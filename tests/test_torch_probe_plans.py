"""The plans of P2 (probes/scales.py i8_gemv_plan, the one-row int8 GEMV on
a scale plane), P3 and P6 (probes/gemv.py i4_gemv_plan and tile_plan, the
same GEMV from 4-bit stored weights), P5 and P9/P10 (probes/gemv.py
u4_gemv_plan and u4_tile_plan, the same from the unsigned-nibble codecs;
probes/p5_p9_ab.py's cases, old-source discovery and refusals), P4
(probes/int4.py i32_plan, the codecs' rule on the nibble words), P12
(probes/attention.py attention_plan, one-launch split-S decode attention
merged in a cluster) and P11 (read_plan, the one-launch read merged by a
ticket; probes/p4_p11_ab.py's cases and refusals),
on the CPU: each a function of the shape alone, held against hand-worked
shapes; the wrappers' launch paths, run on the CPU with
`kernels.load`/`kernels.launch` and the device check monkeypatched, hand
the kernels those plans whatever the row count, pos or col0 and launch
once a call; the plain versions, which repeat the kernels' orders, keep a
row's bits independent of the other rows and read nothing past the
visible columns."""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import cuda_q40, kernels
from distributed_llama_tpu_torch.ops.cuda_q40 import _gemv_order
from distributed_llama_tpu_torch.probes import (
    attention, gemv, i4_tiles, int4, int4b, int4c, p4_p11_ab, p5_p9_ab, scales)
from distributed_llama_tpu_torch.probes.operands import scale_planes

REL_TOL = 1e-5  # exact integer partials; the f32 block sums in another order


class _Captured:
    """Every (C function, arguments) a wrapper launches, so the launch
    paths run on the CPU as on the card."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(kernels, "load", lambda name, sig: name)
        monkeypatch.setattr(kernels, "launch",
                            lambda lib, fn, t, *args: self.calls.append((lib, fn, args)))
        monkeypatch.setattr(cuda_q40, "_device_kind", lambda t: "cuda")


def _plan_args(plan):
    return (plan.vec, plan.cols, plan.kw, plan.splits, plan.blocks_per_split)


# -- P2 ----------------------------------------------------------------------

# (nb, out) -> (vec, cols, kw, splits, blocks a split), worked by hand from
# i8_gemv_plan's rule: 128-column tiles (4 columns a lane, 8 warps along k);
# splits doubled while the tiles x splits stay under 128 CTAs and each
# warp keeps its two blocks in flight (a split >= 16 blocks); at most 256
# blocks a split
P2_PLANS = [
    ((64, 8192), (4, 128, 8, 2, 32)),     # the probe's 2048 -> 8192: 64 tiles x 2
    ((64, 2048), (4, 128, 8, 4, 16)),     # 16 tiles: 4 splits reach 64 blocks of 16
    ((256, 2048), (4, 128, 8, 8, 32)),    # 8192 -> 2048: 8 splits, 128 CTAs
    ((64, 128256), (4, 128, 8, 1, 64)),   # a vocab width: 1002 tiles, no split
    ((8, 64), (4, 128, 8, 1, 8)),         # too shallow to split
    ((2048, 64), (4, 128, 8, 8, 256)),    # 65536 deep: 8 splits of the 256-block cap
    ((448, 14336), (4, 128, 8, 2, 224)),  # 8B w2: 112 tiles x 2
]


@pytest.mark.parametrize("shape,want", P2_PLANS)
def test_p2_plan_is_the_hand_worked_one(shape, want):
    plan = scales.i8_gemv_plan(*shape)
    assert _plan_args(plan) == want
    nb, out_f = shape
    assert plan.ctas(out_f) == -(-out_f // want[1]) * want[3]


@pytest.mark.parametrize("nb", [1, 3, 8, 17, 64, 100, 256, 448, 1000, 2048])
@pytest.mark.parametrize("out_f", [8, 64, 264, 2048, 8192, 128256])
def test_p2_plan_covers_every_block_once(nb, out_f):
    """Every split non-empty and within the cap, the splits' ranges and each
    split's warp runs covering the contraction once, in order."""
    plan = scales.i8_gemv_plan(nb, out_f)
    assert 1 <= plan.splits <= scales.P2_MAX_SPLITS and plan.blocks_per_split <= scales.P2_MAX_BPS
    seen = []
    for s in range(plan.splits):
        blocks = plan.split_range(s, nb)
        assert len(blocks) >= 1
        for kw in range(plan.kw):
            seen += list(plan.warp_range(kw, blocks))
    assert seen == list(range(nb))
    assert (plan.vec, plan.kw) == (scales.P2_VEC, scales.P2_KW)


def test_p2_plan_refuses_what_the_kernel_does_not_take():
    for nb, out_f in ((0, 64), (4, 60), (4, 4), (4096, 64)):
        with pytest.raises(ValueError):
            scales.i8_gemv_plan(nb, out_f)


@pytest.mark.parametrize("in_f,out_f", [(2048, 8192), (8192, 2048), (1024, 264)])
def test_p2_launches_its_plan_once_whatever_the_row_count(monkeypatch, in_f, out_f):
    """scale_plane_call hands the kernel i8_gemv_plan(nb, out) at 1..8 rows
    and on both planes, with the plane's scale kind, launches once a call
    and counts it once."""
    x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, 8, "cpu", seed=1)
    planes = scale_planes(dt)
    cap = _Captured(monkeypatch)
    plan = scales.i8_gemv_plan(in_f // 32, out_f)
    for rows in range(1, 9):
        for plane, kind in (("f32", 1), ("i16", 2)):
            before, calls = scales.scale_plane_call.launches, len(cap.calls)
            out = scales.scale_plane_call(x8[:rows], xs[:rows], qt, planes[plane])
            assert scales.scale_plane_call.launches == before + 1 and len(cap.calls) == calls + 1
            assert out.shape == (rows, out_f) and out.dtype == torch.float32
            lib, fn, args = cap.calls[-1]
            assert (lib, fn) == (scales.P2_SOURCE, "i8_gemv")
            assert args[4] == kind and args[6:9] == (rows, in_f // 32, out_f)
            assert args[-5:] == _plan_args(plan)


@pytest.mark.parametrize("in_f,out_f", [(2048, 8192), (8192, 264)])
def test_p2_plain_rows_equal_their_one_row_calls(in_f, out_f):
    """The plain version at 8 rows, under the shape's plan and two others:
    row r equal to the one-row call on that row bit for bit (the order
    never reads R), and within REL_TOL of B9's plain sum."""
    x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, 8, "cpu", seed=2)
    plane = scale_planes(dt)["i16"]
    nb = in_f // 32
    want = cuda_q40.i8_blocks_plain(x8, xs, qt, dt)
    for plan in (scales.i8_gemv_plan(nb, out_f), scales.GemvPlan(4, 128, 8, 1, nb),
                 scales.GemvPlan(8, 512, 4, 4, -(-nb // 4))):
        got = scales.scale_plane_call_plain(x8, xs, qt, plane, plan)
        ones = torch.cat([scales.scale_plane_call_plain(x8[r:r + 1], xs[r:r + 1], qt, plane, plan)
                          for r in range(8)])
        assert torch.equal(got, ones), plan
        assert (got - want).abs().max() <= REL_TOL * want.abs().max()


def test_p2_plain_planes_agree_on_every_finite_scale():
    """The f32 plane of the raw bits' values gives the i16 plane's bits."""
    x8, xs, qt, dt, _ = int4.make_operands(1024, 256, 3, "cpu", seed=3)
    planes = scale_planes(dt)
    assert torch.equal(scales.scale_plane_call_plain(x8, xs, qt, planes["i16"]),
                       scales.scale_plane_call_plain(x8, xs, qt, planes["f32"]))


# -- P3 and P6 --------------------------------------------------------------

# (nb, out) -> (vec, cols, kw, splits, blocks a split), worked by hand from
# i4_gemv_plan's rule: 256-column tiles (8 columns a lane, 8 warps along
# k), 512 (4 warps along k) where more than 128 tiles; splits doubled while
# the tiles x splits stay under 128 CTAs and each warp keeps its two
# half-byte blocks in flight (a split >= 8 kw blocks); at most 256 blocks a
# split
P3_PLANS = [
    ((64, 3072), (8, 256, 8, 4, 16)),     # wqkv: 12 tiles x 4; 8 splits would be 8 blocks
    ((64, 16384), (8, 256, 8, 2, 32)),    # w13: 64 tiles x 2
    ((256, 2048), (8, 256, 8, 8, 32)),    # w2: 8 tiles x 8
    ((64, 32768), (8, 256, 8, 1, 64)),    # the probe's wcls: 128 tiles
    ((64, 128256), (8, 512, 4, 1, 64)),   # the 1B wcls: 501 tiles of 256 -> 251 of 512
    ((68, 264), (8, 256, 8, 4, 17)),      # a ragged depth and width: 2 tiles x 4
    ((2048, 64), (8, 256, 8, 8, 256)),    # 65536 deep: 8 splits of the 256-block cap
]


@pytest.mark.parametrize("shape,want", P3_PLANS)
def test_p3_plan_is_the_hand_worked_one(shape, want):
    plan = gemv.i4_gemv_plan(*shape)
    assert _plan_args(plan) == want
    assert plan.ctas(shape[1]) == -(-shape[1] // want[1]) * want[3]


@pytest.mark.parametrize("nb", [1, 3, 8, 17, 64, 68, 100, 256, 448, 1000, 2048])
@pytest.mark.parametrize("out_f", [8, 64, 264, 2048, 3072, 32768, 128256])
def test_p3_plan_covers_every_block_once(nb, out_f):
    """Every split non-empty and within the cluster and the cap, the splits'
    ranges and each split's warp runs covering the contraction once, in
    order; the columns a lane divide the width."""
    plan = gemv.i4_gemv_plan(nb, out_f)
    assert 1 <= plan.splits <= gemv.MAX_SPLITS and plan.blocks_per_split <= gemv.MAX_BPS
    assert out_f % plan.vec == 0 and plan.cols == 32 * plan.vec * (gemv.WARPS // plan.kw)
    seen = []
    for s in range(plan.splits):
        blocks = plan.split_range(s, nb)
        assert len(blocks) >= 1
        for kw in range(plan.kw):
            seen += list(plan.warp_range(kw, blocks))
    assert seen == list(range(nb))
    assert plan.vec == gemv.P3_VEC
    # 4 warps along k only where 8 would leave more than the target's tiles
    wide = -(-out_f // (32 * gemv.P3_VEC)) > gemv.P3_TARGET_CTAS
    assert plan.kw == (gemv.P3_MIN_KW if wide else gemv.P3_KW)


def test_p3_plan_refuses_what_the_kernel_does_not_take():
    for nb, out_f in ((0, 64), (4, 60), (4, 4), (4096, 64)):
        with pytest.raises(ValueError):
            gemv.i4_gemv_plan(nb, out_f)


@pytest.mark.parametrize("nb,cols,blocks,want", [
    (64, 128, 8, (4, 128, 8, 8, 8)), (64, 256, 64, (4, 256, 4, 1, 64)),
    (64, 512, 16, (4, 512, 2, 4, 16)), (256, 1024, 32, (4, 1024, 1, 8, 32)),
])
def test_p6_tile_is_its_plan(nb, cols, blocks, want):
    assert _plan_args(gemv.tile_plan(nb, cols, blocks)) == want


def test_p6_tiles_leave_out_only_what_passes_the_cluster():
    """At nb 64 every tile of the JAX sweep's blocks fits; at nb 256 the 8-
    and 16-block tiles (32 and 16 splits) are left out at every width."""
    tiles, left = i4_tiles.tiles_for(64)
    assert left == 0 and len(tiles) == 4 * 4
    tiles, left = i4_tiles.tiles_for(256)
    assert left == 2 * 4 and sorted({k for _, k in tiles}) == [32, 64, 128]
    for nb, cols, blocks in ((64, 64, 8), (64, 128, 3), (256, 128, 16), (64, 2048, 8)):
        with pytest.raises(ValueError):
            gemv.tile_plan(nb, cols, blocks)


def _p3_operands(in_f, out_f, rows, seed):
    x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, rows, "cpu", seed=seed)
    return x8, xs, qt, int4.pack_s4(qt), dt


@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048), (2176, 264)])
def test_p3_launches_its_plan_once_whatever_the_row_count(monkeypatch, in_f, out_f):
    """Both of P3's arms hand the kernel i4_gemv_plan(nb, out) at 1..8
    rows, with the s4 loader, their dot and the f16 plane, launch once a
    call and count it once."""
    x8, xs, _, qt4, dt = _p3_operands(in_f, out_f, 8, seed=1)
    cap = _Captured(monkeypatch)
    plan = gemv.i4_gemv_plan(in_f // 32, out_f)
    for rows in range(1, 9):
        for fn, dot in ((int4.i4_call_int8, 0), (int4.i4_call_bf16, 1)):
            before, calls = fn.launches, len(cap.calls)
            out = fn(x8[:rows], xs[:rows], qt4, dt)
            assert fn.launches == before + 1 and len(cap.calls) == calls + 1
            assert out.shape == (rows, out_f) and out.dtype == torch.float32
            lib, name, args = cap.calls[-1]
            assert (lib, name) == (gemv.SOURCE, "i4_gemv")
            assert args[3:5] == (gemv.W_S4, dot) and args[6] == 0
            assert args[8:11] == (rows, in_f // 32, out_f)
            assert args[-5:] == _plan_args(plan)


@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048)])
def test_p6_launches_its_tile_once_whatever_the_row_count(monkeypatch, in_f, out_f):
    """P6 hands the kernel its tile's plan at 1..8 rows and every variant,
    with the nibble-word loader, the bf16 dot and the raw-bits plane, and
    launches once a call."""
    x8, xs, qt, _, dt = _p3_operands(in_f, out_f, 8, seed=2)
    qw, bits = int4.pack_i32_t(qt), dt.view(torch.int16)
    nb = in_f // 32
    cap = _Captured(monkeypatch)
    tiles, _ = i4_tiles.tiles_for(nb)
    for rows in range(1, 9):
        for (cols, blocks), variant in zip(tiles, i4_tiles.VARIANTS * len(tiles)):
            before, calls = i4_tiles.i4_sweep_call.launches, len(cap.calls)
            out = i4_tiles.i4_sweep_call(x8[:rows], xs[:rows], qw, bits, cols, blocks, variant)
            assert i4_tiles.i4_sweep_call.launches == before + 1
            assert len(cap.calls) == calls + 1 and out.shape == (rows, out_f)
            lib, name, args = cap.calls[-1]
            assert (lib, name) == (gemv.SOURCE, "i4_gemv")
            assert args[3:5] == (gemv.W_I32, 1) and args[6] == 2
            assert args[8:11] == (rows, nb, out_f)
            assert args[-5:] == _plan_args(gemv.tile_plan(nb, cols, blocks))


@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 264)])
def test_p3_plain_rows_equal_their_one_row_calls(in_f, out_f):
    """P3's plain version at 8 rows under its plan and two others: row r
    equal to the one-row call on that row bit for bit, the int8 and bf16
    arms bit for bit equal, and within REL_TOL of B9's plain sum."""
    x8, xs, qt, qt4, dt = _p3_operands(in_f, out_f, 8, seed=3)
    nb = in_f // 32
    want = cuda_q40.i8_blocks_plain(x8, xs, qt, dt)
    for plan in (gemv.i4_gemv_plan(nb, out_f), scales.GemvPlan(4, 256, 4, 1, nb),
                 scales.GemvPlan(8, 512, 4, 4, -(-nb // 4))):
        got = int4.i4_call_plain(x8, xs, qt4, dt, "int8", plan)
        ones = torch.cat([int4.i4_call_plain(x8[r:r + 1], xs[r:r + 1], qt4, dt, "int8", plan)
                          for r in range(8)])
        assert torch.equal(got, ones), plan
        assert torch.equal(got, int4.i4_call_plain(x8, xs, qt4, dt, "bf16", plan)), plan
        assert (got - want).abs().max() <= REL_TOL * want.abs().max()


def test_p6_plain_rows_equal_their_one_row_calls():
    x8, xs, qt, _, dt = _p3_operands(2048, 512, 8, seed=4)
    qw, bits = int4.pack_i32_t(qt), dt.view(torch.int16)
    for cols, blocks in ((128, 8), (1024, 64)):
        got = i4_tiles.i4_sweep_call_plain(x8, xs, qw, bits, cols, blocks)
        ones = torch.cat([i4_tiles.i4_sweep_call_plain(x8[r:r + 1], xs[r:r + 1], qw, bits,
                                                       cols, blocks) for r in range(8)])
        assert torch.equal(got, ones)


@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048), (2048, 32768)])
def test_p6_plain_at_p3s_plan_is_p3(in_f, out_f):
    """On the same values (the s4 bytes and the nibble words of one int8
    draw, the f16 plane and its raw bits) P6's plain version at P3's plan
    tile is P3's plain version bit for bit, at 1 and 3 rows."""
    x8, xs, qt, qt4, dt = _p3_operands(in_f, out_f, 3, seed=5)
    qw, bits = int4.pack_i32_t(qt), dt.view(torch.int16)
    tile = i4_tiles.p3_tile(in_f // 32, out_f)
    for rows in (1, 3):
        assert torch.equal(i4_tiles.i4_sweep_call_plain(x8[:rows], xs[:rows], qw, bits, *tile),
                           int4.i4_call_plain(x8[:rows], xs[:rows], qt4, dt))


# -- P4 ----------------------------------------------------------------------

P4_ARMS = ((int4.i32_call_int8, 0), (int4.i32_call_bf16, 1), (int4.i32_call_f32, 1))


@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048), (2176, 264)])
def test_p4_launches_its_plan_once_whatever_the_row_count(monkeypatch, in_f, out_f):
    """P4's three arms hand the kernel i32_plan(nb, out) (the codecs' rule
    at the feature-split words' geometry) at 1..8 rows, with the
    nibble-word loader and the f16 plane: the int8 arm
    the int8 dot, the bf16 and f32 arms the bf16 code (one instance, exact
    f32 products); each launches once a call and counts it on its own
    counter."""
    x8, xs, qt, _, dt = _p3_operands(in_f, out_f, 8, seed=11)
    qw = int4.pack_i32_t(qt)
    cap = _Captured(monkeypatch)
    plan = int4.i32_plan(in_f // 32, out_f)
    assert plan == gemv.u4_gemv_plan(in_f // 32, out_f, gemv.W_FS)
    for rows in range(1, 9):
        for fn, dot in P4_ARMS:
            counts = [f.launches for f, _ in P4_ARMS]
            calls = len(cap.calls)
            out = fn(x8[:rows], xs[:rows], qw, dt)
            assert [f.launches for f, _ in P4_ARMS] == [
                c + (f is fn) for c, (f, _) in zip(counts, P4_ARMS)]
            assert len(cap.calls) == calls + 1
            assert out.shape == (rows, out_f) and out.dtype == torch.float32
            lib, name, args = cap.calls[-1]
            assert (lib, name) == (gemv.SOURCE, "i4_gemv")
            assert args[3:5] == (gemv.W_I32, dot) and args[6] == 0
            assert args[8:11] == (rows, in_f // 32, out_f)
            assert args[-5:] == _plan_args(plan)


@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048), (2176, 264)])
def test_p4_plain_at_a_shared_plan_is_p3(in_f, out_f):
    """On the same values (the nibble words and the s4 bytes of one int8
    draw) P4's plain order is P3's bit for bit, every dot, at P4's plan,
    P3's and two others (the order reads only the warps along k and the
    blocks a split); each of 3 rows equals its one-row call; within REL_TOL
    of B9's plain sum."""
    x8, xs, qt, qt4, dt = _p3_operands(in_f, out_f, 3, seed=12)
    qw = int4.pack_i32_t(qt)
    nb = in_f // 32
    want = cuda_q40.i8_blocks_plain(x8, xs, qt, dt)
    for plan in (int4.i32_plan(nb, out_f), gemv.i4_gemv_plan(nb, out_f),
                 scales.GemvPlan(4, 256, 4, 1, nb), scales.GemvPlan(8, 512, 4, 4, -(-nb // 4))):
        p3 = int4.i4_call_plain(x8, xs, qt4, dt, "int8", plan)
        for dot in int4.P4_DOTS:
            assert torch.equal(int4.i32_call_plain(x8, xs, qw, dt, dot, plan), p3), (plan, dot)
        ones = torch.cat([int4.i32_call_plain(x8[r:r + 1], xs[r:r + 1], qw, dt, "int8", plan)
                          for r in range(3)])
        assert torch.equal(ones, p3), plan
        assert (p3 - want).abs().max() <= REL_TOL * want.abs().max()
    assert torch.equal(int4.i32_call_plain(x8, xs, qw, dt),
                       int4.i32_call_plain(x8, xs, qw, dt, plan=int4.i32_plan(nb, out_f)))
    with pytest.raises(ValueError):
        int4.i32_call_plain(x8, xs, qw, dt, "fp8")


# -- P5 and P9/P10 --------------------------------------------------------------

# (nb, out) -> (vec, cols, kw, splits, blocks a split) of each codec's
# default plan, worked by hand from u4_gemv_plan's rule: P9's 8 word
# columns a lane (256-column tiles at 8 warps along k, 512 at 4 where more
# than 128 tiles), P5's 4 byte columns a lane (two runs of 128 a CTA at 8
# warps along k, 2 x 256 at 4, but only where a CTA's bytes divide out / 2);
# splits doubled while the tiles x splits stay under 128 CTAs and each warp
# keeps a block (a split >= 8 blocks); at most 256 blocks a split
U4_PLANS = [
    (gemv.W_FS, (64, 3072), (8, 256, 8, 8, 8)),      # wqkv: 12 tiles x 8
    (gemv.W_FS, (64, 16384), (8, 256, 8, 2, 32)),    # w13: 64 tiles x 2
    (gemv.W_FS, (256, 2048), (8, 256, 8, 8, 32)),    # w2: 8 tiles x 8
    (gemv.W_FS, (64, 32768), (8, 256, 8, 1, 64)),    # the probe's wcls: 128 tiles
    (gemv.W_FS, (64, 128256), (8, 512, 4, 1, 64)),   # the 1B wcls: 251 tiles of 512
    (gemv.W_FS, (68, 264), (8, 256, 8, 8, 9)),       # a ragged depth and width
    (gemv.W_SH, (64, 3072), (4, 256, 8, 8, 8)),      # 1536 bytes a row: 12 tiles x 8
    (gemv.W_SH, (256, 2048), (4, 256, 8, 8, 32)),    # w2: 8 tiles x 8
    (gemv.W_SH, (64, 32768), (4, 256, 8, 1, 64)),    # 128 tiles
    (gemv.W_SH, (64, 65536), (4, 512, 4, 1, 64)),    # 256 tiles of 256 -> 128 of 512
    (gemv.W_SH, (64, 128256), (4, 256, 8, 1, 64)),   # 256 bytes do not divide 64128: 8 warps
]


@pytest.mark.parametrize("weights,shape,want", U4_PLANS)
def test_u4_plan_is_the_hand_worked_one(weights, shape, want):
    plan = gemv.u4_gemv_plan(*shape, weights)
    assert _plan_args(plan) == want
    assert plan.ctas(shape[1]) == -(-shape[1] // want[1]) * want[3]


@pytest.mark.parametrize("weights", [gemv.W_FS, gemv.W_SH])
@pytest.mark.parametrize("nb", [1, 3, 8, 17, 64, 68, 100, 256, 448, 1000, 2048])
@pytest.mark.parametrize("out_f", [256, 264, 2048, 3072, 32768, 128256])
def test_u4_plan_is_a_function_of_the_shape_alone(weights, nb, out_f):
    """Each codec's default plan from (nb, out) alone, the same every call:
    at most MAX_SPLITS splits, none empty, their warp runs covering the
    contraction once in order; the columns a lane divide the weight row;
    for P5 a CTA's cols / 2 bytes divide out / 2; where its blocks a split
    divide nb it is one of the codec's tiles."""
    if weights == gemv.W_SH and out_f == 264:  # 132 bytes a row: no split-half plan
        with pytest.raises(ValueError):
            gemv.u4_gemv_plan(nb, out_f, weights)
        return
    plan = gemv.u4_gemv_plan(nb, out_f, weights)
    assert plan == gemv.u4_gemv_plan(nb, out_f, weights)
    assert 1 <= plan.splits <= gemv.MAX_SPLITS and plan.blocks_per_split <= gemv.MAX_BPS
    runs = gemv.U4_RUNS[weights]
    assert plan.vec == gemv.U4_VEC[weights] and (out_f // runs) % plan.vec == 0
    assert plan.cols == runs * 32 * plan.vec * (gemv.WARPS // plan.kw)
    if runs == 2:
        assert (out_f // 2) % (plan.cols // 2) == 0
    seen = []
    for s in range(plan.splits):
        blocks = plan.split_range(s, nb)
        assert len(blocks) >= 1
        for kw in range(plan.kw):
            seen += list(plan.warp_range(kw, blocks))
    assert seen == list(range(nb))
    if nb % plan.blocks_per_split == 0:
        assert gemv.u4_tile_plan(nb, out_f, plan.cols, plan.blocks_per_split, weights) == plan


def test_u4_tiles_leave_out_only_what_passes_the_cluster():
    """At nb 64 every JAX tile_knb up to nb fits; at nb 256 the 8- and
    16-block tiles (32 and 16 splits) are left out at every width; P5's
    widths are those whose half divides out / 2. Every tile is a plan, and
    a tile past the cluster limit is refused."""
    tiles, left = int4c.tiles_for(64, 2048)
    assert left == 0 and len(tiles) == 4 * 4
    tiles, left = int4c.tiles_for(256, 2048)
    assert left == 2 * 4 and sorted({k for _, k in tiles}) == [32, 64, 128, 256]
    tiles, left = int4b.tiles_for(256, 3072)  # 1536 bytes a row: 1024-byte CTAs do not fit
    assert sorted({c for c, _ in tiles}) == [256, 512, 1024] and left == 2 * 3
    for weights in (gemv.W_FS, gemv.W_SH):
        for nb, out_f in ((64, 2048), (256, 2048), (64, 3072)):
            for cols, blocks in gemv.u4_tiles_for(nb, out_f, weights)[0]:
                plan = gemv.u4_tile_plan(nb, out_f, cols, blocks, weights)
                assert plan.splits == nb // blocks <= gemv.MAX_SPLITS and plan.cols == cols
        for nb, cols, blocks in ((256, 256, 16), (256, 256, 8), (64, 128, 8), (64, 256, 3),
                                 (64, 4096, 8)):
            with pytest.raises(ValueError):
                gemv.u4_tile_plan(nb, 2048, cols, blocks, weights)


def _u4_operands(in_f, out_f, rows, seed):
    x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, rows, "cpu", seed=seed)
    return (x8, xs, int4b.block_sums(x8, in_f // 32), qt, dt, int4c.pack_feature_split(qt),
            int4b.pack_split_half(qt))


def _u4_plain(weights, x8, xs, bs, qp, qsh, d, cols, blocks):
    """A codec's plain version in natural column order [R, out]."""
    nb, out_f = d.shape
    if weights == gemv.W_FS:
        return int4c.fs_call_plain(x8, xs, bs, qp, d, cols, blocks)
    return int4b.sh_call_plain(x8, xs, bs, qsh, d.reshape(nb, 2, out_f // 2), cols,
                               blocks).reshape(x8.shape[0], out_f)


@pytest.mark.parametrize("weights", [gemv.W_FS, gemv.W_SH])
@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048)])
def test_u4_plain_is_gemv_order_on_block_terms(weights, in_f, out_f):
    """Both codecs' plain versions, which take the dot with u less 8 * bs,
    equal the signed weight's block terms (`gemv.block_terms`, no bs)
    summed in the tile's plan's order (`_gemv_order`) bit for bit, at every
    tile, both planes, 1 and 3 rows."""
    x8, xs, bs, qt, dt, qp, qsh = _u4_operands(in_f, out_f, 3, seed=6)
    nb = in_f // 32
    for rows in (1, 3):
        for d in (dt, dt.view(torch.int16)):
            terms = gemv.block_terms(x8[:rows], xs[:rows], qt, scales.plane_f32(d))
            for cols, blocks in gemv.u4_tiles_for(nb, out_f, weights)[0]:
                plan = gemv.u4_tile_plan(nb, out_f, cols, blocks, weights)
                got = _u4_plain(weights, x8[:rows], xs[:rows], bs[:rows], qp, qsh, d, cols,
                                blocks)
                assert torch.equal(got, _gemv_order(terms, plan)), (rows, d.dtype, cols, blocks)


@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048), (2048, 32768)])
def test_u4_plain_at_p3s_plan_is_p3(in_f, out_f):
    """On the same values (the s4 bytes, the feature-split words and the
    split-half bytes of one int8 draw, the f16 plane and its raw bits) both
    codecs' plain versions at P3's plan tile are P3's int8 plain version
    bit for bit, at 1 and 3 rows."""
    x8, xs, bs, qt, dt, qp, qsh = _u4_operands(in_f, out_f, 3, seed=7)
    qt4, nb = int4.pack_s4(qt), in_f // 32
    for rows in (1, 3):
        want = int4.i4_call_plain(x8[:rows], xs[:rows], qt4, dt)
        for weights in (gemv.W_FS, gemv.W_SH):
            tile = gemv.u4_p3_tile(nb, out_f, weights)
            for d in (dt, dt.view(torch.int16)):
                got = _u4_plain(weights, x8[:rows], xs[:rows], bs[:rows], qp, qsh, d, *tile)
                assert torch.equal(got, want), (weights, rows, d.dtype)


@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048)])
def test_u4_launch_their_tile_once_whatever_the_row_count(monkeypatch, in_f, out_f):
    """P5 (both storages), P9 and P10 hand the kernel their tile's plan at
    1..8 rows, with their loader, both planes' scale kinds and bs, launch
    once a call and count it once; at the default plan's tile the plan is
    the default plan."""
    x8, xs, bs, _, dt, qp, qsh = _u4_operands(in_f, out_f, 8, seed=8)
    nb = in_f // 32
    cap = _Captured(monkeypatch)
    for weights in (gemv.W_FS, gemv.W_SH):
        plan = gemv.u4_gemv_plan(nb, out_f, weights)
        tiles = gemv.u4_tiles_for(nb, out_f, weights)[0]
        assert (plan.cols, plan.blocks_per_split) in tiles
        for rows in range(1, 9):
            for (cols, blocks), d in zip(tiles, (dt, dt.view(torch.int16)) * len(tiles)):
                calls = []
                if weights == gemv.W_FS:
                    calls += [(int4c.fs2d_call, lambda: int4c.fs2d_call(
                        x8[:rows], xs[:rows], bs[:rows], qp.view(nb * 4, out_f), d, cols,
                        blocks)), (int4c.fs_call, lambda: int4c.fs_call(
                            x8[:rows], xs[:rows], bs[:rows], qp, d, cols, blocks))]
                else:
                    for st in int4b.STORAGES:
                        calls.append((int4b.sh_call, lambda st=st: int4b.sh_call(
                            x8[:rows], xs[:rows], bs[:rows], int4b.storage_view(qsh, st),
                            d.reshape(nb, 2, out_f // 2), cols, blocks, st)))
                for fn, call in calls:
                    before, n = fn.launches, len(cap.calls)
                    out = call()
                    assert fn.launches == before + 1 and len(cap.calls) == n + 1
                    assert out.numel() == rows * out_f
                    lib, name, args = cap.calls[-1]
                    assert (lib, name) == (gemv.U4_SOURCE, "u4_gemv")
                    assert args[4] == weights and args[6] == (0 if d.dtype == torch.float16
                                                              else 2)
                    assert args[2] == bs[:rows].data_ptr()
                    assert args[8:11] == (rows, nb, out_f)
                    assert args[-5:] == _plan_args(gemv.u4_tile_plan(nb, out_f, cols, blocks,
                                                                     weights))
                    if (cols, blocks) == (plan.cols, plan.blocks_per_split):
                        assert args[-5:] == _plan_args(plan)


def test_u4_wrappers_refuse_a_tile_past_the_cluster(monkeypatch):
    """16 splits of 4 blocks (the JAX tile_knb 4 at nb 64) have no plan: on
    CPU tensors and on the card's launch path alike the wrappers raise, and
    nothing is launched."""
    x8, xs, bs, _, dt, qp, qsh = _u4_operands(2048, 2048, 1, seed=9)
    for patch in (False, True):
        cap = _Captured(monkeypatch) if patch else None
        for cols in (256, 512):
            with pytest.raises(ValueError):
                int4c.fs_call(x8, xs, bs, qp, dt, cols, 4)
            with pytest.raises(ValueError):
                int4b.sh_call(x8, xs, bs, qsh, dt.reshape(64, 2, 1024), cols, 4)
        if cap:
            assert cap.calls == []


@pytest.mark.parametrize("weights", [gemv.W_FS, gemv.W_SH])
def test_u4_plain_rows_equal_their_one_row_calls(weights):
    x8, xs, bs, _, dt, qp, qsh = _u4_operands(2048, 3072, 8, seed=10)
    plan = gemv.u4_gemv_plan(64, 3072, weights)
    tile = (plan.cols, plan.blocks_per_split)
    got = _u4_plain(weights, x8, xs, bs, qp, qsh, dt, *tile)
    ones = torch.cat([_u4_plain(weights, x8[r:r + 1], xs[r:r + 1], bs[r:r + 1], qp, qsh, dt,
                                *tile) for r in range(8)])
    assert torch.equal(got, ones)


def test_p5_p9_ab_cases_and_old_sources(tmp_path, monkeypatch):
    """The A/B's case list (five shapes, 1 and 8 rows, two planes, P5's two
    storages and P9/P10's two views), its old-source discovery, its sweep's
    plans, and its refusals: no mode, a directory without the earlier
    sources, no card."""
    cases = p5_p9_ab.cases()
    assert len(cases) == 5 * 2 * 2 * 4
    assert {(c["probe"], c["variant"]) for c in cases} == {
        ("P5", "i8ops"), ("P5", "i32st"), ("P9", "fs2d"), ("P10", "fs")}
    assert [s[1:] for s in int4b.SHAPES] == sorted({(c["in"], c["out"]) for c in cases},
                                                   key=[s[1:] for s in int4b.SHAPES].index)
    with pytest.raises(FileNotFoundError):
        p5_p9_ab.old_sources(tmp_path)
    (tmp_path / "i4_codec_probe.cu").write_text("// old\n")
    with pytest.raises(FileNotFoundError):  # the header is missing
        p5_p9_ab.old_sources(tmp_path)
    (tmp_path / "q40_i8_mma.cuh").write_text("// old\n")
    assert set(p5_p9_ab.old_sources(tmp_path)) == set(p5_p9_ab.OLD_SOURCES)
    with pytest.raises(SystemExit):
        p5_p9_ab.main([])
    with pytest.raises(FileNotFoundError):
        p5_p9_ab.main(["--old", str(tmp_path / "nowhere")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert p5_p9_ab.main(["--old", str(tmp_path)]) == 2
    assert p5_p9_ab.main(["--sweep"]) == 2
    # the old arm's tiles: 3 widths x the blocks dividing nb; P5's where a
    # CTA's bytes divide out / 2
    assert len(p5_p9_ab.old_tiles(64, 3072, gemv.W_FS)) == 3 * 4
    assert len(p5_p9_ab.old_tiles(64, 1056, gemv.W_SH)) == 1 * 4
    for weights in (gemv.W_FS, gemv.W_SH):
        plans = p5_p9_ab.sweep_plans(64, 3072, weights)
        pairs = {(p.vec, p.kw) for p in plans}
        assert pairs <= set(p5_p9_ab.SWEEP_PAIRS[weights]) and len(pairs) >= 4
        assert all(p.splits * p.blocks_per_split >= 64 > (p.splits - 1) * p.blocks_per_split
                   for p in plans)


# -- P12 ---------------------------------------------------------------------

# (S, hd) -> (cluster, width), worked by hand from attention_plan: S in
# units of (warps x tile rows) columns (8 x 32 = 256 at hd 64, 8 x 16 = 128
# at hd 128) spread over at most 8 CTAs, no CTA past S
P12_PLANS = [
    ((1024, 64), (4, 256)),
    ((2048, 64), (8, 256)),
    ((32768, 64), (8, 4096)),
    ((40, 64), (1, 256)),
    ((4097, 64), (6, 768)),  # 17 units: 3 a CTA, 6 CTAs
    ((32768, 128), (8, 4096)),
    ((2048, 128), (8, 256)),
    ((300, 128), (3, 128)),
    ((1000, 128), (8, 128)),
]


@pytest.mark.parametrize("shape,want", P12_PLANS)
def test_p12_plan_is_the_hand_worked_one(shape, want):
    plan = attention.attention_plan(*shape)
    assert (plan.cluster, plan.width) == want
    assert (8, plan.warps, plan.tile, plan.stages) == attention.ATT_VARIANT[shape[1]]
    assert plan.run == want[1] // 8 and plan.run % plan.tile == 0


@pytest.mark.parametrize("S", [1, 31, 32, 127, 128, 129, 1000, 2047, 2048, 5000, 32768, 100000])
@pytest.mark.parametrize("max_cluster", [1, 8, 16])
def test_p12_plan_covers_the_cache_once(S, max_cluster):
    """C <= max_cluster CTAs of whole (warps x tile)-column units cover S,
    the last one reaching it and none past it; each warp's run whole
    tiles."""
    for hd, *variant in attention.ATT_SWEEP_VARIANTS:
        plan = attention.attention_plan(S, hd, max_cluster, tuple(variant))
        assert 1 <= plan.cluster <= max_cluster
        assert plan.width % (plan.warps * plan.tile) == 0 and plan.run % plan.tile == 0
        assert (plan.cluster - 1) * plan.width < S <= plan.cluster * plan.width


def test_p12_plan_refuses_what_the_kernel_does_not_take():
    for args in ((1024, 96), (0, 64), (1024, 64, 17), (1024, 64, 0)):
        with pytest.raises(ValueError):
            attention.attention_plan(*args)
    with pytest.raises(ValueError):  # sixteen warps' rings of 16-row tiles pass 227 KB at hd 128
        attention.attention_plan(1024, 128, variant=(16, 16, 2))


@pytest.mark.parametrize("S,hd,g", [(1024, 64, 4), (32768, 64, 4), (300, 128, 8)])
def test_p12_launches_its_plan_once_whatever_pos_and_batch(monkeypatch, S, hd, g):
    """decode_attention hands the kernel attention_plan(S, hd) at every
    pos (before the cache, inside, past it) and col0, at batch 1 and 3, and
    launches once a call."""
    cap = _Captured(monkeypatch)
    plan = attention.attention_plan(S, hd)
    for b in (1, 3):
        q, k, v = (torch.zeros((b, 2 * g, hd), dtype=torch.bfloat16),
                   torch.zeros((b, 2, S, hd), dtype=torch.bfloat16),
                   torch.zeros((b, 2, S, hd), dtype=torch.bfloat16))
        for pos, col0 in ((-5, 0), (0, 0), (S // 2, 0), (S - 1, 0), (S + 50, 0), (S, 64)):
            before, calls = attention.decode_attention.launches, len(cap.calls)
            out = attention.decode_attention(q, k, v, pos, col0)
            assert attention.decode_attention.launches == before + 1
            assert len(cap.calls) == calls + 1 and out.shape == q.shape
            lib, fn, args = cap.calls[-1]
            assert (lib, fn) == ("attention_probe", "decode_attention")
            assert args[4:11] == (b, 2, g, S, hd, pos, col0)
            assert args[11:16] == (plan.cluster, plan.width, plan.warps, plan.tile, plan.stages)
            assert args[-1] is None  # a launch, not an occupancy query


def test_p12_refuses_more_heads_a_group_than_the_mma_rows(monkeypatch):
    """The kernel puts a kv head's query heads on the MMA's rows 0..7: 9
    heads a group are refused before any launch."""
    cap = _Captured(monkeypatch)
    q, k, v = attention.make_operands(1, 18, 2, 64, 128, "cpu")
    with pytest.raises(ValueError):
        attention.decode_attention(q, k, v, 100)
    assert cap.calls == []


@pytest.mark.parametrize("pos,col0", [(700, 0), (37, 0), (900, 256), (100, 200)])
def test_p12_plain_reads_nothing_past_the_visible_columns(pos, col0):
    """NaN in the cache from the first invisible column on changes nothing:
    the runs stop there and a ragged tile is masked, not read. With nothing
    visible the output is zeros."""
    q, k, v = attention.make_operands(1, 8, 2, 64, 1000, "cpu", seed=pos)
    want = attention.decode_attention_plain(q, k, v, pos, col0)
    vis = attention.visible_columns(1000, pos, col0)
    k[:, :, vis:] = float("nan")
    v[:, :, vis:] = float("nan")
    got = attention.decode_attention_plain(q, k, v, pos, col0)
    assert torch.equal(got, want)
    assert torch.isfinite(got.float()).all()
    assert bool(got.any()) == (vis > 0)


@pytest.mark.parametrize("max_cluster", [1, 4, 16])
def test_p12_plain_plans_agree(max_cluster):
    """The split and merge order changes only where p rounds: with every
    visible column in the first tile (16 rows at hd 128) the other runs add
    exact zeros (every plan gives the same bits); over the whole cache, any
    two plans within one bf16 rounding of the largest output."""
    q, k, v = attention.make_operands(2, 16, 4, 128, 2048, "cpu", seed=max_cluster)
    ref = attention.attention_plan(2048, 128)
    plan = attention.attention_plan(2048, 128, max_cluster)
    q32 = q.float()
    assert torch.equal(attention.decode_attention_plain(q32, k, v, 12, 0, plan),
                       attention.decode_attention_plain(q32, k, v, 12, 0, ref))
    a = attention.decode_attention_plain(q32, k, v, 2040, 0, plan)
    b = attention.decode_attention_plain(q32, k, v, 2040, 0, ref)
    assert (a - b).abs().max() <= 2.0 ** -8 * b.abs().max()


def test_p12_merge_takes_the_largest_m_and_sums_in_order():
    """_merge on hand-made states: M the largest m, acc and l weighted by
    e^(m - M) and summed from the first; an empty state (m = NEG_INF, l 0)
    adds exact zeros."""
    ninf = attention.NEG_INF
    m = torch.tensor([[1.0], [3.0], [ninf]])
    l = torch.tensor([[2.0], [1.0], [0.0]])
    acc = torch.tensor([[2.0, 4.0], [1.0, 1.0], [0.0, 0.0]])
    M, L, O = attention._merge(m, l, acc, 0)
    f = np.exp(np.float32(1.0) - np.float32(3.0))
    assert M.item() == 3.0
    assert torch.equal(L, torch.tensor([np.float32(2.0) * f + np.float32(1.0)]))
    assert torch.equal(O, torch.tensor([np.float32(2.0) * f + 1, np.float32(4.0) * f + 1]))


# -- P11 ---------------------------------------------------------------------

# (b, kv, S, hd) -> (splits, chunk rows) of read_plan, worked by hand: whole
# CTA iterations of 4 rows a thread (128 rows at hd 64, 64 at hd 128), as
# many CTAs a row as reach 256 over the batch, none empty
P11_PLANS = [
    ((1, 8, 1024, 64), (64, 128)),      # 64 iterations, one a CTA
    ((4, 8, 1024, 64), (64, 128)),      # 64 a row reach 256
    ((16, 8, 1024, 64), (16, 512)),     # 16 a row: 4 iterations a CTA
    ((1, 8, 32768, 64), (256, 1024)),   # 2048 iterations, 8 a CTA
    ((4, 8, 32768, 128), (64, 4096)),
    ((1, 8, 1024, 128), (128, 64)),
    ((3, 2, 37, 64), (1, 128)),         # 74 rows: one ragged iteration
    ((2, 4, 300, 128), (19, 64)),       # 1200 rows: the last CTA 48
    ((256, 8, 1024, 64), (1, 8192)),    # a CTA a row already passes 256
]


@pytest.mark.parametrize("shape,want", P11_PLANS)
def test_p11_plan_is_the_hand_worked_one(shape, want):
    plan = attention.read_plan(*shape)
    assert (plan.splits, plan.chunk) == want
    assert plan.unroll == attention.READ_UNROLL[shape[3]]


@pytest.mark.parametrize("b", [1, 2, 3, 16, 300])
@pytest.mark.parametrize("n_kv,S", [(8, 1024), (8, 32768), (4, 300), (2, 37), (1, 1), (8, 1000)])
def test_p11_plan_covers_the_cache_once(b, n_kv, S):
    """The shape alone sets the plan: chunks of whole CTA iterations that
    cover the row's kv * S rows once, none empty, at most about
    READ_TARGET_CTAS CTAs over the batch (one a row at the least); the
    sweep's overrides keep those properties."""
    for hd in attention.HEAD_DIMS:
        rows = n_kv * S
        for splits, unroll in ((None, None), (7, 8), (1, 4), (10 ** 6, 4)):
            plan = attention.read_plan(b, n_kv, S, hd, splits, unroll)
            assert plan == attention.read_plan(b, n_kv, S, hd, splits, unroll)
            assert plan.chunk % (attention.READ_THREADS // (hd // 8) * plan.unroll) == 0
            assert plan.splits * plan.chunk >= rows > (plan.splits - 1) * plan.chunk
            if splits is None:
                assert b * plan.splits < attention.READ_TARGET_CTAS + b
            else:
                assert plan.splits <= splits


def test_p11_plan_refuses_what_the_kernel_does_not_take():
    for args in ((1, 8, 1024, 96), (0, 8, 1024, 64), (1, 8, 0, 64), (1, 0, 8, 64)):
        with pytest.raises(ValueError):
            attention.read_plan(*args)
    for splits, unroll in ((0, 4), (4, 5), (4, 2)):
        with pytest.raises(ValueError):
            attention.read_plan(1, 8, 1024, 64, splits, unroll)


@pytest.mark.parametrize("n_kv,S,hd", [(8, 1024, 64), (4, 300, 128), (2, 37, 64)])
def test_p11_launches_its_plan_once_whatever_the_batch(monkeypatch, n_kv, S, hd):
    """pure_read hands the kernel read_plan(b, kv, S, hd) at batch 1, 3 and
    16, launches once a call, and gives it a partials buffer and zeroed
    tickets only where a row has more than one split."""
    cap = _Captured(monkeypatch)
    for b in (1, 3, 16):
        k = torch.zeros((b, n_kv, S, hd), dtype=torch.bfloat16)
        plan = attention.read_plan(b, n_kv, S, hd)
        before, calls = attention.pure_read.launches, len(cap.calls)
        out = attention.pure_read(k, k.clone())
        assert attention.pure_read.launches == before + 1 and len(cap.calls) == calls + 1
        assert out.shape == (b, 1, hd) and out.dtype == torch.float32
        lib, fn, args = cap.calls[-1]
        assert (lib, fn) == ("attention_probe", "pure_read")
        assert args[2:9] == (b, n_kv, S, hd, plan.splits, plan.chunk, plan.unroll)
        assert (args[9] is None) == (args[10] is None) == (plan.splits == 1)


def test_p11_order_plain_splits_agree_within_the_closed_form():
    """Any split count reorders the f32 sums only: each within 1e-6 of the
    column's sum of magnitudes of the others, and a split's rows past the
    cache add nothing (a cache of zeros past S gives the same bits)."""
    _, k, v = attention.make_operands(2, 8, 8, 64, 1000, "cpu", seed=3)
    mag = (k.float().abs().sum(dim=(1, 2)) + v.float().abs().sum(dim=(1, 2))).unsqueeze(1)
    ref = attention.pure_read_order_plain(k, v)
    for splits in (1, 2, 5, 63):
        got = attention.pure_read_order_plain(k, v, attention.read_plan(2, 8, 1000, 64, splits))
        assert bool(((got - ref).abs() <= 1e-6 * mag).all()), splits
    # one kv head of 8000 rows, and the same rows with the last CTA's 64
    # missing ones read as zeros: the same bits
    k1, v1 = k.reshape(2, 1, 8000, 64), v.reshape(2, 1, 8000, 64)
    plan = attention.read_plan(2, 1, 8000, 64)
    assert (plan.splits, plan.chunk) == (63, 128)
    kz, vz = (torch.nn.functional.pad(t, (0, 0, 0, 64)) for t in (k1, v1))
    assert torch.equal(attention.pure_read_order_plain(kz, vz, plan),
                       attention.pure_read_order_plain(k1, v1, plan))


def test_p4_p11_ab_cases_and_old_sources(tmp_path, monkeypatch):
    """The A/B's P11 cases (S 1024 and 32768, hd 64 and 128, b 1 and 4), its
    old-source discovery and its refusals: no mode, a directory without the
    earlier sources, no card; the old P11's split as the earlier wrapper
    computed it."""
    assert len(p4_p11_ab.P11_CASES) == 8
    assert {(S, b) for S, _, b in p4_p11_ab.P11_CASES} == {(1024, 1), (1024, 4), (32768, 1),
                                                            (32768, 4)}
    with pytest.raises(FileNotFoundError):
        p4_p11_ab.old_sources(tmp_path)
    for name in p4_p11_ab.OLD_SOURCES[:-1]:
        (tmp_path / name).write_text("// old\n")
    with pytest.raises(FileNotFoundError):  # attention_probe.cu is missing
        p4_p11_ab.old_sources(tmp_path)
    (tmp_path / "attention_probe.cu").write_text("// old\n")
    assert set(p4_p11_ab.old_sources(tmp_path)) == set(p4_p11_ab.OLD_SOURCES)
    with pytest.raises(SystemExit):
        p4_p11_ab.main([])
    with pytest.raises(FileNotFoundError):
        p4_p11_ab.main(["--old", str(tmp_path / "nowhere")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert p4_p11_ab.main(["--old", str(tmp_path)]) == 2
    assert p4_p11_ab.main(["--sweep", "p11"]) == 2
    assert p4_p11_ab.old_read_splits(8, 1024, 64) == 256
    assert p4_p11_ab.old_read_splits(8, 32768, 128) == 512
