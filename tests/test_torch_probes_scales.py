"""P1, P2 and P13's port (probes/scales.py) against the JAX probes on the
CPU: P1's plain convert against scripts/probe_f16_scales.py's `_kernel` in
a pallas_call and against both scripts' `f16bits_to_f32`, on every f16 bit
pattern; P13's plain version against scripts/sweep_i8_tiles.py's
`build_call` with `_kernel_i8` (f32 plane) and `_kernel_i8_i16` (raw-bits
plane); P2's against `build_call` with probe_f16_scales.py's
`_mm_kernel_i16`. `build_call` and `probe_convert` have no `interpret`
argument, so they run under `force_tpu_interpret_mode`. P2's own `build` is
local to `bench_mm` and cannot be imported; its pallas_call has the same
specs as `build_call`, so the test runs `build_call` with P2's kernel at
P2's tile."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from distributed_llama_tpu.ops.pallas_q40 import (
    _blockdiag_mask, _kernel_i8, _quantize_row_q80, _scale_f32)
from distributed_llama_tpu_torch.ops import cuda_q40
from distributed_llama_tpu_torch.probes import scales
from distributed_llama_tpu_torch.probes.operands import operands_from_jax, scale_planes
from scripts import probe_f16_scales as jf16
from scripts import sweep_i8_tiles as jsweep

# exact integer partials; the f32 block sums run in another order (the JAX
# kernel sums a k tile's blocks, then adds the tiles; the planes' f32
# scales agree exactly)
REL_TOL = 1e-5


def _every_pattern() -> np.ndarray:
    """All 65,536 f16 bit patterns as a [256, 256] int16 plane."""
    return np.arange(-32768, 32768, dtype=np.int32).astype(np.int16).reshape(256, 256)


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def test_p1_plain_is_the_jax_kernel_on_every_bit_pattern():
    """The JAX probe's convert in a pallas_call at tile 8 (inf and NaN
    patterns to finite values included) equals the port's plain version
    bit for bit, and so does each script's jnp function."""
    bits = _every_pattern()
    with pltpu.force_tpu_interpret_mode():  # read where the pallas_call is made
        fn = pl.pallas_call(
            jf16._kernel, grid=(256 // 8,),
            in_specs=[pl.BlockSpec((8, 256), lambda k: (k, 0))],
            out_specs=pl.BlockSpec((8, 256), lambda k: (k, 0)),
            out_shape=jax.ShapeDtypeStruct((256, 256), jnp.float32),
        )
        want = np.asarray(fn(jnp.asarray(bits)))
    got = scales.f16bits_to_f32(torch.from_numpy(bits))  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (256, 256)
    assert _bits_equal(got.numpy(), want)
    for jax_fn in (jf16.f16bits_to_f32, jsweep.f16bits_to_f32, _scale_f32):
        assert _bits_equal(got.numpy(), jax_fn(jnp.asarray(bits)))
    finite = np.isfinite(bits.view(np.float16))
    assert (~finite).sum() == 2048 and np.isfinite(want).all()
    assert np.array_equal(want[finite], bits.view(np.float16)[finite].astype(np.float32))


def test_p1_jax_probe_convert_holds_and_the_port_agrees():
    """probe_convert's own check (exact against f16 -> f32) on its plane of
    zeros, subnormals and N(0, 1) values, at tile 8, and the port's plain
    version on the same plane."""
    with pltpu.force_tpu_interpret_mode():
        assert jf16.probe_convert(64, 8)
    vals = np.random.default_rng(0).standard_normal((64, 256)).astype(np.float16)
    vals[0, :8], vals[0, 8:16] = np.float16(0.0), np.float16(1e-7)
    got = scales.f16bits_to_f32_plain(torch.from_numpy(vals.view(np.int16)))
    assert _bits_equal(got.numpy(), vals.astype(np.float32))


def _sweep_operands(in_f, out_f, seed):
    """The JAX sweep's operands from numpy: one bf16 row quantized by
    `_quantize_row_q80`, qt [nb, 32, out] int8, the f16 plane N(0, 1) *
    0.01 as f32 and as raw bits."""
    rng = np.random.default_rng(seed)
    nb = in_f // 32
    qt = rng.integers(-8, 8, (nb, 32, out_f), dtype=np.int8)
    d16 = (rng.standard_normal((nb, out_f)) * 0.01).astype(np.float16)
    x = jnp.asarray(rng.standard_normal((1, in_f)), jnp.bfloat16)
    x8, xs = _quantize_row_q80(x, nb)
    return x8, xs, qt, d16


def _jax_call(kernel, x8, xs, qt, dt, tile_n, tile_knb):
    nb, _, out = qt.shape
    with pltpu.force_tpu_interpret_mode():  # read where the pallas_call is made
        call = jsweep.build_call(kernel, nb, out, tile_n, tile_knb)
        return np.asarray(call(x8, xs, _blockdiag_mask(tile_knb), jnp.asarray(qt), jnp.asarray(dt)))


@pytest.mark.parametrize("plane", ["f32", "i16"])
@pytest.mark.parametrize("tile_n,tile_knb,cols,blocks", [(256, 16, 64, 16), (512, 32, 128, 8)])
def test_p13_plain_matches_jax_build_call(plane, tile_n, tile_knb, cols, blocks):
    x8, xs, qt, d16 = _sweep_operands(1024, 512, seed=tile_n)
    kernel, dt = {"f32": (_kernel_i8, d16.astype(np.float32)),
                  "i16": (jsweep._kernel_i8_i16, d16.view(np.int16))}[plane]
    want = _jax_call(kernel, x8, xs, qt, dt, tile_n, tile_knb)
    px8, pxs, pqt, pdt = operands_from_jax(x8, xs, qt, dt, device="cpu")
    pdt = scale_planes(pdt)["i16"] if plane == "i16" else pdt
    assert pdt.dtype == {"f32": torch.float32, "i16": torch.int16}[plane]
    got = scales.i8_tile_call(px8, pxs, pqt, pdt, cols, blocks)  # CPU: the plain version
    assert got.shape == (1, 512) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= REL_TOL * np.abs(want).max()
    # the tile is the kernel's; the plain version's function does not move
    assert torch.equal(got, scales.i8_tile_call_plain(px8, pxs, pqt, pdt, 32, 32))


@pytest.mark.parametrize("plane", ["f32", "i16"])
def test_p2_plain_matches_jax_mm_kernel_i16(plane):
    """P2 against the JAX probe at its tile (1024, 64): the f32 plane
    through `_kernel_i8`, the raw-bits plane through `_mm_kernel_i16`; the
    port sums in the order of its own plan at the probe's 2048 -> 8192 (4
    columns a lane, all 8 warps along k, 2 splits of 32 blocks: 128 CTAs)."""
    x8, xs, qt, d16 = _sweep_operands(2048, 1024, seed=2)
    kernel, dt = {"f32": (_kernel_i8, d16.astype(np.float32)),
                  "i16": (jf16._mm_kernel_i16, d16.view(np.int16))}[plane]
    want = _jax_call(kernel, x8, xs, qt, dt, 1024, 64)
    px8, pxs, pqt, pdt = operands_from_jax(x8, xs, qt, dt, device="cpu")
    pdt = scale_planes(pdt)["i16"] if plane == "i16" else pdt
    got = scales.scale_plane_call(px8, pxs, pqt, pdt)
    assert np.abs(got.numpy() - want).max() <= REL_TOL * np.abs(want).max()
    assert scales.P2_SHAPE[1:] == (2048, 8192)
    plan = scales.i8_gemv_plan(2048 // 32, 8192)
    assert (plan.vec, plan.cols, plan.kw, plan.splits, plan.blocks_per_split) == (4, 128, 8, 2, 32)
    assert plan.ctas(8192) == 128


def test_p2_plain_matches_jax_mm_kernel_i16_on_exponent_31_patterns():
    """A raw-bits plane whose every row holds inf and NaN patterns (exponent
    31, both signs, mantissas 0..1023) beside ordinary scales:
    `_mm_kernel_i16`'s integer convert maps them to the finite 2^16 * (1 +
    mant / 1024), and so does P2's plain version (the kernel's compare and
    select), within REL_TOL of the JAX output's largest value."""
    x8, xs, qt, d16 = _sweep_operands(2048, 1024, seed=7)
    bits = d16.view(np.int16).copy()
    special = np.arange(1024, dtype=np.int32) | 0x7C00  # exponent 31, every mantissa
    special = np.where(np.arange(1024) % 2, special | 0x8000, special)  # both signs
    bits[::3] = special.astype(np.uint16).view(np.int16)  # every third block row
    want = _jax_call(jf16._mm_kernel_i16, x8, xs, qt, bits, 1024, 64)
    assert np.isfinite(want).all()
    px8, pxs, pqt, pdt = operands_from_jax(x8, xs, qt, bits, device="cpu")
    got = scales.scale_plane_call(px8, pxs, pqt, scale_planes(pdt)["i16"])
    assert torch.isfinite(got).all()
    assert np.abs(got.numpy() - want).max() <= REL_TOL * np.abs(want).max()


def test_scale_planes_are_three_storages_of_one_value():
    d16 = torch.from_numpy(np.random.default_rng(3).standard_normal((8, 40)).astype(np.float16))
    planes = scale_planes(d16)
    assert [planes[p].dtype for p in scales.PLANES] == [torch.float16, torch.float32, torch.int16]
    assert planes["i16"].data_ptr() == d16.data_ptr()  # a view, no copy
    for p in scales.PLANES:
        assert torch.equal(scales.plane_f32(planes[p]), d16.float())
    with pytest.raises(ValueError):
        scale_planes(d16.float())


def test_operands_from_jax_pass_an_f32_plane_through():
    x8, xs, qt, d16 = _sweep_operands(256, 64, seed=4)
    f32 = d16.astype(np.float32)
    got = operands_from_jax(x8, xs, qt, f32, device="cpu")[3]
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), f32)
    got = operands_from_jax(x8, xs, qt, d16.view(np.int16), device="cpu")[3]
    assert got.dtype == torch.float16 and np.array_equal(got.numpy(), d16)
    with pytest.raises(ValueError):
        operands_from_jax(x8, xs, qt, f32.astype(np.float64), device="cpu")


def test_wrappers_take_the_plain_version_on_the_cpu_and_count_nothing():
    x8, xs, qt, d16, _ = scales.make_operands(2048, 64, "cpu", seed=5)
    counts = [k.launches for k in scales.KERNELS]
    want = cuda_q40.i8_blocks_plain(x8, xs, qt, d16)
    planes = scale_planes(d16)
    for cols, blocks in scales.tiles_for(64):
        for p in scales.PLANES:
            assert torch.equal(scales.i8_tile_call(x8, xs, qt, planes[p], cols, blocks), want)
    for p in ("f32", "i16"):  # P2 sums in its plan's order
        got = scales.scale_plane_call(x8, xs, qt, planes[p])
        assert torch.equal(got, scales.scale_plane_call_plain(x8, xs, qt, planes[p]))
        assert (got - want).abs().max() <= REL_TOL * want.abs().max()
    bits = planes["i16"]
    assert torch.equal(scales.f16bits_to_f32(bits), scales.f16bits_to_f32_plain(bits))
    assert counts == [k.launches for k in scales.KERNELS]


def test_tile_and_plane_checks():
    x8, xs, qt, d16, _ = scales.make_operands(512, 64, "cpu")  # nb 16
    for cols, blocks in ((48, 8), (64, 3), (64, 0), (64, 32), (256, 8)):
        with pytest.raises(ValueError):
            scales.i8_tile_call(x8, xs, qt, d16, cols, blocks)
    with pytest.raises(ValueError):  # a bf16 plane
        scales.i8_tile_call(x8, xs, qt, d16.to(torch.bfloat16), 64, 8)
    with pytest.raises(ValueError):  # P2 takes the f32 and i16 planes, not B9's f16
        scales.scale_plane_call(x8, xs, qt, d16)
    with pytest.raises(ValueError):  # P2 takes at most 8 rows
        scales.scale_plane_call(x8.expand(9, -1).contiguous(), xs.expand(9, -1).contiguous(),
                                qt, d16.float())
    with pytest.raises(ValueError):
        scales.f16bits_to_f32(d16)  # f16, not its bits
    assert scales.tiles_for(448) == [(c, k) for c in (32, 64, 128) for k in (8, 16, 32, 64)]
    assert scales.tiles_for(128, quick=True) == [(64, 8), (64, 32), (128, 8), (128, 32)]


def test_work_counts_the_bytes_once():
    """The bound's bytes: weights, plane, int8 row, f32 row scales and the
    f32 output once each (the f16/i16 plane 2 bytes a block, f32 4)."""
    assert scales.work(1, 2048, 2048, 1.0, 2) == (2048 * 2048 + 64 * 2048 * 2 + 2048 + 256
                                                  + 2048 * 4, 2 * 2048 * 2048)
    assert round(scales.work(1, 4096, 128256, 1.0, 4)[0] / 1e6, 1) == 591.5
    assert round(scales.work(1, 2048, 32768, 0.5, 2)[0] / 1e6, 2) == 37.88


def test_scales_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):  # the card, unless told the CPU
        scales.main(["--shape", "256,64"])
    rows = scales.main(["--device", "cpu", "--shape", "1024,256", "--quick", "--seed", "1"])
    p1 = [r for r in rows if r["probe"] == "P1"]
    assert len(p1) == 1 + len(scales.CONVERT_SHAPES)
    assert all(r["bit_equal_plain"] and r["equal_f16_on_finite"] for r in p1)
    assert p1[0]["non_finite_patterns"] == 2048 and p1[0]["non_finite_give_finite"]
    p2 = [r for r in rows if r["probe"] == "P2"]
    assert [r["plane"] for r in p2] == ["f32", "i16"] and all(r["planes_bit_equal"] for r in p2)
    p13 = [r for r in rows if r["probe"] == "P13"]
    assert len(p13) == 3 * len(scales.tiles_for(32, quick=True))
    assert all(r["max_abs_err"] == 0.0 and r["planes_bit_equal"] for r in p13)
    out = capsys.readouterr().out
    assert "not measured" in out and "no CTA counterpart" in out
    assert scales.SHAPES_1B[3] == ("1B wcls 2048->32768", 2048, 32768)
    assert scales.SHAPES_8B[3] == ("8B wcls 4096->128256", 4096, 128256)
