"""P9 and P10: the feature-split unsigned-nibble codec for the int8 decode
matmul (the counterparts of the JAX package's scripts/probe_int4c.py), held
against K1, which reads the same bytes.

The codec (`pack_feature_split`): byte [b, s, o] (s < 16) holds u = q + 8 of
feature s of block b in its low nibble and of feature s + 16 in its high
nibble, and word [b, g, o] is bytes 4g..4g+3 little-endian. That is the
port's T layout byte for byte (ops/quant.py `pack_q`, flattened to
[nb * 4, out]): the operand K1 (ops/cuda_q40.py, csrc/q40_gemv.cu) reads with
`__dp4a`. Here the same words go through the W_FS loader of the one-row
GEMV template (csrc/i8_gemv.cuh, csrc/i4_codec_probe.cu; probes/gemv.py
`launch_u4_gemv`): a lane loads its 8 columns of a word row in one wide
load, word g masked by 0x0F0F0F0F holds k = 4g..4g+3 of the column, shifted
down by 4 k = 16+4g..16+4g+3 (the natural k order: x is staged as it is),
and the __dp4a dot with u less 8 * bs (the row block's sum of x8,
probes/int4b.py `block_sums`) is the signed partial exactly: K1's body on
K1's operand, with x8, xs and bs given.

  * P9 `fs2d_call(x8, xs, bs, qp2d, dt, cols, blocks_per_cta)`
    (probe_int4c.py:145, body `_kernel_fs2d` :110): the words as
    [nb * 4, out] int32;
  * P10 `fs_call(...)` (:173, body `_kernel_fs` :75): the same words as
    [nb, 4, out].

The JAX kernels differ only in how the TPU pads a vreg (the 3-D block
leaves half of each int32 vreg empty); on the card the two are one instance
on the same bytes through two views, and agree bit for bit. The JAX probes
split x8 into features 0-15 and 16-31 (x8a, x8b) for two block-diagonal
dots; the __dp4a dot takes the whole 32-wide block, so the port takes x8
whole (`operands.split_operands_from_jax` rejoins them). dt is the f16
plane (K1's operand) or its raw int16 bits (the JAX probes' `_dt_operand`).
The tile is the plan (`gemv.u4_tile_plan`): a CTA owns `cols` output
columns (one of `gemv.u4_tile_cols(W_FS)`, 8 a lane; the JAX tile_n of
256..4096 is a TPU lane width with no CTA counterpart) and a split
`blocks_per_cta` blocks (tile_knb; a divisor of nb, at most 8 splits, the
cluster limit: `tiles_for` leaves out and counts the JAX tiles past it).
Each wrapper takes its plain version (K1's per-block terms summed in the
plan's order, bit for bit the kernel's) for CPU tensors, launches its
kernel for CUDA tensors or raises, and counts its launches in `launches`;
`gemv.u4_gemv_plan(nb, out, W_FS)` is the default plan.

    python -m distributed_llama_tpu_torch.probes.int4c [--device cpu] [--only LABEL]
        [--seed N] [--shape IN,OUT ...]

runs the JAX script's five Llama-3.2-1B shapes (or the `--shape`s given):
B9's baseline and the first K1's body at its tile on the same q and d, then every
tile of `tiles_for` with the f16 and the i16 plane (P9 timed, P10 launched
on the same operands and held bit-equal to it), each bit for bit against
the plain order of its plan and within 1e-5 of B9, at P3's plan against
P3's int8 arm; on the card each point's cold and hot µs a call, a chain of 64
calls in one CUDA graph, GB/s against the bytes the script counts (half a
byte a weight, 2 a block), its CTAs and its speed against B9 and that body; then
the best tile per shape and plane, and P10 timed at P9's best tile. Without
`--device cpu` it needs a CUDA device and raises otherwise.
"""

from __future__ import annotations

import json

import torch

from ..formats.quants import Q_BLOCK
from ..ops import cuda_q40
from ..ops.cuda_q40 import _gemv_order, _gemv_terms
from . import gemv
from .gemv import W_FS
from .int4 import i4_call_int8, make_operands, pack_s4
from .int4b import (FLAGS, SHAPES, baselines, best, block_sums, parse_args, plain_ms, planes,
                    point, print_shape, time_point, work)
from .scales import plane_f32

HGRP = Q_BLOCK // 2  # features a nibble plane


def pack_feature_split(qt: torch.Tensor) -> torch.Tensor:
    """[nb, 32, out] int8 in [-8, 7] -> [nb, 4, out] int32 feature-split
    words, on qt's device: byte k of word [b, g, o] = (q[b, 4g + k, o] + 8) |
    ((q[b, 16 + 4g + k, o] + 8) << 4)."""
    nb, _, out = qt.shape
    u = qt.to(torch.int32) + 8
    b8 = u[:, :HGRP, :] | (u[:, HGRP:, :] << 4)  # [nb, 16, out]
    b4 = b8.reshape(nb, 4, 4, out)  # [b, g, k, o]
    # byte 3 << 24 wraps into the sign bit, as the words' int32 view does
    return b4[:, :, 0] | (b4[:, :, 1] << 8) | (b4[:, :, 2] << 16) | (b4[:, :, 3] << 24)


def tiles_for(nb: int, out_f: int) -> tuple[list, int]:
    """P9's and P10's (cols, blocks_per_cta) tiles at nb blocks by out_f
    columns, and the count of the JAX tiles past the cluster limit left
    out."""
    return gemv.u4_tiles_for(nb, out_f, W_FS)


def _operands(x8, xs, bs, q3, dt, cols: int, blocks_per_cta: int):
    """Check the operands and tile; return the tile's plan."""
    gemv.check_u4_operands(x8, xs, bs, q3, dt, W_FS)
    return gemv.u4_tile_plan(q3.shape[0], q3.shape[2], cols, blocks_per_cta, W_FS)


def _words_2d(qp2d) -> torch.Tensor:
    """P9's [nb * 4, out] int32 words -> their [nb, 4, out] view."""
    if qp2d.ndim != 2 or qp2d.dtype != torch.int32 or qp2d.shape[0] % 4:
        raise ValueError(f"qp2d must be [nb * 4, out] int32, got {qp2d.dtype} "
                         f"{tuple(qp2d.shape)}")
    if not qp2d.is_contiguous():
        raise ValueError("qp2d must be contiguous")
    return qp2d.view(qp2d.shape[0] // 4, 4, qp2d.shape[1])


def fs_call_plain(x8, xs, bs, qp, dt, cols: int, blocks_per_cta: int) -> torch.Tensor:
    """P10's (and P9's) plain version: K1's per-block terms (the dot with u
    less 8 * bs, times xs * dt, on the plane's f32 values) summed in the
    tile's plan's order -> [R, out] f32, bit for bit the kernel's."""
    plan = _operands(x8, xs, bs, qp, dt, cols, blocks_per_cta)
    terms = _gemv_terms(x8, xs, bs, qp.reshape(-1, qp.shape[-1]), plane_f32(dt))
    return _gemv_order(terms, plan)


def fs2d_call_plain(x8, xs, bs, qp2d, dt, cols: int, blocks_per_cta: int) -> torch.Tensor:
    """P9's plain version: P10's on the [nb, 4, out] view."""
    return fs_call_plain(x8, xs, bs, _words_2d(qp2d), dt, cols, blocks_per_cta)


def _call(wrapper, x8, xs, bs, q3, dt, cols: int, blocks_per_cta: int) -> torch.Tensor:
    if cuda_q40._device_kind(x8) == "cpu":
        return fs_call_plain(x8, xs, bs, q3, dt, cols, blocks_per_cta)
    plan = _operands(x8, xs, bs, q3, dt, cols, blocks_per_cta)
    out = gemv.launch_u4_gemv(x8, xs, bs, q3, W_FS, dt, plan)
    wrapper.launches += 1
    return out


def fs2d_call(x8, xs, bs, qp2d, dt, cols: int, blocks_per_cta: int) -> torch.Tensor:
    """P9: x8 [R <= 8, in] int8, xs [R, nb] f32, bs [R, nb] int32 block sums
    of x8, qp2d [nb * 4, out] int32 feature-split words (the T layout), dt
    [nb, out] f16 or int16 (raw f16 bits) -> [R, out] f32, at a CTA of
    `cols` columns and splits of `blocks_per_cta` blocks (the plan
    `gemv.u4_tile_plan`), one launch."""
    return _call(fs2d_call, x8, xs, bs, _words_2d(qp2d), dt, cols, blocks_per_cta)


def fs_call(x8, xs, bs, qp, dt, cols: int, blocks_per_cta: int) -> torch.Tensor:
    """P10: P9 on the words as [nb, 4, out] int32; the same instance."""
    return _call(fs_call, x8, xs, bs, qp, dt, cols, blocks_per_cta)


fs2d_call.launches = 0
fs_call.launches = 0

KERNELS = (fs2d_call, fs_call)

# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------


def sweep_shape(label: str, in_f: int, out_f: int, device, seed: int = 0,
                time_it: bool = True) -> dict:
    """One shape: the baselines (K1 on the very words and plane P9 reads),
    then every tile with each plane: P9 against the plain order of the
    tile's plan bit for bit, against B9 and timed, P10 on the same operands
    bit-equal to it, at P3's plan against P3's int8 arm; then P10 timed at
    P9's best tile a plane. Returns {"baseline": rows, "tiles": rows,
    "left_out": the JAX tiles past the cluster limit}."""
    nb = in_f // Q_BLOCK
    x8, xs, qt, dt16, x = make_operands(in_f, out_f, 1, device, seed)
    bs = block_sums(x8, nb)
    qp = pack_feature_split(qt)
    qp2d = qp.view(nb * 4, out_f)
    base, lib = baselines(label, in_f, out_f, x8, xs, bs, qt, qp2d, dt16, x, time_it)
    b9 = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt16)
    dts = planes(dt16)
    terms = {p: gemv.block_terms(x8, xs, qt, plane_f32(d)) for p, d in dts.items()}
    tiles, left_out = tiles_for(nb, out_f)
    default = gemv.u4_gemv_plan(nb, out_f, W_FS)
    default = (default.cols, default.blocks_per_split)
    p3 = gemv.u4_p3_tile(nb, out_f, W_FS)
    p3_out = i4_call_int8(x8, xs, pack_s4(qt), dt16) if p3 in tiles else None
    extra = {p: {"plain_ms": plain_ms(fs2d_call_plain, x8, xs, bs, qp2d, d, *default), **lib}
             for p, d in dts.items()} if time_it else {}
    rows = []
    for cols, blocks in tiles:
        plan = gemv.u4_tile_plan(nb, out_f, cols, blocks, W_FS)
        outs = {}
        for plane, d in dts.items():
            outs[plane] = got = fs2d_call(x8, xs, bs, qp2d, d, cols, blocks)
            want = _gemv_order(terms[plane], plan)
            flags = {"views_bit_equal": torch.equal(got, fs_call(x8, xs, bs, qp, d, cols, blocks)),
                     "bit_equal_plain": torch.equal(got, want),
                     "default_plan": (cols, blocks) == default, "p3_plan": (cols, blocks) == p3}
            if flags["p3_plan"]:
                flags["equals_p3"] = torch.equal(got, p3_out)
            row = point(label, in_f, out_f, "P9", "fs2d_call", plane, cols, blocks, got, want, b9,
                        flags)
            if time_it:
                time_point(row, fs2d_call, (x8, xs, bs, qp2d, d, cols, blocks), base,
                           extra[plane])
            rows.append(row)
        for row in rows[-len(dts):]:
            row["planes_bit_equal"] = torch.equal(outs["f16"], outs["i16"])
    if time_it:
        for plane, d in dts.items():
            r = best(rows, plane)
            got = fs_call(x8, xs, bs, qp, d, r["cols"], r["blocks_per_cta"])
            want = _gemv_order(terms[plane], gemv.u4_tile_plan(nb, out_f, r["cols"],
                                                               r["blocks_per_cta"], W_FS))
            row = point(label, in_f, out_f, "P10", "fs_call", plane, r["cols"],
                        r["blocks_per_cta"], got, want, b9,
                        {"views_bit_equal": torch.equal(got, fs2d_call(
                            x8, xs, bs, qp2d, d, r["cols"], r["blocks_per_cta"])),
                         "bit_equal_plain": torch.equal(got, want),
                         "planes_bit_equal": r["planes_bit_equal"]})
            time_point(row, fs_call, (x8, xs, bs, qp, d, r["cols"], r["blocks_per_cta"]), base,
                       extra[plane])
            rows.append(row)
    return {"baseline": base, "tiles": rows, "left_out": left_out}


def main(argv=None) -> list:
    """Run P9 and P10 over their shapes; print the baselines, one line a
    point and the best tile per shape and plane; return the rows."""
    args, device, time_it = parse_args("int4c", argv)
    cols = "/".join(map(str, gemv.u4_tile_cols(W_FS)))
    print(f"fs2d ([nb*4, out], P9) and fs3d ([nb, 4, out], P10): one instance on the card (the "
          f"same words; the JAX variants differ in TPU vreg padding); JAX tile_n (256..4096) is "
          f"a TPU lane width with no CTA counterpart: TN sweeps {cols} columns a CTA, 8 a "
          f"lane; tile_knb -> blocks a split, at most {gemv.MAX_SPLITS} splits", flush=True)
    rows = []
    for label, in_f, out_f in args.shape or SHAPES:
        if args.only and args.only not in label:
            continue
        got = sweep_shape(label, in_f, out_f, device, args.seed, time_it)
        w = work(1, in_f, out_f)
        print(f"== {label} packed {w['phys_bytes'] / 1e6:.2f} MB | {got['left_out']} JAX tiles "
              f"left out (more than {gemv.MAX_SPLITS} splits) ==", flush=True)
        print_shape(label, got["baseline"], [r for r in got["tiles"] if r["probe"] == "P9"],
                    time_it, ("views_bit_equal", *FLAGS))
        for r in got["tiles"]:
            if r["probe"] == "P10":
                print(f"  P10 {r['plane']} at P9's best TN {r['cols']} x {r['blocks_per_cta']}: "
                      f"bit-equal to P9 {r['views_bit_equal']}; cold {r['cold_ms'] * 1e3:.2f} us "
                      f"({r['x_first_k1']:.2f}x first K1), hot {r['hot_ms'] * 1e3:.2f} us",
                      flush=True)
        rows.extend(got["baseline"])
        rows.extend(got["tiles"])
    print(json.dumps({"probe": "int4c", "device": str(device), "rows": len(rows)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
