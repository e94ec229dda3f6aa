"""P9 and P10: the feature-split unsigned-nibble codec for the int8 decode
matmul (the counterparts of the JAX package's scripts/probe_int4c.py), held
against K1, which reads the same bytes.

The codec (`pack_feature_split`): byte [b, s, o] (s < 16) holds u = q + 8 of
feature s of block b in its low nibble and of feature s + 16 in its high
nibble, and word [b, g, o] is bytes 4g..4g+3 little-endian. That is the
port's T layout byte for byte (ops/quant.py `pack_q`, flattened to
[nb * 4, out]): the operand K1 (ops/cuda_q40.py, csrc/q40_gemv.cu) reads with
`__dp4a`. Here the int8 tensor cores read it instead, through a loader of
the int8-MMA template (csrc/q40_i8_mma.cuh, csrc/i4_codec_probe.cu): word g
masked by 0x0F0F0F0F holds k = 4g..4g+3 of the column, shifted down by 4
k = 16+4g..16+4g+3, and the integer dot with u less 8 * bs (the row block's
sum of x8, probes/int4b.py `block_sums`) is the signed partial exactly.

  * P9 `fs2d_call(x8, xs, bs, qp2d, dt, cols, blocks_per_cta)`
    (probe_int4c.py:145, body `_kernel_fs2d` :110): the words as
    [nb * 4, out] int32;
  * P10 `fs_call(...)` (:173, body `_kernel_fs` :75): the same words as
    [nb, 4, out].

The JAX kernels differ only in how the TPU pads a vreg (the 3-D block
leaves half of each int32 vreg empty); on the card the two are one instance
on the same bytes through two views, and agree bit for bit. The JAX probes
split x8 into features 0-15 and 16-31 (x8a, x8b) for two block-diagonal
dots; the m16n8k32 MMA takes the whole 32-wide block, so the port takes x8
whole (`operands.split_operands_from_jax` rejoins them). dt is the f16
plane (K1's operand) or its raw int16 bits (the JAX probes' `_dt_operand`).
A CTA owns `cols` output columns (32, 64 or 128; the JAX tile_n of 256..4096
is a TPU lane width with no CTA counterpart) and `blocks_per_cta` blocks
(tile_knb). Each wrapper takes its plain version (K1's plain GEMV over the
plane's f32 values) for CPU tensors, launches its kernel for CUDA tensors
or raises, and counts its launches in `launches`.

    python -m distributed_llama_tpu_torch.probes.int4c [--device cpu] [--only LABEL]
        [--seed N] [--shape IN,OUT ...]

runs the JAX script's five Llama-3.2-1B shapes (or the `--shape`s given):
B9's baseline and the first K1's body at its tile on the same q and d, then every
tile of `tiles_for` with the f16 and the i16 plane (P9 timed, P10 launched
on the same operands and held bit-equal to it), each against the plain
version; on the card each point's cold and hot µs a call, a chain of 64
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
from ..ops.cuda_q40 import W_FS
from .int4 import make_operands
from .int4b import (SHAPES, baselines, best, block_sums, launch_u4, parse_args,
                    plain_ms, planes, point, print_shape, time_point, work)
from .scales import check_tile, plane_f32, tiles_for

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


def _operands(x8, xs, bs, q3, dt, cols: int, blocks_per_cta: int) -> None:
    cuda_q40.check_u4_operands(x8, xs, bs, q3, dt, W_FS)
    check_tile(q3.shape[0], cols, blocks_per_cta)


def _words_2d(qp2d) -> torch.Tensor:
    """P9's [nb * 4, out] int32 words -> their [nb, 4, out] view."""
    if qp2d.ndim != 2 or qp2d.dtype != torch.int32 or qp2d.shape[0] % 4:
        raise ValueError(f"qp2d must be [nb * 4, out] int32, got {qp2d.dtype} "
                         f"{tuple(qp2d.shape)}")
    if not qp2d.is_contiguous():
        raise ValueError("qp2d must be contiguous")
    return qp2d.view(qp2d.shape[0] // 4, 4, qp2d.shape[1])


def fs_call_plain(x8, xs, bs, qp, dt, cols: int, blocks_per_cta: int) -> torch.Tensor:
    """P10's (and P9's) plain version: K1's GEMV math, the dot with u less
    8 * bs, on the plane's f32 values -> [R, out] f32. The tile changes only
    the order of the f32 block sums."""
    _operands(x8, xs, bs, qp, dt, cols, blocks_per_cta)
    return cuda_q40.q80_gemv_plain(x8, xs, bs, qp.reshape(-1, qp.shape[-1]), plane_f32(dt))


def fs2d_call_plain(x8, xs, bs, qp2d, dt, cols: int, blocks_per_cta: int) -> torch.Tensor:
    """P9's plain version: P10's on the [nb, 4, out] view."""
    return fs_call_plain(x8, xs, bs, _words_2d(qp2d), dt, cols, blocks_per_cta)


def _call(wrapper, x8, xs, bs, q3, dt, cols: int, blocks_per_cta: int) -> torch.Tensor:
    if cuda_q40._device_kind(x8) == "cpu":
        return fs_call_plain(x8, xs, bs, q3, dt, cols, blocks_per_cta)
    _operands(x8, xs, bs, q3, dt, cols, blocks_per_cta)
    out = launch_u4(x8, xs, bs, q3, W_FS, dt, cols, blocks_per_cta)
    wrapper.launches += 1
    return out


def fs2d_call(x8, xs, bs, qp2d, dt, cols: int, blocks_per_cta: int) -> torch.Tensor:
    """P9: x8 [R <= 8, in] int8, xs [R, nb] f32, bs [R, nb] int32 block sums
    of x8, qp2d [nb * 4, out] int32 feature-split words (the T layout), dt
    [nb, out] f16 or int16 (raw f16 bits) -> [R, out] f32, at a CTA of
    `cols` columns owning `blocks_per_cta` blocks."""
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
    then every tile with each plane: P9 against the plain version and
    timed, P10 on the same operands bit-equal to it; then P10 timed at P9's
    best tile a plane. Returns {"baseline": rows, "tiles": rows}."""
    nb = in_f // Q_BLOCK
    x8, xs, qt, dt16, x = make_operands(in_f, out_f, 1, device, seed)
    bs = block_sums(x8, nb)
    qp = pack_feature_split(qt)
    qp2d = qp.view(nb * 4, out_f)
    base, lib = baselines(label, in_f, out_f, x8, xs, bs, qt, qp2d, dt16, x, time_it)
    b9 = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt16)
    dts = planes(dt16)
    want = {p: fs2d_call_plain(x8, xs, bs, qp2d, d, 64, nb) for p, d in dts.items()}
    extra = {p: {"plain_ms": plain_ms(fs2d_call_plain, x8, xs, bs, qp2d, d, 64, nb), **lib}
             for p, d in dts.items()} if time_it else {}
    rows = []
    for cols, blocks in tiles_for(nb):
        outs = {}
        for plane, d in dts.items():
            outs[plane] = got = fs2d_call(x8, xs, bs, qp2d, d, cols, blocks)
            row = point(label, in_f, out_f, "P9", "fs2d_call", plane, cols, blocks, got,
                        want[plane], b9, {"views_bit_equal": torch.equal(
                            got, fs_call(x8, xs, bs, qp, d, cols, blocks))})
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
            row = point(label, in_f, out_f, "P10", "fs_call", plane, r["cols"],
                        r["blocks_per_cta"], got, want[plane], b9,
                        {"views_bit_equal": torch.equal(got, fs2d_call(
                            x8, xs, bs, qp2d, d, r["cols"], r["blocks_per_cta"])),
                         "planes_bit_equal": r["planes_bit_equal"]})
            time_point(row, fs_call, (x8, xs, bs, qp, d, r["cols"], r["blocks_per_cta"]), base,
                       extra[plane])
            rows.append(row)
    return {"baseline": base, "tiles": rows}


def main(argv=None) -> list:
    """Run P9 and P10 over their shapes; print the baselines, one line a
    point and the best tile per shape and plane; return the rows."""
    args, device, time_it = parse_args("int4c", argv)
    print("fs2d ([nb*4, out], P9) and fs3d ([nb, 4, out], P10): one instance on the card (the "
          "same words; the JAX variants differ in TPU vreg padding); JAX tile_n (256..4096) is "
          "a TPU lane width with no CTA counterpart: TN sweeps 32, 64 and 128 columns a CTA; "
          "tile_knb -> blocks a CTA", flush=True)
    rows = []
    for label, in_f, out_f in args.shape or SHAPES:
        if args.only and args.only not in label:
            continue
        got = sweep_shape(label, in_f, out_f, device, args.seed, time_it)
        w = work(1, in_f, out_f)
        print(f"== {label} packed {w['phys_bytes'] / 1e6:.2f} MB ==", flush=True)
        print_shape(label, got["baseline"], [r for r in got["tiles"] if r["probe"] == "P9"],
                    time_it, ("views_bit_equal", "planes_bit_equal"))
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
