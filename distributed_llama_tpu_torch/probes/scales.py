"""P1, P2 and P13: what the scale plane's storage and the CTA tile cost the
int8 decode matmul (the counterparts of the JAX package's
scripts/probe_f16_scales.py and scripts/sweep_i8_tiles.py).

B9 (`ops/cuda_q40.py:q40_i8_unpacked`) reads an f16 scale plane [nb, out]
at 64 output columns a CTA and a split-K chosen from the shape. The JAX
probes ask what the plane's storage and the tile cost:

  * P1 `f16bits_to_f32(bits)` (csrc/i8_tile_probe.cu, probe_f16_scales.py
    :48): an int16 plane of raw f16 bits -> f32 with integer ops alone
    (sign, exponent + 112, mantissa << 13; exponent 0 gives mant * 2^-24).
    Equal to the f16 value for every finite f16; the inf and NaN patterns
    give finite values, as the JAX function's do;
  * P13 `i8_tile_call(x8, xs, qt, dt, cols, blocks_per_cta)`
    (csrc/i8_tile_probe.cu, sweep_i8_tiles.py:69): B9's kernel with the
    plane stored as f16, f32 or raw f16 bits (read from dt's dtype:
    float16, float32, int16), a CTA owning `cols` output columns (32, 64
    or 128) and `blocks_per_cta` 32-blocks (a divisor of nb; the nb /
    blocks_per_cta splits are summed in split order). Of the JAX grid's
    (tile_n, tile_knb), tile_knb is blocks_per_cta; tile_n (256..2048) is a
    TPU lane width, and no CTA that wide makes sense on the card, so the
    sweep takes 32, 64 and 128 columns instead;
  * P2 `scale_plane_call(x8, xs, qt, dt)` (probe_f16_scales.py:118, the
    inner `build`; bodies _kernel_i8 and _mm_kernel_i16 :72): the same
    function on an f32 or raw-bits plane, 2048 -> 8192 in the probe, as
    its own one-row GEMV on the CUDA cores (csrc/i8_gemv_probe.cu, the
    template of csrc/i8_gemv.cuh that P3 and P6 share): a lane
    owns 4 or 8 consecutive columns, transposes each 4 x 4 byte patch in
    registers and takes __dp4a, at the plan `i8_gemv_plan(nb, out)` of the
    shape alone (columns a lane, warps along the contraction, a split-K
    over a thread-block cluster merged in order). The JAX default tile
    (1024, 64) maps to P2_TILE, 128 columns and 64 blocks a CTA: P13 there
    is the int8-MMA design P2 had before, the A/B's old arm
    (probes/p2_p12_ab.py).

P13's instances at one tile give the same f32 scale for every finite f16
and the same exact integer partials, so on the card its three planes agree
bit for bit, and P13 at 64 columns and B9's split is B9 bit for bit. P2's
two planes agree bit for bit on every bit pattern, and P2 equals its plain
version, which repeats its plan's order, bit for bit. Each
wrapper takes its plain version for CPU tensors, launches its kernel for
CUDA tensors or raises, and counts its launches in `launches`.

    python -m distributed_llama_tpu_torch.probes.scales [--device cpu] [--1b | --8b] [--quick]
        [--seed N] [--shape IN,OUT ...]

runs P1 (the JAX shapes [64, 256] and [128, 256], every bit pattern, and
the 1B wcls plane [64, 128256]), P2 at its shape, and the P13 sweep at the
JAX script's eight shapes (`--1b`: its four 1B shapes, `--8b`: its four 8B
ones; `--quick`: fewer tiles): each point's cold and hot µs a call
(probes/timing.py), a chain of 64 calls in one CUDA graph (the JAX
lax.scan chain), GB/s against the bytes moved and its CTAs; then the best
tile per shape and plane. Without `--device cpu` it needs a CUDA device and
raises otherwise.
"""

from __future__ import annotations

import argparse
import json
from functools import partial

import numpy as np
import torch

from ..device import resolve_device
from ..formats.quants import Q_BLOCK
from ..ops import cuda_q40, kernels
from ..ops.cuda_q40 import GemvPlan, _gemv_order, i8_blocks_plain, quantize_rows_q80
from . import gemv, parse_shape
from .operands import scale_planes

SOURCE = "i8_tile_probe"
P2_SOURCE = "i8_gemv_probe"
_SIG = {
    # x8, xs, qt, dt, scale_kind, out, part, rows, nb, out, cols,
    # blocks_per_cta, stream
    "q40_i8_mma_tiled": (
        kernels.P, kernels.P, kernels.P, kernels.P, kernels.I, kernels.P, kernels.P, kernels.I,
        kernels.I, kernels.I, kernels.I, kernels.I, kernels.P,
    ),
    # bits, out, n, stream
    "f16bits_to_f32": (kernels.P, kernels.P, kernels.LL, kernels.P),
}
_P2_SIG = {
    # x8, xs, qt, dt, scale_kind, out, rows, nb, out, vec, cols, kw, splits,
    # blocks_per_split, stream
    "i8_gemv": (
        kernels.P, kernels.P, kernels.P, kernels.P, kernels.I, kernels.P, kernels.I, kernels.I,
        kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.P,
    ),
}
# the plane's storage -> q40_i8_mma_tiled's scale_kind
SCALE_KINDS = {torch.float16: 0, torch.float32: 1, torch.int16: 2}
PLANES = ("f16", "f32", "i16")
TILE_COLS = (32, 64, 128)  # output columns a CTA (the template's TN)
SWEEP_BLOCKS = (8, 16, 32, 64, 128)  # blocks a CTA, where they divide nb
QUICK_COLS, QUICK_BLOCKS = (64, 128), (8, 32)  # --quick
P2_TILE = (128, 64)  # the JAX default (tile_n 1024, tile_knb 64): P13's, the old P2
# P2's plans (csrc/i8_gemv_probe.cu): columns a lane, warps along the
# contraction (of 8 a CTA) and the split-K, chosen by probes/p2_p12_ab.py
# --sweep at 2048 -> 8192
P2_VEC, P2_KW = 4, 8
P2_TARGET_CTAS = 128  # CTAs the split-K aims a call at (132 SMs)
P2_MAX_SPLITS, P2_MAX_BPS, P2_WARPS = gemv.MAX_SPLITS, gemv.MAX_BPS, gemv.WARPS
P2_SHAPE = ("ffn 2048->8192", 2048, 8192)
CHAIN = 64  # calls in one chained graph, as the JAX probes' lax.scan
# the JAX sweep's shapes: Llama-3.2-1B and Llama-3.1-8B layer shapes
SHAPES_1B = (
    ("1B qkvo 2048->2048", 2048, 2048),
    ("1B w1/w3 2048->8192", 2048, 8192),
    ("1B w2 8192->2048", 8192, 2048),
    ("1B wcls 2048->32768", 2048, 32768),
)
SHAPES_8B = (
    ("8B q/wo 4096->4096", 4096, 4096),
    ("8B w1/w3 4096->14336", 4096, 14336),
    ("8B w2 14336->4096", 14336, 4096),
    ("8B wcls 4096->128256", 4096, 128256),
)
# P1: (label, rows, columns); the JAX probe's tile over rows (64 and 8)
# has no counterpart: the convert is one elementwise pass
CONVERT_SHAPES = (
    ("[64, 256] (JAX tiles 64 and 8)", 64, 256),
    ("[128, 256]", 128, 256),
    ("1B wcls plane [64, 128256]", 64, 128256),
)

# ---------------------------------------------------------------------------
# P1: raw f16 bits -> f32
# ---------------------------------------------------------------------------


def f16bits_to_f32_plain(bits: torch.Tensor) -> torch.Tensor:
    """P1's plain version: the JAX `f16bits_to_f32` in torch integer ops."""
    h = bits.to(torch.int32) & 0xFFFF
    sign = (h & 0x8000) << 16
    ex = (h >> 10) & 0x1F
    mant = h & 0x3FF
    normal = (sign | ((ex + 112) << 23) | (mant << 13)).view(torch.float32)
    signf = torch.where(sign != 0, -1.0, 1.0).to(torch.float32)
    sub = mant.to(torch.float32) * 2.0 ** -24 * signf
    return torch.where(ex == 0, sub, normal)


def f16bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """P1: a contiguous int16 plane of raw f16 bits -> f32 of its shape."""
    if bits.dtype != torch.int16 or not bits.is_contiguous() or bits.numel() == 0:
        raise ValueError(f"expected a non-empty contiguous int16 plane, got {bits.dtype} "
                         f"{tuple(bits.shape)}")
    if cuda_q40._device_kind(bits) == "cpu":
        return f16bits_to_f32_plain(bits)
    if bits.data_ptr() % 8:
        raise ValueError("the plane must start on an 8-byte boundary")
    out = torch.empty(bits.shape, dtype=torch.float32, device=bits.device)
    lib = kernels.load(SOURCE, _SIG)
    kernels.launch(
        lib, "f16bits_to_f32", bits,
        bits.data_ptr(), out.data_ptr(), bits.numel(),
    )
    f16bits_to_f32.launches += 1
    return out


f16bits_to_f32.launches = 0


def f16_view_float(bits: torch.Tensor) -> torch.Tensor:
    """P1's library yardstick: torch's own f16 -> f32 on the bits' view
    (the same function on finite values only)."""
    return bits.view(torch.float16).float()


# ---------------------------------------------------------------------------
# P13 and P2: B9's kernel by tile and scale storage
# ---------------------------------------------------------------------------


def check_tile(nb: int, cols: int, blocks_per_cta: int) -> None:
    if cols not in TILE_COLS:
        raise ValueError(f"cols must be one of {TILE_COLS}, got {cols}")
    if blocks_per_cta < 1 or nb % blocks_per_cta:
        raise ValueError(f"blocks_per_cta must divide nb = {nb}, got {blocks_per_cta}")


def plane_f32(dt: torch.Tensor) -> torch.Tensor:
    """A scale plane in any of the three storages -> its f32 values."""
    if dt.dtype == torch.int16:
        return f16bits_to_f32_plain(dt)
    return dt.to(torch.float32)


def launch_tiled(x8, xs, qt, dt, cols: int, blocks_per_cta: int) -> torch.Tensor:
    """One launch of csrc/i8_tile_probe.cu's q40_i8_mma_tiled on checked
    operands on the card."""
    if cuda_q40._device_kind(x8) != "cuda":
        raise ValueError(f"q40_i8_mma_tiled runs on a CUDA device, not {x8.device}")
    R, nb, out_f = x8.shape[0], qt.shape[0], qt.shape[2]
    splits = nb // blocks_per_cta
    lib = kernels.load(SOURCE, _SIG)
    out = torch.empty((R, out_f), dtype=torch.float32, device=x8.device)
    part = torch.empty((splits, R, out_f) if splits > 1 else (1,), dtype=torch.float32,
                       device=x8.device)
    kernels.launch(
        lib, "q40_i8_mma_tiled", x8,
        x8.data_ptr(), xs.data_ptr(), qt.data_ptr(), dt.data_ptr(), SCALE_KINDS[dt.dtype],
        out.data_ptr(), part.data_ptr(), R, nb, out_f, cols, blocks_per_cta,
    )
    return out


def i8_tile_call_plain(x8, xs, qt, dt, cols: int, blocks_per_cta: int) -> torch.Tensor:
    """P13's (and P2's) plain version: B9's math on the plane's f32 values;
    the tile changes only the order of the f32 block sums."""
    check_tile(qt.shape[0], cols, blocks_per_cta)
    return i8_blocks_plain(x8, xs, qt, plane_f32(dt))


def i8_tile_call(x8, xs, qt, dt, cols: int, blocks_per_cta: int) -> torch.Tensor:
    """P13: x8 [R <= 8, in] int8, xs [R, nb] f32, qt [nb, 32, out] int8, dt
    [nb, out] float16, float32 or int16 (raw f16 bits) -> [R, out] f32, at
    a CTA of `cols` columns owning `blocks_per_cta` blocks."""
    cuda_q40.check_i8_operands(x8, xs, qt, dt, Q_BLOCK, torch.int8, dt_dtypes=tuple(SCALE_KINDS))
    check_tile(qt.shape[0], cols, blocks_per_cta)
    if cuda_q40._device_kind(x8) == "cpu":
        return i8_tile_call_plain(x8, xs, qt, dt, cols, blocks_per_cta)
    out = launch_tiled(x8, xs, qt, dt, cols, blocks_per_cta)
    i8_tile_call.launches += 1
    return out


i8_tile_call.launches = 0


def i8_gemv_plan(nb: int, out_f: int) -> GemvPlan:
    """P2's plan for a weight of nb blocks by out_f columns (a multiple of
    8): the probes' GEMV rule (probes/gemv.py probe_plan) at P2_VEC columns
    a lane and P2_KW warps along its contraction range, aiming at
    P2_TARGET_CTAS while every warp keeps its loads in flight (64 / (8 *
    P2_VEC) blocks of int8 weights)."""
    flight = gemv.FLIGHT_WORDS // gemv.block_words("i8", P2_VEC)
    return gemv.probe_plan(nb, out_f, P2_VEC, P2_KW, flight, P2_TARGET_CTAS)


def scale_plane_terms(x8, xs, qt, dt) -> torch.Tensor:
    """P2's per-block terms [nb, R, out] = p * (xs * dt) in f32, each
    product rounded once as the kernel rounds it."""
    return gemv.block_terms(x8, xs, qt, plane_f32(dt))


def scale_plane_call_plain(x8, xs, qt, dt, plan: GemvPlan | None = None) -> torch.Tensor:
    """P2's plain version: its terms summed in the kernel's order under
    `plan` (by default `i8_gemv_plan`): blocks in order within a warp's
    run, the warps in order, then the splits in order. Bit for bit the
    kernel's."""
    plan = plan or i8_gemv_plan(qt.shape[0], qt.shape[2])
    return _gemv_order(scale_plane_terms(x8, xs, qt, dt), plan)


def launch_scale_plane(x8, xs, qt, dt, plan: GemvPlan, lib=None) -> torch.Tensor:
    """One launch of csrc/i8_gemv_probe.cu under `plan` on checked operands
    on the card (`lib`: another build of the source)."""
    if cuda_q40._device_kind(x8) != "cuda":
        raise ValueError(f"i8_gemv runs on a CUDA device, not {x8.device}")
    for t in (x8, qt, dt):
        if t.data_ptr() % 16:
            raise ValueError("P2's operands must start on a 16-byte boundary")
    R, nb, out_f = x8.shape[0], qt.shape[0], qt.shape[2]
    lib = lib or kernels.load(P2_SOURCE, _P2_SIG)
    out = torch.empty((R, out_f), dtype=torch.float32, device=x8.device)
    kernels.launch(
        lib, "i8_gemv", x8,
        x8.data_ptr(), xs.data_ptr(), qt.data_ptr(), dt.data_ptr(), SCALE_KINDS[dt.dtype],
        out.data_ptr(), R, nb, out_f, plan.vec, plan.cols, plan.kw, plan.splits,
        plan.blocks_per_split,
    )
    return out


def scale_plane_call(x8, xs, qt, dt) -> torch.Tensor:
    """P2: x8 [R <= 8, in] int8, xs [R, nb] f32, qt [nb, 32, out] int8, dt
    [nb, out] f32 or int16 (raw f16 bits) -> [R, out] f32, one launch at
    `i8_gemv_plan(nb, out)`."""
    cuda_q40.check_i8_operands(x8, xs, qt, dt, Q_BLOCK, torch.int8,
                               dt_dtypes=(torch.float32, torch.int16))
    if cuda_q40._device_kind(x8) == "cpu":
        return scale_plane_call_plain(x8, xs, qt, dt)
    out = launch_scale_plane(x8, xs, qt, dt, i8_gemv_plan(qt.shape[0], qt.shape[2]))
    scale_plane_call.launches += 1
    return out


scale_plane_call.launches = 0

KERNELS = (f16bits_to_f32, i8_tile_call, scale_plane_call)

# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------


def make_operands(in_f: int, out_f: int, device, seed: int = 0):
    """The JAX sweep's operands, made on `device` from `seed`: qt [nb, 32,
    out] int8 in [-8, 7], an f16 plane of N(0, 1) * 0.01 (signed, a few
    subnormals), and one bf16 row quantized to x8 [1, in] int8, xs [1, nb]
    f32. Returns (x8, xs, qt, dt16, x)."""
    nb = in_f // Q_BLOCK
    gen = torch.Generator(device=device).manual_seed(seed)
    qt = torch.randint(-8, 8, (nb, Q_BLOCK, out_f), generator=gen, device=device, dtype=torch.int8)
    dt = (torch.randn((nb, out_f), generator=gen, device=device) * 0.01).to(torch.float16)
    x = torch.randn((1, in_f), generator=gen, device=device).to(torch.bfloat16).float()
    x8, xs, _ = quantize_rows_q80(x, nb)
    return x8.to(torch.int8).reshape(1, in_f), xs.contiguous(), qt, dt, x


def work(R: int, in_f: int, out_f: int, wbytes: float, plane_bytes: int) -> tuple[int, int]:
    """(bytes, ops) of one call: weights, the scale plane, int8 rows, f32
    row scales and the f32 output once each; 2 ops a weight a row."""
    nb = in_f // Q_BLOCK
    nbytes = (int(in_f * out_f * wbytes) + nb * out_f * plane_bytes + R * in_f + R * nb * 4
              + R * out_f * 4)
    return nbytes, 2 * R * in_f * out_f


def tiles_for(nb: int, quick: bool = False) -> list:
    """The (cols, blocks_per_cta) points of the sweep at nb blocks."""
    cols = QUICK_COLS if quick else TILE_COLS
    blocks = QUICK_BLOCKS if quick else SWEEP_BLOCKS
    return [(c, k) for c in cols for k in blocks if k <= nb and nb % k == 0]


def timed(fn, operands: tuple, nbytes: int) -> dict:
    """Cold and hot ms of one call fn(*operands) and a chain of CHAIN calls
    in one graph, with GB/s against `nbytes`."""
    from . import timing

    cold, hot = timing.cold_hot_ms(fn, operands, nbytes)
    chain = timing.graph_ms([partial(fn, *operands)] * CHAIN, warm=False, replays=3)
    return {"cold_ms": cold, "hot_ms": hot, "chain_ms": chain, "gb_s_cold": nbytes / cold / 1e6,
            "gb_s_hot": nbytes / hot / 1e6, "gb_s_chain": nbytes / chain / 1e6}


def library_ms(x, qt, dt16) -> dict:
    """The library yardstick: torch.matmul of the bf16 row against the
    bf16-dequantized weight, cold and hot."""
    from . import timing
    from .int4 import dequantized_bf16

    w = dequantized_bf16(qt, dt16)
    cold, hot = timing.cold_hot_ms(torch.matmul, (x.to(torch.bfloat16), w), w.numel() * 2)
    return {"library_cold_ms": cold, "library_hot_ms": hot}


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got - want).abs().max().item()


def convert_rows(device, seed: int = 0, time_it: bool = True) -> list:
    """P1 on every f16 bit pattern ([256, 256]) and at CONVERT_SHAPES (f16
    N(0, 1) values with zeros and subnormals, as the JAX probe makes
    them): bit equality with the plain version (through int32 views) and,
    on finite values, with torch's f16 -> f32."""
    every = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).reshape(256, 256)
    planes = [("every bit pattern [256, 256]", every.to(device))]
    gen = np.random.default_rng(seed)
    for label, knb, n in CONVERT_SHAPES:
        vals = gen.standard_normal((knb, n)).astype(np.float16)
        vals[0, :8] = np.float16(0.0)
        vals[0, 8:16] = np.float16(1e-7)  # subnormal
        planes.append((label, torch.from_numpy(vals.view(np.int16)).to(device)))
    rows = []
    for label, bits in planes:
        got = f16bits_to_f32(bits)
        want = f16bits_to_f32_plain(bits)
        ref = f16_view_float(bits)
        finite = torch.isfinite(ref)
        row = {"probe": "P1", "kernel": "f16bits_to_f32", "shape": label,
               "elements": bits.numel(),
               "bit_equal_plain": torch.equal(got.view(torch.int32), want.view(torch.int32)),
               "equal_f16_on_finite": torch.equal(got[finite], ref[finite]),
               "non_finite_patterns": int((~finite).sum().item()),
               "non_finite_give_finite": bool(torch.isfinite(got).all().item()),
               "bytes": bits.numel() * 6, "ops": 0}
        if time_it:
            from . import timing

            row.update(timed(f16bits_to_f32, (bits,), row["bytes"]))
            row["plain_ms"] = timing.graph_ms([partial(f16bits_to_f32_plain, bits)], replays=5)
            lib_cold, lib_hot = timing.cold_hot_ms(f16_view_float, (bits,), row["bytes"])
            row.update(library_cold_ms=lib_cold, library_hot_ms=lib_hot)
        rows.append(row)
    return rows


def p2_rows(device, seed: int = 0, time_it: bool = True) -> list:
    """P2 at its shape: the f32 and the i16 plane at `i8_gemv_plan`, each
    against the plain version, and against each other."""
    label, in_f, out_f = P2_SHAPE
    x8, xs, qt, dt16, x = make_operands(in_f, out_f, device, seed)
    planes = scale_planes(dt16)
    plan = i8_gemv_plan(in_f // Q_BLOCK, out_f)
    lib = library_ms(x, qt, dt16) if time_it else {}
    rows, outs = [], {}
    for plane in ("f32", "i16"):
        dt = planes[plane]
        want = scale_plane_call_plain(x8, xs, qt, dt)
        outs[plane] = got = scale_plane_call(x8, xs, qt, dt)
        nbytes, nops = work(1, in_f, out_f, 1.0, dt.element_size())
        row = {"probe": "P2", "kernel": "scale_plane_call", "shape": label, "in": in_f,
               "out": out_f, "plane": plane, "cols": plan.cols, "vec": plan.vec, "kw": plan.kw,
               "splits": plan.splits, "blocks_per_split": plan.blocks_per_split,
               "ctas": plan.ctas(out_f), "max_abs_err": _err(got, want),
               "out_scale": want.abs().max().item(), "bytes": nbytes, "ops": nops}
        if time_it:
            from . import timing

            row.update(timed(scale_plane_call, (x8, xs, qt, dt), nbytes), **lib)
            row["plain_ms"] = timing.graph_ms(
                [partial(scale_plane_call_plain, x8, xs, qt, dt)], replays=5)
        rows.append(row)
    for row in rows:
        row["planes_bit_equal"] = torch.equal(outs["f32"], outs["i16"])
    return rows


def sweep_shape(label: str, in_f: int, out_f: int, device, seed: int = 0, time_it: bool = True,
                quick: bool = False) -> list:
    """P13 at one shape: every tile of `tiles_for` with each of the three
    planes, against the plain version; at each tile, whether the three
    planes agree bit for bit. One row a (tile, plane)."""
    nb = in_f // Q_BLOCK
    x8, xs, qt, dt16, x = make_operands(in_f, out_f, device, seed)
    planes = scale_planes(dt16)
    want = i8_blocks_plain(x8, xs, qt, dt16)
    scale = want.abs().max().item()
    extra = library_ms(x, qt, dt16) if time_it else {}
    plain = {}
    if time_it:
        from . import timing

        for plane, dt in planes.items():
            plain[plane] = timing.graph_ms(
                [partial(i8_tile_call_plain, x8, xs, qt, dt, 64, nb)], replays=5)
    rows = []
    for cols, blocks in tiles_for(nb, quick):
        outs = {}
        for plane, dt in planes.items():
            outs[plane] = got = i8_tile_call(x8, xs, qt, dt, cols, blocks)
            nbytes, nops = work(1, in_f, out_f, 1.0, dt.element_size())
            row = {"probe": "P13", "kernel": "i8_tile_call", "shape": label, "in": in_f,
                   "out": out_f, "plane": plane, "cols": cols, "blocks_per_cta": blocks,
                   "splits": nb // blocks, "ctas": -(-out_f // cols) * (nb // blocks),
                   "max_abs_err": _err(got, want), "out_scale": scale, "bytes": nbytes,
                   "ops": nops}
            if time_it:
                row.update(timed(i8_tile_call, (x8, xs, qt, dt, cols, blocks), nbytes),
                           plain_ms=plain[plane], **extra)
            rows.append(row)
        equal = all(torch.equal(outs["f16"], outs[p]) for p in PLANES)
        for row in rows[-len(PLANES):]:
            row["planes_bit_equal"] = equal
    return rows


def best_rows(rows: list) -> dict:
    """{plane: the row of least cold time} of one shape's timed rows."""
    best = {}
    for r in rows:
        if r["plane"] not in best or r["cold_ms"] < best[r["plane"]]["cold_ms"]:
            best[r["plane"]] = r
    return best


def _point(r: dict, time_it: bool) -> str:
    line = (f"  {r['plane']} TN {r['cols']:3d} x {r['blocks_per_cta']:3d} blocks "
            f"({r['ctas']:5d} CTAs): maxerr vs plain {r['max_abs_err']:.3e}")
    if time_it:
        line += (f"; cold {r['cold_ms'] * 1e3:.2f} us ({r['gb_s_cold']:.0f} GB/s), hot "
                 f"{r['hot_ms'] * 1e3:.2f} us, chain {r['chain_ms'] * 1e3:.2f} us")
    return line


def main(argv=None) -> list:
    """Run P1, P2 and the P13 sweep; print one line a point and the best
    tile per shape and plane; return the rows."""
    ap = argparse.ArgumentParser(prog="python -m distributed_llama_tpu_torch.probes.scales")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--1b", dest="b1", action="store_true", help="the sweep's 1B shapes only")
    ap.add_argument("--8b", dest="b8", action="store_true", help="the sweep's 8B shapes only")
    ap.add_argument("--quick", action="store_true",
                    help=f"sweep TN {QUICK_COLS} x blocks {QUICK_BLOCKS} only")
    ap.add_argument("--shape", action="append", type=parse_shape,
                    help="IN,OUT of the sweep (repeatable; replaces the JAX shapes)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random operands")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    time_it = device.type == "cuda"
    if time_it:
        from . import timing

        print(f"card: {timing.card_line()}", flush=True)
    else:
        print("(CPU: the plain versions, correctness only; times not measured)", flush=True)
    rows = []
    print("== P1: raw f16 bits -> f32 (integer ops) ==", flush=True)
    for r in convert_rows(device, args.seed, time_it):
        line = (f"  {r['shape']}: bit-equal to plain {r['bit_equal_plain']}, equal to f16 on "
                f"finite {r['equal_f16_on_finite']}, {r['non_finite_patterns']} inf/NaN "
                f"patterns, all finite out {r['non_finite_give_finite']}")
        if time_it:
            line += (f"; cold {r['cold_ms'] * 1e3:.2f} us ({r['gb_s_cold']:.0f} GB/s), hot "
                     f"{r['hot_ms'] * 1e3:.2f} us, chain {r['chain_ms'] * 1e3:.2f} us; "
                     f"library .view(f16).float() cold {r['library_cold_ms'] * 1e3:.2f} us")
        print(line, flush=True)
        rows.append(r)
    p2 = p2_rows(device, args.seed, time_it)
    r = p2[0]
    print(f"== P2: {P2_SHAPE[0]}, the one-row GEMV at {r['vec']} columns a lane, {r['kw']} "
          f"warps along k, {r['splits']} splits ({r['ctas']} CTAs) ==", flush=True)
    for r in p2:
        line = f"  {r['plane']}: maxerr vs plain {r['max_abs_err']:.3e}"
        if time_it:
            line += (f"; cold {r['cold_ms'] * 1e3:.2f} us ({r['gb_s_cold']:.0f} GB/s), hot "
                     f"{r['hot_ms'] * 1e3:.2f} us, chain {r['chain_ms'] * 1e3:.2f} us")
        print(line + f"; planes bit-equal {r['planes_bit_equal']}", flush=True)
    rows.extend(p2)
    shapes = args.shape or ((SHAPES_1B if args.b1 else ()) + (SHAPES_8B if args.b8 else ())
                            or SHAPES_1B + SHAPES_8B)
    print("== P13: tile x scale-plane sweep. JAX tile_n (256..2048) is a TPU lane width with "
          "no CTA counterpart: TN sweeps 32, 64 and 128 columns a CTA; tile_knb -> blocks a "
          "CTA ==", flush=True)
    for label, in_f, out_f in shapes:
        print(f"shape {label} (nb={in_f // Q_BLOCK})", flush=True)
        shape_rows = sweep_shape(label, in_f, out_f, device, args.seed, time_it, args.quick)
        for r in shape_rows:
            print(_point(r, time_it) + ("" if r["planes_bit_equal"] else "; PLANES DIFFER"),
                  flush=True)
        if time_it:
            for plane, r in best_rows(shape_rows).items():
                print(f"  BEST {label} {plane}: TN {r['cols']} x {r['blocks_per_cta']} blocks "
                      f"{r['cold_ms'] * 1e3:.2f} us cold ({r['gb_s_cold']:.0f} GB/s)", flush=True)
            top = max(shape_rows, key=lambda r: r["gb_s_cold"])
            print(f"  BEST {label}: {top['plane']} TN {top['cols']} x {top['blocks_per_cta']} "
                  f"{top['gb_s_cold']:.0f} GB/s", flush=True)
        rows.extend(shape_rows)
    print(json.dumps({"probe": "scales", "device": str(device), "rows": len(rows)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
