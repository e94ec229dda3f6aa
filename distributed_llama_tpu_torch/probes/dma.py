"""P14: how fast the card streams a packed Q40 weight plane (the
counterpart of the JAX package's scripts/probe_dma.py).

`stream_call(bias, qp, tile_n, tile_knb)` (csrc/stream_probe.cu) computes
the TPU kernel's function (scripts/probe_dma.py:stream_call, :40): with the
plane qp [nb*4, out] int32 cut into tiles of tile_knb*4 rows by tile_n
columns, out = bias + the sum over tiles of each tile's [8, 128] corner, as
f32. One CTA streams one tile and loads every word of it, folding them into
the tile's XOR checksum, a second output [out / tile_n, nb / tile_knb]
int32: a GPU does not fetch what no thread reads, where the TPU pays for the
whole block's DMA. The corner sum is an exact 64-bit integer sum rounded
once (f32(f64(bias) + sum)), so kernel and plain version agree exactly.

    python -m distributed_llama_tpu_torch.probes.dma [--device cpu] [--shape IN,OUT ...]

sweeps the CTA tile over the probe's shapes and prints each shape's best
cold GB/s (probes/timing.py) with its tile, beside the data sheet's 3.35
TB/s and the card's name and power limit. Without `--device cpu` it needs a
CUDA device and raises otherwise.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..device import resolve_device
from ..formats.quants import Q_BLOCK
from ..ops import kernels
from . import parse_shape

# the probe's five shapes (Llama-3.2-1B layer shapes) and the 1B's full wcls
SHAPES = (
    ("wqkv", 2048, 3072),
    ("wo", 2048, 2048),
    ("w13", 2048, 16384),
    ("w2", 8192, 2048),
    ("wcls", 2048, 32768),
    ("wcls 128256", 2048, 128256),
)
# the CTA tiles swept: tile_n columns by tile_knb * 4 rows, from 16 KB (so a
# 2 MB plane still spreads over 128 CTAs; the corner's re-read 4 KB comes
# from L2) to 4 MB (the JAX probe's cap of a double-buffered 8 MB block)
TILES_N = (128, 256, 512, 1024, 2048, 4096)
TILES_KNB = (8, 16, 32, 64)
MAX_TILE_BYTES = 4 * 1024 * 1024
DATASHEET_BYTES_S = 3.35e12  # H100 SXM
CORNER = (8, 128)
_ACC_WORDS = 32 * 8 * 128  # the kernel's 64-bit corner sums, 32 slots
# one accumulator a device, zeroed once: the kernel leaves it zero, so a call
# is two kernels with no memset node (calls on one device run in stream order)
_ACC: dict[torch.device, torch.Tensor] = {}

_SIG = {
    # bias, qp, rows, out, tile_n, tile_knb, out, chk, acc, stream
    "stream_probe": (
        kernels.P, kernels.P, kernels.I, kernels.I, kernels.I, kernels.I,
        kernels.P, kernels.P, kernels.P, kernels.P,
    ),
}


def _check(bias, qp, tile_n: int, tile_knb: int) -> tuple[int, int]:
    if bias.dtype != torch.float32 or tuple(bias.shape) != CORNER:
        raise ValueError(f"bias must be [8, 128] float32, got {bias.dtype} {tuple(bias.shape)}")
    if qp.ndim != 2 or qp.dtype != torch.int32:
        raise ValueError(f"qp must be a 2D int32 plane, got {qp.dtype} {tuple(qp.shape)}")
    rows, out_f = qp.shape
    if tile_n < 128 or tile_n & (tile_n - 1) or out_f % tile_n:
        raise ValueError(f"tile_n {tile_n} must be a power of two >= 128 dividing {out_f}")
    if tile_knb < 2 or rows % (4 * tile_knb):
        raise ValueError(f"tile_knb {tile_knb} must be >= 2 with 4 * tile_knb dividing {rows}")
    if bias.device != qp.device:
        raise ValueError(f"bias is on {bias.device}, qp on {qp.device}")
    if not (bias.is_contiguous() and qp.is_contiguous()):
        raise ValueError("bias and qp must be contiguous")
    return out_f // tile_n, rows // (4 * tile_knb)


def _xor_fold(t: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR over one dimension, by halving (torch has no XOR reduction)."""
    while t.shape[dim] > 1:
        n = t.shape[dim]
        if n % 2:
            t = torch.cat([t, torch.zeros_like(t.narrow(dim, 0, 1))], dim)
            n += 1
        t = t.narrow(dim, 0, n // 2) ^ t.narrow(dim, n // 2, n // 2)
    return t.squeeze(dim)


def stream_call_plain(bias, qp, tile_n: int, tile_knb: int):
    """P14's plain version: (out [8, 128] f32, chk [grid_j, grid_k] int32)."""
    grid_j, grid_k = _check(bias, qp, tile_n, tile_knb)
    tiles = qp.reshape(grid_k, 4 * tile_knb, grid_j, tile_n)
    s = tiles[:, :8, :, :128].to(torch.int64).sum(dim=(0, 2))  # exact
    out = (bias.to(torch.float64) + s.to(torch.float64)).to(torch.float32)
    chk = _xor_fold(_xor_fold(tiles, 3), 1)  # [grid_k, grid_j]
    return out, chk.t().contiguous()


def stream_call(bias, qp, tile_n: int, tile_knb: int):
    """P14: (out [8, 128] f32, chk [out / tile_n, nb / tile_knb] int32) of
    the plane qp [nb*4, out] int32 at CTA tile (tile_knb * 4, tile_n)."""
    grid_j, grid_k = _check(bias, qp, tile_n, tile_knb)
    if qp.device.type == "cpu":
        return stream_call_plain(bias, qp, tile_n, tile_knb)
    if qp.device.type != "cuda":
        raise ValueError(f"unsupported device {qp.device}")
    lib = kernels.load("stream_probe", _SIG)
    acc = _ACC.get(qp.device)
    if acc is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("stream_call: call it once outside graph capture first")
        acc = _ACC[qp.device] = torch.zeros(_ACC_WORDS, dtype=torch.int64, device=qp.device)
    out = torch.empty(CORNER, dtype=torch.float32, device=qp.device)
    chk = torch.empty((grid_j, grid_k), dtype=torch.int32, device=qp.device)
    kernels.launch(
        lib, "stream_probe", qp,
        bias.data_ptr(), qp.data_ptr(), qp.shape[0], qp.shape[1], tile_n, tile_knb,
        out.data_ptr(), chk.data_ptr(), acc.data_ptr(),
    )
    stream_call.launches += 1
    return out, chk


stream_call.launches = 0

KERNELS = (stream_call,)


def tiles_for(in_f: int, out_f: int) -> list[tuple[int, int]]:
    """The swept (tile_n, tile_knb) that divide the plane [in/8, out]."""
    nb = in_f // Q_BLOCK
    return [(tn, tk) for tn in TILES_N for tk in TILES_KNB
            if out_f % tn == 0 and nb % tk == 0
            and tk * 16 * tn <= MAX_TILE_BYTES]


def make_plane(in_f: int, out_f: int, device, seed: int = 0):
    """A random packed plane [in/8, out] int32 (every word is a valid nibble
    pattern) and a random bias, made on `device` from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qp = torch.randint(-2**31, 2**31 - 1, (in_f // 8, out_f), generator=gen, device=device,
                       dtype=torch.int32)
    bias = torch.randn(CORNER, generator=gen, device=device)
    return bias, qp


def run_shape(label: str, in_f: int, out_f: int, device, seed: int = 0,
              timed: bool = True) -> dict:
    """One shape: at each tile, stream_call against its plain version (out
    and checksums) and, timed on the card, its cold ms. Returns the best
    tile's row (the first tile's when not timed) with the worst error and
    whether every tile's checksums agreed; timed, also the best tile's hot
    ms, the plain version's ms, the library call's (torch.sum over the
    plane: the nearest call, not the same function) and every tile's cold
    ms under "sweep"."""
    bias, qp = make_plane(in_f, out_f, device, seed)
    nbytes = qp.numel() * 4
    rows = []
    for tn, tk in tiles_for(in_f, out_f):
        out, chk = stream_call(bias, qp, tn, tk)
        p_out, p_chk = stream_call_plain(bias, qp, tn, tk)
        row = {"shape": label, "in": in_f, "out": out_f, "tile_n": tn, "tile_knb": tk,
               "bytes": nbytes,
               "max_rel_err": ((out - p_out).abs().max() / p_out.abs().max()).item(),
               "checksums_equal": bool(torch.equal(chk, p_chk))}
        if timed:
            from . import timing

            row["cold_ms"] = timing.cold_ms(
                lambda b, q, tn=tn, tk=tk: stream_call(b, q, tn, tk), (bias, qp), nbytes)
            row["gb_s_cold"] = nbytes / row["cold_ms"] / 1e6
        rows.append(row)
    if not rows:
        raise ValueError(f"no swept tile divides the {in_f // 8} x {out_f} plane")
    best = dict(min(rows, key=lambda r: r["cold_ms"]) if timed else rows[0])
    best["tiles"] = len(rows)
    best["max_rel_err_all_tiles"] = max(r["max_rel_err"] for r in rows)
    best["checksums_equal_all_tiles"] = all(r["checksums_equal"] for r in rows)
    if timed:
        tn, tk = best["tile_n"], best["tile_knb"]
        best["hot_ms"] = timing.hot_ms(lambda b, q: stream_call(b, q, tn, tk), (bias, qp), nbytes)
        best["plain_ms"] = timing.graph_ms([lambda: stream_call_plain(bias, qp, tn, tk)],
                                           replays=5)
        best["library_cold_ms"], best["library_hot_ms"] = timing.cold_hot_ms(
            torch.sum, (qp,), nbytes)
        best["sweep"] = [{k: r[k] for k in ("tile_n", "tile_knb", "cold_ms")} for r in rows]
    return best


def main(argv=None) -> list:
    """Run the probe over its shapes (or the `--shape`s given); print each
    shape's best tile and return the rows."""
    ap = argparse.ArgumentParser(prog="python -m distributed_llama_tpu_torch.probes.dma")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--shape", action="append", type=parse_shape, help="IN,OUT (repeatable)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    timed = device.type == "cuda"
    if timed:
        from . import timing

        print(f"card: {timing.card_line()}; data sheet: {DATASHEET_BYTES_S / 1e9:.0f} GB/s",
              flush=True)
    else:
        print("(CPU: the plain version, correctness only; times not measured)", flush=True)
    rows = []
    for label, in_f, out_f in args.shape or SHAPES:
        r = run_shape(label, in_f, out_f, device, timed=timed)
        line = (f"{label} packed {r['bytes'] / 1e6:6.1f} MB: {r['tiles']} tiles, max rel err "
                f"{r['max_rel_err_all_tiles']:.1e}, checksums equal "
                f"{r['checksums_equal_all_tiles']}")
        if timed:
            line += (f"; best cold {r['cold_ms'] * 1e3:.1f} us = {r['gb_s_cold']:.0f} GB/s "
                     f"({100 * r['gb_s_cold'] * 1e9 / DATASHEET_BYTES_S:.0f}% of the data "
                     f"sheet) at tile_n={r['tile_n']} tile_knb={r['tile_knb']}; hot "
                     f"{r['hot_ms'] * 1e3:.1f} us")
        print(line, flush=True)
        rows.append(r)
    print(json.dumps({"probe": "dma", "device": str(device), "rows": len(rows)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
