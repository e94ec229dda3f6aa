"""P6: the tile sweep of the i32-nibble int8 decode matmul (the counterpart
of the JAX package's scripts/sweep_i4_tiles.py).

P4 (`probes/int4.py:i32_call`) reads [nb, 4, out] int32 words, value
q[b, 4j + g, o] + 8 in nibble j of word [b, g, o], at B9's 64 output
columns a CTA and B9's split-K. `i4_sweep_call(x8, xs, qw, dt, cols,
blocks_per_cta, variant)` (csrc/i8_tile_probe.cu, sweep_i4_tiles.py:123,
body `_kernel_w32` :56) is P4's bf16-dot instance on the raw-f16-bits
scale plane (`_dt_operand`'s int16 plane), at a CTA of `cols` output
columns (32, 64 or 128) owning `blocks_per_cta` 32-blocks (a divisor of
nb). The JAX tile_n (512..2048 TPU lanes) has no CTA counterpart; tile_knb
is blocks_per_cta.

The JAX kernel's three variants (`concat-bf16`, `concat-i32`,
`split-dot`) differ only in where Mosaic relayouts and casts the unpacked
planes; their partials are the same exact integers. On the card all three
are one instance, the staged bf16 MMA: the wrapper takes each name and runs
that instance, and the probe launches it once a tile and names the three
variants in the row. At 64 columns and P4's split it equals P4's bf16
instance (and B9) bit for bit.

The wrapper takes its plain version for CPU tensors, launches its kernel
for CUDA tensors or raises, and counts its launches in `launches`.

    python -m distributed_llama_tpu_torch.probes.i4_tiles [--device cpu] [--only LABEL]
        [--seed N] [--shape IN,OUT ...]

runs the JAX script's five Llama-3.2-1B shapes (or the `--shape`s given;
`--only` keeps the shapes whose label holds LABEL, as the script's first
argument does): B9's baseline and, at every tile, the three variants' one
instance against the plain version and B9; on the card each tile's cold
and hot µs a call (probes/timing.py), a chain of 64 calls in one CUDA
graph, GB/s against the bytes moved, its CTAs and its speed against B9;
then the best tile per shape. Without `--device cpu` it needs a CUDA device and raises
otherwise.
"""

from __future__ import annotations

import argparse
import json
from functools import partial

import torch

from ..device import resolve_device
from ..formats.quants import Q_BLOCK
from ..ops import cuda_q40
from ..ops.cuda_q40 import W_I32, i8_blocks_plain
from . import parse_shape
from .int4 import make_operands, pack_i32_t, unpack_i32
from .scales import check_tile, launch_tiled, library_ms, plane_f32, tiles_for, timed, work

VARIANTS = ("concat-bf16", "concat-i32", "split-dot")
# the JAX script's shapes (Llama-3.2-1B; wcls cut to 32768)
SHAPES = (
    ("wqkv 2048->3072", 2048, 3072),
    ("wo   2048->2048", 2048, 2048),
    ("w13  2048->16384", 2048, 16384),
    ("w2   8192->2048", 8192, 2048),
    ("wcls 2048->32768", 2048, 32768),
)


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


def i4_sweep_call_plain(x8, xs, qw, dt, cols: int, blocks_per_cta: int,
                        variant: str = "concat-bf16") -> torch.Tensor:
    """P6's plain version: B9's math, bf16 dot, on the unpacked words and
    the plane's f32 values (every variant's function)."""
    _check_variant(variant)
    check_tile(qw.shape[0], cols, blocks_per_cta)
    return i8_blocks_plain(x8, xs, unpack_i32(qw), plane_f32(dt), "bf16")


def i4_sweep_call(x8, xs, qw, dt, cols: int, blocks_per_cta: int,
                  variant: str = "concat-bf16") -> torch.Tensor:
    """P6: x8 [R <= 8, in] int8, xs [R, nb] f32, qw [nb, 4, out] int32, dt
    [nb, out] int16 raw f16 bits -> [R, out] f32, at a CTA of `cols` columns
    owning `blocks_per_cta` blocks. Every `variant` runs the one instance."""
    cuda_q40.check_i8_operands(x8, xs, qw, dt, 4, torch.int32, dt_dtypes=(torch.int16,))
    _check_variant(variant)
    check_tile(qw.shape[0], cols, blocks_per_cta)
    if cuda_q40._device_kind(x8) == "cpu":
        return i4_sweep_call_plain(x8, xs, qw, dt, cols, blocks_per_cta, variant)
    out = launch_tiled(x8, xs, qw, W_I32, "bf16", dt, cols, blocks_per_cta)
    i4_sweep_call.launches += 1
    return out


i4_sweep_call.launches = 0

KERNELS = (i4_sweep_call,)


def sweep_shape(label: str, in_f: int, out_f: int, device, seed: int = 0,
                time_it: bool = True) -> dict:
    """One shape: B9's baseline, then every tile (one launch, the three
    variants' one instance) against the plain version and B9. Returns
    {"baseline": row, "tiles": rows}."""
    nb = in_f // Q_BLOCK
    x8, xs, qt, dt16, x = make_operands(in_f, out_f, 1, device, seed)
    qw = pack_i32_t(qt)
    bits = dt16.view(torch.int16)
    ref = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt16)
    want = i4_sweep_call_plain(x8, xs, qw, bits, 64, nb)
    scale = want.abs().max().item()
    b_bytes, b_ops = work(1, in_f, out_f, 1.0, 2)
    base = {"probe": "B9 baseline", "kernel": "q40_i8_unpacked", "shape": label, "in": in_f,
            "out": out_f, "bytes": b_bytes, "ops": b_ops, "out_scale": scale,
            "max_abs_err": (ref - cuda_q40.q40_i8_unpacked_plain(x8, xs, qt, dt16)).abs().max().item()}
    extra = {}
    if time_it:
        from . import timing

        base.update(timed(cuda_q40.q40_i8_unpacked, (x8, xs, qt, dt16), b_bytes))
        extra = library_ms(x, qt, dt16)
        extra["plain_ms"] = timing.graph_ms(
            [partial(i4_sweep_call_plain, x8, xs, qw, bits, 64, nb)], replays=5)
    nbytes, nops = work(1, in_f, out_f, 0.5, 2)
    rows = []
    for cols, blocks in tiles_for(nb):
        got = i4_sweep_call(x8, xs, qw, bits, cols, blocks)
        row = {"probe": "P6", "kernel": "i4_sweep_call", "shape": label, "in": in_f,
               "out": out_f, "variants": list(VARIANTS), "cols": cols,
               "blocks_per_cta": blocks, "splits": nb // blocks,
               "ctas": -(-out_f // cols) * (nb // blocks),
               "max_abs_err": (got - want).abs().max().item(),
               "max_abs_err_vs_b9": (got - ref).abs().max().item(), "out_scale": scale,
               "bytes": nbytes, "ops": nops}
        if time_it:
            row.update(timed(i4_sweep_call, (x8, xs, qw, bits, cols, blocks), nbytes), **extra)
            row["x_b9"] = base["cold_ms"] / row["cold_ms"]
        rows.append(row)
    return {"baseline": base, "tiles": rows}


def main(argv=None) -> list:
    """Run the sweep over its shapes; print B9's baseline, one line a tile
    and the best tile per shape; return the rows (baselines and tiles)."""
    ap = argparse.ArgumentParser(prog="python -m distributed_llama_tpu_torch.probes.i4_tiles")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--only", default=None, help="keep the shapes whose label holds this")
    ap.add_argument("--shape", action="append", type=parse_shape, help="IN,OUT (repeatable)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random operands")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    time_it = device.type == "cuda"
    if time_it:
        from . import timing

        print(f"card: {timing.card_line()}", flush=True)
    else:
        print("(CPU: the plain versions, correctness only; times not measured)", flush=True)
    print(f"variants {', '.join(VARIANTS)}: one instance on the card (the staged bf16 MMA); "
          f"JAX tile_n (512..2048) is a TPU lane width with no CTA counterpart: TN sweeps 32, "
          f"64 and 128 columns a CTA; tile_knb -> blocks a CTA", flush=True)
    rows = []
    for label, in_f, out_f in args.shape or SHAPES:
        if args.only and args.only not in label:
            continue
        got = sweep_shape(label, in_f, out_f, device, args.seed, time_it)
        base = got["baseline"]
        line = f"== {label} packed {got['tiles'][0]['bytes'] / 1e6:.2f} MB | i8 baseline"
        line += (f" {base['cold_ms'] * 1e3:.2f} us cold ==" if time_it
                 else f" maxerr vs plain {base['max_abs_err']:.3e} ==")
        print(line, flush=True)
        for r in got["tiles"]:
            line = (f"  TN {r['cols']:3d} x {r['blocks_per_cta']:3d} blocks ({r['ctas']:5d} "
                    f"CTAs): maxerr vs plain {r['max_abs_err']:.3e}, vs B9 "
                    f"{r['max_abs_err_vs_b9']:.3e}")
            if time_it:
                line += (f"; cold {r['cold_ms'] * 1e3:.2f} us ({r['gb_s_cold']:.0f} GB/s, "
                         f"{r['x_b9']:.2f}x i8), hot {r['hot_ms'] * 1e3:.2f} us, chain "
                         f"{r['chain_ms'] * 1e3:.2f} us")
            print(line, flush=True)
        if time_it:
            r = min(got["tiles"], key=lambda r: r["cold_ms"])
            print(f"  BEST: TN {r['cols']} x {r['blocks_per_cta']} blocks {r['cold_ms'] * 1e3:.2f} "
                  f"us ({r['x_b9']:.2f}x i8)", flush=True)
        rows.append(base)
        rows.extend(got["tiles"])
    print(json.dumps({"probe": "i4_tiles", "device": str(device), "rows": len(rows)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
