"""P6: the tile sweep of the i32-nibble int8 decode matmul (the counterpart
of the JAX package's scripts/sweep_i4_tiles.py).

`i4_sweep_call(x8, xs, qw, dt, cols, blocks_per_cta, variant)`
(sweep_i4_tiles.py:123, body `_kernel_w32` :56) reads [nb, 4, out] int32
words, value q[b, 4j + g, o] + 8 in nibble j of word [b, g, o] (P4's
storage, `probes/int4.py:pack_i32`), with a bf16 dot, on the
raw-f16-bits scale plane (`_dt_operand`'s int16 plane). On the card it is
the one-row GEMV of csrc/i8_gemv.cuh (csrc/i4_gemv_probe.cu, P3's
template): a lane owns 4 columns and loads a word row of them in one
16-byte load, each word one column's 8 values, unpacked in registers, the
bf16 dot as exact f32 products on the CUDA cores;
one launch a call, the splits of a column tile merged in one cluster. Its
tile is the plan: `cols` output columns a CTA (128, 256, 512 or 1024:
the JAX tile_n of 512..2048 lanes is nearest the wide end; the warps not
across the columns go along the contraction) and `blocks_per_cta`
32-blocks a split (tile_knb's counterpart; a divisor of nb, at most 8
splits, the cluster limit). `tiles_for` leaves out the JAX sweep's tiles
past that limit and counts them.

The JAX kernel's three variants (`concat-bf16`, `concat-i32`,
`split-dot`) differ only in where Mosaic relayouts and casts the unpacked
planes; their partials are the same exact integers. On the card all three
are one instance: the wrapper takes each name and runs that instance, and
the probe launches it once a tile and names the three variants in the
row. The plain version repeats the tile's order of f32 sums and equals the
kernel bit for bit; at the tile of P3's plan's order (`p3_tile`: its warps
along k and its blocks a split) the kernel gives P3's bits on the same
values.

The wrapper takes its plain version for CPU tensors, launches its kernel
for CUDA tensors or raises, and counts its launches in `launches`.

    python -m distributed_llama_tpu_torch.probes.i4_tiles [--device cpu] [--only LABEL]
        [--seed N] [--shape IN,OUT ...]

runs the JAX script's five Llama-3.2-1B shapes (or the `--shape`s given;
`--only` keeps the shapes whose label holds LABEL, as the script's first
argument does): B9's baseline and, at every tile, the three variants' one
instance against the plain version and B9, and at P3's plan against P3; on
the card each tile's cold and hot µs a call (probes/timing.py), a chain of
64 calls in one CUDA graph, GB/s against the bytes moved, its CTAs and its
speed against B9; then the best tile per shape. Without `--device cpu` it
needs a CUDA device and raises otherwise.
"""

from __future__ import annotations

import argparse
import json
from functools import partial

import torch

from ..device import resolve_device
from ..formats.quants import Q_BLOCK
from ..ops import cuda_q40
from ..ops.cuda_q40 import _gemv_order
from . import gemv, parse_shape
from .int4 import i4_call_bf16, make_operands, pack_i32_t, pack_s4, unpack_i32
from .scales import SWEEP_BLOCKS, library_ms, plane_f32, timed, work

VARIANTS = ("concat-bf16", "concat-i32", "split-dot")
# the JAX script's shapes (Llama-3.2-1B; wcls cut to 32768)
SHAPES = (
    ("wqkv 2048->3072", 2048, 3072),
    ("wo   2048->2048", 2048, 2048),
    ("w13  2048->16384", 2048, 16384),
    ("w2   8192->2048", 8192, 2048),
    ("wcls 2048->32768", 2048, 32768),
)
REL_TOL = 1e-5  # against B9: exact integer partials, the f32 block sums in another order


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


def tiles_for(nb: int) -> tuple[list, int]:
    """The (cols, blocks_per_cta) tiles of the sweep at nb blocks: every
    column width of gemv.P6_COLS by every SWEEP_BLOCKS count that divides
    nb, and how many of those the cluster limit leaves out (more than
    gemv.MAX_SPLITS splits)."""
    points = [(c, k) for c in gemv.P6_COLS for k in SWEEP_BLOCKS if k <= nb and nb % k == 0]
    kept = [(c, k) for c, k in points if nb // k <= gemv.MAX_SPLITS]
    return kept, len(points) - len(kept)


def plan_tile(plan: gemv.GemvPlan) -> tuple[int, int]:
    """The P6 tile (cols, blocks_per_cta) that sums in `plan`'s order: its
    warps along k and its blocks a split. A plan's order does not depend on
    the columns a lane, so P6 there gives the plan's bits on the same
    values (where its blocks a split divide nb, as P6's tiles need)."""
    return 32 * gemv.P6_VEC * (gemv.WARPS // plan.kw), plan.blocks_per_split


def p3_tile(nb: int, out_f: int) -> tuple[int, int]:
    """The P6 tile that sums in P3's plan's order at (nb, out)."""
    return plan_tile(gemv.i4_gemv_plan(nb, out_f))


def i4_sweep_call_plain(x8, xs, qw, dt, cols: int, blocks_per_cta: int,
                        variant: str = "concat-bf16") -> torch.Tensor:
    """P6's plain version: the per-block terms of the unpacked words on the
    plane's f32 values (every variant's function), summed in the tile's
    order; bit for bit the kernel's."""
    _check_variant(variant)
    plan = gemv.tile_plan(qw.shape[0], cols, blocks_per_cta)
    return _gemv_order(gemv.block_terms(x8, xs, unpack_i32(qw), plane_f32(dt)), plan)


def i4_sweep_call(x8, xs, qw, dt, cols: int, blocks_per_cta: int,
                  variant: str = "concat-bf16") -> torch.Tensor:
    """P6: x8 [R <= 8, in] int8, xs [R, nb] f32, qw [nb, 4, out] int32, dt
    [nb, out] int16 raw f16 bits -> [R, out] f32, one launch at the tile:
    a CTA of `cols` columns, splits of `blocks_per_cta` blocks. Every
    `variant` runs the one instance."""
    cuda_q40.check_i8_operands(x8, xs, qw, dt, 4, torch.int32, dt_dtypes=(torch.int16,))
    _check_variant(variant)
    plan = gemv.tile_plan(qw.shape[0], cols, blocks_per_cta)
    if cuda_q40._device_kind(x8) == "cpu":
        return i4_sweep_call_plain(x8, xs, qw, dt, cols, blocks_per_cta, variant)
    out = gemv.launch_i4_gemv(x8, xs, qw, gemv.W_I32, gemv.DOTS["bf16"], dt, plan)
    i4_sweep_call.launches += 1
    return out


i4_sweep_call.launches = 0

KERNELS = (i4_sweep_call,)


def sweep_shape(label: str, in_f: int, out_f: int, device, seed: int = 0,
                time_it: bool = True) -> dict:
    """One shape: B9's baseline, then every tile (one launch, the three
    variants' one instance) against its plain version (bit for bit) and
    B9 (within REL_TOL), and at P3's plan against P3's bf16 arm on the same
    values. Returns {"baseline": row, "tiles": rows, "left_out": the tiles
    past the cluster limit, "p3_tile": (cols, blocks_per_cta)}."""
    nb = in_f // Q_BLOCK
    x8, xs, qt, dt16, x = make_operands(in_f, out_f, 1, device, seed)
    qw = pack_i32_t(qt)
    bits = dt16.view(torch.int16)
    ref = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt16)
    terms = gemv.block_terms(x8, xs, unpack_i32(qw), plane_f32(bits))
    scale = ref.abs().max().item()
    b_bytes, b_ops = work(1, in_f, out_f, 1.0, 2)
    base = {"probe": "B9 baseline", "kernel": "q40_i8_unpacked", "shape": label, "in": in_f,
            "out": out_f, "bytes": b_bytes, "ops": b_ops, "out_scale": scale,
            "max_abs_err": (ref - cuda_q40.q40_i8_unpacked_plain(x8, xs, qt, dt16)).abs().max().item()}
    tiles, left_out = tiles_for(nb)
    p3 = p3_tile(nb, out_f)
    extra = {}
    if time_it:
        from . import timing

        base.update(timed(cuda_q40.q40_i8_unpacked, (x8, xs, qt, dt16), b_bytes))
        extra = library_ms(x, qt, dt16)
        extra["plain_ms"] = timing.graph_ms(
            [partial(i4_sweep_call_plain, x8, xs, qw, bits, *p3)], replays=5)
    nbytes, nops = work(1, in_f, out_f, 0.5, 2)
    rows = []
    for cols, blocks in tiles:
        got = i4_sweep_call(x8, xs, qw, bits, cols, blocks)
        want = _gemv_order(terms, gemv.tile_plan(nb, cols, blocks))
        row = {"probe": "P6", "kernel": "i4_sweep_call", "shape": label, "in": in_f,
               "out": out_f, "variants": list(VARIANTS), "cols": cols,
               "blocks_per_cta": blocks, "splits": nb // blocks,
               "ctas": -(-out_f // cols) * (nb // blocks),
               "max_abs_err": (got - want).abs().max().item(),
               "bit_equal_plain": torch.equal(got, want),
               "max_abs_err_vs_b9": (got - ref).abs().max().item(), "out_scale": scale,
               "bytes": nbytes, "ops": nops, "p3_plan": (cols, blocks) == p3}
        if row["p3_plan"]:
            row["equals_p3"] = torch.equal(got, i4_call_bf16(x8, xs, pack_s4(qt), dt16))
        if time_it:
            row.update(timed(i4_sweep_call, (x8, xs, qw, bits, cols, blocks), nbytes), **extra)
            row["x_b9"] = base["cold_ms"] / row["cold_ms"]
        rows.append(row)
    return {"baseline": base, "tiles": rows, "left_out": left_out, "p3_tile": p3}


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
    print(f"variants {', '.join(VARIANTS)}: one instance on the card (the one-row GEMV, "
          f"bf16 dot); cols {'/'.join(map(str, gemv.P6_COLS))} columns a CTA (JAX tile_n "
          f"512..2048), tile_knb -> blocks a split, at most {gemv.MAX_SPLITS} splits",
          flush=True)
    rows = []
    for label, in_f, out_f in args.shape or SHAPES:
        if args.only and args.only not in label:
            continue
        got = sweep_shape(label, in_f, out_f, device, args.seed, time_it)
        base = got["baseline"]
        line = f"== {label} packed {got['tiles'][0]['bytes'] / 1e6:.2f} MB | i8 baseline"
        line += (f" {base['cold_ms'] * 1e3:.2f} us cold" if time_it
                 else f" maxerr vs plain {base['max_abs_err']:.3e}")
        print(f"{line} | {got['left_out']} tiles left out (more than {gemv.MAX_SPLITS} "
              f"splits) | P3's plan: TN {got['p3_tile'][0]} x {got['p3_tile'][1]} ==", flush=True)
        for r in got["tiles"]:
            line = (f"  TN {r['cols']:4d} x {r['blocks_per_cta']:3d} blocks ({r['ctas']:5d} "
                    f"CTAs): maxerr vs plain {r['max_abs_err']:.3e}, vs B9 "
                    f"{r['max_abs_err_vs_b9']:.3e}")
            if r["p3_plan"]:
                line += f", P3's plan, equal to P3: {r['equals_p3']}"
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
