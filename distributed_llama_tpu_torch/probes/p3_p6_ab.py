"""P3 (the int8 decode matmul from s4 bytes, int8 and bf16 dots) and P6
(the same from i32 nibble words, swept over its tile) against their
earlier designs, and the sweep that chooses P3's plan, in one process on
one card.

    python -m distributed_llama_tpu_torch.probes.p3_p6_ab --old DIR [--out FILE]
    python -m distributed_llama_tpu_torch.probes.p3_p6_ab --sweep [--out FILE]

`--old`: DIR holds an earlier `q40_i8_mma.cu`, `q40_i8_mma.cuh` and
`i8_tile_probe.cu` in which P3 and P6 ran the int8-MMA template (a CTA of
4 warps on 32..128 columns, the block staged in shared memory, split-K
summed by a second kernel), for example from `git show
<commit>:distributed_llama_tpu_torch/csrc/<file>`. They are compiled here
with the port's nvcc flags and `-I DIR` into build/kernels/, so the old
sources take the old header, and called through their own C signatures:
P3 at 64 columns and `cuda_q40.i8_mma_splits`, P6 at every old tile (32,
64 or 128 columns by the blocks a CTA that divide nb) and then at the
fastest. The new arm is the current build (csrc/i4_gemv_probe.cu): P3 at
`gemv.i4_gemv_plan`, P6 at every tile of `i4_tiles.tiles_for` and then at
the fastest. Rows: P3 at its five shapes (probes/int4.py SHAPES) at 1 and
8 rows, each dot; P6 at its five shapes (probes/i4_tiles.py SHAPES) at 1
row. Each row is timed old, new, new, old (CUDA events over CUDA-graph
replays, probes/timing.graph_ms), cold: a case's calls walk copies of
their operands that together take at least timing.RING_BYTES (4x the L2).
Beside them: the bound (bytes moved over the card's memory rate: weights,
scales, rows and row scales read once, the output written once), one
PyTorch call's time (`torch.matmul` of the bf16 rows against the
bf16-dequantized weight), the plain version's, and the checks: the new
output equal to its plain order bit for bit, the two P3 arms equal, and
the new output against the old one relative to the output's largest
value; the launches a call.

`--sweep`: compiles csrc/i4_gemv_probe.cu with -DDLT_P3_SWEEP (every (vec,
kw) pair of 4, 8 or 16 columns a lane and 2, 4 or 8 warps along k, at 1
and 8 rows, and the bf16 dot on both routes: mma.sync, at 4 or 8 columns
a lane, and exact f32 products on the CUDA cores) and times every P3 plan
(each pair by 1, 2, 4 or 8 splits) at P3's five shapes, 1 and 8 rows, each
dot and route, each held
to its plain order bit for bit, and P6 at every tile of its five shapes on
both bf16 routes: how `gemv.i4_gemv_plan`'s constants and the bf16 dot's
route were chosen.

Prints one JSON line a case and the card's `nvidia-smi` name and power
limit; `--out` also writes them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from ..formats.quants import Q_BLOCK
from ..ops import cuda_q40, kernels
from ..ops.cuda_q40 import GemvPlan, _gemv_order
from . import gemv, i4_tiles, int4, timing
from .k1_ab import _compile, _open
from .scales import plane_f32, work

BW = 3.35e12  # H100 SXM data sheet: bytes/s
ROWS = (1, 8)
OLD_TILE_COLS = (32, 64, 128)  # the int8-MMA template's TN
SWEEP_PAIRS = tuple((v, kw) for v in (4, 8, 16) for kw in (2, 4, 8))
# the sweep build's dot codes: the int8 dot, and the bf16 dot on mma.sync
# and on the CUDA cores (exact f32 products), for the s4 bytes and the
# nibble words (the bf16 code runs each one's chosen route)
SWEEP_DOTS = {"s4": {"int8": 0, "bf16-mma": 1, "bf16-fma": gemv.SWEEP_BF16_OTHER},
              "i32": {"bf16-fma": 1, "bf16-mma": gemv.SWEEP_BF16_OTHER}}

P, I = ctypes.c_void_p, ctypes.c_int
OLD_SIG = {
    # x8, xs, w, weights, dot, dt, out, part, rows, nb, out, splits, stream
    "q40_i8_mma": (P, P, P, I, I, P, P, P, I, I, I, I, P),
    # x8, xs, w, weights, dot, dt, scale_kind, out, part, rows, nb, out,
    # cols, blocks_per_cta, stream
    "q40_i8_mma_tiled": (P, P, P, I, I, P, I, P, P, I, I, I, I, I, P),
}
OLD_W_S4, OLD_W_I32 = 1, 2  # the earlier template's weights codes


def build_old(src_dir: Path) -> dict:
    """Compile the earlier q40_i8_mma.cu and i8_tile_probe.cu against the
    header beside them, both at once; returns {name: library}."""
    procs = {}
    for name, fn in (("q40_i8_mma", "q40_i8_mma"), ("i8_tile_probe", "q40_i8_mma_tiled")):
        out = kernels.BUILD_DIR / f"libold_{name}.so"
        procs[name] = (_compile(src_dir / f"{name}.cu", out, include=src_dir), out,
                       {fn: OLD_SIG[fn]})
    return {name: _open(proc, out, sig, f"the earlier {name}.cu")
            for name, (proc, out, sig) in procs.items()}


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def old_p3(lib, x8, xs, qt4, dt, dot: str) -> torch.Tensor:
    """The earlier P3: the int8-MMA template's s4 instance at 64 columns and
    i8_mma_splits, its splits summed by a second kernel."""
    R, nb, out_f = x8.shape[0], qt4.shape[0], qt4.shape[2]
    splits = cuda_q40.i8_mma_splits(nb, out_f)
    out = torch.empty((R, out_f), dtype=torch.float32, device=x8.device)
    part = torch.empty((splits, R, out_f) if splits > 1 else (1,), dtype=torch.float32,
                       device=x8.device)
    kernels.check(lib, lib.q40_i8_mma(
        x8.data_ptr(), xs.data_ptr(), qt4.data_ptr(), OLD_W_S4, gemv.DOTS[dot], dt.data_ptr(),
        out.data_ptr(), part.data_ptr(), R, nb, out_f, splits, _stream()), "old q40_i8_mma")
    return out


def old_p6(lib, x8, xs, qw, bits, cols: int, blocks: int) -> torch.Tensor:
    """The earlier P6: the int8-MMA template's i32-word bf16 instance on the
    raw-bits plane at a (cols, blocks_per_cta) tile."""
    R, nb, out_f = x8.shape[0], qw.shape[0], qw.shape[2]
    splits = nb // blocks
    out = torch.empty((R, out_f), dtype=torch.float32, device=x8.device)
    part = torch.empty((splits, R, out_f) if splits > 1 else (1,), dtype=torch.float32,
                       device=x8.device)
    kernels.check(lib, lib.q40_i8_mma_tiled(
        x8.data_ptr(), xs.data_ptr(), qw.data_ptr(), OLD_W_I32, gemv.DOTS["bf16"],
        bits.data_ptr(), 2, out.data_ptr(), part.data_ptr(), R, nb, out_f, cols, blocks,
        _stream()), "old q40_i8_mma_tiled")
    return out


def _turns(old, new) -> dict:
    """old, new, new, old: each a list of zero-argument calls in one graph,
    ms a call."""
    t = [timing.graph_ms(c) for c in (old, new, new, old)]
    return {"old_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2, "turns_ms": t}


def _emit(row: dict, rows: list) -> None:
    if "old_ms" in row:
        row["speedup"] = row["old_ms"] / row["new_ms"]
    print(json.dumps(row), flush=True)
    rows.append(row)


def _rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def operand_ring(in_f: int, out_f: int, rows: int, seed: int):
    """Copies of P3's and P6's operands at in -> out that together reach the
    ring: [(x8, xs, qt4, dt16, qw, bits)], and the library call's operands
    [(bf16 rows, bf16-dequantized weight)]."""
    nbytes = work(rows, in_f, out_f, 0.5, 2)[0]
    sets, lib = [], []
    for i in range(timing.ring_size(nbytes)):
        x8, xs, qt, dt16, x = int4.make_operands(in_f, out_f, rows, "cuda", seed=seed + i)
        sets.append((x8, xs, int4.pack_s4(qt), dt16, int4.pack_i32_t(qt), dt16.view(torch.int16)))
        lib.append((x.to(torch.bfloat16), int4.dequantized_bf16(qt, dt16)))
        del qt
    return sets, lib


def _library_ms(lib_in) -> float:
    return timing.graph_ms([lambda x=x, w=w: torch.matmul(x, w) for x, w in lib_in])


def p3_cases(libs) -> list:
    out = []
    for label, in_f, out_f in int4.SHAPES:
        nb = in_f // Q_BLOCK
        plan = gemv.i4_gemv_plan(nb, out_f)
        for rows in ROWS:
            sets, lib_in = operand_ring(in_f, out_f, rows, seed=rows)
            x8, xs, qt4, dt16, _, _ = sets[0]
            lib_ms = _library_ms(lib_in)
            del lib_in
            got = {d: int4.i4_call(x8, xs, qt4, dt16, d) for d in gemv.DOTS}
            want = int4.i4_call_plain(x8, xs, qt4, dt16)
            old1 = old_p3(libs["q40_i8_mma"], x8, xs, qt4, dt16, "int8")
            splits = cuda_q40.i8_mma_splits(nb, out_f)
            for dot in gemv.DOTS:
                arm = {"int8": int4.i4_call_int8, "bf16": int4.i4_call_bf16}[dot]
                before = arm.launches
                arm(x8, xs, qt4, dt16)
                launches = arm.launches - before
                nbytes = work(rows, in_f, out_f, 0.5, 2)[0]
                row = {"case": f"P3 {label.strip()} {dot}, {rows} rows", "shape": label,
                       "rows": rows, "dot": dot,
                       **_turns([lambda s=s, d=dot: old_p3(libs["q40_i8_mma"], *s[:4], d)
                                 for s in sets],
                                [lambda s=s, d=dot: int4.i4_call(*s[:4], d) for s in sets]),
                       "bound_ms": nbytes / BW * 1e3, "bound_by": "bytes",
                       "library_ms": lib_ms,
                       "plain_ms": timing.graph_ms([lambda: int4.i4_call_plain(
                           x8, xs, qt4, dt16, dot)], replays=3),
                       "new_equals_plain": torch.equal(got[dot], want),
                       "arms_bit_equal": torch.equal(got["int8"], got["bf16"]),
                       "new_vs_old_rel": _rel(got[dot], old1),
                       "plan": plan.__dict__, "ctas": plan.ctas(out_f),
                       "old_ctas": -(-out_f // 64) * splits, "launches_a_call": launches,
                       "old_launches_a_call": 1 if splits == 1 else 2}
                _emit(row, out)
            if rows > 1:  # each row equals its one-row call
                singles = torch.cat([int4.i4_call(x8[r:r + 1], xs[r:r + 1], qt4, dt16)
                                     for r in range(rows)])
                out[-1]["rows_equal_one_row_calls"] = torch.equal(singles, got["int8"])
            del sets
            torch.cuda.empty_cache()
    return out


def _best(times: dict):
    return min(times, key=times.get)


def p6_cases(libs) -> list:
    out = []
    lib = libs["i8_tile_probe"]
    for label, in_f, out_f in i4_tiles.SHAPES:
        nb = in_f // Q_BLOCK
        sets, lib_in = operand_ring(in_f, out_f, 1, seed=6)
        x8, xs, qt4, dt16, qw, bits = sets[0]
        lib_ms = _library_ms(lib_in)
        del lib_in
        old_tiles = [(c, k) for c in OLD_TILE_COLS for k in (8, 16, 32, 64, 128)
                     if k <= nb and nb % k == 0]
        old_t = {t: timing.graph_ms([lambda s=s, t=t: old_p6(lib, s[0], s[1], s[4], s[5], *t)
                                     for s in sets]) for t in old_tiles}
        new_tiles, left_out = i4_tiles.tiles_for(nb)
        new_t = {t: timing.graph_ms([lambda s=s, t=t: i4_tiles.i4_sweep_call(
            s[0], s[1], s[4], s[5], *t) for s in sets]) for t in new_tiles}
        ot, nt = _best(old_t), _best(new_t)
        got = i4_tiles.i4_sweep_call(x8, xs, qw, bits, *nt)
        want = i4_tiles.i4_sweep_call_plain(x8, xs, qw, bits, *nt)
        p3 = i4_tiles.p3_tile(nb, out_f)
        nbytes = work(1, in_f, out_f, 0.5, 2)[0]
        row = {"case": f"P6 {label.strip()}, 1 row, best tiles", "shape": label,
               "old_tile": ot, "new_tile": nt,
               **_turns([lambda s=s: old_p6(lib, s[0], s[1], s[4], s[5], *ot) for s in sets],
                        [lambda s=s: i4_tiles.i4_sweep_call(s[0], s[1], s[4], s[5], *nt)
                         for s in sets]),
               "bound_ms": nbytes / BW * 1e3, "bound_by": "bytes", "library_ms": lib_ms,
               "plain_ms": timing.graph_ms([lambda: i4_tiles.i4_sweep_call_plain(
                   x8, xs, qw, bits, *nt)], replays=3),
               "new_equals_plain": torch.equal(got, want),
               "new_vs_old_rel": _rel(got, old_p6(lib, x8, xs, qw, bits, *ot)),
               "p3_tile": p3, "p3_tile_ms": new_t.get(p3),
               "equals_p3_at_its_plan": torch.equal(
                   i4_tiles.i4_sweep_call(x8, xs, qw, bits, *p3),
                   int4.i4_call_bf16(x8, xs, qt4, dt16)),
               "old_tiles_ms": {f"{c}x{k}": v for (c, k), v in old_t.items()},
               "new_tiles_ms": {f"{c}x{k}": v for (c, k), v in new_t.items()},
               "left_out": left_out, "launches_a_call": 1,
               "old_launches_a_call": 1 if nb // ot[1] == 1 else 2}
        _emit(row, out)
        del sets
        torch.cuda.empty_cache()
    return out


def sweep_lib() -> ctypes.CDLL:
    """csrc/i4_gemv_probe.cu built with -DDLT_P3_SWEEP and -DDLT_GEMV_ROWS_1_8."""
    out_path = kernels.BUILD_DIR / "libi4_gemv_sweep.so"
    return _open(_compile(kernels.CSRC / f"{gemv.SOURCE}.cu", out_path,
                          ("-DDLT_P3_SWEEP", "-DDLT_GEMV_ROWS_1_8")),
                 out_path, gemv._SIG, f"{gemv.SOURCE}.cu -DDLT_P3_SWEEP")


def p3_sweep(lib) -> list:
    out = []
    for label, in_f, out_f in int4.SHAPES:
        nb = in_f // Q_BLOCK
        for rows in ROWS:
            sets, _ = operand_ring(in_f, out_f, rows, seed=rows)
            x8, xs, qt4, dt16, _, _ = sets[0]
            terms = gemv.block_terms(x8, xs, int4.unpack_s4(qt4), dt16.float())
            nbytes = work(rows, in_f, out_f, 0.5, 2)[0]
            for vec, kw in SWEEP_PAIRS:
                cols = 32 * vec * (gemv.WARPS // kw)
                for splits in (1, 2, 4, 8):
                    bps = -(-nb // splits)
                    if (splits - 1) * bps >= nb or bps > gemv.MAX_BPS:
                        continue
                    plan = GemvPlan(vec, cols, kw, splits, bps)
                    want = _gemv_order(terms, plan)
                    for dot, code in SWEEP_DOTS["s4"].items():
                        if dot == "bf16-mma" and vec > 8:  # the MMA layout: at most 8
                            continue
                        got = gemv.launch_i4_gemv(x8, xs, qt4, gemv.W_S4, code, dt16, plan, lib)
                        ms = timing.graph_ms([lambda s=s, p=plan, c=code: gemv.launch_i4_gemv(
                            s[0], s[1], s[2], gemv.W_S4, c, s[3], p, lib) for s in sets],
                            replays=10)
                        _emit({"sweep": "P3", "shape": label, "rows": rows, "dot": dot,
                               "plan": plan.__dict__, "ctas": plan.ctas(out_f), "ms": ms,
                               "bound_ms": nbytes / BW * 1e3,
                               "equals_plain": torch.equal(got, want)}, out)
            del sets, terms
            torch.cuda.empty_cache()
    return out


def p6_sweep(lib) -> list:
    """P6 at every tile of its five shapes, 1 row, on both bf16 routes of
    the sweep build `lib`, each held to its plain order bit for bit."""
    out = []
    for label, in_f, out_f in i4_tiles.SHAPES:
        nb = in_f // Q_BLOCK
        sets, _ = operand_ring(in_f, out_f, 1, seed=6)
        x8, xs, _, _, qw, bits = sets[0]
        terms = gemv.block_terms(x8, xs, int4.unpack_i32(qw), plane_f32(bits))
        nbytes = work(1, in_f, out_f, 0.5, 2)[0]
        for cols, blocks in i4_tiles.tiles_for(nb)[0]:
            plan = gemv.tile_plan(nb, cols, blocks)
            want = _gemv_order(terms, plan)
            for route, code in SWEEP_DOTS["i32"].items():
                got = gemv.launch_i4_gemv(x8, xs, qw, gemv.W_I32, code, bits, plan, lib)
                ms = timing.graph_ms([lambda s=s, p=plan, c=code: gemv.launch_i4_gemv(
                    s[0], s[1], s[4], gemv.W_I32, c, s[5], p, lib) for s in sets], replays=10)
                _emit({"sweep": "P6", "shape": label, "route": route, "cols": cols,
                       "blocks_per_cta": blocks, "ctas": plan.ctas(out_f), "ms": ms,
                       "bound_ms": nbytes / BW * 1e3, "equals_plain": torch.equal(got, want)},
                      out)
        del sets, terms
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--old", type=Path, help="directory of the earlier int8-MMA sources")
    mode.add_argument("--sweep", action="store_true", help="time every P3 plan")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("p3_p6_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = timing.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    if args.sweep:
        lib = sweep_lib()
        rows = p3_sweep(lib) + p6_sweep(lib)
    else:
        libs = build_old(args.old)
        kernels.build([gemv.SOURCE, "q40_i8_mma"])
        rows = p3_cases(libs) + p6_cases(libs)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows) + card + "\n")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
