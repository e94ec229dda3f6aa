"""P4 (the int8 decode matmul from [nb, 4, out] int32 nibble words, three
dots) and P11 (the pure K/V read) against their earlier designs, the sweep
that chooses their defaults, and the floor of one kernel node in a CUDA
graph, in one process on one card.

    python -m distributed_llama_tpu_torch.probes.p4_p11_ab --old DIR [--out FILE]
    python -m distributed_llama_tpu_torch.probes.p4_p11_ab --sweep [p4|p11] [--out FILE]

`--old`: DIR holds an earlier `q40_i8_mma.cu`, `q40_i8_mma.cuh` and
`attention_probe.cu`, for example from `git show
<commit>:distributed_llama_tpu_torch/csrc/<file>`, in which P4 ran the
int8-MMA template (4 warps and 64 columns a CTA, each block staged in
shared memory, split-K `cuda_q40.i8_mma_splits` summed by a second kernel)
and P11 two launches (a split partial and an ordered combine). They are
compiled here with the port's nvcc flags, `-I DIR` and then `-I` the
current csrc/, into build/kernels/, and called through their own C
signatures (OLD_SIG). The new arms are the current build: P4 on the
one-row GEMV of csrc/i8_gemv.cuh through csrc/i4_gemv_probe.cu, P11 in
one launch (csrc/attention_probe.cu). Cases: P4's three arms at the JAX
probe's five shapes (probes/int4.py SHAPES), 1 and 8 rows; P11 at S 1024
and 32768, head_dim 64 and 128, batch 1 and 4 (kv 8). Each is timed old,
new, new, old: CUDA events over CUDA-graph replays (probes/timing.graph_ms),
cold, a case's calls walking copies of their operands that together take
at least timing.RING_BYTES (4x the L2), and hot, every call on one copy.
Beside them: the bound (bytes moved over the card's memory rate), one
PyTorch call's time (P4: `torch.matmul` of the bf16 rows against the
bf16-dequantized weight; P11: `torch.sum` of K and of V, the nearest call,
not the same function), the plain version's time, the launches a call and
the checks: the new output bit for bit its plain order (P4: and, where
its plan sums in P3's order, P3's int8 arm on the same values; P11: and within 1e-6 of the column's sum of
magnitudes of the closed form), and the new output against the old one
and P4's against B9, relative to the output's largest value. Then the
floor of one kernel node in a graph: a one-element `Tensor.add_` chained in
a graph as the probes are, timed before and after P11's cases.

`--sweep` (or `--sweep p4` / `--sweep p11`): P4 through csrc/i4_gemv_probe.cu
built with -DDLT_P3_SWEEP and -DDLT_GEMV_ROWS_1_8 (every (columns a lane,
warps along k) pair of SWEEP_PAIRS by 1, 2, 4 or 8 splits, the int8 dot and
the bf16 dot on both routes, at 1 and 8 rows of the five shapes), each
plan marked with the probes' rules that give it (`gemv.i4_gemv_plan`,
P3's, and `gemv.u4_gemv_plan` of the feature-split words, P9's, which P4
takes); P11 through csrc/attention_probe.cu built with -DDLT_P11_SWEEP at
a grid of each of SWEEP_CTAS CTAs over the batch and each count of rows in
flight of READ_SWEEP_UNROLLS, at P11's cases. Each point is held to its plain order bit for bit. The summary rows
give each P4 rule's time against the best plan, and P11's best plan beside
its default: how the defaults were chosen.

Prints one JSON line a case and the card's `nvidia-smi` name and power
limit; `--out` also writes them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

import torch

from ..formats.quants import Q_BLOCK
from ..ops import cuda_q40, kernels
from ..ops.cuda_q40 import GemvPlan, _gemv_order
from . import attention, gemv, int4, timing
from .k1_ab import _compile, _open
from .p3_p6_ab import SWEEP_PAIRS, _library_ms, operand_ring
from .scales import work

BW = 3.35e12  # H100 SXM data sheet: bytes/s
ROWS = (1, 8)
P11_CASES = tuple((S, hd, b) for S in (1024, 32768) for hd in attention.HEAD_DIMS
                  for b in (1, 4))
P11_KV = 8
OLD_SOURCES = ("q40_i8_mma.cu", "q40_i8_mma.cuh", "attention_probe.cu")
P, I = ctypes.c_void_p, ctypes.c_int
OLD_SIG = {
    # x8, xs, w, weights, dot, dt, out, part, rows, nb, out, splits, stream
    "q40_i8_mma": (P, P, P, I, I, P, P, P, I, I, I, I, P),
    # k, v, b, n_kv, S, hd, splits, part, out, stream
    "pure_read": (P, P, I, I, I, I, I, P, P, P),
}
OLD_W_I32 = 2  # the earlier template's weights code of the nibble words
OLD_DOTS = {"int8": 0, "bf16": 1, "f32": 2}
OLD_READ_THREADS, OLD_MAX_READ_SPLITS = 256, 512
# the sweep build's dot codes for the nibble words: the int8 dot, and the
# bf16 dot on the CUDA cores (the chosen route, code 1) and on mma.sync
P4_SWEEP_DOTS = {"int8": 0, "bf16-fma": 1, "bf16-mma": gemv.SWEEP_BF16_OTHER}
# P11's sweep: a grid of about 16 .. 512 CTAs over the batch
SWEEP_CTAS = (16, 32, 64, 128, 256, 512)
FLOOR_CALLS = 256  # kernel nodes in the floor's graph


def old_sources(src_dir: Path) -> dict:
    """The earlier sources in `src_dir`: {file name: path}; raises if one
    is missing."""
    src_dir = Path(src_dir)
    missing = [f for f in OLD_SOURCES if not (src_dir / f).is_file()]
    if missing:
        raise FileNotFoundError(f"{src_dir} lacks the earlier {', '.join(missing)}")
    return {f: src_dir / f for f in OLD_SOURCES}


def build_old(src_dir: Path) -> dict:
    """Compile the earlier q40_i8_mma.cu and attention_probe.cu against the
    headers beside them (then csrc/'s), and the current sources, all at
    once; returns {name: earlier library}."""
    old_sources(src_dir)
    procs = {}
    for name, fn in (("q40_i8_mma", "q40_i8_mma"), ("attention_probe", "pure_read")):
        out = kernels.BUILD_DIR / f"libold_{name}.so"
        procs[name] = (_compile(Path(src_dir) / f"{name}.cu", out, ("-I", str(kernels.CSRC)),
                                include=Path(src_dir)), out, {fn: OLD_SIG[fn]})
    kernels.build([gemv.SOURCE, "q40_i8_mma", "attention_probe"])
    return {name: _open(proc, out, sig, f"the earlier {name}.cu")
            for name, (proc, out, sig) in procs.items()}


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def old_p4(lib, x8, xs, qw, dt, dot: str) -> torch.Tensor:
    """The earlier P4: the int8-MMA template's nibble-word instance at 64
    columns a CTA and i8_mma_splits, its splits summed by a second kernel."""
    R, nb, out_f = x8.shape[0], qw.shape[0], qw.shape[2]
    splits = cuda_q40.i8_mma_splits(nb, out_f)
    out = torch.empty((R, out_f), dtype=torch.float32, device=x8.device)
    part = torch.empty((splits, R, out_f) if splits > 1 else (1,), dtype=torch.float32,
                       device=x8.device)
    kernels.check(lib, lib.q40_i8_mma(
        x8.data_ptr(), xs.data_ptr(), qw.data_ptr(), OLD_W_I32, OLD_DOTS[dot], dt.data_ptr(),
        out.data_ptr(), part.data_ptr(), R, nb, out_f, splits, _stream()), "old q40_i8_mma")
    return out


def old_read_splits(n_kv: int, S: int, hd: int) -> int:
    """The earlier P11's split of a row: one iteration of a CTA's threads
    at the least, at most OLD_MAX_READ_SPLITS."""
    return max(1, min(-(-n_kv * S // (OLD_READ_THREADS // (hd // 8))), OLD_MAX_READ_SPLITS))


def old_p11(lib, k, v) -> torch.Tensor:
    """The earlier P11: a split partial, then an ordered combine."""
    b, n_kv, S, hd = k.shape
    splits = old_read_splits(n_kv, S, hd)
    part = torch.empty((b, splits, hd), dtype=torch.float32, device=k.device)
    out = torch.empty((b, 1, hd), dtype=torch.float32, device=k.device)
    kernels.check(lib, lib.pure_read(k.data_ptr(), v.data_ptr(), b, n_kv, S, hd, splits,
                                     part.data_ptr(), out.data_ptr(), _stream()), "old pure_read")
    return out


def _ms(calls, replays: int = 20) -> float:
    return timing.graph_ms(calls, replays=replays)


def _rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def _emit(row: dict, rows: list) -> None:
    print(json.dumps(row), flush=True)
    rows.append(row)


def node_floor() -> float:
    """ms of one kernel node in a graph: FLOOR_CALLS one-element add_ calls
    chained in one graph, a replay's time over their number."""
    t = torch.zeros(1, device="cuda")
    return _ms([lambda: t.add_(1.0)] * FLOOR_CALLS)


def read_ring(S: int, hd: int, b: int, seed: int) -> list:
    """Copies of P11's (K, V) [b, kv 8, S, hd] bf16 that together reach the
    ring."""
    nbytes = attention.work(b, P11_KV, P11_KV, hd, S, S)["pure_read"]
    return [attention.make_operands(b, P11_KV, P11_KV, hd, S, "cuda", seed=seed + i)[1:]
            for i in range(timing.ring_size(nbytes))]


def _sum_kv(k, v):
    return (torch.sum(k, dim=(1, 2), dtype=torch.float32)
            + torch.sum(v, dim=(1, 2), dtype=torch.float32))


# ---------------------------------------------------------------------------
# --old: the A/B
# ---------------------------------------------------------------------------


def p4_cases(old) -> list:
    out = []
    for label, in_f, out_f in int4.SHAPES:
        nb = in_f // Q_BLOCK
        plan = int4.i32_plan(nb, out_f)
        p3_plan = gemv.i4_gemv_plan(nb, out_f)
        same = (plan.kw, plan.splits, plan.blocks_per_split) == (
            p3_plan.kw, p3_plan.splits, p3_plan.blocks_per_split)
        for rows in ROWS:
            sets, lib_in = operand_ring(in_f, out_f, rows, seed=rows)
            x8, xs, qt4, dt16, qw, _ = sets[0]
            lib_ms = _library_ms(lib_in)
            lib_hot = _ms([lambda: torch.matmul(*lib_in[0])] * len(lib_in))
            del lib_in
            nbytes = work(rows, in_f, out_f, 0.5, 2)[0]
            p3 = int4.i4_call_int8(x8, xs, qt4, dt16)
            b9 = cuda_q40.q40_i8_unpacked(x8, xs, int4.unpack_s4(qt4), dt16)
            want = int4.i32_call_plain(x8, xs, qw, dt16)
            for dot in int4.P4_DOTS:
                fn = int4._I32[dot]
                new_c = [lambda s=s, f=fn: f(s[0], s[1], s[4], s[3]) for s in sets]
                old_c = [lambda s=s, d=dot: old_p4(old, s[0], s[1], s[4], s[3], d) for s in sets]
                t = [_ms(c) for c in (old_c, new_c, new_c, old_c)]
                hot = [_ms([c[0]] * len(sets)) for c in (old_c, new_c, new_c, old_c)]
                before = fn.launches
                got = fn(x8, xs, qw, dt16)
                launches = fn.launches - before
                old1 = old_p4(old, x8, xs, qw, dt16, dot)
                row = {
                    "case": f"P4 {dot} {label.strip()}, {rows} rows", "probe": "P4",
                    "dot": dot, "shape": label, "in": in_f, "out": out_f, "rows": rows,
                    "old_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2, "turns_ms": t,
                    "old_hot_ms": (hot[0] + hot[3]) / 2, "new_hot_ms": (hot[1] + hot[2]) / 2,
                    "bound_ms": nbytes / BW * 1e3, "bound_by": "bytes",
                    "library_ms": lib_ms, "library_hot_ms": lib_hot,
                    "plain_ms": _ms([lambda: int4.i32_call_plain(x8, xs, qw, dt16, dot)],
                                    replays=3),
                    "plan": plan.__dict__, "ctas": plan.ctas(out_f),
                    "launches_a_call": launches,
                    "old_launches_a_call": 1 if cuda_q40.i8_mma_splits(nb, out_f) == 1 else 2,
                    "new_equals_plain": torch.equal(got, want),
                    "p3_plan": p3_plan.__dict__,
                    "new_equals_p3_int8": torch.equal(got, p3) if same else None,
                    "new_vs_b9_rel": _rel(got, b9), "new_vs_old_rel": _rel(got, old1),
                }
                row["speedup"] = row["old_ms"] / row["new_ms"]
                if rows > 1:
                    singles = torch.cat([fn(x8[r:r + 1], xs[r:r + 1], qw, dt16)
                                         for r in range(rows)])
                    row["rows_equal_one_row_calls"] = torch.equal(singles, got)
                _emit(row, out)
            del sets, p3, b9, want
            torch.cuda.empty_cache()
    return out


def p11_cases(old) -> list:
    out = []
    for S, hd, b in P11_CASES:
        sets = read_ring(S, hd, b, seed=S + hd + b)
        k, v = sets[0]
        nbytes = attention.work(b, P11_KV, P11_KV, hd, S, S)["pure_read"]
        plan = attention.read_plan(b, P11_KV, S, hd)
        new_c = [lambda s=s: attention.pure_read(*s) for s in sets]
        old_c = [lambda s=s: old_p11(old, *s) for s in sets]
        t = [_ms(c) for c in (old_c, new_c, new_c, old_c)]
        hot = [_ms([c[0]] * len(sets)) for c in (old_c, new_c, new_c, old_c)]
        lib_c = [lambda s=s: _sum_kv(*s) for s in sets]
        before = attention.pure_read.launches
        got = attention.pure_read(k, v)
        launches = attention.pure_read.launches - before
        want = attention.pure_read_order_plain(k, v)
        closed = attention.pure_read_plain(k, v)
        mag = (k.float().abs().sum(dim=(1, 2)) + v.float().abs().sum(dim=(1, 2))).unsqueeze(1)
        row = {
            "case": f"P11 S {S}, hd {hd}, b {b}", "probe": "P11", "S": S, "hd": hd, "b": b,
            "kv": P11_KV, "old_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2,
            "turns_ms": t, "old_hot_ms": (hot[0] + hot[3]) / 2,
            "new_hot_ms": (hot[1] + hot[2]) / 2, "hot_turns_ms": hot,
            "bound_ms": nbytes / BW * 1e3, "bound_by": "bytes",
            "library_ms": _ms(lib_c), "library_hot_ms": _ms([lib_c[0]] * len(sets)),
            "plain_ms": _ms([lambda: attention.pure_read_order_plain(k, v)], replays=3),
            "plan": plan.__dict__, "ctas": b * plan.splits,
            "old_ctas": b * old_read_splits(P11_KV, S, hd),
            "launches_a_call": launches, "old_launches_a_call": 2,
            "new_equals_plain": torch.equal(got, want),
            "within_closed_form": bool(((got - closed).abs() <= 1e-6 * mag).all()),
            "new_vs_old_rel": _rel(got, old_p11(old, k, v)),
        }
        row["speedup"] = row["old_ms"] / row["new_ms"]
        _emit(row, out)
        del sets, k, v
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# --sweep
# ---------------------------------------------------------------------------


def p4_sweep(lib) -> list:
    out = []
    for label, in_f, out_f in int4.SHAPES:
        nb = in_f // Q_BLOCK
        rules = {"i4_gemv_plan": gemv.i4_gemv_plan(nb, out_f),
                 "u4_gemv_plan": gemv.u4_gemv_plan(nb, out_f, gemv.W_FS)}
        for rows in ROWS:
            sets, lib_in = operand_ring(in_f, out_f, rows, seed=rows)
            del lib_in
            x8, xs, _, dt16, qw, _ = sets[0]
            terms = gemv.block_terms(x8, xs, int4.unpack_i32(qw), dt16.float())
            nbytes = work(rows, in_f, out_f, 0.5, 2)[0]
            for vec, kw in SWEEP_PAIRS:
                cols = 32 * vec * (gemv.WARPS // kw)
                for splits in (1, 2, 4, 8):
                    bps = -(-nb // splits)
                    if (splits - 1) * bps >= nb or bps > gemv.MAX_BPS:
                        continue
                    plan = GemvPlan(vec, cols, kw, splits, bps)
                    want = _gemv_order(terms, plan)
                    for dot, code in P4_SWEEP_DOTS.items():
                        if dot == "bf16-mma" and vec > 8:  # the MMA layout: at most 8
                            continue
                        got = gemv.launch_i4_gemv(x8, xs, qw, gemv.W_I32, code, dt16, plan, lib)
                        ms = _ms([lambda s=s, p=plan, c=code: gemv.launch_i4_gemv(
                            s[0], s[1], s[4], gemv.W_I32, c, s[3], p, lib) for s in sets],
                            replays=10)
                        _emit({"sweep": "P4", "shape": label, "rows": rows, "dot": dot,
                               "plan": plan.__dict__, "ctas": plan.ctas(out_f), "ms": ms,
                               "bound_ms": nbytes / BW * 1e3,
                               "rules": [r for r, p in rules.items() if p == plan],
                               "equals_plain": torch.equal(got, want)}, out)
            del sets, terms
            torch.cuda.empty_cache()
    return out


def p4_summary(rows: list) -> list:
    """A rule's time against the best plan a (dot, rows): the ratio at each
    shape and its mean over the shapes."""
    out = []
    for dot in P4_SWEEP_DOTS:
        for n in ROWS:
            pts = [r for r in rows if r["dot"] == dot and r["rows"] == n]
            shapes = list(dict.fromkeys(r["shape"] for r in pts))
            best = {s: min(r["ms"] for r in pts if r["shape"] == s) for s in shapes}
            for rule in ("i4_gemv_plan", "u4_gemv_plan"):
                at = {s: next(r["ms"] for r in pts if r["shape"] == s and rule in r["rules"])
                      for s in shapes}
                out.append({"summary": "P4", "dot": dot, "rows": n, "rule": rule,
                            "ms": at, "best_ms": best,
                            "ratio": {s: at[s] / best[s] for s in shapes},
                            "mean_ratio": statistics.mean(at[s] / best[s] for s in shapes)})
    return out


def sweep_libs(which: str) -> dict:
    """The sweep builds `which` asks for, compiled at once: "p4"
    csrc/i4_gemv_probe.cu with -DDLT_P3_SWEEP and -DDLT_GEMV_ROWS_1_8, "p11"
    csrc/attention_probe.cu with -DDLT_P11_SWEEP."""
    builds = {"p4": (gemv.SOURCE, ("-DDLT_P3_SWEEP", "-DDLT_GEMV_ROWS_1_8"), gemv._SIG),
              "p11": ("attention_probe", ("-DDLT_P11_SWEEP",), attention._SIG)}
    procs = {}
    for key, (src, defines, sig) in builds.items():
        if which in ("all", key):
            out = kernels.BUILD_DIR / f"lib{src}_sweep_{key}.so"
            procs[key] = (_compile(kernels.CSRC / f"{src}.cu", out, defines), out, sig,
                          f"{src}.cu {' '.join(defines)}")
    return {key: _open(*args) for key, args in procs.items()}


def p11_sweep(lib) -> list:
    out = []
    for S, hd, b in P11_CASES:
        sets = read_ring(S, hd, b, seed=S + hd + b)
        k, v = sets[0]
        nbytes = attention.work(b, P11_KV, P11_KV, hd, S, S)["pure_read"]
        seen = set()
        for unroll in attention.READ_SWEEP_UNROLLS:
            for n in SWEEP_CTAS:
                plan = attention.read_plan(b, P11_KV, S, hd, -(-n // b), unroll)
                if plan in seen:
                    continue
                seen.add(plan)
                got = attention._launch_read(k, v, plan, lib)
                calls = [lambda s=s, p=plan: attention._launch_read(*s, p, lib) for s in sets]
                _emit({"sweep": "P11", "S": S, "hd": hd, "b": b, "plan": plan.__dict__,
                       "ctas": b * plan.splits, "ms": _ms(calls),
                       "hot_ms": _ms([calls[0]] * len(sets)), "bound_ms": nbytes / BW * 1e3,
                       "equals_plain": torch.equal(
                           got, attention.pure_read_order_plain(k, v, plan))}, out)
        del sets, k, v
        torch.cuda.empty_cache()
    return out


def p11_summary(rows: list) -> list:
    """The best plan a case, cold and hot, and the default plan's times."""
    out = []
    for S, hd, b in P11_CASES:
        pts = [r for r in rows if (r["S"], r["hd"], r["b"]) == (S, hd, b)]
        default = attention.read_plan(b, P11_KV, S, hd).__dict__
        row = {"summary": "P11", "S": S, "hd": hd, "b": b}
        for key in ("ms", "hot_ms"):
            best = min(pts, key=lambda r: r[key])
            row[f"best_{key}"], row[f"best_{key}_plan"] = best[key], best["plan"]
        at = [r for r in pts if r["plan"] == default]
        if at:
            row["default_ms"], row["default_hot_ms"] = at[0]["ms"], at[0]["hot_ms"]
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--old", type=Path, help="directory of the earlier sources")
    mode.add_argument("--sweep", nargs="?", const="all", choices=("all", "p4", "p11"),
                      help="time every P4 plan and every P11 plan")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if args.old is not None:
        old_sources(args.old)
    if not torch.cuda.is_available():
        print("p4_p11_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = timing.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    rows = []
    if args.sweep:
        libs = sweep_libs(args.sweep)
        if "p11" in libs:
            pts = p11_sweep(libs["p11"])
            rows += pts
            for r in p11_summary(pts):
                _emit(r, rows)
        if "p4" in libs:
            pts = p4_sweep(libs["p4"])
            rows += pts
            for r in p4_summary(pts):
                _emit(r, rows)
    else:
        old = build_old(args.old)
        _emit({"case": "kernel-node floor", "when": "before", "floor_ms": node_floor(),
               "calls_a_graph": FLOOR_CALLS}, rows)
        rows += p11_cases(old["attention_probe"])
        _emit({"case": "kernel-node floor", "when": "after", "floor_ms": node_floor(),
               "calls_a_graph": FLOOR_CALLS}, rows)
        rows += p4_cases(old["q40_i8_mma"])
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows) + card + "\n")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
