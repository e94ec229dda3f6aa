"""K1 (the Q80 x Q40 decode GEMV: K1-stacked, K1 on the wcls and
K1-indexed) against an earlier build of the same source, and the sweep that
chooses its plan, in one process on one card.

    python -m distributed_llama_tpu_torch.probes.k1_ab --old DIR [--out FILE]
    python -m distributed_llama_tpu_torch.probes.k1_ab --sweep [--out FILE]

`--old`: DIR holds an earlier `q40_gemv.cu` with the C entry points of the
port before the cluster split-K K1 (the caller allocates the prologue's
scratch; no plan arguments), for example from `git show
<commit>:distributed_llama_tpu_torch/csrc/q40_gemv.cu`. It is compiled here
with the port's nvcc flags into build/kernels/ and called through its own C
signatures; the current kernel goes through the port's wrappers. Each case
is timed old, new, new, old (CUDA events over CUDA-graph replays,
probes/timing.graph_ms) and cold: a case's calls walk weights that together
take at least timing.RING_BYTES (4x the L2), so no call finds its weights in
L2. Beside them: its bound (bytes moved over the card's memory rate; the
int8 operations are far below their peak), one PyTorch call's time
(`torch.matmul` of the bf16 rows against the bf16-dequantized weight;
K1-indexed: against the slots' gathered bf16 experts) and the plain
version's. Every case also checks the two builds' outputs against each
other and the new one against `q40_gemv_q80_blocked` bit for bit.

`--sweep`: compiles csrc/q40_gemv.cu with -DDLT_GEMV_SWEEP (every (vec, kw)
pair a plan can name) and times every plan at each main-path shape at 1 and
8 rows (K1-indexed at 8 slots), cold as above, each held to
`q40_gemv_q80_blocked` at that plan bit for bit; then prints the fastest
plan a shape beside `gemv_plan`'s.

Prints one JSON line a case and the card's `nvidia-smi` name and power
limit; `--out` also writes them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import cuda_q40, kernels
from ..ops.quant import QuantTensor, dequantize_t
from . import timing
from .k2_k3_ab import BW, _stack, _wbytes

L1B, L30B, E30B, K30B = 16, 48, 128, 8
# (name, in, out) of the main path's K1 calls
SHAPES_1B = (("wqkv", 2048, 3072), ("wo", 2048, 2048), ("w13", 2048, 16384), ("w2", 8192, 2048))
WCLS_1B = ("wcls", 2048, 128256)
SHAPES_30B = (("wqkv", 2048, 5120), ("wo", 4096, 2048), ("wcls", 2048, 151936))
MOE_30B = (("w1", 2048, 768), ("w3", 2048, 768), ("w2", 768, 2048))
ROWS = (1, 8)

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_SIGS = {
    # x, x_is_bf16, q, d, out, rows, in, out, layer, x8, xs, bs, stream
    "q40_gemv_q80": (P, I, P, P, P, I, I, I, LL, P, P, P, P),
    # x, x_is_bf16, x_rows, q, d, idx, n_slots, n_groups, out, in, out, x8,
    # xs, bs, stream
    "q40_gemv_q80_indexed": (P, I, I, P, P, P, I, LL, P, I, I, P, P, P, P),
}


def _compile(src: Path, out: Path, defines=(), include: Path = kernels.CSRC) -> subprocess.Popen:
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, *defines, "-I", str(include), "-o",
           str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _open(proc: subprocess.Popen, out: Path, sigs: dict, what: str) -> ctypes.CDLL:
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {what}:\n{log}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.dlt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dlt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


class Old:
    """The earlier K1 behind the current wrappers' signatures: its prologue
    launch into scratch allocated here, then its GEMV launch."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib

    def _scratch(self, rows: int, in_f: int, device):
        return (torch.empty((rows, in_f), dtype=torch.int8, device=device),
                torch.empty((rows, in_f // 32), dtype=torch.float32, device=device),
                torch.empty((rows, in_f // 32), dtype=torch.int32, device=device))

    def stacked(self, x, q, d, layer: int) -> torch.Tensor:
        in_f, out_f = q.shape[-2] * 8, q.shape[-1]
        rows = x.numel() // in_f
        out = torch.empty((rows, out_f), dtype=torch.float32, device=x.device)
        x8, xs, bs = self._scratch(rows, in_f, x.device)
        kernels.check(self.lib, self.lib.q40_gemv_q80(
            x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(), d.data_ptr(),
            out.data_ptr(), rows, in_f, out_f, layer, x8.data_ptr(), xs.data_ptr(),
            bs.data_ptr(), _stream()), "old q40_gemv_q80")
        return out

    def indexed(self, x, q, d, idx) -> torch.Tensor:
        in_f, out_f = q.shape[-2] * 8, q.shape[-1]
        rows, n = x.numel() // in_f, idx.shape[0]
        out = torch.empty((n, out_f), dtype=torch.float32, device=x.device)
        x8, xs, bs = self._scratch(rows, in_f, x.device)
        kernels.check(self.lib, self.lib.q40_gemv_q80_indexed(
            x.data_ptr(), int(x.dtype == torch.bfloat16), rows, q.data_ptr(), d.data_ptr(),
            idx.data_ptr(), n, q.numel() // (in_f // 8 * out_f), out.data_ptr(), in_f, out_f,
            x8.data_ptr(), xs.data_ptr(), bs.data_ptr(), _stream()), "old q40_gemv_q80_indexed")
        return out


def ring_layers(in_f: int, out_f: int, at_least: int = 1) -> int:
    """Weights of this shape that together reach timing.RING_BYTES."""
    return max(at_least, timing.ring_size(_wbytes(in_f, out_f)))


def dense_case(name, old: Old, q, d, xs, lib_w, plain: bool = True) -> dict:
    """One call's case: call i runs xs[i] against layer i of the stack q/d;
    ms are a call's share of one graph of them all."""
    n = len(xs)
    in_f, out_f = q.shape[-2] * 8, q.shape[-1]
    rows = xs[0].numel() // in_f
    plan = cuda_q40.gemv_plan(in_f // 32, out_f)
    news = [cuda_q40.q40_gemv_q80_stacked(xs[i], q, d, i) for i in (0, n - 1)]
    diff = max((old.stacked(xs[i], q, d, i) - new).abs().max().item()
               for i, new in zip((0, n - 1), news))
    equal = all(torch.equal(new, cuda_q40.q40_gemv_q80_blocked(xs[i], q[i], d[i], plan))
                for i, new in zip((0, n - 1), news))
    old_calls = [lambda i=i: old.stacked(xs[i], q, d, i) for i in range(n)]
    new_calls = [lambda i=i: cuda_q40.q40_gemv_q80_stacked(xs[i], q, d, i) for i in range(n)]
    xb = [x.reshape(rows, in_f).to(torch.bfloat16) for x in xs]
    t = [timing.graph_ms(c) for c in (old_calls, new_calls, new_calls, old_calls)]
    nbytes = _wbytes(in_f, out_f) + rows * (in_f + out_f) * 4
    row = {"case": name, "rows": rows, "calls": n, "old_ms": (t[0] + t[3]) / 2,
           "new_ms": (t[1] + t[2]) / 2, "turns_ms": t, "bound_ms": nbytes / BW * 1e3,
           "bound_by": "bytes",
           "library_ms": timing.graph_ms([lambda i=i: torch.matmul(xb[i], lib_w[i])
                                          for i in range(n)]),
           "old_vs_new_max_abs": diff, "new_equals_blocked": equal, "plan": plan.__dict__,
           "ctas": plan.ctas(out_f)}
    if plain:
        row["plain_ms"] = timing.graph_ms(
            [lambda i=i: cuda_q40.q40_gemv_q80_plain(xs[i], q[i], d[i]) for i in range(2)],
            replays=3)
    row["speedup"] = row["old_ms"] / row["new_ms"]
    print(json.dumps(row), flush=True)
    return row


def dq(q, d):
    return dequantize_t(QuantTensor(q=q, d=d), torch.bfloat16)


def dense_cases(old: Old, gen) -> list:
    out = []
    rings = {n: _stack(gen, ring_layers(i, o, L1B), i, o) for n, i, o in SHAPES_1B}
    lib_w = {n: [dq(rings[n][0][li], rings[n][1][li]) for li in range(rings[n][0].shape[0])]
             for n, _, _ in SHAPES_1B}
    for rows in ROWS:
        xs = {n: [torch.randn((1, rows, i), device="cuda", generator=gen)
                  for _ in range(rings[n][0].shape[0])] for n, i, _ in SHAPES_1B}

        # one 1B token: 16 layers x (wqkv, wo, w13, w2), as the decode walks them
        def token(fn):
            return [lambda n=n, li=li: fn(n, li) for li in range(L1B) for n, _, _ in SHAPES_1B]

        calls = {
            "old": token(lambda n, li: old.stacked(xs[n][li], *rings[n], li)),
            "new": token(lambda n, li: cuda_q40.q40_gemv_q80_stacked(xs[n][li], *rings[n], li)),
            "lib": token(lambda n, li: torch.matmul(xs[n][li].reshape(rows, -1).to(torch.bfloat16),
                                                    lib_w[n][li])),
            "plain": token(lambda n, li: cuda_q40.q40_gemv_q80_plain(
                xs[n][li], rings[n][0][li], rings[n][1][li])),
        }
        t = [timing.graph_ms(calls[k]) * len(calls[k]) for k in ("old", "new", "new", "old")]
        nbytes = L1B * sum(_wbytes(i, o) + rows * (i + o) * 4 for _, i, o in SHAPES_1B)
        row = {"case": f"K1-stacked one 1B token: 16 layers x (wqkv, wo, w13, w2), {rows} rows",
               "rows": rows, "calls": len(calls["new"]), "old_ms": (t[0] + t[3]) / 2,
               "new_ms": (t[1] + t[2]) / 2, "turns_ms": t, "bound_ms": nbytes / BW * 1e3,
               "bound_by": "bytes",
               "library_ms": timing.graph_ms(calls["lib"]) * len(calls["lib"]),
               "plain_ms": timing.graph_ms(calls["plain"], replays=3) * len(calls["plain"])}
        row["speedup"] = row["old_ms"] / row["new_ms"]
        print(json.dumps(row), flush=True)
        out.append(row)
        for n, i, o in SHAPES_1B:  # a call, over the shape's ring
            out.append(dense_case(f"K1 1B {n} {i}->{o}, a call, {rows} rows", old, *rings[n],
                                  xs[n], lib_w[n], plain=rows == 1))
    del rings, lib_w
    torch.cuda.empty_cache()
    for model, (n, i, o) in [("1B", WCLS_1B)] + [("30B-A3B", s) for s in SHAPES_30B]:
        q, d = _stack(gen, ring_layers(i, o, 2), i, o)
        lw = [dq(q[li], d[li]) for li in range(q.shape[0])]
        for rows in ROWS:
            xs = [torch.randn((rows, i), device="cuda", generator=gen) for _ in range(q.shape[0])]
            out.append(dense_case(f"K1 {model} {n} {i}->{o}, a call, {rows} rows", old, q, d, xs,
                                  lw, plain=rows == 1))
        del q, d, lw
        torch.cuda.empty_cache()
    return out


def moe_cases(old: Old, gen) -> list:
    """K1-indexed over one 30B-A3B decode token: 48 layers x (w1, w3 on the
    one shared row, w2 on 8 rows) x 8 experts, on full flat [48 * 128]
    stacks (5.4 GB a role), and a call of each shape."""
    stacks = {n: _stack(gen, L30B * E30B, i, o) for n, i, o in MOE_30B}
    idx = [(torch.randperm(E30B, device="cuda", generator=gen)[:K30B] + li * E30B).to(torch.int32)
           for li in range(L30B)]
    xs = [torch.randn((1, 2048), device="cuda", generator=gen) for _ in range(L30B)]
    hs = [torch.randn((K30B, 768), device="cuda", generator=gen) for _ in range(L30B)]
    ins = {"w1": xs, "w3": xs, "w2": hs}
    lib_w = {n: [dq(stacks[n][0][idx[li].long()], stacks[n][1][idx[li].long()])
                 for li in range(L30B)] for n, _, _ in MOE_30B}
    lib_x = {"w1": [x.to(torch.bfloat16).expand(K30B, 1, 2048) for x in xs],
             "w2": [h.to(torch.bfloat16).unsqueeze(1) for h in hs]}
    lib_x["w3"] = lib_x["w1"]
    diff, equal = 0.0, True
    for n, i, o in MOE_30B:
        plan = cuda_q40.gemv_plan(i // 32, o)
        for li in (0, L30B - 1):
            new = cuda_q40.q40_gemv_q80_indexed(ins[n][li], *stacks[n], idx[li])
            diff = max(diff, (old.indexed(ins[n][li], *stacks[n], idx[li]) - new)
                       .abs().max().item())
            equal &= torch.equal(new, cuda_q40.q40_gemv_q80_indexed_blocked(
                ins[n][li], *stacks[n], idx[li], plan))

    def calls(fn, names):
        return [lambda n=n, li=li: fn(ins[n][li], *stacks[n], idx[li])
                for li in range(L30B) for n in names]

    def lib(names):
        return [lambda n=n, li=li: torch.matmul(lib_x[n][li], lib_w[n][li])
                for li in range(L30B) for n in names]

    def nbytes(names):
        return sum(K30B * _wbytes(i, o) + (1 if n != "w2" else K30B) * i * 4 + K30B * o * 4
                   for n, i, o in MOE_30B if n in names)

    out = []
    names = [n for n, _, _ in MOE_30B]
    groups = [("K1-indexed one 30B-A3B token: 48 layers x (w1, w3, w2), 8 slots", names, False)]
    groups += [(f"K1-indexed {n} {i}->{o}, a call, 8 slots", [n], True)
               for n, i, o in MOE_30B[1:]]
    for name, ns, per_call in groups:
        o_calls = calls(old.indexed, ns)
        n_calls = calls(cuda_q40.q40_gemv_q80_indexed, ns)
        scale = 1 if per_call else len(n_calls)
        t = [timing.graph_ms(c) * scale for c in (o_calls, n_calls, n_calls, o_calls)]
        row = {"case": name, "calls": len(n_calls), "old_ms": (t[0] + t[3]) / 2,
               "new_ms": (t[1] + t[2]) / 2, "turns_ms": t,
               "bound_ms": nbytes(ns) * (L30B if not per_call else 1) / BW * 1e3,
               "bound_by": "bytes", "library_ms": timing.graph_ms(lib(ns)) * scale,
               "old_vs_new_max_abs": diff, "new_equals_blocked": equal}
        if not per_call:
            row["plain_ms"] = timing.graph_ms(calls(cuda_q40.q40_gemv_q80_indexed_plain, ns),
                                              replays=3) * scale
        plan = cuda_q40.gemv_plan(MOE_30B[names.index(ns[-1])][1] // 32,
                                  MOE_30B[names.index(ns[-1])][2])
        row["plan"] = plan.__dict__
        row["speedup"] = row["old_ms"] / row["new_ms"]
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def candidates(nb: int, out_f: int) -> list:
    """Every plan the sweep build takes at this shape: vec 1, 2, 4 x kw 2,
    4, 8 x splits 1, 2, 4, 8 with every split non-empty and staged."""
    plans = []
    for vec in (1, 2, 4):
        for kw in (2, 4, 8):
            for splits in (1, 2, 4, 8):
                bps = -(-nb // splits)
                if (splits - 1) * bps >= nb or bps > cuda_q40.GEMV_MAX_BPS:
                    continue
                plans.append(cuda_q40.GemvPlan(vec, 32 * vec * (cuda_q40.GEMV_WARPS // kw), kw,
                                               splits, bps))
    return plans


def sweep(lib, gen) -> list:
    """Every candidate plan at each main-path shape, cold, held to
    q40_gemv_q80_blocked bit for bit."""
    out = []
    dense = [("1B",) + s for s in SHAPES_1B + (WCLS_1B,)] + [("30B-A3B",) + s for s in SHAPES_30B]
    for model, n, i, o in dense:
        q, d = _stack(gen, ring_layers(i, o, 2), i, o)
        nb = i // 32
        for rows in ROWS:
            xs = [torch.randn((rows, i), device="cuda", generator=gen) for _ in range(q.shape[0])]
            x8, xsc, bs = cuda_q40.quantize_rows_q80(xs[0], nb)
            terms = cuda_q40._gemv_terms(x8, xsc, bs, q[0], d[0])
            for plan in candidates(nb, o):
                got = cuda_q40._launch_gemv(xs[0], q, d, 0, plan, lib)
                equal = torch.equal(got, cuda_q40._gemv_order(terms, plan))
                ms = timing.graph_ms([lambda li=li, p=plan: cuda_q40._launch_gemv(
                    xs[li], q, d, li, p, lib) for li in range(q.shape[0])])
                out.append(_sweep_row(f"{model} {n} {i}->{o}", rows, nb, o, plan, ms, equal,
                                      _wbytes(i, o) + rows * (i + o) * 4))
            del terms
        del q, d
        torch.cuda.empty_cache()
    for n, i, o in (MOE_30B[0], MOE_30B[2]):  # w3 is w1's shape
        per = _wbytes(i, o) * K30B
        calls = max(2, timing.ring_size(per))
        q, d = _stack(gen, calls * K30B, i, o)
        idx = [torch.arange(c * K30B, (c + 1) * K30B, device="cuda", dtype=torch.int32)
               for c in range(calls)]
        rows = 1 if n == "w1" else K30B
        xs = [torch.randn((rows, i), device="cuda", generator=gen) for _ in range(calls)]
        for plan in candidates(i // 32, o):
            got = cuda_q40._launch_gemv_indexed(xs[0], q, d, idx[0], plan, lib)
            equal = torch.equal(got, cuda_q40.q40_gemv_q80_indexed_blocked(xs[0], q, d, idx[0],
                                                                           plan))
            ms = timing.graph_ms([lambda c=c, p=plan: cuda_q40._launch_gemv_indexed(
                xs[c], q, d, idx[c], p, lib) for c in range(calls)])
            out.append(_sweep_row(f"30B-A3B indexed {n} {i}->{o}, 8 slots", rows, i // 32, o,
                                  plan, ms, equal, per + rows * i * 4 + K30B * o * 4,
                                  slots=K30B))
        del q, d
        torch.cuda.empty_cache()
    best = {}
    for r in out:
        key = (r["sweep"], r["rows"])
        if key not in best or r["ms"] < best[key]["ms"]:
            best[key] = r
    for (shape, rows), r in best.items():
        nb, o = r["nb"], r["out"]
        chosen = cuda_q40.gemv_plan(nb, o)
        mine = next((x for x in out if x["sweep"] == shape and x["rows"] == rows
                     and x["plan"] == chosen.__dict__), None)
        print(json.dumps({"best": shape, "rows": rows, "plan": r["plan"], "ms": r["ms"],
                          "gemv_plan": chosen.__dict__,
                          "gemv_plan_ms": mine["ms"] if mine else None}), flush=True)
    return out


def _sweep_row(shape, rows, nb, out_f, plan, ms, equal, nbytes, slots=1) -> dict:
    row = {"sweep": shape, "rows": rows, "nb": nb, "out": out_f, "plan": plan.__dict__,
           "ctas": plan.ctas(out_f) * slots, "ms": ms, "bound_ms": nbytes / BW * 1e3,
           "equals_blocked": equal}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--old", type=Path, help="directory of the earlier q40_gemv.cu")
    mode.add_argument("--sweep", action="store_true", help="time every plan at each shape")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = timing.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.sweep:
        out = kernels.BUILD_DIR / "libk1_sweep.so"
        lib = _open(_compile(kernels.CSRC / "q40_gemv.cu", out, ("-DDLT_GEMV_SWEEP",)), out,
                    cuda_q40._GEMV_SIG, "q40_gemv.cu -DDLT_GEMV_SWEEP")
        rows = sweep(lib, gen)
    else:
        out = kernels.BUILD_DIR / "libold_q40_gemv.so"
        proc = _compile(args.old / "q40_gemv.cu", out)
        kernels.build(["q40_gemv"])
        old = Old(_open(proc, out, OLD_SIGS, "the earlier q40_gemv.cu"))
        rows = dense_cases(old, gen)
        torch.cuda.empty_cache()
        rows += moe_cases(old, gen)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows) + card + "\n")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
