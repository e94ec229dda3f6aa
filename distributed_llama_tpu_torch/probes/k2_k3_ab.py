"""K2 (the Q40 prefill GEMM, B3 and B5) and K3/B8 (prefill flash attention
and its shard-local partial, P8 on a head-major view) against an earlier
build of the same kernels, in one process on one card.

    python -m distributed_llama_tpu_torch.probes.k2_k3_ab --old DIR [--out FILE]

DIR holds an earlier `q40_gemm.cu` and `flash_attention.cu` with the C
entry points of the port before split-K and split-S (no plan arguments),
for example from `git show <commit>:distributed_llama_tpu_torch/csrc/...`.
They are compiled here with the port's nvcc flags into build/kernels/ and
called through their own C signatures; the current kernels go through the
port's wrappers. Each case is timed old, new, new, old (CUDA events over
CUDA-graph replays, probes/timing.graph_ms; a per-call case is a call's
share of REPS calls, or of one call per layer), beside its bound (bytes
moved over the card's memory rate, or flops over its bf16 peak, the
larger) and one PyTorch call's time where one computes the same function
(SDPA computes no (m, l) for B8: nearest call). Every case also checks the
two builds' outputs against each other. Prints one JSON line a case and
the card's `nvidia-smi` name and power limit; `--out` also writes them.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import cuda_attention, cuda_q40, kernels
from ..ops.quant import QuantTensor, dequantize_t
from . import timing

BW, BF16 = 3.35e12, 989e12  # H100 SXM data sheet: bytes/s, dense bf16 flop/s
L1B = 16
DIM, FF, NH, NKV, HD = 2048, 8192, 32, 8, 64  # Llama-3.2-1B
VOCAB = 128256
L30B, NH30, NKV30, HD30 = 48, 32, 4, 128  # Qwen3-30B-A3B attention
REPS = 16  # a one-call case is timed as REPS calls in one graph, per call
SHAPES = (("wqkv", DIM, (NH + 2 * NKV) * HD), ("wo", NH * HD, DIM), ("w13", DIM, 2 * FF),
          ("w2", FF, DIM))

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
OLD_SIGS = {
    "q40_gemm": {"q40_gemm_bf16": (P, P, P, P, I, I, I, LL, P)},
    "flash_attention": {
        "flash_attention_fwd": (P, I, P, P, LL, LL, LL, P, I, I, I, I, I, I, I, F, P),
        "flash_attention_partial_fwd": (P, I, P, P, LL, LL, LL, P, P, P, I, I, I, I, I, I, I, I,
                                        I, F, P),
    },
}


def build_old(src_dir: Path) -> dict:
    """Compile the earlier sources with the port's flags; {name: CDLL}."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in OLD_SIGS:
        out = kernels.BUILD_DIR / f"libold_{name}.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(out), str(src_dir / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the earlier {name}.cu:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in OLD_SIGS[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.dlt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dlt_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


class Old:
    """The earlier kernels behind the current wrappers' signatures."""

    def __init__(self, libs: dict):
        self.gemm_lib, self.flash_lib = libs["q40_gemm"], libs["flash_attention"]

    def q40_gemm(self, x, q, d, layer: int = 0) -> torch.Tensor:
        nb, out_f = q.shape[-2] // 4, q.shape[-1]
        xb = x.reshape(-1, nb * 32).to(torch.bfloat16).contiguous()
        out = torch.empty((xb.shape[0], out_f), dtype=torch.float32, device=x.device)
        kernels.check(self.gemm_lib, self.gemm_lib.q40_gemm_bf16(
            xb.data_ptr(), q.data_ptr(), d.data_ptr(), out.data_ptr(), xb.shape[0], nb * 32,
            out_f, layer, _stream()), "old q40_gemm_bf16")
        return out

    def flash(self, q, k, v, pos: int) -> torch.Tensor:
        b, t, nh, hd = q.shape
        out = torch.empty((b, t, nh, hd), dtype=torch.float32, device=q.device)
        ksb, kss, ksh, _ = k.stride()
        kernels.check(self.flash_lib, self.flash_lib.flash_attention_fwd(
            q.data_ptr(), int(q.dtype == torch.float32), k.data_ptr(), v.data_ptr(), ksb, kss, ksh,
            out.data_ptr(), b, t, k.shape[1], nh, k.shape[2], hd, pos, hd ** -0.5, _stream()),
            "old flash_attention_fwd")
        return out.to(q.dtype)

    def partial(self, q, k, v, pos: int, col: int) -> tuple:
        b, t, nh, hd = q.shape
        o = torch.empty((b, t, nh, hd), dtype=torch.float32, device=q.device)
        m = torch.empty((b, t, nh), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        ksb, kss, ksh, _ = k.stride()
        kernels.check(self.flash_lib, self.flash_lib.flash_attention_partial_fwd(
            q.data_ptr(), int(q.dtype == torch.float32), k.data_ptr(), v.data_ptr(), ksb, kss, ksh,
            o.data_ptr(), m.data_ptr(), l.data_ptr(), b, t, k.shape[1], nh, k.shape[2], hd, pos,
            col, cuda_attention._query_block(t), hd ** -0.5, _stream()), "old partial_fwd")
        return o, m, l


def _wbytes(in_f: int, out_f: int) -> int:
    return in_f * out_f // 2 + (in_f // 32) * out_f * 2


def _stack(gen, L, in_f, out_f):
    q = torch.randint(-2**31, 2**31 - 1, (L, in_f // 8, out_f), dtype=torch.int32, device="cuda",
                      generator=gen)
    d = (torch.rand((L, in_f // 32, out_f), device="cuda", generator=gen) * 0.016 + 0.004).half()
    return q, d


def case(name: str, old, new, lib, nbytes: float, flops: float, diff, per_call: bool = False,
         **work) -> dict:
    """old, new, new, old, each a list of zero-argument calls timed as one
    graph, and lib likewise: ms for the whole list, or a call's share of it
    with per_call (a list of one shape's calls over several layers'
    weights)."""
    n = 1 if per_call else len(old)
    t = [timing.graph_ms(c) * n for c in (old, new, new, old)]
    t_bytes, t_ops = nbytes / BW * 1e3, flops / BF16 * 1e3
    row = {"case": name, "old_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2, "turns_ms": t,
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": timing.graph_ms(lib) * n, "old_vs_new_max_abs": diff, **work}
    row["speedup"] = row["old_ms"] / row["new_ms"]
    print(json.dumps(row), flush=True)
    return row


def k2_cases(old: Old) -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    stacks = {n: _stack(gen, L1B, i, o) for n, i, o in SHAPES}
    rows_out = []
    for rows in (32, 16):
        xs = {n: torch.randn((rows, i), device="cuda", generator=gen) for n, i, _ in SHAPES}
        diff = max((old.q40_gemm(xs[n], *stacks[n], li)
                    - cuda_q40.q40_gemm_bf16_stacked(xs[n], *stacks[n], li)).abs().max().item()
                   for n, _, _ in SHAPES for li in (0, L1B - 1))
        lw = {n: [dequantize_t(QuantTensor(q=stacks[n][0][li], d=stacks[n][1][li]), torch.bfloat16)
                  for li in range(L1B)] for n, _, _ in SHAPES}
        xb = {n: x.to(torch.bfloat16) for n, x in xs.items()}

        def calls(fn, names):
            return [lambda n=n, li=li: fn(n, li) for n in names for li in range(L1B)]

        def old_call(n, li):
            old.q40_gemm(xs[n], *stacks[n], li)

        def new_call(n, li):
            cuda_q40.q40_gemm_bf16_stacked(xs[n], *stacks[n], li)

        def lib_call(n, li):
            torch.matmul(xb[n], lw[n][li])

        names = [n for n, _, _ in SHAPES]
        if rows == 32:
            nbytes = L1B * sum(_wbytes(i, o) + rows * (i + o) * 4 for _, i, o in SHAPES)
            flops = L1B * sum(2 * rows * i * o for _, i, o in SHAPES)
            rows_out.append(case("K2 chunk: 16 layers x (wqkv, wo, w13, w2), 32 rows",
                                 calls(old_call, names), calls(new_call, names),
                                 calls(lib_call, names), nbytes, flops, diff, rows=rows,
                                 calls=len(names) * L1B))
        for n, i, o in SHAPES:  # per call, over the 16 layers' weights
            plan = cuda_q40.gemm_plan(i // 32, o)
            rows_out.append(case(
                f"K2 {n} {i}->{o}, {rows} rows", calls(old_call, [n]), calls(new_call, [n]),
                calls(lib_call, [n]), _wbytes(i, o) + rows * (i + o) * 4, 2 * rows * i * o, diff,
                per_call=True, rows=rows, plan=plan.__dict__, ctas=plan.ctas(o, rows)))
        del lw
    del stacks
    wq, wd = _stack(gen, 1, DIM, VOCAB)
    wq, wd = wq[0], wd[0]
    w_bf16 = dequantize_t(QuantTensor(q=wq, d=wd), torch.bfloat16)
    for rows in (16, 32):
        x = torch.randn((rows, DIM), device="cuda", generator=gen)
        xb = x.to(torch.bfloat16)
        diff = (old.q40_gemm(x, wq, wd) - cuda_q40.q40_gemm_bf16(x, wq, wd)).abs().max().item()
        rows_out.append(case(f"B5 wcls {DIM}->{VOCAB}, {rows} rows",
                             [lambda: old.q40_gemm(x, wq, wd)] * REPS,
                             [lambda: cuda_q40.q40_gemm_bf16(x, wq, wd)] * REPS,
                             [lambda: torch.matmul(xb, w_bf16)] * REPS,
                             _wbytes(DIM, VOCAB) + rows * (DIM + VOCAB) * 4, 2 * rows * DIM * VOCAB,
                             diff, per_call=True, rows=rows))
    return rows_out


def _sdpa(q, k, v, pos: int):
    """SDPA on [b, H, t, hd] with the causal mask from pos (is_causal
    assumes top-left alignment)."""
    import torch.nn.functional as F

    t, S = q.shape[1], k.shape[1]
    mask = torch.arange(S, device="cuda")[None, :] <= pos + torch.arange(t, device="cuda")[:, None]
    sq, sk, sv = q.to(torch.bfloat16).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask, enable_gqa=True)


def k3_cases(old: Old) -> list:
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = []
    # one 32-token chunk at position 64 over a 256-row view, all layers
    for L, nh, nkv, hd in ((L1B, NH, NKV, HD), (L30B, NH30, NKV30, HD30)):
        t, pos, S = 32, 64, 256
        ck = torch.randn((L, 1, 4096, nkv, hd), device="cuda", generator=gen).to(torch.bfloat16)
        cv = torch.randn((L, 1, 4096, nkv, hd), device="cuda", generator=gen).to(torch.bfloat16)
        qs = [torch.randn((1, t, nh, hd), device="cuda", generator=gen) for _ in range(L)]
        views = [(qs[li], ck[li, :, :S], cv[li, :, :S]) for li in range(L)]
        diff = max((old.flash(a, b, c, pos) - cuda_attention.flash_attention(a, b, c, pos))
                   .abs().max().item() for a, b, c in views)
        visible = sum(pos + i + 1 for i in range(t))
        out.append(case(
            f"K3 chunk: {L} layers, hd {hd}, t {t} at pos {pos} over a {S}-row view",
            [lambda a=a, b=b, c=c: old.flash(a, b, c, pos) for a, b, c in views],
            [lambda a=a, b=b, c=c: cuda_attention.flash_attention(a, b, c, pos) for a, b, c in views],
            [_sdpa(a, b, c, pos) for a, b, c in views],
            L * (2 * t * nh * hd * 4 + 2 * (pos + t) * nkv * hd * 2), L * 4 * nh * hd * visible,
            diff, splits=cuda_attention.plan_for(qs[0], views[0][1]).splits))
        del ck, cv
    # long context: one chunk at position 6000 over an 8192-row view, hd 64
    t, pos, S = 32, 6000, 8192
    ck = torch.randn((2, 1, S, NKV, HD), device="cuda", generator=gen).to(torch.bfloat16)
    q = torch.randn((1, t, NH, HD), device="cuda", generator=gen)
    k, v = ck[0], ck[1]
    diff = (old.flash(q, k, v, pos) - cuda_attention.flash_attention(q, k, v, pos)).abs().max().item()
    visible = sum(pos + i + 1 for i in range(t))
    out.append(case(f"K3 long: hd {HD}, t {t} at pos {pos} over an {S}-row view",
                    [lambda: old.flash(q, k, v, pos)] * REPS,
                    [lambda: cuda_attention.flash_attention(q, k, v, pos)] * REPS,
                    [_sdpa(q, k, v, pos)] * REPS,
                    2 * t * NH * HD * 4 + 2 * (pos + t) * NKV * HD * 2, 4 * NH * HD * visible,
                    diff, per_call=True, splits=cuda_attention.plan_for(q, k).splits))
    # B8: the 4096-row shard 0 of a chunk at 4080, all visible, both widths
    for nh, nkv, hd in ((NH, NKV, HD), (NH30, NKV30, HD30)):
        t, S, pos = 32, 4096, 4080
        kv = torch.randn((2, 1, S, nkv, hd), device="cuda", generator=gen).to(torch.bfloat16)
        q = torch.randn((1, t, nh, hd), device="cuda", generator=gen)
        k, v = kv[0], kv[1]
        a, b = old.partial(q, k, v, pos, 0), cuda_attention.flash_attention_partial(q, k, v, pos, 0)
        diff = max((x - y).abs().max().item() for x, y in zip(a, b))
        visible = sum(min(S, pos + i + 1) for i in range(t))
        nbytes = 2 * t * nh * hd * 4 + 2 * min(S, pos + t) * nkv * hd * 2 + 2 * t * nh * 4
        out.append(case(f"B8 shard: hd {hd}, t {t} at pos {pos}, 4096-row shard at col 0",
                        [lambda: old.partial(q, k, v, pos, 0)] * REPS,
                        [lambda: cuda_attention.flash_attention_partial(q, k, v, pos, 0)] * REPS,
                        [_sdpa(q, k, v, pos)] * REPS, nbytes, 4 * nh * hd * visible, diff,
                        per_call=True, splits=cuda_attention.plan_for(q, k).splits,
                        library="SDPA, nearest"))
    # P8: K3 at t = 1 over a head-major 32768-row cache
    from .attention import headmajor_view

    S = 32768
    pos = S - 10
    kh = torch.randn((2, 1, NKV, S, HD), device="cuda", generator=gen).to(torch.bfloat16)
    k, v = headmajor_view(kh[0]), headmajor_view(kh[1])
    q = torch.randn((1, 1, NH, HD), device="cuda", generator=gen).to(torch.bfloat16)
    diff = (old.flash(q, k, v, pos).float() - cuda_attention.flash_attention(q, k, v, pos).float()
            ).abs().max().item()
    out.append(case(f"P8: K3 at t 1, pos {pos} over a head-major {S}-row cache",
                    [lambda: old.flash(q, k, v, pos)] * REPS,
                    [lambda: cuda_attention.flash_attention(q, k, v, pos)] * REPS,
                    [_sdpa(q, k, v, pos)] * REPS,
                    2 * (pos + 1) * NKV * HD * 2 + 2 * NH * HD * 2, 4 * NH * HD * (pos + 1), diff,
                    per_call=True, splits=cuda_attention.plan_for(q, k).splits))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path, help="directory of the earlier sources")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_k3_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = timing.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    old = Old(build_old(args.old))
    kernels.build(["q40_gemm", "flash_attention"])
    rows = k2_cases(old)
    torch.cuda.empty_cache()
    rows += k3_cases(old)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows) + card + "\n")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
