"""K4 (the MoE grouped Q40 GEMM, B7) and K5 (int8 paged decode attention,
B6) against an earlier build of the same kernels, in one process on one
card.

    python -m distributed_llama_tpu_torch.probes.k4_k5_ab --old DIR [--out FILE]

DIR holds an earlier `q40_grouped_gemm.cu` and `paged_attention.cu` with
the C entry points of the port before the split-S K5 and the
swapped-operand K4 (no plan, workspace or ticket arguments), for example
from `git show <commit>:distributed_llama_tpu_torch/csrc/...`. They are
compiled here with the port's nvcc flags into build/kernels/ and called
through their own C signatures; the current kernels go through the port's
wrappers. Each case is timed old, new, new, old (CUDA events over
CUDA-graph replays, probes/timing.graph_ms), beside its bound (bytes moved
over the card's memory rate, or flops over its bf16 peak, the larger) and
one PyTorch call's time (K4: `torch._grouped_mm` on the layer's
bf16-dequantized experts; K5: SDPA on a pre-gathered dequantized bf16
view, the nearest call, not the same function). Every case also checks
the two builds' outputs against each other. Prints one JSON line a case
and the card's `nvidia-smi` name and power limit; `--out` also writes
them. Needs a CUDA device.
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
from ..ops.kv_quant import dequantize_kv
from ..ops.quant import QuantTensor, dequantize_t
from . import timing
from .k2_k3_ab import BF16, BW, _wbytes, case

L1B, NKV1B, G1B, HD1B = 16, 8, 4, 64           # Llama-3.2-1B attention
L30B, NKV30B, G30B, HD30B = 48, 4, 8, 128      # Qwen3-30B-A3B attention
DIM30B, FF30B, E30B, K30B = 2048, 768, 128, 8  # Qwen3-30B-A3B experts
PS = 16          # the engine's page size
SEQ_LEN = 4096   # a parked row's pos_base
CHUNK = 32       # prefill chunk tokens

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
OLD_SIGS = {
    "paged_attention": {
        "paged_attention_fwd": (P, I, P, P, P, P, P, I, P, P, I, I, I, I, I, I, I, I, LL, F, P),
    },
    "q40_grouped_gemm": {"q40_grouped_gemm_bf16": (P, P, P, P, I, LL, P, I, I, I, P)},
}


def build_old(src_dir: Path) -> dict:
    """Compile the earlier sources with the port's flags; {name: CDLL}."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in OLD_SIGS:
        out = kernels.BUILD_DIR / f"libold_{name}.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", str(out),
               str(src_dir / f"{name}.cu")]
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
        self.paged_lib, self.grouped_lib = libs["paged_attention"], libs["q40_grouped_gemm"]

    def paged(self, q, k, v, ks, vs, layer, pos, table, n_read, ps) -> torch.Tensor:
        b, t, nh, hd = q.shape
        out = torch.empty_like(q)
        kernels.check(self.paged_lib, self.paged_lib.paged_attention_fwd(
            q.data_ptr(), int(q.dtype == torch.float32), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), table.data_ptr(), table.stride(0), pos.data_ptr(), out.data_ptr(), b, t,
            nh, k.shape[3], hd, ps, n_read, k.shape[1], layer, hd ** -0.5, _stream()),
            "old paged_attention_fwd")
        return out

    def grouped(self, xp, q, d, be, block_r: int) -> torch.Tensor:
        nb, out_f = q.shape[-2] // 4, q.shape[-1]
        xb = xp.to(torch.bfloat16).contiguous()
        out = torch.empty((xp.shape[0], out_f), dtype=torch.float32, device=xp.device)
        kernels.check(self.grouped_lib, self.grouped_lib.q40_grouped_gemm_bf16(
            xb.data_ptr(), q.data_ptr(), d.data_ptr(), be.data_ptr(), be.shape[0],
            q.numel() // (nb * 4 * out_f), out.data_ptr(), block_r, nb * 32, out_f, _stream()),
            "old q40_grouped_gemm_bf16")
        return out


def paged_inputs(gen, L, n_kv, g, hd, b, n_read, pos=None, t=1):
    """An int8 pool with b * n_read mapped pages in random order; with b >
    1 row 1 is parked (pos_base = seq_len) and the live rows sit at random
    positions in the last two pages of their view, every fifth row from row
    2 with its tail past the causal limit unmapped; `pos` fixes b = 1's."""
    kv_len = n_read * PS
    n_pages = b * n_read + 8
    k = torch.randint(-127, 128, (L, n_pages, PS, n_kv, hd), dtype=torch.int8, device="cuda",
                      generator=gen)
    v = torch.randint(-127, 128, (L, n_pages, PS, n_kv, hd), dtype=torch.int8, device="cuda",
                      generator=gen)
    ks = torch.rand((L, n_pages, PS, n_kv), device="cuda", generator=gen) * 0.02 + 1e-3
    vs = torch.rand((L, n_pages, PS, n_kv), device="cuda", generator=gen) * 0.02 + 1e-3
    table = torch.randperm(n_pages, device="cuda", generator=gen)[: b * n_read].reshape(b, n_read)
    table = table.to(torch.int32).contiguous()
    if pos is None:
        p = torch.randint(kv_len - 2 * PS, kv_len - t + 1, (b,), device="cuda", generator=gen)
        if b > 1:
            p[1] = SEQ_LEN
    else:
        p = torch.tensor([pos], device="cuda")
    for r in range(2, b, 5):
        table[r, (int(p[r]) + t - 1) // PS + 1:] = -1
    q = torch.randn((b, t, n_kv * g, hd), device="cuda", generator=gen)
    return q, k, v, ks, vs, p.contiguous(), table


def k5_cases(old: Old) -> list:
    import torch.nn.functional as Fn

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    shapes = [("llama32_1b", L1B, NKV1B, G1B, HD1B, 16, 16, None),
              ("llama32_1b", L1B, NKV1B, G1B, HD1B, 16, 64, None),
              ("llama32_1b", L1B, NKV1B, G1B, HD1B, 1, 32, 300),
              ("qwen3_30b_a3b", L30B, NKV30B, G30B, HD30B, 16, 16, None),
              ("qwen3_30b_a3b", L30B, NKV30B, G30B, HD30B, 16, 64, None)]
    for model, L, n_kv, g, hd, b, n_read, pos in shapes:
        q, k, v, ks, vs, p, table = paged_inputs(gen, L, n_kv, g, hd, b, n_read, pos)
        args = [(q, k, v, ks, vs, li, p, table, n_read, PS) for li in range(L)]
        diff = max((old.paged(*a) - cuda_attention.paged_flash_attention(*a)).abs().max().item()
                   for a in args[:: L - 1])
        kv_len = n_read * PS
        pages = table.clamp(min=0).long()
        views = [[dequantize_kv(x[li, pages], s[li, pages], torch.bfloat16)
                  .reshape(b, kv_len, n_kv, hd).transpose(1, 2) for x, s in ((k, ks), (v, vs))]
                 for li in range(L)]
        mask = (torch.arange(kv_len, device="cuda")[None, :] <= p[:, None])[:, None, None, :]
        sq = q.to(torch.bfloat16).transpose(1, 2)
        need = [n_read if int(x) >= SEQ_LEN else min(n_read, int(x) // PS + 1) for x in p.tolist()]
        page_bytes = PS * n_kv * (hd + 4)
        nbytes = L * (2 * sum(need) * page_bytes + 2 * b * n_kv * g * hd * 4 + b * (n_read * 4 + 8))
        flops = L * 4 * g * hd * PS * n_kv * sum(need)
        plan = cuda_attention.paged_plan(PS, hd, g)
        out.append(case(
            f"K5 {model}: {L} layers, b {b}, n_read {n_read} (kv_len {kv_len})"
            + (f", pos {pos}" if pos is not None else ", one parked row"),
            [lambda a=a: old.paged(*a) for a in args],
            [lambda a=a: cuda_attention.paged_flash_attention(*a) for a in args],
            [lambda kk=kk, vv=vv: Fn.scaled_dot_product_attention(sq, kk, vv, attn_mask=mask,
                                                                  enable_gqa=True)
             for kk, vv in views],
            nbytes, flops, diff, split_pages=plan.split_pages, splits=plan.splits(n_read),
            ctas=b * n_kv * -(-g // plan.rows) * plan.splits(n_read),
            library="SDPA on a gathered bf16 view, nearest"))
        del views, k, v
        torch.cuda.empty_cache()
    return out


def k4_cases(old: Old) -> list:
    from ..ops.moe import _grouped_block_rows, _grouped_layout_direct

    gen = torch.Generator(device="cuda").manual_seed(1)
    roles = (("w1", DIM30B, FF30B), ("w3", DIM30B, FF30B), ("w2", FF30B, DIM30B))
    stacks = {}
    for n, i, o in roles:
        q = torch.randint(-2**31, 2**31 - 1, (E30B, i // 8, o), dtype=torch.int32, device="cuda",
                          generator=gen)
        d = (torch.rand((E30B, i // 32, o), device="cuda", generator=gen) * 0.016 + 0.004).half()
        stacks[n] = (q, d)
    rows = CHUNK * K30B
    e_flat = torch.stack([torch.randperm(E30B, device="cuda", generator=gen)[:K30B]
                          for _ in range(CHUNK)]).reshape(rows).to(torch.int32)
    block_r = _grouped_block_rows(rows, E30B)
    dest, be, R_pad = _grouped_layout_direct(e_flat, E30B, block_r)
    xp = torch.zeros((R_pad, DIM30B), dtype=torch.bfloat16, device="cuda")
    xp[dest] = torch.randn((rows, DIM30B), device="cuda", generator=gen).to(torch.bfloat16)
    hp = torch.zeros((R_pad, FF30B), device="cuda")
    hp[dest] = torch.randn((rows, FF30B), device="cuda", generator=gen)
    kin = {"w1": xp, "w3": xp, "w2": hp}
    lw = {n: dequantize_t(QuantTensor(q=stacks[n][0], d=stacks[n][1]), torch.bfloat16)
          for n, _, _ in roles}
    counts = torch.bincount(e_flat.long(), minlength=E30B)
    src = dest[torch.argsort(e_flat, stable=True)]
    lin = {"w1": xp[src], "w3": xp[src], "w2": hp[src].to(torch.bfloat16)}
    offs = torch.cumsum(counts, 0).to(torch.int32)
    hit = int((counts > 0).sum())
    diff = max((old.grouped(kin[n], *stacks[n], be, block_r)
                - cuda_q40.q40_grouped_gemm_bf16(kin[n], *stacks[n], be, block_r)).abs().max().item()
               for n, _, _ in roles)

    def calls(fn, names):
        return [lambda n=n: fn(kin[n], *stacks[n], be, block_r) for n in names]

    def lib(names):
        return [lambda n=n: torch._grouped_mm(lin[n], lw[n], offs=offs) for n in names]

    def nbytes(names):
        return sum(hit * _wbytes(i, o) + rows * i * (2 if n != "w2" else 4) + rows * o * 4
                   for n, i, o in roles if n in names)

    def flops(names):
        return sum(2 * rows * i * o for n, i, o in roles if n in names)

    plan = {n: cuda_q40.grouped_plan(i // 32, o, block_r) for n, i, o in roles}
    out = []
    names = [n for n, _, _ in roles]
    out.append(case(
        f"K4 one 30B-A3B layer: (w1, w3, w2), {rows} rows over {hit} of {E30B} experts, "
        f"block_r {block_r}, R_pad {R_pad}", calls(old.grouped, names),
        calls(cuda_q40.q40_grouped_gemm_bf16, names), lib(names), nbytes(names), flops(names),
        diff, library="torch._grouped_mm"))
    for n, i, o in roles[1:]:  # w1 is w3's shape
        out.append(case(
            f"K4 {n} {i}->{o}, one call", calls(old.grouped, [n]) * 4,
            calls(cuda_q40.q40_grouped_gemm_bf16, [n]) * 4, lib([n]) * 4, nbytes([n]), flops([n]),
            diff, per_call=True, cols=plan[n].cols,
            ctas=plan[n].ctas(o, R_pad // block_r)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path, help="directory of the earlier sources")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_k5_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = timing.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    old = Old(build_old(args.old))
    kernels.build(["paged_attention", "q40_grouped_gemm"])
    rows = k5_cases(old)
    torch.cuda.empty_cache()
    rows += k4_cases(old)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows) + card + "\n")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
