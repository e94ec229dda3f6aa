#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (distributed_llama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (a failing phase raises and the script exits non-zero; nothing is
caught):
  1. the card: name, `nvidia-smi` name and power limit, torch and CUDA versions;
  2. build every kernel from csrc/ with nvcc (one process per source, all at
     once) and print how long it took;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it (Llama-3.2-1B and Qwen3-30B-A3B widths),
     with its time (CUDA events over CUDA-graph replays), its plain
     version's time, one PyTorch library call's time as a yardstick, and
     its bound;
  4. small-input references: a tiny Llama and a tiny Qwen3-MoE through the
     engine on the card and on the CPU (plain versions), logits and greedy
     tokens compared;
  5. the main paths: the CLI's `inference` mode at the full Llama-3.2-1B
     width, then at Qwen3-30B-A3B's width (synthetic Q40 weights from a
     seed, written once into build/), each with every kernel's launch
     counter set to 0 just before and read just after;
  6. where a decode token's time goes: torch.profiler over 16 decode steps
     of each model;
  7. one {"kernels": [...]} line, then the card, then the result line.

It needs a CUDA device and the repository around it: without either it
exits non-zero and prints no result. Bounds use the card's published rates
(NVIDIA's data sheets).
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "distributed_llama_tpu_torch"
BUILD = ROOT / "build"

# Llama-3.2-1B's published config (dim, ffn, layers, heads, kv heads,
# head_dim, vocab, rope theta, llama3.1 scaling), as launch.py runs it
LLAMA32_1B = dict(
    dim=2048, hidden_dim=8192, n_layers=16, n_heads=32, n_kv_heads=8, head_dim=64,
    vocab_size=128256, seq_len=131072, rope_theta=500000.0, rope_type=2,
    rope_scaling_factor=32.0, rope_scaling_low_freq_factor=1.0,
    rope_scaling_high_freq_factor=4.0, rope_scaling_orig_max_seq_len=8192,
)
# Qwen3-30B-A3B's published config (Qwen/Qwen3-30B-A3B config.json, as
# launch.py's qwen3_30b_a3b_q40 serves it): dim, intermediate and expert
# widths, layers, heads, kv heads, head_dim (explicit: dim / heads would give
# 64), 128 experts with 8 active, vocab, context, rope theta 1e6 (falcon
# rope, which the header's arch sets), rms eps 1e-6, norm_topk_prob (the
# router always renormalizes). Full depth: nothing is cut.
QWEN3_30B_A3B = dict(
    dim=2048, hidden_dim=6144, moe_hidden_dim=768, n_layers=48, n_heads=32, n_kv_heads=4,
    head_dim=128, n_experts=128, n_active_experts=8, vocab_size=151936, seq_len=40960,
    rope_theta=1000000.0,
)
QWEN3_MOE_ARCH = 0xABCD02  # ArchType.QWEN3_MOE
QWEN3_NORM_EPS = 1e-6
MAX_SEQ_LEN = 4096
PREFILL_ROWS = 32  # the CLI's default --nbatches
DECODE_STEPS = 256
PROMPT = (
    "The quick brown fox jumps over the lazy dog while a small bird sings "
    "in the tall green tree near the old stone bridge."
)

# published dense rates: (bytes/s, bf16 flop/s, int8 op/s)
RATES = {
    "H100 PCIe": (2.0e12, 756e12, 1513e12),
    "H100 NVL": (3.9e12, 835e12, 1671e12),
    "H100": (3.35e12, 989e12, 1979e12),  # SXM
    "H200": (4.8e12, 989e12, 1979e12),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def rates_for(name: str):
    for key, val in RATES.items():
        if key in name:
            return key, val
    raise RuntimeError(f"no published rates for {name!r}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def graph_ms(torch, fn, replays: int = 20) -> float:
    """Median device time of one call of `fn`, from CUDA events around
    replays of a CUDA graph that holds the call (so Python's launch cost is
    not in the number)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    del g
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the main path's shapes
# ---------------------------------------------------------------------------


def random_q40_stack(torch, gen, L, in_f, out_f):
    """Random packed T-layout weights: any int32 word is a valid nibble
    pattern; scales f16 in [0.004, 0.02)."""
    nb = in_f // 32
    q = torch.randint(-2**31, 2**31 - 1, (L, nb * 4, out_f), dtype=torch.int32, device="cuda", generator=gen)
    d = (torch.rand((L, nb, out_f), device="cuda", generator=gen) * 0.016 + 0.004).to(torch.float16)
    return q, d


def compare(torch, name, pairs, rel_tol=None, abs_tol=None):
    """Hold every (kernel, plain) output pair within its tolerance: rel_tol
    times the plain output's largest magnitude, or abs_tol. Returns the max
    abs error, the max error relative to that magnitude, and the loosest
    tolerance applied."""
    err = rel = tol = 0.0
    for got, ref in pairs:
        e = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        t = abs_tol if abs_tol is not None else rel_tol * scale
        assert e <= t, f"{name}: max abs err {e} > {t}"
        err, rel, tol = max(err, e), max(rel, e / scale), max(tol, t)
    torch.cuda.synchronize()
    return err, rel, tol


def _wbytes(in_f, out_f):
    """Bytes of one packed Q40 weight: 4-bit values plus an f16 scale per 32."""
    return in_f * out_f // 2 + (in_f // 32) * out_f * 2


def _dq(torch, q, d):
    """bf16 dequantized weight for a library yardstick."""
    from distributed_llama_tpu_torch.ops.quant import QuantTensor, dequantize_t

    return dequantize_t(QuantTensor(q=q, d=d), torch.bfloat16)


def kernel_checks(torch, rates):
    from distributed_llama_tpu_torch.ops import cuda_q40

    bw, bf16_peak, int8_peak = rates
    c = LLAMA32_1B
    dim, ff, L = c["dim"], c["hidden_dim"], c["n_layers"]
    hd, nh, nkv = c["head_dim"], c["n_heads"], c["n_kv_heads"]
    qkv_out = (nh + 2 * nkv) * hd
    # per-layer matmuls: (name, in, out)
    shapes = [("wqkv", dim, qkv_out), ("wo", nh * hd, dim), ("w13", dim, 2 * ff), ("w2", ff, dim)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    stacks = {n: random_q40_stack(torch, gen, L, i, o) for n, i, o in shapes}
    wcls = random_q40_stack(torch, gen, 1, dim, c["vocab_size"])
    wcls = (wcls[0][0], wcls[1][0])
    results = []

    # -- K1 stacked: one decode token's 64 per-layer matmuls at 1 row --------
    xs = {n: torch.randn((1, 1, i), device="cuda", generator=gen) for n, i, _ in shapes}
    # integer partials are exact; the nb f32 block sums are re-associated:
    # a few ulp of the output scale
    errs = compare(torch, "q40_gemv_q80_stacked", (
        (cuda_q40.q40_gemv_q80_stacked(xs[n], *stacks[n], li),
         cuda_q40.q40_gemv_q80_plain(xs[n], stacks[n][0][li], stacks[n][1][li]))
        for n, _, _ in shapes for li in range(L)
    ), rel_tol=1e-5)

    def k1_all():
        for n, _, _ in shapes:
            for li in range(L):
                cuda_q40.q40_gemv_q80_stacked(xs[n], *stacks[n], li)

    def k1_plain():
        for n, _, _ in shapes:
            for li in range(L):
                cuda_q40.q40_gemv_q80_plain(xs[n], stacks[n][0][li], stacks[n][1][li])

    lib_w = {n: [_dq(torch, stacks[n][0][li], stacks[n][1][li]) for li in range(L)] for n, _, _ in shapes}
    xb = {n: x.reshape(1, -1).to(torch.bfloat16) for n, x in xs.items()}

    def k1_lib():
        for n, _, _ in shapes:
            for li in range(L):
                torch.matmul(xb[n], lib_w[n][li])

    step_bytes = L * sum(_wbytes(i, o) + i * 4 + o * 4 for _, i, o in shapes)
    step_ops = L * sum(2 * i * o for _, i, o in shapes)
    results.append(_entry(
        torch, "q40_gemv_q80_stacked", "distributed_llama_tpu_torch/csrc/q40_gemv.cu",
        "distributed_llama_tpu/ops/pallas_q40.py:725", errs,
        k1_all, k1_plain, k1_lib, step_bytes, step_ops, bw, int8_peak,
        "one decode token: 16 layers x (wqkv, wo, w13, w2) at 1 row",
    ))
    del lib_w

    # -- K1 unstacked: the decode logits (wcls) at 1 row ----------------------
    x1 = torch.randn((1, dim), device="cuda", generator=gen)
    errs = compare(torch, "q40_gemv_q80", [
        (cuda_q40.q40_gemv_q80(x1, *wcls), cuda_q40.q40_gemv_q80_plain(x1, *wcls))
    ], rel_tol=1e-5)
    wcls_bf16 = _dq(torch, *wcls)
    x1b = x1.to(torch.bfloat16)
    results.append(_entry(
        torch, "q40_gemv_q80", "distributed_llama_tpu_torch/csrc/q40_gemv.cu",
        "distributed_llama_tpu/ops/pallas_q40.py:686", errs,
        lambda: cuda_q40.q40_gemv_q80(x1, *wcls),
        lambda: cuda_q40.q40_gemv_q80_plain(x1, *wcls),
        lambda: torch.matmul(x1b, wcls_bf16),
        _wbytes(dim, c["vocab_size"]) + dim * 4 + c["vocab_size"] * 4,
        2 * dim * c["vocab_size"], bw, int8_peak,
        "decode logits: wcls 2048 -> 128256 at 1 row",
    ))
    del wcls_bf16

    # -- K2 stacked: one 32-row prefill chunk's 64 per-layer matmuls ---------
    xp = {n: torch.randn((1, PREFILL_ROWS, i), device="cuda", generator=gen) for n, i, _ in shapes}
    # exact bf16 products, f32 sums in another order (tensor-core
    # accumulation over in <= 8192 terms): 1e-4 of the output scale
    errs = compare(torch, "q40_gemm_bf16_stacked", (
        (cuda_q40.q40_gemm_bf16_stacked(xp[n], *stacks[n], li),
         cuda_q40.q40_gemm_bf16_plain(xp[n], stacks[n][0][li], stacks[n][1][li]))
        for n, _, _ in shapes for li in range(L)
    ), rel_tol=1e-4)

    def k2_all():
        for n, _, _ in shapes:
            for li in range(L):
                cuda_q40.q40_gemm_bf16_stacked(xp[n], *stacks[n], li)

    def k2_plain():
        for n, _, _ in shapes:
            for li in range(L):
                cuda_q40.q40_gemm_bf16_plain(xp[n], stacks[n][0][li], stacks[n][1][li])

    lib_w = {n: [_dq(torch, stacks[n][0][li], stacks[n][1][li]) for li in range(L)] for n, _, _ in shapes}
    xpb = {n: x.reshape(PREFILL_ROWS, -1).to(torch.bfloat16) for n, x in xp.items()}

    def k2_lib():
        for n, _, _ in shapes:
            for li in range(L):
                torch.matmul(xpb[n], lib_w[n][li])

    chunk_bytes = L * sum(_wbytes(i, o) + PREFILL_ROWS * (i + o) * 4 for _, i, o in shapes)
    chunk_flops = L * sum(2 * PREFILL_ROWS * i * o for _, i, o in shapes)
    results.append(_entry(
        torch, "q40_gemm_bf16_stacked", "distributed_llama_tpu_torch/csrc/q40_gemm.cu",
        "distributed_llama_tpu/ops/pallas_q40.py:253", errs,
        k2_all, k2_plain, k2_lib, chunk_bytes, chunk_flops, bw, bf16_peak,
        "one prefill chunk: 16 layers x (wqkv, wo, w13, w2) at 32 rows",
    ))
    del lib_w, stacks

    # -- K3: one 32-token prefill chunk's attention in all 16 layers ---------
    results.append(flash_row(torch, gen, bw, bf16_peak, L, nh, nkv, hd))
    return results


def flash_row(torch, gen, bw, bf16_peak, L, nh, nkv, hd):
    """K3 over one 32-token prefill chunk's attention in all L layers, t=32
    at position 64 (the third chunk of a ~100-token prompt) over the
    256-row cache view the engine's kv bucket gives it."""
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops import cuda_attention

    t, pos_start, S = PREFILL_ROWS, 64, 256
    cache_k = torch.randn((L, 1, MAX_SEQ_LEN, nkv, hd), device="cuda", generator=gen).to(torch.bfloat16)
    cache_v = torch.randn((L, 1, MAX_SEQ_LEN, nkv, hd), device="cuda", generator=gen).to(torch.bfloat16)
    qs = [torch.randn((1, t, nh, hd), device="cuda", generator=gen) for _ in range(L)]
    # P is rounded to bf16 against the running max of each KV tile, and the
    # kernel's tiles (64 rows) are not the plain version's (one 256-row
    # block): a bf16 rounding (2^-8 relative) of the weights of |v| ~ 1 rows
    errs = compare(torch, "flash_attention", (
        (cuda_attention.flash_attention(qs[li], cache_k[li, :, :S], cache_v[li, :, :S], pos_start),
         cuda_attention.flash_attention_plain(qs[li], cache_k[li, :, :S], cache_v[li, :, :S], pos_start))
        for li in range(L)
    ), abs_tol=1e-2)

    def k3_all():
        for li in range(L):
            cuda_attention.flash_attention(qs[li], cache_k[li, :, :S], cache_v[li, :, :S], pos_start)

    def k3_plain():
        for li in range(L):
            cuda_attention.flash_attention_plain(qs[li], cache_k[li, :, :S], cache_v[li, :, :S], pos_start)

    # the library yardstick: SDPA on [b, H, t, hd] with an explicit causal
    # mask from pos_start (is_causal assumes top-left alignment)
    mask = (torch.arange(S, device="cuda")[None, :] <= pos_start + torch.arange(t, device="cuda")[:, None])
    sq = [q.to(torch.bfloat16).transpose(1, 2) for q in qs]
    sk = [cache_k[li, :, :S].transpose(1, 2) for li in range(L)]
    sv = [cache_v[li, :, :S].transpose(1, 2) for li in range(L)]

    def k3_lib():
        for li in range(L):
            F.scaled_dot_product_attention(sq[li], sk[li], sv[li], attn_mask=mask, enable_gqa=True)

    visible = sum(pos_start + i + 1 for i in range(t))  # keys each query needs
    att_bytes = L * (2 * t * nh * hd * 4 + 2 * (pos_start + t) * nkv * hd * 2)
    att_flops = L * 4 * nh * hd * visible
    return _entry(
        torch, "flash_attention", "distributed_llama_tpu_torch/csrc/flash_attention.cu",
        "distributed_llama_tpu/ops/pallas_attention.py:199", errs,
        k3_all, k3_plain, k3_lib, att_bytes, att_flops, bw, bf16_peak,
        f"one prefill chunk: {L} layers, head_dim {hd}, {nh // nkv} query heads per kv head, "
        f"t=32 at pos 64 over a 256-row cache view",
    )


def moe_kernel_checks(torch, rates):
    """Phase 3 at Qwen3-30B-A3B width, on full-size flat [48 * 128] expert
    stacks (5.4 GB a role): K1-indexed over one decode token's 48 layers,
    K4 over one layer's three calls of a 32-token prefill chunk (the last
    layer, folded into the flat index), K3 at head_dim 128 with 8 query
    heads per kv head."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.ops.moe import _grouped_block_rows, _grouped_layout_direct

    bw, bf16_peak, int8_peak = rates
    c = QWEN3_30B_A3B
    dim, ff, L = c["dim"], c["moe_hidden_dim"], c["n_layers"]
    E, k = c["n_experts"], c["n_active_experts"]
    roles = (("w1", dim, ff), ("w3", dim, ff), ("w2", ff, dim))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    stacks = {n: random_q40_stack(torch, gen, L * E, i, o) for n, i, o in roles}
    results = []

    # -- K1-indexed: one decode token's 48 layers x (w1, w3, w2) -------------
    # 8 distinct experts a layer, flat index layer * E + e: the last layers'
    # byte offsets are past 2^31, where a 32-bit offset would wrap
    idx = [(torch.randperm(E, device="cuda", generator=gen)[:k] + li * E).to(torch.int32)
           for li in range(L)]
    xs = [torch.randn((1, dim), device="cuda", generator=gen) for _ in range(L)]
    hs = [torch.randn((k, ff), device="cuda", generator=gen) for _ in range(L)]
    ins = {"w1": xs, "w3": xs, "w2": hs}

    def k1i(fn):
        def run():
            for li in range(L):
                for n, _, _ in roles:
                    fn(ins[n][li], *stacks[n], idx[li])
        return run

    # K1's tolerance: exact integer partials, f32 block sums re-associated
    errs = compare(torch, "q40_gemv_q80_indexed", (
        (cuda_q40.q40_gemv_q80_indexed(ins[n][li], *stacks[n], idx[li]),
         cuda_q40.q40_gemv_q80_indexed_plain(ins[n][li], *stacks[n], idx[li]))
        for li in range(L) for n, _, _ in roles
    ), rel_tol=1e-5)
    # yardstick: torch.matmul against the 8 gathered bf16-dequantized experts
    lib_w = {n: [_dq(torch, stacks[n][0][idx[li].long()], stacks[n][1][idx[li].long()]) for li in range(L)]
             for n, _, _ in roles}
    lib_x = {"w1": [x.to(torch.bfloat16).expand(k, 1, dim) for x in xs],
             "w2": [h.to(torch.bfloat16).unsqueeze(1) for h in hs]}
    lib_x["w3"] = lib_x["w1"]

    def k1i_lib():
        for li in range(L):
            for n, _, _ in roles:
                torch.matmul(lib_x[n][li], lib_w[n][li])

    tok_bytes = L * sum(k * _wbytes(i, o) + (1 if n != "w2" else k) * i * 4 + k * o * 4
                        for n, i, o in roles)
    tok_ops = L * sum(2 * k * i * o for _, i, o in roles)
    results.append(_entry(
        torch, "q40_gemv_q80_indexed", "distributed_llama_tpu_torch/csrc/q40_gemv.cu",
        "distributed_llama_tpu/ops/pallas_q40.py:725", errs,
        k1i(cuda_q40.q40_gemv_q80_indexed), k1i(cuda_q40.q40_gemv_q80_indexed_plain), k1i_lib,
        tok_bytes, tok_ops, bw, int8_peak,
        "one decode token: 48 layers x (w1, w3 shared row, w2 8 rows) x 8 experts, "
        "flat [6144] stacks",
    ))
    del lib_w, lib_x

    # -- K4: one layer's (w1, w3, w2) of a 32-token prefill chunk ------------
    layer = L - 1
    rows = PREFILL_ROWS * k
    e_flat = torch.stack([torch.randperm(E, device="cuda", generator=gen)[:k]
                          for _ in range(PREFILL_ROWS)]).reshape(rows).to(torch.int32)
    block_r = _grouped_block_rows(rows, E)
    dest, block_expert, R_pad = _grouped_layout_direct(e_flat, E, block_r)
    assert (block_r, R_pad) == (8, 1152), (block_r, R_pad)
    be = block_expert + layer * E
    xp = torch.zeros((R_pad, dim), dtype=torch.bfloat16, device="cuda")
    xp[dest] = torch.randn((rows, dim), device="cuda", generator=gen).to(torch.bfloat16)
    hp = torch.zeros((R_pad, ff), device="cuda")
    hp[dest] = torch.randn((rows, ff), device="cuda", generator=gen)
    kin = {"w1": xp, "w3": xp, "w2": hp}

    def k4(fn):
        def run():
            for n, _, _ in roles:
                fn(kin[n], *stacks[n], be, block_r)
        return run

    # K2's tolerance: exact bf16 products, tensor-core f32 sums in another order
    errs = compare(torch, "q40_grouped_gemm_bf16", (
        (cuda_q40.q40_grouped_gemm_bf16(kin[n], *stacks[n], be, block_r),
         cuda_q40.q40_grouped_gemm_bf16_plain(kin[n], *stacks[n], be, block_r))
        for n, _, _ in roles
    ), rel_tol=1e-4)
    # yardstick: one grouped matmul over this layer's bf16-dequantized
    # experts (1.2 GB for the three roles; all 48 layers would take 58 GB),
    # rows sorted by expert
    sl = slice(layer * E, (layer + 1) * E)
    lw = {n: _dq(torch, stacks[n][0][sl], stacks[n][1][sl]) for n, _, _ in roles}
    counts = torch.bincount(e_flat.long(), minlength=E)
    src = dest[torch.argsort(e_flat, stable=True)]
    lin = {"w1": xp[src], "w2": hp[src].to(torch.bfloat16)}
    lin["w3"] = lin["w1"]
    if hasattr(torch, "_grouped_mm"):
        lib_name = "torch._grouped_mm"
        offs = torch.cumsum(counts, 0).to(torch.int32)

        def k4_lib():
            for n, _, _ in roles:
                torch._grouped_mm(lin[n], lw[n], offs=offs)
    else:
        lib_name = "torch.matmul per expert"
        bounds = [0, *torch.cumsum(counts, 0).tolist()]

        def k4_lib():
            for n, _, _ in roles:
                for e in range(E):
                    if bounds[e + 1] > bounds[e]:
                        torch.matmul(lin[n][bounds[e]:bounds[e + 1]], lw[n][e])

    hit = int((counts > 0).sum())
    chunk_bytes = sum(hit * _wbytes(i, o) + rows * i * (2 if n != "w2" else 4) + rows * o * 4
                      for n, i, o in roles)
    chunk_ops = sum(2 * rows * i * o for _, i, o in roles)
    row = _entry(
        torch, "q40_grouped_gemm_bf16", "distributed_llama_tpu_torch/csrc/q40_grouped_gemm.cu",
        "distributed_llama_tpu/ops/pallas_q40.py:779", errs,
        k4(cuda_q40.q40_grouped_gemm_bf16), k4(cuda_q40.q40_grouped_gemm_bf16_plain), k4_lib,
        chunk_bytes, chunk_ops, bw, bf16_peak,
        f"one layer of a 32-token prefill chunk: (w1, w3, w2), 256 rows over {hit} of 128 "
        f"experts, block_r 8, R_pad 1152, layer 47 folded into the flat index; library: {lib_name}",
    )
    results.append(row)
    del lw, lin, stacks
    torch.cuda.empty_cache()

    # -- K3 at the Qwen3 shape ------------------------------------------------
    results.append(flash_row(torch, gen, bw, bf16_peak, L, c["n_heads"], c["n_kv_heads"],
                             c["head_dim"]))
    torch.cuda.empty_cache()
    return results


def _entry(torch, name, source, replaces, errs, fn, plain, lib, nbytes, nops,
           bw, peak, work):
    err, rel, tol = errs
    ms = graph_ms(torch, fn)
    plain_ms = graph_ms(torch, plain)
    library_ms = graph_ms(torch, lib)
    t_bytes = nbytes / bw * 1e3
    t_ops = nops / peak * 1e3
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "max_abs_err": err, "max_rel_err": rel, "tol": tol, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "ops": nops, "work": work,
    }
    log("kernel " + json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# phase 4: small inputs on the card against the CPU
# ---------------------------------------------------------------------------


def small_reference(torch, tmp: Path, name: str, header_kw: dict, prompt: list[int], kernels):
    """A tiny model through the engine on the card and on the CPU: logits
    after the prompt and 100 greedy tokens compared; every kernel in
    `kernels` must have launched on the card."""
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
    from distributed_llama_tpu_torch.testing import tiny_header, write_tiny_model

    h = tiny_header(**header_kw)
    path = str(tmp / f"{name}.m")
    write_tiny_model(path, h, seed=1)
    before = {k.__name__: k.launches for k in kernels}
    out = {}
    for dev in ("cuda", "cpu"):
        eng = InferenceEngine(path, device=dev, decode_chunk_size=16)
        eng.prefill(prompt[:-1])
        logits = torch.from_numpy(eng.decode_one(prompt[-1], len(prompt) - 1))
        eng.reset()
        toks = eng.generate(prompt, 100, sampler=None).tokens[len(prompt):]
        out[dev] = (logits, toks)
        eng.close()
    launched = {k.__name__: k.launches - before[k.__name__] for k in kernels}
    (lg, tg), (lc, tc) = out["cuda"], out["cpu"]
    assert lg.shape == (1, h.vocab_size) and torch.isfinite(lg).all()
    err = (lg - lc).abs().max().item()
    # kernel and plain versions round P (flash) and the int8 activations at
    # slightly different points; a wrong kernel moves logits by O(1)
    tol = 2e-2 * lc.abs().max().item()
    same = next((i for i, (a, b) in enumerate(zip(tg, tc)) if a != b), len(tc))
    log(json.dumps({"phase": "small_reference", "model": name, "logits_max_abs_err": err,
                    "tol": tol, "tokens": len(tc), "leading_tokens_equal": same,
                    "launches_on_card": launched}))
    assert err <= tol, f"{name}: tiny-model logits differ from the CPU by {err} > {tol}"
    assert same >= 8, f"{name}: tiny-model greedy tokens diverge from the CPU at step {same}"
    for k, n in launched.items():
        assert n > 0, f"{name}: kernel {k} never launched on the card"


# ---------------------------------------------------------------------------
# phase 5: the main paths at full width
# ---------------------------------------------------------------------------


def synthetic_model(stem: str, header_kw: dict, norm_epsilon: float | None = None):
    """The model file (random Q40 block bytes from seed 0, written fast by
    testing.write_random_q40_model) and a byte tokenizer padded to its
    vocab, written once into build/models. Returns (model path, tokenizer
    path, write seconds, file bytes)."""
    from distributed_llama_tpu_torch.formats.mfile import MFileReader
    from distributed_llama_tpu_torch.testing import (
        tiny_header, write_random_q40_model, write_tiny_tokenizer,
    )

    d = BUILD / "models"
    d.mkdir(parents=True, exist_ok=True)
    vocab = header_kw["vocab_size"]
    mp, tp = d / f"{stem}_random_q40_seed0.m", d / f"byte_tokenizer_{vocab}.t"
    t0 = time.perf_counter()
    h = tiny_header(**header_kw)
    if norm_epsilon is not None:
        h.norm_epsilon = norm_epsilon
    if not mp.exists():
        tmp = mp.with_name(mp.name + ".tmp")
        write_random_q40_model(str(tmp), h, seed=0)
        tmp.replace(mp)
    if not tp.exists():
        tmp = tp.with_name(tp.name + ".tmp")
        write_tiny_tokenizer(str(tmp), pad_to=vocab)
        tmp.replace(tp)
    with MFileReader(str(mp)) as r:  # the cached file is whole
        assert (r.header.dim, r.header.n_layers, r.header.vocab_size) == (
            header_kw["dim"], header_kw["n_layers"], vocab)
    return str(mp), str(tp), time.perf_counter() - t0, mp.stat().st_size


def main_path(torch, name: str, mp: str, tp: str, n_layers: int, counters, expected):
    """The CLI's inference mode on one model: 256 greedy decode steps after
    the prompt, every counter set to 0 just before and read just after;
    each kernel in `expected` must have launched."""
    from distributed_llama_tpu_torch import cli
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    n_prompt = len(Tokenizer(tp).encode(PROMPT))
    # decode runs positions n_prompt - 1 .. steps - 1 (the reference's maxPos)
    steps = n_prompt - 1 + DECODE_STEPS
    argv = ["inference", "--model", mp, "--tokenizer", tp, "--prompt", PROMPT,
            "--steps", str(steps), "--max-seq-len", str(MAX_SEQ_LEN),
            "--temperature", "0", "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counters:
        k.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    text = buf.getvalue()
    print(text[-4000:], flush=True)
    assert rc == 0, f"cli inference exited {rc}"

    def num(section, key):
        m = re.search(section + r"\n(?:.*\n)*?\s*" + key + r":\s*([0-9.]+)", text)
        assert m, f"no {key} under {section} in the CLI output"
        return float(m.group(1))

    n_pred = int(num("Prediction", "nTokens"))
    assert n_pred == DECODE_STEPS, f"decoded {n_pred} tokens, expected {DECODE_STEPS}"
    summary = {
        "phase": "main_path", "model": name, "n_layers": n_layers,
        "prompt_tokens": n_prompt, "decode_tokens": n_pred,
        "load_s": num("Load", "seconds"),
        "prefill_tok_s": num("Evaluation", "tokens/s"),
        "decode_tok_s": num("Prediction", "tokens/s"),
        "ttft_ms": num("Timing", "ttftMs"),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches,
    }
    log(json.dumps(summary))
    for k in expected:
        assert launches[k.__name__] > 0, f"kernel {k.__name__} was never launched on {name}'s main path"
    return launches


def decode_profile(torch, name: str, model_path: str, steps: int = 16) -> dict:
    """Where one decode token's time goes: torch.profiler over `steps`
    decode steps of the main path's engine after a 99-token prefill. Host
    wall per token; device busy time per token, summed over the device's
    own events (kernels, copies) only: an aten op's device time is its
    kernels' again; the device's idle share; kernels and host-side launch
    calls per token; the top kernels and host ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distributed_llama_tpu_torch.runtime.decode import decode_chunk
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine(model_path, max_seq_len=MAX_SEQ_LEN, device="cuda")
    prompt = [(7 * i) % 1000 + 1 for i in range(100)]
    eng.prefill(prompt[:-1])
    tok = torch.tensor([prompt[-1]], device="cuda")
    pos = len(prompt) - 1

    def run(at):
        return decode_chunk(eng.cfg, eng.params, eng.rope, eng.cache, tok, at, n_steps=steps,
                            kv_len=eng._kv_bucket(at + steps))

    run(pos)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(pos + steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    assert on_dev, "the profiler recorded no device events"
    dev_us = sum(e.self_device_time_total for e in on_dev)
    by_dev = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:10]
    by_cpu = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
    out = {
        "phase": "decode_profile", "model": name, "steps": steps,
        "wall_ms_per_token": wall * 1e3 / steps,
        "device_busy_ms_per_token": dev_us / 1e3 / steps,
        "device_idle_share": 1.0 - (dev_us / 1e6) / wall,
        "kernels_per_token": sum(e.count for e in on_dev) / steps,
        "launch_calls_per_token": sum(
            e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel")) / steps,
        "top_kernels_ms_per_token": {e.key[:100]: e.self_device_time_total / 1e3 / steps
                                     for e in by_dev},
        "top_host_ops_ms_per_token": {e.key: e.self_cpu_time_total / 1e3 / steps for e in by_cpu},
    }
    eng.close()
    del eng
    log(json.dumps(out))
    return out


def release(torch) -> None:
    """Drop what a finished phase left on the card."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG} not found next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    rate_key, rates = rates_for(kind)
    log(f"card: {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| bounds from the {rate_key} data sheet: {rates[0] / 1e12} TB/s, "
        f"{rates[1] / 1e12} bf16 TFLOP/s, {rates[2] / 1e12} int8 TOP/s")

    # 2. build
    t0 = time.perf_counter()
    logs = kernels.build(ptxas_verbose=True)
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        log(f"--- nvcc {name}.cu\n{text.strip()}")
    log(f"kernels built in {secs:.1f} s ({len(logs)} compiled, one nvcc each, in parallel)")

    # 3. kernels against their plain versions
    rows = {r["name"]: r for r in kernel_checks(torch, rates)}
    release(torch)
    rows.update({r["name"]: r for r in moe_kernel_checks(torch, rates)})  # K3 at hd 128
    release(torch)

    # 4. small inputs against the CPU
    tmp = BUILD / "smoke"
    tmp.mkdir(parents=True, exist_ok=True)
    q = cuda_q40
    dense = (q.q40_gemv_q80_stacked, q.q40_gemv_q80, q.q40_gemm_bf16_stacked,
             cuda_attention.flash_attention)
    small_reference(torch, tmp, "tiny_llama", dict(
        dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512,
        seq_len=512), list(range(1, 39)), dense)  # prefill 37: a 32-row and an 8-row chunk
    # E = 16, k = 2: prefill 35 is a 32-row chunk (grouped arm, K4) and a
    # 4-row tail (gather arm); decode t = 1 takes the indexed arm (K1-indexed)
    small_reference(torch, tmp, "tiny_qwen3_moe", dict(
        arch=QWEN3_MOE_ARCH, dim=256, hidden_dim=256, moe_hidden_dim=256, n_layers=2,
        n_heads=4, n_kv_heads=2, head_dim=64, n_experts=16, n_active_experts=2,
        vocab_size=512, seq_len=512), list(range(1, 37)),
        (q.q40_gemv_q80_indexed, q.q40_grouped_gemm_bf16))
    release(torch)

    # 5-6. the main paths, each followed by its decode profile
    counters = (*cuda_q40.KERNELS, *cuda_attention.KERNELS)
    mp, tp, write_s, size = synthetic_model("llama32_1b", LLAMA32_1B)
    log(f"synthetic Llama-3.2-1B-width model: {size} bytes, ready in {write_s:.1f} s "
        f"(set-up, not timed below)")
    dense_launches = main_path(torch, "llama32_1b", mp, tp, LLAMA32_1B["n_layers"], counters, dense)
    release(torch)
    decode_profile(torch, "llama32_1b", mp)
    release(torch)
    Path(mp).unlink()  # room on the disk for the MoE file

    moe_kw = dict(QWEN3_30B_A3B, arch=QWEN3_MOE_ARCH)
    mp, tp, write_s, size = synthetic_model("qwen3_30b_a3b", moe_kw, norm_epsilon=QWEN3_NORM_EPS)
    log(f"synthetic Qwen3-30B-A3B-width model: {size} bytes, {QWEN3_30B_A3B['n_layers']} layers "
        f"(full depth, no cut), ready in {write_s:.1f} s (set-up, not timed below)")
    moe_launches = main_path(torch, "qwen3_30b_a3b", mp, tp, QWEN3_30B_A3B["n_layers"],
                             counters, counters)
    release(torch)
    decode_profile(torch, "qwen3_30b_a3b", mp)
    release(torch)

    # 7. the record: one row a kernel; launches from the Qwen3-30B-A3B main
    # path (all six run there), the Llama-3.2-1B path's beside them
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kern = [{**{k: r[k] for k in keys}, "launches": moe_launches[name],
             "launches_dense": dense_launches[name]} for name, r in rows.items()]
    print(json.dumps({"kernels": kern}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
