#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (distributed_llama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (a failing phase raises and the script exits non-zero; nothing is
caught):
  1. the card: name, `nvidia-smi` name and power limit, torch and CUDA versions;
  2. build every kernel from csrc/ with nvcc (one process per source, all at
     once) and print how long it took;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it (Llama-3.2-1B widths), with its time
     (CUDA events over CUDA-graph replays), its plain version's time, one
     PyTorch library call's time as a yardstick, and its bound;
  4. a small-input reference: a tiny model through the engine on the card
     and on the CPU (plain versions), logits and greedy tokens compared;
  5. the main path: the CLI's `inference` mode at the full Llama-3.2-1B
     width (synthetic Q40 weights from a seed, written once into build/),
     with every kernel's launch counter set to 0 before and read after;
  6. where a decode token's time goes: torch.profiler over 16 decode steps;
  7. one {"kernels": [...]} line, then the card, then the result line.

It needs a CUDA device and the repository around it: without either it
exits non-zero and prints no result. Bounds use the card's published rates
(NVIDIA's data sheets).
"""

from __future__ import annotations

import contextlib
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


def kernel_checks(torch, rates):
    from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40
    from distributed_llama_tpu_torch.ops.quant import QuantTensor, dequantize_t

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

    def wbytes(in_f, out_f):
        return in_f * out_f // 2 + (in_f // 32) * out_f * 2

    def dq(q, d):  # bf16 dequantized weight for the library yardstick
        return dequantize_t(QuantTensor(q=q, d=d), torch.bfloat16)

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

    lib_w = {n: [dq(stacks[n][0][li], stacks[n][1][li]) for li in range(L)] for n, _, _ in shapes}
    xb = {n: x.reshape(1, -1).to(torch.bfloat16) for n, x in xs.items()}

    def k1_lib():
        for n, _, _ in shapes:
            for li in range(L):
                torch.matmul(xb[n], lib_w[n][li])

    step_bytes = L * sum(wbytes(i, o) + i * 4 + o * 4 for _, i, o in shapes)
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
    wcls_bf16 = dq(*wcls)
    x1b = x1.to(torch.bfloat16)
    results.append(_entry(
        torch, "q40_gemv_q80", "distributed_llama_tpu_torch/csrc/q40_gemv.cu",
        "distributed_llama_tpu/ops/pallas_q40.py:686", errs,
        lambda: cuda_q40.q40_gemv_q80(x1, *wcls),
        lambda: cuda_q40.q40_gemv_q80_plain(x1, *wcls),
        lambda: torch.matmul(x1b, wcls_bf16),
        wbytes(dim, c["vocab_size"]) + dim * 4 + c["vocab_size"] * 4,
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

    lib_w = {n: [dq(stacks[n][0][li], stacks[n][1][li]) for li in range(L)] for n, _, _ in shapes}
    xpb = {n: x.reshape(PREFILL_ROWS, -1).to(torch.bfloat16) for n, x in xp.items()}

    def k2_lib():
        for n, _, _ in shapes:
            for li in range(L):
                torch.matmul(xpb[n], lib_w[n][li])

    chunk_bytes = L * sum(wbytes(i, o) + PREFILL_ROWS * (i + o) * 4 for _, i, o in shapes)
    chunk_flops = L * sum(2 * PREFILL_ROWS * i * o for _, i, o in shapes)
    results.append(_entry(
        torch, "q40_gemm_bf16_stacked", "distributed_llama_tpu_torch/csrc/q40_gemm.cu",
        "distributed_llama_tpu/ops/pallas_q40.py:253", errs,
        k2_all, k2_plain, k2_lib, chunk_bytes, chunk_flops, bw, bf16_peak,
        "one prefill chunk: 16 layers x (wqkv, wo, w13, w2) at 32 rows",
    ))
    del lib_w, stacks

    # -- K3: one 32-token prefill chunk's attention in all 16 layers ---------
    t, pos_start, S = PREFILL_ROWS, 64, 256  # third chunk of a ~100-token prompt
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

    import torch.nn.functional as F

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
    results.append(_entry(
        torch, "flash_attention", "distributed_llama_tpu_torch/csrc/flash_attention.cu",
        "distributed_llama_tpu/ops/pallas_attention.py:199", errs,
        k3_all, k3_plain, k3_lib, att_bytes, att_flops, bw, bf16_peak,
        "one prefill chunk: 16 layers, t=32 at pos 64 over a 256-row cache view",
    ))
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
# phase 4: a small input on the card against the CPU
# ---------------------------------------------------------------------------


def small_reference(torch, tmp: Path):
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
    from distributed_llama_tpu_torch.testing import tiny_header, write_tiny_model

    h = tiny_header(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                    vocab_size=512, seq_len=512)
    path = str(tmp / "tiny.m")
    write_tiny_model(path, h, seed=1)
    prompt = list(range(1, 39))  # prefill 37 tokens: a 32-row and an 8-row chunk
    out = {}
    for dev in ("cuda", "cpu"):
        eng = InferenceEngine(path, device=dev, decode_chunk_size=16)
        eng.prefill(prompt[:-1])
        logits = torch.from_numpy(eng.decode_one(prompt[-1], len(prompt) - 1))
        eng.reset()
        toks = eng.generate(prompt, 100, sampler=None).tokens[len(prompt):]
        out[dev] = (logits, toks)
        eng.close()
    (lg, tg), (lc, tc) = out["cuda"], out["cpu"]
    assert lg.shape == (1, 512) and torch.isfinite(lg).all()
    err = (lg - lc).abs().max().item()
    # kernel and plain versions round P (flash) and the int8 activations at
    # slightly different points; a wrong kernel moves logits by O(1)
    tol = 2e-2 * lc.abs().max().item()
    same = next((i for i, (a, b) in enumerate(zip(tg, tc)) if a != b), len(tc))
    log(json.dumps({"phase": "small_reference", "logits_max_abs_err": err, "tol": tol,
                    "tokens": len(tc), "leading_tokens_equal": same}))
    assert err <= tol, f"tiny-model logits differ from the CPU by {err} > {tol}"
    assert same >= 8, f"tiny-model greedy tokens diverge from the CPU at step {same}"


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------


def synthetic_model() -> tuple[str, str, float]:
    from distributed_llama_tpu_torch.formats.mfile import MFileReader
    from distributed_llama_tpu_torch.testing import tiny_header, write_tiny_model, write_tiny_tokenizer

    d = BUILD / "models"
    d.mkdir(parents=True, exist_ok=True)
    mp, tp = d / "llama32_1b_synthetic_q40_seed0.m", d / "byte_tokenizer_128256.t"
    t0 = time.perf_counter()
    h = tiny_header(**LLAMA32_1B)
    if not mp.exists():
        tmp = mp.with_name(mp.name + ".tmp")
        write_tiny_model(str(tmp), h, seed=0)
        tmp.replace(mp)
    if not tp.exists():
        tmp = tp.with_name(tp.name + ".tmp")
        write_tiny_tokenizer(str(tmp), pad_to=LLAMA32_1B["vocab_size"])
        tmp.replace(tp)
    with MFileReader(str(mp)) as r:  # the cached file is whole
        assert r.header.dim == 2048 and r.header.vocab_size == 128256
    return str(mp), str(tp), time.perf_counter() - t0


def main_path(torch, counters):
    from distributed_llama_tpu_torch import cli
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    mp, tp, write_s = synthetic_model()
    log(f"synthetic Llama-3.2-1B-width model ready in {write_s:.1f} s (set-up, not timed below)")
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
    print(text[-6000:], flush=True)
    assert rc == 0, f"cli inference exited {rc}"

    def num(section, key):
        m = re.search(section + r"\n(?:.*\n)*?\s*" + key + r":\s*([0-9.]+)", text)
        assert m, f"no {key} under {section} in the CLI output"
        return float(m.group(1))

    n_pred = int(num("Prediction", "nTokens"))
    assert n_pred == DECODE_STEPS, f"decoded {n_pred} tokens, expected {DECODE_STEPS}"
    summary = {
        "phase": "main_path", "prompt_tokens": n_prompt, "decode_tokens": n_pred,
        "load_s": num("Load", "seconds"),
        "prefill_tok_s": num("Evaluation", "tokens/s"),
        "decode_tok_s": num("Prediction", "tokens/s"),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches,
    }
    log(json.dumps(summary))
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was never launched on the main path"
    return launches


def decode_profile(torch, model_path: str, steps: int = 16) -> dict:
    """Where one decode token's time goes: torch.profiler over `steps`
    decode steps of the main path's engine after a 99-token prefill. Host
    wall per token, device busy time per token (kernel time summed from the
    profiler), the device's idle share, and the top device and host ops."""
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
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    by_dev = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0))[:8]
    by_cpu = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
    out = {
        "phase": "decode_profile", "steps": steps,
        "wall_ms_per_token": wall * 1e3 / steps,
        "device_busy_ms_per_token": dev_us / 1e3 / steps,
        "device_idle_share": 1.0 - (dev_us / 1e6) / wall if dev_us else None,
        "top_device_ops_ms_per_token": {
            e.key: getattr(e, "self_device_time_total", 0) / 1e3 / steps for e in by_dev
        },
        "top_host_ops_ms_per_token": {e.key: e.self_cpu_time_total / 1e3 / steps for e in by_cpu},
        "launches_per_token": sum(e.count for e in events if e.key == "cudaLaunchKernel") / steps,
    }
    eng.close()
    log(json.dumps(out))
    return out


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
    rows = kernel_checks(torch, rates)

    # 4. small input against the CPU
    tmp = BUILD / "smoke"
    tmp.mkdir(parents=True, exist_ok=True)
    small_reference(torch, tmp)

    # 5. the main path
    counters = (*cuda_q40.KERNELS, *cuda_attention.KERNELS)
    launches = main_path(torch, counters)

    # 6. where a decode token's time goes
    mp, _, _ = synthetic_model()
    decode_profile(torch, mp)

    # 7. the record
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kern = [{**{k: r[k] for k in keys}, "launches": launches[r["name"]]} for r in rows]
    print(json.dumps({"kernels": kern}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
