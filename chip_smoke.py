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
     its bound; K1 at 1..8 rows at both models' widths bit for bit equal to
     its blocked order (q40_gemv_q80_blocked at gemv_plan) and each row to
     its 1-row call, K1-indexed's slots likewise; K2 also per call at each 1B shape at 16 and 32 rows beside
     torch.matmul, K3 also at long context (t 32 at position 6000 over an
     8192-row view, hd 64) beside SDPA; B8 (the shard-local flash
     partial) on 4096-row shards of
     a 16384-row cache at col_offset 0, 4096 (a straddling chunk) and
     8192 (fully masked: exact), and the four-shard combine against K3
     over the whole cache, at the 1B and 30B-A3B attention shapes; at the
     shapes a speculative verify round gives them at 1B width, each
     against its plain version with its time, library call and bound: K2
     on the four layer shapes and B5 on the wcls at 9, 80 and 144 rows,
     K5 at t = 5 and 9 queries a row, batch 1 and 16, per-row positions;
  3b. the kernel probes (B9, P3, P4, P14): each kernel or instance
     against its plain version at every probe shape (Llama-3.2-1B layer
     shapes and the full wcls 2048 -> 128256): P3's two arms and P4's
     three (the one-row GEMV, each at its plan) at 1..8 rows bit for bit
     equal to their plain order, P4 to P3 at P4's plan, within 1e-5 of B9,
     and P14's checksums; then
     the probes' entry points (probes/int4.py and probes/dma.py main) with
     their launch counters set to 0 just before and read just after: cold
     (operands out of L2) and hot times, the streaming ceiling per shape;
  3c. the decode-attention floor probes and the first K1's body: P11 (pure
     read, bit for bit its plain order), P12 (grouped decode attention,
     hd 64 and 128, g 4 and 8), P8 (K3
     on a head-major cache) and P7 (the first K1's GEMV body at every tile,
     and its Q80 prologue alone) against their plain versions at the probe
     shapes, K1 on the same rows bit for bit equal to its blocked order;
     then the probes' entry points
     (probes/attention.py and probes/int4_prod.py main), counted as the
     path "decode floor probes";
  3d. the scale-plane and tile sweeps and the f16-bits convert: P1 (raw
     f16 bits -> f32) on the 1B wcls plane bit for bit, P13 at B9's tile
     equal to B9 with each plane, P2 (the one-row GEMV) at 1..8 rows equal
     to its plain version bit for bit, its two planes equal and within
     1e-5 of P13 at the old P2 tile, and P6 at P3's and P4's plans equal
     to their bf16 arms;
     then the sweeps' entry points (probes/scales.py
     and probes/i4_tiles.py main), counted as the path "scale and tile
     sweeps", whose rows are held: P1 on every bit pattern bit for bit, P13
     at every tile of the JAX sweep's eight 1B and 8B shapes with its f16,
     f32 and i16 planes bit for bit equal, P2 within its tolerance of the
     plain version, and P6 at every tile of its five shapes bit for bit
     equal to its plain version;
  3e. the unsigned-nibble codecs (one-row GEMVs of csrc/i8_gemv.cuh): P5
     (split-half bytes, both storages) and P9/P10 (the T layout's
     feature-split words, both views) at every tile and both planes (f16,
     raw f16 bits) of the JAX probes' five 1B shapes, at 1 and 3 rows, bit
     for bit equal to their plain order and within 1e-5 of B9; at each
     codec's default plan each of 8 rows equal to its one-row call; at P3's
     plan equal to P3's int8 arm; then the probes' entry points
     (probes/int4b.py and probes/int4c.py main, with B9 and the first K1's
     body beside them on the same weights), counted as the path "nibble
     codec probes", whose rows are held;
  4. small-input references: a tiny Llama and a tiny Qwen3-MoE through the
     engine on the card and on the CPU (plain versions), logits and greedy
     tokens compared; a tiny Llama's paged int8 BatchSession at batch 4,
     card against CPU; the q80 parity mode (f32, `q80_activations=True`)
     on a tiny Llama and a tiny Qwen3-MoE, card against CPU: 48 greedy
     tokens equal, first logits within Q80_TOL;
  5. the main paths, each with every kernel's launch counter set to 0 just
     before it and read just after (synthetic Q40 weights from a seed,
     written once into build/). At the full Llama-3.2-1B width: the CLI's
     `inference` (contiguous, then at its paged bf16 default), `perplexity`
     at its defaults (paged bf16; equal to the contiguous run's to 1e-3),
     `inference --kv-dtype int8` (paged), a BatchSession at batch 16 (paged
     int8, rolling release and re-admission; rows against their runs with
     the other rows parked),
     `generate_batch` at batch 4 (paged int8; rows against solo runs) and
     the sequence-parallel engine on an sp = 4 mesh of this one card (a
     16384-row cache in four 4096-row shards): the 113-token prompt's
     prefill logits bit for bit equal to the sp = 1 engine's, then a
     4400-token prompt and 16 greedy steps with B8 launched chunks x
     layers x shards times and K3 never, logits and tokens against sp = 1,
     and profiles of its prefill tail (B8's share) and decode. At
     Qwen3-30B-A3B's width: the CLI's `inference` (contiguous). The CLI
     runs its default ngram speculation (greedy decode in verify rounds),
     which is off at 30B-A3B, whose rounds would take the MoE gather arm,
     and builds the grammar arena, so every decode step and round carries
     the grammar mask (at the all-legal FREE state);
     the contiguous `inference` of each model runs again with
     `--speculative off`, the tokens equal. Each `inference` run's step
     report (`StepStats.report`, printed after the Timing block as the JAX
     CLI prints it) holds prefill[...] entries counting its Eval lines and
     decode[...] / spec_verify[...] entries counting its Pred lines (one a
     chunk or a round). Decode on these paths
     replays CUDA graphs of the decode step and the verify round
     (runtime/graphs.py) except on the sp mesh, and the launch counters
     count each replay's kernels;
  5b. graphed decode against eager decode on one engine (`cuda_graphs`
     off, then on): from a 200-token context 64 greedy steps in chunks of
     32 across the 256 kv bucket and a seeded sampled chunk of each
     sampling arm (top-p 0.9 and 1.0), tokens and every chunk's last
     logits bit for bit equal, at Llama-3.2-1B width batch 1 contiguous,
     paged bf16 and paged int8, and the batch-16 paged int8 BatchSession
     (16 chunks, four rows re-admitted, then four sampled at each arm); at
     Qwen3-30B-A3B width batch 1 contiguous, the same trace. Then `warmup()` (its seconds, captures and graph-pool
     bytes) and a pinned trace, a prompt decoding across the 256 and 512
     kv buckets and (batch 16) a BatchSession admit/step/release cycle,
     which must make 0 captures after warmup;
  5f. observability (runtime/telemetry.py, runtime/tracing.py), run after
     5b and counted as one path, at Llama-3.2-1B width: a batch-1
     contiguous engine with a 64 MB prefix cache and ngram at k 4, after
     `warmup()`: a greedy generate that hits the cache and speculates,
     untraced and traced, the same tokens, kernel launches and graph
     replays, the spans in the JAX engine's order, as many spans as the
     StepStats series gained; the guard's enter plus exit in µs (mean of
     10,000, one `guard_cost` line); a stall: 0.5 s of device spin
     (`torch.cuda._sleep`) before a graphed decode chunk with
     DLT_STALL_LOG_MS 100 and DLT_STALL_TIMEOUT_MS 300 for that call,
     one `[EXEC_STALL]` log and the hard-timeout line, StallError once the
     fetch returns, a flight record with the request's decode_chunk span
     and watchdog_stall, both counters up by one, then after `reset()` the
     tokens of before and 0 recaptures; on phase 5b's batch-16 paged int8
     engine a session with one traced row, untraced and traced alike;
  5c. the prefix cache at Llama-3.2-1B width, counted as one path: a
     1,024-token shared head with 64-token tails, batch 1 on the
     contiguous, paged bf16 and paged int8 layouts, an engine with a 512
     MB cache against one with the cache off: the hit prompt's prefill
     timed cold and hit with its launches (the hit resumes at 1,024), its
     first logits and 64 graphed greedy tokens bit for bit equal; a
     24-token head (boundary 16, below one chunk) within
     PREFIX_SUBCHUNK_TOL; on paged int8 a 45 MB pool where reclaim must
     evict, then `warmup()` and hits with 0 captures after it; and a
     batch-16 paged int8 BatchSession after `warmup()` whose 8
     admissions share the head (7 hits), rows and last logits equal to
     the same admissions with the cache off;
  5d. speculative decoding, counted as one path: at Llama-3.2-1B width,
     batch 1 on the contiguous, paged bf16 and paged int8 layouts, 256
     greedy steps from PROMPT without speculation and with ngram at k 4
     and k 8 on one engine: k 4's tokens equal, k 8's equal, or parted
     (the first divergence and its margin reported) where the chains with
     and without speculation are equal once decode takes the verify
     rounds' arms (`verify_arms`), with `arm_growth`: how far the two
     arms' teacher-forced logits stray along the chain up to the
     divergence; each arm once more in turns for tok/s
     with rounds, acceptance, verify ms, draft and fetch µs a round; a
     verify round at k 4 and 8 graphed equal to eager bit for bit and
     within SPEC_VERIFY_TOL of the stepwise logits; the batch-16 paged
     int8 session's `spec_step` rounds against its `step` chunks,
     `warmup()` at k 8 and a pinned spec trace with 0 captures after it;
     `generate_batch` at batch 4 with and without speculation; at
     Qwen3-30B-A3B width, on phase 5b's engine, the gather arm's verify
     round graphed, its pool bytes, tok/s against off; torch.profiler over
     64 tokens of the 1B contiguous decode with and without speculation
     in turns (one `spec_ab` line);
  5e. grammar-constrained decoding (runtime/grammar.py), counted as one
     path: at Llama-3.2-1B width, engines with the grammar arena (65
     states of 128256 tokens, 33.3 MB on the card), batch 1 on the
     contiguous, paged bf16 and paged int8 layouts: greedy `generate`
     under a boolean JSON object and `(?:yes|no)`, eagerly, graphed and
     with ngram at k 4 (on the contiguous layout also a repeat grammar
     whose drafts verify under the mask): 0 illegal tokens, finished and a
     full match, graphed equal to eager bit for bit, k 4 equal to off; a
     batch-16 paged int8 BatchSession of 8 constrained rows (three
     grammars, two rows sampled) beside 8 free rows, a `spec_step` round
     and 8 `step`s, the free rows bit for bit those of the same rows alone
     on an engine without the arena; `warmup()`, then installs that evict
     from the arena and constrained work: 0 captures after warmup, the
     table's storage fixed, each install's upload timed; the arena's cost,
     engines with and without it in turns (graphed batch-1 decode and a
     batch-16 chunk under torch.profiler, verify rounds at batch 1 t 5 and
     batch 16 t 9); at Qwen3-30B-A3B width, on phase 5b's engine (built
     with the arena, as the CLI builds it), one constrained greedy
     generate of 64 tokens, 0 illegal tokens, counted as its own path;
  5g. the OpenAI-compatible server (server/api.py), at Llama-3.2-1B width
     after 5e, three servers started through `serve()` on 127.0.0.1, each
     its own path: (a) batch 1 at the CLI's defaults (paged bf16, ngram,
     the prefix cache, the grammar arena), (b) `--batch 8 --kv-dtype
     int8`, (c) the same with `--speculative off`. Chat requests of 32
     greedy tokens from threads, each prompt alone first (TTFT and decode
     tok/s from the server's `ttft_ms` / `tpot_ms` histograms); at batch 8
     the eight prompts at once, seeded sampled (each row equal to its run
     alone) and greedy (aggregate tok/s); at (a) and (b) a non-stream and
     an SSE request at once, two sharing a system prompt (a prefix-cache
     hit), a JSON-schema `response_format` reply that parses, `/health`,
     `/stats`, `/metrics` (the TTFT histogram, StepStats series) and the
     `/debug/*` views, a request's trace, and one forced engine failure:
     a 500, the supervisor's close-and-rebuild (its seconds), the tokens
     of before, the card's memory back within one graph pool; 0 captures
     after warmup; then each greedy response against `engine.generate` on
     the server's engine, exactly at (a) and (c) (at (b) a greedy token's
     arm, verify round or decode step, follows the co-tenants' drafts:
     where a row parts is reported); K1-stacked, K1 and K2 launched, K5 at
     batch 8;
  5h. the KV movement layer and the device views, at Llama-3.2-1B width
     after 5g, through `serve()` on 127.0.0.1, one counted path: (a) a
     server `--batch 4 --speculative off --prefix-cache-mb 12` with host
     and disk tiers of one 256-token entry's size, three system prompts
     that evict each other (demotions, a spill to disk), then a disk and a
     host promotion, each equal to its cold run and `engine.generate`, the
     promotion walls and hit counters; (c) on the same server
     `/debug/costs` (full coverage of the JAX engine's ladder, the decode
     FLOPs a token within 1.0-1.5 of the analytic 2 x matmul params),
     `/metrics` (`dlt_mfu`, `dlt_bw_utilization`, the duty cycle in [0,
     1]; `dlt_hbm_bytes{component=...}`, the modeled weights and KV 0.6-1.0
     of the bytes the allocator reserved since the server started: the
     ledger measures the whole process, earlier phases' leftovers
     included) and `/debug/profile?ms=200` during a burst of
     four (a concurrent capture gets 409; the trace holds the Batcher's
     kernels or graph launches); then a forced failure whose rebuild
     captures while this thread keeps the tier's drain copying: 0
     recaptures, `hbm_drift_events` 0, the promoted tokens of before; (b)
     a prefill worker and a decode worker (`--batch 4 --speculative off`)
     in the process: the decode worker's tokens equal (a)'s on the device
     path and on the HTTP path, a growing prefix skips the pages it holds,
     a device-path fault degrades with equal tokens; each path's transfer
     wall and bytes (JAX's bench bar, device 3x faster, reported);
  5i. the shard loop (tensor, pipeline, data and expert parallelism):
     each kernel of the mesh path at the shapes its shards give it
     (Llama-3.2-1B at tp 2 and 4, Qwen3-30B-A3B at ep 2 x tp 2) against its
     plain version, timed beside its bound and a library call
     (`kernel_shard` lines, `shard_shapes` in the kernels line); then at
     1B width, after the sp path, library engines on meshes of this card
     named once a shard (distinct cards where there are as many): pp 2
     equal to the single device bit for bit (PROMPT's prefill logits every
     chunk, 32 greedy tokens, contiguous and paged bf16), tp 2 and pp 2 x
     tp 2 within the bf16 bound with the chains' parting step reported,
     generate_batch at batch 4 on dp 2 x tp 2 and a paged BatchSession at
     batch 4 on pp 2 x tp 2 row for row equal to each row alone, each
     chunk's collectives equal to their budget, a profiled decode window
     of pp 2 x tp 2; and at the end, at Qwen3-30B-A3B's full width and
     depth, ep 2 x tp 2 within the bound against phase 5b's engine (which
     closes first), with K4 and K1-indexed on the local expert stacks.
     Each mesh path is counted;
  6. where a token's time goes: torch.profiler over 8 batch-1 decode
     steps of each model (contiguous) and of the 1B on the paged int8
     layout (K5's share; 16 steps until phase 5d came), over one
     batch-16 paged int8 chunk (K5's share)
     and over a 128-token Qwen3-30B-A3B prefill (K4's share); each decode
     window eagerly and graphed in turns on one engine, reported as wall,
     busy and idle, kernel and `cudaGraphLaunch` calls a token and tok/s;
     the 1B contiguous window also sampled at temperature 0.8, top-p 0.9
     (the top-p arm; `--profiles` also at 1.0, the full distribution);
  7. one {"kernels": [...]} line, then the card, then the result line.

`python3 chip_smoke.py --profiles llama32_1b|qwen3_30b_a3b [--models DIR]`
runs phases 1-2 and only that model's phase-6 windows (the paged int8
decode and batch-16 chunk, or the prefill), each decode window graphed
and eager, and at 1B width `guarded_paths_ab` (the decode and
speculation loops, profiled, and the k 4 verify ms): run from the root of
two trees in one call, it compares them end to end. `--spec-divergence` runs phases 1-2 and only phase 5d's
paged int8 batch-1 chains without speculation and at k 8, with
`arm_growth` where they part. `--grammar` runs phases 1-2 and only phase
5e at Llama-3.2-1B width, `--server` only phase 5g, `--kv` only phase 5h,
`--mesh` only phase 5i;
`--guarded-paths [--models DIR]` only
`guarded_paths_ab`, for many short runs of two trees in turns, and with
`--guard-share` also `guard_share`: the loops with and without their
watchdog guards in one process.

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
import sys
import time
from functools import partial
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
# the depth of the 30B-A3B file the main paths and phase 5i run (16 of its
# 48 layers, cut to keep the script inside its time limit); the kernel
# checks keep the full model's shapes
MOE_PATH_LAYERS = 16
QWEN3_NORM_EPS = 1e-6
MAX_SEQ_LEN = 4096
PREFILL_ROWS = 32  # the CLI's default --nbatches
DECODE_STEPS = 256
# the 30B-A3B CLI runs (at the default speculation its verify rounds take
# the MoE gather arm, ~258 ms a round: PERF.md)
MOE_CLI_DECODE_STEPS = 128
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
# published f32 rates outside the tensor cores (flop/s), for P4's f32 dot
FP32_PEAK = {"H100 PCIe": 51e12, "H100 NVL": 60e12, "H100": 67e12, "H200": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def rates_for(name: str):
    for key, val in RATES.items():
        if key in name:
            return key, val
    raise RuntimeError(f"no published rates for {name!r}")


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
    k1_gates(torch, gen, [(i, o, stacks[n]) for n, i, o in shapes] + [(dim, c["vocab_size"], wcls)])

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
    results[-1]["per_shape"] = k2_shape_times(torch, gen, shapes, stacks, lib_w, L, bw, bf16_peak)
    del lib_w, stacks

    # -- K3: one 32-token prefill chunk's attention in all 16 layers ---------
    results.append(flash_row(torch, gen, bw, bf16_peak, L, nh, nkv, hd))

    # -- B5 (K2 on the unstacked wcls): perplexity's and batch > 8 logits ---
    results.append(b5_row(torch, gen, wcls, dim, c["vocab_size"], bw, bf16_peak))
    return results


def k1_gates(torch, gen, weights):
    """K1 at 1..8 rows on each (in, out, (q, d)) of `weights` (a stack's
    layer 1 or an unstacked weight), and on 1-layer stacks at the
    Qwen3-30B-A3B widths: each row's 1-row call equal to
    q40_gemv_q80_blocked at gemv_plan bit for bit, and rows 0..R-1 of an
    R-row call equal to the rows' 1-row calls bit for bit."""
    from distributed_llama_tpu_torch.ops import cuda_q40

    c = QWEN3_30B_A3B
    qkv = (c["n_heads"] + 2 * c["n_kv_heads"]) * c["head_dim"]
    weights = list(weights)
    for i, o in ((c["dim"], qkv), (c["n_heads"] * c["head_dim"], c["dim"]),
                 (c["dim"], c["vocab_size"])):
        q, d = random_q40_stack(torch, gen, 1, i, o)
        weights.append((i, o, (q[0], d[0])))
    for i, o, (q, d) in weights:
        if q.ndim == 3:
            q, d = q[1], d[1]
        plan = cuda_q40.gemv_plan(i // 32, o)
        x = torch.randn((8, i), device="cuda", generator=gen)
        solo = [cuda_q40.q40_gemv_q80(x[r:r + 1], q, d) for r in range(8)]
        for r in range(8):
            want = cuda_q40.q40_gemv_q80_blocked(x[r:r + 1], q, d, plan)
            assert torch.equal(solo[r], want), f"K1 {i}->{o} row {r}: not its blocked order"
        for rows in range(2, 9):
            got = cuda_q40.q40_gemv_q80(x[:rows], q, d)
            assert torch.equal(got, torch.cat(solo[:rows])), f"K1 {i}->{o}: {rows} rows differ"
    torch.cuda.synchronize()
    log(json.dumps({"kernel_extra": "q40_gemv_q80", "gates": "rows 1-8 bit-equal to the "
                    "blocked order and to 1-row calls", "shapes": [(i, o) for i, o, _ in weights]}))


def k2_shape_times(torch, gen, shapes, stacks, lib_w, L, bw, bf16_peak):
    """K2 per call at each of the four 1B shapes at 16 and 32 rows: ms a
    call over the L layers' weights in one graph, torch.matmul's on the
    bf16-dequantized weights the same way, and the bound of one call.
    Logged once; returns {shape: {rows: times}}."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.probes import timing

    out = {}
    for n, i, o in shapes:
        plan = cuda_q40.gemm_plan(i // 32, o)
        out[n] = {"in": i, "out": o, "plan": plan.__dict__}
        for rows in (16, 32):
            x = torch.randn((rows, i), device="cuda", generator=gen)
            xb = x.to(torch.bfloat16)
            t_bytes = (_wbytes(i, o) + rows * (i + o) * 4) / bw * 1e3
            t_ops = 2 * rows * i * o / bf16_peak * 1e3
            out[n][rows] = {
                "ms": timing.graph_ms([partial(cuda_q40.q40_gemm_bf16_stacked, x, *stacks[n], li)
                                       for li in range(L)]),
                "library_ms": timing.graph_ms([partial(torch.matmul, xb, lib_w[n][li])
                                               for li in range(L)]),
                "bound_ms": max(t_bytes, t_ops), "ctas": plan.ctas(o, rows),
            }
    log(json.dumps({"kernel_extra": "q40_gemm_bf16_stacked", "per_shape": out}))
    return out


def b5_row(torch, gen, wcls, dim, vocab, bw, bf16_peak):
    """B5: the wcls 2048 -> 128256 at 16 rows (a batch-16 decode step's
    logits) and 32 rows (a 32-token perplexity chunk); the row records the
    16-row call."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.probes import timing

    xs = {r: torch.randn((r, dim), device="cuda", generator=gen) for r in (16, 32)}
    # K2's tolerance: exact bf16 products, tensor-core f32 sums in another order
    errs = compare(torch, "q40_gemm_bf16", (
        (cuda_q40.q40_gemm_bf16(x, *wcls), cuda_q40.q40_gemm_bf16_plain(x, *wcls))
        for x in xs.values()
    ), rel_tol=1e-4)
    w_bf16 = _dq(torch, *wcls)
    x16, xb = xs[16], xs[16].to(torch.bfloat16)
    rows = 16
    row = _entry(
        torch, "q40_gemm_bf16", "distributed_llama_tpu_torch/csrc/q40_gemm.cu",
        "distributed_llama_tpu/ops/pallas_q40.py:880", errs,
        lambda: cuda_q40.q40_gemm_bf16(x16, *wcls),
        lambda: cuda_q40.q40_gemm_bf16_plain(x16, *wcls),
        lambda: torch.matmul(xb, w_bf16),
        _wbytes(dim, vocab) + rows * (dim + vocab) * 4, 2 * rows * dim * vocab, bw, bf16_peak,
        f"logits of a batch-16 decode step: wcls {dim} -> {vocab} at 16 rows "
        f"(32 rows checked too); library: torch.matmul on the bf16-dequantized wcls",
    )
    row["ms_32_rows"] = timing.graph_ms([lambda: cuda_q40.q40_gemm_bf16(xs[32], *wcls)])
    log(json.dumps({"kernel_extra": "q40_gemm_bf16", "ms_32_rows": row["ms_32_rows"]}))
    return row


def paged_case(torch, gen, L, n_kv, g, hd, b, n_read, ps=16, t=1):
    """Inputs for K5 at one shape: an int8 pool of L layers with b * n_read
    mapped pages plus spare ones, each row's table a random permutation of
    pool pages with its unmapped tail at -1, row 1 parked where b > 1
    (pos_base = seq_len, every entry read) and the live rows at random
    positions in the last two pages of their view, with room for t
    queries."""
    kv_len = n_read * ps
    P = b * n_read + 8
    k = torch.randint(-127, 128, (L, P, ps, n_kv, hd), dtype=torch.int8, device="cuda", generator=gen)
    v = torch.randint(-127, 128, (L, P, ps, n_kv, hd), dtype=torch.int8, device="cuda", generator=gen)
    ks = torch.rand((L, P, ps, n_kv), device="cuda", generator=gen) * 0.02 + 1e-3
    vs = torch.rand((L, P, ps, n_kv), device="cuda", generator=gen) * 0.02 + 1e-3
    table = torch.randperm(P, device="cuda", generator=gen)[: b * n_read].reshape(b, n_read)
    table = table.to(torch.int32).contiguous()
    pos = torch.randint(kv_len - 2 * ps, kv_len - t + 1, (b,), device="cuda", generator=gen)
    if b > 1:
        pos[1] = MAX_SEQ_LEN  # parked at seq_len
    for r in range(2, b, 5):  # rows whose last pages are unmapped, causally dead
        dead = (int(pos[r]) + t - 1) // ps + 1
        table[r, dead:] = -1
    # f32, as the main path's q leaves rope (the residual stream is f32)
    q = torch.randn((b, t, n_kv * g, hd), device="cuda", generator=gen)
    return q, k, v, ks, vs, pos.contiguous(), table, kv_len


def paged_rows(torch, rates):
    """K5 against its plain version at the two models' widths, b = 16, page
    16, n_read 16 (kv_len 256) and 64 (kv_len 1024); times over all layers
    of one decode step. Returns the 1B row at n_read 16 (the batch-16
    session's bucket) for the kernels line; the other cases are logged."""
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops import cuda_attention as ca
    from distributed_llama_tpu_torch.ops.kv_quant import dequantize_kv

    bw, bf16_peak, _ = rates
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    shapes = (("llama32_1b", LLAMA32_1B["n_layers"], 8, 4, 64),
              ("qwen3_30b_a3b", QWEN3_30B_A3B["n_layers"], 4, 8, 128))
    b, ps = 16, 16
    chosen = None
    for model, L, n_kv, g, hd in shapes:
        for n_read in (16, 64):
            q, k, v, ks, vs, pos, table, kv_len = paged_case(torch, gen, L, n_kv, g, hd, b, n_read)
            # f32 sums in another order over <= 1024 keys: 1e-4 of the scale
            errs = compare(torch, f"paged_flash_attention {model} n_read {n_read}", (
                (ca.paged_flash_attention(q, k, v, ks, vs, li, pos, table, n_read, ps),
                 ca.paged_flash_attention_plain(q, k, v, ks, vs, li, pos, table, n_read, ps))
                for li in (0, L - 1)
            ), rel_tol=1e-4)

            def run(fn):
                def go():
                    for li in range(L):
                        fn(q, k, v, ks, vs, li, pos, table, n_read, ps)
                return go

            # nearest library call, not the same function: SDPA over a
            # pre-gathered, pre-dequantized bf16 view with a per-row mask
            pages = table.clamp(min=0).long()
            views = []
            for li in range(L):
                kv_ = [dequantize_kv(x[li, pages], s[li, pages], torch.bfloat16)
                       .reshape(b, kv_len, n_kv, hd).transpose(1, 2) for x, s in ((k, ks), (v, vs))]
                views.append(kv_)
            mask = (torch.arange(kv_len, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
            sq = q.to(torch.bfloat16).transpose(1, 2)

            def lib():
                for kk, vv in views:
                    F.scaled_dot_product_attention(sq, kk, vv, attn_mask=mask, enable_gqa=True)

            # bytes the causal limit needs: a live row reads pages 0..pos // ps,
            # the parked row all n_read; int8 payload + f32 scale per vector
            need = [n_read if int(p) >= MAX_SEQ_LEN else min(n_read, int(p) // ps + 1) for p in pos.tolist()]
            page_bytes = ps * n_kv * (hd + 4)
            nbytes = L * (2 * sum(need) * page_bytes + 2 * b * n_kv * g * hd * 4 + b * (n_read * 4 + 8))
            nops = L * 4 * g * hd * ps * n_kv * sum(need)
            row = _entry(
                torch, "paged_flash_attention", "distributed_llama_tpu_torch/csrc/paged_attention.cu",
                "distributed_llama_tpu/ops/pallas_attention.py:313", errs,
                run(ca.paged_flash_attention), run(ca.paged_flash_attention_plain), lib,
                nbytes, nops, bw, bf16_peak,
                f"one batch-16 decode step's attention over {L} layers at {model} width "
                f"(head_dim {hd}, {g} query heads per kv head), page 16, n_read {n_read} "
                f"(kv_len {kv_len}), one parked row; library: SDPA on a pre-gathered "
                f"dequantized bf16 view, nearest call, not the same function",
            )
            if chosen is None:
                chosen = row
            del views, k, v, ks, vs
            torch.cuda.empty_cache()
    return chosen


# the row counts a verify round gives K2 and B5 at 1B width: batch 1 at k 8
# (t 9), batch 16 at k 4 (t 5) and at k 8
VERIFY_ROWS = (9, 80, 144)
# the verify feed's tokens a row: k 4 and 8
VERIFY_T = (5, 9)


def verify_gemm_rows(torch, rates) -> dict:
    """K2 on the four 1B layer shapes and B5 on the 1B wcls at VERIFY_ROWS,
    each held to its plain version (K2's tolerance: 1e-4 of the output
    scale) on layers 0 and 15, timed a call (K2 over the 16 layers' weights
    in one graph), beside torch.matmul on the bf16-dequantized weights and
    the bound of one call. Logged; returns {kernel: {shape: {rows:
    record}}}."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.probes import timing

    bw, bf16_peak, _ = rates
    c = LLAMA32_1B
    dim, ff, L = c["dim"], c["hidden_dim"], c["n_layers"]
    qkv_out = (c["n_heads"] + 2 * c["n_kv_heads"]) * c["head_dim"]
    shapes = [("wqkv", dim, qkv_out), ("wo", c["n_heads"] * c["head_dim"], dim),
              ("w13", dim, 2 * ff), ("w2", ff, dim)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)

    def record(name, calls, pairs, lib, plain, i, o, rows):
        """`calls`, `lib`, `plain`: lists of one call each, timed a call;
        `pairs`: (kernel, plain) outputs held to K2's tolerance."""
        errs = compare(torch, f"{name} {i}->{o} at {rows} rows", pairs, rel_tol=1e-4)
        t_bytes = (_wbytes(i, o) + rows * (i + o) * 4) / bw * 1e3
        t_ops = 2 * rows * i * o / bf16_peak * 1e3
        return {"ms": timing.graph_ms(calls), "plain_ms": timing.graph_ms(plain),
                "library_ms": timing.graph_ms(lib), "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "max_abs_err": errs[0], "max_rel_err": errs[1]}

    out = {"q40_gemm_bf16_stacked": {}, "q40_gemm_bf16": {}}
    for n, i, o in shapes:
        q, d = random_q40_stack(torch, gen, L, i, o)
        lib_w = [_dq(torch, q[li], d[li]) for li in range(L)]
        out["q40_gemm_bf16_stacked"][n] = {"in": i, "out": o}
        for rows in VERIFY_ROWS:
            x = torch.randn((rows, i), device="cuda", generator=gen)
            xb = x.to(torch.bfloat16)
            rec = record(
                "q40_gemm_bf16_stacked",
                [partial(cuda_q40.q40_gemm_bf16_stacked, x, q, d, li) for li in range(L)],
                [(cuda_q40.q40_gemm_bf16_stacked(x, q, d, li),
                  cuda_q40.q40_gemm_bf16_plain(x, q[li], d[li])) for li in (0, L - 1)],
                [partial(torch.matmul, xb, lib_w[li]) for li in range(L)],
                [partial(cuda_q40.q40_gemm_bf16_plain, x, q[0], d[0])], i, o, rows)
            out["q40_gemm_bf16_stacked"][n][rows] = rec
        del q, d, lib_w
    wq, wd = random_q40_stack(torch, gen, 1, dim, c["vocab_size"])
    wq, wd = wq[0], wd[0]
    w_bf16 = _dq(torch, wq, wd)
    for rows in VERIFY_ROWS:
        x = torch.randn((rows, dim), device="cuda", generator=gen)
        xb = x.to(torch.bfloat16)
        out["q40_gemm_bf16"][rows] = record(
            "q40_gemm_bf16", [partial(cuda_q40.q40_gemm_bf16, x, wq, wd)],
            [(cuda_q40.q40_gemm_bf16(x, wq, wd), cuda_q40.q40_gemm_bf16_plain(x, wq, wd))],
            [partial(torch.matmul, xb, w_bf16)],
            [partial(cuda_q40.q40_gemm_bf16_plain, x, wq, wd)], dim, c["vocab_size"], rows)
    for name, rec in out.items():
        log(json.dumps({"kernel_extra": name, "verify_rows": rec}))
    del w_bf16
    torch.cuda.empty_cache()
    return out


def verify_paged_rows(torch, rates) -> dict:
    """K5 at the verify feed's t = 5 and 9 queries a row (20 and 36 folded
    rows at 1B's g = 4), per-row positions, at 1B width over the 16 layers
    of one round: batch 1 at n_read 16 (kv_len 256), batch 16 at n_read 16
    with one row parked. Held to its plain version (1e-4 of the scale),
    timed, beside SDPA on a pre-gathered dequantized bf16 view with the
    per-query causal mask (nearest call, not the same function) and the
    bound. Logged; returns {f"b{b}_t{t}": record}."""
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops import cuda_attention as ca
    from distributed_llama_tpu_torch.ops.kv_quant import dequantize_kv
    from distributed_llama_tpu_torch.probes import timing

    bw, bf16_peak, _ = rates
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    L, n_kv, g, hd = LLAMA32_1B["n_layers"], 8, 4, 64
    ps, n_read = 16, 16
    out = {}
    for b in (1, 16):
        for t in VERIFY_T:
            q, k, v, ks, vs, pos, table, kv_len = paged_case(torch, gen, L, n_kv, g, hd, b,
                                                             n_read, t=t)
            errs = compare(torch, f"paged_flash_attention b {b} t {t}", (
                (ca.paged_flash_attention(q, k, v, ks, vs, li, pos, table, n_read, ps),
                 ca.paged_flash_attention_plain(q, k, v, ks, vs, li, pos, table, n_read, ps))
                for li in (0, L - 1)), rel_tol=1e-4)

            def calls(fn):
                return [partial(fn, q, k, v, ks, vs, li, pos, table, n_read, ps)
                        for li in range(L)]

            pages = table.clamp(min=0).long()
            views = [[dequantize_kv(x[li, pages], s[li, pages], torch.bfloat16)
                      .reshape(b, kv_len, n_kv, hd).transpose(1, 2) for x, s in ((k, ks), (v, vs))]
                     for li in range(L)]
            qpos = pos[:, None] + torch.arange(t, device="cuda")[None, :]
            mask = (torch.arange(kv_len, device="cuda")[None, None, :] <= qpos[:, :, None])[:, None]
            sq = q.to(torch.bfloat16).transpose(1, 2)
            lib = [partial(F.scaled_dot_product_attention, sq, kk, vv, attn_mask=mask,
                           enable_gqa=True) for kk, vv in views]
            need = [n_read if int(p) >= MAX_SEQ_LEN else min(n_read, (int(p) + t - 1) // ps + 1)
                    for p in pos.tolist()]
            page_bytes = ps * n_kv * (hd + 4)
            nbytes = L * (2 * sum(need) * page_bytes + 2 * b * t * n_kv * g * hd * 4
                          + b * (n_read * 4 + 8))
            nops = L * 4 * g * hd * ps * n_kv * t * sum(need)
            t_bytes, t_ops = nbytes / bw * 1e3, nops / bf16_peak * 1e3
            out[f"b{b}_t{t}"] = {
                "ms": timing.graph_ms(calls(ca.paged_flash_attention)),
                "plain_ms": timing.graph_ms(calls(ca.paged_flash_attention_plain)),
                "library_ms": timing.graph_ms(lib), "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "max_abs_err": errs[0], "max_rel_err": errs[1], "layers": L,
            }
            del views, k, v, ks, vs
            torch.cuda.empty_cache()
    log(json.dumps({"kernel_extra": "paged_flash_attention", "verify_shapes": out}))
    return out


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
    # cold: the L layers' q and 256-row K/V views as compact copies, timed
    # over a >= 200 MB ring of them (the chunk's operands fit the L2)
    from distributed_llama_tpu_torch.probes import timing

    q_all = torch.stack(qs)
    k_all, v_all = cache_k[:, :, :S].contiguous(), cache_v[:, :, :S].contiguous()

    def k3_layers(q_all, k_all, v_all):
        for li in range(L):
            cuda_attention.flash_attention(q_all[li], k_all[li], v_all[li], pos_start)

    cold = timing.cold_ms(k3_layers, (q_all, k_all, v_all),
                          sum(a.numel() * a.element_size() for a in (q_all, k_all, v_all)))
    del q_all, k_all, v_all
    row = _entry(
        torch, "flash_attention", "distributed_llama_tpu_torch/csrc/flash_attention.cu",
        "distributed_llama_tpu/ops/pallas_attention.py:199", errs,
        k3_all, k3_plain, k3_lib, att_bytes, att_flops, bw, bf16_peak,
        f"one prefill chunk: {L} layers, head_dim {hd}, {nh // nkv} query heads per kv head, "
        f"t=32 at pos 64 over a 256-row cache view; ms L2-warm, cold_ms from a ring of "
        f"compact copies", cold_ms=cold,
    )
    if hd == 64:
        row["long"] = flash_long(torch, gen, bw, bf16_peak, nh, nkv, hd)
    return row


FLASH_LONG = (32, 6000, 8192)  # t, pos, view rows


def flash_long(torch, gen, bw, bf16_peak, nh, nkv, hd):
    """K3 at long context: a 32-token chunk at position 6000 over an
    8192-row view of a stacked cache (the sp = 1 prefill tail's shape),
    against its plain version (K3's 1e-2), timed beside SDPA with the
    causal mask and its bound. Logged once."""
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops import cuda_attention
    from distributed_llama_tpu_torch.probes import timing

    t, pos, S = FLASH_LONG
    cache = torch.randn((2, 1, S + 256, nkv, hd), device="cuda", generator=gen).to(torch.bfloat16)
    k, v = cache[0, :, :S], cache[1, :, :S]
    q = torch.randn((1, t, nh, hd), device="cuda", generator=gen)
    err = (cuda_attention.flash_attention(q, k, v, pos)
           - cuda_attention.flash_attention_plain(q, k, v, pos)).abs().max().item()
    assert err <= 1e-2, f"K3 at pos {pos}: max abs err {err}"
    mask = torch.arange(S, device="cuda")[None, :] <= pos + torch.arange(t, device="cuda")[:, None]
    sq, sk, sv = q.to(torch.bfloat16).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    visible = sum(pos + i + 1 for i in range(t))
    t_bytes = (2 * t * nh * hd * 4 + 2 * (pos + t) * nkv * hd * 2) / bw * 1e3
    t_ops = 4 * nh * hd * visible / bf16_peak * 1e3
    row = {"t": t, "pos": pos, "S": S, "max_abs_err": err,
           "splits": cuda_attention.plan_for(q, k, pos).splits,
           "ms": timing.graph_ms([partial(cuda_attention.flash_attention, q, k, v, pos)] * 16),
           "library_ms": timing.graph_ms([partial(F.scaled_dot_product_attention, sq, sk, sv,
                                                  attn_mask=mask, enable_gqa=True)] * 16),
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(json.dumps({"kernel_extra": "flash_attention", "hd": hd, "long": row}))
    return row


SP = 4  # the sp path's shards
SP_SEQ_LEN = 16384  # its cache: four shards of 4096 rows
# (6000 and 64 until phase 5g came, 5000 and 32 until phase 5i came: cut
# to keep the script's time; 4400 still prefills through shard 0 into
# shard 1)
SP_PROMPT_TOKENS = 4400
SP_DECODE_STEPS = 16


# B8's normalized output o / l (and the shards' combine) against its plain
# version (and K3), as a share of the reference's largest value: P rounds
# to bf16 (2^-9 relative) against each tile's running max, and the kernel's
# 64-row tiles are not the plain version's 1024-row blocks. The kernel
# read 2.0e-3 (head_dim 64) and 1.4e-3 (head_dim 128) of it at the sp
# path's shape on an H100. A P.V that skipped one of a 4096-row shard's 64
# tiles would drop 1/64 of the keys, about an eighth of a typical output
# value: several times this bound. Never above the absolute 1e-2 it
# replaced (rows that see a few keys have outputs above 2).
B8_OUT_REL_TOL = 5e-3


def b8_bound(scale: float) -> float:
    """B8's output bound for a reference whose largest value is `scale`."""
    return min(1e-2, B8_OUT_REL_TOL * scale)


def b8_check(torch, got, want):
    """B8 against its plain version: rows that see no column of the shard
    exactly (o = 0, l = 0, the JAX kernel's m); rows that do with m to the
    f32 order of the score dots (1e-5 of its scale), l to the f32
    rescalings at other tile boundaries (1e-4 relative) and o / l, the
    shard's normalized output, within `b8_bound` of its largest value.
    Returns (normalized output error, the same relative to the output's
    largest value, that error's bound, m error, l relative error, rows
    seeing the shard)."""
    (o, m, l), (po, pm, pl) = got, want
    seen = pl > 0
    assert torch.equal(seen, l > 0), "B8: the rows that see the shard differ"
    blind = ~seen
    assert torch.equal(m[blind], pm[blind]), "B8: a blind row's m differs"
    assert (o[blind] == 0).all() and (l[blind] == 0).all(), "B8: a blind row is not zero"
    if not seen.any():
        return 0.0, 0.0, 0.0, 0.0, 0.0, 0
    e_m = (m[seen] - pm[seen]).abs().max().item()
    e_l = ((l[seen] - pl[seen]).abs() / pl[seen]).max().item()
    ref = po[seen] / pl[seen][:, None]
    e_o = (o[seen] / l[seen][:, None] - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert e_m <= 1e-5 * pm[seen].abs().max().item(), f"B8: m err {e_m}"
    assert e_l <= 1e-4, f"B8: l rel err {e_l}"
    assert e_o <= b8_bound(scale), f"B8: normalized output err {e_o} of {scale}"
    return e_o, e_o / scale, b8_bound(scale), e_m, e_l, int(seen.sum().item())


def partial_row(torch, gen, bw, bf16_peak, nh, nkv, hd):
    """B8 at the sp path's shape: one 32-token chunk at position 4080 (it
    straddles the shard 0/1 boundary) against 4096-row shards of a
    16384-row cache. Checked at col_offset 0 (the whole shard visible),
    4096 (the straddle: the first 16 tokens see none of it) and 8192 (the
    shard wholly in the chunk's future: exact), and the four-shard combine
    against K3 over the whole cache. Timed at col_offset 0, the live shard
    that costs most."""
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops import attention as ops_attention
    from distributed_llama_tpu_torch.ops import cuda_attention
    from distributed_llama_tpu_torch.probes import timing

    t, S, pos = PREFILL_ROWS, SP_SEQ_LEN // SP, SP_SEQ_LEN // SP - 16
    k = torch.randn((1, SP_SEQ_LEN, nkv, hd), device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn((1, SP_SEQ_LEN, nkv, hd), device="cuda", generator=gen).to(torch.bfloat16)
    q = torch.randn((1, t, nh, hd), device="cuda", generator=gen)
    ks = [k[:, i * S : (i + 1) * S] for i in range(SP)]
    vs = [v[:, i * S : (i + 1) * S] for i in range(SP)]
    checks = {}
    for col in (0, S, 2 * S):
        shard = col // S
        got = cuda_attention.flash_attention_partial(q, ks[shard], vs[shard], pos, col)
        want = cuda_attention.flash_attention_partial_plain(q, ks[shard], vs[shard], pos, col)
        e_o, e_rel, tol, e_m, e_l, seen = b8_check(torch, got, want)
        checks[col] = {"out_err": e_o, "out_rel_err": e_rel, "out_tol": tol, "m_err": e_m,
                       "l_rel_err": e_l, "rows_seeing": seen, "rows": got[1].numel()}
    assert checks[2 * S]["rows_seeing"] == 0
    # the combine against K3 over the whole cache: equal up to the bf16
    # rounding of P against other running maxima (`b8_bound` of K3's
    # largest value)
    combine_err = {}
    for p in (pos, 6000, SP_SEQ_LEN - t):
        sp_out = ops_attention.flash_attention_sp(q, ks, vs, p, [i * S for i in range(SP)])
        k3_out = cuda_attention.flash_attention(q, k, v, p)
        combine_err[p] = (sp_out - k3_out).abs().max().item()
        bound = b8_bound(k3_out.abs().max().item())
        assert combine_err[p] <= bound, f"B8 combine vs K3 at pos {p}: {combine_err[p]} > {bound}"
    torch.cuda.synchronize()
    worst = max(checks.values(), key=lambda c: c["out_err"])  # col_offset 0
    errs = (worst["out_err"], worst["out_rel_err"], worst["out_tol"])

    def b8(q, k_, v_):
        cuda_attention.flash_attention_partial(q, k_, v_, pos, 0)

    kc, vc = ks[0].contiguous(), vs[0].contiguous()
    nbytes = sum(a.numel() * a.element_size() for a in (q, kc, vc))
    cold, hot = timing.cold_hot_ms(b8, (q, kc, vc), nbytes)
    plain_ms = timing.graph_ms([lambda: cuda_attention.flash_attention_partial_plain(q, kc, vc, pos, 0)])
    # the other two shards of the path's straddling chunk, hot
    other_ms = {col: timing.graph_ms([partial(cuda_attention.flash_attention_partial, q, ks[col // S],
                                              vs[col // S], pos, col)] * 64)
                for col in (S, 2 * S)}
    # nearest library call, not the same function: SDPA normalizes and
    # returns no (m, l); on the shard with its causal mask
    mask = (torch.arange(S, device="cuda")[None, :] <= pos + torch.arange(t, device="cuda")[:, None])
    sq, sk, sv = q.to(torch.bfloat16).transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    lib_ms = timing.graph_ms([lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                                                     enable_gqa=True)])
    visible = sum(min(S, pos + i + 1) for i in range(t))  # keys each query sees in the shard
    rows_kv = min(S, pos + t)
    nbytes = t * nh * hd * 4 + 2 * rows_kv * nkv * hd * 2 + t * nh * hd * 4 + 2 * t * nh * 4
    row = _row(
        "flash_attention_partial", "distributed_llama_tpu_torch/csrc/flash_attention.cu",
        "distributed_llama_tpu/ops/pallas_attention.py:398", errs,
        {"ms": hot, "hot_ms": hot, "cold_ms": cold, "plain_ms": plain_ms, "library_ms": lib_ms},
        nbytes, 4 * nh * hd * visible, bw, bf16_peak,
        f"one shard of a 32-token chunk at pos {pos}: {S}-row shard at col_offset 0 (all "
        f"visible), head_dim {hd}, {nh // nkv} query heads per kv head; ms hot, cold_ms from "
        f"a ring of copies; library: SDPA on the shard with its mask (nearest call, not the "
        f"same function)",
    )
    row["checks"] = checks
    row["combine_vs_k3_err"] = combine_err
    row["straddle_ms"], row["masked_ms"] = other_ms[S], other_ms[2 * S]
    log(json.dumps({"kernel_extra": "flash_attention_partial", "hd": hd, "checks": checks,
                    "combine_vs_k3_err": combine_err, "straddle_ms": other_ms[S],
                    "masked_ms": other_ms[2 * S]}))
    return row


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
    # bit for bit: the blocked order at gemv_plan, and each slot alone
    for n, i, o in roles:
        plan = cuda_q40.gemv_plan(i // 32, o)
        for li in (0, L - 1):
            got = cuda_q40.q40_gemv_q80_indexed(ins[n][li], *stacks[n], idx[li])
            want = cuda_q40.q40_gemv_q80_indexed_blocked(ins[n][li], *stacks[n], idx[li], plan)
            assert torch.equal(got, want), f"K1-indexed {n} layer {li}: not its blocked order"
            for s in range(k):
                x1 = ins[n][li] if ins[n][li].shape[0] == 1 else ins[n][li][s:s + 1]
                one = cuda_q40.q40_gemv_q80_indexed(x1, *stacks[n], idx[li][s:s + 1])
                assert torch.equal(one[0], got[s]), f"K1-indexed {n} slot {s}: differs alone"
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
           bw, peak, work, **more_times):
    """One kernels-line row, each of the three calls timed by
    probes/timing.graph_ms (CUDA events over CUDA-graph replays), with any
    `more_times` measured by the caller."""
    from distributed_llama_tpu_torch.probes import timing

    times = {"ms": timing.graph_ms([fn]), "plain_ms": timing.graph_ms([plain]),
             "library_ms": timing.graph_ms([lib]), **more_times}
    return _row(name, source, replaces, errs, times, nbytes, nops, bw, peak, work)


def _row(name, source, replaces, errs, times, nbytes, nops, bw, peak, work):
    """One kernels-line row from measured `times` (ms, plain_ms,
    library_ms and any more), with its bound from the card's rates."""
    err, rel, tol = errs
    t_bytes = nbytes / bw * 1e3
    t_ops = nops / peak * 1e3
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "max_abs_err": err, "max_rel_err": rel, "tol": tol, **times,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "ops": nops, "work": work,
    }
    log("kernel " + json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# phase 3b: the kernel probes
# ---------------------------------------------------------------------------

PROBE_SOURCES = {
    "q40_i8_unpacked": ("distributed_llama_tpu_torch/csrc/q40_i8_mma.cu",
                        "distributed_llama_tpu/ops/pallas_q40.py:657"),
    "i4_call_int8": ("distributed_llama_tpu_torch/csrc/i4_gemv_probe.cu",
                     "scripts/probe_int4.py:153"),
    "i4_call_bf16": ("distributed_llama_tpu_torch/csrc/i4_gemv_probe.cu",
                     "scripts/probe_int4.py:153"),
    "i32_call_int8": ("distributed_llama_tpu_torch/csrc/i4_gemv_probe.cu",
                      "scripts/probe_int4.py:219"),
    "i32_call_bf16": ("distributed_llama_tpu_torch/csrc/i4_gemv_probe.cu",
                      "scripts/probe_int4.py:219"),
    "i32_call_f32": ("distributed_llama_tpu_torch/csrc/i4_gemv_probe.cu",
                     "scripts/probe_int4.py:219"),
    "stream_call": ("distributed_llama_tpu_torch/csrc/stream_probe.cu", "scripts/probe_dma.py:40"),
}


def probe_checks(torch):
    """B9 against its plain version at every shape of the int4 probe (at 8
    rows too); P3's two arms (the one-row GEMV at i4_gemv_plan) and P4's
    three (at i32_plan) at 1..8 rows of every shape bit for bit equal to
    their plain order (which holds their max error; exact integer partials
    in every dot type, one plan's order), P4 to P3's int8 instance at P4's
    plan, and within SWEEP_REL_TOL of B9 (the f32 block sums in another
    order); P14
    at every swept tile of every dma probe shape, its out and checksums
    against the plain version's. Returns {kernel name: (max abs err, max
    rel err, tolerance)}."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.probes import dma, gemv, int4

    errs = {}

    def keep(name, e):
        old = errs.get(name, (0.0, 0.0, 0.0))
        errs[name] = tuple(max(a, b) for a, b in zip(old, e))

    b9 = cuda_q40.q40_i8_unpacked
    for label, in_f, out_f in int4.SHAPES:
        for rows in ((1, 8) if out_f == 3072 else (1,)):
            x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, rows, "cuda", seed=11)
            # exact integer partials, f32 block sums in another order
            keep(b9.__name__, compare(torch, f"{b9.__name__} {label} rows {rows}",
                                      [(b9(x8, xs, qt, dt),
                                        cuda_q40.q40_i8_unpacked_plain(x8, xs, qt, dt))],
                                      rel_tol=1e-5))
            del x8, xs, qt, dt
            torch.cuda.empty_cache()
        x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, 8, "cuda", seed=11)
        qt4, qw = int4.pack_s4(qt), int4.pack_i32_t(qt)
        p4_plan = int4.i32_plan(in_f // 32, out_f)
        full = {int4.i4_call_int8: int4.i4_call_plain(x8, xs, qt4, dt),
                int4.i32_call_int8: int4.i32_call_plain(x8, xs, qw, dt)}
        full[int4.i4_call_bf16] = full[int4.i4_call_int8]
        full[int4.i32_call_bf16] = full[int4.i32_call_f32] = full[int4.i32_call_int8]
        for rows in range(1, 9):
            ref = b9(x8[:rows], xs[:rows], qt, dt)
            got = {fn: fn(x8[:rows], xs[:rows], qt4 if fn in (int4.i4_call_int8,
                                                              int4.i4_call_bf16) else qw, dt)
                   for fn in int4.KERNELS}
            for fn, g in got.items():
                name = f"{fn.__name__} {label} rows {rows}"
                want = full[fn][:rows]
                assert torch.equal(g, want), f"{name}: differs from its plain order"
                keep(fn.__name__, compare(torch, name, [(g, want)], rel_tol=SWEEP_REL_TOL))
                compare(torch, f"{name} vs B9", [(g, ref)], rel_tol=SWEEP_REL_TOL)
            # exact partials: P3's int8 instance at P4's plan gives P4's bits
            p3_at = gemv.launch_i4_gemv(x8[:rows], xs[:rows], qt4, gemv.W_S4, gemv.DOTS["int8"],
                                        dt, p4_plan)
            assert torch.equal(got[int4.i32_call_int8], p3_at), \
                f"P4 {label} rows {rows}: differs from P3 at P4's plan"
        del x8, xs, qt, qt4, qw, dt, full, ref, got, p3_at
        torch.cuda.empty_cache()
    for label, in_f, out_f in dma.SHAPES:
        bias, qp = dma.make_plane(in_f, out_f, "cuda", seed=12)
        for tn, tk in dma.tiles_for(in_f, out_f):
            out, chk = dma.stream_call(bias, qp, tn, tk)
            p_out, p_chk = dma.stream_call_plain(bias, qp, tn, tk)
            # an exact 64-bit corner sum rounded once: 1e-6 relative is the
            # stated tolerance, equality the expectation
            keep("stream_call", compare(torch, f"stream_call {label} {tn}x{tk}",
                                        [(out, p_out)], rel_tol=1e-6))
            assert torch.equal(chk, p_chk), f"stream_call {label} {tn}x{tk}: checksums differ"
        del bias, qp
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "probe_checks", "errs": errs}))
    return errs


def probe_rows(torch, rates, rate_key, errs, counters):
    """The probes' entry points, as a user runs them, with every launch
    counter in `counters` set to 0 just before and read just after; B9, P3,
    P4 and P14 must have launched. Returns (launches, one kernels-line row
    a kernel: its numbers at the 1B's full wcls 2048 -> 128256, P14's at
    its best tile there)."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.probes import dma, int4

    bw, bf16_peak, int8_peak = rates
    peaks = {"int8": int8_peak, "bf16": bf16_peak, "f32": FP32_PEAK[rate_key]}
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    i_rows = int4.main(["--device", "cuda"])
    d_rows = dma.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    log(json.dumps({"phase": "kernel_probes", "launches": launches}))
    for r in i_rows + d_rows:
        log("probe_row " + json.dumps(r))
    check_launched(launches, (cuda_q40.q40_i8_unpacked, *int4.KERNELS, *dma.KERNELS),
                   "the kernel probes")
    def row(name, r, nops, peak, work):
        times = {"ms": r["cold_ms"], "hot_ms": r["hot_ms"], "plain_ms": r["plain_ms"],
                 "library_ms": r["library_cold_ms"]}
        return _row(name, *PROBE_SOURCES[name], errs[name], times, r["bytes"], nops, bw, peak,
                    work)

    out = {r["kernel"]: row(r["kernel"], r, r["ops"], peaks[r["dot"]],
                            f"{r['probe']}: wcls 2048 -> 128256 at 1 row, cold; library: "
                            f"torch.matmul on the bf16-dequantized weight")
           for r in i_rows if r["out"] == 128256}
    d = next(r for r in d_rows if r["out"] == 128256)
    out["stream_call"] = row(
        "stream_call", d, 0, int8_peak,
        f"stream the wcls 2048 -> 128256 packed plane at its best tile ({d['tile_n']} x "
        f"{d['tile_knb']} blocks), cold; library: torch.sum over the plane, the nearest "
        f"call, not the same function")
    return launches, out


# ---------------------------------------------------------------------------
# phase 3c: the decode-attention floor probes and K1's body alone
# ---------------------------------------------------------------------------

FLOOR_SOURCES = {
    "pure_read": ("distributed_llama_tpu_torch/csrc/attention_probe.cu",
                  "scripts/probe_att_floor.py:68"),
    "decode_attention": ("distributed_llama_tpu_torch/csrc/attention_probe.cu",
                         "scripts/probe_grouped_decode_att.py:73"),
    "flash_headmajor": ("distributed_llama_tpu_torch/csrc/flash_attention.cu",
                        "scripts/probe_flash_headmajor.py:26"),
    "fs_call_tiles": ("distributed_llama_tpu_torch/csrc/q40_gemv.cu",
                      "scripts/probe_int4_prod.py:49"),
    "q80_prologue": ("distributed_llama_tpu_torch/csrc/q40_gemv.cu",
                     "distributed_llama_tpu/ops/pallas_q40.py:506"),
}
FLOOR_PATH = "decode floor probes"
ATT_REL_TOL = 2.0 ** -6  # P12 and P8 against their plain versions, of the output's largest value


def floor_checks(torch):
    """P11, P12 and P8 at the attention probe's shapes (b 1, h 32, kv 8, hd
    64, S 1024 / 2048 / 32768, pos = S - 10), P11 also at b 4, hd 128, bit
    for bit its plain order and within 1e-6 of the column's sum of
    magnitudes of torch's sum, P12 also at hd 128 and g 8
    and with col0 > 0; P7 at every tile of every int4_prod shape, at 1 and
    8 rows, K1 on the same rows bit-equal to its blocked order, and the
    prologue equal to its plain version. Returns {row name: (max abs err, max rel err,
    tolerance)}."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.probes import attention, int4_prod

    errs = {}

    def keep(name, e):
        old = errs.get(name, (0.0, 0.0, 0.0))
        errs[name] = tuple(max(a, b) for a, b in zip(old, e))

    for S in attention.SEQS:
        q, k, v = attention.make_operands(1, 32, 8, 64, S, "cuda", seed=S)
        got, want = attention.pure_read(k, v), attention.pure_read_plain(k, v)
        # f32 sums of 8 * S bf16 values in another order: 1e-6 of the
        # column's sum of magnitudes
        mag = (k.float().abs().sum(dim=(1, 2)) + v.float().abs().sum(dim=(1, 2))).max().item()
        compare(torch, f"pure_read S {S} vs torch's sum", [(got, want)], abs_tol=1e-6 * mag)
        for bk, kk, vk in ((1, k, v), (4, *attention.make_operands(4, 8, 8, 128, S, "cuda",
                                                                    seed=S + 1)[1:])):
            g = attention.pure_read(kk, vk)
            # the kernel's order repeated by the plain version: bit for bit
            assert torch.equal(g, attention.pure_read_order_plain(kk, vk)), \
                f"pure_read S {S} b {bk}: differs from its plain order"
            keep("pure_read", compare(torch, f"pure_read S {S} b {bk}",
                                      [(g, attention.pure_read_order_plain(kk, vk))], abs_tol=0.0))
        pos = S - 10
        q4 = q.reshape(1, 1, 32, 64)
        # p rounds to bf16 against each tile's (split's, block's) running
        # max and the output to bf16: a few bf16 ulps of the output's
        # largest value, which shrinks as 1/sqrt(S), so held relative to it
        keep("flash_headmajor", compare(torch, f"flash_headmajor S {S}", [
            (attention.flash_headmajor(q4, k, v, pos), attention.flash_headmajor_plain(q4, k, v, pos))
        ], rel_tol=ATT_REL_TOL))
        keep("decode_attention", compare(torch, f"decode_attention S {S}", [
            (attention.decode_attention(q, k, v, pos), attention.decode_attention_plain(q, k, v, pos))
        ], rel_tol=ATT_REL_TOL))
        del q, k, v
    # hd 64 and 128, g 4 and 8 (Qwen3-30B-A3B's attention is h 32, kv 4, hd 128)
    for h, kv, hd, S, pos, col0 in ((32, 4, 64, 2048, 2038, 0), (32, 8, 128, 2048, 1500, 0),
                                    (32, 4, 128, 4096, 4095, 0), (32, 4, 128, 2048, 2500, 1024)):
        q, k, v = attention.make_operands(1, h, kv, hd, S, "cuda", seed=hd + kv)
        keep("decode_attention", compare(torch, f"decode_attention h {h} kv {kv} hd {hd}", [
            (attention.decode_attention(q, k, v, pos, col0),
             attention.decode_attention_plain(q, k, v, pos, col0))
        ], rel_tol=ATT_REL_TOL))
    for label, in_f, out_f in int4_prod.SHAPES:
        for rows in (1, 8):
            x, qp, d = int4_prod.make_operands(in_f, out_f, "cuda", seed=rows, rows=rows)
            x8, xs, bs = int4_prod.q80_prologue(x)
            for got, want in zip((x8, xs, bs), int4_prod.q80_prologue_plain(x)):
                assert torch.equal(got, want), f"q80_prologue {label} rows {rows}: differs"
            keep("q80_prologue", (0.0, 0.0, 0.0))
            k1 = cuda_q40.q40_gemv_q80(x, qp, d)
            blocked = cuda_q40.q40_gemv_q80_blocked(x, qp, d, cuda_q40.gemv_plan(in_f // 32, out_f))
            diff = (k1 - blocked).abs().max().item()
            assert torch.equal(k1, blocked), f"K1 {label}: differs from its blocked order by {diff}"
            want = int4_prod.fs_call_tiles_plain(x8, xs, bs, qp, d, *cuda_q40.FIRST_K1_TILE)
            for cols, ksplit in cuda_q40.GEMV_TILES:
                got = int4_prod.fs_call_tiles(x8, xs, bs, qp, d, cols, ksplit)
                # exact integer partials, f32 block sums in the tile's order
                keep("fs_call_tiles", compare(torch, f"fs_call_tiles {label} {cols}x{ksplit}",
                                              [(got, want)], rel_tol=1e-5))
            del x, qp, d, x8, xs, bs, k1, blocked, want
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "floor_checks", "errs": errs}))
    return errs


def floor_rows(torch, rates, errs, counters):
    """The floor probes' entry points, as a user runs them, with every
    launch counter in `counters` set to 0 just before and read just after;
    P11, P12, P7 (body and prologue), K3 (P8) and K1 must have launched.
    Returns (launches, one kernels-line row a probe: P11 at S 1024, P12 and
    P8 at S 32768, P7 and the prologue at the wcls 2048 -> 32768)."""
    from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40
    from distributed_llama_tpu_torch.probes import attention, int4_prod

    bw, bf16_peak, int8_peak = rates
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    a_rows = attention.main(["--device", "cuda"])
    p_rows = int4_prod.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    log(json.dumps({"phase": "floor_probes", "launches": launches}))
    for r in a_rows + p_rows:
        log("floor_row " + json.dumps(r))
    check_launched(launches, (*attention.KERNELS, *int4_prod.KERNELS,
                              cuda_attention.flash_attention, cuda_q40.q40_gemv_q80), FLOOR_PATH)

    def row(name, r, nops, peak, work, **extra):
        times = {"ms": r["cold_ms"], "hot_ms": r["hot_ms"], "plain_ms": r["plain_ms"],
                 "library_ms": r["library_cold_ms"]}
        return {**_row(name, *FLOOR_SOURCES[name], errs[name], times, r["bytes"], nops, bw,
                       peak, work), **extra}

    def att(name, S):
        return next(r for r in a_rows if r["probe"] == name and r["S"] == S)

    def flops(r):  # QK^T and PV over the visible rows
        return 4 * r["b"] * r["h"] * r["hd"] * min(r["S"], r["pos"] + 1)

    out = {}
    r = att("pure_read", 1024)
    out["pure_read"] = row("pure_read", r, 0, bf16_peak,
                           f"sum K + V, b 1, kv 8, S 1024, hd 64, cold; {r['ctas']} CTAs; "
                           f"library: torch.sum of K and of V, the nearest call, not the same "
                           f"function")
    for name in ("decode_attention", "flash_headmajor"):
        r = att(name, 32768)
        out[name] = row(name, r, flops(r), bf16_peak,
                        f"one layer's decode attention, b 1, h 32, kv 8, hd 64, S 32768 at pos "
                        f"{r['pos']}, cold; {r['ctas']} CTAs; library: SDPA with enable_gqa on the "
                        f"cache cut to pos + 1", **({"counter": "flash_attention", "path": FLOOR_PATH}
                                                    if name == "flash_headmajor" else {}))
    p = next(r for r in p_rows if r["out"] == 32768)
    body = {"cold_ms": p["a_cold_ms"], "hot_ms": p["a_hot_ms"], "plain_ms": p["plain_ms"],
            "library_cold_ms": p["library_cold_ms"], "bytes": p["body"]}
    out["fs_call_tiles"] = row("fs_call_tiles", body, p["ops"], int8_peak,
                               "the first K1's GEMV alone at its tile (32, 8): wcls 2048 -> "
                               "32768 at 1 row, cold; library: torch.matmul on the "
                               "bf16-dequantized plane")
    pro = {"cold_ms": p["c_cold_ms"], "hot_ms": p["c_hot_ms"], "plain_ms": p["prologue_plain_ms"],
           "library_cold_ms": None, "bytes": p["prologue"]}
    out["q80_prologue"] = row("q80_prologue", pro, 0, bf16_peak,
                              "the first K1's Q80 prologue alone on one bf16 row of 2048, cold; "
                              "no library call computes it")
    return launches, out


# ---------------------------------------------------------------------------
# phase 3d: the scale-plane and tile sweeps and the f16-bits convert
# ---------------------------------------------------------------------------

SWEEP_SOURCES = {
    "f16bits_to_f32": ("distributed_llama_tpu_torch/csrc/i8_tile_probe.cu",
                       "scripts/probe_f16_scales.py:48"),
    "scale_plane_call": ("distributed_llama_tpu_torch/csrc/i8_gemv_probe.cu",
                         "scripts/probe_f16_scales.py:118"),
    "i8_tile_call": ("distributed_llama_tpu_torch/csrc/i8_tile_probe.cu",
                     "scripts/sweep_i8_tiles.py:69"),
    "i4_sweep_call": ("distributed_llama_tpu_torch/csrc/i4_gemv_probe.cu",
                      "scripts/sweep_i4_tiles.py:123"),
}
SWEEP_PATH = "scale and tile sweeps"
SWEEP_REL_TOL = 1e-5  # exact integer partials, f32 block sums in the tile's order


def sweep_checks(torch):
    """The identities that the sweeps' mains do not check: P1 bit for bit
    on random bit patterns over the 1B wcls plane [64, 128256]; P13 at 64
    columns and B9's split, each plane, bit for bit equal to B9 at every
    sweep shape (1B and 8B); P2 at 1..8 rows equal to its plain version bit
    for bit, its two planes equal to each other and within SWEEP_REL_TOL of
    P13 at P2_TILE (its int8-MMA design before); P6 at P3's plan and at
    P4's bit for bit equal to P3's and P4's bf16 arms on the same values.
    Every tile against the plain
    version, the three planes' bit identity at every tile and P1 on every
    bit pattern are the mains' rows, held in sweep_rows."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.probes import i4_tiles, int4, scales
    from distributed_llama_tpu_torch.probes.operands import scale_planes

    gen = torch.Generator(device="cuda").manual_seed(1)
    wcls = torch.randint(-32768, 32768, (64, 128256), dtype=torch.int32, device="cuda",
                         generator=gen).to(torch.int16)
    got, want = scales.f16bits_to_f32(wcls), scales.f16bits_to_f32_plain(wcls)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        "f16bits_to_f32 on the 1B wcls plane: differs from its plain version"
    del wcls, got, want
    for label, in_f, out_f in scales.SHAPES_1B + scales.SHAPES_8B:
        nb = in_f // 32
        x8, xs, qt, dt16, _ = scales.make_operands(in_f, out_f, "cuda", seed=13)
        planes = scale_planes(dt16)
        splits = cuda_q40.i8_mma_splits(nb, out_f)
        assert nb % splits == 0, f"{label}: B9's {splits} splits do not divide nb {nb}"
        ref = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt16)
        for plane, d in planes.items():
            got = scales.i8_tile_call(x8, xs, qt, d, 64, nb // splits)
            assert torch.equal(got, ref), f"i8_tile_call {label} {plane} at B9's tile: differs from B9"
        if (in_f, out_f) == scales.P2_SHAPE[1:]:
            x8r, xsr, _, _, _ = int4.make_operands(in_f, out_f, 8, "cuda", seed=14)
            for rows in range(1, 9):
                xr, sr = x8r[:rows], xsr[:rows]
                p13 = scales.i8_tile_call(xr, sr, qt, dt16, *scales.P2_TILE)
                got = {p: scales.scale_plane_call(xr, sr, qt, planes[p]) for p in ("f32", "i16")}
                for plane, g in got.items():
                    assert torch.equal(g, scales.scale_plane_call_plain(xr, sr, qt, planes[plane])), \
                        f"scale_plane_call {plane} at {rows} rows: differs from its plain version"
                    compare(torch, f"scale_plane_call {plane} {rows} rows vs P13", [(g, p13)],
                            rel_tol=SWEEP_REL_TOL)
                assert torch.equal(got["f32"], got["i16"]), \
                    f"scale_plane_call at {rows} rows: the planes differ"
        del x8, xs, qt, dt16, planes, ref, got
        torch.cuda.empty_cache()
    for label, in_f, out_f in i4_tiles.SHAPES:
        x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, 1, "cuda", seed=6)
        qw = int4.pack_i32_t(qt)
        got = i4_tiles.i4_sweep_call(x8, xs, qw, dt.view(torch.int16),
                                     *i4_tiles.p3_tile(in_f // 32, out_f))
        assert torch.equal(got, int4.i4_call_bf16(x8, xs, int4.pack_s4(qt), dt)), \
            f"i4_sweep_call {label} at P3's plan: differs from P3's bf16 arm"
        # P6 at P4's warps along k and blocks a split, where its tiles have them
        tile = i4_tiles.plan_tile(int4.i32_plan(in_f // 32, out_f))
        if tile in i4_tiles.tiles_for(in_f // 32)[0]:
            got = i4_tiles.i4_sweep_call(x8, xs, qw, dt.view(torch.int16), *tile)
            assert torch.equal(got, int4.i32_call_bf16(x8, xs, qw, dt)), \
                f"i4_sweep_call {label} at P4's plan: differs from P4's bf16 arm"
        del x8, xs, qt, dt, qw, got
    torch.cuda.empty_cache()
    log(json.dumps({"phase": "sweep_checks", "ok": True}))


def sweep_rows(torch, rates, counters):
    """The sweeps' entry points (probes/scales.py and probes/i4_tiles.py
    main), as a user runs them, with every launch counter in `counters`
    set to 0 just before and read just after; P1, P2, P13, P6 and B9 (P6's
    baseline) must have launched, and every row of the mains must hold its
    checks: P1 bit for bit equal to its plain version, every other row
    within SWEEP_REL_TOL of the plain output's largest value (P6's bit for
    bit equal to it, and at P3's plan to P3) and, at each tile, the planes
    bit for bit equal. Returns (launches, one kernels-line row a probe: P1 on the 1B
    wcls plane, P2's i16 plane, P13 at the 8B wcls 4096 -> 128256 (i16
    plane, its best tile), P6 at the 1B wcls 2048 -> 32768 (its best tile))."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.probes import i4_tiles, scales

    bw, bf16_peak, int8_peak = rates
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    # all eight shapes at every tile
    s_rows = scales.main(["--device", "cuda"])
    t1 = time.perf_counter()
    i_rows = i4_tiles.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    log(json.dumps({"phase": "sweeps", "launches": launches, "scales_s": t1 - t0,
                    "i4_tiles_s": time.perf_counter() - t1}))
    for r in s_rows + i_rows:
        log("sweep_row " + json.dumps(r))
    check_launched(launches, (*scales.KERNELS, *i4_tiles.KERNELS, cuda_q40.q40_i8_unpacked),
                   SWEEP_PATH)
    errs = {}  # kernel -> (max abs err, max rel err, loosest tolerance)
    for r in s_rows + i_rows:
        if r["probe"] == "P1":
            assert r["bit_equal_plain"] and r["equal_f16_on_finite"], f"P1 {r['shape']}"
            e = (0.0, 0.0, 0.0)
        else:
            tol = SWEEP_REL_TOL * r["out_scale"]
            assert r["max_abs_err"] <= tol, f"{r['probe']} {r['shape']}: {r['max_abs_err']}"
            assert r.get("planes_bit_equal", True), \
                f"{r['probe']} {r['shape']} {r['cols']}x{r['blocks_per_cta']}: the planes differ"
            assert r.get("bit_equal_plain", True) and r.get("equals_p3", True), \
                f"{r['probe']} {r['shape']} {r['cols']}x{r['blocks_per_cta']}: not its plain " \
                f"order or not P3 at P3's plan"
            e = (r["max_abs_err"], r["max_abs_err"] / r["out_scale"], tol)
        old = errs.get(r["kernel"], (0.0, 0.0, 0.0))
        errs[r["kernel"]] = tuple(max(a, b) for a, b in zip(old, e))

    def row(name, r, peak, work):
        times = {"ms": r["cold_ms"], "hot_ms": r["hot_ms"], "chain_ms": r["chain_ms"],
                 "plain_ms": r["plain_ms"], "library_ms": r["library_cold_ms"]}
        return _row(name, *SWEEP_SOURCES[name], errs[name], times, r["bytes"], r["ops"], bw,
                    peak, work)

    def best(rows):
        return min(rows, key=lambda r: r["cold_ms"])

    out = {}
    r = next(r for r in s_rows if r["probe"] == "P1" and "128256" in r["shape"])
    out["f16bits_to_f32"] = row("f16bits_to_f32", r, int8_peak,
                                f"P1: {r['shape']} raw f16 bits -> f32, cold; library: "
                                f".view(torch.float16).float(), the same function on finite "
                                f"values only")
    r = next(r for r in s_rows if r["probe"] == "P2" and r["plane"] == "i16")
    out["scale_plane_call"] = row("scale_plane_call", r, int8_peak,
                                  f"P2: {r['shape']} at 1 row, i16 plane, the one-row GEMV at "
                                  f"{r['vec']} columns a lane, {r['kw']} warps along k, "
                                  f"{r['splits']} splits ({r['ctas']} CTAs), cold; library: "
                                  f"torch.matmul on the bf16-dequantized plane")
    r = best([r for r in s_rows if r["probe"] == "P13" and r["out"] == 128256
              and r["plane"] == "i16"])
    out["i8_tile_call"] = row("i8_tile_call", r, int8_peak,
                              f"P13: {r['shape']} at 1 row, i16 plane, best tile TN {r['cols']} "
                              f"x {r['blocks_per_cta']} blocks, cold; library: torch.matmul on "
                              f"the bf16-dequantized plane")
    r = best([r for r in i_rows if r["probe"] == "P6" and r["out"] == 32768])
    out["i4_sweep_call"] = row("i4_sweep_call", r, bf16_peak,
                               f"P6: {r['shape'].strip()} at 1 row, best tile TN {r['cols']} x "
                               f"{r['blocks_per_cta']} blocks, cold, one instance for the "
                               f"variants {'/'.join(r['variants'])}; library: torch.matmul "
                               f"on the bf16-dequantized plane")
    return launches, out


# ---------------------------------------------------------------------------
# phase 3e: the unsigned-nibble codecs
# ---------------------------------------------------------------------------

CODEC_SOURCES = {
    "sh_call": ("distributed_llama_tpu_torch/csrc/i4_codec_probe.cu",
                "scripts/probe_int4b.py:119"),
    "fs2d_call": ("distributed_llama_tpu_torch/csrc/i4_codec_probe.cu",
                  "scripts/probe_int4c.py:145"),
    "fs_call": ("distributed_llama_tpu_torch/csrc/i4_codec_probe.cu",
                "scripts/probe_int4c.py:173"),
}
CODEC_PATH = "nibble codec probes"
CODEC_REL_TOL = 1e-5  # against B9: exact corrected partials, f32 block sums in another order


def codec_checks(torch):
    """Every tile of csrc/i4_codec_probe.cu's two loaders (P5's split-half
    bytes in both storages, P9/P10's feature-split words in both views, f16
    and i16 planes; the one-row GEMV of csrc/i8_gemv.cuh) at the five probe
    shapes, at 1 and 3 rows, bit for bit equal to its plain order; at the
    default plan each of 1..8 rows equal to its one-row call; at P3's plan
    equal to P3's int8 arm; within CODEC_REL_TOL of B9. Returns {kernel
    name: (max abs err, max rel err, tolerance)} against the plain
    versions (bit for bit: zero)."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.probes import gemv, int4, int4b, int4c

    errs = {}

    def keep(name, e):
        old = errs.get(name, (0.0, 0.0, 0.0))
        errs[name] = tuple(max(a, b) for a, b in zip(old, e))

    def equal(name, got, want, where):
        assert torch.equal(got.reshape(want.shape), want), f"{name} {where}: differs"
        keep(name, (0.0, 0.0, 0.0))

    for label, in_f, out_f in int4c.SHAPES:
        nb = in_f // 32
        fs_tiles, sh_tiles = int4c.tiles_for(nb, out_f)[0], int4b.tiles_for(nb, out_f)[0]
        p3_tiles = {w: gemv.u4_p3_tile(nb, out_f, w) for w in (gemv.W_FS, gemv.W_SH)}
        for rows in (1, 3, 8):
            x8, xs, qt, dt16, _ = int4.make_operands(in_f, out_f, rows, "cuda", seed=14 + rows)
            bs = int4b.block_sums(x8, nb)
            qp = int4c.pack_feature_split(qt)
            qp2d, qsh = qp.view(nb * 4, out_f), int4b.pack_split_half(qt)
            p3 = int4.i4_call_int8(x8, xs, int4.pack_s4(qt), dt16)
            b9 = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt16)
            for plane, d in int4b.planes(dt16).items():
                d2 = d.reshape(nb, 2, out_f // 2)
                if rows == 8:  # the default plans: each row its one-row call
                    fs, sh = (gemv.u4_gemv_plan(nb, out_f, w) for w in (gemv.W_FS, gemv.W_SH))
                    got_fs = int4c.fs_call(x8, xs, bs, qp, d, fs.cols, fs.blocks_per_split)
                    got_sh = int4b.sh_call(x8, xs, bs, qsh, d2, sh.cols, sh.blocks_per_split)
                    for r in range(rows):
                        one = (slice(r, r + 1),)
                        equal("fs_call", int4c.fs_call(x8[one], xs[one], bs[one], qp, d, fs.cols,
                                                       fs.blocks_per_split), got_fs[one],
                              f"{label} {plane} row {r} of 8 at the default plan")
                        equal("sh_call", int4b.sh_call(x8[one], xs[one], bs[one], qsh, d2,
                                                       sh.cols, sh.blocks_per_split),
                              got_sh[one], f"{label} {plane} row {r} of 8 at the default plan")
                    for got in (got_fs, got_sh):
                        compare(torch, f"codec {label} {plane} 8 rows vs B9",
                                [(got.reshape(b9.shape), b9)], rel_tol=CODEC_REL_TOL)
                    continue
                for cols, blocks in fs_tiles:
                    where = f"{label} rows {rows} {plane} {cols}x{blocks}"
                    got = int4c.fs2d_call(x8, xs, bs, qp2d, d, cols, blocks)
                    equal("fs2d_call", got,
                          int4c.fs2d_call_plain(x8, xs, bs, qp2d, d, cols, blocks), where)
                    equal("fs_call", int4c.fs_call(x8, xs, bs, qp, d, cols, blocks), got, where)
                    compare(torch, f"fs2d_call {where} vs B9", [(got, b9)],
                            rel_tol=CODEC_REL_TOL)
                    if (cols, blocks) == p3_tiles[gemv.W_FS]:
                        equal("fs2d_call", got, p3, f"{where}: P3's plan, against P3")
                for cols, blocks in sh_tiles:
                    where = f"{label} rows {rows} {plane} {cols}x{blocks}"
                    sh = int4b.sh_call(x8, xs, bs, qsh, d2, cols, blocks, "i8ops")
                    equal("sh_call", sh, int4b.sh_call_plain(x8, xs, bs, qsh, d2, cols, blocks),
                          where)
                    equal("sh_call", int4b.sh_call(x8, xs, bs, qsh.view(torch.int32), d2, cols,
                                                   blocks, "i32st"), sh, f"{where} i32st")
                    compare(torch, f"sh_call {where} vs B9", [(sh.reshape(b9.shape), b9)],
                            rel_tol=CODEC_REL_TOL)
                    if (cols, blocks) == p3_tiles[gemv.W_SH]:
                        equal("sh_call", sh, p3, f"{where}: P3's plan, against P3")
            del x8, xs, qt, dt16, bs, qp, qp2d, qsh, p3, b9
            torch.cuda.empty_cache()
    log(json.dumps({"phase": "codec_checks", "errs": errs}))
    return errs


def codec_rows(torch, rates, errs, counters):
    """The codec probes' entry points (probes/int4b.py and probes/int4c.py
    main), as a user runs them, with every launch counter in `counters` set
    to 0 just before and read just after; P5, P9, P10, B9 and K1's body
    must have launched, and every row of the mains must hold its checks:
    bit for bit its plain order, within CODEC_REL_TOL of B9's largest
    value, the planes, storages and views bit for bit equal, at P3's plan
    equal to P3. Returns (launches, one kernels-line row a probe at the
    wcls 2048 -> 32768: P5 and P9 at their best tile on the i16 plane (the
    JAX probes' `_dt_operand`), P10 at P9's best tile, each with its
    default plan's time and the launches one call makes, counted after
    the path's counts are read)."""
    from distributed_llama_tpu_torch.ops import cuda_q40
    from distributed_llama_tpu_torch.probes import gemv, int4, int4_prod, int4b, int4c

    bw, bf16_peak, int8_peak = rates
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    b_rows = int4b.main(["--device", "cuda"])
    t1 = time.perf_counter()
    c_rows = int4c.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    log(json.dumps({"phase": "codecs", "launches": launches, "int4b_s": t1 - t0,
                    "int4c_s": time.perf_counter() - t1}))
    for r in b_rows + c_rows:
        log("codec_row " + json.dumps(r))
    check_launched(launches, (*int4b.KERNELS, *int4c.KERNELS, cuda_q40.q40_i8_unpacked,
                              int4_prod.fs_call_tiles), CODEC_PATH)
    errs = dict(errs)
    for r in b_rows + c_rows:
        if r["kernel"] not in CODEC_SOURCES:  # the baselines: B9, the first K1's body
            assert r["max_abs_err"] <= CODEC_REL_TOL * r["out_scale"], r
            continue
        where = f"{r['probe']} {r['shape']} {r['plane']} {r['cols']}x{r['blocks_per_cta']}"
        assert r["max_abs_err_vs_b9"] <= CODEC_REL_TOL * r["out_scale"], f"{where}: vs B9"
        for flag in ("bit_equal_plain", "planes_bit_equal", "storages_bit_equal",
                     "views_bit_equal", "equals_p3"):
            assert r.get(flag, True), f"{where}: {flag} fails"
        e = (r["max_abs_err"], r["max_abs_err"] / r["out_scale"], 0.0)
        errs[r["kernel"]] = tuple(max(a, b) for a, b in zip(errs[r["kernel"]], e))

    def at_wcls(rows, probe, plane, default=False):
        return min((r for r in rows if r["probe"] == probe and r["out"] == 32768
                    and r["plane"] == plane and (r.get("default_plan") or not default)),
                   key=lambda r: r["cold_ms"])

    # the launches of one call at the default plan, 2048 -> 32768
    nb, out_f = 64, 32768
    x8, xs, qt, dt16, _ = int4.make_operands(2048, out_f, 1, "cuda", seed=1)
    bs, bits = int4b.block_sums(x8, nb), dt16.view(torch.int16)
    one = {}
    for fn, w, q, d in ((int4b.sh_call, gemv.W_SH, int4b.pack_split_half(qt),
                         bits.reshape(nb, 2, out_f // 2)),
                        (int4c.fs2d_call, gemv.W_FS, int4c.pack_feature_split(qt).view(-1, out_f),
                         bits),
                        (int4c.fs_call, gemv.W_FS, int4c.pack_feature_split(qt), bits)):
        plan = gemv.u4_gemv_plan(nb, out_f, w)
        before = fn.launches
        fn(x8, xs, bs, q, d, plan.cols, plan.blocks_per_split)
        one[fn.__name__] = fn.launches - before
    del x8, xs, qt, dt16, bs, bits
    out = {}
    for name, rows, probe in (("sh_call", b_rows, "P5"), ("fs2d_call", c_rows, "P9"),
                              ("fs_call", c_rows, "P10")):
        r, f16 = at_wcls(rows, probe, "i16"), at_wcls(rows, probe, "f16")
        default = at_wcls(c_rows if probe == "P10" else rows, "P9" if probe == "P10" else probe,
                          "i16", default=True)
        times = {"ms": r["cold_ms"], "hot_ms": r["hot_ms"], "chain_ms": r["chain_ms"],
                 "plain_ms": r["plain_ms"], "library_ms": r["library_cold_ms"],
                 "f16_ms": f16["cold_ms"], "default_ms": default["cold_ms"],
                 "launches_a_call": one[name], "x_b9": r["x_b9"],
                 "x_first_k1": r["x_first_k1"]}
        tile = "P9's best" if probe == "P10" else "best"
        out[name] = _row(name, *CODEC_SOURCES[name], errs[name], times, r["bytes"], r["ops"],
                         bw, int8_peak,
                         f"{probe}: {r['shape'].strip()} at 1 row, i16 plane, {tile} tile TN "
                         f"{r['cols']} x {r['blocks_per_cta']} blocks, cold (f16_ms: the f16 "
                         f"plane's best, TN {f16['cols']} x {f16['blocks_per_cta']}; "
                         f"default_ms: the default plan's tile TN {default['cols']} x "
                         f"{default['blocks_per_cta']}, P9's for P10; bit for bit the plain "
                         f"order: tol 0); library: torch.matmul on the bf16-dequantized plane")
    return launches, out


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


def small_batch_reference(torch, tmp: Path):
    """A tiny Llama through a paged int8 BatchSession at batch 4, on the
    card and on the CPU: one decode step's logits after admission and 24
    greedy tokens a row compared; K1 and K5 must have launched on the card."""
    from distributed_llama_tpu_torch.models import forward
    from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40
    from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
    from distributed_llama_tpu_torch.testing import tiny_header, write_tiny_model

    h = tiny_header(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                    vocab_size=512, seq_len=512)
    path = str(tmp / "tiny_llama_batch.m")
    write_tiny_model(path, h, seed=1)
    prompts = [list(range(1, 1 + n)) for n in (5, 17, 38, 9)]
    kernels = (cuda_q40.q40_gemv_q80_stacked, cuda_attention.paged_flash_attention)
    before = {k.__name__: k.launches for k in kernels}
    out = {}
    for dev in ("cuda", "cpu"):
        eng = InferenceEngine(path, device=dev, batch=4, kv_layout="paged", cache_dtype="int8")
        s = BatchSession(eng)
        for r, p in enumerate(prompts):
            s.admit(r, p)
        pos = torch.tensor(s.pos, device=dev)
        logits = forward(eng.cfg, eng.params, eng.rope, eng.cache,
                         torch.tensor(s.token, device=dev)[:, None], pos,
                         kv_len=eng._kv_bucket(int(pos.max()) + 1),
                         page_table=eng._pt_operand(), page_size=eng.page_size).cpu()
        toks = [s.step(8) for _ in range(3)]
        out[dev] = (logits, [t.tolist() for t in toks])
        eng.close()
    launched = {k.__name__: k.launches - before[k.__name__] for k in kernels}
    (lg, tg), (lc, tc) = out["cuda"], out["cpu"]
    assert torch.isfinite(lg).all() and lg.shape == (4, h.vocab_size)
    err = (lg - lc).abs().max().item()
    # the kernels and the plain versions sum in other orders (K1's f32
    # block sums, K5's f32 dots): far below a wrong kernel's O(1)
    tol = 2e-2 * lc.abs().max().item()
    log(json.dumps({"phase": "small_reference", "model": "tiny_llama_paged_int8_batch4",
                    "logits_max_abs_err": err, "tol": tol, "tokens_equal": tg == tc,
                    "launches_on_card": launched}))
    assert err <= tol, f"paged int8 batch: logits differ from the CPU by {err} > {tol}"
    assert tg == tc, "paged int8 batch: greedy tokens differ from the CPU"
    for k, n in launched.items():
        assert n > 0, f"paged int8 batch: kernel {k} never launched on the card"


# the q80 parity mode's tiny models (phase 4) and a model seed each. The
# card and the CPU sum f32 in other orders; where an activation lands on a
# rounding boundary of its block they round it to neighbouring int8 steps,
# which moves the logits by ~1% and may part the greedy chains at a
# near-tie. Over seeds 0-11 on an H100 (`small_q80_reference`'s `seed`)
# no step happened over the run on 5 (Llama: first logits within 4.1e-7
# of their scale, 48 tokens equal) and 4 (Qwen3-MoE, 4.8e-7) seeds; the
# others moved the logits 0.8-1.4%. The seeds below are the first of each
# set
Q80_CASES = {
    "tiny_llama": (dict(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                        vocab_size=512, seq_len=512), 0),
    "tiny_qwen3_moe": (dict(arch=QWEN3_MOE_ARCH, dim=256, hidden_dim=256, moe_hidden_dim=256,
                            n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64, n_experts=16,
                            n_active_experts=2, vocab_size=512, seq_len=512), 1),
}
# the first logits' largest difference card against CPU, as a share of
# their scale, where no activation rounds to another int8 step: f32 sums in
# other orders only
Q80_TOL = 1e-5
Q80_DECODE_STEPS = 48


def small_q80_reference(torch, tmp: Path, name: str, seed: int | None = None) -> dict:
    """The q80 parity mode (compute_dtype float32, `q80_activations=True`:
    every Q40 matmul input round-tripped through Q80, the reference's
    `--buffer-float-type q80`) on a tiny model, on the card and on the CPU:
    the first logits after a 39-token prompt within Q80_TOL of their scale
    and Q80_DECODE_STEPS greedy tokens equal. The prefill's 32-row chunk
    takes the MoE plain arm on the tiny Qwen3-MoE (the grouped kernel
    refuses q80), its tail and decode the gather arm."""
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
    from distributed_llama_tpu_torch.testing import tiny_header, write_tiny_model

    header_kw, pinned = Q80_CASES[name]
    seed = pinned if seed is None else seed
    path = str(tmp / f"{name}_q80_seed{seed}.m")
    write_tiny_model(path, tiny_header(**header_kw), seed=seed)
    prompt = [(7 * i) % 500 + 1 for i in range(40)]
    out = {}
    for dev in ("cuda", "cpu"):
        eng = InferenceEngine(path, device=dev, compute_dtype="float32", q80_activations=True,
                              decode_chunk_size=16)
        eng.prefill(prompt[:-1])
        logits = torch.from_numpy(eng.decode_one(prompt[-1], len(prompt) - 1))
        eng.reset()
        toks = eng.generate(prompt, len(prompt) - 1 + Q80_DECODE_STEPS).tokens[len(prompt):]
        out[dev] = (logits, toks)
        eng.close()
    (lg, tg), (lc, tc) = out["cuda"], out["cpu"]
    rel = (lg - lc).abs().max().item() / lc.abs().max().item()
    same = next((i for i, (a, b) in enumerate(zip(tg, tc)) if a != b), len(tc))
    return {"phase": "small_q80_reference", "model": name, "seed": seed,
            "logits_rel_err": rel, "tol": Q80_TOL, "tokens": len(tc),
            "leading_tokens_equal": same, "finite": bool(torch.isfinite(lg).all())}


def q80_references(torch, tmp: Path) -> None:
    """`small_q80_reference` at the pinned seeds; raises where they part."""
    for name in Q80_CASES:
        r = small_q80_reference(torch, tmp, name)
        log(json.dumps(r))
        assert r["finite"], f"{name} q80: non-finite logits on the card"
        assert r["logits_rel_err"] <= Q80_TOL, f"{name} q80: card logits off the CPU's: {r}"
        assert r["leading_tokens_equal"] == r["tokens"], f"{name} q80: tokens part: {r}"


# ---------------------------------------------------------------------------
# phase 5: the main paths at full width
# ---------------------------------------------------------------------------


def synthetic_model(stem: str, header_kw: dict, norm_epsilon: float | None = None,
                    root: Path = BUILD):
    """The model file (random Q40 block bytes from seed 0, written fast by
    testing.write_random_q40_model) and a byte tokenizer padded to its
    vocab, written once into root/models. Returns (model path, tokenizer
    path, write seconds, file bytes)."""
    from distributed_llama_tpu_torch.formats.mfile import MFileReader
    from distributed_llama_tpu_torch.testing import (
        tiny_header, write_random_q40_model, write_tiny_tokenizer,
    )

    d = root / "models"
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


def start_model_writer(stem: str, header_kw: dict, norm_epsilon: float | None, nbytes: int):
    """`synthetic_model` in a child process, so that a large file is written
    while the card runs other phases; None (the caller writes it in turn)
    where the disk would not hold it beside what is there with 4 GB to
    spare. The child is a daemon: it ends with this process."""
    import multiprocessing
    import shutil

    (BUILD / "models").mkdir(parents=True, exist_ok=True)
    if shutil.disk_usage(BUILD).free < nbytes + (4 << 30):
        return None
    proc = multiprocessing.get_context("spawn").Process(
        target=synthetic_model, args=(stem, header_kw, norm_epsilon), daemon=True)
    proc.start()
    return proc


def run_cli(torch, argv, counters):
    """One CLI run on the card with every launch counter set to 0 just
    before and read just after. Returns (stdout, launches)."""
    from distributed_llama_tpu_torch import cli

    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    text = buf.getvalue()
    assert rc == 0, f"cli {argv[0]} exited {rc}"
    return text, launches


def check_launched(launches, expected, where):
    for k in expected:
        assert launches[k.__name__] > 0, f"kernel {k.__name__} was never launched on {where}"


def pred_text(text: str) -> str:
    """The generated text of a CLI inference run: its Pred lines' texts
    joined (split at newlines only: a token's text may hold a control
    character that `splitlines` splits at; a line of no text shows "~")."""
    lines = [line.split("| ", 1)[1] for line in text.split("\n") if line.startswith("🔶 Pred")]
    texts = [re.sub(r"^\(\d+ tokens\) ", "", line) for line in lines]
    return "".join("" if t == "~" else t for t in texts)


def step_report(text: str) -> dict:
    """The CLI's step report ({series: count}) after its Timing block,
    checked against the run: the prefill series count the Eval lines (one
    a prefill chunk), the decode and verify series the Pred lines (one a
    decode chunk or a verify round)."""
    assert "📊 Step performance report:" in text, "no step report in the CLI output"
    lines = text.split("📊 Step performance report:")[1].strip().split("\n")
    report = {}
    for line in lines:
        m = re.match(r"\s*(\S+)\s+n=(\d+)\s+avg=", line)
        if not m:
            break
        report[m.group(1)] = int(m.group(2))
    n_eval = sum(1 for line in text.split("\n") if line.startswith("🔷️ Eval"))
    n_pred = sum(1 for line in text.split("\n") if line.startswith("🔶 Pred"))

    def total(prefix):
        return sum(n for k, n in report.items() if k.startswith(prefix))

    assert total("prefill[") == n_eval > 0, f"step report {report} against {n_eval} Eval lines"
    assert total("decode[") + total("spec_verify[") == n_pred > 0, \
        f"step report {report} against {n_pred} Pred lines"
    return report


def main_path(torch, name: str, mp: str, tp: str, n_layers: int, counters, expected,
              extra=("--kv-layout", "contiguous"), texts=None, decode_steps=DECODE_STEPS):
    """The CLI's inference mode on one model: `decode_steps` greedy decode
    steps after the prompt, at the CLI's default speculation unless `extra` says
    otherwise; each kernel in `expected` must have launched. The layout is
    explicit: the CLI's default is paged. `texts`: a dict that takes the
    run's generated text under `extra`."""
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    n_prompt = len(Tokenizer(tp).encode(PROMPT))
    # decode runs positions n_prompt - 1 .. steps - 1 (the reference's maxPos)
    steps = n_prompt - 1 + decode_steps
    argv = ["inference", "--model", mp, "--tokenizer", tp, "--prompt", PROMPT,
            "--steps", str(steps), "--max-seq-len", str(MAX_SEQ_LEN),
            "--temperature", "0", "--device", "cuda", *extra]
    torch.cuda.reset_peak_memory_stats()
    text, launches = run_cli(torch, argv, counters)
    print(text[-4000:], flush=True)

    def num(section, key):
        m = re.search(section + r"\n(?:.*\n)*?\s*" + key + r":\s*([0-9.]+)", text)
        assert m, f"no {key} under {section} in the CLI output"
        return float(m.group(1))

    n_pred = int(num("Prediction", "nTokens"))
    assert n_pred == decode_steps, f"decoded {n_pred} tokens, expected {decode_steps}"
    report = step_report(text)
    summary = {
        "phase": "main_path", "model": name, "args": list(extra), "n_layers": n_layers,
        "prompt_tokens": n_prompt, "decode_tokens": n_pred,
        "load_s": num("Load", "seconds"),
        "prefill_tok_s": num("Evaluation", "tokens/s"),
        "decode_tok_s": num("Prediction", "tokens/s"),
        "ttft_ms": num("Timing", "ttftMs"),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "step_report": report,
        "launches": launches,
    }
    log(json.dumps(summary))
    check_launched(launches, expected, f"{name}'s main path {' '.join(extra)}")
    if texts is not None:
        texts[tuple(extra)] = pred_text(text)
    return launches


def perplexity_path(torch, mp: str, tp: str, counters, expected):
    """The CLI's perplexity mode over PROMPT at its defaults (paged bf16),
    then with --kv-layout contiguous: the two perplexities agree to 1e-3
    relative (the same numerics arms; only attention's view is gathered)."""
    argv = ["perplexity", "--model", mp, "--tokenizer", tp, "--prompt", PROMPT,
            "--max-seq-len", str(MAX_SEQ_LEN), "--device", "cuda"]
    ppl, out = {}, {}
    for layout in ("paged", "contiguous"):
        t0 = time.perf_counter()
        extra = [] if layout == "paged" else ["--kv-layout", "contiguous"]
        text, launches = run_cli(torch, argv + extra, counters)
        ppl[layout] = float(re.search(r"perplexity: ([0-9.]+)", text).group(1))
        out[layout] = {"perplexity": ppl[layout], "wall_s": time.perf_counter() - t0,
                       "launches": launches}
        if layout == "paged":
            paged_launches = launches
    log(json.dumps({"phase": "perplexity", **out}))
    assert abs(ppl["paged"] - ppl["contiguous"]) <= 1e-3 * ppl["contiguous"], ppl
    check_launched(paged_launches, expected, "the perplexity path")
    return paged_launches


def batch_session_path(torch, mp: str, tp: str, counters, expected):
    """A BatchSession at batch 16 on the paged int8 layout: 16 prompts of
    16-113 tokens (prefixes of PROMPT), 8-token chunks to 128 tokens; at
    token 64 four rows are released and four new prompts admitted. The
    gate: every row, and each re-admitted row, produces the same greedy
    tokens as the same row alone in a batch-16 session whose other rows
    are parked. Returns (launches, the session, its engine)."""
    from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    ids = Tokenizer(tp).encode(PROMPT)
    b, chunk, n_chunks, swap_at = 16, 8, 16, 8
    prompts = [ids[: 16 + (len(ids) - 16) * i // (b - 1)] for i in range(b)]
    swapped = (2, 6, 10, 14)
    new_prompts = {r: ids[10 + 5 * j : 10 + 5 * j + 24 + 20 * j] for j, r in enumerate(swapped)}
    eng = InferenceEngine(mp, max_seq_len=MAX_SEQ_LEN, batch=b, kv_layout="paged",
                          cache_dtype="int8", device="cuda")

    def run(rows_first, rows_new, chunks):
        """Admit `rows_first`, step; at chunk swap_at release `swapped` and
        admit `rows_new`. Returns tokens per (row, admission), TTFTs and
        the decode tokens and seconds."""
        s = BatchSession(eng)
        toks, ttft, t_adm = {}, {}, {}
        for r in rows_first:
            t_adm[(r, 0)] = time.perf_counter()
            s.admit(r, prompts[r])
            toks[(r, 0)] = []
        n_dec, dec_s = 0, 0.0
        for c in range(chunks):
            if c == swap_at and rows_new:
                for r in swapped:
                    s.release(r)
                for r in rows_new:
                    t_adm[(r, 1)] = time.perf_counter()
                    s.admit(r, new_prompts[r])
                    toks[(r, 1)] = []
            live = {r: k for (r, k) in toks if s.active[r] and (k == 1 or c < swap_at or r not in swapped)}
            t0 = time.perf_counter()
            host = s.step(chunk)
            dt = time.perf_counter() - t0
            now = time.perf_counter()
            for r, k in live.items():
                if not toks[(r, k)]:
                    ttft[(r, k)] = (now - t_adm[(r, k)]) * 1e3
                toks[(r, k)].extend(int(t) for t in host[r])
            n_dec += chunk * len(live)
            dec_s += dt
        return s, toks, ttft, n_dec, dec_s

    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    sess, toks, ttft, n_dec, dec_s = run(range(b), swapped, n_chunks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in counters}
    check_launched(launches, expected, "the batch-16 session")
    summary = {
        "phase": "batch_session", "batch": b, "layout": "paged", "kv_dtype": "int8",
        "prompt_tokens": [len(p) for p in prompts],
        "readmitted_prompt_tokens": [len(p) for p in new_prompts.values()],
        "decode_tokens": n_dec, "decode_s": dec_s, "decode_tok_s": n_dec / dec_s,
        "wall_s": wall,
        "ttft_ms": {f"row{r}" + ("_readmitted" if k else ""): v for (r, k), v in ttft.items()},
        "launches": launches,
    }
    log(json.dumps(summary))
    # the gate: every row, each admission of it, alone among parked rows
    checked = {}
    for r, k in toks:
        if k == 0:
            _, ref, _, _, _ = run([r], (), swap_at if r in swapped else n_chunks)
        else:
            s = BatchSession(eng)
            s.admit(r, new_prompts[r])
            ref = {(r, 1): [int(t) for c in range(n_chunks - swap_at) for t in s.step(chunk)[r]]}
        same = ref[(r, k)] == toks[(r, k)]
        checked[f"row{r}" + ("_readmitted" if k else "")] = {"tokens": len(ref[(r, k)]), "equal": same}
        assert same, f"batch-16 row {r} ({k}) differs from its run with the other rows parked"
    log(json.dumps({"phase": "batch_session_gate", "rows": checked}))
    return launches, sess, eng


def generate_batch_path(torch, mp: str, tp: str, counters, expected):
    """generate_batch at batch 4 on the paged int8 layout: four 81-token
    windows of PROMPT (one length, so the batch and a row alone take the
    same prefill chunks and numerics arms), 64 greedy tokens a row; each
    row must equal its solo paged-int8 run."""
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    ids = Tokenizer(tp).encode(PROMPT)
    prompts = [ids[o : o + 81] for o in (0, 10, 20, 32)]
    n = 64
    kw = dict(max_seq_len=MAX_SEQ_LEN, kv_layout="paged", cache_dtype="int8", device="cuda")
    eng = InferenceEngine(mp, batch=4, **kw)
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    out = eng.generate_batch(prompts, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in counters}
    eng.close()
    del eng
    solo = InferenceEngine(mp, **kw)
    equal = []
    for p, got in zip(prompts, out):
        solo.reset()
        equal.append(solo.generate(p, len(p) + n).tokens[len(p) : len(p) + n] == got)
    solo.close()
    log(json.dumps({"phase": "generate_batch", "batch": 4, "layout": "paged", "kv_dtype": "int8",
                    "tokens_per_row": n, "wall_s": wall, "decode_tok_s_upper": 4 * n / wall,
                    "rows_equal_solo": equal, "launches": launches}))
    assert all(len(o) == n for o in out) and all(equal), "generate_batch rows differ from solo runs"
    check_launched(launches, expected, "generate_batch at batch 4")
    return launches


def prefill_logits(torch, eng, ids):
    """Every prefill chunk's logits at its real rows, chunk by chunk as
    `prefill` runs them (logits of all rows kept)."""
    from distributed_llama_tpu_torch.runtime.engine import chunk_plan

    out = []
    for i, size, n_real in chunk_plan(len(ids), 0, eng.max_chunk, eng.cfg.seq_len):
        chunk = ids[i : i + n_real] + [0] * (size - n_real)
        logits = eng._forward(eng._tokens([chunk]), i, logits_mode="all",
                              kv_len=eng._kv_bucket(i + size))
        out.append(logits[:, :n_real])
    return torch.cat(out, dim=1)


def sp_path(torch, mp: str, tp: str, counters, expected, b8, k3):
    """The sequence-parallel path at Llama-3.2-1B width and depth:
    InferenceEngine(mesh=make_mesh(sp=4)) on this card four times, a
    16384-row cache in four 4096-row shards, against the sp = 1 engine.
    Gates, each on the card:
      * the 113-token PROMPT's prefill logits, every chunk, equal the sp = 1
        engine's bit for bit (shards 1-3 add exact zeros and shard 0 runs
        K3's own loop through B8);
      * a 4400-token seeded prompt (prefill through shard 0 into shard 1;
        shards 2-3 fully masked) and 16 greedy steps, counted: B8 launched
        chunks x layers x shards times and K3 never;
      * the last prompt row's logits within 5e-2 of their scale of the sp =
        1 engine's (the engine tests' bf16 bound: chunks past 4096 combine
        two shards, whose P rounds to bf16 against other running maxima);
      * the greedy tokens equal up to the first step whose sp = 1 top-2
        margin is under that tolerance."""
    import numpy as np

    from distributed_llama_tpu_torch.parallel import make_mesh
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine, chunk_plan
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    kw = dict(max_seq_len=SP_SEQ_LEN, kv_layout="contiguous")
    eng = InferenceEngine(mp, mesh=make_mesh(sp=SP, devices=[torch.device("cuda")] * SP), **kw)
    solo = InferenceEngine(mp, device="cuda", **kw)
    assert eng.use_pipeline and [c.k.shape[2] for c in eng.cache] == [SP_SEQ_LEN // SP] * SP

    ids = Tokenizer(tp).encode(PROMPT)
    short_equal = torch.equal(prefill_logits(torch, eng, ids), prefill_logits(torch, solo, ids))
    assert short_equal, "sp = 4 prefill logits differ from sp = 1 on PROMPT"
    eng.reset()
    solo.reset()

    vocab = eng.cfg.vocab_size
    prompt = np.random.default_rng(0).integers(1, vocab, SP_PROMPT_TOKENS).tolist()
    n = len(prompt)
    steps = n - 1 + SP_DECODE_STEPS
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    res = eng.generate(prompt, steps, sampler=None)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    n_chunks = len(list(chunk_plan(n - 1, 0, eng.max_chunk, eng.cfg.seq_len)))
    expected_b8 = n_chunks * eng.cfg.n_layers * SP
    assert launches[b8.__name__] == expected_b8, (launches[b8.__name__], expected_b8)
    assert launches[k3.__name__] == 0, launches[k3.__name__]
    check_launched(launches, expected, "the sp path")
    res1 = solo.generate(prompt, steps, sampler=None)
    got, want = res.tokens[n:], res1.tokens[n:]
    assert len(got) == len(want) == SP_DECODE_STEPS

    # the first step's logits, recomputed on each engine's cache (the row
    # at n - 1 is rewritten with the same values; later rows are masked)
    lg = torch.from_numpy(eng.decode_one(prompt[-1], n - 1))
    l1 = torch.from_numpy(solo.decode_one(prompt[-1], n - 1))
    assert torch.isfinite(lg).all() and lg.shape == (1, vocab)
    scale = l1.abs().max().item()
    tol = 5e-2 * scale
    err = (lg - l1).abs().max().item()
    assert err <= tol, f"sp last-row logits differ from sp = 1 by {err} > {tol}"
    first_diff = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    margin = None
    if first_diff is not None:
        feed = prompt[-1] if first_diff == 0 else want[first_diff - 1]
        top2 = torch.from_numpy(solo.decode_one(feed, n - 1 + first_diff))[0].topk(2).values
        margin = (top2[0] - top2[1]).item()
        assert margin < tol, (
            f"sp tokens diverge at step {first_diff} where the sp = 1 top-2 margin is {margin} "
            f">= {tol}")
    summary = {
        "phase": "sp_path", "sp": SP, "seq_len": SP_SEQ_LEN, "prompt_tokens": n,
        "decode_tokens": len(got), "chunks": n_chunks,
        "prefill_tok_s": (n - 1) / (res.prefill_us / 1e6),
        "decode_tok_s": len(got) / (res.decode_us / 1e6),
        "sp1_prefill_tok_s": (n - 1) / (res1.prefill_us / 1e6),
        "sp1_decode_tok_s": len(got) / (res1.decode_us / 1e6),
        "short_prompt_prefill_logits_bit_equal": short_equal,
        "last_row_logits_max_abs_err": err, "tol": tol, "logits_scale": scale,
        "tokens_equal": first_diff is None, "first_differing_step": first_diff,
        "sp1_top2_margin_there": margin, "launches": launches, "expected_b8": expected_b8,
    }
    log(json.dumps(summary))

    # where the prefill's device time goes: the last four chunks again
    # (their rows are rewritten with the same values), B8's share at sp = 4
    # beside K3's at sp = 1
    plan = list(chunk_plan(n - 1, 0, eng.max_chunk, eng.cfg.seq_len))[-4:]
    shares = {}
    for label, e, kernel in (("sp=4", eng, "<64, true>"), ("sp=1", solo, "<64, false>")):

        def tail(e=e):
            for i, size, n_real in plan:
                chunk = prompt[i : i + n_real] + [0] * (size - n_real)
                e._forward(e._tokens([chunk]), i, kv_len=e._kv_bucket(i + size))

        prof = profile_window(torch, f"llama32_1b {label} prefill tail", tail,
                              sum(nr for _, _, nr in plan),
                              share_of={"flash": f"flash_attention_fwd_kernel{kernel}"})
        shares[label] = prof["share"]["flash"]
    log(json.dumps({"phase": "sp_prefill_share", "b8_device_share_sp4": shares["sp=4"],
                    "k3_device_share_sp1": shares["sp=1"]}))

    # and its decode, at sp = 4 and at sp = 1, past the generated tokens
    for label, e in (("sp=4", eng), ("sp=1", solo)):
        at = [steps]
        tok = torch.tensor([got[-1]], device=e.device)

        def run(e=e, at=at, tok=tok, n_steps=16):
            e._decode_chunk(tok, at[0], n_steps)
            at[0] += n_steps

        profile_window(torch, f"llama32_1b {label} decode from position {steps}", run, 16)
    eng.close()
    solo.close()
    return launches


# ---------------------------------------------------------------------------
# phase 5i: the shard loop (tensor, pipeline, data and expert parallelism)
# ---------------------------------------------------------------------------

MESH_SEQ_LEN = 1024  # the 5i engines' context: PROMPT and its decode fit
MESH_DECODE_STEPS = 32
MESH_BATCH_STEPS = 16  # generate_batch's tokens a row (and its rows' runs alone)
MESH_MOE_DECODE_STEPS = 16
# the engine tests' bf16 bound on logits, a share of their scale: the tp and
# ep shards' partial sums add in another order than one device's
MESH_TOL = 5e-2
# the shard shapes (label, in, out) each mesh gives the dense matmuls
MESH_SHARD_MATMULS = (
    ("1B tp2 wqkv", 2048, 1536), ("1B tp2 wo", 1024, 2048), ("1B tp2 w13", 2048, 8192),
    ("1B tp2 w2", 4096, 2048), ("1B tp4 wqkv", 2048, 768), ("1B tp4 wo", 512, 2048),
    ("1B tp4 w13", 2048, 4096), ("1B tp4 w2", 2048, 2048),
    ("30B-A3B tp2 wqkv", 2048, 2560), ("30B-A3B tp2 wo", 2048, 2048),
)


def card_mesh(torch, **shape):
    """A mesh of `shape` over distinct cards where there are as many, else
    over this card named once a shard. Returns (mesh, distinct)."""
    from distributed_llama_tpu_torch.parallel import make_mesh

    n = 1
    for v in shape.values():
        n *= v
    if torch.cuda.device_count() >= n:
        return make_mesh(**shape, devices=[torch.device("cuda", i) for i in range(n)]), True
    return make_mesh(**shape, devices=[torch.device("cuda", 0)] * n), False


# a shard shape's calls are timed as a chain of this many, each on its own
# layer's (or expert block's) weights, as phase 3 times a token's layers:
# one call alone is mostly the graph's launch
MESH_CHAIN = 8


def _shard_entry(torch, name, label, fns, plains, libs, nbytes, nops, bw, peak, **tol):
    """One shard shape of a kernel: each of its MESH_CHAIN calls held
    against its plain version, then kernel, plain version and library call
    timed as chains (CUDA events over graph replays, per call), beside the
    bound of one call's work."""
    from distributed_llama_tpu_torch.probes import timing

    err, rel, t = compare(torch, f"{name} at {label}",
                          ((fn(), plain()) for fn, plain in zip(fns, plains)), **tol)
    t_bytes, t_ops = nbytes / bw * 1e3, nops / peak * 1e3
    entry = {"shape": label, "max_abs_err": err, "max_rel_err": rel, "tol": t,
             "ms": timing.graph_ms(fns), "plain_ms": timing.graph_ms(plains),
             "library_ms": timing.graph_ms(libs), "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations", "calls": len(fns)}
    log("kernel_shard " + json.dumps({"name": name, **entry}))
    return entry


def shard_shape_checks(torch, rates) -> dict:
    """Phase 5i's kernel table: every kernel of the mesh path at the shapes
    its shards give it (Llama-3.2-1B at tp 2 and 4, Qwen3-30B-A3B at ep 2 x
    tp 2), each against its plain version with the phase 3 tolerances,
    timed a call over a chain of MESH_CHAIN calls on distinct weights,
    beside its bound and a library call. Returns {kernel: [entries]}."""
    import torch.nn.functional as F

    from distributed_llama_tpu_torch.ops import cuda_attention as ca
    from distributed_llama_tpu_torch.ops import cuda_q40 as q
    from distributed_llama_tpu_torch.ops.moe import _grouped_block_rows, _grouped_layout_direct

    bw, bf16_peak, int8_peak = rates
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    L = MESH_CHAIN
    out = {}
    for label, i, o in MESH_SHARD_MATMULS:
        qs, ds = random_q40_stack(torch, gen, L, i, o)
        ws = [_dq(torch, qs[li], ds[li]) for li in range(L)]
        x1 = torch.randn((1, 1, i), device="cuda", generator=gen)
        xb1 = x1.reshape(1, i).to(torch.bfloat16)
        out.setdefault("q40_gemv_q80_stacked", []).append(_shard_entry(
            torch, "q40_gemv_q80_stacked", f"{label} {i}->{o}, 1 row",
            [partial(q.q40_gemv_q80_stacked, x1, qs, ds, li) for li in range(L)],
            [partial(q.q40_gemv_q80_plain, x1, qs[li], ds[li]) for li in range(L)],
            [partial(torch.matmul, xb1, w) for w in ws],
            _wbytes(i, o) + (i + o) * 4, 2 * i * o, bw, int8_peak, rel_tol=1e-5))
        x16 = torch.randn((1, 16, i), device="cuda", generator=gen)
        xb16 = x16.reshape(16, i).to(torch.bfloat16)
        out.setdefault("q40_gemm_bf16_stacked", []).append(_shard_entry(
            torch, "q40_gemm_bf16_stacked", f"{label} {i}->{o}, 16 rows (a pp 2 microbatch)",
            [partial(q.q40_gemm_bf16_stacked, x16, qs, ds, li) for li in range(L)],
            [partial(q.q40_gemm_bf16_plain, x16, qs[li], ds[li]) for li in range(L)],
            [partial(torch.matmul, xb16, w) for w in ws],
            _wbytes(i, o) + 16 * (i + o) * 4, 2 * 16 * i * o, bw, bf16_peak, rel_tol=1e-4))
        del qs, ds, ws
    # the vocab-split classifier: 1B at tp 2 (64128 columns) and tp 4
    # (32064), 30B-A3B at tp 2 (75968); a shard that is not a lane multiple
    # is cut with zero columns up to one (parallel/sharding.py), and its
    # bound and library call count its own columns only
    from distributed_llama_tpu_torch.ops.quant import QuantTensor
    from distributed_llama_tpu_torch.parallel.sharding import _lane_padded

    n_w = 2
    for label, dim, vocab in (("1B tp2", LLAMA32_1B["dim"], LLAMA32_1B["vocab_size"] // 2),
                              ("1B tp4", LLAMA32_1B["dim"], LLAMA32_1B["vocab_size"] // 4),
                              ("30B-A3B tp2", QWEN3_30B_A3B["dim"],
                               QWEN3_30B_A3B["vocab_size"] // 2)):
        qs, ds = random_q40_stack(torch, gen, n_w, dim, vocab)
        ws = [_dq(torch, qs[j], ds[j]) for j in range(n_w)]
        pw = [_lane_padded(QuantTensor(q=qs[j], d=ds[j])) for j in range(n_w)]
        del qs, ds
        width = pw[0].out_features
        x1 = torch.randn((1, dim), device="cuda", generator=gen)
        x32 = torch.randn((32, dim), device="cuda", generator=gen)
        shape = f"{label} wcls {dim}->{vocab}" + (f" (padded to {width})" if width != vocab else "")
        out.setdefault("q40_gemv_q80", []).append(_shard_entry(
            torch, "q40_gemv_q80", f"{shape}, 1 row",
            [partial(q.q40_gemv_q80, x1, w.q, w.d) for w in pw],
            [partial(q.q40_gemv_q80_plain, x1, w.q, w.d) for w in pw],
            [partial(torch.matmul, x1.to(torch.bfloat16), w) for w in ws],
            _wbytes(dim, vocab) + (dim + vocab) * 4, 2 * dim * vocab, bw, int8_peak,
            rel_tol=1e-5))
        out.setdefault("q40_gemm_bf16", []).append(_shard_entry(
            torch, "q40_gemm_bf16", f"{shape}, 32 rows",
            [partial(q.q40_gemm_bf16, x32, w.q, w.d) for w in pw],
            [partial(q.q40_gemm_bf16_plain, x32, w.q, w.d) for w in pw],
            [partial(torch.matmul, x32.to(torch.bfloat16), w) for w in ws],
            _wbytes(dim, vocab) + 32 * (dim + vocab) * 4, 2 * 32 * dim * vocab, bw, bf16_peak,
            rel_tol=1e-4))
        del pw, ws
    # K3 at the shards' heads: t 32 and a pp 2 microbatch's 16 at position
    # 64 over the 256-row view, each of the chain's calls a layer's cache
    for label, nh, nkv, hd in (("1B tp2", 16, 4, 64), ("1B tp4", 8, 2, 64),
                               ("30B-A3B tp2", 16, 2, 128)):
        kc = torch.randn((L, 1, 256, nkv, hd), device="cuda", generator=gen).to(torch.bfloat16)
        vc = torch.randn((L, 1, 256, nkv, hd), device="cuda", generator=gen).to(torch.bfloat16)
        for t in (32, 16):
            qq = [torch.randn((1, t, nh, hd), device="cuda", generator=gen) for _ in range(L)]
            mask = (torch.arange(256, device="cuda")[None, :]
                    <= 64 + torch.arange(t, device="cuda")[:, None])
            sq = [x.to(torch.bfloat16).transpose(1, 2) for x in qq]
            sk = [kc[li].transpose(1, 2) for li in range(L)]
            sv = [vc[li].transpose(1, 2) for li in range(L)]
            visible = sum(64 + j + 1 for j in range(t))
            out.setdefault("flash_attention", []).append(_shard_entry(
                torch, "flash_attention", f"{label} heads {nh}/{nkv} hd {hd}, t {t} at 64 of 256",
                [partial(ca.flash_attention, qq[li], kc[li], vc[li], 64) for li in range(L)],
                [partial(ca.flash_attention_plain, qq[li], kc[li], vc[li], 64) for li in range(L)],
                [partial(F.scaled_dot_product_attention, sq[li], sk[li], sv[li], attn_mask=mask,
                         enable_gqa=True) for li in range(L)],
                2 * t * nh * hd * 4 + 2 * (64 + t) * nkv * hd * 2, 4 * nh * hd * visible,
                bw, bf16_peak, abs_tol=1e-2))
    # the 30B-A3B expert shards at ep 2 x tp 2: 64 local experts a layer,
    # w1/w3 2048 -> 384 and w2 384 (12 blocks) -> 2048; the chain's calls
    # index their layer's block of a flat [L * 64] stack
    c = QWEN3_30B_A3B
    E, k, dim, ff = c["n_experts"] // 2, c["n_active_experts"], c["dim"], c["moe_hidden_dim"] // 2
    stacks = {"w1": random_q40_stack(torch, gen, L * E, dim, ff),
              "w2": random_q40_stack(torch, gen, L * E, ff, dim)}
    idx = [(torch.randperm(E, device="cuda", generator=gen)[:k] + li * E).to(torch.int32)
           for li in range(L)]
    ins = {"w1": torch.randn((1, dim), device="cuda", generator=gen),
           "w2": torch.randn((k, ff), device="cuda", generator=gen)}
    for n, i, o in (("w1", dim, ff), ("w2", ff, dim)):
        sq_, sd_ = stacks[n]
        xw = ins[n]
        lws = [_dq(torch, sq_[ix.long()], sd_[ix.long()]) for ix in idx]
        lx = (xw.to(torch.bfloat16).expand(k, 1, i) if n == "w1"
              else xw.to(torch.bfloat16).unsqueeze(1))
        out.setdefault("q40_gemv_q80_indexed", []).append(_shard_entry(
            torch, "q40_gemv_q80_indexed", f"30B-A3B ep2 x tp2 {n} {i}->{o}, 8 slots of {E}",
            [partial(q.q40_gemv_q80_indexed, xw, sq_, sd_, ix) for ix in idx],
            [partial(q.q40_gemv_q80_indexed_plain, xw, sq_, sd_, ix) for ix in idx],
            [partial(torch.matmul, lx, lw) for lw in lws],
            k * _wbytes(i, o) + xw.shape[0] * i * 4 + k * o * 4, 2 * k * i * o, bw, int8_peak,
            rel_tol=1e-5))
        del lws
    rows = PREFILL_ROWS * k
    e_flat = torch.randint(0, E, (rows,), device="cuda", generator=gen, dtype=torch.int32)
    block_r = _grouped_block_rows(rows, E)
    dest, be, R_pad = _grouped_layout_direct(e_flat, E, block_r)
    bes = [be + li * E for li in range(L)]
    counts = torch.bincount(e_flat.long(), minlength=E)
    offs = torch.cumsum(counts, 0).to(torch.int32)
    hit = int((counts > 0).sum())
    for n, i, o in (("w1", dim, ff), ("w2", ff, dim)):
        sq_, sd_ = stacks[n]
        xp = torch.zeros((R_pad, i), dtype=torch.bfloat16, device="cuda")
        xp[dest] = torch.randn((rows, i), device="cuda", generator=gen).to(torch.bfloat16)
        lws = [_dq(torch, sq_[li * E:(li + 1) * E], sd_[li * E:(li + 1) * E]) for li in range(L)]
        lin = xp[dest[torch.argsort(e_flat, stable=True)]]
        if hasattr(torch, "_grouped_mm"):
            libs = [partial(torch._grouped_mm, lin, lw, offs=offs) for lw in lws]
        else:
            libs = [partial(torch.matmul, lin, lw[0]) for lw in lws]
        out.setdefault("q40_grouped_gemm_bf16", []).append(_shard_entry(
            torch, "q40_grouped_gemm_bf16",
            f"30B-A3B ep2 x tp2 {n} {i}->{o}, {rows} rows over {hit} of {E} experts, "
            f"block_r {block_r}",
            [partial(q.q40_grouped_gemm_bf16, xp, sq_, sd_, b_, block_r) for b_ in bes],
            [partial(q.q40_grouped_gemm_bf16_plain, xp, sq_, sd_, b_, block_r) for b_ in bes],
            libs, hit * _wbytes(i, o) + rows * i * 2 + rows * o * 4, 2 * rows * i * o, bw,
            bf16_peak, rel_tol=1e-4))
        del lws
    del stacks
    torch.cuda.empty_cache()
    return out


def mesh_prefill_logits(torch, eng, ids):
    """`prefill_logits` on any layout: a paged engine maps each chunk's
    pages first."""
    from distributed_llama_tpu_torch.runtime.engine import chunk_plan

    if eng.paged:
        plan = list(chunk_plan(len(ids), 0, eng.max_chunk, eng.cfg.seq_len))
        i, size, _ = plan[-1]
        eng._ensure_pages_all_rows(0, i + size)
    return prefill_logits(torch, eng, ids)


def _counted(torch, counters, fn):
    """fn() with every launch counter and the shard loop's collective
    counter set to 0 just before and read just after. Returns (fn's
    result, launches, collectives, wall seconds)."""
    from distributed_llama_tpu_torch.parallel.pipeline import COUNTS

    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    COUNTS.reset()
    t0 = time.perf_counter()
    res = fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    wall = time.perf_counter() - t0
    return res, {k.__name__: k.launches for k in counters}, COUNTS.snapshot(), wall


def _budget_check(torch, eng, ids) -> dict:
    """One 32-token chunk at position 0 against `collective_budget`."""
    from distributed_llama_tpu_torch.parallel.pipeline import (
        COUNTS, collective_budget, step_microbatches)

    eng.reset()
    kvb = eng._kv_bucket(32)
    pt = None
    if eng.paged:
        eng._ensure_pages_all_rows(0, 32)
        pt = eng._pt_operand()
    M = step_microbatches(eng.params, eng.cache, eng.batch // eng.mesh.dp, 32, 0, kvb, pt,
                          eng.page_size)
    COUNTS.reset()
    eng._forward(eng._tokens([ids[:32]] * eng.batch), 0, kv_len=kvb)
    got, want = COUNTS.snapshot(), collective_budget(eng.cfg, eng.mesh, M)
    assert got == want, f"collectives {got} against the budget {want}"
    eng.reset()
    return {"microbatches": M, **got}


def _first_parting(torch, solo, prompt, got, want, tol):
    """Where two greedy chains part, and the single device's top-2 margin
    there, which must be under `tol` (a near-tie the sums' order may
    flip). Returns (step or None, margin or None)."""
    first = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if first is None:
        return None, None
    n = len(prompt)
    feed = prompt[-1] if first == 0 else want[first - 1]
    top2 = torch.from_numpy(solo.decode_one(feed, n - 1 + first))[0].topk(2).values
    margin = (top2[0] - top2[1]).item()
    assert margin < tol, f"chains part at step {first} where the top-2 margin is {margin} >= {tol}"
    return first, margin


def mesh_phase(torch, mp: str, tp: str, counters) -> dict:
    """Phase 5i at Llama-3.2-1B width and depth: the library's meshes on
    this card (on distinct cards where there are as many). Gates, each on
    the card:
      * pp 2 equals the single device bit for bit: PROMPT's prefill logits,
        every chunk (32-token chunks in two microbatches), and 32 greedy
        tokens, contiguous and paged bf16;
      * tp 2 and pp 2 x tp 2: the last prompt row's logits within MESH_TOL
        of their scale, greedy tokens equal up to the first step whose
        single-device top-2 margin is under that bound;
      * generate_batch at batch 4 on dp 2 x tp 2 and a BatchSession at
        batch 4, paged, on pp 2 x tp 2: each row equals its run alone on
        the same mesh;
      * K1-stacked, B2, K2, B5 and K3 launched on each path, and one
        chunk's collectives equal to `collective_budget`.
    Reported, not gated: prefill and decode tok/s, and a profiled 16-step
    decode window (device-busy ms, launch calls a token, idle share) of the
    pp 2 x tp 2 mesh beside the single device. Returns {path: launches}."""
    from distributed_llama_tpu_torch.ops import cuda_attention as ca
    from distributed_llama_tpu_torch.ops import cuda_q40 as q
    from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    ids = Tokenizer(tp).encode(PROMPT)
    n = len(ids)
    steps = n - 1 + MESH_DECODE_STEPS
    dense = (q.q40_gemv_q80_stacked, q.q40_gemv_q80, q.q40_gemm_bf16_stacked, q.q40_gemm_bf16,
             ca.flash_attention)
    paths, report = {}, {"phase": "mesh", "model": "llama32_1b", "prompt_tokens": n,
                         "decode_tokens": MESH_DECODE_STEPS, "cards": torch.cuda.device_count(),
                         "section_s": {}}
    t_sec = [time.perf_counter()]

    def section(name):
        now = time.perf_counter()
        report["section_s"][name] = now - t_sec[0]
        t_sec[0] = now

    def run_path(eng):
        logits = mesh_prefill_logits(torch, eng, ids)
        eng.reset()
        return logits, eng.generate(ids, steps)

    # -- pp 2: the single device's numbers, bit for bit --------------------
    solos = {}
    for layout in ("contiguous", "paged"):
        kw = dict(max_seq_len=MESH_SEQ_LEN, kv_layout=layout)
        solo = InferenceEngine(mp, device="cuda", **kw)
        (want_logits, res1), _, _, _ = _counted(torch, counters, lambda: run_path(solo))
        solos[layout] = res1
        if layout == "paged":
            solo.close()
        else:
            solo_c = solo
        mesh, distinct = card_mesh(torch, pp=2)
        eng = InferenceEngine(mp, mesh=mesh, **kw)
        (got_logits, res), launches, coll, wall = _counted(torch, counters,
                                                           lambda: run_path(eng))
        bit = torch.equal(got_logits, want_logits)
        toks_equal = res.tokens[n:] == res1.tokens[n:]
        report[f"pp2 {layout}"] = {
            "distinct_cards": distinct, "prefill_logits_bit_equal": bit,
            "tokens_equal": toks_equal, "prefill_tok_s": (n - 1) / (res.prefill_us / 1e6),
            "decode_tok_s": MESH_DECODE_STEPS / (res.decode_us / 1e6),
            "solo_prefill_tok_s": (n - 1) / (res1.prefill_us / 1e6),
            "solo_decode_tok_s": MESH_DECODE_STEPS / (res1.decode_us / 1e6),
            "collectives": coll, "budget": _budget_check(torch, eng, ids), "launches": launches,
        }
        assert bit, f"pp 2 {layout}: prefill logits differ from the single device"
        assert toks_equal, f"pp 2 {layout}: greedy tokens differ from the single device"
        check_launched(launches, dense, f"the pp 2 {layout} mesh")
        paths[f"llama32_1b mesh pp2 {layout}"] = launches
        eng.close()
        del eng
        release(torch)

    section("pp2")

    # -- tp 2 and pp 2 x tp 2: within the bf16 bound -----------------------
    solo = solo_c
    solo.prefill(ids[:-1])
    l1 = torch.from_numpy(solo.decode_one(ids[-1], n - 1))
    want = solos["contiguous"].tokens[n:]
    scale = l1.abs().max().item()
    tol = MESH_TOL * scale
    for shape in (dict(tp=2), dict(pp=2, tp=2)):
        label = "x".join(f"{k}{v}" for k, v in shape.items())
        mesh, distinct = card_mesh(torch, **shape)
        eng = InferenceEngine(mp, mesh=mesh, max_seq_len=MESH_SEQ_LEN, kv_layout="contiguous")
        eng.prefill(ids[:-1])
        lg = torch.from_numpy(eng.decode_one(ids[-1], n - 1))
        assert torch.isfinite(lg).all() and lg.shape == l1.shape
        err = (lg - l1).abs().max().item()
        eng.reset()
        (_, res), launches, coll, wall = _counted(torch, counters, lambda: run_path(eng))
        got = res.tokens[n:]
        if got != want:
            solo.reset()
            solo.generate(ids, steps)  # the chain the margin is read along
        first, margin = _first_parting(torch, solo, ids, got, want, tol)
        report[label] = {
            "distinct_cards": distinct, "last_row_logits_max_abs_err": err, "tol": tol,
            "logits_scale": scale, "tokens_equal": first is None, "first_parting_step": first,
            "solo_top2_margin_there": margin,
            "prefill_tok_s": (n - 1) / (res.prefill_us / 1e6),
            "decode_tok_s": MESH_DECODE_STEPS / (res.decode_us / 1e6),
            "collectives": coll, "budget": _budget_check(torch, eng, ids), "launches": launches,
        }
        assert err <= tol, f"{label}: last-row logits differ by {err} > {tol}"
        check_launched(launches, dense, f"the {label} mesh")
        paths[f"llama32_1b mesh {label} contiguous"] = launches
        if shape == dict(pp=2, tp=2):
            # the mesh's decode window (the single device's graphed and
            # eager windows are phase 6's)
            at = [steps]
            tok = torch.tensor([got[-1]], device=eng.device)

            def window(n_steps=8):
                eng._decode_chunk(tok, at[0], n_steps)
                at[0] += n_steps

            prof = profile_window(torch, f"llama32_1b mesh {label} decode", window, 8)
            report[label]["profile"] = {k: prof[k] for k in AB_KEYS}
        eng.close()
        del eng
        release(torch)
    solo.close()
    release(torch)
    section("tp2, pp2xtp2")

    # -- generate_batch at batch 4 on dp 2 x tp 2 ---------------------------
    prompts = [ids[o : o + 81] for o in (0, 10, 20, 32)]
    nb = MESH_BATCH_STEPS
    mesh, distinct = card_mesh(torch, dp=2, tp=2)
    kw = dict(max_seq_len=MESH_SEQ_LEN, kv_layout="contiguous")
    eng = InferenceEngine(mp, mesh=mesh, batch=4, **kw)
    out, launches, coll, wall = _counted(torch, counters, lambda: eng.generate_batch(prompts, nb))
    eng.close()
    del eng
    one = InferenceEngine(mp, mesh=mesh, batch=2, **kw)
    equal = []
    for p, got in zip(prompts, out):
        one.reset()
        equal.append(one.generate(p, len(p) + nb).tokens[len(p) : len(p) + nb] == got)
    one.close()
    report["dp2xtp2 generate_batch 4"] = {"distinct_cards": distinct, "rows_equal_alone": equal,
                                          "wall_s": wall, "tok_s_upper": 4 * nb / wall,
                                          "collectives": coll, "launches": launches}
    assert all(equal), "dp 2 x tp 2 generate_batch rows differ from their runs alone"
    check_launched(launches, (q.q40_gemv_q80_stacked, q.q40_gemv_q80, q.q40_gemm_bf16_stacked,
                              ca.flash_attention), "the dp 2 x tp 2 generate_batch")
    paths["llama32_1b mesh dp2xtp2 generate_batch 4"] = launches
    release(torch)
    section("dp2xtp2 generate_batch")

    # -- a BatchSession at batch 4, paged, on pp 2 x tp 2 --------------------
    mesh, distinct = card_mesh(torch, pp=2, tp=2)
    eng = InferenceEngine(mp, mesh=mesh, batch=4, max_seq_len=MESH_SEQ_LEN, kv_layout="paged")
    sprompts = [ids[:16], ids[:48], ids[5:85], ids]

    def session(rows):
        s = BatchSession(eng)
        for r in rows:
            s.admit(r, sprompts[r])
        toks = {r: [] for r in rows}
        for _ in range(4):
            host = s.step(8)
            for r in rows:
                toks[r].extend(int(t) for t in host[r])
        for r in rows:
            s.release(r)
        return toks

    toks, launches, coll, wall = _counted(torch, counters, lambda: session(range(4)))
    alone = {r: session([r])[r] for r in range(4)}
    same = [alone[r] == toks[r] for r in range(4)]
    report["pp2xtp2 BatchSession 4 paged"] = {"distinct_cards": distinct, "rows_equal_alone": same,
                                              "wall_s": wall, "collectives": coll,
                                              "launches": launches}
    assert all(same), "pp 2 x tp 2 session rows differ from their runs alone"
    # an admission chunk runs its row alone at a scalar position: K3
    check_launched(launches, (q.q40_gemv_q80_stacked, q.q40_gemv_q80, q.q40_gemm_bf16_stacked,
                              ca.flash_attention), "the pp 2 x tp 2 session")
    paths["llama32_1b mesh pp2xtp2 batch_session 4 paged"] = launches
    eng.close()
    del eng
    release(torch)
    section("pp2xtp2 session")
    log(json.dumps(report))
    return paths


def mesh_moe_reference(torch, eng, ids) -> dict:
    """The single device's side of `mesh_moe_phase`, from an engine on the
    same file (phase 5b's at Qwen3-30B-A3B width): PROMPT's prefill logits,
    MESH_MOE_DECODE_STEPS greedy tokens and each step's top-2 margin, so the
    engine can close before the mesh's is built."""
    n = len(ids)
    logits = prefill_logits(torch, eng, ids)
    eng.reset()
    res = eng.generate(ids, n - 1 + MESH_MOE_DECODE_STEPS)
    toks = res.tokens[n:]
    eng.reset()
    eng.prefill(ids[:-1])
    margins, feed = [], ids[-1]
    for j, t in enumerate(toks):
        top2 = torch.from_numpy(eng.decode_one(feed, n - 1 + j))[0].topk(2).values
        margins.append((top2[0] - top2[1]).item())
        feed = t
    eng.reset()
    return {"logits": logits, "tokens": toks, "margins": margins, "res": res}


def mesh_moe_phase(torch, mp: str, tp: str, counters, ref: dict) -> dict:
    """Phase 5i at Qwen3-30B-A3B width (MOE_PATH_LAYERS deep) on ep 2 x tp 2 (each
    ep shard 64 experts, each tp shard 384 of an expert's 768 columns),
    against `mesh_moe_reference`: PROMPT's prefill logits within MESH_TOL of
    their scale, MESH_MOE_DECODE_STEPS greedy tokens equal up to the first
    step whose single-device top-2 margin is under that bound, and K4 and
    K1-indexed launched on the local expert stacks. Returns {path:
    launches}."""
    from distributed_llama_tpu_torch.ops import cuda_q40 as q
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    t0 = time.perf_counter()
    ids = Tokenizer(tp).encode(PROMPT)
    n = len(ids)
    steps = n - 1 + MESH_MOE_DECODE_STEPS
    mesh, distinct = card_mesh(torch, ep=2, tp=2)
    eng = InferenceEngine(mp, mesh=mesh, max_seq_len=MESH_SEQ_LEN, kv_layout="contiguous")
    load_s = time.perf_counter() - t0

    def run():
        logits = prefill_logits(torch, eng, ids)
        eng.reset()
        return logits, eng.generate(ids, steps)

    (got_logits, res), launches, coll, wall = _counted(torch, counters, run)
    want_logits, res1 = ref["logits"], ref["res"]
    scale = want_logits.abs().max().item()
    tol = MESH_TOL * scale
    err = (got_logits - want_logits).abs().max().item()
    got = res.tokens[n:]
    first = next((j for j, (a, b) in enumerate(zip(got, ref["tokens"])) if a != b), None)
    margin = ref["margins"][first] if first is not None else None
    summary = {
        "phase": "mesh", "model": "qwen3_30b_a3b", "layers": eng.cfg.n_layers,
        "mesh": "ep2xtp2", "distinct_cards": distinct, "prompt_tokens": n,
        "decode_tokens": MESH_MOE_DECODE_STEPS, "prefill_logits_max_abs_err": err, "tol": tol,
        "logits_scale": scale, "tokens_equal": first is None, "first_parting_step": first,
        "solo_top2_margin_there": margin,
        "prefill_tok_s": (n - 1) / (res.prefill_us / 1e6),
        "decode_tok_s": MESH_MOE_DECODE_STEPS / (res.decode_us / 1e6),
        "solo_prefill_tok_s": (n - 1) / (res1.prefill_us / 1e6),
        "solo_decode_tok_s": MESH_MOE_DECODE_STEPS / (res1.decode_us / 1e6),
        "collectives": coll, "budget": _budget_check(torch, eng, ids), "launches": launches,
        "load_and_cut_s": load_s, "seconds": time.perf_counter() - t0,
    }
    log(json.dumps(summary))
    assert err <= tol, f"30B-A3B ep 2 x tp 2: prefill logits differ by {err} > {tol}"
    assert margin is None or margin < tol, \
        f"30B-A3B ep 2 x tp 2 parts at step {first} where the top-2 margin is {margin} >= {tol}"
    check_launched(launches, (q.q40_grouped_gemm_bf16, q.q40_gemv_q80_indexed,
                              q.q40_gemm_bf16_stacked, q.q40_gemv_q80_stacked,
                              q.q40_gemm_bf16, q.q40_gemv_q80),
                   "the 30B-A3B ep 2 x tp 2 mesh")
    eng.close()
    del eng
    release(torch)
    return {"qwen3_30b_a3b mesh ep2xtp2 contiguous": launches}


def mesh_only(torch, rates) -> int:
    """`--mesh`: phase 5i alone (its kernel table, the 1B and 30B-A3B
    meshes), after phases 1-2."""
    from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    counters = (*cuda_q40.KERNELS, *cuda_attention.KERNELS)
    t0 = time.perf_counter()
    log(json.dumps({"phase": "mesh_kernels", "shard_shapes": shard_shape_checks(torch, rates),
                    "seconds": time.perf_counter() - t0}))
    release(torch)
    mp, tp, _, _ = synthetic_model("llama32_1b", LLAMA32_1B)
    paths = mesh_phase(torch, mp, tp, counters)
    Path(mp).unlink()
    moe_kw = dict(QWEN3_30B_A3B, arch=QWEN3_MOE_ARCH, n_layers=MOE_PATH_LAYERS)
    mp, tp, _, _ = synthetic_model("qwen3_30b_a3b", moe_kw, norm_epsilon=QWEN3_NORM_EPS)
    eng = spec_engine(mp, kv_layout="contiguous")
    ref = mesh_moe_reference(torch, eng, Tokenizer(tp).encode(PROMPT))
    eng.close()
    del eng
    release(torch)
    paths.update(mesh_moe_phase(torch, mp, tp, counters, ref))
    log(json.dumps({"phase": "mesh_launches", "launches": paths}))
    return 0


# ---------------------------------------------------------------------------
# phase 5b: graphed decode against eager decode
# ---------------------------------------------------------------------------

# a trace decodes from a GRAPH_CONTEXT-token context: 64 greedy steps across
# the 256 kv bucket, then a sampled chunk of each arm, the top-p arm and the
# full distribution (steps, temperature, top-p, seed). The eager arm runs
# ~7 (30B-A3B) to ~37 (1B) tok/s: the 1B traces took 160 greedy steps from
# PROMPT's end and sampled chunks of 32 and 16 until phase 5g came (the
# 30B-A3B's until phase 5e), cut to keep the script's time
GRAPH_CONTEXT = 200
GRAPH_CHUNKS = (32, 32)
GRAPH_SAMPLED = ((16, 0.8, 0.9, 1234), (8, 0.8, 1.0, 1235))


def decode_trace(torch, eng, ids, greedy=GRAPH_CHUNKS, sampled=GRAPH_SAMPLED):
    """ids[:-1] prefilled, then the `greedy` chunks (GRAPH_CHUNKS) and the
    `sampled` ones (GRAPH_SAMPLED) through the engine's chunk step, eager
    or graphed as `eng.cuda_graphs` says. Returns (host tokens [b, steps],
    each chunk's last logits, decode seconds)."""
    from distributed_llama_tpu_torch.tokenizer import Sampler

    eng.reset()
    eng.prefill(ids[:-1])
    pos = len(ids) - 1
    tok = eng._tokens([ids[-1]] * eng.batch)
    chunks = [(n, 0.0, 0.9, None) for n in greedy]
    chunks += [(n, t, p, Sampler(eng.cfg.vocab_size, t, p, seed)) for n, t, p, seed in sampled]
    toks, logits = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n, t, topp, sampler in chunks:
        out, tok = eng._decode_chunk(tok, pos, n, t, topp, eng._generator(sampler))
        toks.append(out.cpu())
        logits.append(eng.last_logits.clone())
        pos += n
    return torch.cat(toks, dim=1), logits, time.perf_counter() - t0


def graph_vs_eager(torch, name: str, eng, ids, **chunks) -> dict:
    """`decode_trace` (its `chunks`) eagerly, then graphed (captures
    included) on the same engine: tokens and every chunk's last logits
    equal bit for bit."""
    runs = {}
    for graphs in (False, True):
        eng.cuda_graphs = graphs
        runs[graphs] = decode_trace(torch, eng, ids, **chunks)
    (te, le, se), (tg, lg, sg) = runs[False], runs[True]
    n = te.shape[1] * te.shape[0]
    out = {"phase": "graphed_decode", "setup": name, "decode_steps": te.shape[1],
           "batch": te.shape[0], "tokens_equal": torch.equal(te, tg),
           "logits_equal": all(torch.equal(a, b) for a, b in zip(le, lg)),
           "eager_tok_s": n / se, "graphed_tok_s_captures_included": n / sg,
           "graphs": eng.graph_stats()}
    log(json.dumps(out))
    assert out["tokens_equal"], f"{name}: graphed decode tokens differ from eager"
    assert out["logits_equal"], f"{name}: graphed decode logits differ from eager"
    return out


def pinned_trace(torch, name: str, eng, ids, session: bool) -> dict:
    """warmup(), then a prompt whose decode crosses the 256 and 512 kv
    buckets (streamed, so the TTFT ramp's chunk too) and, with `session`,
    a BatchSession admit/step/release cycle with a sampled row: 0
    recaptures after warmup."""
    from distributed_llama_tpu_torch.runtime.batch_session import BatchSession

    eng.cuda_graphs = True
    before = torch.cuda.memory_reserved()
    stats = eng.warmup()
    reserved = torch.cuda.memory_reserved() - before
    prompt = (ids * 2)[:200]
    eng.generate(prompt, 600, on_token=lambda t: None)
    if session:
        s = BatchSession(eng)
        s.admit(0, ids, temperature=0.7, seed=5)
        s.admit(3, ids[:40])
        s.step(8)
        s.step(64)
        s.release(0)
        s.step(8)
        s.release(3)
    after = eng.graph_stats()
    out = {"phase": "graph_warmup", "setup": name, "warmup_s": stats["warmup_seconds"],
           "captures": stats["captures"], "graph_pool_bytes": stats["pool_bytes"],
           "reserved_bytes_added_by_warmup": reserved,
           "recaptures_after_warmup": after["recaptures_after_warmup"],
           "launches_per_replay": stats["launches_per_replay"]}
    log(json.dumps(out))
    assert after["recaptures_after_warmup"] == 0, f"{name}: a capture after warmup"
    return out


def graphed_batch_session(torch, name: str, eng, ids) -> dict:
    """The batch-16 paged int8 BatchSession eagerly and graphed: 16 rows,
    16 greedy 8-step chunks (32 until phase 5g came, cut to keep the
    script's time) with four rows re-admitted at chunk 8, then
    four rows re-admitted sampled (seeded) for one chunk at top-p 0.9 and
    one at 1.0 (each sampling arm); every chunk's tokens and last logits
    equal bit for bit."""
    from distributed_llama_tpu_torch.runtime.batch_session import BatchSession

    b, chunk, n_chunks, swap_at = 16, 8, 16, 8
    prompts = [ids[: 16 + (len(ids) - 16) * i // (b - 1)] for i in range(b)]
    swapped = (2, 6, 10, 14)
    runs = {}
    for graphs in (False, True):
        eng.cuda_graphs = graphs
        s = BatchSession(eng)
        for r in range(b):
            s.admit(r, prompts[r])
        toks, logits = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(n_chunks + 2):
            if c >= n_chunks or c == swap_at:
                for j, r in enumerate(swapped):
                    s.release(r)
                    s.admit(r, ids[10 + 5 * j : 34 + 25 * j],
                            temperature=0.8 if c >= n_chunks else 0.0,
                            topp=1.0 if c > n_chunks else 0.9, seed=100 + j)
            toks.append(s.step(chunk))
            logits.append(eng.last_logits.clone())
        runs[graphs] = (toks, logits, time.perf_counter() - t0)
    (te, le, se), (tg, lg, sg) = runs[False], runs[True]
    out = {"phase": "graphed_decode", "setup": name,
           "decode_steps": chunk * (n_chunks + 2), "batch": b,
           "tokens_equal": all((a == g).all() for a, g in zip(te, tg)),
           "logits_equal": all(torch.equal(a, g) for a, g in zip(le, lg)),
           "eager_s": se, "graphed_s_captures_included": sg, "graphs": eng.graph_stats()}
    log(json.dumps(out))
    assert out["tokens_equal"], "batch-16 session: graphed tokens differ from eager"
    assert out["logits_equal"], "batch-16 session: graphed logits differ from eager"
    return out


def graphed_decode_phase(torch, mp: str, tp: str, model: str, eng=None) -> None:
    """Phase 5b at one model's width: graphed against eager decode, then the
    warm ladder's pinned trace. Llama-3.2-1B: batch 1 contiguous, paged
    bf16 and paged int8, and the batch-16 paged int8 BatchSession;
    Qwen3-30B-A3B: batch 1 contiguous on `eng` (a `spec_engine`, with
    speculation off), then phase 5d's part there; `eng` stays open for
    phase 5i's reference. At Llama-3.2-1B width returns the batch-16
    engine, open, for phase 5f."""
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    ids = Tokenizer(tp).encode(PROMPT)
    kw = dict(max_seq_len=MAX_SEQ_LEN, device="cuda")
    if model == "qwen3_30b_a3b":
        graph_vs_eager(torch, f"{model} batch 1 contiguous", eng, (ids * 2)[:GRAPH_CONTEXT])
        pinned_trace(torch, f"{model} batch 1 contiguous", eng, ids, session=False)
        spec_moe(torch, eng, ids)
        return
    for layout, kv in (("contiguous", None), ("paged", None), ("paged", "int8")):
        name = f"{model} batch 1 {layout} {kv or 'bf16'}"
        eng = InferenceEngine(mp, kv_layout=layout, cache_dtype=kv, **kw)
        graph_vs_eager(torch, name, eng, (ids * 2)[:GRAPH_CONTEXT])
        if kv == "int8":
            pinned_trace(torch, name, eng, ids, session=False)
        eng.close()
        del eng
        release(torch)
    eng = InferenceEngine(mp, batch=16, kv_layout="paged", cache_dtype="int8", **kw)
    graphed_batch_session(torch, f"{model} batch_session 16 paged int8", eng, ids)
    pinned_trace(torch, f"{model} batch 16 paged int8", eng, ids, session=True)
    return eng


# ---------------------------------------------------------------------------
# phase 5f: observability (StepStats, request traces, the stall watchdog)
# ---------------------------------------------------------------------------

# the traced generate: a 64-step plain chunk from PROMPT's end (which drafts
# nothing), then ngram k 4 verify rounds
OBS_DECODE_STEPS = 128
# the stalled generate: a 16-step chunk, then an 8-step one behind the spin
OBS_STALL_STEPS = 24
OBS_STALL_S = 0.5
GUARD_CALLS = 10_000
# what a traced generate that hits the prefix cache and speculates must
# record, by the JAX engine's names (tests/test_torch_telemetry.py holds
# the port's to the JAX engine's on the CPU)
OBS_COUNTERS = ("prefix_hits", "prefix_hit_tokens", "prefix_misses", "prefix_inserts",
                "spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
                "spec_rejected_tokens")
OBS_GAUGES = ("prefill_dispatch_overlap_pct", "prefix_cache_bytes", "prefix_cache_entries",
              "spec_acceptance_rate")


def counted_run(torch, counters, run):
    """run() with each kernel counter's gain and the CUDA graph replays it
    made: (its result, {kernel: launches}, replays)."""
    replays = [0]
    replay = torch.cuda.CUDAGraph.replay

    def counting(graph):
        replays[0] += 1
        return replay(graph)

    torch.cuda.synchronize()
    before = {k.__name__: k.launches for k in counters}
    torch.cuda.CUDAGraph.replay = counting
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        torch.cuda.CUDAGraph.replay = replay
    return out, {k.__name__: k.launches - before[k.__name__] for k in counters}, replays[0]


def series_gain(before: dict, after: dict) -> dict:
    """{series: count} that a run added to a StepStats snapshot."""
    reserved = ("counters", "gauges", "histograms")
    return {k: v["count"] - before.get(k, {"count": 0})["count"]
            for k, v in after.items() if k not in reserved
            and v["count"] != before.get(k, {"count": 0})["count"]}


def spin_cycles(torch, seconds: float) -> int:
    """The `torch.cuda._sleep` cycles of `seconds` of device spin on this
    card, from one timed spin of 1e8 cycles."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    torch.cuda.synchronize()
    return int(1e8 * seconds * 1e3 / start.elapsed_time(end))


def traced_generate(torch, eng, ids, counters) -> dict:
    """A greedy generate that hits the prefix cache and speculates at k 4,
    untraced and then traced: tokens, kernel launches and graph replays
    equal; the trace's spans in the JAX engine's order and their counts
    those of the StepStats series the run added."""
    from distributed_llama_tpu_torch.runtime import tracing

    steps = len(ids) - 1 + OBS_DECODE_STEPS

    def gen(trace):
        eng.reset()
        eng.trace = trace
        try:
            return eng.generate(ids, steps).tokens
        finally:
            eng.trace = None

    plain, l_plain, r_plain = counted_run(torch, counters, lambda: gen(None))
    tid = tracing.mint_trace_id()
    before = eng.stats.snapshot()
    traced, l_traced, r_traced = counted_run(
        torch, counters, lambda: gen(tracing.TRACER.start(tid, sampled=True)))
    after = eng.stats.snapshot()
    gain = series_gain(before, after)
    names = [e[1] for e in tracing.TRACER.for_trace(tid)]
    n_chunks = sum(n for k, n in gain.items() if k.startswith("prefill_dispatch["))
    head = ["prefix_match", "prefix_splice"] + ["prefill_chunk"] * n_chunks + [
        "prefill_sync", "prefill"]
    tail = names[len(head):]
    out = {"phase": "observability", "setup": "llama32_1b batch 1 contiguous ngram k 4 prefix hit",
           "tokens_equal": traced == plain, "launches_equal": l_traced == l_plain,
           "graph_replays": [r_plain, r_traced], "kernel_launches": sum(l_traced.values()),
           "decode_tokens": OBS_DECODE_STEPS, "event_names": names, "series_added": gain,
           "counters": after["counters"], "gauges": sorted(after["gauges"]),
           "last_prefill_timing": eng.last_prefill_timing}
    log(json.dumps(out))
    assert out["tokens_equal"], "a traced generate gave other tokens"
    assert out["launches_equal"] and r_traced == r_plain, "a traced generate launched otherwise"
    assert names[: len(head)] == head, f"trace head {names[: len(head)]} != {head}"
    assert set(tail) <= {"spec_round", "decode_chunk"} and tail.count("spec_round") > 0, tail
    assert tail.count("spec_round") == gain.get("spec_verify[4]", 0), (tail, gain)
    assert tail.count("decode_chunk") == sum(
        n for k, n in gain.items() if k.startswith("decode[")), (tail, gain)
    assert gain.get("prefill_sync") == 1 and n_chunks >= 1, gain
    assert all(after["counters"].get(c, 0) > 0 for c in OBS_COUNTERS), after["counters"]
    assert set(OBS_GAUGES) <= set(after["gauges"]), after["gauges"]
    return out


def traced_session(torch, eng16, ids, counters) -> dict:
    """A batch-16 BatchSession (phase 5b's paged int8 engine), row 0
    admitted with a trace, two 8-step chunks; untraced, then traced: tokens,
    kernel launches and graph replays equal; one prefill_chunk span a chunk
    of row 0's admission, and a batch_decode[8] series entry a step."""
    import numpy as np

    from distributed_llama_tpu_torch.runtime import tracing
    from distributed_llama_tpu_torch.runtime.batch_session import BatchSession

    b = eng16.batch
    prompts = [ids] + [ids[: 16 + (len(ids) - 16) * i // (b - 1)] for i in range(1, b)]

    def session(trace):
        s = BatchSession(eng16)
        for r in range(b):
            s.admit(r, prompts[r], trace=trace if r == 0 else None)
        return [s.step(8) for _ in range(2)]

    plain, l_plain, r_plain = counted_run(torch, counters, lambda: session(None))
    tid = tracing.mint_trace_id()
    before = eng16.stats.snapshot()
    traced, l_traced, r_traced = counted_run(
        torch, counters, lambda: session(tracing.TRACER.start(tid, sampled=True)))
    gain = series_gain(before, eng16.stats.snapshot())
    names = [e[1] for e in tracing.TRACER.for_trace(tid)]
    n_chunks = len(list(range(0, len(ids) - 1, eng16.max_chunk)))
    out = {"phase": "observability", "setup": "llama32_1b batch_session 16 paged int8",
           "tokens_equal": all(np.array_equal(a, t) for a, t in zip(plain, traced)),
           "launches_equal": l_traced == l_plain, "graph_replays": [r_plain, r_traced],
           "event_names": names, "series_added": gain}
    log(json.dumps(out))
    assert out["tokens_equal"], "a traced session gave other tokens"
    assert out["launches_equal"] and r_traced == r_plain, "a traced session launched otherwise"
    assert names == ["prefill_chunk"] * n_chunks, names
    assert gain.get("batch_decode[8]") == 2, gain
    return out


def guard_cost(eng) -> dict:
    """The stall watchdog's host cost: the mean of GUARD_CALLS calls of
    enter plus exit of one guard, and of the engine's `_guard` (a guard
    made, entered and left, as every chunk and round makes one)."""
    from distributed_llama_tpu_torch.runtime.telemetry import watchdog

    wd = watchdog("decode[64]", stats=eng.stats)
    t0 = time.perf_counter()
    for _ in range(GUARD_CALLS):
        with wd:
            pass
    enter_exit = (time.perf_counter() - t0) / GUARD_CALLS * 1e6
    key = ("decode", 64, 256, "greedy")
    t0 = time.perf_counter()
    for _ in range(GUARD_CALLS):
        with eng._guard("decode[64]", key):
            pass
    made = (time.perf_counter() - t0) / GUARD_CALLS * 1e6
    out = {"phase": "guard_cost", "calls": GUARD_CALLS, "enter_exit_us": enter_exit,
           "engine_guard_us": made}
    log(json.dumps(out))
    return out


def stall_check(torch, eng, ids) -> dict:
    """A stall on the card: OBS_STALL_S of device spin (`torch.cuda._sleep`)
    enqueued on the engine's stream before the second graphed decode chunk
    of a greedy generate, with DLT_STALL_LOG_MS 100 and DLT_STALL_TIMEOUT_MS
    300 for that call only: one `[EXEC_STALL]` line, StallError once the
    fetch returns, a flight record with the request's decode_chunk span and
    the watchdog_stall event, both counters up by one; then `reset()` and
    the same generate gives the tokens of before, with 0 recaptures."""
    import os

    from distributed_llama_tpu_torch.runtime import tracing
    from distributed_llama_tpu_torch.runtime.telemetry import StallError

    steps = len(ids) - 1 + OBS_STALL_STEPS
    eng.set_speculation("off")
    eng.reset()
    want = eng.generate(ids, steps).tokens
    cycles = spin_cycles(torch, OBS_STALL_S)
    chunk = eng._decode_chunk
    calls = []

    def stalled(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            torch.cuda._sleep(cycles)
        return chunk(*args, **kw)

    env = {"DLT_STALL_LOG_MS": "100", "DLT_STALL_TIMEOUT_MS": "300", "DLT_FLIGHTREC_DIR": ""}
    saved = {k: os.environ.get(k) for k in env}
    c0 = eng.stats.counters_snapshot()
    tid = tracing.mint_trace_id()
    err = io.StringIO()
    raised = None
    eng.reset()
    eng.trace = tracing.TRACER.start(tid, sampled=True)
    eng._decode_chunk = stalled
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            eng.generate(ids, steps)
    except StallError as e:
        raised = str(e)
    finally:
        wall = time.perf_counter() - t0
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        del eng._decode_chunk
        eng.trace = None
    c1 = eng.stats.counters_snapshot()
    rec = tracing.last_flight_record()
    lines = err.getvalue().strip().split("\n")
    events = [(e["trace_id"], e["name"]) for e in rec["events"]] if rec else []
    eng.reset()
    again = eng.generate(ids, steps).tokens
    out = {"phase": "stall", "spin_s": OBS_STALL_S, "spin_cycles": cycles, "wall_s": wall,
           "raised": raised, "stderr": lines, "flight_record_reason": rec and rec["reason"],
           "request_spans_in_record": [n for t, n in events if t == tid],
           "counters_added": {k: c1.get(k, 0) - c0.get(k, 0)
                              for k in ("exec_stall_logged", "exec_stall_timeout")},
           "tokens_after_reset_equal": again == want,
           "recaptures_after_warmup": eng.graph_stats()["recaptures_after_warmup"]}
    log(json.dumps(out))
    assert raised == "decode[8] exceeded 300 ms", out
    assert sum("⏳ [EXEC_STALL] decode[8] exceeded 100 ms" in l for l in lines) == 1, lines
    assert sum("[EXEC_STALL]" in l for l in lines) == 2, lines  # the log and the timeout
    assert rec["reason"] == "stall:decode[8]", rec["reason"]
    assert "decode_chunk" in out["request_spans_in_record"], out
    assert ("", "watchdog_stall") in events
    assert out["counters_added"] == {"exec_stall_logged": 1, "exec_stall_timeout": 1}, out
    assert out["tokens_after_reset_equal"] and out["recaptures_after_warmup"] == 0, out
    return out


def observability_phase(torch, mp: str, tp: str, counters, expected, eng16) -> dict:
    """Phase 5f at Llama-3.2-1B width, counted as one path: a batch-1
    contiguous engine with a 64 MB prefix cache and ngram speculation at
    k 4, after `warmup()` and a cold generate that publishes PROMPT:
    `traced_generate`, `guard_cost`, `stall_check`; then
    `traced_session` on phase 5b's batch-16 paged int8 engine `eng16`.
    Returns the path's launches."""
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    ids = Tokenizer(tp).encode(PROMPT)
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    eng = InferenceEngine(mp, max_seq_len=MAX_SEQ_LEN, device="cuda", prefix_cache_mb=64,
                          speculative="ngram", draft_k=4)
    eng.warmup()
    eng.generate(ids, len(ids) - 1 + OBS_DECODE_STEPS)  # publishes PROMPT and its reply
    traced_generate(torch, eng, ids, counters)
    guard_cost(eng)
    stall_check(torch, eng, ids)
    eng.close()
    del eng
    release(torch)
    traced_session(torch, eng16, ids, counters)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    check_launched(launches, expected, "the observability phase")
    return launches


# ---------------------------------------------------------------------------
# phase 5c: the prefix cache
# ---------------------------------------------------------------------------

PREFIX_HEAD_TOKENS = 1024  # the shared head: a multiple of the 32-row chunk
PREFIX_TAIL_TOKENS = 64
PREFIX_DECODE = 64
# the batch-16 session's admissions (16 until phase 5g came: the cold arm's
# 16 prefills of 1,088 tokens took ~20 s, cut to keep the script's time)
PREFIX_SESSION_ROWS = 8
# the 24-token head resumes at 16, below one chunk: its chunks take other
# shapes than the cold run's (an 8-row tail takes K1's Q80 arm), so its
# first logits are held to this share of the cold logits' largest value
PREFIX_SUBCHUNK_TOL = 0.05


def prefix_prompts(vocab: int) -> dict:
    """Token prompts from seed 0: the 1,024-token head with four 64-token
    tails (head + tail 0 publishes, tail 1 hits, tails 2-3 are the pool's
    other heads' tails), two other heads for the tight pool, a 24-token
    head, and 16 session tails."""
    import numpy as np

    rng = np.random.default_rng(0)

    def toks(n):
        return [int(t) for t in rng.integers(3, vocab, size=n)]

    head = toks(PREFIX_HEAD_TOKENS)
    return {
        "publish": head + toks(PREFIX_TAIL_TOKENS),
        "hit": head + toks(PREFIX_TAIL_TOKENS),
        "head24": head[:24] + toks(PREFIX_TAIL_TOKENS),
        "others": [toks(PREFIX_HEAD_TOKENS + PREFIX_TAIL_TOKENS) for _ in range(2)],
        "session": [head + toks(PREFIX_TAIL_TOKENS) for _ in range(16)],
    }


def timed_prefill(torch, eng, ids, counters):
    """`ids[:-1]` prefilled (no publish) with the launch counters zeroed
    just before, then the decode step on the last token. Returns (prefill
    ms, the prefill's launches, host logits of the first generated token)."""
    torch.cuda.synchronize()
    before = {k.__name__: k.launches for k in counters}
    t0 = time.perf_counter()
    eng.prefill(ids[:-1], publish=False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k.__name__: k.launches - before[k.__name__] for k in counters}
    return ms, launches, eng.decode_one(ids[-1], len(ids) - 1)


def prefix_layout(torch, mp: str, prompts: dict, counters, layout: str, kv) -> dict:
    """One batch-1 layout: an engine with a 512 MB cache against one with
    the cache off. The cold engine's first prefill warms it; then the hit
    prompt's prefill is timed on both (the cached engine resumes at 1,024
    after the publish prompt's prefill), its first logits and 64 graphed
    greedy tokens equal bit for bit; the 24-token head within
    PREFIX_SUBCHUNK_TOL. Paged int8 also runs the tight pool (two more
    heads through a 45 MB pool: reclaim must evict) and warmup() then hits
    with 0 recaptures."""
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine

    kw = dict(max_seq_len=MAX_SEQ_LEN, device="cuda", kv_layout=layout, cache_dtype=kv)
    tight = layout == "paged" and kv == "int8"
    t0 = time.perf_counter()
    cold = InferenceEngine(mp, prefix_cache_mb=0, **kw)
    eng = InferenceEngine(mp, prefix_cache_mb=512, kv_pool_mb=45 if tight else None, **kw)
    load_s = time.perf_counter() - t0
    hit, n = prompts["hit"], PREFIX_DECODE

    def tokens(e, ids):
        """n greedy tokens after `ids`, from a reset."""
        e.reset()
        return e.generate(ids, len(ids) + n - 1).tokens[len(ids):]

    cold.prefill(prompts["publish"][:-1])  # warms the cold engine's ladder
    cold.reset()
    eng.prefill(prompts["publish"][:-1])  # cold, and publishes the head
    eng.reset()
    cold_ms, cold_launches, want_logits = timed_prefill(torch, cold, hit, counters)
    hit_ms, hit_launches, got_logits = timed_prefill(torch, eng, hit, counters)
    hit_tokens = eng.last_prefix_hit_tokens
    want, got = tokens(cold, hit), tokens(eng, hit)
    gen_hit = eng.last_prefix_hit_tokens
    out = {"phase": "prefix_cache", "setup": f"llama32_1b batch 1 {layout} {kv or 'bf16'}",
           "engines_load_s": load_s, "head_tokens": PREFIX_HEAD_TOKENS,
           "prompt_tokens": len(hit), "cold_prefill_ms": cold_ms, "hit_prefill_ms": hit_ms,
           "last_prefix_hit_tokens": hit_tokens, "generate_hit_tokens": gen_hit,
           "first_logits_equal": bool((got_logits == want_logits).all()),
           "tokens_equal": got == want, "decode_tokens": len(got),
           "cold_prefill_launches": {k: v for k, v in cold_launches.items() if v},
           "hit_prefill_launches": {k: v for k, v in hit_launches.items() if v}}
    # the 24-token head: boundary 16
    eng.reset()
    cold.reset()
    _, _, got24 = timed_prefill(torch, eng, prompts["head24"], counters)
    out["head24_hit_tokens"] = eng.last_prefix_hit_tokens
    _, _, want24 = timed_prefill(torch, cold, prompts["head24"], counters)
    scale = float(abs(want24).max())
    out["head24_max_abs_err"] = float(abs(got24 - want24).max())
    out["head24_logits_scale"] = scale
    out["head24_bit_equal"] = bool((got24 == want24).all())
    out["head24_argmax_equal"] = int(got24[0].argmax()) == int(want24[0].argmax())
    if tight:
        # two more 1,088-token heads: the third request needs pages only
        # an eviction frees
        for ids in prompts["others"]:
            got_o = tokens(eng, ids[: PREFIX_HEAD_TOKENS + 1])
        out["tight_pool_pages"] = eng.page_pool.n_pages
        out["tight_pool_after_eviction_equal"] = got_o == tokens(
            cold, prompts["others"][-1][: PREFIX_HEAD_TOKENS + 1])
        out["tight_pool_evictions"] = eng.prefix_cache.counters["prefix_evictions"]
        # warmup() clears the cache; then a publish, a hit and a 24-token
        # head, with 0 captures after it
        eng.warmup()
        entries_after_warmup = eng.prefix_cache.n_entries
        tokens(eng, prompts["publish"])
        warm_hit = tokens(eng, hit)
        out["warmup_hit_tokens"] = eng.last_prefix_hit_tokens
        tokens(eng, prompts["head24"])
        out["warmup"] = {"entries_after": entries_after_warmup,
                         "hit_tokens_equal": warm_hit == want,
                         "recaptures_after_warmup": eng.graph_stats()["recaptures_after_warmup"]}
    out["counters"] = dict(eng.prefix_cache.counters)
    out["cache"] = eng.prefix_cache.stats_snapshot()
    log(json.dumps(out))
    assert hit_tokens == gen_hit == PREFIX_HEAD_TOKENS, f"{out['setup']}: hit {hit_tokens}"
    assert out["first_logits_equal"], f"{out['setup']}: hit logits differ from cold"
    assert out["tokens_equal"] and len(got) == n, f"{out['setup']}: hit tokens differ from cold"
    assert out["head24_hit_tokens"] == 16, out["head24_hit_tokens"]
    assert out["head24_max_abs_err"] <= PREFIX_SUBCHUNK_TOL * scale, out["head24_max_abs_err"]
    if tight:
        assert out["tight_pool_evictions"] >= 1, "the tight pool never evicted"
        assert out["tight_pool_after_eviction_equal"], "tight pool: tokens differ from cold"
        assert entries_after_warmup == 0 and out["warmup_hit_tokens"] == PREFIX_HEAD_TOKENS
        assert out["warmup"]["hit_tokens_equal"], "hit after warmup differs from cold"
        assert out["warmup"]["recaptures_after_warmup"] == 0, "a capture after warmup"
    cold.close()
    eng.close()
    return out


def prefix_session(torch, mp: str, prompts: dict) -> dict:
    """A batch-16 paged int8 BatchSession after warmup(): PREFIX_SESSION_ROWS
    admissions of the head with their own tails (the first publishes at
    arming, the others hit at 1,024), 64 greedy steps; every row's tokens and the last
    logits equal the same admissions on an engine with the cache off, and
    0 captures after warmup."""
    import numpy as np

    from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine

    kw = dict(max_seq_len=MAX_SEQ_LEN, device="cuda", batch=16, kv_layout="paged",
              cache_dtype="int8")
    runs = {}
    for mb in (512, 0):
        eng = InferenceEngine(mp, prefix_cache_mb=mb, **kw)
        if mb:
            eng.warmup()
        s = BatchSession(eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumes = []
        for r, ids in enumerate(prompts["session"][:PREFIX_SESSION_ROWS]):
            s.begin_admit(r, ids)
            resumes.append(s.pending_resume(r))
            s.prefill_pending(r)
        torch.cuda.synchronize()
        admit_s = time.perf_counter() - t0
        toks = np.concatenate([s.step(8) for _ in range(PREFIX_DECODE // 8)], axis=1)
        runs[mb] = (toks, eng.last_logits.clone(), resumes, admit_s,
                    None if eng.prefix_cache is None else dict(eng.prefix_cache.counters),
                    eng.graph_stats()["recaptures_after_warmup"])
        eng.close()
        del eng, s
        release(torch)
    (tg, lg, rg, sg, cg, recap), (tw, lw, _, sw, _, _) = runs[512], runs[0]
    out = {"phase": "prefix_cache", "setup": "llama32_1b batch_session 16 paged int8",
           "resumes": rg, "admit_s_hit": sg, "admit_s_cold": sw,
           "rows_equal": [bool((tg[r] == tw[r]).all()) for r in range(PREFIX_SESSION_ROWS)],
           "logits_equal": torch.equal(lg[:PREFIX_SESSION_ROWS], lw[:PREFIX_SESSION_ROWS]),
           "counters": cg,
           "recaptures_after_warmup": recap}
    log(json.dumps(out))
    assert rg == [0] + [PREFIX_HEAD_TOKENS] * (PREFIX_SESSION_ROWS - 1), rg
    assert all(out["rows_equal"]) and out["logits_equal"], "session rows differ from cold"
    assert recap == 0, "a capture after warmup in the session"
    return out


def prefix_cache_phase(torch, mp: str, tp: str, counters, expected) -> dict:
    """Phase 5c, counted as one path: every launch counter set to 0 just
    before and read just after."""
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    prompts = prefix_prompts(Tokenizer(tp).vocab_size)
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    for layout, kv in (("contiguous", None), ("paged", None), ("paged", "int8")):
        prefix_layout(torch, mp, prompts, counters, layout, kv)
        release(torch)
    prefix_session(torch, mp, prompts)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    check_launched(launches, expected, "the prefix-cache phase")
    return launches


# ---------------------------------------------------------------------------
# phase 5d: speculative decoding
# ---------------------------------------------------------------------------

SPEC_DECODE_STEPS = 256
# the 30B-A3B runs: a round costs several decode tokens there (the gather
# arm), and the model's steps are 4x the 1B's; the first 64 steps are a
# plain chunk (PROMPT's end drafts nothing), the rest verify rounds (128
# until phase 5e came, cut to keep the script's time)
MOE_SPEC_DECODE_STEPS = 96
# a verify round's logits against the stepwise decode's at the same
# positions, as a share of the stepwise logits' largest value: at k 4 the
# round takes the decode step's arms (K1's Q80 arm at 5 rows, bit for bit
# its 1-row calls), and the logits are equal bit for bit (measured on an
# H100: 0 on all three layouts); at k 8 K2's bf16 arm at 9 rows (measured:
# 0.22% on all three layouts)
SPEC_VERIFY_TOL = {4: 0.0, 8: 0.005}
# a 30B-A3B round of 5 tokens: the MoE gather arm where decode takes
# K1-indexed (measured on an H100: 0.046%)
MOE_SPEC_VERIFY_TOL = 0.002


@contextlib.contextmanager
def verify_arms(eng):
    """Decode on the arms a verify round takes where decode takes others:
    every dense Q40 matmul on K2's bf16 arm (a round of more than 8 rows;
    decode's K1 quantizes x to Q80) and the MoE on its gather arm (a
    30B-A3B round of 5 tokens; decode's K1-indexed). K2, K5 and the plain
    attention compute each row and query alone, so on these arms the
    chains with and without speculation are equal bit for bit: where they
    part without them, the arms parted them, not a fault. The engine's
    graphs are dropped before and after, so each arm captures its own."""
    from distributed_llama_tpu_torch.models import transformer
    from distributed_llama_tpu_torch.ops import cuda_q40

    saved = (cuda_q40.q40_gemv_q80_stacked, cuda_q40.q40_gemv_q80,
             transformer._moe_decode_i8_eligible)
    eng._graphs = None
    gc.collect()
    cuda_q40.q40_gemv_q80_stacked = cuda_q40.q40_gemm_bf16_stacked
    cuda_q40.q40_gemv_q80 = cuda_q40.q40_gemm_bf16
    transformer._moe_decode_i8_eligible = lambda *args: False
    try:
        yield
    finally:
        (cuda_q40.q40_gemv_q80_stacked, cuda_q40.q40_gemv_q80,
         transformer._moe_decode_i8_eligible) = saved
        eng._graphs = None
        gc.collect()


def spec_engine(mp: str, **kw):
    """An engine with ngram speculation at draft_k 8, which `speculate`
    switches between off, k 4 and k 8: the A/B arms of one engine."""
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine

    return InferenceEngine(mp, max_seq_len=MAX_SEQ_LEN, device="cuda", speculative="ngram",
                           draft_k=8, **kw)


def speculate(eng, k: int) -> None:
    """ngram speculation at draft_k k, or off at k 0."""
    eng.set_speculation("ngram" if k else "off", k or None)


def first_divergence(torch, want: list, got: list, n_prompt: int, logits_at):
    """None where the token lists (prompt and generated) are equal; else
    where the generated tokens first part, and the margin there:
    `logits_at(j)` gives the logits from which the run without speculation
    took want[j], replayed on its own path; the margin is want's logit less
    got's, alone and as a share of their largest magnitude (`replayed`:
    want[j] is their argmax, so the replay is the run's)."""
    j = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if j is None:
        assert len(want) == len(got), (len(want), len(got))
        return None
    logits = logits_at(j).float().cpu()
    margin = (logits[want[j]] - logits[got[j]]).item()
    return {"index": j - n_prompt, "want": want[j], "got": got[j], "margin": margin,
            "margin_share": margin / logits.abs().max().item(),
            "replayed": int(logits.argmax()) == want[j]}


def decode_logits(torch, eng, ids: list, n_steps: int = SPEC_DECODE_STEPS):
    """`logits_at` for a batch-1 `generate` of PROMPT without speculation
    (n_steps tokens):
    PROMPT's prefill, then the run's own 64-step chunks (graphed) up to
    the chunk that holds the step producing tokens[j], whose first steps
    run eagerly at that chunk's kv bucket (eager equals graphed bit for
    bit). Returns the step's row-0 logits."""
    from distributed_llama_tpu_torch.runtime.decode import decode_chunk

    def logits_at(j):
        eng.reset()
        eng.prefill(ids[:-1])
        pos, tok = len(ids) - 1, eng._tokens([ids[-1]] * eng.batch)
        max_pos, n = len(ids) - 1 + n_steps, eng.decode_chunk_size
        while True:
            while n > max_pos - pos:
                n //= 2
            if pos + n >= j:
                if eng.paged:
                    eng._ensure_pages_all_rows(pos, j)
                _, _, logits = decode_chunk(
                    eng.cfg, eng.params, eng.rope, eng.cache, tok, pos, j - pos,
                    kv_len=eng._kv_bucket(pos + n),
                    page_table=eng._pt_operand() if eng.paged else None, page_size=eng.page_size)
                return logits[0]
            _, tok = eng._decode_chunk(tok, pos, n)
            pos += n

    return logits_at


def verify_check(torch, eng, ids: list, chain: list, k: int, tol: float,
                 same_arms: bool = True) -> dict:
    """One verify round over [PROMPT's last token] + the greedy chain's
    next k tokens after PROMPT's prefill: eager (the position a 0-d device
    tensor, as graphed), then graphed twice; ids and logits of the graphed
    rounds bit for bit the eager round's. Against the stepwise logits of
    the same k + 1 positions (eager decode, int positions) within `tol` of
    their largest value; with `same_arms` (the round takes the decode
    step's matmul arms) every draft accepted, else the count reported."""
    import numpy as np

    from distributed_llama_tpu_torch.runtime.speculative import accept_greedy

    n = len(ids)
    feed = np.array([[ids[-1]] + chain[n : n + k]] * eng.batch)
    pos, kvb = n - 1, eng._kv_bucket(n + k)
    outs = []
    for graphs in (False, True, True):
        eng.cuda_graphs = graphs
        eng.reset()
        eng.prefill(ids[:-1])
        got_ids, got_logits = eng._dispatch_verify(feed, pos, kvb)
        outs.append((got_ids.clone(), got_logits.clone()))
    eng.cuda_graphs = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_ids.tolist()  # the round's fetch alone, its device work done
    copy_us = (time.perf_counter() - t0) * 1e6
    ids_e, logits_e = outs[0]
    eng.reset()
    eng.prefill(ids[:-1])
    step = torch.stack([torch.from_numpy(eng.decode_one(int(t), pos + j)[0])
                        for j, t in enumerate(feed[0])]).to(logits_e.device)
    err = (logits_e[0] - step).abs().max().item()
    scale = step.abs().max().item()
    out = {"k": k, "graphed_equal_eager": all(torch.equal(i, ids_e) and torch.equal(l, logits_e)
                                              for i, l in outs[1:]),
           "max_abs_err_vs_stepwise": err, "share_of_scale": err / scale, "tol_share": tol,
           "fetch_copy_us": copy_us,
           "accepted": accept_greedy(feed[0, 1:].tolist(), ids_e[0].tolist())}
    assert out["graphed_equal_eager"], f"k {k}: graphed verify differs from eager"
    assert err <= tol * scale, f"k {k}: verify logits {err} from stepwise (> {tol * scale})"
    assert out["accepted"] == k or not same_arms, f"k {k}: the chain's own drafts were rejected"
    return out


SPEC_PROFILE_STEPS = 64


def spec_profile(torch, name: str, eng, ctx: list) -> dict:
    """Where a token's time goes with ngram speculation at k 4 and without,
    on one engine in turns (off, k 4, k 4, off): torch.profiler over the
    decode of SPEC_PROFILE_STEPS greedy tokens after `ctx` (PROMPT and the
    first 64 tokens of its greedy chain: past the plain chunk that PROMPT's
    end, which drafts nothing, starts with), whose prefill runs outside the
    window (`profile_window`); logs and returns each arm's mean of
    AB_KEYS."""
    from distributed_llama_tpu_torch.runtime.engine import GenerationResult

    pos, n_steps = len(ctx) - 1, SPEC_PROFILE_STEPS

    def setup():
        eng.reset()
        eng.prefill(ctx[:-1])

    def decode(k):
        res = GenerationResult(tokens=list(ctx), n_prompt_tokens=len(ctx))
        if k:
            eng._decode_speculative(res, ctx[-1], pos, pos + n_steps, None, None,
                                    time.perf_counter())
        else:
            eng._decode_device(res, ctx[-1], pos, pos + n_steps, None, None, None,
                               time.perf_counter())

    windows = {0: [], 4: []}
    for k in (0, 4, 4, 0):
        speculate(eng, k)
        windows[k].append(profile_window(torch, f"{name} {'ngram k 4' if k else 'off'}",
                                         partial(decode, k), n_steps, setup=setup))
    out = {"phase": "spec_ab", "window": name, "tokens": n_steps}
    for k, arm in ((0, "off"), (4, "ngram k 4")):
        out[arm] = {key: sum(w[key] for w in windows[k]) / 2 for key in AB_KEYS}
    log(json.dumps(out))
    return out


def spec_layout(torch, mp: str, ids: list, layout: str, kv) -> dict:
    """Batch 1 on one layout: SPEC_DECODE_STEPS greedy steps from PROMPT
    without speculation, with ngram at k 4 and at k 8, on one engine
    (graphed; the first run of each arm captures). k 4's rounds take
    decode's arms and its tokens equal the run without; k 8's 9-token
    rounds take K2's, so its tokens equal the run without or part where
    `verify_arms` makes them equal again. Each arm once more in turns
    (k 8, k 4, off; twice until phase 5f came) for decode tok/s, and `verify_check`
    at k 4 and 8."""
    eng = spec_engine(mp, kv_layout=layout, cache_dtype=kv)
    steps = len(ids) - 1 + SPEC_DECODE_STEPS

    def run(k):
        speculate(eng, k)
        eng.reset()
        torch.cuda.synchronize()
        res = eng.generate(ids, steps)
        assert res.n_pred_tokens == SPEC_DECODE_STEPS, res.n_pred_tokens
        return res

    first = {k: run(k) for k in (0, 4, 8)}
    want = first[0].tokens
    speculate(eng, 0)
    div = {k: first_divergence(torch, want, first[k].tokens, len(ids),
                               decode_logits(torch, eng, ids)) for k in (4, 8)}
    tok_s = {0: [], 4: [], 8: []}
    spec_timing = {4: [], 8: []}
    for k in (8, 4, 0):
        res = run(k)
        tok_s[k].append(SPEC_DECODE_STEPS / (res.decode_us / 1e6))
        if k:
            t = eng.last_spec_timing
            spec_timing[k].append({
                **t, "verify_ms_per_round": t["verify_us"] / 1e3 / max(t["rounds"], 1),
                "draft_us_per_round": t["draft_us"] / max(t["rounds"] + t["fallback_chunks"], 1),
                "fetch_us_per_round": t["fetch_us"] / max(t["rounds"], 1),
                "tokens_per_round":
                    t["emitted_tokens"] / max(t["rounds"] + t["fallback_chunks"], 1),
                "tokens_equal": res.tokens == want})
    name = f"llama32_1b batch 1 {layout} {kv or 'bf16'}"
    profiled = (spec_profile(torch, name, eng, want[: len(ids) + 64])
                if layout == "contiguous" else None)
    speculate(eng, 8)
    checks = [verify_check(torch, eng, ids, want, k, SPEC_VERIFY_TOL[k], same_arms=k == 4)
              for k in (4, 8)]
    out = {"phase": "speculation", "setup": name, "profiled": profiled,
           "decode_steps": SPEC_DECODE_STEPS, "divergence": div, "decode_tok_s": tok_s,
           "spec": spec_timing, "verify_checks": checks, "graphs": eng.graph_stats()}
    if div[8] is not None:
        with verify_arms(eng):
            out["k8_equal_on_verify_arms"] = run(0).tokens == run(8).tokens
        j = len(ids) + div[8]["index"]
        out["k8_arm_growth"] = arm_growth(torch, eng, want, len(ids), j, first[8].tokens[j])
    log(json.dumps(out))
    assert div[4] is None, f"{layout} {kv}: k 4 tokens part from the run without speculation"
    assert div[8] is None or out["k8_equal_on_verify_arms"], \
        f"{layout} {kv}: k 8 parts from the run without speculation on the same arms: {div[8]}"
    assert all(t["tokens_equal"] for t in spec_timing[4])
    eng.close()
    return out


@contextlib.contextmanager
def recorded_matmuls(calls: list):
    """Record each dense Q40 matmul call (K1 and K2, stacked and not) as
    (slot, layer, x, out, q, d), the slot being the name `quant_matmul`
    calls, whatever `verify_arms` put there. The calls' launches are
    handed back to the kernels' counters on exit."""
    from distributed_llama_tpu_torch.ops import cuda_q40

    names = ("q40_gemv_q80_stacked", "q40_gemv_q80", "q40_gemm_bf16_stacked", "q40_gemm_bf16")
    saved = {n: getattr(cuda_q40, n) for n in names}

    def wrap(name, fn):
        def call(x, q, d, *layer):
            out = fn(x, q, d, *layer)
            calls.append((name, layer[0] if layer else None, x.detach().clone(),
                          out.detach().clone(), q, d))
            return out

        call.launches = 0  # a kernel's own count lands here while it is patched
        return call

    wrapped = {n: wrap(n, saved[n]) for n in names}
    for n in names:
        setattr(cuda_q40, n, wrapped[n])
    try:
        yield
    finally:
        for n in names:
            setattr(cuda_q40, n, saved[n])
            saved[n].launches += wrapped[n].launches


def first_parting_call(torch, own: list, other: list) -> dict:
    """The first matmul call of one decode step whose output parts from the
    other arm's by more than 5% of its scale: its slot and layer, how far
    its input and the previous call's output had parted, its input's
    largest magnitude, and that input through the plain K1 (Q80 x) and K2
    (bf16 x) on the CPU, each against both arms' kernels; and for every
    call up to it, how far its input and output had parted (`shares`: a
    call's input is what the ops between it and the call before made)."""
    from distributed_llama_tpu_torch.ops import cuda_q40

    def share(a, b):
        return ((a.float() - b.float()).abs().max() / a.float().abs().max()).item()

    assert [c[:2] for c in own] == [c[:2] for c in other], "the arms made other calls"
    outs = [share(a[3], b[3]) for a, b in zip(own, other)]
    ins = [share(a[2], b[2]) for a, b in zip(own, other)]
    i = next((n for n, x in enumerate(outs) if x > 0.05), None)
    if i is None:
        return {"calls": len(own), "largest_out_share": max(outs)}
    name, layer, x, out_own, q, d = own[i]
    out_other = other[i][3]
    if layer is not None:
        q, d = q[layer], d[layer]
    xc, qc, dc = x.float().cpu(), q.cpu(), d.cpu()
    k1, k2 = cuda_q40.q40_gemv_q80_plain(xc, qc, dc), cuda_q40.q40_gemm_bf16_plain(xc, qc, dc)
    return {"calls": len(own), "index": i, "slot": name, "layer": layer,
            "in_share": share(x, other[i][2]), "out_share": outs[i],
            "prev_out_share": outs[i - 1] if i else None, "x_amax": x.abs().max().item(),
            "own_vs_plain_k1": share(k1, out_own.cpu()), "own_vs_plain_k2": share(k2, out_own.cpu()),
            "other_vs_plain_k1": share(k1, out_other.cpu()),
            "other_vs_plain_k2": share(k2, out_other.cpu()), "plain_k1_vs_k2": share(k1, k2),
            "shares": [[a, b] for a, b in zip(ins[: i + 1], outs[: i + 1])]}


def arm_growth(torch, eng, want: list, n_prompt: int, j: int, got_j: int) -> dict:
    """Where a k 8 divergence comes from: decode along `want` (the chain
    without speculation; its first n_prompt tokens the prompt), teacher
    forced, one eager `decode_one` a position up to the step that gives
    want[j], on decode's own arms and on the verify rounds'
    (`verify_arms`). A generated token's share: the largest difference of
    the two arms' logits over the own arms' largest logit. Reports where
    the arms first differ and the share there, every 32nd token's share,
    the share at j, at j the margin of want[j] over got_j (the token the
    speculative chain took) on each arm, and the matmul call of that last
    step where the arms part (`first_parting_call`)."""

    def logits(arms, calls):
        with arms:
            eng.reset()
            eng.prefill(want[: n_prompt - 1])
            rows = [torch.from_numpy(eng.decode_one(int(want[p]), p)[0])
                    for p in range(n_prompt - 1, j - 1)]
            with recorded_matmuls(calls):
                rows.append(torch.from_numpy(eng.decode_one(int(want[j - 1]), j - 1)[0]))
            return torch.stack(rows)

    own_calls, other_calls = [], []
    own = logits(contextlib.nullcontext(), own_calls)
    other = logits(verify_arms(eng), other_calls)
    share = ((own - other).abs().amax(-1) / own.abs().amax(-1)).tolist()
    first = next((i for i, x in enumerate(share) if x > 0), None)
    return {"tokens": len(share), "first_differing_token": first,
            "share_first": share[first] if first is not None else 0.0,
            "share_every_32": share[::32], "share_at_divergence": share[-1],
            "own_argmax_is_chain": sum(int(own[i].argmax()) == want[n_prompt + i]
                                       for i in range(len(share))) / len(share),
            "margin_own": (own[-1, want[j]] - own[-1, got_j]).item(),
            "margin_verify_arms": (other[-1, want[j]] - other[-1, got_j]).item(),
            "parting_call": first_parting_call(torch, own_calls, other_calls)}


def spec_rows_divergence(torch, prompts: list, want: dict, got: dict, logits_at) -> dict:
    """Each row's spec tokens against its tokens without speculation: None
    where equal, else the first divergence with its margin in the run
    without's own logits (`logits_at(r, d)`: the logits from which that
    run took row r's d-th generated token)."""
    out = {}
    for r, w in want.items():
        p, n = list(prompts[r]), len(prompts[r])
        out[r] = first_divergence(torch, p + w, p + got[r][: len(w)], n,
                                  lambda j, r=r, n=n: logits_at(r, j - n))
    return out


def spec_session(torch, mp: str, ids: list) -> dict:
    """The batch-16 paged int8 BatchSession: 16 prefixes of PROMPT, 64
    tokens a row in 8-token `step`s, then the same admissions in
    `spec_step` rounds (ngram drafts of at most 4 tokens from each row's
    own context: 80-row rounds, on K2's arm as `step`'s 16 rows are);
    each row's tokens against its plain run: equal, or equal again under
    `verify_arms`. Then `warmup()` at k 8 and a pinned spec trace (a
    streamed generate across the 256 and 512 buckets, generate_batch,
    spec_step and step rounds): 0 captures after warmup."""
    from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
    from distributed_llama_tpu_torch.runtime.speculative import NGramDraft

    b, n = 16, 64
    prompts = [ids[: 16 + (len(ids) - 16) * i // (b - 1)] for i in range(b)]
    eng = spec_engine(mp, batch=b, kv_layout="paged", cache_dtype="int8")
    speculate(eng, 4)
    ds = NGramDraft()

    def admitted():
        s = BatchSession(eng)
        for r in range(b):
            s.admit(r, prompts[r])
        torch.cuda.synchronize()
        return s, time.perf_counter()

    def stepped():
        s, t0 = admitted()
        steps = [s.step(8) for _ in range(n // 8)]
        return {r: [int(t) for h in steps for t in h[r]] for r in range(b)}, \
            time.perf_counter() - t0

    def speculated():
        s, t0 = admitted()
        got, rounds = {r: [] for r in range(b)}, 0
        while any(len(g) < n for g in got.values()):
            drafts = {r: ds.draft(list(prompts[r]) + got[r], min(4, n - len(got[r]) - 1))
                      for r in range(b) if len(got[r]) < n}
            for r, e in s.spec_step(drafts).items():
                got[r].extend(e)
            rounds += 1
        return got, time.perf_counter() - t0, rounds

    want, step_s = stepped()
    got, spec_s, rounds = speculated()
    c = dict(eng.spec_counters)

    def logits_at(r, d):
        """Row r's logits of its d-th token in `step` chunks of 8 (every
        position below 256: one kv bucket, whatever the chunk)."""
        s = BatchSession(eng)
        for i in range(b):
            s.admit(i, prompts[i])
        for _ in range(d // 8):
            s.step(8)
        s.step(d % 8 + 1)
        return eng.last_logits[r]

    divs = spec_rows_divergence(torch, prompts, want, got, logits_at)
    out = {"phase": "speculation", "setup": "llama32_1b batch_session 16 paged int8",
           "tokens_per_row": n, "rows_equal": sum(d is None for d in divs.values()),
           "divergence": {r: d for r, d in divs.items() if d is not None},
           "step_tok_s": b * n / step_s, "spec_step_tok_s": b * n / spec_s, "rounds": rounds,
           "acceptance_rate": c.get("spec_acceptance_rate")}
    if out["divergence"]:
        with verify_arms(eng):
            out["rows_equal_on_verify_arms"] = stepped()[0] == speculated()[0]
    log(json.dumps(out))
    assert not out["divergence"] or out["rows_equal_on_verify_arms"], \
        "batch-16 spec_step rows part from step's on the same arms"
    speculate(eng, 8)
    stats = eng.warmup()
    eng.generate((ids * 4)[:200], 600, on_token=lambda t: None)
    eng.generate_batch([(ids * 2)[o : o + 60 + o] for o in range(b)], 24)
    s = BatchSession(eng)
    s.admit(0, ids)
    s.admit(5, ids[:40])
    s.admit(9, ids, temperature=0.7, seed=3)
    for _ in range(4):
        s.spec_step({r: ds.draft(ids, 8) for r in (0, 5)})
        s.step(8)
    s.release(9)
    after = eng.graph_stats()
    warm = {"phase": "graph_warmup", "setup": "llama32_1b batch 16 paged int8 speculation k 8",
            "warmup_s": stats["warmup_seconds"], "captures": stats["captures"],
            "graph_pool_bytes": stats["pool_bytes"],
            "recaptures_after_warmup": after["recaptures_after_warmup"]}
    log(json.dumps(warm))
    assert after["recaptures_after_warmup"] == 0, "a capture after warmup on the spec trace"
    eng.close()
    return {**out, "warmup": warm}


def spec_generate_batch(torch, mp: str, ids: list) -> dict:
    """generate_batch at batch 4 (paged int8): four 81-token windows of
    PROMPT, 64 tokens a row, without speculation and with ngram at k 4 on
    one engine. A round's 20 rows take K2's arm where the decode chunk's 4
    take K1's, so rows equal the run without or part where `verify_arms`
    makes them equal again (each first divergence reported with its
    margin)."""
    eng = spec_engine(mp, batch=4, kv_layout="paged", cache_dtype="int8")
    prompts = [ids[o : o + 81] for o in (0, 10, 20, 32)]
    n, res, wall = 64, {}, {}
    for k in (0, 4, 4, 0):
        speculate(eng, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[k] = eng.generate_batch(prompts, n)
        wall.setdefault(k, []).append(time.perf_counter() - t0)
    c = dict(eng.spec_counters)

    def logits_at(r, d):
        """Row r's logits of its d-th token without speculation: a budget of
        d + 1 (every position below 256: one kv bucket, whatever the
        chunks)."""
        speculate(eng, 0)
        eng.generate_batch(prompts, d + 1)
        return eng.last_logits[r]

    divs = spec_rows_divergence(torch, prompts, dict(enumerate(res[0])),
                                dict(enumerate(res[4])), logits_at)
    out = {"phase": "speculation", "setup": "llama32_1b generate_batch 4 paged int8",
           "tokens_per_row": n, "rows_equal": sum(d is None for d in divs.values()),
           "divergence": {r: d for r, d in divs.items() if d is not None},
           "wall_s": wall, "spec_counters": c}
    if out["divergence"]:
        with verify_arms(eng):
            arms = {}
            for k in (0, 4):
                speculate(eng, k)
                arms[k] = eng.generate_batch(prompts, n)
        out["rows_equal_on_verify_arms"] = arms[0] == arms[4]
    log(json.dumps(out))
    assert not out["divergence"] or out["rows_equal_on_verify_arms"], \
        "generate_batch spec rows part from the rows without on the same arms"
    eng.close()
    return out


def speculation_phase(torch, mp: str, tp: str, counters, expected) -> dict:
    """Phase 5d at Llama-3.2-1B width, counted as one path: every launch
    counter set to 0 just before and read just after."""
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    ids = Tokenizer(tp).encode(PROMPT)
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    for layout, kv in (("contiguous", None), ("paged", None), ("paged", "int8")):
        spec_layout(torch, mp, ids, layout, kv)
        release(torch)
    spec_session(torch, mp, ids)
    release(torch)
    spec_generate_batch(torch, mp, ids)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    check_launched(launches, expected, "the speculation phase")
    return launches


def spec_moe(torch, eng, ids: list) -> dict:
    """Phase 5d at Qwen3-30B-A3B width on the phase-5b engine (batch 1
    contiguous): a verify round of 5 tokens makes 40 expert rows, fewer
    than 128 experts, so the MoE takes its gather arm, graphed. Without
    speculation, then ngram at k 4 (the first run captures; the pool's
    bytes before and after), then in turns (k 4, off; twice until phase 5f
    came) for tok/s.
    Decode takes K1-indexed where the round takes the gather arm, so the
    tokens equal the run without or part where `verify_arms` makes them
    equal again; `verify_check` at the cross-arm tolerance."""
    steps = len(ids) - 1 + MOE_SPEC_DECODE_STEPS

    def run(k):
        speculate(eng, k)
        eng.reset()
        torch.cuda.synchronize()
        res = eng.generate(ids, steps)
        assert res.n_pred_tokens == MOE_SPEC_DECODE_STEPS
        return res

    want = run(0).tokens
    pool0 = eng.graph_stats()["pool_bytes"]
    got = run(4).tokens
    pool1 = eng.graph_stats()["pool_bytes"]
    speculate(eng, 0)
    div = first_divergence(torch, want, got, len(ids),
                           decode_logits(torch, eng, ids, MOE_SPEC_DECODE_STEPS))
    tok_s, timing_k4 = {0: [], 4: []}, []
    for k in (4, 0):
        res = run(k)
        tok_s[k].append(MOE_SPEC_DECODE_STEPS / (res.decode_us / 1e6))
        if k:
            t = eng.last_spec_timing
            timing_k4.append({**t, "verify_ms_per_round":
                              t["verify_us"] / 1e3 / max(t["rounds"], 1)})
    check = verify_check(torch, eng, ids, want, 4, MOE_SPEC_VERIFY_TOL, same_arms=False)
    out = {"phase": "speculation", "setup": "qwen3_30b_a3b batch 1 contiguous",
           "decode_steps": MOE_SPEC_DECODE_STEPS, "divergence": div, "decode_tok_s": tok_s,
           "spec": timing_k4, "verify_check": check,
           "graph_pool_bytes_before_verify": pool0, "graph_pool_bytes_after_verify": pool1}
    if div is not None:
        with verify_arms(eng):
            out["equal_on_verify_arms"] = run(0).tokens == run(4).tokens
    log(json.dumps(out))
    assert div is None or out["equal_on_verify_arms"], \
        f"30B-A3B: spec parts from the run without speculation on the same arms: {div}"
    return out


# ---------------------------------------------------------------------------
# phase 5e: grammar-constrained decoding
# ---------------------------------------------------------------------------

# the grammars (runtime/grammar.py), as tests/test_grammar.py and the port's
# tests compile them: a boolean object (a short, fully determined tail a
# random model finishes), a two-word alternation, an enum and a repeat
GRAMMAR_BOOL = {"type": "object", "properties": {"ok": {"type": "boolean"}}}
GRAMMAR_ENUM = {"enum": ["red", "green", "blue"]}
# the 30B-A3B run's object: an unbounded string and integer, so a 64-token
# budget may end it unfinished (held to legality; a finished run to a match)
GRAMMAR_OPEN = {"type": "object", "properties": {"name": {"type": "string"},
                                                 "n": {"type": "integer"}}}
# a constrained generate's budget (the grammars above finish well before)
GRAMMAR_STEPS = 64
# the decode chunk of phase 5e's batch-1 engines: an eager chunk runs to its
# end after the grammar finished, so a short one
GRAMMAR_CHUNK = 16


def grammar_specs() -> dict:
    from distributed_llama_tpu_torch.runtime.grammar import schema_to_regex

    return {"bool": ("json_schema", schema_to_regex(GRAMMAR_BOOL)),
            "yesno": ("regex", "(?:yes|no)"),
            "color": ("json_schema", schema_to_regex(GRAMMAR_ENUM)),
            "repeat": ("regex", "(?:yes,)*no"),
            "open": ("json_schema", schema_to_regex(GRAMMAR_OPEN))}


def grammar_replay(tok, g, gen: list) -> dict:
    """Walk `gen` through a fresh session of `g`: the legality and validity
    oracle of a constrained stream (illegal tokens, finished, full match)."""
    from distributed_llama_tpu_torch.runtime.grammar import GrammarArena, GrammarSession

    s = GrammarSession(GrammarArena(len(tok.vocab), n_states=g.n_states + 1), g)
    out, illegal = b"", 0
    for t in gen:
        if s.done:
            break
        r = s.advance(int(t))
        if r == "illegal":
            illegal += 1
        elif r != "eos":
            out += tok.vocab[int(t)]
        if s.done or s.at_terminal:
            break
    finished = s.done or s.at_terminal
    s.close()
    return {"tokens": len(gen), "illegal": illegal, "finished": finished,
            "fullmatch": bool(g.fullmatch(out)), "text": out.decode("utf-8", "replace")}


def grammar_valid(check: dict, where: str, must_finish: bool = True) -> None:
    assert check["illegal"] == 0, f"{where}: {check['illegal']} illegal tokens"
    if must_finish or check["finished"]:
        assert check["finished"] and check["fullmatch"], f"{where}: not a full match: {check}"


def grammar_layout(torch, mp: str, tok, comp, layout: str, kv) -> dict:
    """Batch 1 on one layout, an engine with the arena: constrained greedy
    `generate` of PROMPT under the boolean object and the alternation,
    eagerly, graphed and with ngram at k 4 (tokens and the last chunk's
    logits of eager and graphed bit for bit; k 4's tokens the same); on the
    contiguous layout also the repeat grammar from a prompt whose own
    drafts are legal, so rounds verify under the mask."""
    from distributed_llama_tpu_torch.runtime.grammar import GrammarSession

    eng = spec_engine(mp, kv_layout=layout, cache_dtype=kv, grammar=True,
                      decode_chunk_size=GRAMMAR_CHUNK)
    specs = grammar_specs()
    ids = tok.encode(PROMPT)
    cases = [("bool", ids), ("yesno", ids)]
    if layout == "contiguous":
        cases.append(("repeat", tok.encode("yes,yes,yes,yes,yes,")))
    name = f"llama32_1b batch 1 {layout} {kv or 'bf16'}"
    out = {"phase": "grammar", "setup": name, "arena_states": eng.grammar.n_states,
           "arena_bytes": eng._gr_table.numel() * 4, "cases": {}}
    for gname, prompt in cases:
        g = comp.compile(*specs[gname])
        runs, logits, timing = {}, {}, None
        for mode in ("eager", "graphed", "ngram k 4"):
            eng.cuda_graphs = mode != "eager"
            speculate(eng, 4 if mode == "ngram k 4" else 0)
            eng.reset()
            s = GrammarSession(eng.grammar, g)
            res = eng.generate(prompt, len(prompt) - 1 + GRAMMAR_STEPS, grammar=s)
            s.close()
            runs[mode] = res.tokens[len(prompt):]
            if mode != "ngram k 4":  # a round's logits are the verify's
                logits[mode] = eng.last_logits.clone()
            check = grammar_replay(tok, g, runs[mode])
            grammar_valid(check, f"{name} {gname} {mode}", must_finish=gname != "repeat")
            if mode == "ngram k 4":
                timing = {k: eng.last_spec_timing[k] for k in
                          ("rounds", "fallback_chunks", "draft_tokens", "accepted_tokens")}
        out["cases"][gname] = {
            **check, "graphed_equals_eager": runs["graphed"] == runs["eager"]
            and torch.equal(logits["graphed"], logits["eager"]),
            "spec_equals_off": runs["ngram k 4"] == runs["graphed"], "spec": timing}
    log(json.dumps(out))
    for gname, c in out["cases"].items():
        assert c["graphed_equals_eager"], f"{name} {gname}: graphed differs from eager"
        assert c["spec_equals_off"], f"{name} {gname}: ngram k 4 differs from off"
    eng.close()
    return out


def grammar_session(torch, mp: str, tok, comp) -> dict:
    """A batch-16 paged int8 BatchSession on an engine with the arena: 8
    constrained rows (even rows; the boolean object, the alternation and
    the enum; rows 12 and 14 sampled at temperature 0.8, top-p 0.9 and
    1.0) beside 8 free greedy rows; one `spec_step` round over the greedy
    rows (ngram drafts of their own context, a constrained row's cut to
    its legal prefix), then 8 `step`s of 8. The free rows' tokens and
    logits bit for bit those of the same free rows alone (the others
    parked) on an engine without the arena; constrained rows legal and
    finished. Then `warmup()`, installs that evict from the arena, a
    constrained session and generate: 0 captures after warmup, the
    table's storage fixed, each install's upload (its dirty rows) timed
    beside a copy of the whole table."""
    from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
    from distributed_llama_tpu_torch.runtime.grammar import GrammarSession
    from distributed_llama_tpu_torch.runtime.speculative import NGramDraft

    b, chunk, n_chunks = 16, 8, 8
    ids = tok.encode(PROMPT)
    prompts = [ids[: 16 + (len(ids) - 16) * i // (b - 1)] for i in range(b)]
    specs = grammar_specs()
    names = {r: ("bool", "yesno", "color")[(r // 2) % 3] for r in range(0, b, 2)}
    sampled = {12: 0.9, 14: 1.0}
    ds = NGramDraft()

    def run(eng, rows):
        s = BatchSession(eng)
        sess = {}
        for r in rows:
            g = None
            if r in names and eng.grammar is not None:
                g = sess[r] = GrammarSession(eng.grammar, comp.compile(*specs[names[r]]))
            t = 0.8 if r in sampled else 0.0
            s.admit(r, prompts[r], temperature=t, topp=sampled.get(r, 0.9), seed=100 + r,
                    grammar=g)
        got = {r: [] for r in rows}

        def take(r, toks):
            g = sess.get(r)
            for t in toks:
                if g is not None and (g.done or g.at_terminal):
                    return
                got[r].append(int(t))
                if g is not None:
                    g.advance(int(t))

        greedy = [r for r in rows if r not in sampled]
        for r, e in s.spec_step({r: ds.draft(list(prompts[r]), 4) for r in greedy}).items():
            take(r, e)
        logits = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            host = s.step(chunk)
            logits.append(eng.last_logits.clone())
            for r in rows:
                take(r, host[r])
        wall = time.perf_counter() - t0
        for g in sess.values():
            g.close()
        return got, logits, wall

    eng = spec_engine(mp, batch=b, kv_layout="paged", cache_dtype="int8", grammar=True)
    speculate(eng, 4)
    got, logits, wall = run(eng, range(b))
    plain = spec_engine(mp, batch=b, kv_layout="paged", cache_dtype="int8", grammar=False)
    speculate(plain, 4)
    free = [r for r in range(b) if r not in names]
    want, plain_logits, plain_wall = run(plain, free)
    plain.close()
    del plain
    checks = {r: grammar_replay(tok, comp.compile(*specs[names[r]]), got[r]) for r in names}
    out = {"phase": "grammar", "setup": "llama32_1b batch_session 16 paged int8",
           "constrained_rows": {r: {"grammar": names[r], "sampled": r in sampled, **checks[r]}
                                for r in names},
           "free_rows_equal": all(got[r] == want[r] for r in free),
           "free_logits_equal": all(torch.equal(a[r], p[r]) for a, p in zip(logits, plain_logits)
                                    for r in free),
           "step_s": wall, "step_s_without_arena_free_rows_only": plain_wall}
    log(json.dumps(out))
    assert out["free_rows_equal"] and out["free_logits_equal"], \
        "batch-16 grammar session: a free row differs from its run without co-tenants or arena"
    for r, c in checks.items():
        grammar_valid(c, f"batch-16 row {r} ({names[r]})")

    # warmup, then installs that evict from the arena and constrained work
    ptr = eng._gr_table.data_ptr()
    stats = eng.warmup()
    uploads = []
    evicting = [("regex", "a" * 40), ("regex", "b" * 40), ("regex", "c" * 40)]
    v0 = eng.grammar.version
    for kind, pat in evicting:  # 41 states each: the second and third evict
        g = comp.compile(kind, pat)
        s = GrammarSession(eng.grammar, g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._gr_operand()
        torch.cuda.synchronize()
        uploads.append((time.perf_counter() - t0) * 1e3)
        res = eng.generate_batch([prompts[-1]] * b, [48] * b, grammars=[s] + [None] * (b - 1))
        check = grammar_replay(tok, g, res[0])
        grammar_valid(check, f"post-warmup install {pat[:3]}...")
        s.close()
    whole = []  # the whole table's copy, what an upload without dirty rows costs
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._gr_table.copy_(eng._gr_host)
        torch.cuda.synchronize()
        whole.append((time.perf_counter() - t0) * 1e3)
    s2 = BatchSession(eng)
    g = GrammarSession(eng.grammar, comp.compile(*specs["bool"]))
    s2.admit(0, ids, grammar=g)
    s2.admit(3, ids[:40])
    s2.spec_step({0: [], 3: ds.draft(ids[:40], 4)})
    got0 = []
    for _ in range(4):
        for t in s2.step(8)[0]:
            if g.done or g.at_terminal:
                break
            got0.append(int(t))
            g.advance(int(t))
    s2.release(0)
    s2.release(3)
    g.close()
    grammar_valid(grammar_replay(tok, g.grammar, got0), "post-warmup session row")
    after = eng.graph_stats()
    warm = {"phase": "grammar_warmup", "setup": "llama32_1b batch 16 paged int8 grammar",
            "warmup_s": stats["warmup_seconds"], "captures": stats["captures"],
            "graph_pool_bytes": stats["pool_bytes"],
            "arena_versions": eng.grammar.version - v0,
            "arena": eng.grammar.snapshot(), "upload_ms_per_install": uploads,
            "whole_table_upload_ms": whole,
            "table_storage_fixed": eng._gr_table.data_ptr() == ptr,
            "recaptures_after_warmup": after["recaptures_after_warmup"]}
    log(json.dumps(warm))
    assert comp.compile(*evicting[0]).key not in eng.grammar._spans, "no install evicted"
    assert warm["table_storage_fixed"], "the grammar table moved"
    assert after["recaptures_after_warmup"] == 0, "a capture after warmup on the grammar trace"
    eng.close()
    return {**out, "warmup": warm}


GRAMMAR_AB_TOKENS = 64
GRAMMAR_PROFILE_TOKENS = 16
GRAMMAR_VERIFY_ROUNDS = 20


def verify_round_ms(torch, eng, t: int) -> float:
    """The device time of one graphed verify round of t tokens a row (every
    row live at PROMPT's end, FREE states), from CUDA events over
    GRAMMAR_VERIFY_ROUNDS rounds after a warm one."""
    import numpy as np

    b = eng.batch
    pos = np.full((b,), 112, np.int64) if b > 1 else 112
    feed = np.zeros((b, t), np.int64)
    kvb = eng._kv_bucket(112 + t)
    eng._dispatch_verify(feed, pos, kvb)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(GRAMMAR_VERIFY_ROUNDS):
        eng._dispatch_verify(feed, pos, kvb)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / GRAMMAR_VERIFY_ROUNDS


def grammar_ab(torch, mp: str, tok) -> dict:
    """What the arena costs, engines with and without it: graphed batch-1
    contiguous decode after PROMPT (every step masked at the FREE state, as
    the CLI's default engine decodes) and 8-step chunks of a batch-16 paged
    int8 session. In turns (without, with, with, without): decode tok/s of
    GRAMMAR_AB_TOKENS batch-1 tokens and of four batch-16 chunks (host
    wall to a synchronize), and verify rounds of 5 tokens at batch 1 and 9
    at batch 16 (CUDA events). Once an arm under torch.profiler (stable
    counts, so one window each): busy ms and graph nodes a token over
    GRAMMAR_PROFILE_TOKENS batch-1 tokens and over one batch-16 chunk."""
    from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
    from distributed_llama_tpu_torch.runtime.engine import GenerationResult

    ids = tok.encode(PROMPT)
    pos = len(ids) - 1
    one = {on: spec_engine(mp, kv_layout="contiguous", grammar=on) for on in (False, True)}
    sixteen = {on: spec_engine(mp, batch=16, kv_layout="paged", cache_dtype="int8", grammar=on)
               for on in (False, True)}
    prompts = [ids[: 16 + (len(ids) - 16) * i // 15] for i in range(16)]
    sessions = {}
    for on, eng in sixteen.items():
        speculate(eng, 8)
        s = sessions[on] = BatchSession(eng)
        for r in range(16):
            s.admit(r, prompts[r])

    def setup(eng):
        eng.reset()
        eng.prefill(ids[:-1])

    def decode(eng, n):
        res = GenerationResult(tokens=list(ids), n_prompt_tokens=len(ids))
        eng._decode_device(res, ids[-1], pos, pos + n, None, None, None, time.perf_counter())

    def chunks(s, k=4):
        if s.pos.max() + k * 8 + 1 > MAX_SEQ_LEN:
            raise AssertionError("the batch-16 A/B session ran out of context")
        for _ in range(k):
            s.step(8)

    arm = {False: "without arena", True: "with arena"}
    out = {"phase": "grammar_ab", "tokens": GRAMMAR_AB_TOKENS,
           "profiled_tokens": GRAMMAR_PROFILE_TOKENS}
    rates = {k: {False: [], True: []} for k in ("batch 1 tok/s", "batch 16 tok/s",
                                                "verify ms batch 1 t 5", "verify ms batch 16 t 9")}
    for on in (False, True, True, False):
        for eng in (one[on], one[on]):  # a warm run, then the timed one
            setup(eng)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(eng, GRAMMAR_AB_TOKENS)
            torch.cuda.synchronize()
        rates["batch 1 tok/s"][on].append(GRAMMAR_AB_TOKENS / (time.perf_counter() - t0))
        chunks(sessions[on], 1)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks(sessions[on])
        torch.cuda.synchronize()
        rates["batch 16 tok/s"][on].append(4 * 8 * 16 / (time.perf_counter() - t0))
    for on in (False, True):
        out[f"batch 1 profiled {arm[on]}"] = profile_window(
            torch, f"llama32_1b batch 1 contiguous {arm[on]}",
            partial(decode, one[on], GRAMMAR_PROFILE_TOKENS), GRAMMAR_PROFILE_TOKENS,
            setup=partial(setup, one[on]))
        out[f"batch 16 profiled {arm[on]}"] = profile_window(
            torch, f"llama32_1b batch-16 paged int8 chunk {arm[on]}",
            partial(chunks, sessions[on], 1), 8 * 16)
    # after the decode: a round writes junk KV at PROMPT's end in every row
    for on in (False, True, True, False):
        one[on].reset()
        rates["verify ms batch 1 t 5"][on].append(verify_round_ms(torch, one[on], 5))
        rates["verify ms batch 16 t 9"][on].append(verify_round_ms(torch, sixteen[on], 9))
    for key, v in rates.items():
        out[key] = {arm[on]: v[on] for on in (False, True)}
    for key in [k for k in out if " profiled " in k]:
        out[key] = {k: out[key][k] for k in AB_KEYS}
    log(json.dumps(out))
    for eng in (*one.values(), *sixteen.values()):
        eng.close()
    return out


def grammar_phase(torch, mp: str, tp: str, counters, expected) -> dict:
    """Phase 5e at Llama-3.2-1B width, counted as one path: every launch
    counter set to 0 just before and read just after."""
    from distributed_llama_tpu_torch.runtime.grammar import GrammarCompiler
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    tok = Tokenizer(tp)
    t0 = time.perf_counter()
    comp = GrammarCompiler(tok, vocab_size=LLAMA32_1B["vocab_size"])
    for spec in grammar_specs().values():
        comp.compile(*spec)
    log(json.dumps({"phase": "grammar_compile", "vocab": LLAMA32_1B["vocab_size"],
                    "seconds": time.perf_counter() - t0,
                    "states": {k: comp.compile(*v).n_states for k, v in grammar_specs().items()}}))
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    for layout, kv in (("contiguous", None), ("paged", None), ("paged", "int8")):
        grammar_layout(torch, mp, tok, comp, layout, kv)
        release(torch)
    grammar_session(torch, mp, tok, comp)
    release(torch)
    grammar_ab(torch, mp, tok)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    check_launched(launches, expected, "the grammar phase")
    return launches


def grammar_moe(torch, eng, tp: str, counters, expected) -> dict:
    """Phase 5e at Qwen3-30B-A3B width on the phase-5b engine (built with
    the arena): one constrained greedy generate of GRAMMAR_STEPS tokens
    under the open object (an unbounded string and integer), 0 illegal
    tokens, counted as its own path."""
    from distributed_llama_tpu_torch.runtime.grammar import GrammarCompiler, GrammarSession
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    tok = Tokenizer(tp)
    g = GrammarCompiler(tok, vocab_size=QWEN3_30B_A3B["vocab_size"]).compile(
        *grammar_specs()["open"])
    ids = tok.encode(PROMPT)
    speculate(eng, 0)
    eng.reset()
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    s = GrammarSession(eng.grammar, g)
    t0 = time.perf_counter()
    res = eng.generate(ids, len(ids) - 1 + GRAMMAR_STEPS, grammar=s)
    wall = time.perf_counter() - t0
    s.close()
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    check = grammar_replay(tok, g, res.tokens[len(ids):])
    out = {"phase": "grammar", "setup": "qwen3_30b_a3b batch 1 contiguous",
           "arena_states": eng.grammar.n_states, "arena_bytes": eng._gr_table.numel() * 4,
           "wall_s": wall, **check, "launches": launches}
    log(json.dumps(out))
    grammar_valid(check, "30B-A3B constrained generate", must_finish=False)
    check_launched(launches, expected, "the 30B-A3B grammar run")
    return launches


# ---------------------------------------------------------------------------
# phase 5g: the OpenAI-compatible server (server/api.py)
# ---------------------------------------------------------------------------

# the greedy requests' budget, and the shared system prompt (~330 byte
# tokens after the template: it covers the prefix cache's 256 bucket)
SERVER_MAX_TOKENS = 32
SERVER_SYSTEM = ("You are a careful assistant. Answer briefly, cite nothing, and keep to "
                 "the facts the user gives you. ") * 3
SERVER_USERS = ("Name a colour.", "Count to five.", "Say hello.", "Pick a number.",
                "Spell cat.", "Name a fruit.", "Describe the sea.", "Say goodbye.")
# the batch-8 server's burst: eight requests at once
SERVER_BURST = 8


class _Server:
    """One port server on 127.0.0.1 and a free port, started through
    `server.api.serve` as `python -m distributed_llama_tpu_torch.server.api`
    starts it; `start_s` is serve()'s wall: the engine's load plus warmup."""

    def __init__(self, mp: str, tp: str, extra):
        import socket
        import threading

        from distributed_llama_tpu_torch.cli import build_arg_parser
        from distributed_llama_tpu_torch.server import api

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        self.port = s.getsockname()[1]
        s.close()
        p = build_arg_parser()
        p.add_argument("--port", type=int)
        p.add_argument("--host")
        args = p.parse_args(
            ["inference", "--model", mp, "--tokenizer", tp, "--chat-template", "chatml",
             "--max-seq-len", str(MAX_SEQ_LEN), "--temperature", "0", "--device", "cuda",
             "--host", "127.0.0.1", "--port", str(self.port), *extra])
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            self.httpd = api.serve(args)
        self.start_s = time.perf_counter() - t0
        self.state = self.httpd.api_state
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def request(self, method: str, path: str, body=None, timeout=300):
        """(status, body bytes, seconds to the response's first body byte)."""
        import urllib.error
        import urllib.request

        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}", data=data,
                                     method=method, headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                first = r.read(1)
                t_first = time.perf_counter() - t0
                return r.status, first + r.read(), t_first
        except urllib.error.HTTPError as e:
            return e.code, e.read(), time.perf_counter() - t0

    def chat(self, messages, **kw) -> dict:
        code, body, _ = self.request("POST", "/v1/chat/completions",
                                     {"messages": messages, "max_tokens": SERVER_MAX_TOKENS, **kw})
        assert code == 200, f"chat answered {code}: {body[:300]!r}"
        return json.loads(body)

    def sse(self, messages) -> tuple:
        """(the streamed text, seconds to the first chunk)."""
        code, body, t_first = self.request(
            "POST", "/v1/chat/completions",
            {"messages": messages, "max_tokens": SERVER_MAX_TOKENS, "stream": True})
        assert code == 200, f"SSE answered {code}"
        events = [e for e in body.decode().split("\r\n\r\n") if e.strip()]
        assert events[-1].strip() == "data: [DONE]", "SSE stream without [DONE]"
        chunks = [json.loads(e[len("data: "):])["choices"][0] for e in events[:-1]]
        assert chunks[-1]["finish_reason"] == "stop"
        return "".join(c.get("delta", {}).get("content", "") for c in chunks), t_first

    def get(self, path: str):
        code, body, _ = self.request("GET", path)
        assert code == 200, f"GET {path} answered {code}: {body[:300]!r}"
        return body.decode()

    def hist(self) -> dict:
        """The unlabeled TTFT and per-output-token histograms' sums and
        counts from /metrics (the server's own clocks)."""
        text = self.get("/metrics")
        out = {}
        for name in ("ttft_ms", "tpot_ms"):
            for part in ("sum", "count"):
                m = re.search(rf"^dlt_{name}_{part} ([0-9.e+-]+)$", text, re.M)
                out[f"{name}_{part}"] = float(m.group(1)) if m else 0.0
        return out

    def counters(self) -> dict:
        return json.loads(self.get("/stats"))["steps"]["counters"]

    def wait_serving(self, timeout_s=300.0) -> float:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout_s:
            code, _, _ = self.request("GET", "/health")
            if code == 200:
                return time.perf_counter() - t0
            time.sleep(0.02)
        raise AssertionError("the server did not rejoin after the failure")

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)


def _messages(user: str, system: str | None = None) -> list:
    return ([{"role": "system", "content": system}] if system else []) + [
        {"role": "user", "content": user}]


def _timed(srv: _Server, messages, **kw) -> dict:
    """One request alone: its response, and the server's TTFT and mean
    per-output-token ms for it (the histograms' deltas, one request)."""
    h0 = srv.hist()
    out = srv.chat(messages, **kw)
    h1 = srv.hist()
    d = {k: h1[k] - h0[k] for k in h0}
    assert d["ttft_ms_count"] == 1, f"one request moved the TTFT count by {d['ttft_ms_count']}"
    tpot = d["tpot_ms_sum"] if d["tpot_ms_count"] else None
    g = out["usage"]["goodput"]
    return {"response": out, "content": out["choices"][0]["message"]["content"],
            "ttft_ms": d["ttft_ms_sum"], "decode_tok_s": 1e3 / tpot if tpot else None,
            "completion_tokens": out["usage"]["completion_tokens"],
            "prefix_hit_tokens": g["prefix_hit_tokens"], "spec_accepted": g["spec_accepted_tokens"]}


def reference_text(torch, srv: _Server, messages) -> tuple:
    """What `engine.generate` gives on the server's engine for the same
    prompt, greedy, through the server's text path (the stream decoder and
    the stop detector): (text, tokens until the stop)."""
    from distributed_llama_tpu_torch.tokenizer import (
        EOS_FOUND, EOS_MAYBE, ChatItem, EosDetector, Sampler,
    )

    st = srv.state
    tok, eng = st.tokenizer, st.engine
    prompt = st.template.generate([ChatItem(m["role"], m["content"]) for m in messages], True)
    ids = tok.encode(prompt.content, is_start=True)
    res = eng.generate(ids, len(ids) - 1 + SERVER_MAX_TOKENS,
                       sampler=Sampler(eng.cfg.vocab_size, 0.0, 0.9, 12345))
    torch.cuda.synchronize()
    width = max((len(s) for s in st.stops), default=0)
    det = EosDetector(tok.eos_token_ids, st.stops, width, width)
    dec = tok.stream_decoder()
    text, n = [], 0
    for t in res.tokens[len(ids):]:
        n += 1
        kind = det.append(t, dec.decode(t))
        if kind != EOS_MAYBE:
            text.append(det.get_delta() or "")
            det.reset()
        if kind == EOS_FOUND:
            break
    return "".join(text), n


def _poison(srv: _Server, batched: bool):
    """The next engine call fails: batch 1 through `generate` (the
    serialized path), batch 8 through the session's chunk and verify round
    (the Batcher loop). The rebuild replaces the engine, and the poison
    with it."""
    def boom(*a, **k):
        raise RuntimeError("injected engine failure")

    eng = srv.state.engine
    if batched:
        eng._decode_batch = boom
        eng._dispatch_verify = boom
    else:
        eng.generate = boom


def _burst(srv: _Server, users, kws=None) -> tuple:
    """Every prompt at once, each from its own thread, request i with the
    body fields `kws[i]`: (responses, wall s)."""
    import threading

    out = [None] * len(users)

    def one(i):
        out[i] = srv.chat(_messages(users[i]), **(kws[i] if kws else {}))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(users))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, time.perf_counter() - t0


def _first_diff(a: str, b: str):
    """Where two texts part (None: equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def server_run(torch, mp: str, tp: str, extra, counters, expected, name: str,
               full: bool = True) -> dict:
    """One server of phase 5g, its counters set to 0 just before the first
    request and read after the last. Each prompt alone first, timed by the
    server's own histograms; at batch 8 all eight at once, greedy (the
    aggregate tok/s). With `full`: at batch 8 each alone again seeded and
    sampled and the eight at once; a non-stream and an SSE request at once from
    threads, two requests sharing the system prompt (the second must hit
    the prefix cache), one under `response_format` (a JSON schema), the
    views, a request's trace, and one forced engine failure (a 500, the
    rebuild, then the tokens of before and the card's memory back within
    one graph pool). Then, with the Batcher stopped, each greedy response
    against `engine.generate` on the server's engine.

    What must be equal: seeded sampled rows of the burst and their alone
    runs (a sampled row never speculates, and its stream is its seed's:
    the JAX Batcher's contract); greedy rows and their alone runs,
    and greedy responses and `engine.generate`, where the server does not
    speculate at batch > 1. With ngram speculation at batch > 1 a greedy
    token is computed by a verify round (K2, bf16) or a decode step (K1,
    Q80 activations) as the row's co-tenants' drafts (or generate's own
    loop) schedule them, so a near-tie may part the texts: reported
    (`greedy_parts`), not required."""
    batched = "--batch" in extra
    speculates = "off" not in extra
    greedy_exact = not (batched and speculates)
    srv = _Server(mp, tp, extra)
    try:
        st = srv.state
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        users = SERVER_USERS[:SERVER_BURST if batched else 2]
        alone = {u: _timed(srv, _messages(u)) for u in users}
        r1 = alone[users[0]]
        out = {"phase": "server", "setup": name, "args": list(extra), "start_s": srv.start_s,
               "warmup_s": st.engine.warmup_seconds}
        greedy_parts = {}
        if batched:
            if full:
                seeded = [dict(temperature=0.8, top_p=0.9, seed=100 + i)
                          for i in range(len(users))]
                sampled_alone = [srv.chat(_messages(u), **kw) for u, kw in zip(users, seeded)]
                together, wall = _burst(srv, users, seeded)
                for u, a, b in zip(users, sampled_alone, together):
                    assert b["choices"][0]["message"]["content"] == \
                        a["choices"][0]["message"]["content"], \
                        f"{name}: a seeded sampled row of the burst differs from its run alone ({u!r})"
                n_s = sum(r["usage"]["completion_tokens"] for r in together)
                out["sampled_burst"] = {"tok_s": n_s / wall, "wall_s": wall}
            greedy, gwall = _burst(srv, users)
            for u, r in zip(users, greedy):
                d = _first_diff(r["choices"][0]["message"]["content"], alone[u]["content"])
                if d is not None:
                    greedy_parts[u] = d
            assert not (greedy_exact and greedy_parts), \
                f"{name}: greedy rows of the burst part from their runs alone at {greedy_parts}"
            n_g = sum(r["usage"]["completion_tokens"] for r in greedy)
            out["burst"] = {"requests": len(users), "greedy_tok_s": n_g / gwall,
                            "greedy_wall_s": gwall, "greedy_parts_from_alone": greedy_parts}
        if full:
            out.update(_server_surface(torch, srv, name, batched, r1, alone, users, greedy_exact))
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in counters}
        out["recaptures_after_warmup"] = st.engine.graph_stats(live=False)[
            "recaptures_after_warmup"]
        assert out["recaptures_after_warmup"] == 0, f"{name}: a capture after warmup"
        # each greedy response against engine.generate on the server's
        # engine, with the Batcher stopped: this thread owns it now
        if st.batcher is not None:
            st.batcher.stop()
        generate_parts = {}
        for u, r in alone.items():
            text, n = reference_text(torch, srv, _messages(u))
            d = _first_diff(r["content"], text)
            if d is not None or r["completion_tokens"] != n:
                generate_parts[u] = d
        assert not (greedy_exact and generate_parts), \
            f"{name}: responses part from engine.generate at {generate_parts}"
        from distributed_llama_tpu_torch.probes import timing

        out.update({
            "requests": [{"user": u, **{k: r[k] for k in (
                "ttft_ms", "decode_tok_s", "completion_tokens", "prefix_hit_tokens",
                "spec_accepted")}} for u, r in alone.items()],
            "generate_checked": len(alone), "generate_parts": generate_parts,
            "launches": launches, "card": timing.card_line()})
        log(json.dumps(out))
        check_launched(launches, expected, f"the {name} server")
        return launches
    finally:
        srv.close()


def _server_surface(torch, srv: _Server, name: str, batched: bool, r1: dict, alone: dict,
                    users, greedy_exact: bool) -> dict:
    """The rest of a full server run (see `server_run`); returns its
    numbers. The non-stream and SSE pair run as co-tenants at batch 8: held
    to their runs alone as `server_run` holds the greedy burst."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    st = srv.state
    first = _messages(users[0])
    # a non-stream request and an SSE one at once, from threads
    with ThreadPoolExecutor(2) as ex:
        a = ex.submit(srv.chat, first)
        b = ex.submit(srv.sse, _messages(users[1]))
        ns, (sse_text, sse_first_s) = a.result(), b.result()
    pair_parts = {k: d for k, d in (
        ("non-stream", _first_diff(ns["choices"][0]["message"]["content"], r1["content"])),
        ("sse", _first_diff(sse_text, alone[users[1]]["content"]))) if d is not None}
    assert not (greedy_exact and pair_parts), \
        f"{name}: the non-stream and SSE pair part from their runs alone at {pair_parts}"
    # two requests sharing the system prompt: the second hits
    shared = [_timed(srv, _messages(u, SERVER_SYSTEM)) for u in users[:2]]
    assert shared[1]["prefix_hit_tokens"] > 0, f"{name}: the shared prompt missed the cache"
    # a constrained request
    rf = {"type": "json_schema", "json_schema": {"name": "t", "schema": GRAMMAR_BOOL}}
    constrained = _timed(srv, _messages("Emit the object.", SERVER_SYSTEM), response_format=rf)
    assert isinstance(json.loads(constrained["content"]), dict), \
        f"{name}: the constrained reply is not a JSON object"
    # the views answer
    assert json.loads(srv.get("/health"))["status"] == "ok"
    stats = json.loads(srv.get("/stats"))
    metrics = srv.get("/metrics")
    for series in ("dlt_ttft_ms_bucket", "dlt_tpot_ms_bucket", "dlt_requests_completed_total",
                   "dlt_goodput_tokens_per_s"):
        assert series in metrics, f"{name}: /metrics lacks {series}"
    assert re.search(r'^dlt_steps_total\{kind="(decode|batch_decode|spec_verify)\[', metrics,
                     re.M), f"{name}: /metrics lacks the StepStats series"
    for path in ("/v1/models", "/debug/config", "/debug/hot_prefixes", "/debug/quarantine",
                 "/debug/batch_timeline"):
        srv.get(path)
    code, _, _ = srv.request("POST", "/admin/drain_hint", {"draining": False})
    assert code == 200, f"{name}: /admin/drain_hint answered {code}"
    # the trace id a response echoes, read back from /debug/trace
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/chat/completions",
        data=json.dumps({"messages": first, "max_tokens": 4}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        tid = r.headers["X-DLT-Trace-Id"]
        r.read()
    spans = sorted({e["name"] for e in json.loads(srv.get(f"/debug/trace?id={tid}"))["events"]})
    assert "request" in spans, f"{name}: the trace lacks its request span"
    # the forced failure: a 500, the rebuild, then the tokens of before
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    pool_before = st.engine.warm_pool_bytes
    old = st.engine
    _poison(srv, batched)
    t0 = time.perf_counter()
    code, body, _ = srv.request("POST", "/v1/chat/completions",
                                {"messages": first, "max_tokens": SERVER_MAX_TOKENS})
    assert code == 500 and b"engine error" in body, f"{name}: the failure answered {code}"
    srv.wait_serving()
    recovery_s = time.perf_counter() - t0
    assert st.engine is not old and old.closed, f"{name}: no rebuild"
    del old
    srv.get("/debug/flightrecord")  # the recovery's post-mortem
    again = _timed(srv, first)
    assert again["content"] == r1["content"], f"{name}: after the rebuild, other tokens"
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    pool_after = st.engine.warm_pool_bytes
    assert abs(mem_after - mem_before) <= max(pool_before, pool_after), \
        f"{name}: memory {mem_before} -> {mem_after} past one graph pool"
    return {
        "pool_bytes": pool_before, "recovery_s": recovery_s, "pair_parts": pair_parts,
        # beside a non-stream request (a batch-1 server serves one at a time)
        "sse_first_chunk_ms": sse_first_s * 1e3,
        "shared": [{k: r[k] for k in ("ttft_ms", "decode_tok_s", "prefix_hit_tokens")}
                   for r in shared],
        "constrained": {"content": constrained["content"], "ttft_ms": constrained["ttft_ms"],
                        "decode_tok_s": constrained["decode_tok_s"]},
        "again_ttft_ms": again["ttft_ms"], "memory_before": mem_before,
        "memory_after": mem_after, "trace_spans": spans, "stats_sections": sorted(stats),
    }


def server_phase(torch, mp: str, tp: str, counters) -> dict:
    """Phase 5g at Llama-3.2-1B width, three servers, each its own path:
    (a) batch 1 at the CLI's defaults (paged bf16, ngram, the prefix cache,
    the grammar arena), (b) `--batch 8 --kv-dtype int8`, (c) the same with
    `--speculative off`, lean: the greedy burst and `engine.generate`
    held exactly. Returns {path: launches}."""
    from distributed_llama_tpu_torch.ops import cuda_attention as ca
    from distributed_llama_tpu_torch.ops import cuda_q40 as q

    base = (q.q40_gemv_q80_stacked, q.q40_gemv_q80, q.q40_gemm_bf16_stacked)
    int8 = ("--batch", "8", "--kv-dtype", "int8")
    paths = {}
    for path, extra, expected, name, full in (
            ("llama32_1b server batch 1 (the CLI defaults)", (), base, "batch 1", True),
            ("llama32_1b server batch 8 paged int8", int8, (*base, ca.paged_flash_attention),
             "batch 8 int8", True),
            ("llama32_1b server batch 8 paged int8 --speculative off",
             (*int8, "--speculative", "off"), (*base, ca.paged_flash_attention),
             "batch 8 int8 speculation off", False)):
        paths[path] = server_run(torch, mp, tp, extra, counters, expected, name, full=full)
        release(torch)
    return paths


# ---------------------------------------------------------------------------
# phase 5h: the KV movement layer and the device views (runtime/kv_tiering.py,
# server/disagg.py, runtime/profiling.py) through the server
# ---------------------------------------------------------------------------

# three system prompts of more than 256 byte tokens that part at their first
# word: each publishes its own 256-token prefix entry (8 MiB of bf16 pages
# at 1B width), so a budget of one entry evicts on every switch
KV_SYSTEMS = tuple(
    f"{w} assistant: answer briefly, cite nothing, keep to the facts the user gives you, "
    "and say so when you do not know. " * 3
    for w in ("Careful", "Patient", "Honest"))
# server (a): batched (the Batcher applies each promotion on its thread),
# speculation off (greedy rows exact: phase 5g), one 256-token entry of
# prefix cache and of host tier, so demotions spill to disk
KV_ARGS = ("--batch", "4", "--speculative", "off")
KV_TIER_ARGS = (*KV_ARGS, "--prefix-cache-mb", "12")
KV_TIER_ENV = {"DLT_KV_HOST_TIER_MB": "12", "DLT_KV_DISK_TIER_MB": "1024"}
# the rebuild's drain traffic: a 16-token slice queued every KV_FEED_S, at
# most KV_FEED_MAX of them (~270 MB of 1B KV), so the disk tier's budget
# keeps the real entries the promotions after the rebuild need
KV_FEED_S, KV_FEED_MAX = 0.02, 500
KV_PROFILE_MS = 200
# the profiled burst's requests: ~1 s of decode each at batch 4
KV_BURST_TOKENS = 256


@contextlib.contextmanager
def _env(values: dict):
    import os

    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _wait_for(cond, what: str, timeout_s: float = 60.0) -> float:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if cond():
            return time.perf_counter() - t0
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _metric(text: str, name: str):
    m = re.search(rf"^{re.escape(name)} ([0-9.e+-]+)$", text, re.M)
    return float(m.group(1)) if m else None


def _matmul_params(h: dict) -> int:
    """Weight elements one token's matmuls read (the analytic decode FLOPs
    are twice this): q, k, v, o, w1, w2, w3 a layer and the classifier."""
    qd, kvd = h["n_heads"] * h["head_dim"], h["n_kv_heads"] * h["head_dim"]
    per_layer = h["dim"] * qd + 2 * h["dim"] * kvd + qd * h["dim"] + 3 * h["dim"] * h["hidden_dim"]
    return h["n_layers"] * per_layer + h["dim"] * h["vocab_size"]


def _profile_during_burst(srv: "_Server") -> dict:
    """/debug/profile?ms=KV_PROFILE_MS while four clients keep the Batcher
    decoding (each sends long requests until both captures have answered:
    the profiler's start and stop take up to seconds, and the recorded
    window must still hold the Batcher's work), a second capture refused
    with 409, and what the trace holds of the Batcher's work: kernel events
    (the port's kernels and glue, in or out of graph replays) and graph
    launches."""
    import threading

    out, codes, chats = {}, {}, []
    batcher = srv.state.batcher
    stop = threading.Event()

    def chat(i):
        while not stop.is_set():
            chats.append(srv.request("POST", "/v1/chat/completions", {
                "messages": _messages(SERVER_USERS[i], KV_SYSTEMS[i % len(KV_SYSTEMS)]),
                "max_tokens": KV_BURST_TOKENS})[0])

    def profile(key):
        code, body, _ = srv.request("GET", f"/debug/profile?ms={KV_PROFILE_MS}")
        codes[key] = code
        if code == 200:
            out.update(json.loads(body))

    threads = [threading.Thread(target=chat, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    try:
        _wait_for(lambda: any(r is not None and not r.prefilling
                              for r in list(batcher.slots)), "a decoding row")
        first = threading.Thread(target=profile, args=("first",))
        first.start()
        time.sleep(0.05)
        profile("second")
        first.join()
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert codes == {"first": 200, "second": 409}, f"profile answers {codes}"
    assert chats and set(chats) == {200}, f"the burst answered {chats}"
    with open(out["perfetto_trace"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    graph_launches = [e for e in events if e.get("name") in GRAPH_LAUNCH_CALLS]
    port_kernels = [e for e in kernels if any(
        s in e.get("name", "") for s in ("q40_", "flash", "paged", "gemv", "gemm"))]
    cats = {}
    for e in events:
        cats[str(e.get("cat"))] = cats.get(str(e.get("cat")), 0) + 1
    assert kernels or graph_launches, \
        f"the profile holds none of the Batcher's work: {cats}, {len(events)} events"
    names = sorted({e["name"][:60] for e in port_kernels})[:6]
    return {"wall_ms": out["wall_ms"], "files": out["files"], "categories": cats,
            "kernel_events": len(kernels),
            "port_kernel_events": len(port_kernels), "graph_launches": len(graph_launches),
            "port_kernel_names": names,
            "seen_as": ("kernels in graph replays" if port_kernels else "graph launches")}


def kv_tier_run(torch, mp: str, tp: str) -> tuple:
    """Phase 5h (a) and (c) on one server, `KV_TIER_ARGS` with host and disk
    tiers: three prompts past one entry's budget demote and spill; a disk
    and a host promotion each equal their cold run and `engine.generate`;
    the cost table, the ledger, the roofline gauges and a profile during a
    burst; then a rebuild while demotions drain, with 0 recaptures and the
    tokens of before. Returns (the phase's numbers, the cold answers by
    system prompt)."""
    t0 = time.perf_counter()
    disk = BUILD / "smoke" / "kvtier"
    if disk.exists():
        for f in disk.iterdir():
            f.unlink()
    # what the process holds on the card before the server (earlier
    # phases' leftovers): the ledger measures the whole process's reserve
    reserved0 = torch.cuda.memory_stats()["reserved_bytes.all.current"]
    with _env(dict(KV_TIER_ENV, DLT_KV_DISK_TIER_DIR=str(disk))):
        srv = _Server(mp, tp, KV_TIER_ARGS)
    try:
        st = srv.state
        store = st.kv_tier
        assert store is not None and st.engine.prefix_cache.tier is store
        user = SERVER_USERS[0]

        def demoted(n):  # the drain landed n demotions in host RAM
            _wait_for(lambda: st.engine.stats.counters_snapshot().get(
                "kv_tier_demoted_host", 0) >= n, f"demotion {n}")

        cold = {}
        for i, system in enumerate(KV_SYSTEMS):  # A, B, C: each evicts the last
            cold[i] = _timed(srv, _messages(user, system))
            demoted(i)
        assert store.snapshot()["disk"]["entries"] >= 1, "no spill to disk"
        c0 = srv.counters()
        # A: evicted first, spilled to disk (B's demotion pushed it out of
        # host RAM); its insert evicts C, demoted into host RAM
        prom_disk = _timed(srv, _messages(user, KV_SYSTEMS[0]))
        demoted(3)
        prom_host = _timed(srv, _messages(user, KV_SYSTEMS[2]))
        c1 = srv.counters()
        hits = {t: c1.get(f"kv_tier_hits_{t}", 0) - c0.get(f"kv_tier_hits_{t}", 0)
                for t in ("host", "disk")}
        assert hits == {"host": 1, "disk": 1}, f"tier hits {hits}"
        assert prom_disk["content"] == cold[0]["content"], "a disk promotion changed the tokens"
        assert prom_host["content"] == cold[2]["content"], "a host promotion changed the tokens"
        for r in (prom_disk, prom_host):
            assert r["prefix_hit_tokens"] >= 256, f"promoted, then missed: {r['prefix_hit_tokens']}"
        promotion_us = [r["response"]["usage"]["goodput"]["promotion_us"]
                        for r in (prom_disk, prom_host)]
        tiering = {
            "demoted": {t: c1.get(f"kv_tier_demoted_{t}", 0) for t in ("host", "disk")},
            "demoted_bytes": c1.get("kv_tier_demoted_bytes", 0),
            "hits": hits, "promotions": c1.get("kv_tier_promotions", 0),
            "promotion_us_disk_host": promotion_us,
            "prefix_hit_tokens": [prom_disk["prefix_hit_tokens"], prom_host["prefix_hit_tokens"]],
            "ttft_ms_cold_vs_promoted": {"disk": [cold[0]["ttft_ms"], prom_disk["ttft_ms"]],
                                         "host": [cold[2]["ttft_ms"], prom_host["ttft_ms"]]},
            "tiers": {k: store.snapshot()[k] for k in ("host", "disk")},
        }

        tiering["seconds"] = time.perf_counter() - t0
        tiering["start_s"] = srv.start_s
        t0 = time.perf_counter()
        # (c) the device views
        costs = json.loads(srv.get("/debug/costs"))
        eng = st.engine
        plan = eng.cost_plan()
        assert costs["coverage"]["complete"] and not costs.get("failures"), costs.get("coverage")
        assert costs["n_entries"] == costs["coverage"]["plan_size"] == len(plan)
        kinds = {e["kind"] for e in costs["entries"]}
        assert kinds == {"prefill", "decode", "prefill_row", "batch_decode", "page_copy",
                         "page_extract", "page_insert"}, kinds
        table = eng.cost_table(build=False)
        dec = table.entries[("batch_decode", 1, 256)]
        band = dec.flops_per_token / (2.0 * _matmul_params(LLAMA32_1B))
        assert 1.0 <= band <= 1.5, f"decode FLOPs a token {band:.4f} x the analytic"
        metrics = srv.get("/metrics")
        shares = {g: _metric(metrics, f"dlt_{g}") for g in
                  ("mfu", "bw_utilization", "device_duty_cycle")}
        for g, v in shares.items():
            assert v is not None and 0.0 <= v <= 1.0, f"dlt_{g} = {v}"
        comps = {m.group(1): float(m.group(2)) for m in re.finditer(
            r'^dlt_hbm_bytes\{component="([a-z_]+)"\} ([0-9.e+-]+)$', metrics, re.M)}
        for c in ("weights", "rope", "kv_cache", "unattributed"):
            assert c in comps, f"dlt_hbm_bytes lacks {c}"
        modeled = sum(v for c, v in comps.items() if c != "unattributed")
        measured = modeled + comps["unattributed"]
        ratio = (comps["weights"] + comps["kv_cache"]) / (measured - reserved0)
        assert 0.6 <= ratio <= 1.0, \
            f"modeled weights + KV {ratio:.3f} of the bytes the server reserved"
        profile = _profile_during_burst(srv)
        views = {
            "cost_entries": costs["n_entries"], "cost_kinds": sorted(kinds),
            "batch_decode_1_kv256": {"flops_per_token": dec.flops_per_token,
                                     "bytes_per_token": dec.bytes_per_token,
                                     "analytic_ratio": band,
                                     "kernel_share_flops": dec.kernel_flops / dec.flops,
                                     "kernel_share_bytes": dec.kernel_bytes / dec.bytes_accessed},
            "gauges": shares, "hbm_bytes": comps, "reserved_before_server": reserved0,
            "weights_kv_over_measured": ratio,
            "headroom_bytes": _metric(metrics, "dlt_hbm_headroom_bytes"),
            "profile": profile, "seconds": time.perf_counter() - t0,
        }
        t0 = time.perf_counter()

        # a rebuild while demotions drain: this thread keeps the drain busy
        # (16-token slices on the card queued as captures) until the new
        # engine serves; the rebuild's captures and the drain's copies both
        # take CAPTURE_LOCK
        c = st.engine.cfg
        junk = torch.randn((c.n_layers, 16, c.n_kv_heads, c.head_dim), device=st.engine.device,
                           dtype=st.engine.cache.k.dtype)
        torch.cuda.synchronize()
        drift0 = srv.counters().get("hbm_drift_events", 0)
        old = st.engine
        _poison(srv, batched=True)
        import queue
        import threading

        stop = threading.Event()
        queued = [0]

        def feed():
            while not stop.is_set() and queued[0] < KV_FEED_MAX:
                try:
                    store._demote_q.put_nowait(
                        (tuple([7] * 15 + [1000 + queued[0]]), junk, junk))
                    queued[0] += 1
                except queue.Full:
                    pass
                time.sleep(KV_FEED_S)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        t0 = time.perf_counter()
        code, body, _ = srv.request("POST", "/v1/chat/completions", {
            "messages": _messages(user, KV_SYSTEMS[1]), "max_tokens": SERVER_MAX_TOKENS})
        assert code == 500, f"the forced failure answered {code}"
        srv.wait_serving()
        recovery_s = time.perf_counter() - t0
        stop.set()
        feeder.join()
        del junk
        assert st.engine is not old and old.closed, "no rebuild"
        del old
        gs = st.engine.graph_stats(live=False)
        assert gs["recaptures_after_warmup"] == 0 and (
            gs["captures"] > 0 or st.engine.device.type != "cuda"), gs
        c2 = srv.counters()

        def landed():  # the queued slices that reached a tier
            with store._lock:
                return sum(1 for t in (*store._host, *store._disk) if len(t) == 16 and t[0] == 7)

        _wait_for(lambda: landed() == queued[0] > 0, f"{queued[0]} queued slices in the tiers")
        drained = landed()
        again = {i: _timed(srv, _messages(user, KV_SYSTEMS[i])) for i in (0, 2)}
        for i, r in again.items():
            assert r["content"] == cold[i]["content"], f"after the rebuild, prompt {i} differs"
            assert r["prefix_hit_tokens"] >= 256, \
                f"after the rebuild, prompt {i} was not promoted ({r['prefix_hit_tokens']})"
        drift = srv.counters().get("hbm_drift_events", 0) - drift0
        srv.get("/metrics")  # the new engine's first reconcile
        assert srv.counters().get("hbm_drift_events", 0) - drift0 == drift == 0, \
            "hbm_drift_events moved across the rebuild"
        rebuild = {"recovery_s": recovery_s, "captures": gs["captures"],
                   "recaptures_after_warmup": gs["recaptures_after_warmup"],
                   "demotions_queued": queued[0], "demotions_drained": drained,
                   "dropped": c2.get("kv_tier_demote_dropped", 0),
                   "promoted_after": {i: again[i]["prefix_hit_tokens"] for i in again},
                   "hbm_drift_events": drift, "seconds": time.perf_counter() - t0}
        assert st.engine.graph_stats(live=False)["recaptures_after_warmup"] == 0
        # each cold answer against engine.generate, the Batcher stopped
        st.batcher.stop()
        for i in (0, 2):
            text, n = reference_text(torch, srv, _messages(user, KV_SYSTEMS[i]))
            assert text == cold[i]["content"], f"prompt {i}: the server parts from generate"
        return {"tiering": tiering, "views": views, "rebuild": rebuild}, {
            i: r["content"] for i, r in cold.items()}
    finally:
        srv.close()


def kv_disagg_run(torch, mp: str, tp: str, cold: dict) -> dict:
    """Phase 5h (b): a prefill worker and a decode worker (`KV_ARGS`) in
    this process, greedy: the decode worker's tokens equal server (a)'s on
    the device path and on the HTTP path, a growing prefix ships only its
    missing pages, and a device-path fault degrades with equal tokens."""
    from distributed_llama_tpu_torch.runtime import kv_transport
    from distributed_llama_tpu_torch.server.disagg import DisaggClient

    pf = _Server(mp, tp, ("--role", "prefill"))
    try:
        dec = _Server(mp, tp, (*KV_ARGS, "--role", "decode", "--prefill-peer",
                               f"127.0.0.1:{pf.port}"))
        try:
            st = dec.state
            user = SERVER_USERS[0]
            assert st.disagg.snapshot()["peer_transports"] == {
                f"127.0.0.1:{pf.port}": "device"}
            paths = {}

            def fetched(i, what):
                c0 = dec.counters()
                r = _timed(dec, _messages(user, KV_SYSTEMS[i]))
                c1 = dec.counters()
                assert r["content"] == cold[i], f"{what}: tokens differ from server (a)"
                g = r["response"]["usage"]["goodput"]
                delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in (
                    "disagg_kv_fetched", "disagg_degraded", "disagg_pages_skipped",
                    "kv_transfer_bytes_device", "kv_transfer_bytes_http")}
                return r, g, delta

            r, g, d = fetched(0, "device path")
            assert g["kv_transfer_path"] == "device" and d["disagg_kv_fetched"] == 1
            paths["device"] = {"kv_transfer_us": g["kv_transfer_us"],
                               "remote_prefill_us": g["remote_prefill_us"],
                               "bytes": d["kv_transfer_bytes_device"], "ttft_ms": r["ttft_ms"]}
            old = st.disagg
            st.disagg = DisaggClient(st, old.peers, transport="http")
            try:
                r, g, d = fetched(1, "HTTP path")
            finally:
                st.disagg = old
            assert g["kv_transfer_path"] == "http" and d["disagg_kv_fetched"] == 1
            paths["http"] = {"kv_transfer_us": g["kv_transfer_us"],
                             "remote_prefill_us": g["remote_prefill_us"],
                             "bytes": d["kv_transfer_bytes_http"], "ttft_ms": r["ttft_ms"]}
            kv_transport.set_device_chaos(OSError("injected device-path failure"))
            try:
                r, g, d = fetched(2, "a device-path fault")
            finally:
                kv_transport.set_device_chaos(None)
                st.disagg._backoff_until.clear()
            assert d["disagg_degraded"] == 1 and g["kv_transfer_path"] == "", d
            # a prefix that grows past the 256 entry the worker shipped: the
            # held leading pages are named, not shipped again
            grown = _messages(user, KV_SYSTEMS[0] * 3)
            c0 = dec.counters()
            dec.chat(grown)
            c1 = dec.counters()
            skipped = c1.get("disagg_pages_skipped", 0) - c0.get("disagg_pages_skipped", 0)
            assert skipped > 0, "the growing prefix shipped every page again"
            speed = paths["http"]["kv_transfer_us"] / max(paths["device"]["kv_transfer_us"], 1)
            gs = st.engine.graph_stats(live=False)
            assert gs["recaptures_after_warmup"] == 0
            return {"start_s": [pf.start_s, dec.start_s], "paths": paths,
                    "http_over_device": speed,
                    "device_at_least_3x_faster": speed >= 3.0,
                    "degraded_tokens_equal": True, "pages_skipped": skipped,
                    "worker": {k: v for k, v in pf.counters().items() if k.startswith("disagg")},
                    "recaptures_after_warmup": gs["recaptures_after_warmup"]}
        finally:
            dec.close()
    finally:
        pf.close()


def kv_phase(torch, mp: str, tp: str, counters) -> dict:
    """Phase 5h at Llama-3.2-1B width, through `serve()` on 127.0.0.1: the
    tiered store, the device views and a rebuild under drain traffic on
    server (a), then prefill/decode disaggregation against (a)'s tokens.
    One counted path: the counters are set to 0 before (a) starts serving
    and read after the decode worker's last request. Returns {path:
    launches}."""
    from distributed_llama_tpu_torch.ops import cuda_attention as ca
    from distributed_llama_tpu_torch.ops import cuda_q40 as q
    from distributed_llama_tpu_torch.probes import timing

    t0 = time.perf_counter()
    release(torch)
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    tier, cold = kv_tier_run(torch, mp, tp)
    release(torch)
    disagg = kv_disagg_run(torch, mp, tp, cold)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    release(torch)
    log(json.dumps({"phase": "kv", **tier, "disagg": disagg, "launches": launches,
                    "seconds": time.perf_counter() - t0, "card": timing.card_line()}))
    check_launched(launches, (q.q40_gemv_q80_stacked, q.q40_gemv_q80, q.q40_gemm_bf16_stacked,
                              ca.flash_attention), "phase 5h")
    return {"llama32_1b kv tiers, disaggregation and device views": launches}


# the host-side launch calls a window counts: the CUDA runtime's and the
# low-level cu* entries, plain and extended (a kernel launched as a
# thread-block cluster goes through cudaLaunchKernelEx), and a CUDA graph's
# replay, counted apart as well
GRAPH_LAUNCH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                *GRAPH_LAUNCH_CALLS)


def profile_window(torch, name: str, run, n_tokens: int, share_of=None, setup=None) -> dict:
    """Where a decode window's time goes: torch.profiler over one call of
    `run` (after one warm call), which decodes `n_tokens` tokens; `setup`,
    if given, runs before each call, outside the window. Host wall
    per token; device busy time per token, summed over the device's own
    events (kernels, copies) only: an aten op's device time is its kernels'
    again; the device's idle share; kernels and host-side launch calls per
    token; the top kernels and host ops; with `share_of` ({label: a kernel
    name's substring, or a tuple of them}), each label's share of the
    device busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for call in (setup, run, setup):  # warm
        if call is not None:
            call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    assert on_dev, "the profiler recorded no device events"
    dev_us = sum(e.self_device_time_total for e in on_dev)
    by_dev = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:10]
    by_cpu = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
    out = {
        "phase": "decode_profile", "model": name, "tokens": n_tokens,
        "wall_ms_per_token": wall * 1e3 / n_tokens,
        "device_busy_ms_per_token": dev_us / 1e3 / n_tokens,
        "device_idle_share": 1.0 - (dev_us / 1e6) / wall,
        "kernels_per_token": sum(e.count for e in on_dev) / n_tokens,
        "launch_calls_per_token": sum(
            e.count for e in events if e.key in LAUNCH_CALLS) / n_tokens,
        "graph_launch_calls_per_token": sum(
            e.count for e in events if e.key in GRAPH_LAUNCH_CALLS) / n_tokens,
        "decode_tok_s": n_tokens / wall,
        "top_kernels_ms_per_token": {e.key[:100]: e.self_device_time_total / 1e3 / n_tokens
                                     for e in by_dev},
        "top_host_ops_ms_per_token": {e.key: e.self_cpu_time_total / 1e3 / n_tokens
                                      for e in by_cpu},
    }
    if share_of:
        subs = {label: (sub,) if isinstance(sub, str) else sub for label, sub in share_of.items()}
        out["share"] = {label: sum(e.self_device_time_total for e in on_dev
                                   if any(s in e.key for s in subs[label])) / dev_us
                        for label in subs}
    log(json.dumps(out))
    return out


# the profiled windows' metrics the graph A/B compares
AB_KEYS = ("wall_ms_per_token", "device_busy_ms_per_token", "device_idle_share",
           "kernels_per_token", "launch_calls_per_token", "graph_launch_calls_per_token",
           "decode_tok_s")


def graph_ab(torch, name: str, eng, run, n_tokens: int, share_of=None) -> dict:
    """One window on one engine eagerly and graphed, in turns (eager,
    graphed, graphed, eager), each profiled after a warm call (the graphed
    warm call captures); returns and logs each arm's mean of AB_KEYS."""
    windows = {False: [], True: []}
    for graphs in (False, True, True, False):
        eng.cuda_graphs = graphs
        arm = "graphed" if graphs else "eager"
        windows[graphs].append(profile_window(torch, f"{name} {arm}", run, n_tokens, share_of))
    out = {"phase": "graph_ab", "window": name, "tokens": n_tokens}
    for graphs, arm in ((False, "eager"), (True, "graphed")):
        out[arm] = {k: sum(w[k] for w in windows[graphs]) / 2 for k in AB_KEYS}
    log(json.dumps(out))
    eng.cuda_graphs = True
    return out


# the 1B batch-1 windows' sampling settings (label, temperature, top-p):
# greedy, then sampled through the top-p arm and with the full distribution
GREEDY = (("", 0.0, 0.9),)
SAMPLED = (*GREEDY, (" sampled t0.8 p0.9", 0.8, 0.9), (" sampled t0.8 p1.0", 0.8, 1.0))


def decode_profile(torch, name: str, model_path: str, steps: int = 16, share_of=None,
                   windows=GREEDY, eng=None, **engine_kw) -> list:
    """`steps` batch-1 decode steps of the main path's engine (contiguous, or
    the layout `engine_kw` names) after a 99-token prefill, profiled
    eagerly and graphed (`graph_ab`), once for each sampling setting of
    `windows`; each window decodes from position 99. `eng`: an engine to
    use (and leave open) in place of one made from `model_path`. Returns
    the `graph_ab` records."""
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine

    own = eng is None
    if own:
        eng = InferenceEngine(model_path, max_seq_len=MAX_SEQ_LEN, device="cuda", **engine_kw)
    prompt = [(7 * i) % 1000 + 1 for i in range(100)]
    eng.prefill(prompt[:-1])
    tok = torch.tensor([prompt[-1]], device="cuda")

    out = []
    for label, temperature, topp in windows:
        def run(temperature=temperature, topp=topp):
            eng._decode_chunk(tok, len(prompt) - 1, steps, temperature, topp)

        share = {**(share_of or {}), **SORT_SHARE} if temperature > 0 else share_of
        out.append(graph_ab(torch, name + label, eng, run, steps, share))
    if own:
        eng.close()
    return out


# the profiled windows' kernels of interest, by a substring of the CUDA
# kernel's name
K5_SHARE = {"paged_attention (K5)": "paged_attention"}
K4_SHARE = {"q40_grouped_gemm (K4)": "q40_grouped_gemm"}
# the top-p arm's sort over the vocabulary (cub's radix sort and torch's own)
SORT_SHARE = {"sort (top-p arm)": ("Sort", "sort")}
# K1's GEMV (either design) and the first design's separate prologue
K1_SHARE = {"q40_gemv (K1)": "q40_gemv", "quantize_rows_q80 (K1 prologue)": "quantize_rows_q80"}


def int8_decode_profile(torch, model_path: str) -> list:
    """The CLI's `inference --kv-dtype int8` path at batch 1 (paged int8,
    K5 at b = 1): 8 decode steps after a 99-token prefill, profiled."""
    return decode_profile(torch, "llama32_1b paged int8 batch 1", model_path, steps=8,
                          share_of=K5_SHARE, kv_layout="paged", cache_dtype="int8")


def prefill_profile(torch, name: str, model_path: str, n_tokens: int = 128, eng=None) -> dict:
    """Prefill of n_tokens tokens (four 32-row chunks) on the CLI's
    contiguous engine (or `eng`, left open), profiled, with K4's share of
    the device time."""
    from distributed_llama_tpu_torch.runtime.engine import InferenceEngine

    own = eng is None
    if own:
        eng = InferenceEngine(model_path, max_seq_len=MAX_SEQ_LEN, device="cuda")
    prompt = [(11 * i) % 1000 + 1 for i in range(n_tokens)]
    out = profile_window(torch, name + " prefill", lambda: eng.prefill(prompt), n_tokens, K4_SHARE)
    if own:
        eng.close()
    return out


def batch16_profile(torch, model_path: str, tp: str, sess=None) -> dict:
    """One 8-step chunk of a batch-16 paged int8 BatchSession, profiled
    eagerly and graphed (`graph_ab`), with K5's share. Without `sess` (the
    main run's), a session of its own: the main run's 16 prompts, stepped
    16 chunks of 8 first."""
    eng = None
    if sess is None:
        from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
        from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
        from distributed_llama_tpu_torch.tokenizer import Tokenizer

        ids = Tokenizer(tp).encode(PROMPT)
        b = 16
        eng = InferenceEngine(model_path, max_seq_len=MAX_SEQ_LEN, batch=b, kv_layout="paged",
                              cache_dtype="int8", device="cuda")
        sess = BatchSession(eng)
        for r in range(b):
            sess.admit(r, ids[: 16 + (len(ids) - 16) * r // (b - 1)])
        for _ in range(16):
            sess.step(8)
    out = graph_ab(torch, "llama32_1b batch-16 paged int8 chunk", sess.engine,
                   lambda: sess.step(8), 8 * 16, K5_SHARE)
    if eng is not None:
        eng.close()
    return out


# the guarded loops' A/B: generates a side, in turns without speculation
# and at k 4; and `guard_share`'s generates an arm
GUARDED_RUNS = 6
GUARD_SHARE_RUNS = 10


def guarded_paths_ab(torch, mp: str, tp: str) -> dict:
    """The decode loops that the stall watchdog, StepStats and the trace
    emitters sit on, at Llama-3.2-1B width batch 1 contiguous: phase 5d's
    `spec_profile` (graphed decode through `_decode_device` without
    speculation and ngram k 4 through `_decode_speculative`, profiled in
    turns), then GUARDED_RUNS greedy generates of SPEC_DECODE_STEPS tokens
    without speculation (decode tok/s) and at k 4 (verify ms a round,
    `last_spec_timing`), in turns, after one of each that captures. Uses
    only what the engine had before the watchdog came, so the same script
    measures an older tree."""
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    ids = Tokenizer(tp).encode(PROMPT)
    steps = len(ids) - 1 + SPEC_DECODE_STEPS
    eng = spec_engine(mp, kv_layout="contiguous")
    speculate(eng, 0)
    want = eng.generate(ids, steps).tokens
    prof = spec_profile(torch, "llama32_1b batch 1 contiguous", eng, want[: len(ids) + 64])
    tok_s, verify = [], []
    for i in range(GUARDED_RUNS + 1):
        for k in (0, 4):
            speculate(eng, k)
            eng.reset()
            res = eng.generate(ids, steps)
            assert res.tokens == want
            if i == 0:
                continue  # the first of each captures its graphs
            if k:
                t = eng.last_spec_timing
                verify.append(t["verify_us"] / 1e3 / max(t["rounds"], 1))
            else:
                tok_s.append(SPEC_DECODE_STEPS / (res.decode_us / 1e6))
    out = {"phase": "guarded_paths", "spec_ab": prof, "decode_tok_s_off": tok_s,
           "verify_ms_per_round_k4": verify}
    log(json.dumps(out))
    eng.close()
    return out


def guard_share(torch, mp: str, tp: str) -> dict:
    """The stall watchdog's share of the guarded loops, in one process (so
    the process's host state, which moves tok/s by ~15% between processes,
    is the same for both arms): greedy generates of SPEC_DECODE_STEPS
    tokens without speculation and at k 4, GUARD_SHARE_RUNS each with the
    engine's guards and with `_guard` returning a null context, in turns
    (on, off, off, on, ...) after one of each that captures."""
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    ids = Tokenizer(tp).encode(PROMPT)
    steps = len(ids) - 1 + SPEC_DECODE_STEPS
    eng = spec_engine(mp, kv_layout="contiguous")
    guard = eng._guard
    out = {"phase": "guard_share", "runs": GUARD_SHARE_RUNS}
    for k in (0, 4):
        speculate(eng, k)
        arms = {"guarded": [], "unguarded": []}
        order = ["guarded", "unguarded", "unguarded", "guarded"] * GUARD_SHARE_RUNS
        for i, arm in enumerate(["guarded", "unguarded"] + order[: 2 * GUARD_SHARE_RUNS]):
            eng._guard = guard if arm == "guarded" else (lambda label, key: contextlib.nullcontext())
            eng.reset()
            res = eng.generate(ids, steps)
            if i < 2:
                continue  # the first of each captures its graphs
            t = eng.last_spec_timing
            arms[arm].append(t["verify_us"] / 1e3 / max(t["rounds"], 1) if k
                             else SPEC_DECODE_STEPS / (res.decode_us / 1e6))
        out["verify_ms_per_round_k4" if k else "decode_tok_s_off"] = arms
    eng._guard = guard
    log(json.dumps(out))
    eng.close()
    return out


def profiles_only(torch, model: str, models_dir: Path | None) -> int:
    """`--profiles MODEL`: only the profiled windows of one model, for an
    end-to-end comparison of two trees with this script (run it from the
    root of each): at Llama-3.2-1B width the contiguous and the paged int8
    batch-1 decode (K1's share beside K5's) and the batch-16 paged int8
    chunk, at Qwen3-30B-A3B width the contiguous decode (K1's share) and
    the prefill. `--models DIR` shares the synthetic model files between
    the runs. At Llama-3.2-1B width also `guarded_paths_ab`: the decode
    and speculation loops themselves, profiled, and the k 4 verify ms."""
    root = models_dir or BUILD
    if model == "llama32_1b":
        mp, tp, _, _ = synthetic_model("llama32_1b", LLAMA32_1B, root=root)
        out = decode_profile(torch, "llama32_1b", mp, share_of=K1_SHARE, windows=SAMPLED)
        release(torch)
        out += decode_profile(torch, "llama32_1b paged int8 batch 1", mp,
                              share_of={**K5_SHARE, **K1_SHARE}, kv_layout="paged",
                              cache_dtype="int8")
        release(torch)
        out.append(batch16_profile(torch, mp, tp))
        release(torch)
        out.append(guarded_paths_ab(torch, mp, tp))
    else:
        mp, _, _, _ = synthetic_model("qwen3_30b_a3b", dict(QWEN3_30B_A3B, arch=QWEN3_MOE_ARCH),
                                      norm_epsilon=QWEN3_NORM_EPS, root=root)
        out = decode_profile(torch, "qwen3_30b_a3b", mp, share_of=K1_SHARE)
        release(torch)
        out.append(prefill_profile(torch, "qwen3_30b_a3b", mp))
    print(json.dumps({"profiles": out, "tree": str(ROOT)}))
    return 0


def spec_divergence_only(torch) -> int:
    """`--spec-divergence`: phase 5d's paged int8 batch-1 chains at 1B
    width alone, without speculation and with ngram at k 8, and where they
    part, `arm_growth`."""
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    mp, tp, _, _ = synthetic_model("llama32_1b", LLAMA32_1B)
    ids = Tokenizer(tp).encode(PROMPT)
    eng = spec_engine(mp, kv_layout="paged", cache_dtype="int8")
    chains = {}
    for k in (0, 8):
        speculate(eng, k)
        eng.reset()
        chains[k] = eng.generate(ids, len(ids) - 1 + SPEC_DECODE_STEPS).tokens
    speculate(eng, 0)
    div = first_divergence(torch, chains[0], chains[8], len(ids), decode_logits(torch, eng, ids))
    out = {"phase": "spec_divergence", "divergence": div}
    if div is not None:
        j = len(ids) + div["index"]
        out["arm_growth"] = arm_growth(torch, eng, chains[0], len(ids), j, chains[8][j])
    print(json.dumps(out))
    eng.close()
    return 0


def grammar_only(torch) -> int:
    """`--grammar`: phase 5e at Llama-3.2-1B width alone, counted, each
    kernel of its path launched."""
    from distributed_llama_tpu_torch.ops import cuda_attention as ca
    from distributed_llama_tpu_torch.ops import cuda_q40 as q

    mp, tp, _, _ = synthetic_model("llama32_1b", LLAMA32_1B)
    launches = grammar_phase(
        torch, mp, tp, (*q.KERNELS, *ca.KERNELS),
        (q.q40_gemv_q80_stacked, q.q40_gemv_q80, q.q40_gemm_bf16_stacked, q.q40_gemm_bf16,
         ca.flash_attention, ca.paged_flash_attention))
    print(json.dumps({"phase": "grammar_launches", "launches": launches}))
    return 0


def server_only(torch) -> int:
    """`--server`: phase 5g at Llama-3.2-1B width alone, each server counted,
    each kernel of its path launched."""
    from distributed_llama_tpu_torch.ops import cuda_attention as ca
    from distributed_llama_tpu_torch.ops import cuda_q40 as q

    mp, tp, _, _ = synthetic_model("llama32_1b", LLAMA32_1B)
    paths = server_phase(torch, mp, tp, (*q.KERNELS, *ca.KERNELS))
    print(json.dumps({"phase": "server_launches", "launches": paths}))
    return 0


def kv_only(torch) -> int:
    """`--kv`: phase 5h at Llama-3.2-1B width alone, counted, each kernel of
    its path launched."""
    from distributed_llama_tpu_torch.ops import cuda_attention as ca
    from distributed_llama_tpu_torch.ops import cuda_q40 as q

    mp, tp, _, _ = synthetic_model("llama32_1b", LLAMA32_1B)
    paths = kv_phase(torch, mp, tp, (*q.KERNELS, *ca.KERNELS))
    print(json.dumps({"phase": "kv_launches", "launches": paths}))
    return 0


def release(torch) -> None:
    """Drop what a finished phase left on the card."""
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port on one NVIDIA GPU.")
    ap.add_argument("--profiles", choices=("llama32_1b", "qwen3_30b_a3b"),
                    help="only the profiled windows of one model")
    ap.add_argument("--models", type=Path, help="with --profiles: where the model files live")
    ap.add_argument("--spec-divergence", action="store_true",
                    help="only phase 5d's paged int8 k 8 chains and, where they part, arm_growth")
    ap.add_argument("--grammar", action="store_true",
                    help="only phase 5e at Llama-3.2-1B width")
    ap.add_argument("--server", action="store_true",
                    help="only phase 5g (the server) at Llama-3.2-1B width")
    ap.add_argument("--kv", action="store_true",
                    help="only phase 5h (KV tiers, disaggregation, device views) at "
                    "Llama-3.2-1B width")
    ap.add_argument("--mesh", action="store_true",
                    help="only phase 5i (the shard loop's meshes and its kernel table)")
    ap.add_argument("--guarded-paths", action="store_true",
                    help="only `guarded_paths_ab` at Llama-3.2-1B width (with --models)")
    ap.add_argument("--guard-share", action="store_true",
                    help="with --guarded-paths: also `guard_share` (this tree only)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    def done(what: str) -> None:
        log(f"{what} done at {time.perf_counter() - t_start:.1f} s")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG} not found next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40, kernels
    from distributed_llama_tpu_torch.probes import (
        attention, dma, i4_tiles, int4, int4_prod, int4b, int4c, scales, timing)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    kind = torch.cuda.get_device_name(0)
    smi = timing.card_line()
    rate_key, rates = rates_for(kind)
    log(f"card: {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| bounds from the {rate_key} data sheet: {rates[0] / 1e12} TB/s, "
        f"{rates[1] / 1e12} bf16 TFLOP/s, {rates[2] / 1e12} int8 TOP/s")

    # the 30B-A3B file (7.0 GB at MOE_PATH_LAYERS) in a child process
    # beside the build and phases 3-3e, whose numbers are device
    # times (CUDA events over graph replays); it is joined before phase 4,
    # so that no host-timed phase shares the CPU or the disk with it
    full = not (args.guarded_paths or args.profiles or args.spec_divergence or args.grammar
                or args.server or args.kv or args.mesh)
    moe_kw = dict(QWEN3_30B_A3B, arch=QWEN3_MOE_ARCH, n_layers=MOE_PATH_LAYERS)
    t_writer = time.perf_counter()
    writer = start_model_writer("qwen3_30b_a3b", moe_kw, QWEN3_NORM_EPS,
                                7_100_000_000) if full else None
    if full:
        log("writing the Qwen3-30B-A3B-width file " +
            ("in a child process" if writer else "after the 1B phases (the disk is short)"))

    # 2. build
    t0 = time.perf_counter()
    logs = kernels.build(ptxas_verbose=True)
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        log(f"--- nvcc {name}.cu\n{text.strip()}")
    log(f"kernels built in {secs:.1f} s ({len(logs)} compiled, one nvcc each, in parallel)")
    done("phases 1-2")
    if args.guarded_paths:
        mp, tp, _, _ = synthetic_model("llama32_1b", LLAMA32_1B, root=args.models or BUILD)
        print(json.dumps(guarded_paths_ab(torch, mp, tp)))
        if args.guard_share:
            print(json.dumps(guard_share(torch, mp, tp)))
        print(smi)
        return 0
    if args.profiles or args.spec_divergence or args.grammar or args.server or args.kv or args.mesh:
        rc = (profiles_only(torch, args.profiles, args.models) if args.profiles
              else mesh_only(torch, rates) if args.mesh
              else spec_divergence_only(torch) if args.spec_divergence
              else grammar_only(torch) if args.grammar
              else kv_only(torch) if args.kv else server_only(torch))
        print(smi)
        return rc

    # 3. kernels against their plain versions
    rows = {r["name"]: r for r in kernel_checks(torch, rates)}  # K1, K1-stacked, K2, K3, B5
    release(torch)
    rows.update({r["name"]: r for r in moe_kernel_checks(torch, rates)})  # K3 at hd 128
    release(torch)
    rows["paged_flash_attention"] = paged_rows(torch, rates)  # K5
    release(torch)
    # the verify rounds' row counts (K2, B5) and queries a row (K5)
    verify = verify_gemm_rows(torch, rates)
    for name in ("q40_gemm_bf16_stacked", "q40_gemm_bf16"):
        rows[name]["verify_rows"] = verify[name]
    rows["paged_flash_attention"]["verify_shapes"] = verify_paged_rows(torch, rates)
    release(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    c, m = LLAMA32_1B, QWEN3_30B_A3B
    rows["flash_attention_partial"] = partial_row(  # B8 at the sp path's 1B shape
        torch, gen, rates[0], rates[1], c["n_heads"], c["n_kv_heads"], c["head_dim"])
    rows["flash_attention_partial"]["hd128"] = {
        k: v for k, v in partial_row(torch, gen, rates[0], rates[1], m["n_heads"], m["n_kv_heads"],
                                     m["head_dim"]).items()
        if k in ("ms", "cold_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
    release(torch)
    done("phase 3")

    # every launch counter: each counted run (the probes', then each main
    # path) sets all of them to 0 just before it and reads all just after
    counters = (*cuda_q40.KERNELS, *cuda_attention.KERNELS, *int4.KERNELS, *dma.KERNELS,
                *attention.KERNELS, *int4_prod.KERNELS, *scales.KERNELS, *i4_tiles.KERNELS,
                *int4b.KERNELS, *int4c.KERNELS)

    # 3b. the kernel probes: checks, then the probes' own run, counted
    errs = probe_checks(torch)
    release(torch)
    paths = {}
    paths["probes"], probe_kernels = probe_rows(torch, rates, rate_key, errs, counters)
    rows.update(probe_kernels)
    release(torch)
    done("phase 3b")

    # 3c. the decode-attention floor probes and K1's body: checks, then the
    # probes' own run, counted
    errs = floor_checks(torch)
    release(torch)
    paths[FLOOR_PATH], floor_kernels = floor_rows(torch, rates, errs, counters)
    rows.update(floor_kernels)
    release(torch)
    done("phase 3c")

    # 3d. the scale-plane and tile sweeps and the f16-bits convert: checks,
    # then the sweeps' own run, counted
    sweep_checks(torch)
    release(torch)
    paths[SWEEP_PATH], sweep_kernels = sweep_rows(torch, rates, counters)
    rows.update(sweep_kernels)
    release(torch)
    done("phase 3d")

    # 3e. the unsigned-nibble codecs: checks, then the probes' own run,
    # counted
    errs = codec_checks(torch)
    release(torch)
    paths[CODEC_PATH], codec_kernels = codec_rows(torch, rates, errs, counters)
    rows.update(codec_kernels)
    release(torch)
    done("phase 3e")
    if writer is not None:
        t_wait = time.perf_counter()
        writer.join()
        assert writer.exitcode == 0, f"the model writer exited {writer.exitcode}"
        log(f"the child's write ended {time.perf_counter() - t_writer:.1f} s after it began; "
            f"waited {time.perf_counter() - t_wait:.1f} s for it after phase 3e")

    # 4. small inputs against the CPU
    tmp = BUILD / "smoke"
    tmp.mkdir(parents=True, exist_ok=True)
    q, ca = cuda_q40, cuda_attention
    dense = (q.q40_gemv_q80_stacked, q.q40_gemv_q80, q.q40_gemm_bf16_stacked, ca.flash_attention)
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
    small_batch_reference(torch, tmp)
    q80_references(torch, tmp)
    release(torch)
    done("phase 4")

    # 5-6. the main paths, each with its counters set to 0 just before it
    # and read just after, and profiles of their decode
    mp, tp, write_s, size = synthetic_model("llama32_1b", LLAMA32_1B)
    log(f"synthetic Llama-3.2-1B-width model: {size} bytes, ready in {write_s:.1f} s "
        f"(set-up, not timed below)")
    # the CLI at its default ngram speculation and with it off: the same
    # tokens (k 4 takes the decode step's arms)
    texts = {}
    paths["llama32_1b inference contiguous"] = main_path(
        torch, "llama32_1b", mp, tp, LLAMA32_1B["n_layers"], counters, dense, texts=texts)
    release(torch)
    paths["llama32_1b inference contiguous --speculative off"] = main_path(
        torch, "llama32_1b", mp, tp, LLAMA32_1B["n_layers"], counters, dense,
        extra=("--kv-layout", "contiguous", "--speculative", "off"), texts=texts)
    assert len(set(texts.values())) == 1, "1B CLI: ngram and off print other tokens"
    release(torch)
    done("the 1B contiguous CLI paths")
    # 8 steps a window (16 until phase 5d came), greedy (the top-p arm's
    # window too until phase 5f came, the full distribution's until phase
    # 5e came; both stay under --profiles), to keep the script's time
    decode_profile(torch, "llama32_1b", mp, steps=8)
    release(torch)
    done("the 1B decode profiles")
    paths["llama32_1b perplexity paged"] = perplexity_path(
        torch, mp, tp, counters, (q.q40_gemm_bf16_stacked, q.q40_gemm_bf16, ca.flash_attention))
    release(torch)
    paths["llama32_1b inference paged (the CLI default)"] = main_path(
        torch, "llama32_1b", mp, tp, LLAMA32_1B["n_layers"], counters, dense, extra=())
    release(torch)
    paths["llama32_1b inference paged int8"] = main_path(
        torch, "llama32_1b", mp, tp, LLAMA32_1B["n_layers"], counters,
        (*dense, ca.paged_flash_attention), extra=("--kv-dtype", "int8"))
    release(torch)
    int8_decode_profile(torch, mp)
    release(torch)
    done("the 1B perplexity, paged and int8 paths")
    launches, sess, eng = batch_session_path(
        torch, mp, tp, counters,
        (q.q40_gemm_bf16_stacked, q.q40_gemm_bf16, ca.flash_attention, ca.paged_flash_attention))
    paths["llama32_1b batch_session 16 paged int8"] = launches
    batch16_profile(torch, mp, tp, sess)
    eng.close()
    del sess, eng
    release(torch)
    paths["llama32_1b generate_batch 4 paged int8"] = generate_batch_path(
        torch, mp, tp, counters, (q.q40_gemv_q80_stacked, ca.paged_flash_attention))
    release(torch)
    done("the 1B batch-16 session and generate_batch paths")
    paths["llama32_1b sp=4 inference contiguous"] = sp_path(
        torch, mp, tp, counters,
        (q.q40_gemv_q80_stacked, q.q40_gemv_q80, q.q40_gemm_bf16_stacked, ca.flash_attention_partial),
        ca.flash_attention_partial, ca.flash_attention)
    release(torch)
    done("the sp path")
    # 5i. the shard loop: its kernels at the shard shapes, then the meshes
    for name, entries in shard_shape_checks(torch, rates).items():
        rows[name]["shard_shapes"] = entries
    release(torch)
    paths.update(mesh_phase(torch, mp, tp, counters))
    release(torch)
    done("phase 5i at 1B width")
    eng16 = graphed_decode_phase(torch, mp, tp, "llama32_1b")
    release(torch)
    done("phase 5b at 1B width")
    paths["llama32_1b observability"] = observability_phase(
        torch, mp, tp, counters, (q.q40_gemv_q80_stacked, q.q40_gemm_bf16_stacked,
                                  ca.flash_attention, ca.paged_flash_attention), eng16)
    eng16.close()
    del eng16
    release(torch)
    done("phase 5f")
    paths["llama32_1b prefix cache"] = prefix_cache_phase(
        torch, mp, tp, counters, (q.q40_gemm_bf16_stacked, q.q40_gemv_q80_stacked, q.q40_gemv_q80,
                                  ca.flash_attention, ca.paged_flash_attention))
    release(torch)
    done("phase 5c")
    paths["llama32_1b speculation"] = speculation_phase(
        torch, mp, tp, counters, (q.q40_gemv_q80_stacked, q.q40_gemv_q80, q.q40_gemm_bf16_stacked,
                                  q.q40_gemm_bf16, ca.flash_attention, ca.paged_flash_attention))
    release(torch)
    done("phase 5d")
    paths["llama32_1b grammar"] = grammar_phase(
        torch, mp, tp, counters, (q.q40_gemv_q80_stacked, q.q40_gemv_q80, q.q40_gemm_bf16_stacked,
                                  q.q40_gemm_bf16, ca.flash_attention, ca.paged_flash_attention))
    release(torch)
    done("phase 5e")
    paths.update(server_phase(torch, mp, tp, counters))
    done("phase 5g")
    paths.update(kv_phase(torch, mp, tp, counters))
    done("phase 5h")
    Path(mp).unlink()  # room on the disk for the MoE file
    done("phases 5-6 at Llama-3.2-1B width")

    mp, tp, write_s, size = synthetic_model("qwen3_30b_a3b", moe_kw, norm_epsilon=QWEN3_NORM_EPS)
    log(f"synthetic Qwen3-30B-A3B-width model: {size} bytes, {MOE_PATH_LAYERS} of "
        f"{QWEN3_30B_A3B['n_layers']} layers, ready in {write_s:.1f} s (set-up, not timed below)")
    moe = (q.q40_gemv_q80_stacked, q.q40_gemv_q80, q.q40_gemm_bf16_stacked,
           q.q40_gemv_q80_indexed, q.q40_grouped_gemm_bf16, ca.flash_attention)
    # the CLI's default does not speculate here: a 5-token round's 40
    # expert rows would take the gather arm (`verify_takes_gather_arm`), so
    # the default and `--speculative off` decode alike, through K1-indexed
    texts = {}
    paths["qwen3_30b_a3b inference contiguous"] = main_path(
        torch, "qwen3_30b_a3b", mp, tp, MOE_PATH_LAYERS, counters, moe, texts=texts,
        decode_steps=MOE_CLI_DECODE_STEPS)
    release(torch)
    paths["qwen3_30b_a3b inference contiguous --speculative off"] = main_path(
        torch, "qwen3_30b_a3b", mp, tp, MOE_PATH_LAYERS, counters, moe,
        extra=("--kv-layout", "contiguous", "--speculative", "off"), texts=texts,
        decode_steps=MOE_CLI_DECODE_STEPS)
    log(json.dumps({"phase": "cli_speculation", "model": "qwen3_30b_a3b",
                    "tokens_equal": len(set(texts.values())) == 1}))
    assert len(set(texts.values())) == 1, "30B-A3B CLI: the default and off print other tokens"
    release(torch)
    done("the 30B-A3B CLI paths")
    # one load for the profiles, phase 5b and phase 5d's and 5e's MoE
    # parts; with the grammar arena, as the CLI builds its engine
    eng = spec_engine(mp, kv_layout="contiguous", grammar=True)
    paths["qwen3_30b_a3b grammar"] = grammar_moe(torch, eng, tp, counters, moe)
    speculate(eng, 0)
    decode_profile(torch, "qwen3_30b_a3b", mp, steps=8, eng=eng)
    prefill_profile(torch, "qwen3_30b_a3b", mp, eng=eng)
    graphed_decode_phase(torch, mp, tp, "qwen3_30b_a3b", eng=eng)
    # 5i's single-device side on this engine (speculation off), which
    # closes before the mesh's engine cuts the same file (two copies
    # at most)
    from distributed_llama_tpu_torch.tokenizer import Tokenizer

    speculate(eng, 0)
    ref = mesh_moe_reference(torch, eng, Tokenizer(tp).encode(PROMPT))
    eng.close()
    del eng
    release(torch)
    done("phases 5-6 at Qwen3-30B-A3B width")
    paths.update(mesh_moe_phase(torch, mp, tp, counters, ref))
    done("phase 5i at Qwen3-30B-A3B width")

    # 7. the record: one row a kernel; `launches` sums the main paths'
    # counts (each path counted on its own), `launches_by_path` holds them
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    # a row without a counter of its own (P8 runs K3) reads its kernel's
    # counter on its own path only
    def by_path(name, r):
        count = r.get("counter", name)
        return {path: p[count] for path, p in paths.items() if r.get("path", path) == path}

    kern = [{**{k: r[k] for k in keys},
             **{k: r[k] for k in ("cold_ms", "hot_ms", "shard_shapes") if k in r},
             "launches": sum(by_path(name, r).values()), "launches_by_path": by_path(name, r)}
            for name, r in rows.items()]
    print(json.dumps({"kernels": kern}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
