"""Command-line entry point — the `dllama` analogue, on PyTorch.

The counterpart of the JAX package's `cli.py`: the `inference`,
`perplexity` and `chat` modes (reference: src/dllama.cpp:13-305) with the
same flags where the port runs them, plus `--device {cuda,cpu}` (default
cuda: the CLI runs on the card unless asked for the CPU). As in the JAX
CLI, `--kv-layout` defaults to paged (DLT_KV_LAYOUT env first);
`--kv-dtype int8` stores the cache in int8. `--tp`, `--pp`, `--dp`, `--ep`
and `--sp` lay the engine over a mesh of that many shards (parallel/): the
visible cards, or the CPU for every shard with `--device cpu`; as in the
JAX CLI, `--batch` must split over `--dp` and is at least `--dp`, and the
paged layout stays on pure pp x tp meshes, where others keep contiguous and
say so. `--prefix-cache-mb` sizes the radix prefix cache
(runtime/prefix_cache.py) as the JAX CLI does: -1, the default, means
DLT_PREFIX_CACHE_MB env, else 512; 0 turns it off. `--speculative`
(off | ngram | model; runtime/speculative.py) defaults to DLT_SPECULATIVE
env, else ngram, as in the JAX CLI: greedy generations decode in verify
rounds, sampled ones as before. Unlike the JAX CLI, the default is off
for a MoE model whose verify round at `--batch` would take the gather
arm (`verify_takes_gather_arm`: Qwen3-30B-A3B at batch 1, where a round
costs about 20 decode tokens); the flag or the env still turns it on. At
`--batch` > 1 a round's rows take other matmul arms than batch 1's, so
the printed row 0 may part from a batch-1 run. `--draft-k` caps the drafted tokens a
round (0: DLT_DRAFT_K env, else 4); `--speculative model` drafts with
the `--draft-model` file, a second engine at batch 1 with speculation and
the prefix cache off, and raises ValueError without one. As in the JAX
CLI, the engine builds the grammar arena (runtime/grammar.py) on one
device with device decode, so every decode and verify graph carries the
grammar mask at the all-legal FREE state; DLT_GRAMMAR=0 turns it off,
and on a mesh or under `--host-decode` it stays off. `--role` and
`--prefill-peer` (the API server's disaggregated roles, server/disagg.py)
parse here as in the JAX CLI and feed the server's ``DLT_ROLE`` /
``DLT_PREFILL_PEER`` resolution. After the Timing
block `inference` prints the engine's step report (`StepStats.report`:
the prefill and decode or verify series), as the JAX CLI does. The
reference's `worker` mode, anywhere in argv, prints the JAX CLI's migration
text on stderr and returns 2, as the JAX CLI does.

Usage:
  python -m distributed_llama_tpu_torch.cli inference --model m.m \
      --tokenizer t.t --prompt "Hello" --steps 64 [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .formats.mfile import MFileReader
from .parallel import make_mesh
from .runtime.engine import InferenceEngine
from .runtime.grammar import resolve_grammar_enabled
from .runtime.paged_kv import resolve_kv_layout
from .runtime.prefix_cache import resolve_budget_mb
from .runtime.speculative import (
    DRAFT_BUCKETS, ModelDraft, resolve_draft_k, resolve_spec_mode, verify_takes_gather_arm,
)
from .tokenizer import (
    EOS_FOUND,
    EOS_MAYBE,
    TEMPLATE_UNKNOWN,
    ChatItem,
    ChatTemplateGenerator,
    EosDetector,
    Sampler,
    Tokenizer,
)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="distributed_llama_tpu_torch")
    p.add_argument("mode", choices=["inference", "chat", "perplexity", "worker"])
    p.add_argument("--model", required=False, default=None)
    p.add_argument("--tokenizer", required=False, default=None)
    p.add_argument("--prompt", default=None)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--max-seq-len", type=int, default=0)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--topp", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--chat-template", default=None)
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument(
        "--cache-dtype", "--kv-dtype", dest="cache_dtype",
        choices=["bfloat16", "float32", "int8"], default=None,
        help="KV cache storage dtype (default DLT_KV_DTYPE env, else the "
        "compute dtype's): int8 stores quantized KV with an f32 scale per "
        "(token, kv head)",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the model runs (default cuda; no GPU is an error, not a "
        "fallback)",
    )
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel mesh size")
    p.add_argument("--pp", type=int, default=1, help="pipeline-parallel mesh size")
    p.add_argument("--sp", type=int, default=1, help="sequence-parallel mesh size (long context)")
    p.add_argument("--ep", type=int, default=1, help="expert-parallel mesh size (MoE)")
    p.add_argument("--dp", type=int, default=1, help="data-parallel mesh size (batch)")
    p.add_argument(
        "--batch", type=int, default=1,
        help="engine batch rows (the CLI's modes run the same sequence in each)",
    )
    p.add_argument(
        "--host-decode", action="store_true",
        help="per-token host decode loop (bit-parity RNG with the reference)",
    )
    # the JAX CLI's compat knobs from the reference CLI: parsed, ignored
    p.add_argument("--nthreads", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--buffer-float-type", default=None, help=argparse.SUPPRESS)
    p.add_argument("--net-turbo", default=None, help=argparse.SUPPRESS)
    p.add_argument("--max-batch-size", "--nbatches", dest="max_chunk", type=int, default=32)
    p.add_argument("--prefill-chunk-size", type=int, default=0)
    p.add_argument("--prefill-chunk-threshold", type=int, default=128, help=argparse.SUPPRESS)
    p.add_argument(
        "--kv-layout", choices=["contiguous", "paged"], default=None,
        help="KV cache layout: paged (fixed-size pages and per-row page "
        "tables) or contiguous (per-row seq_len slabs). Default: "
        "DLT_KV_LAYOUT env, else paged",
    )
    p.add_argument(
        "--kv-page-size", type=int, default=0,
        help="tokens per KV page, a power of two (default DLT_KV_PAGE env, else 16)",
    )
    p.add_argument(
        "--kv-pool-mb", type=int, default=0,
        help="paged KV pool budget in MB (default DLT_KV_POOL_MB env, else "
        "batch x seq_len worth of pages)",
    )
    p.add_argument(
        "--speculative", choices=["off", "ngram", "model"], default=None,
        help="speculative decoding draft source for greedy generations "
        "(default DLT_SPECULATIVE env, else ngram; else off on a MoE model "
        "whose verify round at --batch takes the gather arm). At --batch > 1 "
        "a round's rows take other matmul arms than batch 1's, so the "
        "printed row 0 may part from a batch-1 run",
    )
    p.add_argument(
        "--draft-k", type=int, default=0,
        help="max drafted tokens a verify round, bucketed at 4 and 8 (0 = "
        "DLT_DRAFT_K env, else 4)",
    )
    p.add_argument(
        "--draft-model", default=None,
        help="the draft model file of --speculative model",
    )
    p.add_argument(
        "--prefix-cache-mb", type=int, default=-1,
        help="device budget of the radix prefix cache (cross-request KV "
        "reuse over shared prompts). -1 = DLT_PREFIX_CACHE_MB env, "
        "defaulting to 512; 0 disables",
    )
    p.add_argument(
        "--role", choices=["unified", "prefill", "decode"], default=None,
        help="disaggregated serving role of the API server (server/disagg.py): "
        "'prefill' workers answer POST /v1/prefill (run the prompt, ship "
        "bucket-aligned KV); 'decode' workers fetch shipped KV from "
        "--prefill-peer before admission and stream tokens; 'unified' "
        "(default, or DLT_ROLE env) serves everything locally. "
        "DLT_KV_TRANSPORT={auto,device,http} picks the transfer path per peer",
    )
    p.add_argument(
        "--prefill-peer", action="append", default=None, metavar="HOST:PORT",
        help="prefill worker a --role decode server fetches KV from "
        "(repeatable; round-robin with in-request failover; default "
        "DLT_PREFILL_PEER env, comma-separated). A dead peer degrades the "
        "request to local prefill, never fails it",
    )
    return p


def make_engine(args) -> InferenceEngine:
    # speculation as the JAX CLI resolves it: ngram unless the flag or
    # DLT_SPECULATIVE says otherwise (library engines default to off); but
    # off where a round of the smallest bucket takes the MoE gather arm
    # --batch against --dp, as the JAX CLI checks it (cli.py:180-191): an
    # explicit batch must split over the dp shards; the batch is at least dp
    batch = args.batch or 1
    if batch % args.dp != 0 and batch != 1:
        raise ValueError(
            f"--batch {batch} must be a multiple of --dp {args.dp} "
            f"(each dp shard holds batch/dp rows)"
        )
    batch = max(batch, args.dp)
    with MFileReader(args.model) as reader:
        h = reader.header
    gather = verify_takes_gather_arm(h, batch, DRAFT_BUCKETS[0] + 1)
    spec_mode = resolve_spec_mode(args.speculative, default="off" if gather else "ngram")
    draft_k = resolve_draft_k(args.draft_k or None)
    if spec_mode == "model" and not args.draft_model:
        raise ValueError("--speculative model requires --draft-model")
    # the prefix cache as the JAX CLI resolves it: a flag >= 0 wins, else
    # DLT_PREFIX_CACHE_MB, else 512 (on for the CLI; library engines
    # default to off)
    flag = args.prefix_cache_mb
    prefix_mb = resolve_budget_mb(None if flag < 0 else flag, default_mb=512)
    max_chunk = args.prefill_chunk_size if args.prefill_chunk_size > 0 else args.max_chunk
    mesh = None
    axes = dict(tp=args.tp, pp=args.pp, sp=args.sp, ep=args.ep, dp=args.dp)
    if any(v > 1 for v in axes.values()):
        # the CPU stands in for every shard, as the JAX tests' forced host
        # devices do; on the card the mesh takes the visible cards
        n = args.tp * args.pp * args.sp * args.ep * args.dp
        devices = [args.device] * n if args.device == "cpu" else None
        mesh = make_mesh(**axes, devices=devices)
    # paged is the CLI's default, as in the JAX CLI (cli.py:236); library
    # engines keep contiguous. The mesh-paged path covers pure pp x tp
    # meshes; other meshes keep contiguous, as there (:236-250)
    kv_layout = resolve_kv_layout(args.kv_layout, default="paged")
    if kv_layout == "paged" and mesh is not None:
        pure_pptp = args.dp == 1 and args.sp == 1 and args.ep == 1 and (
            args.pp > 1 or args.tp > 1)
        if not pure_pptp:
            print(
                "⚠️  --kv-layout paged covers single-chip and pure pp x tp "
                "pipeline meshes: this topology keeps the contiguous KV layout"
            )
            kv_layout = "contiguous"
    # the grammar arena as the JAX CLI builds it (cli.py:251-260): on by
    # default where it can serve, one device with device decode, so every
    # decode program carries the mask; off on a mesh and under --host-decode
    # (an explicit DLT_GRAMMAR=1 still reaches the engine, which warns);
    # DLT_GRAMMAR=0 turns it off. Library engines keep the env-or-off default
    gr_capable = mesh is None and not args.host_decode
    grammar = resolve_grammar_enabled(None, default="1" if gr_capable else "0")
    draft_source = None
    if spec_mode == "model":
        # the draft engine: batch 1, speculation and the prefix cache off
        # (explicitly, so an ambient DLT_SPECULATIVE=model cannot recurse);
        # torn down if the main engine fails
        draft_source = ModelDraft(
            InferenceEngine(args.draft_model, compute_dtype=args.compute_dtype, batch=1,
                            device_decode=True, device=args.device, prefix_cache_mb=0,
                            speculative="off"),
            owns=True,
        )
    try:
        engine = InferenceEngine(
            args.model,
            compute_dtype=args.compute_dtype,
            cache_dtype=args.cache_dtype,
            max_seq_len=args.max_seq_len,
            batch=batch,
            max_chunk=max_chunk,
            device_decode=not args.host_decode,
            verbose=True,
            device=None if mesh is not None else args.device,
            mesh=mesh,
            kv_layout=kv_layout,
            kv_page_size=args.kv_page_size or None,
            kv_pool_mb=args.kv_pool_mb or None,
            prefix_cache_mb=prefix_mb,
            speculative=spec_mode or "off",
            draft_k=draft_k,
            draft_source=draft_source,
            grammar=grammar,
        )
    except BaseException:
        if draft_source is not None:
            draft_source.close()
        raise
    if prefix_mb > 0 and engine.prefix_cache is None:
        # the JAX CLI's warning, word for word: a requested cache that
        # cannot be built means no KV reuse across requests
        print(
            "⚠️  prefix cache unavailable on this topology (sp>1 mesh or "
            "tiny context): cross-request KV reuse is OFF; multi-turn "
            "chats re-prefill their full history each turn"
        )
    return engine


def make_sampler(args, vocab_size: int) -> Sampler:
    seed = args.seed if args.seed is not None else 12345
    return Sampler(vocab_size, args.temperature, args.topp, seed)


def run_inference(args) -> int:
    if not args.prompt:
        print("Prompt is required", file=sys.stderr)
        return 1
    if args.steps == 0:
        print("Number of steps is required", file=sys.stderr)
        return 1
    engine = make_engine(args)
    tok = Tokenizer(args.tokenizer)
    sampler = make_sampler(args, engine.cfg.vocab_size)
    ids = tok.encode(args.prompt)

    print(args.prompt)
    pieces: list[str] = []

    def on_token(t):
        piece = tok.decode(t)
        pieces.append(piece or "")

    res = engine.generate(ids, args.steps, sampler=sampler, on_token=on_token)

    for s in res.eval_steps:
        print(f"🔷️ Eval{s.eval_us // 1000:5d} ms | ({s.n_tokens} tokens)")
    pi = 0
    for s in res.pred_steps:
        text = "".join(pieces[pi : pi + s.n_tokens]) or "~"
        label = f"({s.n_tokens} tokens) " if s.n_tokens > 1 else ""
        print(f"🔶 Pred{s.eval_us // 1000:5d} ms | {label}{text}")
        pi += s.n_tokens

    n_eval = res.n_prompt_tokens - 1
    n_pred = res.n_pred_tokens
    eval_ms = sum(s.eval_us for s in res.eval_steps) / 1000.0
    pred_ms = sum(s.eval_us for s in res.pred_steps) / 1000.0
    print()
    print("Load")
    print(f"    seconds: {engine.load_seconds:3.2f}")
    print("Evaluation")
    print(f"   nBatches: {engine.max_chunk}")
    print(f"    nTokens: {n_eval}")
    if eval_ms > 0 and n_eval > 0:
        print(f"   tokens/s: {n_eval * 1000 / eval_ms:3.2f} ({eval_ms / n_eval:3.2f} ms/tok)")
    print("Prediction")
    print(f"    nTokens: {n_pred}")
    if pred_ms > 0 and n_pred > 0:
        print(f"   tokens/s: {n_pred * 1000 / pred_ms:3.2f} ({pred_ms / n_pred:3.2f} ms/tok)")
    print("Timing")
    print(f"  prefillMs: {res.prefill_us / 1000.0:3.2f}")
    print(f"     ttftMs: {(res.ttft_us or res.prefill_us) / 1000.0:3.2f}")
    print(f"   decodeMs: {res.decode_us / 1000.0:3.2f}")
    print(f"    totalMs: {res.total_us / 1000.0:3.2f}")
    print()
    print(engine.stats.report())
    engine.close()
    return 0


def run_perplexity(args) -> int:
    """Next-token probabilities over the prompt (reference:
    dllama.cpp:167-207), as the JAX CLI computes them: one teacher-forced
    forward with logits at every position per chunk of max_chunk tokens."""
    if not args.prompt:
        print("Prompt is required", file=sys.stderr)
        return 1
    engine = make_engine(args)
    tok = Tokenizer(args.tokenizer)
    ids = tok.encode(args.prompt)
    n = len(ids)
    print(f"Evaluating {n} tokens...")

    total_log_prob = 0.0
    pos = 0
    chunk = engine.max_chunk
    for i in range(0, n - 1, chunk):
        part = ids[i : i + chunk]
        probs = _softmax_np(engine.forward_tokens(part, i, logits_mode="all")[0])
        for j in range(len(part)):
            if i + j + 1 >= n:
                break
            p = max(float(probs[j, ids[i + j + 1]]), 1e-30)
            total_log_prob += float(np.log(p))
            pos += 1
            print(f"{pos:5d} / {n - 1}, prob={p:f}")

    avg = total_log_prob / (n - 1)
    print()
    print("Results")
    print(f"   perplexity: {float(np.exp(-avg)):f} (lower = better)")
    print(f"   avgLogProb: {avg:f}")
    print(f"   bitPerToken: {-avg / float(np.log(2.0)):f}")
    engine.close()
    return 0


def _softmax_np(x):
    m = x.max(axis=-1, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=-1, keepdims=True)


def run_chat(args) -> int:
    """Interactive chat REPL (reference: dllama.cpp:209-305): each turn's
    prompt continues the cache where the previous turn stopped."""
    engine = make_engine(args)
    tok = Tokenizer(args.tokenizer)
    sampler = make_sampler(args, engine.cfg.vocab_size)

    template_type = (
        ChatTemplateGenerator.parse_type(args.chat_template)
        if args.chat_template
        else TEMPLATE_UNKNOWN
    )
    stops = [tok.piece(t).decode("utf-8", errors="replace") for t in tok.eos_token_ids]
    gen = ChatTemplateGenerator(template_type, tok.chat_template, stops[0] if stops else "")
    max_stop = max((len(s) for s in stops), default=0)

    try:
        sys_prompt = input("💻 System prompt (optional): ")
    except (EOFError, KeyboardInterrupt):
        print()
        return 0
    delta_items: list[ChatItem] = []
    if sys_prompt:
        delta_items.append(ChatItem("system", sys_prompt))

    pos = 0
    seq_len = engine.cfg.seq_len
    while pos < seq_len:
        user = ""
        try:
            while not user:
                user = input("\n👱 User\n> ")
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        delta_items.append(ChatItem("user", user))
        prompt = gen.generate(delta_items, True)
        ids = tok.encode(prompt.content, is_start=(pos == 0))
        if pos + len(ids) - 1 >= seq_len:
            break

        tok.reset_decoder()
        detector = EosDetector(tok.eos_token_ids, stops, max_stop, max_stop)
        print("\n🤖 Assistant")
        if prompt.public_prompt:
            print(prompt.public_prompt, end="")

        # chunked on-device decode with host-side stop scanning: tokens past
        # the stop are dropped, and the next turn's prefill rewrites the
        # cache past this turn's end before reading it
        state = {"stop": False}

        def on_token(t):
            piece = tok.decode(t)
            eos_type = detector.append(t, piece)
            if eos_type != EOS_MAYBE:
                delta = detector.get_delta()
                if delta:
                    print(delta, end="", flush=True)
                detector.reset()
            if eos_type == EOS_FOUND:
                state["stop"] = True

        res = engine.generate(
            ids, seq_len, sampler=sampler, pos_start=pos,
            on_token=on_token, stop_fn=lambda t: state["stop"],
        )
        pos = pos + len(ids) - 1 + res.n_pred_tokens
        delta_items.clear()
    print("(end of context)")
    return 0


def _worker_migration_message() -> int:
    # the JAX CLI's text (distributed_llama_tpu/cli.py), word for word: the
    # reference's `dllama worker` processes have no counterpart here either
    print(
        "this framework has no worker processes: multi-chip/multi-host "
        "execution runs the SAME command on every host.\n"
        "  reference:  dllama inference --workers h1:port h2:port ...\n"
        "  here:       <same inference command> --tp N      (one host)\n"
        "              <same inference command> --distributed "
        "--coordinator h0:port --num-processes P --process-id i  (pod)\n"
        "see docs/DISTRIBUTED.md",
        file=sys.stderr,
    )
    return 2


def main(argv=None) -> int:
    raw = list(argv) if argv is not None else sys.argv[1:]
    if raw[:1] == ["worker"]:  # before parsing, so the reference's worker flags do not matter
        return _worker_migration_message()
    args = build_arg_parser().parse_args(raw)
    if args.mode == "worker":  # `worker` later in argv parses as the mode
        return _worker_migration_message()
    if args.model is None or args.tokenizer is None:
        print("--model and --tokenizer are required", file=sys.stderr)
        return 2
    modes = {"inference": run_inference, "perplexity": run_perplexity, "chat": run_chat}
    return modes[args.mode](args)


if __name__ == "__main__":
    sys.exit(main())
