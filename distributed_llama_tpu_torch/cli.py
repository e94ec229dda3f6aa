"""Command-line entry point — the `dllama` analogue, on PyTorch.

The counterpart of the JAX package's `cli.py` for the `inference` mode
(reference: src/dllama.cpp:13-151): the same flags where this slice runs
them, plus `--device {cuda,cpu}` (default cuda: the CLI runs on the card
unless asked for the CPU). The JAX CLI's defaults turn on the paged KV
layout, ngram speculation and the prefix cache; this port defaults to the
contiguous layout with both off, and a value not ported yet raises
NotImplementedError naming its ROADMAP item.

Usage:
  python -m distributed_llama_tpu_torch.cli inference --model m.m \
      --tokenizer t.t --prompt "Hello" --steps 64 [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from .runtime.engine import InferenceEngine
from .tokenizer import Sampler, Tokenizer


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="distributed_llama_tpu_torch")
    p.add_argument("mode", choices=["inference", "chat", "perplexity"])
    p.add_argument("--model", required=False, default=None)
    p.add_argument("--tokenizer", required=False, default=None)
    p.add_argument("--prompt", default=None)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--max-seq-len", type=int, default=0)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--topp", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument(
        "--cache-dtype", "--kv-dtype", dest="cache_dtype",
        choices=["bfloat16", "float32", "int8"], default=None,
        help="KV cache storage dtype (default: the compute dtype's); int8 is "
        "not ported yet",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the model runs (default cuda; no GPU is an error, not a "
        "fallback)",
    )
    p.add_argument("--batch", type=int, default=1)
    p.add_argument(
        "--host-decode", action="store_true",
        help="per-token host decode loop (bit-parity RNG with the reference)",
    )
    p.add_argument("--max-batch-size", "--nbatches", dest="max_chunk", type=int, default=32)
    p.add_argument("--prefill-chunk-size", type=int, default=0)
    p.add_argument(
        "--kv-layout", choices=["contiguous", "paged"], default="contiguous",
        help="KV cache layout; only contiguous is ported",
    )
    p.add_argument(
        "--speculative", choices=["off", "ngram", "model"], default="off",
        help="speculative decoding draft source; only off is ported",
    )
    p.add_argument(
        "--prefix-cache-mb", type=int, default=0,
        help="radix prefix cache budget; only 0 (off) is ported",
    )
    return p


def _refuse_unported(args) -> None:
    """Flags the JAX CLI has whose other values this slice does not run."""
    for flag, value, ported, item in (
        ("--batch", args.batch, 1, "A8, batched decode"),
        ("--kv-layout", args.kv_layout, "contiguous", "A9, paged and int8 KV"),
        ("--speculative", args.speculative, "off", "A10, speculation"),
        ("--prefix-cache-mb", args.prefix_cache_mb, 0, "A10, prefix cache"),
    ):
        if value != ported:
            raise NotImplementedError(f"{flag} {value} is not ported yet (ROADMAP {item})")


def make_engine(args) -> InferenceEngine:
    _refuse_unported(args)
    max_chunk = args.prefill_chunk_size if args.prefill_chunk_size > 0 else args.max_chunk
    return InferenceEngine(
        args.model,
        compute_dtype=args.compute_dtype,
        cache_dtype=args.cache_dtype,
        max_seq_len=args.max_seq_len,
        max_chunk=max_chunk,
        device_decode=not args.host_decode,
        verbose=True,
        device=args.device,
    )


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
    engine.close()
    return 0


def main(argv=None) -> int:
    raw = list(argv) if argv is not None else sys.argv[1:]
    args = build_arg_parser().parse_args(raw)
    if args.model is None or args.tokenizer is None:
        print("--model and --tokenizer are required", file=sys.stderr)
        return 2
    if args.mode == "inference":
        return run_inference(args)
    raise NotImplementedError(
        f"the {args.mode} mode is not ported yet (ROADMAP A6b, chat and perplexity)"
    )


if __name__ == "__main__":
    sys.exit(main())
