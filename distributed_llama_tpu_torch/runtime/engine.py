"""The inference engine: model loading, prefill/decode orchestration, timing.

The counterpart of the JAX package's `runtime/engine.py` (the reference's
`RootLlmInference` + `inference()` loop, src/app.cpp:223-303,
src/dllama.cpp:13-151), for one device at batch 1 with a contiguous KV
cache: `chunk_plan`, `__init__`, `_kv_bucket`, `reset`, `prefill` (serial,
no prefix cache), `decode_one`, `generate`, `_decode_host` and
`_decode_device`.

* The engine runs on the card unless the caller asks for the CPU:
  `device=None` means "cuda" and raises where no GPU is present.
* Prompt chunks are padded to power-of-two buckets, as in the JAX package,
  so a run takes the same chunk shapes (and numerics arms) there and here.
  Padded tail positions write junk into cache slots past the true length;
  those slots are masked (attention sees t <= pos) or overwritten by the
  next real token before they are read.
* The KV cache lives on the device and is updated in place.
* Decode runs in chunks of device steps with one token fetch to the host
  per chunk (`_decode_device`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..formats.mfile import MFileReader
from ..models import config_from_header, forward, init_kv_cache, load_params
from ..ops.rope import build_rope_tables
from ..tokenizer import Sampler
from .decode import decode_chunk


@dataclass
class StepTiming:
    """Wall time of one host-observable unit (a prefill chunk, a decode
    chunk, or one host-loop decode step) over `n_tokens` tokens."""

    eval_us: int = 0
    n_tokens: int = 0


@dataclass
class GenerationResult:
    tokens: list[int] = field(default_factory=list)
    n_prompt_tokens: int = 0
    prefill_us: int = 0
    ttft_us: int = 0
    decode_us: int = 0
    total_us: int = 0
    eval_steps: list[StepTiming] = field(default_factory=list)
    pred_steps: list[StepTiming] = field(default_factory=list)

    @property
    def n_pred_tokens(self) -> int:
        return len(self.tokens) - self.n_prompt_tokens


def _chunk_buckets(max_chunk: int) -> list[int]:
    out = [1]
    while out[-1] < max_chunk:
        out.append(min(out[-1] * 2, max_chunk))
    return out


def chunk_plan(n_tokens: int, pos_start: int, max_chunk: int, seq_len: int):
    """The padded power-of-two prefill ladder: yields (offset, size, n_real)
    triples covering `n_tokens` tokens whose first absolute position is
    `pos_start`. The last chunk's tail past `n_real` is padding. Raises when
    a chunk would write past seq_len."""
    buckets = _chunk_buckets(max_chunk)
    i = 0
    while i < n_tokens:
        remaining = n_tokens - i
        size = next(b for b in buckets if b >= min(remaining, max_chunk))
        size = min(size, seq_len - (pos_start + i))
        if size <= 0:
            raise ValueError(
                f"prefill would write past seq_len ({seq_len}): "
                f"{n_tokens} tokens starting at position {pos_start}"
            )
        n_real = min(size, remaining)
        yield i, size, n_real
        i += n_real


def resolve_device(device) -> torch.device:
    """`None` means the card. A CUDA device where none is present raises:
    the engine never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class InferenceEngine:
    """Owns params + cache for one model on one device, at batch 1."""

    def __init__(
        self,
        model_path: str,
        compute_dtype: str = "bfloat16",
        max_seq_len: int = 0,
        max_chunk: int = 32,
        cache_dtype: str | None = None,
        device_decode: bool = True,
        decode_chunk_size: int = 64,
        verbose: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        t0 = time.perf_counter()
        self.reader = MFileReader(model_path, max_seq_len=max_seq_len)
        self.header = self.reader.header
        self.cfg = config_from_header(
            self.header, compute_dtype=compute_dtype, cache_dtype=cache_dtype
        )
        self.params = load_params(self.reader, self.cfg, device=self.device)
        # the header's seq_len is already capped at max_seq_len, so the
        # tables cover the cache, not the model's 128k context
        self.rope = build_rope_tables(self.header, device=self.device)
        self.max_chunk = max(1, min(max_chunk, self.cfg.seq_len))
        # device_decode: chunked decode on the device (fast path); False =
        # per-token host loop with the reference's exact RNG stream
        self.device_decode = device_decode
        self.decode_chunk_size = decode_chunk_size
        self.cache = init_kv_cache(self.cfg, batch=1, device=self.device)
        self._sync()
        self.load_seconds = time.perf_counter() - t0
        if verbose:
            print(self.memory_report())

    def close(self):
        self.reader.close()

    def memory_report(self) -> str:
        def nbytes(x):
            if x is None:
                return 0
            if hasattr(x, "q"):
                return x.q.numel() * x.q.element_size() + x.d.numel() * x.d.element_size()
            return x.numel() * x.element_size()

        p = self.params
        w = sum(nbytes(getattr(p.layers, f)) for f in p.layers.__dataclass_fields__)
        w += nbytes(p.embedding) + nbytes(p.final_norm) + nbytes(p.wcls)
        kv = nbytes(self.cache.k) + nbytes(self.cache.v)
        return (
            f"💿 weights {w / 2**20:.1f} MiB, KV cache {kv / 2**20:.1f} MiB "
            f"on {self.device}"
        )

    # -- low-level steps ----------------------------------------------------

    def _kv_bucket(self, end_pos: int) -> int:
        """Attention reads cache[:, :bucket]: the smallest power-of-two
        bucket covering `end_pos`, floored at 256, as in the JAX package."""
        floor = min(256, self.cfg.seq_len)
        b = floor
        while b < end_pos:
            b *= 2
        return min(b, self.cfg.seq_len)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tokens(self, rows) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.long).to(self.device, non_blocking=True)

    def reset(self):
        """Fresh independent sequence: zero the cache."""
        self.cache.k.zero_()
        self.cache.v.zero_()

    def prefill(self, tokens: list[int], pos_start: int = 0, on_chunk=None) -> None:
        """Feed `tokens` through the model in padded power-of-two chunks.
        Only the KV cache matters: the first generated token's logits come
        from the decode step that feeds the final prompt token (the
        reference's shape: prefill covers nInputTokens-1 tokens,
        dllama.cpp:44-85)."""
        n = len(tokens)
        if n == 0:
            return
        t0 = time.perf_counter()
        plan = list(chunk_plan(n, pos_start, self.max_chunk, self.cfg.seq_len))
        for i, size, n_real in plan:
            chunk = tokens[i : i + n_real] + [0] * (size - n_real)
            forward(
                self.cfg, self.params, self.rope, self.cache,
                self._tokens([chunk]), pos_start + i,
                logits_mode="last", kv_len=self._kv_bucket(pos_start + i + size),
            )
        self._sync()
        total_us = int((time.perf_counter() - t0) * 1e6)
        if on_chunk is not None:
            for _, _, n_real in plan:
                on_chunk(StepTiming(eval_us=total_us * n_real // n, n_tokens=n_real))

    def decode_one(self, token: int, pos: int) -> np.ndarray:
        """One decode step; returns host logits [1, vocab]."""
        logits = forward(
            self.cfg, self.params, self.rope, self.cache,
            self._tokens([[token]]), pos, kv_len=self._kv_bucket(pos + 1),
        )
        return logits.cpu().numpy()

    # -- generation ---------------------------------------------------------

    def generate(
        self,
        prompt_tokens: list[int],
        steps: int,
        sampler: Sampler | None = None,
        on_token=None,
        stop_fn=None,
        pos_start: int = 0,
    ) -> GenerationResult:
        """The reference `inference()` loop (dllama.cpp:13-151): prefill all
        but the last prompt token, then decode until position `steps` or
        `stop_fn(token)` says stop."""
        if not prompt_tokens:
            raise ValueError("prompt tokens required")
        if pos_start + len(prompt_tokens) > self.cfg.seq_len:
            raise ValueError("prompt is longer than the sequence length")
        res = GenerationResult(tokens=list(prompt_tokens), n_prompt_tokens=len(prompt_tokens))
        wall0 = time.perf_counter()
        self.prefill(prompt_tokens[:-1], pos_start, on_chunk=res.eval_steps.append)
        res.prefill_us = int((time.perf_counter() - wall0) * 1e6)
        pos = pos_start + len(prompt_tokens) - 1
        token = prompt_tokens[-1]
        max_pos = min(self.cfg.seq_len, steps)
        if self.device_decode:
            self._decode_device(res, token, pos, max_pos, sampler, on_token, stop_fn, wall0)
        else:
            self._decode_host(res, token, pos, max_pos, sampler, on_token, stop_fn, wall0)
        res.total_us = int((time.perf_counter() - wall0) * 1e6)
        res.decode_us = res.total_us - res.prefill_us
        return res

    def _decode_host(self, res, token, pos, max_pos, sampler, on_token, stop_fn, wall0):
        """Per-token host loop: one device round trip per token. Bit-parity
        path (host Sampler = the reference's xorshift* stream)."""
        greedy = sampler is None or sampler.temperature == 0.0
        first = True
        while pos < max_pos:
            t0 = time.perf_counter()
            logits = self.decode_one(token, pos)
            token = int(np.argmax(logits[0])) if greedy else sampler.sample(logits[0].copy())
            res.pred_steps.append(StepTiming(eval_us=int((time.perf_counter() - t0) * 1e6), n_tokens=1))
            if first:
                res.ttft_us = int((time.perf_counter() - wall0) * 1e6)
                first = False
            res.tokens.append(token)
            pos += 1
            if on_token is not None:
                on_token(token)
            if stop_fn is not None and stop_fn(token):
                return

    def _generator(self, sampler) -> torch.Generator | None:
        """The device generator for sampled chunks, seeded from the host
        sampler's xorshift* state (a different stream from the reference's;
        the host loop is the bit-parity path)."""
        if sampler is None or sampler.temperature == 0.0:
            return None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(sampler._state) & 0xFFFFFFFFFFFFFFFF)
        return gen

    def _decode_device(self, res, token, pos, max_pos, sampler, on_token, stop_fn, wall0):
        """Chunked on-device decode: n forward+sample steps per chunk, one
        token fetch per chunk; each chunk's last token stays on the device
        and feeds the next chunk.

        Unlike the JAX engine, there is no one-chunk lookahead: an eager
        dispatch is host work as long as the chunk itself, so dispatching
        chunk i + 1 before reading chunk i would only hold chunk i's tokens
        back by a whole chunk (on an H100 at 1B width, chip_smoke.py's CLI
        run: TTFT 2.0 s with the lookahead, 0.29 s without)."""
        temperature = 0.0 if sampler is None else sampler.temperature
        topp = sampler.topp if sampler is not None else 0.9
        gen = self._generator(sampler)
        tok_arr = self._tokens([token])
        # a streaming consumer gets its first tokens after a short first
        # chunk (the JAX engine's TTFT ramp; the same chunk ladder as there)
        n = min(8, self.decode_chunk_size) if on_token is not None else self.decode_chunk_size
        first = True
        t_prev = time.perf_counter()
        while pos < max_pos:
            limit = min(max_pos, self.cfg.seq_len) - pos
            # largest power-of-two chunk that fits the remaining budget
            while n > limit:
                n //= 2
            n = max(n, 1)
            toks, tok_arr = decode_chunk(
                self.cfg, self.params, self.rope, self.cache, tok_arr, pos,
                n_steps=n, temperature=temperature, topp=topp, generator=gen,
                kv_len=self._kv_bucket(pos + n),
            )
            host_toks = toks[0].tolist()  # the one device-to-host fetch of the chunk
            now = time.perf_counter()
            res.pred_steps.append(StepTiming(eval_us=int((now - t_prev) * 1e6), n_tokens=n))
            t_prev = now
            if first:
                res.ttft_us = int((now - wall0) * 1e6)
                first = False
            for t in host_toks:
                res.tokens.append(t)
                pos += 1
                if on_token is not None:
                    on_token(t)
                if stop_fn is not None and stop_fn(t):
                    # tokens past the stop are dropped; the cache overran by
                    # up to the chunk's tail, which a continuation rewrites
                    # before reading
                    return
            n = self.decode_chunk_size
