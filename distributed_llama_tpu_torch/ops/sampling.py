"""On-device sampling (argmax / temperature / top-p).

The counterpart of the JAX package's `ops/sampling.py:sample_logits_traced`
and `_sample_topp`. The math is the same (temperature scaling -> softmax ->
top-p truncation at the first cumulative probability > topp, a pick within
the kept mass); the random numbers come from an explicit `torch.Generator`,
so a seeded stream differs from jax.random's. Tests hand `_sample_topp`
the uniform draw (`coin`) to compare the math.

Temperature and top-p are host floats here: PyTorch runs eagerly, so the
greedy/sampled split is a Python branch and costs no device sync.

The batched path's per-row sampling (`sample_logits_per_row`, the JAX
package's :158) takes per-row settings as device vectors and one uniform
draw per row from `row_coins`, a counter-based hash of the row's seed and
draw count (the counterpart of `split_row_keys` :143).
"""

from __future__ import annotations

import torch


def _sample_topp(probs: torch.Tensor, topp: float, coin: torch.Tensor) -> torch.Tensor:
    """Top-p pick over [b, vocab] probs with a [b, 1] uniform `coin`: keep
    everything up to and including the first element whose cumulative
    probability exceeds topp (reference: sample_topp, tokenizer.cpp:426-447)."""
    b, n = probs.shape
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    csum = torch.cumsum(sorted_probs, dim=-1)
    over = csum > topp
    keep = torch.logical_not(
        torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=probs.device), over[:, :-1]], dim=-1)
    )
    kept = torch.where(keep, sorted_probs, 0.0)
    kept_sum = kept.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(kept, dim=-1)
    pick = (cdf < coin * kept_sum).sum(dim=-1).clamp(0, n - 1)
    return torch.gather(order, 1, pick[:, None])[:, 0]


def sample_logits_traced(
    logits: torch.Tensor,  # [b, vocab] f32
    temperature: float,  # <= 0 = greedy
    topp: float,  # outside (0, 1) = full distribution
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Returns [b] int64 sampled tokens, on the logits' device."""
    if temperature <= 0.0:
        # argmax returns the first maximal index on ties, as jnp.argmax does
        return torch.argmax(logits, dim=-1)
    b, n = logits.shape
    probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
    coin = torch.rand((b, 1), generator=generator, device=logits.device)
    if 0.0 < topp < 1.0:
        return _sample_topp(probs, topp, coin)
    cdf = torch.cumsum(probs, dim=-1)
    return (cdf < coin).sum(dim=-1).clamp(0, n - 1)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant, in
    16-bit halves so that no intermediate leaves the int64 range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 tensors holding uint32s."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def row_coins(seeds: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """One uniform draw in [0, 1) per row, [b, 1] f32, from a counter-based
    stream: a pure function of the row's own seed (int64, two 32-bit
    words) and its draw counter, so a row's stream never depends on its
    co-tenants or on the chunk it lands in. The counterpart of the JAX
    package's per-row threefry key chains (`split_row_keys` :143); the bits
    differ, so greedy is the parity path."""
    lo = seeds & _M32
    hi = (seeds >> 32) & _M32
    h = _fmix32(lo ^ _fmix32(_mul32(counters & _M32, 0x9E3779B9) ^ hi))
    return ((h >> 8).to(torch.float32) * (1.0 / (1 << 24)))[:, None]


def sample_logits_per_row(
    logits: torch.Tensor,  # [b, vocab] f32
    coin: torch.Tensor,  # [b, 1] uniform draws (row_coins)
    temperature: torch.Tensor,  # [b] f32; <= 0 = greedy for that row
    topp: torch.Tensor,  # [b] f32; outside (0, 1) = full distribution
) -> torch.Tensor:
    """Per-row sampling settings as device vectors, so one chunk serves any
    mix of greedy, temperature and top-p rows: the JAX package's
    `sample_logits_per_row` (:158). Each row takes the greedy argmax, the
    vocab-order CDF (topp outside (0, 1)) or the top-p sorted CDF, all
    computed and then selected per row. Returns [b] int64."""
    b, n = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature.clamp(min=1e-6)[:, None], dim=-1)
    full_pick = (torch.cumsum(probs, dim=-1) < coin).sum(dim=-1).clamp(0, n - 1)
    in_topp = (topp > 0.0) & (topp < 1.0)
    topp_safe = torch.where(in_topp, topp, 1.0)
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    over = torch.cumsum(sorted_probs, dim=-1) > topp_safe[:, None]
    keep = torch.logical_not(
        torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=logits.device), over[:, :-1]], dim=-1)
    )
    kept = torch.where(keep, sorted_probs, 0.0)
    kept_sum = kept.sum(dim=-1, keepdim=True)
    pick = (torch.cumsum(kept, dim=-1) < coin * kept_sum).sum(dim=-1).clamp(0, n - 1)
    topp_pick = torch.gather(order, 1, pick[:, None])[:, 0]
    sampled = torch.where(in_topp, topp_pick, full_pick)
    return torch.where(temperature <= 0.0, greedy, sampled)
