"""On-device sampling (argmax / temperature / top-p).

The counterpart of the JAX package's `ops/sampling.py:sample_logits_traced`
and `_sample_topp`. The math is the same (temperature scaling -> softmax ->
top-p truncation at the first cumulative probability > topp, a pick within
the kept mass); the random numbers come from an explicit `torch.Generator`,
so a seeded stream differs from jax.random's. Tests hand `_sample_topp`
the uniform draw (`coin`) to compare the math.

Temperature and top-p are host floats here: PyTorch runs eagerly, so the
greedy/sampled split is a Python branch and costs no device sync.
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
