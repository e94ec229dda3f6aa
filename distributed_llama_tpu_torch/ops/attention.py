"""Grouped-query attention against a full KV cache, in plain PyTorch.

The counterpart of the JAX package's `ops/attention.py:gqa_attention`: there
it is an XLA einsum, used at decode (t = 1) and wherever the flash kernel's
gate refuses a shape, so plain tensor ops are its port too. Scores, softmax
and the weighted V sum run in f32 whatever the cache dtype.
"""

from __future__ import annotations

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def gqa_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    positions: torch.Tensor,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal GQA attention over the (padded) cache.

    q: [batch, q_len, n_heads, head_dim]
    k_cache, v_cache: [batch, cache_len, n_kv_heads, head_dim]
    positions: [batch, q_len] absolute position of each query token; cache
        slot t is visible to a query at position p iff t <= p.
    Returns [batch, q_len, n_heads, head_dim] in q.dtype.
    """
    b, q_len, n_heads, head_dim = q.shape
    cache_len = k_cache.shape[1]
    n_kv_heads = k_cache.shape[2]
    kv_mul = n_heads // n_kv_heads
    if scale is None:
        scale = 1.0 / (head_dim ** 0.5)

    qg = q.reshape(b, q_len, n_kv_heads, kv_mul, head_dim).to(torch.float32)
    kf = k_cache.to(torch.float32)
    vf = v_cache.to(torch.float32)
    # scores: [b, n_kv_heads, kv_mul, q_len, cache_len]
    scores = torch.einsum("bqhgd,bthd->bhgqt", qg, kf) * scale
    t_idx = torch.arange(cache_len, device=q.device)
    mask = t_idx[None, None, :] <= positions[:, :, None]  # [b, q_len, cache_len]
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqt,bthd->bqhgd", probs, vf)
    return out.reshape(b, q_len, n_heads, head_dim).to(q.dtype)
