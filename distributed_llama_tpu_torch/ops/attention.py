"""Grouped-query attention against a full KV cache, in plain PyTorch, and
its sequence-parallel forms.

The counterpart of the JAX package's `ops/attention.py`: `gqa_attention`
(:172) is an XLA einsum there, used at decode (t = 1) and wherever the flash
kernel's gate refuses a shape, so plain tensor ops are its port too; so is
`gqa_attention_sp` (:28). Scores, softmax and the weighted V sum run in f32
whatever the cache dtype.

Sequence parallelism (the mesh's sp axis, parallel/): the cache's sequence
axis is cut into shards of `local_seq` rows, shard i holding the global rows
[i * local_seq, (i + 1) * local_seq). `scatter_cache_update_sp` (:99) writes
the rows of a chunk that land in one shard, and each shard computes the
unnormalized online-softmax triple (o, m, l) over its rows: `_gqa_partial`
with torch ops, or the B8 kernel (`cuda_attention.flash_attention_partial`)
for prefill chunks in `flash_attention_sp` (:138). Where JAX combines the
shards' triples with pmax/psum under shard_map, `_combine` takes the list of
triples on the mesh's first device:

    M = max over shards of m;  out = sum(o * e^(m - M)) / max(sum(l * e^(m - M)), 1e-30)

with the sums taken in shard order 0, 1, ..., n - 1.
"""

from __future__ import annotations

import torch

from .cuda_attention import flash_attention_partial

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


def scatter_cache_update_sp(
    cache: torch.Tensor,
    new: torch.Tensor,
    pos_start: int,
    shard_offset: int,
    layer: int | None = None,
) -> torch.Tensor:
    """Write new KV rows into one shard of a sequence-sharded cache, in
    place, and return the cache.

    cache: the shard's [b, local_seq, n_kv, hd] slab, or with `layer` the
    [L, b, local_seq, n_kv, hd] stack; new: [b, t, n_kv, hd] at the GLOBAL
    positions pos_start + arange(t) in every row (JAX takes the [b, t]
    positions; the port's sp path runs aligned rows only); shard_offset:
    the global position of the shard's row 0. A chunk may straddle shards:
    each shard writes exactly the rows that land in its range, and a row
    below the shard does not wrap to its end."""
    dst = cache if layer is None else cache[layer]
    local_seq, t = dst.shape[1], new.shape[1]
    lo = max(pos_start, shard_offset)
    hi = min(pos_start + t, shard_offset + local_seq)
    if lo < hi:
        dst[:, lo - shard_offset : hi - shard_offset] = new[:, lo - pos_start : hi - pos_start]
    return cache


def _gqa_partial(q, k_local, v_local, positions, shard_offset: int, scale: float):
    """One shard's unnormalized triple over its rows, as JAX's
    gqa_attention_sp computes it before the collectives: o [b, kv, g, t,
    hd], m [b, kv, g, t] clamped to NEG_INF / 2 (a fully masked row stays
    finite), l [b, kv, g, t]."""
    b, t, n_heads, head_dim = q.shape
    local_seq, n_kv = k_local.shape[1], k_local.shape[2]
    qg = q.reshape(b, t, n_kv, n_heads // n_kv, head_dim).to(torch.float32)
    scores = torch.einsum("bqhgd,bthd->bhgqt", qg, k_local.to(torch.float32)) * scale
    cols = shard_offset + torch.arange(local_seq, device=q.device)
    mask = (cols[None, None, :] <= positions[:, :, None])[:, None, None]  # [b, 1, 1, t, S]
    scores = torch.where(mask, scores, NEG_INF)
    m_safe = torch.clamp(scores.amax(dim=-1), min=NEG_INF / 2)
    e = torch.where(mask, torch.exp(scores - m_safe[..., None]), 0.0)
    o = torch.einsum("bhgqt,bthd->bhgqd", e, v_local.to(torch.float32))
    return o, m_safe, e.sum(dim=-1)


def _combine(parts, device: torch.device) -> torch.Tensor:
    """The exact cross-shard online-softmax combine of per-shard (o, m, l)
    triples (o with one trailing axis more than m and l), on `device`, the
    sums in shard order. Returns the f32 normalized output."""
    parts = [tuple(x.to(device) for x in part) for part in parts]
    m_max = parts[0][1]
    for _, m, _ in parts[1:]:
        m_max = torch.maximum(m_max, m)
    o_sum = l_sum = None
    for o, m, l in parts:
        corr = torch.exp(m - m_max)
        o_c, l_c = o * corr[..., None], l * corr
        o_sum = o_c if o_sum is None else o_sum + o_c
        l_sum = l_c if l_sum is None else l_sum + l_c
    return o_sum / torch.clamp(l_sum, min=1e-30)[..., None]


def gqa_attention_sp(
    q: torch.Tensor,
    k_locals: list,
    v_locals: list,
    positions: torch.Tensor,
    shard_offsets: list,
    scale: float | None = None,
) -> torch.Tensor:
    """Sequence-parallel GQA attention (decode, and chunks the flash gate
    refuses): q [b, t, H, hd] and positions [b, t] (GLOBAL) on the mesh's
    first device; shard i's [b, local_kv, n_kv, hd] views and its offset.
    Each shard's triple is computed on the shard's device and combined on
    q's. Returns [b, t, H, hd] in q.dtype."""
    b, t, n_heads, head_dim = q.shape
    if scale is None:
        scale = 1.0 / (head_dim ** 0.5)
    parts = [
        _gqa_partial(q.to(k.device), k, v, positions.to(k.device), off, scale)
        for k, v, off in zip(k_locals, v_locals, shard_offsets)
    ]
    out = _combine(parts, q.device)  # [b, kv, g, t, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, n_heads, head_dim).to(q.dtype)


def flash_attention_sp(
    q: torch.Tensor,
    k_locals: list,
    v_locals: list,
    pos_start: int,
    shard_offsets: list,
) -> torch.Tensor:
    """Sequence-parallel blocked attention for prefill chunks: B8 on each
    shard's view (`flash_attention_partial`, the kernel on the card) gives
    its unnormalized triple, and `_combine` joins them on q's device. A
    shard wholly in the chunk's future contributes exact zeros. Returns [b,
    t, H, hd] in q.dtype."""
    parts = [
        flash_attention_partial(q.to(k.device), k, v, pos_start, off)
        for k, v, off in zip(k_locals, v_locals, shard_offsets)
    ]
    return _combine(parts, q.device).to(q.dtype)
