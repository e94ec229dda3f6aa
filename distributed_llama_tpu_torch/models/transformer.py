"""The transformer forward pass (Llama, Qwen3 and Qwen3-MoE).

The counterpart of the JAX package's `models/transformer.py`: its `linear`
(:39), `_dense_ffn` (:79), the MoE block (`_gather_expert` :93,
`_expert_matmul` :105, `_n_local_experts` :179, `_moe_ffn` :186,
`_moe_decode_i8` :270, single device), `_attention_auto` (:135),
`_fused_paged_eligible` (:164), the paged branch of `_layer` (:410-493), its
stacked contiguous branch with scalar or per-row positions and the int8 arm
(:495-558), its sequence-parallel branch (:591-640, driven by
parallel/pipeline.py), and `forward_uncompiled` (:660). PyTorch runs
eagerly, so the scan over layers is a Python loop and each matmul selects
its layer inside the kernel.

Math per layer (reference att segment src/llm.cpp:278-418, ff segment
src/llm.cpp:421-569):

    y  = rms_norm(x, norm0);  q|k|v = y @ Wqkv
    [qwen3: per-head rms_norm of q, k]
    q, k = rope(q, k); write k, v at their positions     (in place)
    a  = attention(q, the first kv_len positions);  x += a @ Wo
    y  = rms_norm(x, norm1)
    dense: x += (silu(y @ W1) * (y @ W3)) @ W2
    moe:   route y to its top-k experts; x += the weighted sum of their SwiGLUs

Dtype boundaries are the JAX package's: the residual stream is f32, matmul
operands are the compute dtype (bf16 on the fast path), `linear` returns its
input's dtype, and the cache is written in the cache dtype (int8 with f32
scales on the quantized arm, read back dequantized to the compute dtype).

Rows aligned at one position the host knows only as a device scalar (a
decode graph's step, runtime/graphs.py) write the contiguous cache with one
`index_copy_` along the sequence axis: the eager slice write's values and
launch count.

Rows at per-row positions may be parked (pos = seq_len) or finished: their
writes must not land. JAX drops them with mode="drop" scatters; here the
contiguous arm rewrites an in-bounds window with the old values
(`_write_rows`) and the paged arm sends them to the pool's sink page, both
by index arithmetic, with no host sync. That index work is the same in
every layer, so `forward` does it once (`_row_window`, `_paged_index`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import torch

from ..formats.mfile import HiddenAct
from ..ops.activations import gelu, silu
from ..ops.attention import (
    flash_attention_sp, gqa_attention, gqa_attention_sp, scatter_cache_update_sp,
)
from ..ops.cuda_attention import (
    flash_attention, flash_attention_aligned, paged_attention_eligible, paged_flash_attention,
)
from ..ops.cuda_q40 import q40_gemv_q80_indexed
from ..ops.kv_quant import dequantize_kv, quantize_kv
from ..ops.moe import ep_local_route, moe_ffn_ragged, moe_router
from ..ops.norm import rms_norm
from ..ops.quant import (
    QuantTensor, _f32_matmul, dequantize_t, q40_expert_aligned, quant_matmul,
    quantize_q80_activations, slice_layer,
)
from ..ops.rope import RopeTables, rope_rows, rotate
from .config import ModelConfig
from .params import KVCache, LayerParams, ModelParams


def linear(x: torch.Tensor, w: Any, dtype, layer: int | None = None,
           q80: bool = False) -> torch.Tensor:
    """x @ w.T for a dense or Q40 weight; returns x.dtype. `layer`: use
    w[layer] of an all-layers stacked weight. `q80`: the reference-parity
    mode, the Q40 matmul's input round-tripped through Q80
    (ModelConfig.q80_activations)."""
    if isinstance(w, QuantTensor):
        if q80:
            x = quantize_q80_activations(x)
        return quant_matmul(x, w, dtype=dtype, layer=layer if w.q.ndim == 3 else None)
    if layer is not None and w.ndim == 3:
        w = w[layer]
    y = _f32_matmul(
        x.reshape(-1, x.shape[-1]).to(dtype).to(torch.float32),
        w.to(dtype).to(torch.float32).t(),
    )
    return y.reshape(*x.shape[:-1], w.shape[0]).to(x.dtype)


def _activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return silu(x) if cfg.hidden_act == HiddenAct.SILU else gelu(x)


def _dense_ffn(cfg: ModelConfig, y: torch.Tensor, lp: LayerParams, layer: int) -> torch.Tensor:
    # fused in-projection: one kernel reads w1|w3
    q80 = cfg.q80_activations
    h13 = linear(y, lp.w13, cfg.dtype, layer, q80)
    ff = h13.shape[-1] // 2
    h = _activation(cfg, h13[..., :ff]) * h13[..., ff:]
    return linear(h, lp.w2, cfg.dtype, layer, q80)


def _gather_expert(w: Any, idx: torch.Tensor) -> Any:
    """Per-token expert weights: w [E, ...] (one layer's stack) gathered by
    idx [b, t, k]."""
    sel = idx.long()
    if isinstance(w, QuantTensor):
        return QuantTensor(q=w.q[sel], d=w.d[sel])
    return w[sel]


def _expert_matmul(x: torch.Tensor, w: Any, dtype, q80: bool = False) -> torch.Tensor:
    """x [b, t, k, in] against per-token gathered experts (a QuantTensor in
    the T layout, or dense [..., out, in]) -> [b, t, k, out] in x.dtype. The
    operands take `dtype`, the products are exact in f32 and TF32 stays
    off. `q80`: a Q40 expert's input round-tripped through Q80."""
    if isinstance(w, QuantTensor):
        if q80:
            x = quantize_q80_activations(x)
        wd = dequantize_t(w, dtype)  # [b, t, k, in, out]
    else:
        wd = w.to(dtype).transpose(-1, -2)
    xd = x.to(dtype).to(torch.float32).unsqueeze(-2)  # [b, t, k, 1, in]
    y = _f32_matmul(xd, wd.to(torch.float32)).squeeze(-2)
    return y.to(x.dtype)


def _n_local_experts(w: Any, stacked: bool = False) -> int:
    """Expert count of an expert weight; `stacked`: w has a leading
    all-layers axis ([L, E, ...])."""
    axis = 1 if stacked else 0
    return w.q.shape[axis] if isinstance(w, QuantTensor) else w.shape[axis]


def _moe_decode_i8_eligible(cfg: ModelConfig, y: torch.Tensor, lp: LayerParams) -> bool:
    """One token on the bf16 kernel path with aligned Q40 expert stacks ->
    the indexed integer-dot kernel, which reads only the k active experts."""
    return (
        cfg.dtype == torch.bfloat16
        and y.shape[0] * y.shape[1] == 1
        and all(isinstance(w, QuantTensor) for w in (lp.w1, lp.w2, lp.w3))
        and q40_expert_aligned(lp.w1.in_features, lp.w1.out_features)
        and q40_expert_aligned(lp.w2.in_features, lp.w2.out_features)
    )


def _moe_decode_i8(cfg, y, lp, layer, idx, wts):
    """One token's top-k expert SwiGLU through K1-indexed on the [L*E]-flat
    expert stacks: w1 and w3 are one launch each over the k slots (the
    token's row quantized once, shared by every slot), w2 one launch over
    the k rows of h. The flat index layer * E + expert stays on the device:
    nothing syncs with the host."""
    n_e = _n_local_experts(lp.w1, stacked=lp.w1.q.ndim == 4)
    base = layer * n_e if layer is not None else 0
    k = idx.shape[-1]
    fi = (idx.reshape(k) + base).to(torch.int32)
    x = y.reshape(1, y.shape[-1])
    h = _activation(cfg, q40_gemv_q80_indexed(x, lp.w1.q, lp.w1.d, fi)) * q40_gemv_q80_indexed(
        x, lp.w3.q, lp.w3.d, fi
    )  # [k, ff]
    o = q40_gemv_q80_indexed(h.to(y.dtype), lp.w2.q, lp.w2.d, fi)  # [k, dim]
    return combine_slots(o, wts.reshape(k)).reshape(*y.shape[:2], cfg.dim)


def combine_slots(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum over slots of w[slot] * o[slot] in f32, added one slot at a time
    in slot order onto a zero row, as the JAX package's `_moe_decode_i8`
    adds them (:297-306): the same f32 roundings, so the same bits. One
    multiply for every slot, then k adds (a `.sum` would reassociate)."""
    prod = o * w.to(torch.float32).unsqueeze(-1)  # [k, dim]
    out = torch.zeros_like(prod[0])
    for slot in range(prod.shape[0]):
        out = out + prod[slot]
    return out


def moe_grouped(cfg, tokens: int) -> bool:
    """Whether `_moe_ffn` takes its grouped arm at `tokens` (b * t) tokens:
    as many expert rows (tokens * n_active) as experts or more. `cfg` is a
    ModelConfig or a model file's header."""
    return tokens * cfg.n_active_experts >= cfg.n_experts


def _moe_ffn(cfg: ModelConfig, y: torch.Tensor, lp: LayerParams, layer: int, route=None,
             ep=None) -> torch.Tensor:
    """Top-k expert SwiGLU (reference src/llm.cpp:440-514): the router on
    the normed activation, then the JAX package's choice of arm by the
    static row count rows = b * t * k:
      * rows >= E (prefill chunks): moe_ffn_ragged, the grouped kernel K4
        over every hit expert once;
      * one token on the bf16 kernel path: _moe_decode_i8 (K1-indexed);
      * otherwise (prefill tails of a few tokens, the f32 arm): gather each
        row's experts and dequantize them (plain torch; XLA in JAX).
    `route`: the router's (idx, wts), computed once for every shard of a
    mesh (the gate is replicated); None computes it here. `ep`: (e0,
    n_local), expert parallelism (JAX's `ep_axis`, :186-263): `lp` holds
    experts e0 .. e0 + n_local; slots routed to another shard are clamped
    to a local expert and zero-weighted before any arm is chosen
    (`ep_local_route`), so they add exact zeros, and the caller sums the
    shards' partials (JAX's psum over ep)."""
    idx, wts = route if route is not None else moe_router(y, lp.moe_gate[layer],
                                                          cfg.n_active_experts)  # [b, t, k]
    if ep is not None:
        idx, wts = ep_local_route(idx, wts, ep)
    act = partial(_activation, cfg)
    if moe_grouped(cfg, y.shape[0] * y.shape[1]):
        return moe_ffn_ragged(y, idx, wts, lp.w1, lp.w3, lp.w2, act, cfg.dtype, layer=layer,
                              q80=cfg.q80_activations)
    if _moe_decode_i8_eligible(cfg, y, lp):
        out = _moe_decode_i8(cfg, y, lp, layer, idx, wts)
    else:
        w1 = _gather_expert(slice_layer(lp.w1, layer), idx)
        w3 = _gather_expert(slice_layer(lp.w3, layer), idx)
        w2 = _gather_expert(slice_layer(lp.w2, layer), idx)
        xk = y[:, :, None, :].expand(*y.shape[:2], cfg.n_active_experts, y.shape[-1])
        q80 = cfg.q80_activations
        h = act(_expert_matmul(xk, w1, cfg.dtype, q80)) * _expert_matmul(xk, w3, cfg.dtype, q80)
        out = _expert_matmul(h, w2, cfg.dtype, q80)  # [b, t, k, dim]
        out = (out.to(torch.float32) * wts.unsqueeze(-1)).sum(dim=2)
    return out.to(y.dtype)


def _attention_auto(cfg, q, k_view, v_view, positions, pos_start):
    """Prefill-sized q on a bf16 cache, all rows aligned at a scalar
    `pos_start` -> the flash kernel (K3); otherwise (decode t = 1, per-row
    positions, the f32 parity path, unaligned shapes) the plain whole-view
    attention, whose reads the engine bounds with kv_len."""
    t = q.shape[1]
    if (
        isinstance(pos_start, int)
        and k_view.dtype == torch.bfloat16
        and flash_attention_aligned(q, k_view, t)
    ):
        return flash_attention(q, k_view, v_view, pos_start)
    return gqa_attention(q, k_view, v_view, positions)


def _kv_for_write(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor):
    """(k, v, k_scale, v_scale) as the cache stores them: quantized with
    their scales on the int8 arm (ops/kv_quant.py), cast otherwise."""
    if cfg.kv_quantized:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return kq, vq, ks, vs
    return k.to(cfg.kv_dtype), v.to(cfg.kv_dtype), None, None


def _row_window(pos: torch.Tensor, S: int, t: int) -> tuple:
    """Where `_write_rows` writes, the same in every layer, so built once per
    forward: row r rewrites the in-bounds window [w, w + t) of its slab,
    w = min(pos[r], S - t); slot i takes src[r, i - (pos[r] - w)] when that
    index is >= 0 and its old value otherwise. Returns (rows [b, 1], slots
    [b, t], src index [b, t], keep [b, t])."""
    dev = pos.device
    w = pos.clamp(0, S - t)
    steps = torch.arange(t, device=dev)
    j = steps[None, :] - (pos - w)[:, None]
    rows = torch.arange(pos.shape[0], device=dev)[:, None]
    return rows, w[:, None] + steps, j.clamp(0, t - 1), (j >= 0) & (j < t)


def _write_rows(dst: torch.Tensor, src: torch.Tensor, window: tuple) -> None:
    """dst[r, pos[r] + j] = src[r, j] for every position below dst's length;
    a write at or past it (a parked row, a finished row riding a batch
    chunk) leaves dst as it was. dst [b, S, ...] (a view, written in place),
    src [b, t, ...], `window` from `_row_window`.

    The JAX package scatters with mode="drop". Here every index is in bounds
    and unique, and nothing syncs with the host."""
    rows, idx, j, keep = window
    keep = keep.reshape(*keep.shape, *([1] * (src.ndim - 2)))
    dst[rows, idx] = torch.where(keep, src[rows, j], dst[rows, idx])


def _contiguous_attention(cfg, q, k, v, positions, pos_start, cache: KVCache, li, kv_len,
                          window):
    """Write this layer's K/V into the [L, b, S, h, d] cache in place and
    attend over its first kv_len positions. `window`: per-row positions'
    `_row_window`, the [t] slots of rows aligned at a device position, or
    None for an int pos_start."""
    t = q.shape[1]
    kw, vw, ks, vs = _kv_for_write(cfg, k, v)
    new = [(cache.k, kw), (cache.v, vw)]
    if cfg.kv_quantized:
        new += [(cache.k_scale, ks), (cache.v_scale, vs)]
    for dst, src in new:
        if window is None:
            # padded prefill tails write junk past the true length: attention
            # masks it, and later writes replace it before any query reads it
            dst[li, :, pos_start : pos_start + t] = src
        elif isinstance(window, torch.Tensor):
            dst[li].index_copy_(1, window, src)
        else:
            _write_rows(dst[li], src, window)
    S = cache.k.shape[2]
    view_len = min(kv_len, S) if kv_len is not None else S
    k_view = cache.k[li, :, :view_len]
    v_view = cache.v[li, :, :view_len]
    if cfg.kv_quantized:
        # the bucketed view dequantized to the compute dtype (flash stays
        # eligible on the bf16 path)
        k_view = dequantize_kv(k_view, cache.k_scale[li, :, :view_len], cfg.dtype)
        v_view = dequantize_kv(v_view, cache.v_scale[li, :, :view_len], cfg.dtype)
    return _attention_auto(cfg, q, k_view, v_view, positions, pos_start)


@dataclass(frozen=True)
class _PagedIndex:
    """Where a forward step writes and reads the page pool
    (runtime/paged_kv.py): the same in every layer, so `_paged_index` builds
    it once per forward."""

    table: torch.Tensor  # [b, max_slots] int32 page tables (-1 = unmapped)
    page_size: int
    write: torch.Tensor  # [b * t] flat pool slots, page * page_size + offset
    pages: torch.Tensor  # [b, n_read] int64 pages read, unmapped -> page 0
    pos_base: torch.Tensor  # [b] int64, each row's first query position


def _paged_index(cfg: ModelConfig, positions: torch.Tensor, table: torch.Tensor,
                 page_size: int, sink: int, kv_len: int | None) -> _PagedIndex:
    """Writes go to (table[row, pos // ps], pos % ps). A write that must not
    land (pos >= seq_len, a slot past the table, an unmapped -1 entry) goes
    to the `sink` page, which no table maps. Reads take the first n_read
    table entries, n_read covering kv_len; an unmapped entry reads page 0,
    which the causal mask discards."""
    ps = page_size
    max_slots = table.shape[1]
    slot = positions // ps
    phys = torch.gather(table, 1, slot.clamp(max=max_slots - 1)).long()
    invalid = (positions >= cfg.seq_len) | (slot >= max_slots) | (phys < 0)
    write = torch.where(invalid, sink, phys) * ps + positions % ps
    n_read = max_slots if kv_len is None else min(-(-kv_len // ps), max_slots)
    return _PagedIndex(
        table=table, page_size=ps, write=write.reshape(-1),
        pages=table[:, :n_read].clamp(min=0).long(), pos_base=positions[:, 0].contiguous(),
    )


def _paged_attention(cfg, q, k, v, positions, pos_start, cache: KVCache, li, ix: _PagedIndex):
    """The paged layout: write this layer's K/V into the pool slots of `ix`
    and attend over its pages. Reads: int8 decode-sized q on the bf16 kernel
    path -> K5 through the table; otherwise gather the pages into a [b,
    n_read * ps, h, d] view, dequantized on the int8 arm."""
    b = q.shape[0]
    kw, vw, ks, vs = _kv_for_write(cfg, k, v)
    new = [(cache.k, kw), (cache.v, vw)]
    if cfg.kv_quantized:
        new += [(cache.k_scale, ks), (cache.v_scale, vs)]
    for dst, src in new:
        layer = dst[li]  # [P, ps, ...], contiguous
        layer.view(-1, *layer.shape[2:]).index_copy_(0, ix.write, src.reshape(-1, *src.shape[2:]))

    ps, n_read = ix.page_size, ix.pages.shape[1]
    if (
        cfg.kv_quantized
        and cfg.dtype == torch.bfloat16
        and paged_attention_eligible(q, cfg.n_kv_heads, ps)
    ):
        return paged_flash_attention(
            q, cache.k, cache.v, cache.k_scale, cache.v_scale, li, ix.pos_base, ix.table,
            n_read, ps,
        )
    k_view = cache.k[li, ix.pages]  # [b, n_read, ps, h, d]
    v_view = cache.v[li, ix.pages]
    if cfg.kv_quantized:
        k_view = dequantize_kv(k_view, cache.k_scale[li, ix.pages], cfg.dtype)
        v_view = dequantize_kv(v_view, cache.v_scale[li, ix.pages], cfg.dtype)
    k_view = k_view.reshape(b, n_read * ps, cfg.n_kv_heads, cfg.head_dim)
    v_view = v_view.reshape(b, n_read * ps, cfg.n_kv_heads, cfg.head_dim)
    return _attention_auto(cfg, q, k_view, v_view, positions, pos_start)


@dataclass(frozen=True)
class SpShards:
    """A sequence-parallel cache (parallel/pipeline.py): shard i's [L, b,
    local_seq, n_kv, hd] slab `caches[i]`, on its own device, holds the
    global positions offsets[i] + [0, local_seq)."""

    caches: tuple  # KVCache per shard
    offsets: tuple  # int per shard


def _sp_attention(cfg, q, k, v, positions, pos_start, sp: SpShards, li, kv_len):
    """The sp branch of the JAX `_layer` (:591-640). Each shard writes the
    rows of this step that land in it (`scatter_cache_update_sp`) and reads
    at most local_kv = min(kv_len, local_seq) rows. That bound is exact: a
    row past it lies past the global bucket (shard 0) or at a global
    position >= kv_len (later shards), in the future either way. Prefill
    chunks on a bf16 cache pass `_attention_auto`'s gate on the shard's
    view (pos_start is always a scalar here) and run B8 on every shard
    (`flash_attention_sp`); the rest run `gqa_attention_sp`.

    Everything outside this function runs once, on the mesh's first
    device, where JAX repeats it on every shard: the same deterministic
    computation, so the same numbers. Here only the cache writes and the
    per-shard attention run on the shards' devices."""
    kw, vw = k.to(cfg.kv_dtype), v.to(cfg.kv_dtype)
    k_views, v_views = [], []
    per_row = isinstance(pos_start, torch.Tensor)
    for cache, off in zip(sp.caches, sp.offsets):
        dev = cache.k.device
        local_seq = cache.k.shape[2]
        if per_row:
            # each row's rows that land in this shard; a parked row's land
            # in none (JAX's drop scatter, ops/attention.py)
            win = _row_window(pos_start.to(dev) - off, local_seq, q.shape[1])
            _write_rows(cache.k[li], kw.to(dev), win)
            _write_rows(cache.v[li], vw.to(dev), win)
        else:
            scatter_cache_update_sp(cache.k, kw.to(dev), pos_start, off, layer=li)
            scatter_cache_update_sp(cache.v, vw.to(dev), pos_start, off, layer=li)
        local_kv = min(kv_len, local_seq) if kv_len is not None else local_seq
        k_views.append(cache.k[li, :, :local_kv])
        v_views.append(cache.v[li, :, :local_kv])
    if (not per_row and k_views[0].dtype == torch.bfloat16
            and flash_attention_aligned(q, k_views[0], q.shape[1])):
        return flash_attention_sp(q, k_views, v_views, pos_start, sp.offsets)
    return gqa_attention_sp(q, k_views, v_views, positions, sp.offsets)


def attention_out(
    cfg: ModelConfig,
    rope: tuple,  # the (cos, sin) rows of `positions` (ops/rope.py rope_rows)
    x: torch.Tensor,  # [b, t, dim] residual stream (f32)
    positions: torch.Tensor,  # [b, t]
    pos_start,  # int (rows aligned) or [b] tensor (per-row positions)
    lp: LayerParams,
    cache,  # KVCache, or SpShards (a sequence-parallel cache)
    li: int,
    kv_len: int | None,
    kv_index,  # _PagedIndex (paged layout), a `_row_window` (contiguous at
    # per-row positions), the [t] slots of rows aligned at a device
    # position, or None (contiguous at an int pos_start)
) -> torch.Tensor:
    """The attention half of a layer up to its output projection: the
    [b, t, dim] term the residual adds. Head counts and widths are the
    config's, which on a mesh is the shard's (parallel/sharding.py
    `shard_config`): a tp shard's term is its partial sum, which the shard
    loop reduces (JAX's `reduce_fn`, transformer.py:645)."""
    b, t, _ = x.shape
    y = rms_norm(x, lp.norm0[li], cfg.norm_epsilon)
    qkv = linear(y, lp.wqkv, cfg.dtype, li, cfg.q80_activations)
    q_dim, kv_dim = cfg.q_dim, cfg.kv_dim
    q = qkv[..., :q_dim].reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = qkv[..., q_dim : q_dim + kv_dim].reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = qkv[..., q_dim + kv_dim :].reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    if cfg.is_qwen3:
        q = rms_norm(q, lp.q_norm[li], cfg.norm_epsilon)
        k = rms_norm(k, lp.k_norm[li], cfg.norm_epsilon)
    q = rotate(q, rope, cfg.rope_type).contiguous()
    k = rotate(k, rope, cfg.rope_type)

    if isinstance(cache, SpShards):
        a = _sp_attention(cfg, q, k, v, positions, pos_start, cache, li, kv_len)
    elif isinstance(kv_index, _PagedIndex):
        a = _paged_attention(cfg, q, k, v, positions, pos_start, cache, li, kv_index)
    else:
        a = _contiguous_attention(cfg, q, k, v, positions, pos_start, cache, li, kv_len,
                                  kv_index)
    return linear(a.reshape(b, t, cfg.q_dim), lp.wo, cfg.dtype, li, cfg.q80_activations)


def ffn_out(cfg: ModelConfig, y: torch.Tensor, lp: LayerParams, li: int, route=None,
            ep=None) -> torch.Tensor:
    """The FFN half of a layer on the normed `y`: the term the residual
    adds (a tp shard's partial; under `ep` an ep shard's, see `_moe_ffn`)."""
    if cfg.is_moe:
        return _moe_ffn(cfg, y, lp, li, route, ep)
    return _dense_ffn(cfg, y, lp, li)


def _layer(cfg, rope, x, positions, pos_start, lp, cache, li, kv_len, kv_index) -> torch.Tensor:
    """One layer on one device (`attention_out`, then `ffn_out`);
    parallel/pipeline.py runs the two halves per shard with the reduces
    between them."""
    x = x + attention_out(cfg, rope, x, positions, pos_start, lp, cache, li, kv_len,
                          kv_index).to(x.dtype)
    y = rms_norm(x, lp.norm1[li], cfg.norm_epsilon)
    return x + ffn_out(cfg, y, lp, li).to(x.dtype)


def forward(
    cfg: ModelConfig,
    params: ModelParams,
    rope: RopeTables,
    cache: KVCache,
    tokens: torch.Tensor,  # [b, t] integer
    pos_start,  # int: position of tokens[:, 0] in every row; a 0-d tensor
    # on the device: the same, known to the device only (the caller keeps
    # it inside the cache); or a [b] tensor on the device: each row's own
    # (per-row sequences, batched decode; a row at seq_len is parked and
    # writes nothing)
    logits_mode: str = "last",  # "last" | "all"
    kv_len: int | None = None,  # attention reads the first kv_len positions
    page_table: torch.Tensor | None = None,  # [b, max_slots] int32 on the
    # device: the paged layout, where `cache` is the page pool
    page_size: int | None = None,  # the paged layout's page length
) -> torch.Tensor:
    """One forward step (prefill chunk or decode token); writes the chunk's
    K/V into `cache` in place. Returns f32 logits: [b, vocab] for "last",
    [b, t, vocab] for "all". With `params` a mesh's (parallel/sharding.py
    MeshParams) and `cache` its MeshKV, the step runs the mesh's shard
    loop (parallel/pipeline.py `pipeline_forward`)."""
    if getattr(params, "mesh", None) is not None:
        # a MeshParams: the shard loop (parallel/pipeline.py), which every
        # entry point above this one reaches through here
        from ..parallel.pipeline import pipeline_forward

        return pipeline_forward(cfg, params.mesh, params, rope, cache, tokens, pos_start,
                                logits_mode, kv_len=kv_len, page_table=page_table,
                                page_size=page_size)
    if logits_mode not in ("last", "all"):
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    if (page_table is None) != (page_size is None):
        raise ValueError("the paged layout needs both page_table and page_size")
    limit = cfg.seq_len if page_table is not None else cache.seq_len
    positions, pos_start = step_positions(tokens, pos_start, limit)
    # the layer-invariant index work, once per forward
    if page_table is not None:
        sink = cache.k.shape[1] - 1
        kv_index = _paged_index(cfg, positions, page_table, page_size, sink, kv_len)
    elif isinstance(pos_start, torch.Tensor) and pos_start.ndim == 1:
        kv_index = _row_window(pos_start, cache.seq_len, tokens.shape[1])
    elif isinstance(pos_start, torch.Tensor):
        kv_index = positions[0]  # the slots every row writes
    else:
        kv_index = None
    return forward_layers(cfg, params, rope, cache, tokens, positions, pos_start, logits_mode,
                          kv_len, kv_index)


def step_positions(tokens: torch.Tensor, pos_start, limit: int) -> tuple:
    """(positions [b, t], pos_start) of one step: pos_start an int, checked
    against the cache's `limit`; a 0-d int64 tensor, the same for every row
    (not checked: the value stays on the device); or a [b] tensor of each
    row's first position (returned as an int64 tensor)."""
    b, t = tokens.shape
    steps = torch.arange(t, device=tokens.device)
    if isinstance(pos_start, torch.Tensor) and pos_start.ndim == 0:
        return (pos_start + steps).expand(b, t), pos_start
    if isinstance(pos_start, torch.Tensor):
        if pos_start.shape != (b,):
            raise ValueError(f"per-row positions must be [{b}], got {tuple(pos_start.shape)}")
        positions = pos_start.long()[:, None] + steps
        return positions, positions[:, 0]
    pos_start = int(pos_start)
    if pos_start < 0 or pos_start + t > limit:
        raise ValueError(
            f"positions {pos_start}..{pos_start + t - 1} do not fit the cache ({limit})"
        )
    return (pos_start + steps).expand(b, t), pos_start


def forward_layers(cfg, params, rope, cache, tokens, positions, pos_start, logits_mode, kv_len,
                   kv_index) -> torch.Tensor:
    """Embedding, every layer and the logits of one step on one device,
    once `forward` has laid out its positions and cache index."""
    x = params.embedding[tokens].to(torch.float32)
    rows = rope_rows(rope, positions)
    for li in range(cfg.n_layers):
        x = _layer(cfg, rows, x, positions, pos_start, params.layers, cache, li, kv_len,
                   kv_index)
    x = rms_norm(x, params.final_norm, cfg.norm_epsilon)
    if logits_mode == "last":
        x = x[:, -1, :].contiguous()
    return linear(x, params.wcls, cfg.dtype, q80=cfg.q80_activations).to(torch.float32)
