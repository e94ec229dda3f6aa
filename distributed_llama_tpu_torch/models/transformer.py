"""The transformer forward pass (Llama, Qwen3 and Qwen3-MoE).

The counterpart of the JAX package's `models/transformer.py`: its `linear`
(:39), `_dense_ffn` (:79), the MoE block (`_gather_expert` :93,
`_expert_matmul` :105, `_n_local_experts` :179, `_moe_ffn` :186,
`_moe_decode_i8` :270, single device), `_attention_auto` (:135), the
stacked, contiguous-cache branch of `_layer` (:310, :495-558, scalar
pos_start) and `forward_uncompiled` (:660). PyTorch runs eagerly, so the
scan over layers is a Python loop and each matmul selects its layer inside
the kernel.

Math per layer (reference att segment src/llm.cpp:278-418, ff segment
src/llm.cpp:421-569):

    y  = rms_norm(x, norm0);  q|k|v = y @ Wqkv
    [qwen3: per-head rms_norm of q, k]
    q, k = rope(q, k); cache[layer, :, pos:pos+t] = k, v   (in place)
    a  = attention(q, cache[layer, :, :kv_len]);  x += a @ Wo
    y  = rms_norm(x, norm1)
    dense: x += (silu(y @ W1) * (y @ W3)) @ W2
    moe:   route y to its top-k experts; x += the weighted sum of their SwiGLUs

Dtype boundaries are the JAX package's: the residual stream is f32, matmul
operands are the compute dtype (bf16 on the fast path), `linear` returns its
input's dtype, and the cache is written in the cache dtype.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import torch

from ..formats.mfile import HiddenAct
from ..ops.activations import gelu, silu
from ..ops.attention import gqa_attention
from ..ops.cuda_attention import flash_attention, flash_attention_aligned
from ..ops.cuda_q40 import q40_gemv_q80_indexed
from ..ops.moe import moe_ffn_ragged, moe_router
from ..ops.norm import rms_norm
from ..ops.quant import (
    QuantTensor, _f32_matmul, dequantize_t, q40_stacked_aligned, quant_matmul, slice_layer,
)
from ..ops.rope import RopeTables, apply_rope
from .config import ModelConfig
from .params import KVCache, LayerParams, ModelParams


def linear(x: torch.Tensor, w: Any, dtype, layer: int | None = None) -> torch.Tensor:
    """x @ w.T for a dense or Q40 weight; returns x.dtype. `layer`: use
    w[layer] of an all-layers stacked weight."""
    if isinstance(w, QuantTensor):
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
    h13 = linear(y, lp.w13, cfg.dtype, layer)
    ff = h13.shape[-1] // 2
    h = _activation(cfg, h13[..., :ff]) * h13[..., ff:]
    return linear(h, lp.w2, cfg.dtype, layer)


def _gather_expert(w: Any, idx: torch.Tensor) -> Any:
    """Per-token expert weights: w [E, ...] (one layer's stack) gathered by
    idx [b, t, k]."""
    sel = idx.long()
    if isinstance(w, QuantTensor):
        return QuantTensor(q=w.q[sel], d=w.d[sel])
    return w[sel]


def _expert_matmul(x: torch.Tensor, w: Any, dtype) -> torch.Tensor:
    """x [b, t, k, in] against per-token gathered experts (a QuantTensor in
    the T layout, or dense [..., out, in]) -> [b, t, k, out] in x.dtype. The
    operands take `dtype`, the products are exact in f32 and TF32 stays
    off."""
    if isinstance(w, QuantTensor):
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
        and q40_stacked_aligned(lp.w1.in_features, lp.w1.out_features)
        and q40_stacked_aligned(lp.w2.in_features, lp.w2.out_features)
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
    out = (o * wts.reshape(k, 1).to(torch.float32)).sum(dim=0)  # the slots, in f32
    return out.reshape(*y.shape[:2], cfg.dim)


def _moe_ffn(cfg: ModelConfig, y: torch.Tensor, lp: LayerParams, layer: int) -> torch.Tensor:
    """Top-k expert SwiGLU (reference src/llm.cpp:440-514): the router on
    the normed activation, then the JAX package's choice of arm by the
    static row count rows = b * t * k:
      * rows >= E (prefill chunks): moe_ffn_ragged, the grouped kernel K4
        over every hit expert once;
      * one token on the bf16 kernel path: _moe_decode_i8 (K1-indexed);
      * otherwise (prefill tails of a few tokens, the f32 arm): gather each
        row's experts and dequantize them (plain torch; XLA in JAX)."""
    idx, wts = moe_router(y, lp.moe_gate[layer], cfg.n_active_experts)  # [b, t, k]
    rows = y.shape[0] * y.shape[1] * cfg.n_active_experts
    act = partial(_activation, cfg)
    if rows >= cfg.n_experts:
        return moe_ffn_ragged(y, idx, wts, lp.w1, lp.w3, lp.w2, act, cfg.dtype, layer=layer)
    if _moe_decode_i8_eligible(cfg, y, lp):
        out = _moe_decode_i8(cfg, y, lp, layer, idx, wts)
    else:
        w1 = _gather_expert(slice_layer(lp.w1, layer), idx)
        w3 = _gather_expert(slice_layer(lp.w3, layer), idx)
        w2 = _gather_expert(slice_layer(lp.w2, layer), idx)
        xk = y[:, :, None, :].expand(*y.shape[:2], cfg.n_active_experts, y.shape[-1])
        h = act(_expert_matmul(xk, w1, cfg.dtype)) * _expert_matmul(xk, w3, cfg.dtype)
        out = _expert_matmul(h, w2, cfg.dtype)  # [b, t, k, dim]
        out = (out.to(torch.float32) * wts.unsqueeze(-1)).sum(dim=2)
    return out.to(y.dtype)


def _attention_auto(cfg, q, k_view, v_view, positions, pos_start: int):
    """Prefill-sized q on a bf16 cache -> the flash kernel (K3); otherwise
    (decode t = 1, the f32 parity path, unaligned shapes) the plain
    whole-cache attention, whose reads the engine bounds with kv_len."""
    t = q.shape[1]
    if k_view.dtype == torch.bfloat16 and flash_attention_aligned(q, k_view, t):
        return flash_attention(q, k_view, v_view, pos_start)
    return gqa_attention(q, k_view, v_view, positions)


def _layer(
    cfg: ModelConfig,
    rope: RopeTables,
    x: torch.Tensor,  # [b, t, dim] residual stream (f32)
    positions: torch.Tensor,  # [b, t]
    pos_start: int,  # cache write offset
    lp: LayerParams,
    cache: KVCache,
    li: int,
    kv_len: int | None,
) -> torch.Tensor:
    b, t, _ = x.shape
    y = rms_norm(x, lp.norm0[li], cfg.norm_epsilon)
    qkv = linear(y, lp.wqkv, cfg.dtype, li)
    q_dim, kv_dim = cfg.q_dim, cfg.kv_dim
    q = qkv[..., :q_dim].reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = qkv[..., q_dim : q_dim + kv_dim].reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = qkv[..., q_dim + kv_dim :].reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    if cfg.is_qwen3:
        q = rms_norm(q, lp.q_norm[li], cfg.norm_epsilon)
        k = rms_norm(k, lp.k_norm[li], cfg.norm_epsilon)
    q = apply_rope(q, rope, positions, cfg.rope_type).contiguous()
    k = apply_rope(k, rope, positions, cfg.rope_type)

    # in-place write of this layer's rows (the JAX package's donated
    # dynamic_update_slice). Padded prefill tails write junk past the true
    # length: attention masks it, and later writes replace it before any
    # query at that position reads it.
    S = cache.k.shape[2]
    cache.k[li, :, pos_start : pos_start + t] = k.to(cache.k.dtype)
    cache.v[li, :, pos_start : pos_start + t] = v.to(cache.v.dtype)
    view_len = min(kv_len, S) if kv_len is not None else S
    k_view = cache.k[li, :, :view_len]
    v_view = cache.v[li, :, :view_len]
    a = _attention_auto(cfg, q, k_view, v_view, positions, pos_start)
    att_out = linear(a.reshape(b, t, cfg.q_dim), lp.wo, cfg.dtype, li)
    x = x + att_out.to(x.dtype)

    y = rms_norm(x, lp.norm1[li], cfg.norm_epsilon)
    ff = _moe_ffn(cfg, y, lp, li) if cfg.is_moe else _dense_ffn(cfg, y, lp, li)
    x = x + ff.to(x.dtype)
    return x


def forward(
    cfg: ModelConfig,
    params: ModelParams,
    rope: RopeTables,
    cache: KVCache,
    tokens: torch.Tensor,  # [b, t] integer
    pos_start: int,  # absolute position of tokens[:, 0], all rows aligned
    logits_mode: str = "last",  # "last" | "all"
    kv_len: int | None = None,  # attention reads cache[:, :kv_len]
) -> torch.Tensor:
    """One forward step (prefill chunk or decode token); writes the chunk's
    K/V into `cache` in place. Returns f32 logits: [b, vocab] for "last",
    [b, t, vocab] for "all"."""
    if logits_mode not in ("last", "all"):
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    b, t = tokens.shape
    pos_start = int(pos_start)
    if pos_start < 0 or pos_start + t > cache.seq_len:
        raise ValueError(
            f"positions {pos_start}..{pos_start + t - 1} do not fit the cache "
            f"({cache.seq_len})"
        )
    positions = (pos_start + torch.arange(t, device=tokens.device)).expand(b, t)
    x = params.embedding[tokens].to(torch.float32)
    for li in range(cfg.n_layers):
        x = _layer(cfg, rope, x, positions, pos_start, params.layers, cache, li, kv_len)
    x = rms_norm(x, params.final_norm, cfg.norm_epsilon)
    if logits_mode == "last":
        x = x[:, -1, :].contiguous()
    return linear(x, params.wcls, cfg.dtype).to(torch.float32)
