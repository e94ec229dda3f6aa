"""The transformer forward pass (dense Llama and Qwen3).

The counterpart of the JAX package's `models/transformer.py`: its `linear`
(:39), `_dense_ffn` (:79), `_attention_auto` (:135), the dense, stacked,
contiguous-cache branch of `_layer` (:310, :495-558, scalar pos_start) and
`forward_uncompiled` (:660). PyTorch runs eagerly, so the scan over layers is
a Python loop and each matmul selects its layer inside the kernel.

Math per layer (reference att segment src/llm.cpp:278-418, ff segment
src/llm.cpp:421-569):

    y  = rms_norm(x, norm0);  q|k|v = y @ Wqkv
    [qwen3: per-head rms_norm of q, k]
    q, k = rope(q, k); cache[layer, :, pos:pos+t] = k, v   (in place)
    a  = attention(q, cache[layer, :, :kv_len]);  x += a @ Wo
    y  = rms_norm(x, norm1);  x += (silu(y @ W1) * (y @ W3)) @ W2

Dtype boundaries are the JAX package's: the residual stream is f32, matmul
operands are the compute dtype (bf16 on the fast path), `linear` returns its
input's dtype, and the cache is written in the cache dtype.
"""

from __future__ import annotations

from typing import Any

import torch

from ..formats.mfile import HiddenAct
from ..ops.activations import gelu, silu
from ..ops.attention import gqa_attention
from ..ops.cuda_attention import flash_attention, flash_attention_aligned
from ..ops.norm import rms_norm
from ..ops.quant import QuantTensor, _f32_matmul, quant_matmul
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
    x = x + _dense_ffn(cfg, y, lp, li).to(x.dtype)
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
    if cfg.is_moe:
        raise NotImplementedError("MoE models are not ported yet (ROADMAP A7)")
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
