"""Symmetric per-(token, head) int8 quantization for the KV cache.

The counterpart of the JAX package's `ops/kv_quant.py` (`quantize_kv` :36,
`dequantize_kv` :48, `KV_SCALE_FLOOR` :33), with the same arithmetic so that
the int8 payload and the f32 scales are bit-equal to JAX's:

* one f32 scale per (token, kv-head) vector of `head_dim` elements: every
  write is self-contained, which the paged layout's partial-page writes and
  the parked rows' dropped writes rely on;
* scale = max(|x|) / 127 over the trailing axis, floored at KV_SCALE_FLOOR,
  so an all-zero vector round trips to exact zeros;
* q = clip(round_half_even(x / scale), -127, 127): a true division, not a
  reciprocal multiply, which would round differently;
* re-quantizing a dequantized vector reproduces the same payload.
"""

from __future__ import annotations

import torch

#: floor for the per-vector scale: keeps zero vectors exact and the dequant
#: multiply finite
KV_SCALE_FLOOR = 1e-30


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float[..., head_dim] -> (int8[..., head_dim], f32 scale[...])."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=KV_SCALE_FLOOR)
    q = torch.clamp(torch.round(xf / scale.unsqueeze(-1)), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """int8[..., head_dim] + f32 scale[...] -> dtype[..., head_dim]."""
    return (q.to(torch.float32) * scale.unsqueeze(-1)).to(dtype)
