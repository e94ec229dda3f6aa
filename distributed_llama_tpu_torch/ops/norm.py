"""RMS normalization (reference: src/nn/nn-cpu-ops.cpp:114-175).

The reduction is always done in f32 regardless of the input dtype, as in the
JAX package's `ops/norm.py`.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """``w * x / rms(x)`` along the last axis; returns x.dtype.

    x: [..., dim]; weight: [dim] (or broadcastable after the normalization —
    qwen3's per-head q/k norms pass [head_dim]).
    """
    xf = x.to(torch.float32)
    inv_rms = torch.reciprocal(torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps))
    return (weight.to(torch.float32) * (xf * inv_rms)).to(x.dtype)
