"""Activation functions (reference: src/nn/nn-cpu-ops.cpp OP_SILU / OP_GELU)."""

from __future__ import annotations

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # tanh approximation, matching the reference's geluForward
    return torch.nn.functional.gelu(x, approximate="tanh")
