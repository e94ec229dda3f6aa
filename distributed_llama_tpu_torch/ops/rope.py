"""Rotary position embeddings.

Two pairing conventions, matching the reference and the JAX package:

* **Llama style** (reference: ropeLlama_F32, src/nn/nn-cpu-ops.cpp:843-866):
  rotates interleaved pairs ``(x[2j], x[2j+1])`` within each head (the
  converter permutes HF q/k weights so this layout is right).
* **Falcon/NeoX style** (reference: ropeFalcon_F32, used by Qwen3): rotates
  half-split pairs ``(x[j], x[j+headDim/2])``.

Frequencies are ``theta^(-2j/headDim)``, optionally passed through the
Llama-3.1 wavelength-dependent scaling (reference: scaleFrequencyLlama3,
src/nn/nn-core.cpp:328-342). Tables are precomputed on the host in f64 and
cast to f32 once, for the header's `seq_len` — which `MFileReader` has
already capped at the caller's `max_seq_len` (a Llama-3.2 header says
131072).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..formats.mfile import ModelHeader, RopeType


@dataclass(frozen=True)
class RopeTables:
    """cos/sin lookup tables, shape [seq_len, head_dim // 2] (f32)."""

    cos: torch.Tensor
    sin: torch.Tensor


def _scale_frequency_llama3(
    freq: float,
    scaling_factor: float,
    low_freq_factor: float,
    high_freq_factor: float,
    orig_max_seq_len: int,
) -> float:
    wave_len = 2.0 * math.pi / freq
    high_freq_wavelen = orig_max_seq_len / high_freq_factor
    if wave_len < high_freq_wavelen:
        return freq
    low_freq_wavelen = orig_max_seq_len / low_freq_factor
    if wave_len > low_freq_wavelen:
        return freq / scaling_factor
    smooth = (orig_max_seq_len / wave_len - low_freq_factor) / (high_freq_factor - low_freq_factor)
    return (1 - smooth) * freq / scaling_factor + smooth * freq


def build_rope_tables(h: ModelHeader, device=None) -> RopeTables:
    """Precompute per-position cos/sin for all pair indices of one head, on
    `device` (None: the card)."""
    device = resolve_device(device)
    half = h.head_dim // 2
    freqs = np.empty(half, dtype=np.float64)
    # scaling is gated on the factor alone, as in the reference
    # (applyScaling = ropeScalingFactor != 1.0f, src/nn/nn-core.cpp:346)
    apply_scaling = h.rope_scaling_factor != 1.0
    for j in range(half):
        f = 1.0 / (h.rope_theta ** (2.0 * j / h.head_dim))
        if apply_scaling:
            f = _scale_frequency_llama3(
                f,
                h.rope_scaling_factor,
                h.rope_scaling_low_freq_factor,
                h.rope_scaling_high_freq_factor,
                h.rope_scaling_orig_max_seq_len,
            )
        freqs[j] = f
    pos = np.arange(h.seq_len, dtype=np.float64)[:, None]
    angles = (pos * freqs[None, :]).astype(np.float32)
    return RopeTables(
        cos=torch.from_numpy(np.cos(angles)).to(device),
        sin=torch.from_numpy(np.sin(angles)).to(device),
    )


def rope_rows(tables: RopeTables, positions: torch.Tensor) -> tuple:
    """The (cos, sin) rows of `positions`, each [..., seq, 1, half]: the
    forward pass gathers them once and every layer rotates q and k with
    them. A parked row's positions reach seq_len, past the tables: JAX's
    gather clamps such an index, torch's indexing would raise (CPU) or trap
    (device), so the index is clamped here, on the device, with no host
    sync. The clamped rows rotate junk whose cache writes the forward pass
    drops."""
    p = positions.clamp(0, tables.cos.shape[0] - 1)
    return tables.cos[p].unsqueeze(-2), tables.sin[p].unsqueeze(-2)


def rotate(x: torch.Tensor, rows: tuple, rope_type: int) -> torch.Tensor:
    """Rotate x [..., seq, n_heads, head_dim] by `rope_rows` output:
    interleaved pairs (Llama) or half-split pairs (Falcon/NeoX, Qwen3)."""
    cos, sin = rows
    if rope_type in (RopeType.LLAMA, RopeType.LLAMA3_1):
        x0 = x[..., 0::2]
        x1 = x[..., 1::2]
        r0 = x0 * cos - x1 * sin
        r1 = x0 * sin + x1 * cos
        return torch.stack([r0, r1], dim=-1).reshape(x.shape).to(x.dtype)
    if rope_type == RopeType.FALCON:
        half = x.shape[-1] // 2
        x0 = x[..., :half]
        x1 = x[..., half:]
        r0 = x0 * cos - x1 * sin
        r1 = x0 * sin + x1 * cos
        return torch.cat([r0, r1], dim=-1).to(x.dtype)
    raise ValueError(f"unsupported rope type {rope_type}")


def apply_rope(x: torch.Tensor, tables: RopeTables, positions: torch.Tensor, rope_type: int) -> torch.Tensor:
    """Rotate x [..., seq, n_heads, head_dim] at positions [..., seq]."""
    return rotate(x, rope_rows(tables, positions), rope_type)
