"""Device-side quantized weights and the quantized matmul.

Device layout (the packed "T" layout of the JAX package, ops/quant.py there):
a logical [out_features, in_features] Q40 weight is stored transposed,
block-major and nibble-packed:

    q: [in_features // 8, out_features]   int32  (8 weights per word)
    d: [in_features // 32, out_features]  f16    (the file's scale bits)

Within block b, feature s in [0, 16) shares a byte with feature s + 16:

    byte[b, s, o] = (v[b, s, o] + 8) | ((v[b, s + 16, o] + 8) << 4)
    word[b, g, o] = bytes 4g..4g+3 little-endian, rows flattened to [nb*4, out]

`out` is innermost, so one GPU thread per output column reads its words
coalesced. That byte is exactly the file's Q40 byte s of the block, so the
loader regroups the file's bytes into the layout with one transpose
(`q40_bytes_to_t_layout`) instead of unpacking and repacking nibbles.
Hopper loads f16 natively: the scale plane is used as f16, with no int16
bit-cast workaround.

`quant_matmul` keeps the JAX package's dispatch predicates, so the numerics
arm that runs at each shape is the same as there:
  * bf16 compute and <= 8 rows: the Q80 x Q40 integer-dot kernel
    (ops/cuda_q40.py, K1);
  * bf16 compute and more rows: the bf16-dequant GEMM (K2);
  * f32 compute, or a shape the kernels' alignment gates refuse: the plain
    dequant + matmul (the JAX package's XLA arm), with TF32 off.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..formats.quants import Q40_BLOCK_BYTES, Q_BLOCK

HGRP = Q_BLOCK // 2  # features per nibble plane (feature s pairs with s+16)
LANE = 128


@dataclass
class QuantTensor:
    """A Q40 weight on the device in the packed T layout.

    q: [..., in//8, out] int32 nibble-packed words; d: [..., in//32, out] f16.
    """

    q: torch.Tensor
    d: torch.Tensor

    @property
    def out_features(self) -> int:
        return self.q.shape[-1]

    @property
    def in_features(self) -> int:
        return self.q.shape[-2] * 8

    @property
    def shape(self) -> tuple:
        """Logical [..., out_features, in_features] shape."""
        return (*self.q.shape[:-2], self.out_features, self.in_features)


def pack_q(qt: np.ndarray) -> np.ndarray:
    """Host-side nibble pack: [..., nb, 32, out] int8 in [-8, 7] ->
    [..., nb*4, out] int32 feature-split words (module docstring codec)."""
    *lead, nb, _, out = qt.shape
    u = (qt.astype(np.int16) + 8).astype(np.uint32)
    b8 = u[..., :HGRP, :] | (u[..., HGRP:, :] << 4)  # [..., nb, 16, out]
    b4 = b8.reshape(*lead, nb, 4, 4, out)  # [..., b, g, k, o]
    w = (
        b4[..., 0, :]
        | (b4[..., 1, :] << 8)
        | (b4[..., 2, :] << 16)
        | (b4[..., 3, :] << 24)
    )
    return w.reshape(*lead, nb * 4, out).astype(np.uint32).view(np.int32)


def unpack_q(qp: torch.Tensor) -> torch.Tensor:
    """[..., nb*4, out] int32 packed words -> [..., nb, 32, out] int8 values
    in [-8, 7]: the plain dequant path and the tests."""
    *lead, rows, out = qp.shape
    nb = rows // 4
    planes = [((qp >> (4 * j)) & 0xF).to(torch.int8) - 8 for j in range(8)]
    # plane j holds feature 16*(j%2) + 4*g + j//2 of word row (b*4+g)
    pj = torch.stack(planes, dim=-3)  # [..., 8(j), nb*4, out]
    pj = pj.reshape(*lead, 4, 2, nb, 4, out)  # [..., k, h, b, g, o]
    n = len(lead)
    v = pj.permute(*range(n), n + 2, n + 1, n + 3, n, n + 4)  # [..., b, h, g, k, o]
    return v.reshape(*lead, nb, Q_BLOCK, out)


def q40_to_t_layout(q: np.ndarray, d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side transform from the file layout ([out, in//32, 32] values +
    [out, in//32] f16 scales, `unpack_q40`) to the packed T layout."""
    qt = np.ascontiguousarray(np.transpose(q, (1, 2, 0)))
    dt = np.ascontiguousarray(np.transpose(d, (1, 0))).astype(np.float16)
    return pack_q(qt), dt


def q40_bytes_to_t_layout(
    raw: torch.Tensor, out_features: int, in_features: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """A Q40 tensor's file bytes (uint8, on any device) -> (q, d) in the
    packed T layout on that device. Each 18-byte block is an f16 scale and
    16 nibble bytes; nibble byte s already is byte s of the T layout's
    block (module docstring), so this is a regroup and one transpose.
    `raw` [..., nbytes] may hold several same-shape tensors (a layer's
    experts); q and d then keep its leading axes."""
    nb = in_features // Q_BLOCK
    lead = raw.shape[:-1]
    blocks = raw.reshape(-1, out_features, nb, Q40_BLOCK_BYTES)
    words = blocks[..., 2:].contiguous().view(torch.int32)  # [n, out, nb, 4]
    q = words.permute(0, 2, 3, 1).reshape(*lead, nb * 4, out_features).contiguous()
    scales = blocks[..., :2].contiguous().view(torch.float16)  # [n, out, nb, 1]
    d = scales.reshape(-1, out_features, nb).transpose(1, 2).reshape(*lead, nb, out_features)
    return q, d.contiguous()


def slice_layer(w, layer: int):
    """w[layer] of a stacked weight, dense or QuantTensor (views, no copy)."""
    if isinstance(w, QuantTensor):
        return QuantTensor(q=w.q[layer], d=w.d[layer])
    return w[layer]


def dequantize_t(w: QuantTensor, dtype=torch.float32) -> torch.Tensor:
    """The [..., in_features, out_features] matmul-ready matrix: value =
    q * d with the scale multiply in f32, one cast at the end."""
    qv = unpack_q(w.q)
    x = (qv.to(torch.float32) * w.d.to(torch.float32).unsqueeze(-2)).to(dtype)
    return x.reshape(*w.q.shape[:-2], w.in_features, w.out_features)


def _quant_matmul_xla(x: torch.Tensor, q: torch.Tensor, d: torch.Tensor, dtype) -> torch.Tensor:
    """The JAX package's XLA arm (`_quant_matmul_xla`): dequantize with an
    f32 scale multiply, cast the operands to `dtype`, accumulate in f32.
    Operands go to f32 before the product (bf16 values are exact there) and
    TF32 stays off, so every product is exact and only the order of the f32
    sum differs from XLA's."""
    w = dequantize_t(QuantTensor(q=q, d=d), dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(dtype).to(torch.float32)
    out = _f32_matmul(x2, w.to(torch.float32))
    return out.reshape(*lead, w.shape[-1])


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return a @ b


def q40_matmul_aligned(x: torch.Tensor, w: QuantTensor) -> bool:
    """The unstacked kernels take a 2D packed weight with lane-aligned
    out_features and a matching x (the JAX package's gate)."""
    return w.q.ndim == 2 and w.out_features % LANE == 0 and x.shape[-1] == w.in_features


def q40_stacked_aligned(in_features: int, out_features: int) -> bool:
    """The stacked kernels' gate in the JAX package: lane-aligned
    out_features and nb % 8 == 0. Kept so that the same shapes take the same
    numerics arm on both sides."""
    return out_features % LANE == 0 and (in_features // Q_BLOCK) % 8 == 0


def quant_matmul(
    x: torch.Tensor,
    w: QuantTensor,
    dtype=torch.bfloat16,
    out_dtype=None,
    layer: int | None = None,
) -> torch.Tensor:
    """``x @ w.T`` (logical): x [..., in_features] -> [..., out_features].

    `w` is an unstacked (2D q) QuantTensor, or with `layer` given an
    all-layers stack (3D q): the kernels then offset their base pointers to
    ``w[layer]`` without a slice copy. Returns `out_dtype` (default x.dtype).
    """
    from .cuda_q40 import (
        q40_gemm_bf16,
        q40_gemm_bf16_stacked,
        q40_gemv_q80,
        q40_gemv_q80_stacked,
    )

    rows = 1
    for s in x.shape[:-1]:
        rows *= s
    # the JAX package hands bf16 matmuls to its kernels and keeps f32 on the
    # exact XLA arm; the i8 kernel takes decode-sized row counts
    kernels = dtype == torch.bfloat16
    use_i8 = kernels and rows <= 8
    od = out_dtype if out_dtype is not None else x.dtype
    if layer is not None and w.q.ndim == 3:
        aligned = x.shape[-1] == w.in_features and q40_stacked_aligned(
            w.in_features, w.out_features
        )
        if kernels and aligned:
            fn = q40_gemv_q80_stacked if use_i8 else q40_gemm_bf16_stacked
            out = fn(x.contiguous(), w.q, w.d, layer)
        else:
            out = _quant_matmul_xla(x, w.q[layer], w.d[layer], dtype)
        return out.to(od)
    if w.q.ndim != 2:
        raise ValueError("quant_matmul: a stacked weight needs a layer index")
    if kernels and q40_matmul_aligned(x, w):
        out = (q40_gemv_q80 if use_i8 else q40_gemm_bf16)(x.contiguous(), w.q, w.d)
    else:
        out = _quant_matmul_xla(x, w.q, w.d, dtype)
    return out.to(od)


def quantize_q80_activations(x: torch.Tensor) -> torch.Tensor:
    """Round-trip x through Q80 (per-32-block int8 and an f16 scale): the
    JAX package's `quantize_q80_activations` (ops/quant.py:304), which
    emulates the reference's `--buffer-float-type q80` activations
    (quantizeF32toQ80, src/nn/nn-quants.cpp:67-) for parity runs. The int8
    values are taken against the unrounded f32 scale and dequantized with
    the f16-rounded one, as the host codec (formats/quants.py) does.
    Plain torch ops: XLA glue in JAX too."""
    shape = x.shape
    xf = x.to(torch.float32).reshape(*shape[:-1], shape[-1] // Q_BLOCK, Q_BLOCK)
    delta = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    inv = torch.where(delta != 0, 1.0 / delta, torch.zeros_like(delta))
    qv = torch.clamp(torch.round(xf * inv), -127, 127)
    delta16 = delta.to(torch.float16).to(torch.float32)
    return (qv * delta16).reshape(shape).to(x.dtype)
