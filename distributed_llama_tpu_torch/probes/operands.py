"""The JAX probes' operands, carried across into the port's layouts, so that
the tests run both packages on the same bytes.

The JAX probes (scripts/probe_int4.py, ops/pallas_q40.py:_i8_call) take
x8 [R, in] int8, xs [nb, R*128] f32 (row r's block scales broadcast over
lanes r*128..r*128+127), the weight as qt [nb, 32, out] int8, qt4
[nb, 32, out] `jnp.int4` or qw [nb, 4, out] int32, and dt as
`_dt_operand` gives it (the f16 plane bit-cast to int16; the scale-plane
sweep scripts/sweep_i8_tiles.py also an f32 plane). The port takes xs as
[R, nb], dt as f16 (or f32 as it is), and the 4-bit weight as `pack_s4`'s
bytes. `scale_planes` gives one f16 plane in the three storages of the
sweep: f16, f32 and its raw bits as int16.

P7 (scripts/probe_int4_prod.py) takes the split prologue's operands
(ops/pallas_q40.py:_quantize_rows_q80_split): x8a/x8b [R, nb*16] int8, the
features 0-15 and 16-31 of each block, and xs/bs [nb, R*128] f32 with row
r's scalar at column r*128. K1 takes the int8 row [R, in] whole, xs [R, nb]
f32 and bs [R, nb] int32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .int4 import pack_s4


def _row_scalars(a: np.ndarray, R: int, name: str) -> np.ndarray:
    """[nb, R*128] with row r's scalar at column r*128 -> [R, nb]."""
    if a.ndim != 2 or a.shape[1] != R * 128:
        raise ValueError(f"{name} must be [nb, {R * 128}], got {a.shape}")
    return np.ascontiguousarray(a[:, ::128].T)


def _f16_plane(dt: np.ndarray) -> np.ndarray:
    if dt.dtype == np.int16:
        dt = dt.view(np.float16)
    if dt.dtype != np.float16:
        raise ValueError(f"dt must be an f16 plane or its int16 bits, got {dt.dtype}")
    return np.array(dt)


def _scale_plane(dt: np.ndarray) -> np.ndarray:
    """An f32 plane as it is; an f16 plane or its int16 bits as f16."""
    return np.array(dt) if dt.dtype == np.float32 else _f16_plane(dt)


def scale_planes(dt_f16: torch.Tensor) -> dict:
    """One f16 scale plane in the three storages the scale-plane sweep
    compares: {"f16": B9's own, "f32": the JAX sweep's `dt_f32` (exact),
    "i16": the raw bits, `dt.view(torch.int16)`}, on dt's device."""
    if dt_f16.dtype != torch.float16:
        raise ValueError(f"expected an f16 plane, got {dt_f16.dtype}")
    return {"f16": dt_f16, "f32": dt_f16.to(torch.float32), "i16": dt_f16.view(torch.int16)}


def split_operands_from_jax(x8a, x8b, xs, bs, qp, dt, device=None):
    """P7's operands as numpy arrays from the JAX side -> K1's body's
    tensors (x8 [R, nb*32] int8, xs [R, nb] f32, bs [R, nb] int32, qp
    [nb*4, out] int32, dt [nb, out] f16) on `device` (None: the card)."""
    device = resolve_device(device)
    x8a, x8b, xs, bs, qp = (np.asarray(a) for a in (x8a, x8b, xs, bs, qp))
    if x8a.dtype != np.int8 or x8a.ndim != 2 or x8b.shape != x8a.shape or x8b.dtype != np.int8:
        raise ValueError(f"x8a/x8b must be [R, nb*16] int8, got {x8a.dtype} {x8a.shape} / "
                         f"{x8b.dtype} {x8b.shape}")
    R, half = x8a.shape
    nb = half // 16
    x8 = np.concatenate([x8a.reshape(R, nb, 16), x8b.reshape(R, nb, 16)], axis=2)
    xs_t = _row_scalars(xs, R, "xs").astype(np.float32)
    bs_t = _row_scalars(bs, R, "bs").astype(np.int32)  # small integers, exact in f32
    if qp.dtype != np.int32 or qp.shape[0] != nb * 4:
        raise ValueError(f"qp must be [{nb * 4}, out] int32, got {qp.dtype} {qp.shape}")
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        x8.reshape(R, nb * 32), xs_t, bs_t, qp, _f16_plane(np.asarray(dt))))


def operands_from_jax(x8, xs, w, dt, device=None):
    """(x8, xs, w, dt) as numpy arrays from the JAX side -> the port's
    tensors on `device` (None: the card): x8 as it is; xs [nb, R*128] ->
    [R, nb], column r*128; w: an int4 plane -> `pack_s4`, int8 qt and int32
    qw as they are; dt: an int16 bit plane -> f16 by a view, f16 and f32 as
    they are."""
    device = resolve_device(device)
    x8 = np.asarray(x8)
    xs = np.asarray(xs)
    w = np.asarray(w)
    dt = np.asarray(dt)
    if x8.dtype != np.int8 or x8.ndim != 2:
        raise ValueError(f"x8 must be [R, in] int8, got {x8.dtype} {x8.shape}")
    xs_t = _row_scalars(xs, x8.shape[0], "xs").astype(np.float32)  # [R, nb]
    if w.dtype.name == "int4":
        wt = pack_s4(torch.from_numpy(w.astype(np.int8)))
    elif w.dtype in (np.int8, np.int32):
        wt = torch.from_numpy(np.array(w))
    else:
        raise ValueError(f"unknown weight storage {w.dtype}")
    return tuple(t.to(device) for t in (
        torch.from_numpy(np.array(x8)), torch.from_numpy(xs_t), wt,
        torch.from_numpy(_scale_plane(dt)),
    ))
