"""The JAX probes' operands, carried across into the port's layouts, so that
the tests run both packages on the same bytes.

The JAX probes (scripts/probe_int4.py, ops/pallas_q40.py:_i8_call) take
x8 [R, in] int8, xs [nb, R*128] f32 (row r's block scales broadcast over
lanes r*128..r*128+127), the weight as qt [nb, 32, out] int8, qt4
[nb, 32, out] `jnp.int4` or qw [nb, 4, out] int32, and dt as
`_dt_operand` gives it (the f16 plane bit-cast to int16). The port takes
xs as [R, nb], dt as f16, and the 4-bit weight as `pack_s4`'s bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .int4 import pack_s4


def operands_from_jax(x8, xs, w, dt, device=None):
    """(x8, xs, w, dt) as numpy arrays from the JAX side -> the port's
    tensors on `device` (None: the card): x8 as it is; xs [nb, R*128] ->
    [R, nb], column r*128; w: an int4 plane -> `pack_s4`, int8 qt and int32
    qw as they are; dt: an int16 bit plane -> f16 by a view, f16 as it is."""
    device = resolve_device(device)
    x8 = np.asarray(x8)
    xs = np.asarray(xs)
    w = np.asarray(w)
    dt = np.asarray(dt)
    if x8.dtype != np.int8 or x8.ndim != 2:
        raise ValueError(f"x8 must be [R, in] int8, got {x8.dtype} {x8.shape}")
    R = x8.shape[0]
    if xs.ndim != 2 or xs.shape[1] != R * 128:
        raise ValueError(f"xs must be [nb, {R * 128}], got {xs.shape}")
    xs_t = np.ascontiguousarray(xs[:, ::128].T.astype(np.float32))  # [R, nb]
    if w.dtype.name == "int4":
        wt = pack_s4(torch.from_numpy(w.astype(np.int8)))
    elif w.dtype in (np.int8, np.int32):
        wt = torch.from_numpy(np.array(w))
    else:
        raise ValueError(f"unknown weight storage {w.dtype}")
    if dt.dtype == np.int16:
        dt = dt.view(np.float16)
    if dt.dtype != np.float16:
        raise ValueError(f"dt must be an f16 plane or its int16 bits, got {dt.dtype}")
    return tuple(t.to(device) for t in (
        torch.from_numpy(np.array(x8)), torch.from_numpy(xs_t), wt, torch.from_numpy(np.array(dt)),
    ))
