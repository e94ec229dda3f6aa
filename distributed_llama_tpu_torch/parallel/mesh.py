"""Device mesh construction.

The counterpart of the JAX package's `parallel/mesh.py:make_mesh` (:22-41):
the same five axes in the same order and the same arguments, over torch
devices instead of `jax.devices()`. A mesh here is a small record, the axis
extents and the devices its shards run on; one process drives all of them.

Only the sequence-parallel axis is ported: any other axis above 1 raises
NotImplementedError (ROADMAP A13). An explicit device list may name one
device more than once, so that several shards share one card (or the CPU,
as the tests' shards share the host CPU through JAX's forced host devices).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device

AXES = ("dp", "pp", "ep", "tp", "sp")


@dataclass(frozen=True, eq=False)
class Mesh:
    """Axis extents (`shape`, a dict over AXES, as JAX's `Mesh.shape`) and
    the devices of the sp shards, shard i on `devices[i]`. Replicated work
    runs on `devices[0]`."""

    shape: dict
    devices: tuple

    @property
    def sp(self) -> int:
        return self.shape["sp"]


def make_mesh(
    tp: int = 1, pp: int = 1, dp: int = 1, sp: int = 1, ep: int = 1, devices=None
) -> Mesh:
    """A ("dp", "pp", "ep", "tp", "sp") mesh over the first dp*pp*ep*tp*sp
    devices: the visible cards when `devices` is None (none visible: the
    mesh needs more than it has, and raises), else the given list, in
    which a device may repeat."""
    shape = dict(zip(AXES, (dp, pp, ep, tp, sp)))
    if any(v < 1 for v in shape.values()):
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    other = {k: v for k, v in shape.items() if k != "sp" and v > 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other} are not ported: only sp runs (ROADMAP A13)"
        )
    n = dp * pp * ep * tp * sp
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    return Mesh(shape=shape, devices=tuple(_indexed(resolve_device(d)) for d in devices[:n]))


def _indexed(dev: torch.device) -> torch.device:
    """`cuda` as the card it means (`cuda:0`), as a tensor's `.device`
    names it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
