"""Device mesh construction.

The counterpart of the JAX package's `parallel/mesh.py:make_mesh` (:22-41):
the same five axes in the same order and the same arguments, over torch
devices instead of `jax.devices()`. A mesh here is a small record, the axis
extents and a [dp, pp, ep, tp, sp] grid of the devices its shards run on
(JAX's `Mesh.devices` array in JAX's order); one process drives all of them
(parallel/pipeline.py). A device may appear more than once in the grid, so
that several shards share one card (or the CPU, as the tests' shards share
the host CPU through JAX's forced host devices).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device

AXES = ("dp", "pp", "ep", "tp", "sp")


@dataclass(frozen=True, eq=False)
class Mesh:
    """Axis extents (`shape`, a dict over AXES, as JAX's `Mesh.shape`) and
    `grid`, an object array [dp, pp, ep, tp, sp] of torch devices: the
    shard at mesh coordinate (d, p, e, t, s) runs on grid[d, p, e, t, s]."""

    shape: dict
    grid: np.ndarray

    @property
    def devices(self) -> tuple:
        """Every shard's device, in the grid's (row-major) order: on an
        sp-only mesh, shard i's on `devices[i]`."""
        return tuple(self.grid.reshape(-1))

    @property
    def first(self) -> torch.device:
        """Where a step's tokens arrive and its logits leave."""
        return self.grid.reshape(-1)[0]

    @property
    def size(self) -> int:
        return self.grid.size

    dp = property(lambda self: self.shape["dp"])
    pp = property(lambda self: self.shape["pp"])
    ep = property(lambda self: self.shape["ep"])
    tp = property(lambda self: self.shape["tp"])
    sp = property(lambda self: self.shape["sp"])


def make_mesh(
    tp: int = 1, pp: int = 1, dp: int = 1, sp: int = 1, ep: int = 1, devices=None
) -> Mesh:
    """A ("dp", "pp", "ep", "tp", "sp") mesh over the first dp*pp*ep*tp*sp
    devices, laid out as JAX lays them (ep, tp and sp innermost): the
    visible cards when `devices` is None (none visible: the mesh needs more
    than it has, and raises), else the given list, in which a device may
    repeat."""
    shape = dict(zip(AXES, (dp, pp, ep, tp, sp)))
    if any(v < 1 for v in shape.values()):
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    n = dp * pp * ep * tp * sp
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i] = _indexed(resolve_device(d))
    return Mesh(shape=shape, grid=grid.reshape(dp, pp, ep, tp, sp))


def _indexed(dev: torch.device) -> torch.device:
    """`cuda` as the card it means (`cuda:0`), as a tensor's `.device`
    names it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
