"""Parallel layer: the device mesh and the sequence-parallel forward.

The counterpart of the JAX package's `parallel/`, for the `sp` axis alone:
`make_mesh` (mesh.py) and the pp = 1 sequence-parallel steps of
`pipeline.py`. One process drives every shard of the mesh, as JAX's one
controller does under `shard_map`; the other axes (tp, pp, dp, ep) and
`torch.distributed` across hosts are not ported (ROADMAP A13).
"""

from .mesh import AXES, Mesh, make_mesh

__all__ = ["AXES", "Mesh", "make_mesh"]
