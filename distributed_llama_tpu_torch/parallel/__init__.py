"""Parallel layer: topology, the device mesh, the shards and the shard loop.

The counterpart of the JAX package's `parallel/`: `PPxTPTopology`
(topology.py), `make_mesh` (mesh.py), the NamedSharding rules as shards cut
once per mesh cell (sharding.py) and the shard_map pipeline as a loop over
the shards (pipeline.py), for every axis: tp, pp, dp, ep and sp. One
process drives every shard, as JAX's one controller does under
`shard_map`; `torch.distributed` across hosts (`multihost.py`) and the
GSPMD execution arm are not ported (ROADMAP A13b).
"""

from .mesh import AXES, Mesh, make_mesh
from .topology import PPxTPTopology

__all__ = ["AXES", "Mesh", "PPxTPTopology", "make_mesh"]
