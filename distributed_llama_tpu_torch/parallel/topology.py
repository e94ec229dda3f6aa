"""PPxTP topology bookkeeping.

Pure-math mirror of the reference's `NnParallelTopology`
(reference: src/nn/nn-topology.hpp:15-55): global rank = ppRank * tpSize +
tpRank (row-major placement), TP group = the contiguous rank range of one
pipeline stage. On TPU "rank" is a mesh coordinate, but the mapping is kept
(and unit-tested) for parity with the reference's placement semantics and for
mapping reference-style CLI arguments onto mesh axes.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PPxTPTopology:
    n_nodes: int
    pp_size: int

    def __post_init__(self):
        if self.pp_size < 1:
            raise ValueError("ppSize must be >= 1")
        if self.n_nodes < 1:
            raise ValueError("nNodes must be >= 1")
        if self.n_nodes % self.pp_size != 0:
            raise ValueError(
                f"nNodes ({self.n_nodes}) must be divisible by ppSize ({self.pp_size})"
            )

    @property
    def tp_size(self) -> int:
        return self.n_nodes // self.pp_size

    def pp_rank(self, rank: int) -> int:
        self._check(rank)
        return rank // self.tp_size

    def tp_rank(self, rank: int) -> int:
        self._check(rank)
        return rank % self.tp_size

    def rank(self, pp_rank: int, tp_rank: int) -> int:
        if not (0 <= pp_rank < self.pp_size and 0 <= tp_rank < self.tp_size):
            raise ValueError("pp/tp rank out of range")
        return pp_rank * self.tp_size + tp_rank

    def tp_group(self, rank: int) -> tuple[int, int]:
        """[start, end) rank range of this rank's TP group."""
        start = self.pp_rank(rank) * self.tp_size
        return start, start + self.tp_size

    def layer_range(self, pp_rank: int, n_layers: int) -> tuple[int, int]:
        """Contiguous layer range of a stage (reference: src/llm.cpp:210-216):
        floor split, the last stage absorbs the remainder."""
        per_stage = n_layers // self.pp_size
        start = pp_rank * per_stage
        end = n_layers if pp_rank == self.pp_size - 1 else start + per_stage
        return start, end

    def _check(self, rank: int):
        if not (0 <= rank < self.n_nodes):
            raise ValueError(f"rank {rank} out of range")
