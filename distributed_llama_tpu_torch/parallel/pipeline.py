"""The sequence-parallel forward and decode steps.

The counterpart of the sp part of the JAX package's `parallel/pipeline.py`,
at pp = 1: `_mesh_ctx` (:265), `pipeline_forward` (:187) and
`pipeline_decode_chunk` (:443). There one controller process runs the
forward under `shard_map` on every shard, each shard with its slice of the
cache's sequence axis; the shards combine attention's online-softmax
statistics with pmax/psum. Here one process drives every shard too, with no
process group: the cache is a list of per-shard [L, b, local_seq, n_kv, hd]
slabs, shard i on `mesh.devices[i]`, and `models/transformer.py`'s sp
branch writes and attends shard by shard, then combines the shards' triples
on the mesh's first device, where everything else runs once. Shards that
share a card run one after another on its current stream, so the order, and
each kernel's launch count, is fixed. The logits come from `forward_layers`
too, so the q80 parity mode (`ModelConfig.q80_activations`) reaches the
wcls matmul here as in the JAX `_logits_of` (:399).
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.params import ModelParams
from ..models.transformer import SpShards, forward_layers, step_positions
from ..ops.rope import RopeTables
from ..runtime.decode import decode_loop
from .mesh import Mesh


def _mesh_ctx(mesh: Mesh, cache: list) -> SpShards:
    """The shards of a sequence-parallel cache: shard i holds the global
    positions i * local_seq + [0, local_seq) on `mesh.devices[i]`."""
    if len(cache) != mesh.sp:
        raise ValueError(f"an sp={mesh.sp} mesh needs {mesh.sp} cache shards, got {len(cache)}")
    local_seq = cache[0].seq_len
    for i, (shard, dev) in enumerate(zip(cache, mesh.devices)):
        if shard.k_scale is not None:
            raise NotImplementedError("the int8 KV cache is single-device only")
        if shard.seq_len != local_seq or shard.k.device != dev:
            raise ValueError(f"cache shard {i} must hold {local_seq} rows on {dev}")
    return SpShards(caches=tuple(cache), offsets=tuple(i * local_seq for i in range(mesh.sp)))


def pipeline_forward(
    cfg: ModelConfig,
    mesh: Mesh,
    params: ModelParams,
    rope: RopeTables,
    cache: list,  # KVCache per shard, [L, b, local_seq, n_kv, hd] each
    tokens: torch.Tensor,  # [b, t] on mesh.devices[0]
    pos_start: int,  # every row's first position (per-row positions on a
    # mesh, JAX's batched serving there, are not ported: ROADMAP A13)
    logits_mode: str = "last",
    kv_len: int | None = None,  # the GLOBAL KV read bound; each shard
    # reads min(kv_len, local_seq) of its rows, which is exact
) -> torch.Tensor:
    """One forward step over a sequence-parallel cache; the contract of
    `models.transformer.forward`: writes the step's K/V into the shards in
    place and returns f32 logits, [b, vocab] for "last", [b, t, vocab] for
    "all", on the mesh's first device."""
    if logits_mode not in ("last", "all"):
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    if isinstance(pos_start, torch.Tensor):
        raise NotImplementedError("per-row positions on a mesh are not ported (ROADMAP A13)")
    shards = _mesh_ctx(mesh, cache)
    positions, pos_start = step_positions(tokens, pos_start, len(cache) * cache[0].seq_len)
    return forward_layers(cfg, params, rope, shards, tokens, positions, pos_start, logits_mode,
                          kv_len, None)


def pipeline_decode_chunk(
    cfg: ModelConfig,
    mesh: Mesh,
    params: ModelParams,
    rope: RopeTables,
    cache: list,
    token: torch.Tensor,  # [b] — the token to feed first, on mesh.devices[0]
    pos_start: int,
    n_steps: int,
    temperature: float = 0.0,
    topp: float = 0.9,
    generator: torch.Generator | None = None,
    kv_len: int | None = None,  # the GLOBAL KV read bound covering
    # pos_start + n_steps
) -> tuple[torch.Tensor, torch.Tensor]:
    """runtime/decode.py's decode_chunk over a sequence-parallel cache:
    n_steps forward+sample iterations with no host sync inside. Returns
    (tokens [b, n_steps], last_token [b], the last step's logits) on the
    mesh's first device."""

    def step(tok, pos):
        return pipeline_forward(cfg, mesh, params, rope, cache, tok, pos, kv_len=kv_len)

    return decode_loop(step, token, pos_start, n_steps, temperature, topp, generator)
