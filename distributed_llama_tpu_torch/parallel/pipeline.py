"""The PP x TP shard loop, with dp, ep and sp.

The counterpart of the JAX package's `parallel/pipeline.py`: `_local_stage`
(:133), `_stage_rounds` (:275), `_logits_of` (:395), `pipeline_forward`
(:187), `pipeline_decode_chunk` (:443) and `pipeline_batch_decode_chunk`
(:544). There one controller runs the step under `shard_map` on every
shard at once, with psum / ppermute / all_gather between them. Here one
process drives every shard, with no process group, and JAX's collectives
become operations in a fixed order:

* a psum over tp (after each layer's attention and FFN projections, JAX's
  `reduce_fn`, transformer.py:645, :654) sums the shards' partials in rank
  order, in the partials' dtype, on the group's first device; the sum
  serves every shard from there;
* an ep combine (the psum inside JAX's `_moe_ffn`) sums the ep shards'
  f32 partials likewise, before the tp reduce;
* a ppermute over pp is a copy of the stage's output to the next stage's
  device;
* the all_gather of the vocab-split logits is a concatenation in tp order
  on the mesh's first device, where the step's tokens arrive.

The sum order is then the same in every run, and a mesh with tp = ep = 1
does exactly the single device's arithmetic. Copies between cards are
torch's peer copies, which order themselves against both cards' current
streams; nothing waits on the host. Cells that share a card run one after
another on its stream.

The rounds are JAX's GPipe schedule: microbatch m is in stage s in round
m + s. JAX runs every stage every round and parks the idle ones; here only
the stage holding a microbatch runs. A prefill chunk splits into pp
microbatches where pp divides it and the microbatch keeps the chunk's
kernel arms (`microbatch_count`), else it runs whole. An ep group computes
its attention once, on its ep shard 0, which holds the group's KV cache
(JAX replicates both over ep), and hands the normed activation and the
route to every ep shard for the MoE FFN.

Every collective adds one to `COUNTS` (once a step, whatever the dp
extent: JAX's per-shard program has one op for all dp groups), so that a
test can hold a step to its budget.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.config import ModelConfig
from ..models.transformer import (
    SpShards, _paged_index, _row_window, attention_out, ffn_out, linear, step_positions,
)
from ..ops.cuda_attention import FLASH_ROWS, FLASH_TILE, flash_plan
from ..ops.moe import moe_router
from ..ops.norm import rms_norm
from ..ops.rope import RopeTables, rope_rows
from .mesh import Mesh
from .sharding import MeshKV, MeshParams

#: the row count up to which a Q40 matmul takes K1 (ops/quant.py
#: `quant_matmul`), and the query count from which attention takes flash
I8_MAX_ROWS = 8
FLASH_MIN_T = 8


@dataclass
class CollectiveCounts:
    """The shard loop's collectives since the last `reset`."""

    tp_reduce: int = 0
    pp_handoff: int = 0
    logits_gather: int = 0
    ep_combine: int = 0

    def reset(self) -> None:
        self.tp_reduce = self.pp_handoff = self.logits_gather = self.ep_combine = 0

    def snapshot(self) -> dict:
        return dict(tp_reduce=self.tp_reduce, pp_handoff=self.pp_handoff,
                    logits_gather=self.logits_gather, ep_combine=self.ep_combine)


COUNTS = CollectiveCounts()


def collective_budget(cfg: ModelConfig, mesh: Mesh, microbatches: int) -> dict:
    """What one forward over `mesh` in `microbatches` microbatches counts
    (the static form is JAX's jaxpr budget, tests/test_kv_transport.py:200):
    2 L M tp reduces and one logits gather where tp > 1, (pp - 1) M
    hand-offs, L M ep combines where ep > 1."""
    L, M = cfg.n_layers, microbatches
    return dict(tp_reduce=2 * L * M if mesh.tp > 1 else 0, pp_handoff=(mesh.pp - 1) * M,
                logits_gather=1 if mesh.tp > 1 else 0,
                ep_combine=L * M if mesh.ep > 1 else 0)


def _flash_split(cfg: ModelConfig, b: int, t: int, view_len: int) -> int:
    """The KV tiles a split of K3 takes for t queries over a view_len-row
    view (ops/cuda_attention.py `plan_for`, a function of shapes alone), on
    a shard of `cfg`'s heads."""
    g = cfg.n_heads // cfg.n_kv_heads
    base = b * cfg.n_kv_heads * -(-(t * g) // FLASH_ROWS)
    return flash_plan(-(-view_len // FLASH_TILE), base).split_tiles


def microbatch_count(cfg: ModelConfig, pp: int, b: int, t: int, pos_start=None,
                     view_len: int | None = None) -> int:
    """JAX's rule (engine.py:671): pp microbatches where pp divides the
    chunk, else 1; here also only where every microbatch takes the chunk's
    own kernels and plans, so that a pp mesh computes the single device's
    numbers: K1 or K2 by row count, flash or not by query count, and (rows
    aligned at an int `pos_start` over a `view_len`-row KV view) K3's split
    of the KV tiles, which its query count sets. A MoE chunk runs whole: the
    grouped arm blocks each expert's rows by the chunk's row count (K4's
    block_r; the plain arm's per-expert products). `cfg` is a shard's."""
    if pp == 1 or t % pp or cfg.is_moe:
        return 1
    mt = t // pp
    if ((b * t <= I8_MAX_ROWS) != (b * mt <= I8_MAX_ROWS)
            or (t >= FLASH_MIN_T) != (mt >= FLASH_MIN_T)):
        return 1
    if isinstance(pos_start, int) and view_len is not None and t >= FLASH_MIN_T:
        if _flash_split(cfg, b, mt, view_len) != _flash_split(cfg, b, t, view_len):
            return 1
    return pp


class _Placed:
    """A tensor (or a tuple of tensors, or None) and its copies by device,
    each made once; or, with `build`, a value built on each device."""

    def __init__(self, value=None, build=None):
        self.value = value
        self.build = build
        self.copies = {}

    def on(self, dev):
        if dev in self.copies:
            return self.copies[dev]
        v = self.value
        if self.build is not None:
            got = self.build(dev)
        elif isinstance(v, tuple):
            got = tuple(x.to(dev) for x in v)
        elif isinstance(v, torch.Tensor):
            got = v.to(dev)
        else:
            got = v
        self.copies[dev] = got
        return got


def _reduce(parts: list, dev) -> torch.Tensor:
    """The partials summed in rank order on `dev`, in their dtype."""
    acc = parts[0].to(dev)
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return acc


class _Step:
    """One forward step's operands over the mesh."""

    def __init__(self, cfg, mesh, params, rope, cache, kv_len, page_table, page_size):
        self.cfg, self.mesh, self.params, self.rope = cfg, mesh, params, rope
        self.scfg = params.scfg
        self.cache, self.kv_len = cache, kv_len
        self.page_size = page_size
        self.table = None
        if page_table is not None:
            # one table a distinct device (the engine's DeviceTables), or
            # the first device's, copied
            pre = page_table if isinstance(page_table, dict) else {mesh.first: page_table}
            self.table = _Placed(pre[mesh.first])
            self.table.copies.update(pre)

    def stage_cache(self, d: int, p: int, t: int):
        """The (d, p, t) cell's cache: its KVCache, an SpShards over its sp
        shards, or the (p, t) page pool."""
        mesh = self.mesh
        if self.cache.paged:
            return self.cache.shards[(0, p, t, 0)]
        if mesh.sp == 1:
            return self.cache.shards[(d, p, t, 0)]
        group = self.cache.sp_group(d, p, t)
        local = group[0].seq_len
        return SpShards(caches=tuple(group), offsets=tuple(s * local for s in range(mesh.sp)))

    def run_stage(self, d: int, p: int, x: torch.Tensor, ops: dict, count: bool):
        """Stage p's layers over x (on the stage's home, grid[d, p, 0, 0,
        0]) for one microbatch; `ops` holds the microbatch's placed
        positions, rope rows, cache index and position operand."""
        mesh, cfg = self.mesh, self.scfg
        g = mesh.grid
        home = g[d, p, 0, 0, 0]
        n_local = cfg.n_experts // mesh.ep if cfg.is_moe else 0
        for li in range(cfg.n_layers):
            parts = []
            for t in range(mesh.tp):
                dev = g[d, p, 0, t, 0]
                parts.append(attention_out(
                    cfg, ops["rows"].on(dev), x.to(dev), ops["positions"].on(dev),
                    ops["pos"].on(dev), self.params.stage(p, 0, t, dev),
                    self.stage_cache(d, p, t), li, self.kv_len, ops["index"].on(dev)))
            if count and mesh.tp > 1:
                COUNTS.tp_reduce += 1
            x = x + _reduce(parts, home).to(x.dtype)
            lp0 = self.params.stage(p, 0, 0, home)
            y = rms_norm(x, lp0.norm1[li], cfg.norm_epsilon)
            route = None
            if cfg.is_moe:
                route = _Placed(moe_router(y, lp0.moe_gate[li], cfg.n_active_experts))
            parts = []
            for t in range(mesh.tp):
                eparts = []
                for e in range(mesh.ep):
                    dev = g[d, p, e, t, 0]
                    ep = (e * n_local, n_local) if mesh.ep > 1 else None
                    eparts.append(ffn_out(cfg, y.to(dev), self.params.stage(p, e, t, dev), li,
                                          route.on(dev) if route is not None else None, ep))
                parts.append(_reduce(eparts, g[d, p, 0, t, 0]))
            if count and mesh.ep > 1:
                COUNTS.ep_combine += 1
            if count and mesh.tp > 1:
                COUNTS.tp_reduce += 1
            x = x + _reduce(parts, home).to(x.dtype)
        return x

    def micro_ops(self, tokens_mb, pos0, limit: int, cache_seq):
        """The placed operands of one microbatch: positions, rope rows, the
        cache index (per-row window, paged index or None) and the position
        operand (int or [b] tensor)."""
        positions, pos = step_positions(tokens_mb, pos0, limit)
        placed = _Placed(positions)
        rows = rope_rows(self.rope, positions)
        index = _Placed(None)
        if self.table is not None:
            sink = self.cache[0].k.shape[1] - 1
            index = _Placed(build=lambda dev: _paged_index(
                self.cfg, placed.on(dev), self.table.on(dev), self.page_size, sink, self.kv_len))
        elif isinstance(pos, torch.Tensor) and self.mesh.sp == 1:
            index = _Placed(_row_window(pos, cache_seq, tokens_mb.shape[1]))
        return dict(positions=placed, rows=_Placed(rows), index=index, pos=_Placed(pos))

    def logits(self, d: int, x: torch.Tensor, count: bool) -> torch.Tensor:
        """JAX's `_logits_of`: the final norm, the vocab-split wcls and
        the gather, on the mesh's first device; a lane-padded shard's zero
        columns are dropped there."""
        mesh, cfg = self.mesh, self.cfg
        g = mesh.grid
        home = g[d, mesh.pp - 1, 0, 0, 0]
        x = rms_norm(x, self.params.replicated("final_norm", home), cfg.norm_epsilon)
        parts = []
        for t in range(mesh.tp):
            dev = g[d, mesh.pp - 1, 0, t, 0]
            w = self.params.wcls[(t, dev)]
            y = linear(x.to(dev), w, cfg.dtype, q80=cfg.q80_activations)
            parts.append(y[..., :self.params.vocab_shard].to(torch.float32).to(mesh.first))
        if count and mesh.tp > 1:
            COUNTS.logits_gather += 1
        return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def step_microbatches(params: MeshParams, cache: MeshKV, b: int, t: int, pos_start,
                      kv_len: int | None, page_table=None, page_size: int | None = None) -> int:
    """The microbatches `pipeline_forward` cuts a step of t tokens in b rows
    a dp group into (`microbatch_count` over the step's KV view; 1 on an
    sp mesh, whose shards' views differ)."""
    if params.mesh.sp > 1:
        return 1
    if cache.paged:
        table = page_table if isinstance(page_table, torch.Tensor) else \
            next(iter(page_table.values()))
        max_slots = table.shape[1]
        n_read = max_slots if kv_len is None else min(-(-kv_len // page_size), max_slots)
        view_len = n_read * page_size
    else:
        S = cache[0].seq_len
        view_len = S if kv_len is None else min(kv_len, S)
    return microbatch_count(params.scfg, params.mesh.pp, b, t, pos_start, view_len)


def pipeline_forward(
    cfg: ModelConfig,
    mesh: Mesh,
    params: MeshParams,  # parallel/sharding.py `shard_params`
    rope: RopeTables,  # on the mesh's first device
    cache: MeshKV,  # `mesh_kv` or `mesh_pool`
    tokens: torch.Tensor,  # [b, t] on the mesh's first device
    pos_start,  # int (rows aligned), or a [b] (per-row positions; a row at
    # seq_len is parked and writes nothing) or 0-d tensor on that device
    logits_mode: str = "last",
    microbatches: int | None = None,  # None: `microbatch_count`
    kv_len: int | None = None,  # the GLOBAL KV read bound; an sp shard
    # reads min(kv_len, local_seq) of its rows, which is exact
    page_table=None,  # the paged layout (pure pp x tp): [b, slots] int32
    # tables, a tensor on the first device or a dict of copies by device
    page_size: int | None = None,
) -> torch.Tensor:
    """One forward step over a mesh; the contract of
    `models.transformer.forward`: writes the step's K/V into the cache's
    shards in place and returns f32 logits, [b, vocab] for "last", [b, t,
    vocab] for "all", on the mesh's first device."""
    if logits_mode not in ("last", "all"):
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    if (page_table is None) != (page_size is None):
        raise ValueError("the paged layout needs both page_table and page_size")
    if not isinstance(params, MeshParams) or not isinstance(cache, MeshKV):
        raise TypeError("pipeline_forward takes a MeshParams and a MeshKV (parallel/sharding.py)")
    b, t = tokens.shape
    if b % mesh.dp:
        raise ValueError(f"batch ({b}) must divide over the dp mesh axis ({mesh.dp})")
    bl = b // mesh.dp
    if isinstance(pos_start, torch.Tensor) and pos_start.ndim == 0:
        # a device position, the same for every row: the per-row arm
        # computes what a single device computes at it (no flash either)
        pos_start = pos_start.expand(b)
    per_row = isinstance(pos_start, torch.Tensor)
    if per_row and pos_start.shape != (b,):
        raise ValueError(f"per-row positions must be [{b}], got {tuple(pos_start.shape)}")
    if microbatches is None:
        microbatches = step_microbatches(params, cache, bl, t, pos_start, kv_len, page_table,
                                         page_size)
    M = microbatches
    if t % max(M, 1):
        raise ValueError(f"microbatches ({M}) must divide the token length ({t})")
    M = max(M, 1)
    mt = t // M
    limit = cfg.seq_len if page_table is not None else cache.seq_len
    cache_seq = cache[0].seq_len if not cache.paged else None
    step = _Step(cfg, mesh, params, rope, cache, kv_len, page_table, page_size)
    g, pp = mesh.grid, mesh.pp
    outs = []
    for d in range(mesh.dp):
        count = d == 0
        rows = slice(d * bl, (d + 1) * bl)
        tok_d = tokens[rows]
        pos_d = pos_start[rows] if per_row else pos_start
        home0 = g[d, 0, 0, 0, 0]
        x_all = params.replicated("embedding", home0)[tok_d.to(home0)].to(torch.float32)
        xs = [x_all[:, m * mt:(m + 1) * mt] for m in range(M)]
        ops = [step.micro_ops(tok_d[:, m * mt:(m + 1) * mt], pos_d + m * mt, limit, cache_seq)
               for m in range(M)]
        done = [None] * M
        for r in range(M + pp - 1):
            for p in range(pp):
                m = r - p
                if not 0 <= m < M:
                    continue
                x = step.run_stage(d, p, xs[m], ops[m], count)
                if p < pp - 1:
                    xs[m] = x.to(g[d, p + 1, 0, 0, 0])
                    if count:
                        COUNTS.pp_handoff += 1
                else:
                    done[m] = x
        x = torch.cat(done, dim=1) if M > 1 else done[0]
        if logits_mode == "last":
            x = x[:, -1, :].contiguous()
        outs.append(step.logits(d, x, count))
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]


def pipeline_decode_chunk(
    cfg: ModelConfig,
    mesh: Mesh,
    params: MeshParams,
    rope: RopeTables,
    cache: MeshKV,
    token: torch.Tensor,  # [b] — the token to feed first, on the mesh's first device
    pos_start,  # int, or [b] per-row positions
    n_steps: int,
    temperature: float = 0.0,
    topp: float = 0.9,
    generator: torch.Generator | None = None,
    kv_len: int | None = None,  # the GLOBAL KV read bound covering pos_start + n_steps
    page_table=None,
    page_size: int | None = None,
) -> tuple:
    """runtime/decode.py's `decode_chunk` over a mesh: n_steps forward +
    sample iterations with no host sync inside, each forward crossing the
    stages. Returns (tokens [b, n_steps], last_token [b], the last step's
    logits) on the mesh's first device."""
    from ..runtime.decode import decode_chunk

    return decode_chunk(cfg, params, rope, cache, token, pos_start, n_steps, temperature, topp, generator, kv_len,
                        page_table, page_size)


def pipeline_batch_decode_chunk(cfg: ModelConfig, mesh: Mesh, params: MeshParams,
                                rope: RopeTables, cache: MeshKV, rows, n_steps: int, kv_len: int | None = None, page_table=None,
                                page_size: int | None = None, sampler: str = "topp") -> tuple:
    """runtime/batch_session.py's `batch_decode_chunk` over a mesh: per-row
    positions (parked rows at seq_len) and per-row sampling streams, each
    forward crossing the stages. Returns (tokens [b, n_steps], the last
    step's logits)."""
    from ..runtime.batch_session import batch_decode_chunk

    return batch_decode_chunk(cfg, params, rope, cache, rows, n_steps, kv_len, page_table,
                              page_size, sampler)


__all__ = [
    "COUNTS", "CollectiveCounts", "collective_budget", "microbatch_count",
    "pipeline_batch_decode_chunk", "pipeline_decode_chunk", "pipeline_forward",
    "step_microbatches",
]
