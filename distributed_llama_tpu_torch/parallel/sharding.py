"""Shards of the parameters and the KV cache, one per mesh cell.

The counterpart of the JAX package's NamedSharding rules:
`parallel/sharding.py:param_shardings` (:40), `parallel/pipeline.py:
pp_param_shardings` (:60), `pp_cache_sharding` (:106),
`pp_paged_pool_sharding` (:110) and `pp_prefix_sharding` (:122). JAX lays a
global array over the mesh and each device sees its block; here each block
is cut out once, as its own contiguous tensor on its device (the kernel
wrappers refuse strided operands), and `parallel/pipeline.py` hands every
shard its own. The placement math is the reference's slicers
(src/nn/nn-core.cpp:222-324):

  wqkv, w13        row-split over tp (the out axis: the T layout's last
                   axis of q [L, in/8, out] and d [L, in/32, out]); the
                   fused parts split each on its own, so shard s holds
                   q[s] | k[s] | v[s] and w1[s] | w3[s] (JAX interleaves
                   them so at load, models/params.py `_interleave`)
  wo, w2           col-split over tp (the in axis: q's word rows, d's
                   blocks, whole Q40 blocks a shard)
  expert stacks    [L, E, ...]: experts over ep, ff over tp (`erow` for
                   w1/w3, `ecol` for w2)
  wcls             row-split over the vocab on tp; a Q40 shard whose
                   width is not a lane multiple (Llama-3.2-1B's 32064 at
                   tp 4, Qwen3-30B-A3B's 75968 at tp 2) is padded with
                   zero columns up to one, so that it takes K1/K2, and the
                   gather drops their logits
  layer axis       over pp, for every per-layer weight and vector
  embedding,       replicated
  final_norm
  KV cache         [L/pp, b/dp, S/sp, kv/tp, hd] a (dp, pp, tp, sp) cell,
                   held once for the ep shards of its group, which share
                   JAX's replicated attention
  paged pool       [L/pp, n_pages + 1, ps, kv/tp, hd] a (pp, tp) cell: page
                   ids are global, so the host pool and its tables need no
                   mesh awareness

JAX's constraints hold: pp divides n_layers, tp divides the head counts and
every col-split block count, ep divides the expert count; `check_mesh`
raises where they do not.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields

import torch

from ..models.config import ModelConfig
from ..models.params import KVCache, LayerParams, ModelParams, kv_cache_of_shape
from ..ops.quant import LANE, Q_BLOCK, QuantTensor
from .mesh import Mesh


def check_mesh(cfg: ModelConfig, mesh: Mesh) -> None:
    """Raise ValueError where the model does not split over the mesh."""
    tp, pp, ep = mesh.tp, mesh.pp, mesh.ep
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers ({cfg.n_layers}) must be divisible by pp ({pp})")
    if cfg.n_kv_heads % tp or cfg.n_heads % tp:
        raise ValueError(
            f"tp ({tp}) must divide n_kv_heads ({cfg.n_kv_heads}) and n_heads ({cfg.n_heads})"
        )
    for name, width in (("q_dim", cfg.q_dim), ("hidden_dim", cfg.hidden_dim)):
        if (width // Q_BLOCK) % tp or width % (Q_BLOCK * tp):
            raise ValueError(
                f"tp ({tp}) must divide the {width // Q_BLOCK} Q40 blocks of {name} ({width})"
            )
    if cfg.vocab_size % tp:
        raise ValueError(f"tp ({tp}) must divide vocab_size ({cfg.vocab_size})")
    if ep > 1 and (not cfg.is_moe or cfg.n_experts % ep):
        raise ValueError(f"ep ({ep}) must divide the expert count ({cfg.n_experts})")


def shard_config(cfg: ModelConfig, mesh: Mesh) -> ModelConfig:
    """The config a shard's layers read: its own head counts, ff width and
    layer count. The expert count stays global: the router is replicated,
    and the MoE arm is chosen on the global count, as in JAX."""
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // mesh.tp, n_kv_heads=cfg.n_kv_heads // mesh.tp,
        hidden_dim=cfg.hidden_dim // mesh.tp, n_layers=cfg.n_layers // mesh.pp,
    )


def _cut(x: torch.Tensor, axis: int, n: int, i: int, device) -> torch.Tensor:
    """Block i of n along `axis`, as a contiguous tensor on `device`."""
    size = x.shape[axis] // n
    return x.narrow(axis, i * size, size).to(device).contiguous()


def _cut_parts(x: torch.Tensor, axis: int, sizes: list, n: int, i: int, device) -> torch.Tensor:
    """The fused row-split: x's `axis` concatenates parts of `sizes`; shard
    i takes block i of n of every part, concatenated in order."""
    pieces, start = [], 0
    for s in sizes:
        pieces.append(x.narrow(axis, start + i * (s // n), s // n))
        start += s
    return torch.cat(pieces, dim=axis).to(device).contiguous()


def _weight(w, device, *, layers=None, row=None, col=None, experts=None):
    """One shard of a weight. `layers` (start, count) cuts the leading
    layer axis; `row` (n, i[, sizes]) the out axis, `col` (n, i) the in
    axis, `experts` (n, i) the expert axis (axis 1 of an [L, E, ...]
    stack). A QuantTensor is in the T layout: out last, in (word rows,
    blocks) second to last."""
    if w is None:
        return None
    quant = isinstance(w, QuantTensor)
    parts = (w.q, w.d) if quant else (w,)
    out = []
    for x in parts:
        if layers is not None:
            x = x.narrow(0, layers[0], layers[1])
        if experts is not None:
            x = x.narrow(1, experts[1] * (x.shape[1] // experts[0]), x.shape[1] // experts[0])
        if row is not None:
            axis = x.ndim - 1 if quant else x.ndim - 2
            if len(row) == 3:
                x = _cut_parts(x, axis, row[2], row[0], row[1], device)
            else:
                x = _cut(x, axis, row[0], row[1], device)
        if col is not None:
            axis = x.ndim - 2 if quant else x.ndim - 1
            x = _cut(x, axis, col[0], col[1], device)
        out.append(x.to(device).contiguous())
    return QuantTensor(q=out[0], d=out[1]) if quant else out[0]


def _lane_padded(w):
    """A Q40 weight with zero columns (q 0, d 0: exact zeros out) appended
    up to a lane multiple of out columns; anything else as it is."""
    if not isinstance(w, QuantTensor) or w.out_features % LANE == 0:
        return w
    pad = -w.out_features % LANE
    return QuantTensor(q=torch.nn.functional.pad(w.q, (0, pad)),
                       d=torch.nn.functional.pad(w.d, (0, pad)))


def shard_layers(cfg: ModelConfig, layers: LayerParams, mesh: Mesh, p: int, e: int, t: int,
                 device) -> LayerParams:
    """The (pp p, ep e, tp t) cell's layer weights on `device`. An ep
    shard past the first holds its experts only: its group's attention,
    norms and router run on ep shard 0 (parallel/pipeline.py)."""
    tp, lp = mesh.tp, cfg.n_layers // mesh.pp
    span = (p * lp, lp)
    ff = cfg.hidden_dim
    kw = {f.name: None for f in fields(LayerParams)}
    if e == 0:
        kw["wqkv"] = _weight(layers.wqkv, device, layers=span,
                             row=(tp, t, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim]))
        kw["wo"] = _weight(layers.wo, device, layers=span, col=(tp, t))
        for name in ("norm0", "norm1", "q_norm", "k_norm", "moe_gate"):
            kw[name] = _weight(getattr(layers, name), device, layers=span)
    if cfg.is_moe:
        ex = (mesh.ep, e)
        kw["w1"] = _weight(layers.w1, device, layers=span, experts=ex, row=(tp, t))
        kw["w3"] = _weight(layers.w3, device, layers=span, experts=ex, row=(tp, t))
        kw["w2"] = _weight(layers.w2, device, layers=span, experts=ex, col=(tp, t))
    else:
        kw["w13"] = _weight(layers.w13, device, layers=span, row=(tp, t, [ff, ff]))
        kw["w2"] = _weight(layers.w2, device, layers=span, col=(tp, t))
    return LayerParams(**kw)


@dataclass
class MeshParams:
    """A model's weights cut over a mesh. `layers[(p, e, t, device)]` is
    the (pp p, ep e, tp t) cell's LayerParams on `device`: every device a
    cell's work runs on holds its own copy (the dp and sp replicas of JAX's
    layout), and replicas that share a device share one. `wcls[(t,
    device)]` is tp shard t of the classifier (its first `vocab_shard`
    columns; a Q40 shard may carry zero columns past them, see the module
    docstring); `embedding` and
    `final_norm` are replicated (`replicated(name, device)`)."""

    mesh: Mesh
    cfg: ModelConfig  # the global config
    scfg: ModelConfig  # `shard_config`: what a shard's layers read
    layers: dict
    wcls: dict
    embedding: dict
    final_norm: dict

    @property
    def vocab_shard(self) -> int:
        """The vocab columns of one tp shard of the classifier."""
        return self.cfg.vocab_size // self.mesh.tp

    def stage(self, p: int, e: int, t: int, device) -> LayerParams:
        return self.layers[(p, e, t, device)]

    def replicated(self, name: str, device) -> torch.Tensor:
        return getattr(self, name)[device]

    def tensors(self) -> list:
        """Every distinct device tensor the shards hold."""
        out = []
        for lp in self.layers.values():
            for f in fields(LayerParams):
                w = getattr(lp, f.name)
                if w is not None:
                    out += [w.q, w.d] if isinstance(w, QuantTensor) else [w]
        for w in list(self.wcls.values()):
            out += [w.q, w.d] if isinstance(w, QuantTensor) else [w]
        out += list(self.embedding.values()) + list(self.final_norm.values())
        return out


def shard_params(cfg: ModelConfig, params: ModelParams, mesh: Mesh) -> MeshParams:
    """Cut loaded single-device `params` (the port's tp = 1 load order)
    into a MeshParams over `mesh`: attention weights for every (pp, tp)
    cell on its ep shard 0's devices, expert weights for every (pp, ep,
    tp) cell on its own; dense FFN weights with the attention's."""
    check_mesh(cfg, mesh)
    g = mesh.grid
    layers = {}
    for d in range(mesh.dp):
        for p in range(mesh.pp):
            for e in range(mesh.ep):
                for t in range(mesh.tp):
                    dev = g[d, p, e, t, 0]
                    if (p, e, t, dev) not in layers:
                        layers[(p, e, t, dev)] = shard_layers(cfg, params.layers, mesh, p, e, t,
                                                              dev)
    wcls, emb, fnorm = {}, {}, {}
    for d in range(mesh.dp):
        for t in range(mesh.tp):
            dev = g[d, mesh.pp - 1, 0, t, 0]
            if (t, dev) not in wcls:
                w = _weight(params.wcls, dev, row=(mesh.tp, t))
                wcls[(t, dev)] = _lane_padded(w) if mesh.tp > 1 else w
        emb.setdefault(g[d, 0, 0, 0, 0], params.embedding.to(g[d, 0, 0, 0, 0]))
        last = g[d, mesh.pp - 1, 0, 0, 0]
        fnorm.setdefault(last, params.final_norm.to(last))
    return MeshParams(mesh=mesh, cfg=cfg, scfg=shard_config(cfg, mesh), layers=layers, wcls=wcls,
                      embedding=emb, final_norm=fnorm)


@dataclass
class MeshKV:
    """A KV cache cut over a mesh: `shards[(d, p, t, s)]` is the (dp d, pp
    p, tp t, sp s) cell's KVCache on grid[d, p, 0, t, s], contiguous
    [L/pp, b/dp, S/sp, kv/tp, hd]; or, `paged`, `shards[(0, p, t, 0)]` the
    (pp, tp) cell's page pool [L/pp, n_pages + 1, ps, kv/tp, hd]. Iterating
    gives the shards in grid order (an sp-only mesh's sp shards in order)."""

    mesh: Mesh
    shards: dict
    paged: bool = False

    def __iter__(self):
        return iter(self.shards.values())

    def __len__(self) -> int:
        return len(self.shards)

    def __getitem__(self, i: int) -> KVCache:
        return list(self.shards.values())[i]

    def tensors(self) -> tuple:
        return tuple(x for shard in self.shards.values() for x in shard.tensors())

    def sp_group(self, d: int, p: int, t: int) -> list:
        return [self.shards[(d, p, t, s)] for s in range(self.mesh.sp)]

    def row_view(self, row: int) -> "MeshKV":
        """Row `row` of the contiguous layout alone, on the mesh of its dp
        group (dp 1): every shard a view of the row's slab, so a b = 1 step
        on it (an admission chunk at a scalar position, flash-eligible)
        writes in place."""
        mesh = self.mesh
        bl = self[0].k.shape[1]
        d, r = divmod(row, bl)
        sub = Mesh(shape={**mesh.shape, "dp": 1}, grid=mesh.grid[d : d + 1])
        shards = {(0, p, t, s): KVCache(*(None if x is None else x[:, r : r + 1]
                                          for x in (c.k, c.v, c.k_scale, c.v_scale)))
                  for (dd, p, t, s), c in self.shards.items() if dd == d}
        return MeshKV(mesh=sub, shards=shards)

    @property
    def seq_len(self) -> int:
        """Positions per row of the contiguous layout (every sp shard's)."""
        return self.mesh.sp * self[0].seq_len

    @property
    def k(self) -> torch.Tensor:
        """The first shard's k: its device and dtype stand for the cache's."""
        return self[0].k


def mesh_kv(cfg: ModelConfig, mesh: Mesh, batch: int, seq_len: int | None = None) -> MeshKV:
    """The zeroed contiguous cache of `batch` rows over `mesh`."""
    seq_len = cfg.seq_len if seq_len is None else seq_len
    shape = (cfg.n_layers // mesh.pp, batch // mesh.dp, seq_len // mesh.sp,
             cfg.n_kv_heads // mesh.tp, cfg.head_dim)
    shards = {}
    for d in range(mesh.dp):
        for p in range(mesh.pp):
            for t in range(mesh.tp):
                for s in range(mesh.sp):
                    shards[(d, p, t, s)] = kv_cache_of_shape(cfg, shape, mesh.grid[d, p, 0, t, s])
    return MeshKV(mesh=mesh, shards=shards)


def mesh_pool(cfg: ModelConfig, mesh: Mesh, n_pages: int, page_size: int) -> MeshKV:
    """The zeroed paged pool (n_pages and the sink page) over a pure pp x
    tp mesh."""
    shape = (cfg.n_layers // mesh.pp, n_pages + 1, page_size, cfg.n_kv_heads // mesh.tp,
             cfg.head_dim)
    shards = {(0, p, t, 0): kv_cache_of_shape(cfg, shape, mesh.grid[0, p, 0, t, 0])
              for p in range(mesh.pp) for t in range(mesh.tp)}
    return MeshKV(mesh=mesh, shards=shards, paged=True)


def split_global(x: torch.Tensor, mesh: Mesh, layer_axis: int, head_axis: int) -> dict:
    """A global [L, ..., kv, hd] slice (a prefix entry's, a transport
    segment) cut into its (pp, tp) blocks: {(p, t): block} on the
    devices of the (0, p, 0, t, 0) cells."""
    return {(p, t): _cut(_cut(x, layer_axis, mesh.pp, p, x.device), head_axis, mesh.tp, t,
                         mesh.grid[0, p, 0, t, 0])
            for p in range(mesh.pp) for t in range(mesh.tp)}


def join_global(blocks: dict, mesh: Mesh, layer_axis: int, head_axis: int) -> torch.Tensor:
    """The inverse of `split_global`, on the mesh's first device."""
    dev = mesh.first
    rows = [torch.cat([blocks[(p, t)].to(dev) for t in range(mesh.tp)], dim=head_axis)
            for p in range(mesh.pp)]
    return torch.cat(rows, dim=layer_axis)
