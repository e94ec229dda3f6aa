"""Device-performance observability: the warm-ladder cost table, the HBM
ledger, live roofline / MFU / SLO gauges, and on-demand profiler capture.

The counterpart of the JAX package's `runtime/profiling.py`, with the same
names, counters, gauges and ``/debug/costs`` / ``/metrics`` /
``/debug/profile`` contracts:

* **Warm-ladder cost table** — one `CostEntry` a (kind, size, kv bucket)
  of the JAX engine's warm ladder for the same engine arguments
  (`InferenceEngine.cost_plan`: prefill, prefill_row, decode,
  batch_decode, verify, verify_row, the prefix copies and the page
  movers). JAX lowers each program and walks its jaxpr; the port has no
  jaxpr, so `census_entry` runs one step of the program's shape on
  ``meta`` copies of the engine's tensors (shapes, no data: nothing runs
  on the card and the engine's cache, pool, prefix cache and graphs stay
  as they were) under a census (ops/census.py):

  - a kernel wrapper states its call's FLOPs and bytes from its shapes
    (each input and output once; the attention kernels only the K/V the
    causal limit reads: the kernel table's bound arithmetic, PERF.md);
  - torch glue ops are counted by a dispatch mode: dots as 2·m·n·k, every
    other floating-point op one FLOP an output element (JAX's counting);
    bytes as JAX's census models them: reads of the step's resident
    inputs (weights, rope tables, the KV cache, the static buffers, a
    slice read at its slice's size, a gather at what it gathers) and
    in-place writes into them, intermediates on chip.

  A decode or batch_decode entry is its one-step graph's census times
  `size`; a verify entry is one round; prefill, prefix and page kinds run
  eagerly in the port and are censused from one step of that shape (a
  prefill chunk ending at its kv bucket). Served at ``GET /debug/costs``
  with coverage against the ladder.
* **HBM ledger** — modeled per-component device bytes (weights, rope
  tables, KV cache, contiguous prefix entries, a draft engine),
  reconciled against the card's measured bytes: the caching allocator's
  reserved bytes (``torch.cuda.memory_stats``, which hold the CUDA graph
  pool and the allocator's spare segments) and ``torch.cuda.mem_get_info``
  (the card's total and free bytes). On the CPU nothing is measured, as
  on XLA:CPU. Growth of the measured-minus-modeled residual beyond
  ``DLT_HBM_DRIFT_MB`` bumps ``hbm_drift_events``.
* **Live roofline / MFU** — the cost table joined with the chunk walls
  StepStats records (``decode[n]``, ``batch_decode[n]``,
  ``spec_verify[k]``): ``dlt_mfu``, ``dlt_bw_utilization``,
  ``dlt_device_duty_cycle`` and per-program rates; SLO attainment from
  the TTFT/TPOT histograms against ``DLT_SLO_TTFT_MS`` /
  ``DLT_SLO_TPOT_MS``.
* **On-demand capture** — ``GET /debug/profile?ms=...`` runs
  ``torch.profiler`` (CPU activity, and CUDA activity where a card is
  present) around live serving for a bounded window, single-flight
  (a concurrent capture gets 409), and writes a Chrome trace under
  ``DLT_PROFILE_DIR``.

Peaks: ``DLT_PEAK_TFLOPS`` (default 989, the H100 SXM data sheet's dense
bf16 peak at 700 W) and ``DLT_PEAK_HBM_GBS`` (default 3350, its HBM3
rate). A scrape (`metrics_view`) reads host-side metadata and the
allocator's counters only; it never runs anything on the card.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
import tempfile
import threading
import time

import numpy as np
import torch

from .telemetry import _tree_bytes


def peak_flops() -> float:
    """Device peak FLOP/s for MFU (``DLT_PEAK_TFLOPS``, dense bf16)."""
    try:
        return float(os.environ.get("DLT_PEAK_TFLOPS", 989.0)) * 1e12
    except ValueError:
        return 989.0e12


def peak_hbm_bytes_s() -> float:
    """Device peak HBM bandwidth for roofline (``DLT_PEAK_HBM_GBS``)."""
    try:
        return float(os.environ.get("DLT_PEAK_HBM_GBS", 3350.0)) * 1e9
    except ValueError:
        return 3350.0e9


# -- cost table --------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostEntry:
    """The census of ONE warm-ladder program, per dispatch: `flops` and
    `bytes_accessed` (kernels' stated cost plus the glue's), the kernels'
    share of each, and the counted kernel calls by wrapper."""

    kind: str
    size: int
    kv_len: int
    flops: float
    bytes_accessed: float
    kernel_flops: float
    kernel_bytes: float
    kernel_calls: dict
    tokens: int  # token positions processed per dispatch (batch included)

    @property
    def flops_per_token(self) -> float:
        return self.flops / max(self.tokens, 1)

    @property
    def bytes_per_token(self) -> float:
        return self.bytes_accessed / max(self.tokens, 1)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["flops_per_token"] = round(self.flops_per_token, 1)
        d["bytes_per_token"] = round(self.bytes_per_token, 1)
        return d


class CostTable:
    """Per-(kind, size, kv bucket) cost entries over a plan, plus the
    per-entry build failures (a failure is information: a ladder kind the
    census cannot run fails the coverage audit loudly)."""

    def __init__(self, entries: dict, failures: dict, partial: bool = False):
        self.entries = entries  # (kind, size, kv_len) -> CostEntry
        self.failures = failures  # (kind, size, kv_len) -> error string
        self.partial = partial  # built over a sub-plan (bench), not the ladder

    def lookup(self, kind: str, size: int):
        """The (kind, size) entry at the SHALLOWEST kv bucket — the
        conservative per-program floor the roofline join uses."""
        best = None
        for (k, s, kv), e in self.entries.items():
            if k == kind and s == size and (best is None or kv < best.kv_len):
                best = e
        return best

    def coverage_problems(self, plan) -> list:
        """One message per plan program missing from the table."""
        problems = []
        for key in plan:
            key = tuple(key)
            if key in self.entries:
                continue
            why = self.failures.get(key, "no cost entry built")
            problems.append(
                f"{key[0]}[{key[1]}|kv{key[2]}]: missing cost/memory entry ({why})"
            )
        return problems

    def snapshot(self, plan=None) -> dict:
        """The ``/debug/costs`` payload."""
        out = {
            "partial": self.partial,
            "n_entries": len(self.entries),
            "peak_tflops": peak_flops() / 1e12,
            "peak_hbm_gb_s": peak_hbm_bytes_s() / 1e9,
            "entries": [self.entries[k].as_dict() for k in sorted(self.entries)],
        }
        if self.failures:
            out["failures"] = {
                f"{k[0]}[{k[1]}|kv{k[2]}]": v for k, v in self.failures.items()
            }
        if plan is not None:
            missing = self.coverage_problems(plan)
            out["coverage"] = {
                "plan_size": len(list(plan)),
                "complete": not missing,
                "missing": missing,
            }
        return out


def entry_tokens(engine, kind: str, size: int) -> int:
    """Token positions one dispatch of this program processes: whole-batch
    programs advance `batch * size` positions, the per-row admission
    prefill one row's `size`, prefix and page movers `size` positions."""
    if kind in ("prefill", "decode", "batch_decode", "verify", "verify_row"):
        return engine.batch * size
    return size


# -- the census of one step ---------------------------------------------------

_aten = torch.ops.aten

#: dots: FLOPs 2·m·n·k from the operand shapes
_DOTS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default, _aten.baddbmm.default,
         _aten.dot.default, _aten.mv.default}
#: reads of a resident array at the size of what they take, not the whole
_GATHERS = {_aten.index.Tensor, _aten.index_select.default, _aten.gather.default,
            _aten.take.default, _aten.embedding.default}
#: ops that move or make data and compute nothing (no FLOPs)
_MOVES = _GATHERS | {
    _aten.clone.default, _aten.copy_.default, _aten._to_copy.default, _aten.cat.default,
    _aten.stack.default, _aten.index_copy_.default, _aten.index_copy.default,
    _aten.index_put_.default, _aten.index_put.default, _aten.scatter_.src,
    _aten.scatter.src, _aten.slice_scatter.default, _aten.repeat.default,
    _aten.fill_.Scalar, _aten.zero_.default, _aten.empty_like.default,
    _aten.zeros_like.default, _aten.new_empty.default, _aten.new_zeros.default,
}


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes a read of `t` touches: a broadcast (stride-0) axis reads its
    row once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _dot_flops(func, args) -> float:
    a, b = (args[1], args[2]) if func in (_aten.addmm.default, _aten.baddbmm.default) else args[:2]
    if func == _aten.dot.default:
        return 2.0 * a.numel()
    if func == _aten.mv.default:
        return 2.0 * a.numel()
    # mm [m, k] @ [k, n]; bmm [B, m, k] @ [B, k, n]
    return 2.0 * a.numel() * b.shape[-1]


def _census_mode(census, resident: set):
    """A TorchDispatchMode adding glue ops' FLOPs and bytes to `census`
    (see the module docstring); `resident` holds the storage ids of the
    step's inputs. Built lazily: the dispatch machinery is private API."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def sid(t):
        return t.untyped_storage()._cdata

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if census.depth or func is _aten._unsafe_view.default:
                return out
            schema = func._schema
            ret = schema.returns[0].alias_info if schema.returns else None
            if ret is not None and not ret.is_write:
                return out  # a view: no data moves
            outs = list(_tensors(out))
            if func in _DOTS:
                census.flops += _dot_flops(func, args)
            elif func not in _MOVES and any(o.is_floating_point() for o in outs):
                census.flops += float(sum(o.numel() for o in outs if o.is_floating_point()))
            arg0 = schema.arguments[0].alias_info if schema.arguments else None
            ins = list(_tensors(args)) + list(_tensors(list((kwargs or {}).values())))
            if arg0 is not None and arg0.is_write and ins:
                dst, others = ins[0], ins[1:]
                if sid(dst) in resident:
                    src = max((_read_bytes(t) for t in others), default=_read_bytes(dst))
                    census.bytes += min(_read_bytes(dst), src)
                ins = others
            elif func in _GATHERS and ins:
                # embedding(weight, idx) and index(src, idx) read the rows taken
                if sid(ins[0]) in resident:
                    census.bytes += sum(o.numel() * o.element_size() for o in outs)
                ins = ins[1:]
            for t in ins:
                if sid(t) in resident:
                    census.bytes += _read_bytes(t)
            return out

    return _Mode()


def _to_meta(tree, lead: int | None = None):
    """`tree` (a tensor or a dataclass of them) with every tensor replaced
    by an empty meta tensor of its shape (its leading axis `lead` long
    where given: a layer stack cut to `lead` layers), dtype and strides."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        shape = tree.shape if lead is None else (lead, *tree.shape[1:])
        return torch.empty_strided(shape, tree.stride(), dtype=tree.dtype, device="meta")
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _to_meta(getattr(tree, f.name), lead) for f in dataclasses.fields(tree)
            if f.init})
    return tree


def _meta_mesh(engine, cfg, meta) -> tuple:
    """A mesh engine's MeshParams and MeshKV as meta tensors on a mesh of
    the same shape whose every cell is the meta device, each stage cut to
    cfg.n_layers / pp layers."""
    from ..parallel.mesh import Mesh
    from ..parallel.sharding import MeshKV, MeshParams, shard_config

    mesh = engine.mesh
    mm = Mesh(shape=mesh.shape, grid=np.full(mesh.grid.shape, meta, dtype=object))
    lead = cfg.n_layers // mesh.pp
    p = engine.params

    def one(d: dict, lead_=None, key=lambda k: k[:-1] + (meta,)):
        out = {}
        for k, v in d.items():
            out.setdefault(key(k), _to_meta(v, lead_))
        return out

    params = MeshParams(
        mesh=mm, cfg=cfg, scfg=shard_config(cfg, mm), layers=one(p.layers, lead),
        wcls=one(p.wcls), embedding=one(p.embedding, key=lambda k: meta),
        final_norm=one(p.final_norm, key=lambda k: meta))
    cache = MeshKV(mesh=mm, shards={k: _to_meta(v, lead) for k, v in engine.cache.shards.items()},
                   paged=engine.cache.paged)
    return params, cache


def _storages(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        out.add(tree.untyped_storage()._cdata)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _storages(getattr(tree, f.name), out)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _storages(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _storages(x, out)
    return out


class _MetaEngine:
    """Meta copies of one engine's tensors, cut to `n_layers` layers (the
    layer stacks and the cache along their leading axis, the config with
    them): the operands every census step runs on."""

    def __init__(self, engine, n_layers: int):
        from .graphs import StepBuffers

        self.cfg = dataclasses.replace(engine.cfg, n_layers=n_layers)
        meta = torch.device("meta")
        if engine.use_pipeline:
            self.params, self.cache = _meta_mesh(engine, self.cfg, meta)
        else:
            self.params = dataclasses.replace(_to_meta(engine.params),
                                              layers=_to_meta(engine.params.layers, n_layers))
            self.cache = _to_meta(engine.cache, n_layers)
        self.rope = _to_meta(engine.rope)
        self.table = None
        if engine.paged:
            pool = engine.page_pool
            self.table = torch.empty((engine.batch, pool.max_slots), dtype=torch.int32,
                                     device=meta)
        gr = None
        if engine.grammar is not None and engine._gr_table is not None:
            gr = _to_meta(engine._gr_table)
        self.bufs = StepBuffers(engine.batch, engine.cfg.seq_len, meta, self.table, gr)

    def resident(self, *extra) -> set:
        out = set()
        for tree in (self.params, self.rope, self.cache, self.table, self.bufs.grammar,
                     *extra):
            _storages(tree, out)
        for name in ("token", "pos", "seeds", "draws", "temperature", "topp", "step",
                     "out", "gstate"):
            _storages(getattr(self.bufs, name), out)
        for d in (self.bufs.feed, self.bufs.ids, self.bufs.gstates):
            _storages(d, out)
        return out


def _layer_extrapolated(engine, key, metas: dict):
    """`_census_step` on one and on two layers, extrapolated to the
    engine's depth: every layer of a step does the same work, so the
    census is linear in the layer count (c1 + (L - 1) * (c2 - c1), exact),
    and two shallow steps cost a fraction of a deep one."""
    # a mesh's stages each take a layer at a time: depths pp and 2 pp
    unit = engine.mesh.pp if engine.use_pipeline else 1
    L = engine.cfg.n_layers // unit
    depths = (unit, 2 * unit) if L > 1 else (unit,)
    for n in depths:
        if n not in metas:
            metas[n] = _MetaEngine(engine, n)
    c1 = _census_step(engine, key, metas[unit])
    if L == 1:
        return c1
    c2 = _census_step(engine, key, metas[2 * unit])
    out = tuple(a + (L - 1) * (b - a) for a, b in zip(c1[:4], c2[:4]))
    calls = {k: c1[4].get(k, 0) + (L - 1) * (c2[4].get(k, 0) - c1[4].get(k, 0))
             for k in set(c1[4]) | set(c2[4])}
    return (*out, calls)


def census_entry(engine, key, metas: dict | None = None):
    """(flops, bytes, kernel flops, kernel bytes, kernel calls) of one
    dispatch of the program the ladder key names, from steps on meta
    tensors (see the module docstring; `metas` caches the meta copies by
    depth across calls). Raises for an unknown kind."""
    kind, size, kvb = key
    metas = {} if metas is None else metas
    if kind in ("decode", "batch_decode"):
        # the one-step graph, replayed `size` times a chunk: one census a
        # (kind, kv bucket) serves every chunk size
        steps = metas.setdefault("steps", {})
        if (kind, kvb) not in steps:
            steps[(kind, kvb)] = _layer_extrapolated(engine, (kind, 1, kvb), metas)
        c = steps[(kind, kvb)]
        return (*(x * size for x in c[:4]), {k: n * size for k, n in c[4].items()})
    return _layer_extrapolated(engine, key, metas)


def _census_step(engine, key, meta: _MetaEngine):
    """One step of `key`'s program on `meta`'s tensors under a census:
    (flops, bytes, kernel flops, kernel bytes, kernel calls)."""
    from ..models import forward
    from ..ops import census as census_mod
    from .batch_session import batch_decode_step, prefill_row
    from .decode import decode_step, verify_step
    from .paged_kv import copy_page, gather_pages, scatter_pages
    from .prefix_cache import (
        copy_prefix_into_row, copy_prefix_into_rows, extract_prefix_from_row,
    )

    kind, size, kvb = key
    m = meta
    cfg, b, ps = m.cfg, engine.batch, engine.page_size
    dev = torch.device("meta")
    extra = ()
    L, h, d = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    seg_dtype = torch.float32 if cfg.kv_quantized else m.cache.k.dtype
    if kind in ("prefix_copy", "prefix_copy_row", "page_insert"):
        seg = torch.empty((L, size, h, d), dtype=seg_dtype, device=dev)
        if engine.use_pipeline and kind != "page_insert":
            # a mesh entry's slice: one block a (pp, tp) shard
            mesh = engine.mesh
            seg = {(p, t): torch.empty((L // mesh.pp, size, h // mesh.tp, d), dtype=seg_dtype,
                                       device=dev)
                   for p in range(mesh.pp) for t in range(mesh.tp)}
        extra = (seg,)
    if kind in ("verify", "verify_row"):
        m.bufs.verify(size)
    resident = m.resident(*extra)

    def toks(rows):
        return torch.empty((rows, size), dtype=torch.long, device=dev)

    def step():
        if kind == "prefill":
            # a chunk ending at its kv bucket: attention reads the bucket
            forward(cfg, m.params, m.rope, m.cache, toks(b), kvb - size, kv_len=kvb,
                    page_table=m.table, page_size=ps)
        elif kind == "prefill_row":
            if engine.use_pipeline:
                # the mesh's admission chunk: the full batch, rows parked
                pos = torch.full((b,), kvb - size, dtype=torch.long, device=dev)
                forward(cfg, m.params, m.rope, m.cache, toks(b), pos, kv_len=kvb,
                        page_table=m.table, page_size=ps)
            elif engine.paged:
                forward(cfg, m.params, m.rope, m.cache, toks(1), kvb - size, kv_len=kvb,
                        page_table=m.table[:1], page_size=ps)
            else:
                prefill_row(cfg, m.params, m.rope, m.cache, toks(1), kvb - size, 0, kvb)
        elif kind == "decode":
            decode_step(cfg, m.params, m.rope, m.cache, m.bufs, kvb, ps, sampler="greedy")
        elif kind == "batch_decode":
            batch_decode_step(cfg, m.params, m.rope, m.cache, m.bufs, kvb, ps,
                              sampler="greedy")
        elif kind in ("verify", "verify_row"):
            verify_step(cfg, m.params, m.rope, m.cache, m.bufs, size, kvb, ps,
                        per_row=kind == "verify_row")
        elif kind == "prefix_extract":
            extract_prefix_from_row(m.cache, 0, size)
        elif kind == "prefix_copy":
            copy_prefix_into_rows(m.cache, extra[0], extra[0])
        elif kind == "prefix_copy_row":
            copy_prefix_into_row(m.cache, extra[0], extra[0], 0)
        elif kind == "page_copy":
            copy_page(m.cache, 0, 1)
        elif kind == "page_extract":
            gather_pages(m.cache, list(range(size // ps)))
        elif kind == "page_insert":
            scatter_pages(m.cache, extra[0], extra[0], list(range(size // ps)))
        else:
            raise ValueError(f"unknown warm-plan kind {kind!r}")

    with census_mod.counting() as c, _census_mode(c, resident):
        step()
    return c.flops, c.bytes, c.kernel_flops, c.kernel_bytes, dict(c.kernels)


def build_cost_table(engine, plan=None) -> CostTable:
    """A census of every program in `plan` (default: the engine's full
    `cost_plan()`, JAX's warm ladder). Runs on meta tensors: host work
    only, nothing on the card, the engine's state untouched; call it at
    warmup, lazily from a cold endpoint, or over a partial plan."""
    entries: dict = {}
    failures: dict = {}
    partial = plan is not None
    plan = engine.cost_plan() if plan is None else list(plan)
    metas: dict = {}
    for key in plan:
        key = tuple(key)
        if key in entries or key in failures:
            continue
        kind, size, kvb = key
        try:
            flops, nbytes, k_flops, k_bytes, calls = census_entry(engine, key, metas)
            entries[key] = CostEntry(
                kind=kind, size=size, kv_len=kvb, flops=flops, bytes_accessed=nbytes,
                kernel_flops=k_flops, kernel_bytes=k_bytes, kernel_calls=calls,
                tokens=entry_tokens(engine, kind, size),
            )
        except Exception as e:  # recorded, surfaced by the coverage audit
            failures[key] = f"{type(e).__name__}: {e}"
    return CostTable(entries, failures, partial=partial)


def cost_problems(engine, table=None) -> list:
    """Every ladder program must have a cost entry (build failures count
    as missing). Returns problem strings; empty means full coverage."""
    table = engine.cost_table() if table is None else table
    return table.coverage_problems(engine.cost_plan())


def format_cost_table(table: CostTable) -> str:
    lines = ["💰 warm-ladder cost table:"]
    for key in sorted(table.entries):
        e = table.entries[key]
        lines.append(
            f"  {e.kind}[{e.size}|kv{e.kv_len}]: "
            f"{e.flops / 1e6:.1f} MFLOP, {e.bytes_accessed / 1e6:.1f} MB "
            f"accessed ({e.bytes_per_token:.0f} B/token)"
        )
    for key, why in sorted(table.failures.items()):
        lines.append(f"  ! {key[0]}[{key[1]}|kv{key[2]}]: FAILED — {why}")
    return "\n".join(lines)


# -- HBM ledger --------------------------------------------------------------


def _device_memory_stats(engine) -> dict | None:
    """The card's measured bytes for this engine's device: in use = the
    caching allocator's reserved bytes (live tensors, the CUDA graph pool
    and spare cached segments), limit and free from ``mem_get_info``.
    None on the CPU, as XLA:CPU reports nothing. ``mem_get_info`` is a CUDA
    call off the device-owning thread: it runs under CAPTURE_LOCK."""
    dev = getattr(engine, "device", None)
    if dev is None or dev.type != "cuda":
        return None
    from .graphs import CAPTURE_LOCK

    stats = torch.cuda.memory_stats(dev)
    with CAPTURE_LOCK:
        free, total = torch.cuda.mem_get_info(dev)
    return {
        "bytes_in_use": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_limit": int(total) or None,
        "bytes_free": int(free),
    }


def hbm_ledger(engine) -> dict:
    """Modeled per-component device bytes, reconciled against the card's
    measured numbers where there are any. Reads tensor metadata and the
    allocator's counters only."""
    components = {
        "weights": _tree_bytes(engine.params),
        "rope": _tree_bytes(engine.rope),
        "kv_cache": _tree_bytes(engine.cache),
    }
    pc = engine.prefix_cache
    if pc is not None and not getattr(pc, "paged", False):
        # paged entries own no storage: their bytes are pool pages, counted
        # under kv_cache already
        components["prefix_cache"] = pc.total_bytes
    draft_eng = getattr(engine.draft_source, "engine", None)
    if draft_eng is not None:
        components["draft_engine"] = (
            _tree_bytes(draft_eng.params) + _tree_bytes(draft_eng.cache)
            + _tree_bytes(draft_eng.rope)
        )
    modeled = sum(components.values())
    out = {
        "components": components,
        "modeled_bytes": modeled,
        "measured_bytes": None,
        "limit_bytes": None,
        "headroom_bytes": None,
        "unattributed_bytes": None,
    }
    tier = getattr(engine, "kv_tier", None)
    if tier is not None:
        # host RAM, not device memory: a sibling section, never a component
        out["host_tier"] = tier.memory_snapshot()
    measured = _device_memory_stats(engine)
    if measured is not None:
        out["measured_bytes"] = measured["bytes_in_use"]
        out["unattributed_bytes"] = measured["bytes_in_use"] - modeled
        if measured["bytes_limit"]:
            out["limit_bytes"] = measured["bytes_limit"]
            out["headroom_bytes"] = measured["bytes_free"]
    return out


def _drift_threshold_bytes() -> int:
    try:
        return int(float(os.environ.get("DLT_HBM_DRIFT_MB", 64))) * 1024 * 1024
    except ValueError:
        return 64 * 1024 * 1024


#: serializes the read-modify-write of engine._hbm_drift_base: concurrent
#: /metrics scrapes must count one residual excursion exactly once
_DRIFT_LOCK = threading.Lock()


def reconcile_hbm(engine, ledger: dict | None = None) -> dict:
    """The leak detector: the first reconcile baselines the measured-minus-
    modeled residual (the graph pool, the allocator's spare segments, the
    grammar table: bytes the model does not itemize); later ones count
    residual GROWTH beyond ``DLT_HBM_DRIFT_MB`` as a drift event
    (``hbm_drift_events``). Shrinkage re-baselines. A rebuild's fresh
    engine starts its own baseline. No-op where nothing is measured."""
    ledger = hbm_ledger(engine) if ledger is None else ledger
    un = ledger.get("unattributed_bytes")
    if un is None:
        return {"drift_bytes": 0, "tripped": False}
    with _DRIFT_LOCK:
        base = getattr(engine, "_hbm_drift_base", None)
        if base is None or un < base:
            engine._hbm_drift_base = base = un
        drift = un - base
        tripped = drift > _drift_threshold_bytes()
        if tripped:
            engine.stats.incr("hbm_drift_events")
            engine._hbm_drift_base = un  # re-arm: count each excursion once
    return {"drift_bytes": drift, "tripped": tripped}


# -- live roofline / MFU / SLO -----------------------------------------------

_SERIES_RE = re.compile(r"^([a-z_]+)\[(\d+)\]$")

#: StepStats series that are whole-chunk walls, mapped to their cost-table
#: kind(s) and the size offset from the series' bracket number
#: (spec_verify[k] walls belong to the (k+1)-token verify program)
_SERIES_KINDS = {
    "decode": (("decode", 0),),
    "batch_decode": (("batch_decode", 0),),
    "spec_verify": (("verify", 1), ("verify_row", 1)),
}

#: series whose all-time totals count toward the duty-cycle gauge
_BUSY_RE = re.compile(
    r"^(?:decode|batch_decode|spec_verify|prefill_dispatch)\[\d+\]$"
    r"|^prefill_sync$"
)


def roofline_view(engine, table: CostTable):
    """(gauges, labeled_series) joining the cost table with the recorded
    per-program walls: the recent-window p50 wall, the shallowest-kv cost
    variant (a conservative floor)."""
    gauges: dict = {}
    series: dict = {}
    prog_gbs: list = []
    prog_tflops: list = []
    w_flops = w_bytes = w_us = 0.0
    busy_us = 0.0
    for name, s in sorted(list(engine.stats.series.items())):
        if s.count and _BUSY_RE.match(name):
            busy_us += s.total_us
        m = _SERIES_RE.match(name)
        if not m or m.group(1) not in _SERIES_KINDS or s.count == 0:
            continue
        entry = None
        for kind, off in _SERIES_KINDS[m.group(1)]:
            entry = table.lookup(kind, int(m.group(2)) + off)
            if entry is not None:
                break
        if entry is None:
            continue
        p = engine.stats.percentiles(name)
        p50_us = p.get("p50", 0.0)
        if p50_us <= 0:
            continue
        sec = p50_us / 1e6
        prog_gbs.append(({"program": name}, round(entry.bytes_accessed / sec / 1e9, 2)))
        prog_tflops.append(({"program": name}, round(entry.flops / sec / 1e12, 4)))
        n = len(s.recent)
        w_flops += n * entry.flops
        w_bytes += n * entry.bytes_accessed
        w_us += n * p50_us
    if prog_gbs:
        series["program_gb_s"] = prog_gbs
        series["program_tflop_s"] = prog_tflops
    if w_us > 0:
        gauges["mfu"] = round((w_flops / (w_us / 1e6)) / peak_flops(), 4)
        gauges["bw_utilization"] = round((w_bytes / (w_us / 1e6)) / peak_hbm_bytes_s(), 4)
    elapsed_us = (time.perf_counter() - engine._t_start) * 1e6
    if elapsed_us > 0 and busy_us > 0:
        gauges["device_duty_cycle"] = round(min(busy_us / elapsed_us, 1.0), 4)
    return gauges, series


def _slo_ms(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def slo_gauges(stats) -> dict:
    """SLO attainment from the cumulative TTFT/TPOT histograms: the
    fraction of observations at or under the target, read at the largest
    histogram bound <= the target (a conservative floor)."""
    out: dict = {}
    hists = stats.hists_snapshot()
    for hname, env, default, gauge in (
        ("ttft_ms", "DLT_SLO_TTFT_MS", 1000.0, "slo_ttft_attainment"),
        ("tpot_ms", "DLT_SLO_TPOT_MS", 100.0, "slo_tpot_attainment"),
    ):
        snap = hists.get(hname)
        if not snap or not snap["count"]:
            continue
        slo = _slo_ms(env, default)
        cum = 0
        for bound, c in snap["buckets"]:
            if isinstance(bound, str) or bound > slo:
                break
            cum = c
        out[gauge] = round(cum / snap["count"], 4)
        out[gauge.replace("attainment", "target_ms")] = slo
    return out


def slo_class_series(stats) -> dict:
    """Per-SLO-class attainment rows from the labeled ``ttft_ms{slo_class=
    ...}`` / ``tpot_ms{...}`` histograms."""
    from .tracing import split_labeled_key

    out: dict = {}
    hists = stats.hists_snapshot()
    for base_name, env, default, gauge in (
        ("ttft_ms", "DLT_SLO_TTFT_MS", 1000.0, "slo_ttft_attainment"),
        ("tpot_ms", "DLT_SLO_TPOT_MS", 100.0, "slo_tpot_attainment"),
    ):
        slo = _slo_ms(env, default)
        rows = []
        for key, snap in sorted(hists.items()):
            base, labels = split_labeled_key(key)
            if base != base_name or not labels or "slo_class" not in labels:
                continue
            if not snap["count"]:
                continue
            cum = 0
            for bound, c in snap["buckets"]:
                if isinstance(bound, str) or bound > slo:
                    break
                cum = c
            rows.append(({"slo_class": labels["slo_class"]}, round(cum / snap["count"], 4)))
        if rows:
            out[gauge] = rows
    return out


def metrics_view(engine):
    """Everything `/metrics` adds on top of StepStats: (flat_gauges,
    labeled_series). The roofline section appears once a cost table
    exists (serve()'s post-warmup build, or ``/debug/costs``)."""
    ledger = hbm_ledger(engine)
    rec = reconcile_hbm(engine, ledger)
    gauges = {"hbm_modeled_bytes": ledger["modeled_bytes"]}
    series = {
        "hbm_bytes": [({"component": k}, v) for k, v in sorted(ledger["components"].items())]
    }
    if ledger["unattributed_bytes"] is not None:
        series["hbm_bytes"].append(({"component": "unattributed"}, ledger["unattributed_bytes"]))
        gauges["hbm_drift_bytes"] = rec["drift_bytes"]
    if ledger["headroom_bytes"] is not None:
        gauges["hbm_headroom_bytes"] = ledger["headroom_bytes"]
    table = engine.cost_table(build=False)
    if table is not None:
        rg, rs = roofline_view(engine, table)
        gauges.update(rg)
        series.update(rs)
    # SLO attainment: one gauge family per metric, the unlabeled total row
    # plus the {slo_class} rows; the targets stay flat
    slo_flat = slo_gauges(engine.stats)
    cls_rows = slo_class_series(engine.stats)
    for gauge in ("slo_ttft_attainment", "slo_tpot_attainment"):
        total = slo_flat.pop(gauge, None)
        rows = ([({}, total)] if total is not None else []) + cls_rows.get(gauge, [])
        if rows:
            series[gauge] = rows
    gauges.update(slo_flat)
    return gauges, series


# -- bench integration -------------------------------------------------------


def bench_profile(engine, final_pos: int | None = None) -> dict:
    """A run's device profile: a PARTIAL cost table over exactly the
    decode/verify programs its series recorded, and the ledger and
    roofline numbers."""
    kvb = engine._kv_bucket(final_pos if final_pos is not None else engine.cfg.seq_len)
    plan = []
    for name in list(engine.stats.series):
        m = _SERIES_RE.match(name)
        if not m or m.group(1) not in _SERIES_KINDS:
            continue
        for kind, off in _SERIES_KINDS[m.group(1)]:
            size = int(m.group(2)) + off
            if kind in ("verify", "verify_row") and (
                engine.spec_mode is None or engine.batch <= 1 and kind == "verify_row"
            ):
                continue
            plan.append((kind, size, max(kvb, size)))
    table = build_cost_table(engine, plan=plan)
    if engine._cost_table is None:
        engine._cost_table = table
    gauges, _ = roofline_view(engine, table)
    ledger = hbm_ledger(engine)
    out = {
        "dlt_mfu": gauges.get("mfu"),
        "dlt_bw_utilization": gauges.get("bw_utilization"),
        "hbm_modeled_gb": round(ledger["modeled_bytes"] / 1e9, 3),
        "hbm_components_gb": {k: round(v / 1e9, 3) for k, v in ledger["components"].items()},
    }
    dchunk = table.lookup("decode", engine.decode_chunk_size)
    if dchunk is not None:
        out["decode_bytes_per_token_modeled"] = round(dchunk.bytes_per_token, 1)
        out["decode_flops_per_token_modeled"] = round(dchunk.flops_per_token, 1)
    return out


# -- on-demand profiler capture ----------------------------------------------


def _all_threads() -> dict:
    """The profiler's option to record every thread's CPU ops, not only
    the capturing (handler) thread's, where this torch has it; the CUDA
    activity (kernels, graph replays, copies) is the whole process's
    either way."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


class ProfileBusy(RuntimeError):
    """A capture is already in flight — the profiler is process-wide, so
    overlapping windows would corrupt each other's traces."""


class ProfilerCapture:
    """Single-flight ``torch.profiler`` window around live serving. The
    capture blocks only its caller (the ``/debug/profile`` handler
    thread); serving threads keep running and their work lands in the
    trace: on the card the CUDA activity (kernels, graph launches), on
    any device the CPU ops the profiler sees. The profiler starts and
    stops under CAPTURE_LOCK, never beside a graph capture."""

    MIN_MS, MAX_MS = 10, 30000

    def __init__(self):
        self._lock = threading.Lock()
        self.last: dict | None = None

    @staticmethod
    def _dir() -> str:
        return os.environ.get("DLT_PROFILE_DIR") or os.path.join(
            tempfile.gettempdir(), "dlt-profiles"
        )

    def capture(self, ms: int) -> dict:
        from torch.profiler import ProfilerActivity, profile

        from .graphs import CAPTURE_LOCK

        ms = max(self.MIN_MS, min(int(ms), self.MAX_MS))
        if not self._lock.acquire(blocking=False):
            raise ProfileBusy("a profile capture is already in flight")
        try:
            path = os.path.join(self._dir(), f"capture-{int(time.time() * 1000)}-{os.getpid()}")
            os.makedirs(path, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            t0 = time.perf_counter()
            prof = profile(activities=activities, **_all_threads())
            with CAPTURE_LOCK:
                prof.__enter__()
            try:
                time.sleep(ms / 1000.0)
            finally:
                with CAPTURE_LOCK:
                    prof.__exit__(None, None, None)
            trace = os.path.join(path, "trace.json")
            prof.export_chrome_trace(trace)
            files = sorted(
                os.path.relpath(f, path)
                for f in glob.glob(os.path.join(path, "**", "*"), recursive=True)
                if os.path.isfile(f)
            )
            self.last = {
                "path": path,
                "requested_ms": ms,
                "wall_ms": round((time.perf_counter() - t0) * 1e3, 1),
                "files": files,
                "perfetto_trace": trace,
            }
            return self.last
        finally:
            self._lock.release()


PROFILER = ProfilerCapture()


def capture_profile(ms: int) -> dict:
    """Run one bounded profiler window on the process singleton (the
    ``/debug/profile`` endpoint's backend). Raises :class:`ProfileBusy`
    when a window is already open."""
    return PROFILER.capture(ms)
