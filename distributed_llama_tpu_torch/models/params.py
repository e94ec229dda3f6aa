"""Parameters, the KV cache, and the `.m` weight loader.

Weights for all layers are stacked along a leading n_layers axis, as in the
JAX package (models/params.py there), so a per-layer matmul selects its
layer inside the kernel by offsetting a base pointer. q/k/v always fuse into
`wqkv` and dense w1/w3 into `w13`, in the tp=1 concat order (q|k|v, w1|w3)
of the JAX package's `_fuse_rows`: 7 matmuls per layer become 4. A MoE
model's experts stay separate, as there: w1, w3 and w2 are [L, E, ...]
stacks (a kernel folds layer and expert into one flat index), w13 is None,
and the router `moe_gate` [L, E, dim] stays f32.

Q40 tensors stay quantized on the device as `QuantTensor`s in the packed T
layout (ops/quant.py); the embedding and the norms stay f32 (the reference
keeps both f32), and a dense 2D weight of a non-Q40 file takes the compute
dtype.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..formats.mfile import MFileReader, TensorSpec
from ..formats.quants import FloatType
from ..ops.quant import QuantTensor, q40_bytes_to_t_layout
from .config import ModelConfig

# A weight is either a dense tensor [..., out, in] or a QuantTensor.
Weight = Any


@dataclass
class LayerParams:
    """Per-layer weights, each stacked with a leading [n_layers] axis."""

    wqkv: Weight  # [L, q_dim + 2*kv_dim, dim] fused projection
    wo: Weight  # [L, dim, q_dim]
    w13: Weight  # [L, 2*ff, dim] fused dense ffn in-projection; None for MoE
    w2: Weight  # [L, dim, ff]; MoE: [L, E, dim, ff]
    norm0: torch.Tensor  # [L, dim] f32
    norm1: torch.Tensor  # [L, dim] f32
    q_norm: Optional[torch.Tensor] = None  # [L, head_dim] (qwen3)
    k_norm: Optional[torch.Tensor] = None  # [L, head_dim] (qwen3)
    w1: Weight = None  # MoE: [L, E, ff, dim] expert stack
    w3: Weight = None  # MoE: [L, E, ff, dim] expert stack
    moe_gate: Optional[torch.Tensor] = None  # MoE: [L, E, dim] f32 router


@dataclass
class ModelParams:
    embedding: torch.Tensor  # [vocab, dim] f32
    layers: LayerParams
    final_norm: torch.Tensor  # [dim] f32
    wcls: Weight  # [vocab, dim]


@dataclass
class KVCache:
    """[n_layers, batch, seq_len, n_kv_heads, head_dim] key/value tensors
    (the contiguous layout), or the paged layout's page pools [n_layers,
    pages, page_size, n_kv_heads, head_dim] (runtime/paged_kv.py). The int8
    arm adds f32 scale sidecars of the same shape without head_dim
    (ops/kv_quant.py); float caches leave them None.

    The forward pass writes each step's rows into these tensors IN PLACE.
    (The JAX package threads the cache functionally and donates the buffer
    so that XLA updates it in place; here the update is an explicit indexed
    assignment.)"""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def seq_len(self) -> int:
        """Positions per row of the contiguous layout."""
        return self.k.shape[2]

    def tensors(self) -> tuple:
        """Every device tensor of the cache, scales included."""
        return tuple(t for t in (self.k, self.v, self.k_scale, self.v_scale) if t is not None)


def kv_cache_of_shape(cfg: ModelConfig, shape: tuple, device=None) -> KVCache:
    """Zeroed k/v of `shape` (trailing head_dim) in the cache dtype, with
    zeroed f32 scales on the int8 arm. `device=None` means the card."""
    device = resolve_device(device)
    k = torch.zeros(shape, dtype=cfg.kv_dtype, device=device)
    v = torch.zeros(shape, dtype=cfg.kv_dtype, device=device)
    if not cfg.kv_quantized:
        return KVCache(k=k, v=v)
    return KVCache(
        k=k, v=v,
        k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
    )


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int | None = None, device=None) -> KVCache:
    shape = (
        cfg.n_layers,
        batch,
        seq_len if seq_len is not None else cfg.seq_len,
        cfg.n_kv_heads,
        cfg.head_dim,
    )
    return kv_cache_of_shape(cfg, shape, device)


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def _raw_tensor(reader: MFileReader, spec: TensorSpec, device) -> torch.Tensor:
    """A tensor's file bytes as a uint8 tensor on `device` (copied out of
    the mmap, so the reader can close)."""
    host = np.frombuffer(reader.raw(spec), dtype=np.uint8).copy()
    return torch.from_numpy(host).to(device)


def _dense(reader: MFileReader, spec: TensorSpec, dtype, device) -> torch.Tensor:
    return torch.from_numpy(reader.tensor_f32(spec)).to(device=device, dtype=dtype)


def _fused_stack(reader: MFileReader, cfg: ModelConfig, roles: list[str], device) -> Weight:
    """Stack the per-layer weights of `roles` (same input, concatenated on
    the out axis in the given order) into one [L, ...] weight."""
    specs = [[reader.by_name[f"{r}.l{l}"] for r in roles] for l in range(cfg.n_layers)]
    first = specs[0]
    outs = [s.shape[0] for s in first]
    in_f = first[0].shape[1]
    total = sum(outs)
    if all(s.float_type == FloatType.Q40 for s in first):
        nb = in_f // 32
        q = torch.empty((cfg.n_layers, nb * 4, total), dtype=torch.int32, device=device)
        d = torch.empty((cfg.n_layers, nb, total), dtype=torch.float16, device=device)
        for l, layer_specs in enumerate(specs):
            col = 0
            for s in layer_specs:
                ql, dl = q40_bytes_to_t_layout(_raw_tensor(reader, s, device), s.shape[0], in_f)
                q[l, :, col : col + s.shape[0]] = ql
                d[l, :, col : col + s.shape[0]] = dl
                col += s.shape[0]
        return QuantTensor(q=q, d=d)
    w = torch.empty((cfg.n_layers, total, in_f), dtype=cfg.dtype, device=device)
    for l, layer_specs in enumerate(specs):
        row = 0
        for s in layer_specs:
            w[l, row : row + s.shape[0]] = _dense(reader, s, cfg.dtype, device)
            row += s.shape[0]
    return w


def _expert_stacks(reader: MFileReader, cfg: ModelConfig, device) -> dict[str, Weight]:
    """The [L, E, ...] stacks of a MoE model's w1, w2 and w3. A layer's
    experts lie together in the file (w1, w2, w3 of expert 0, then of expert
    1, ...). For Q40 each layer's span goes to the device in one copy and is
    regrouped there straight into that layer's slot of the preallocated
    stacks (never a list of experts and a stack: that would hold the
    weights twice)."""
    L, E = cfg.n_layers, cfg.n_experts
    roles = ("w1", "w2", "w3")
    first = {r: reader.by_name[f"{r}.l0.e0"] for r in roles}
    if not all(s.float_type == FloatType.Q40 for s in first.values()):
        stacks = {}
        for r, s in first.items():
            w = torch.empty((L, E, *s.shape), dtype=cfg.dtype, device=device)
            for l in range(L):
                for e in range(E):
                    w[l, e] = _dense(reader, reader.by_name[f"{r}.l{l}.e{e}"], cfg.dtype, device)
            stacks[r] = w
        return stacks
    nbytes = first["w1"].n_bytes
    if any(s.n_bytes != nbytes for s in first.values()):
        raise ValueError("MoE expert tensors w1, w2 and w3 differ in size")
    stacks = {}
    for r, s in first.items():
        out_f, in_f = s.shape
        nb = in_f // 32
        stacks[r] = QuantTensor(
            q=torch.empty((L, E, nb * 4, out_f), dtype=torch.int32, device=device),
            d=torch.empty((L, E, nb, out_f), dtype=torch.float16, device=device),
        )
    for l in range(L):
        span = reader.raw_span(reader.by_name[f"w1.l{l}.e0"], reader.by_name[f"w3.l{l}.e{E - 1}"])
        raw = torch.from_numpy(np.frombuffer(span, dtype=np.uint8).copy()).to(device)
        raw = raw.reshape(E, len(roles), nbytes)
        for j, r in enumerate(roles):
            q, d = q40_bytes_to_t_layout(raw[:, j], *first[r].shape)
            stacks[r].q[l] = q
            stacks[r].d[l] = d
    return stacks


def _single(reader: MFileReader, spec: TensorSpec, cfg: ModelConfig, device) -> Weight:
    if spec.float_type == FloatType.Q40 and len(spec.shape) == 2:
        q, d = q40_bytes_to_t_layout(_raw_tensor(reader, spec, device), *spec.shape)
        return QuantTensor(q=q, d=d)
    return _dense(reader, spec, cfg.dtype if len(spec.shape) == 2 else torch.float32, device)


def _norm_stack(reader: MFileReader, cfg: ModelConfig, role: str, device) -> torch.Tensor:
    return torch.stack(
        [_dense(reader, reader.by_name[f"{role}.l{l}"], torch.float32, device) for l in range(cfg.n_layers)]
    )


def load_params(reader: MFileReader, cfg: ModelConfig, device=None) -> ModelParams:
    """Read all weights, fuse and stack them per layer, place them on
    `device` (None: the card). Q40 bytes are regrouped into the T layout on
    the device."""
    device = resolve_device(device)
    if cfg.is_moe:
        experts = _expert_stacks(reader, cfg, device)
        ffn = dict(w13=None, w2=experts["w2"], w1=experts["w1"], w3=experts["w3"],
                   moe_gate=_norm_stack(reader, cfg, "moe_gate", device))
    else:
        ffn = dict(w13=_fused_stack(reader, cfg, ["w1", "w3"], device),
                   w2=_fused_stack(reader, cfg, ["w2"], device))
    layers = LayerParams(
        wqkv=_fused_stack(reader, cfg, ["q", "k", "v"], device),
        wo=_fused_stack(reader, cfg, ["wo"], device),
        norm0=_norm_stack(reader, cfg, "norm0", device),
        norm1=_norm_stack(reader, cfg, "norm1", device),
        **ffn,
    )
    if cfg.is_qwen3:
        layers.q_norm = _norm_stack(reader, cfg, "q_norm", device)
        layers.k_norm = _norm_stack(reader, cfg, "k_norm", device)
    return ModelParams(
        embedding=_dense(reader, reader.by_name["embedding"], torch.float32, device),
        layers=layers,
        final_norm=_dense(reader, reader.by_name["final_norm"], torch.float32, device),
        wcls=_single(reader, reader.by_name["wcls"], cfg, device),
    )


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _weight_from_numpy(w, device) -> Weight:
    if w is None:
        return None
    if isinstance(w, dict):
        return QuantTensor(q=_from_numpy(w["q"], device), d=_from_numpy(w["d"], device))
    return _from_numpy(w, device)


def params_from_jax(tree: dict, device=None) -> ModelParams:
    """The JAX package's `ModelParams` -> the port's, without importing JAX,
    on `device` (None: the card; see `device.resolve_device`).

    `tree` holds numpy arrays keyed by the JAX field names:
    ``{"embedding", "final_norm", "wcls", "layers": {field: ...}}``, where a
    QuantTensor is ``{"q": ..., "d": ...}`` and an unused field is None. The
    JAX loader's fused fields (wqkv, w13) are taken as they are; its separate
    q/k/v fields must be None, and so must w1/w3 unless the tree is a MoE
    one (moe_gate set, w13 None, w1/w3/w2 the [L, E, ...] expert stacks)."""
    lt = tree["layers"]
    moe = lt.get("moe_gate") is not None
    unfused = ("q", "k", "v") if moe else ("q", "k", "v", "w1", "w3")
    for name in unfused + (("w13",) if moe else ()):
        if lt.get(name) is not None:
            kind = "MoE" if moe else "dense"
            raise ValueError(f"params_from_jax: field {name!r} is set ({kind} params keep it None)")
    device = resolve_device(device)
    kw = {f.name: _weight_from_numpy(lt.get(f.name), device) for f in fields(LayerParams)}
    return ModelParams(
        embedding=_from_numpy(tree["embedding"], device),
        layers=LayerParams(**kw),
        final_norm=_from_numpy(tree["final_norm"], device),
        wcls=_weight_from_numpy(tree["wcls"], device),
    )
