"""MoE router and grouped expert dispatch (Qwen3-MoE), one device.

The counterpart of the JAX package's `ops/moe.py`: `moe_router` (:50),
`_padded_rows_bound` (:81), `_grouped_layout_direct` (:126) and
`moe_ffn_ragged` (:184). Router semantics follow the reference graph
(src/llm.cpp:440-514, moeGateForward_F32_F32 src/nn/nn-cpu-ops.cpp:1462-1492):

    probs  = softmax(x @ gate.T)             # f32, over all experts
    topk   = top-k of probs, sorted descending
    weight = probs[topk] / sum(probs[topk])  # norm_topk_prob

`moe_ffn_ragged` runs every (token, slot) row's expert SwiGLU at once. On
the bf16 kernel path it lays the rows out grouped by expert (each group
padded to a block_r multiple, without a sort and without a host sync, and
with no allocation but the step's own: a CUDA graph captures it) and
runs the three matmuls through the grouped kernel K4
(ops/cuda_q40.py:q40_grouped_gemm_bf16), with the layer always folded into
the flat group index (the JAX package's production path; its
DLT_MOE_LAYER_FOLD switch is not kept). Off that path (f32 compute, dense
expert weights) it takes the JAX package's ragged_dot arm as a plain
per-expert torch matmul. Under expert parallelism (`ep`, JAX's `ep_axis`
:254-263, :316-354) the stacks hold one shard's experts and rows routed
elsewhere add exact zeros; the shard loop (parallel/pipeline.py) sums the
shards' partials.
"""

from __future__ import annotations

import torch

from .cuda_q40 import q40_grouped_gemm_bf16
from .quant import (
    QuantTensor, _f32_matmul, dequantize_t, q40_expert_aligned, quantize_q80_activations,
    slice_layer,
)


def moe_router(
    x: torch.Tensor, gate: torch.Tensor, n_active: int, norm_topk: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Select experts for each token. x: [..., dim]; gate: [n_experts, dim]
    f32. Returns (indices [..., n_active] int32, weights [..., n_active]
    f32). The logits are an f32 product with TF32 off."""
    lead = x.shape[:-1]
    logits = _f32_matmul(x.reshape(-1, x.shape[-1]).to(torch.float32), gate.to(torch.float32).t())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, n_active, dim=-1, sorted=True)
    if norm_topk:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return top_i.to(torch.int32).reshape(*lead, n_active), top_p.reshape(*lead, n_active)


def _padded_rows_bound(rows: int, n_groups: int, block_r: int) -> int:
    """Static bound on the expert-grouped padded row count (the grouped
    kernel's row extent): each nonempty group wastes at most block_r - 1
    pad rows and at most min(n_groups, rows) groups are nonempty; rounded
    up to a block_r multiple."""
    bound = rows + min(n_groups, rows) * (block_r - 1)
    return -(-bound // block_r) * block_r


def _grouped_layout_direct(g_flat: torch.Tensor, n_groups: int, block_r: int):
    """Sort-free grouped layout: for each original row r (group g_flat[r]),
    its destination in the expert-grouped padded buffer, plus each row
    block's group. A one-hot cumsum gives each row's stable rank in its
    group. Everything stays on the device: R_pad is the static bound, never
    a count read back. Returns (dest [rows] int64, block_expert [R_pad //
    block_r] int32, R_pad)."""
    rows = g_flat.shape[0]
    R_pad = _padded_rows_bound(rows, n_groups, block_r)
    groups = torch.arange(n_groups, device=g_flat.device, dtype=g_flat.dtype)
    oh = (g_flat[:, None] == groups).to(torch.int32)  # [rows, n_groups]
    within = (torch.cumsum(oh, dim=0) * oh).sum(dim=1) - 1  # stable rank
    counts = oh.sum(dim=0)
    padded_sizes = ((counts + block_r - 1) // block_r) * block_r
    padded_starts = torch.cumsum(padded_sizes, dim=0) - padded_sizes
    dest = padded_starts[g_flat.long()] + within
    blocks = torch.arange(R_pad // block_r, device=g_flat.device, dtype=padded_starts.dtype) * block_r
    block_expert = torch.searchsorted(padded_starts, blocks, right=True) - 1
    block_expert = torch.clamp(block_expert, 0, n_groups - 1).to(torch.int32)
    return dest.long(), block_expert, R_pad


def ep_local_route(idx: torch.Tensor, wts: torch.Tensor, ep) -> tuple:
    """The route an ep shard holding experts e0 .. e0 + n_local runs (JAX's
    `ep_axis` arms, transformer.py:228-250, ops/moe.py:254-263): slots
    routed to another shard are clamped to a local expert and
    zero-weighted, so every arm (K4, K1-indexed, the gather and plain
    arms) gives them an exact zero, and indices stay in range."""
    e0, n_local = ep
    local = idx - e0
    valid = (local >= 0) & (local < n_local)
    return local.clamp(0, n_local - 1), wts * valid.to(wts.dtype)


def _grouped_block_rows(rows: int, n_groups: int) -> int:
    """block_r from static counts (the JAX package's moe.py:286-289): about
    rows per group, a power of two in [8, 64]."""
    avg = max(1, rows // max(n_groups, 1))
    block_r = 8
    while block_r * 2 <= min(avg, 64):
        block_r *= 2
    return block_r


def grouped_eligible(w1, w3, w2, dtype, q80: bool = False) -> bool:
    """The grouped kernel serves bf16 compute on Q40 expert stacks with the
    expert kernels' alignment (the JAX package's _grouped_quant_eligible,
    there at nb % 8 == 0; `q40_expert_aligned`);
    the rest, and the q80 parity mode, take the plain per-expert arm."""
    return not q80 and dtype == torch.bfloat16 and all(
        isinstance(w, QuantTensor) and q40_expert_aligned(w.in_features, w.out_features)
        for w in (w1, w3, w2)
    )


def _expert_matrix(w, e: int, dtype) -> torch.Tensor:
    """Expert e's [in, out] matrix in `dtype` from an [E, ...] stack."""
    if isinstance(w, QuantTensor):
        return dequantize_t(QuantTensor(q=w.q[e], d=w.d[e]), dtype)
    return w[e].to(dtype).t()


def moe_ffn_ragged(
    y: torch.Tensor,  # [b, t, dim] normed activations
    idx: torch.Tensor,  # [b, t, k] int32 expert ids (moe_router)
    wts: torch.Tensor,  # [b, t, k] f32 combine weights
    w1,
    w3,
    w2,  # expert stacks: [E, ...], or with `layer` the full [L, E, ...]
    act_fn,
    dtype,  # matmul operand dtype
    layer: int | None = None,
    q80: bool = False,  # the reference-parity Q80 round trip of the inputs
    exact_scale: bool = False,  # K4 forms the weights as the gather arm does
) -> torch.Tensor:
    """Exact top-k expert SwiGLU for all rows at once: for every (token,
    slot) row, h = act(y @ w1[e]) * (y @ w3[e]); out = sum_k wts * (h @
    w2[e]), the slots summed in f32. With `q80` the plain arm takes the
    rows' inputs and h through Q80 (JAX :345-347). `exact_scale`: K4's
    weights are bf16(f32(scale) * (u - 8)), the JAX gather arm's, where
    this serves a chunk JAX gathers (`models/transformer.py:_moe_ffn`).
    Under expert parallelism the route comes through `ep_local_route`
    first."""
    b, t, dim = y.shape
    k = idx.shape[-1]
    n_tok = b * t
    rows = n_tok * k
    e_flat = idx.reshape(rows)
    n_groups = (w1.q if isinstance(w1, QuantTensor) else w1).shape[-3]  # experts a layer

    if grouped_eligible(w1, w3, w2, dtype, q80):
        block_r = _grouped_block_rows(rows, n_groups)
        dest, block_expert, R_pad = _grouped_layout_direct(e_flat, n_groups, block_r)
        if layer is not None:
            # the kernel indexes the flat all-layers stack: no layer slice
            block_expert = block_expert + int(layer) * n_groups
        # row r = token r // k, in the kernel's bf16 (pad rows stay zero)
        xrep = y.reshape(n_tok, dim).repeat_interleave(k, dim=0)
        xp = torch.zeros((R_pad, dim), dtype=torch.bfloat16, device=y.device)
        xp[dest] = xrep.to(torch.bfloat16)

        def gdot(x_, w_):
            return q40_grouped_gemm_bf16(x_, w_.q, w_.d, block_expert, block_r, exact_scale)

        h = (act_fn(gdot(xp, w1)) * gdot(xp, w3)).to(y.dtype)
        per_row = gdot(h, w2)[dest].reshape(n_tok, k, dim)  # original order
        out = (per_row * wts.reshape(n_tok, k, 1).to(torch.float32)).sum(dim=1)
        return out.reshape(b, t, dim).to(y.dtype)

    # plain arm (f32 compute, dense experts): the JAX package's sort +
    # ragged_dot, as one matmul per expert that has rows (one host read of
    # the counts; this arm is not on the bf16 kernel path)
    if layer is not None:
        w1, w3, w2 = (slice_layer(w, layer) for w in (w1, w3, w2))
    order = torch.argsort(e_flat, stable=True)
    counts = torch.bincount(e_flat.long(), minlength=n_groups).tolist()
    xs = y.reshape(n_tok, dim)[order // k]
    if q80:
        xs = quantize_q80_activations(xs)
    xs = xs.to(dtype).to(torch.float32)
    out_rows = torch.empty((rows, dim), dtype=torch.float32, device=y.device)
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        xe = xs[start : start + n]
        h = act_fn(_f32_matmul(xe, _expert_matrix(w1, e, dtype).to(torch.float32)))
        h = (h * _f32_matmul(xe, _expert_matrix(w3, e, dtype).to(torch.float32))).to(y.dtype)
        if q80:
            h = quantize_q80_activations(h)
        hd = h.to(dtype).to(torch.float32)
        out_rows[start : start + n] = _f32_matmul(hd, _expert_matrix(w2, e, dtype).to(torch.float32))
        start += n
    per_row = torch.empty_like(out_rows)
    per_row[order] = out_rows
    per_row = per_row.reshape(n_tok, k, dim)
    out = (per_row * wts.reshape(n_tok, k, 1).to(torch.float32)).sum(dim=1)
    return out.reshape(b, t, dim).to(y.dtype)
