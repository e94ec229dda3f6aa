"""Q40 matmul kernels: K1 (Q80 x Q40 integer dot, <= 8 rows) and K2
(bf16-dequant GEMM, prefill rows), each beside its plain PyTorch version.

K1 `q40_gemv_q80` (csrc/q40_gemv.cu) replaces the JAX package's
`ops/pallas_q40.py:q40_matmul_pallas_stacked_i8` (:725) and
`q40_matmul_pallas_i8` (:686), body `_kernel_fs_i8` (:591), prologue
`_quantize_rows_q80_split` (:506). Math, per activation row r:

  1. Q80-quantize the row per 32-block, in f32: scale = amax / 127,
     int8 = clip(rint(x * (1 / scale)), -127, 127) (half to even), and the
     dequant scale is the f16-rounded scale; bsum = the block's int8 sum.
  2. The exact integer dot of the int8 row with the weight's unsigned
     nibbles u = v + 8, then `partial - 8 * bsum` (= the signed dot).
  3. out = sum over blocks of (partial - 8 * bsum) * (xs * d), in f32.

The integer partials are bit-exact against the Pallas kernel; only the
order of the f32 block sums differs.

K2 `q40_gemm_bf16` (csrc/q40_gemm.cu) replaces
`ops/pallas_q40.py:q40_matmul_pallas_stacked` (:253), body
`_dequant_dot_accum` (:160): w = bf16((u - 8) * bf16(scale)), one rounding,
then x (cast to bf16) @ w with f32 accumulation.

K1-indexed `q40_gemv_q80_indexed` (csrc/q40_gemv.cu) is K1's per-row
function for the MoE decode experts: B1 as the JAX package's
`models/transformer.py:_moe_decode_i8` calls it, with a flat `layer * E +
expert` index that stays on the device. Row r (or one row shared by every
slot) runs against group idx[r]; one launch covers all slots.

K4 `q40_grouped_gemm_bf16` (csrc/q40_grouped_gemm.cu) replaces
`ops/pallas_q40.py:q40_matmul_pallas_grouped` (:779), body
`_kernel_grouped` (:772): K2's math on row block i against group
block_expert[i] of a flat expert stack (MoE prefill).

Every wrapper takes its plain version for a tensor on the CPU, launches its
kernel for a tensor on the card (or raises), and counts its launches in a
plain int attribute `launches`, incremented where it launches and nowhere
else.
"""

from __future__ import annotations

import torch

from ..formats.quants import Q_BLOCK
from . import kernels
from .quant import _f32_matmul, unpack_q

MAX_I8_ROWS = 8

GROUPED_BLOCK_ROWS = (8, 16, 32, 64)

_GEMV_SIG = {
    # x, x_is_bf16, q, d, out, rows, in, out, layer, x8, xs, bs, stream
    "q40_gemv_q80": (
        kernels.P, kernels.I, kernels.P, kernels.P, kernels.P,
        kernels.I, kernels.I, kernels.I, kernels.LL,
        kernels.P, kernels.P, kernels.P, kernels.P,
    ),
    # x, x_is_bf16, x_rows, q, d, idx, n_slots, n_groups, out, in, out,
    # x8, xs, bs, stream
    "q40_gemv_q80_indexed": (
        kernels.P, kernels.I, kernels.I, kernels.P, kernels.P, kernels.P,
        kernels.I, kernels.LL, kernels.P, kernels.I, kernels.I,
        kernels.P, kernels.P, kernels.P, kernels.P,
    ),
}
_GROUPED_SIG = {
    # x (bf16), q, d, block_group, n_blocks, n_groups, out, block_r, in,
    # out, stream
    "q40_grouped_gemm_bf16": (
        kernels.P, kernels.P, kernels.P, kernels.P, kernels.I, kernels.LL,
        kernels.P, kernels.I, kernels.I, kernels.I, kernels.P,
    ),
}
_GEMM_SIG = {
    # x (bf16), q, d, out, rows, in, out, layer, stream
    "q40_gemm_bf16": (
        kernels.P, kernels.P, kernels.P, kernels.P,
        kernels.I, kernels.I, kernels.I, kernels.LL, kernels.P,
    ),
}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def quantize_rows_q80(x2: torch.Tensor, nb: int):
    """[R, in] rows -> (x8 [R, nb, 32] int8 values as f32, xs [R, nb] f32
    f16-rounded scales, bs [R, nb] f32 block sums): `_quantize_rows_q80_split`
    without the TPU lane layout."""
    R = x2.shape[0]
    xb = x2.reshape(R, nb, Q_BLOCK).to(torch.float32)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    scale = amax / 127.0
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    x8 = torch.clamp(torch.round(xb * inv), -127, 127)
    xs = scale.to(torch.float16).to(torch.float32).squeeze(-1)
    bs = x8.sum(dim=-1)  # small integers: exact in f32
    return x8, xs, bs


def q40_gemv_q80_plain(x: torch.Tensor, q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """K1's plain version: x [..., in] (any float dtype), q [nb*4, out]
    int32, d [nb, out] f16 -> [..., out] f32."""
    nb = q.shape[-2] // 4
    lead = x.shape[:-1]
    x8, xs, bs = quantize_rows_q80(x.reshape(-1, nb * Q_BLOCK), nb)
    u = (unpack_q(q) + 8).to(torch.float32)  # [nb, 32, out] unsigned nibbles
    # integer-valued f32 products and sums below 2^24: exact
    partial = torch.einsum("rbf,bfo->rbo", x8, u)
    pr = partial - 8.0 * bs.unsqueeze(-1)
    scale = xs.unsqueeze(-1) * d.to(torch.float32).unsqueeze(0)  # [R, nb, out]
    out = (pr * scale).sum(dim=1)
    return out.reshape(*lead, q.shape[-1])


def q40_gemm_bf16_plain(x: torch.Tensor, q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """K2's plain version: x [..., in] (cast to bf16), q [nb*4, out], d
    [nb, out] f16 -> [..., out] f32. The dequantized weight is rounded once
    to bf16: (u - 8) * bf16(scale) is exact in f32, then rounds."""
    nb = q.shape[-2] // 4
    lead = x.shape[:-1]
    sb = d.to(torch.float32).to(torch.bfloat16).to(torch.float32)
    w = (unpack_q(q).to(torch.float32) * sb.unsqueeze(1)).to(torch.bfloat16)
    w = w.reshape(nb * Q_BLOCK, q.shape[-1]).to(torch.float32)
    x2 = x.reshape(-1, nb * Q_BLOCK).to(torch.bfloat16).to(torch.float32)
    return _f32_matmul(x2, w).reshape(*lead, q.shape[-1])


def flat_groups(q: torch.Tensor, d: torch.Tensor):
    """[..., nb*4, out] / [..., nb, out] stacks -> flat [G, nb*4, out] /
    [G, nb, out] views (an [L, E, ...] expert stack becomes G = L * E groups,
    group layer * E + e)."""
    return q.reshape(-1, *q.shape[-2:]), d.reshape(-1, *d.shape[-2:])


def q40_gemv_q80_indexed_plain(x, q, d, idx) -> torch.Tensor:
    """K1-indexed's plain version: row r of x [R, in] (or its one row) times
    group idx[r] of the flat stack, K1's math per row -> [len(idx), out] f32.
    The slots' groups are gathered on the device, so nothing reads idx on
    the host."""
    qf, df = flat_groups(q, d)
    nb = qf.shape[-2] // 4
    n = idx.shape[0]
    x8, xs, bs = quantize_rows_q80(x.reshape(-1, nb * Q_BLOCK), nb)
    if x8.shape[0] == 1:  # one row shared by every slot
        x8, xs, bs = x8.expand(n, -1, -1), xs.expand(n, -1), bs.expand(n, -1)
    sel = idx.long()
    u = (unpack_q(qf[sel]) + 8).to(torch.float32)  # [n, nb, 32, out]
    partial = torch.einsum("rbf,rbfo->rbo", x8, u)  # exact, as in K1's plain
    pr = partial - 8.0 * bs.unsqueeze(-1)
    scale = xs.unsqueeze(-1) * df[sel].to(torch.float32)  # [n, nb, out]
    return (pr * scale).sum(dim=1)


def q40_grouped_gemm_bf16_plain(xp, q, d, block_expert, block_r: int) -> torch.Tensor:
    """K4's plain version: row block i of xp [R_pad, in] (cast to bf16)
    times group block_expert[i] of the flat stack, K2's rounding ->
    [R_pad, out] f32."""
    qf, df = flat_groups(q, d)
    nb = qf.shape[-2] // 4
    out_f = qf.shape[-1]
    n_blocks = xp.shape[0] // block_r
    sel = block_expert.long()
    sb = df[sel].to(torch.float32).to(torch.bfloat16).to(torch.float32)
    w = (unpack_q(qf[sel]).to(torch.float32) * sb.unsqueeze(2)).to(torch.bfloat16)
    w = w.reshape(n_blocks, nb * Q_BLOCK, out_f).to(torch.float32)
    xb = xp.reshape(n_blocks, block_r, nb * Q_BLOCK).to(torch.bfloat16).to(torch.float32)
    return _f32_matmul(xb, w).reshape(n_blocks * block_r, out_f)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_weight(q: torch.Tensor, d: torch.Tensor, x: torch.Tensor, stacked: bool):
    nd = 3 if stacked else 2
    if q.ndim != nd or d.ndim != nd:
        raise ValueError(f"expected {nd}D q/d, got {tuple(q.shape)} / {tuple(d.shape)}")
    if q.dtype != torch.int32 or d.dtype != torch.float16:
        raise TypeError(f"q must be int32 and d float16, got {q.dtype} / {d.dtype}")
    nb = q.shape[-2] // 4
    if q.shape[-2] != nb * 4 or d.shape[-2] != nb or d.shape[-1] != q.shape[-1]:
        raise ValueError(f"q {tuple(q.shape)} and d {tuple(d.shape)} disagree")
    if stacked and q.shape[0] != d.shape[0]:
        raise ValueError("q and d stack different layer counts")
    if x.shape[-1] != nb * Q_BLOCK:
        raise ValueError(f"x has {x.shape[-1]} features, the weight {nb * Q_BLOCK}")
    for name, t in (("x", x), ("q", q), ("d", d)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _layer_index(layer, n_layers: int) -> int:
    li = int(layer)
    if not 0 <= li < n_layers:
        raise IndexError(f"layer {li} out of range for a {n_layers}-layer stack")
    return li


def _q80_scratch(rows: int, nb: int, device):
    """The Q80 prologue's outputs: int8 rows, f32 block scales, int32 block
    sums."""
    return (
        torch.empty((rows, nb * Q_BLOCK), dtype=torch.int8, device=device),
        torch.empty((rows, nb), dtype=torch.float32, device=device),
        torch.empty((rows, nb), dtype=torch.int32, device=device),
    )


def _launch_gemv(x, q, d, layer: int) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    nb = q.shape[-2] // 4
    in_f = nb * Q_BLOCK
    out_f = q.shape[-1]
    rows = x.numel() // in_f
    if not 1 <= rows <= MAX_I8_ROWS:
        raise ValueError(f"q40_gemv_q80 takes 1..{MAX_I8_ROWS} rows, got {rows}")
    lib = kernels.load("q40_gemv", _GEMV_SIG)
    out = torch.empty((rows, out_f), dtype=torch.float32, device=x.device)
    x8, xs, bs = _q80_scratch(rows, nb, x.device)
    rc = lib.q40_gemv_q80(
        x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(), d.data_ptr(),
        out.data_ptr(), rows, in_f, out_f, layer,
        x8.data_ptr(), xs.data_ptr(), bs.data_ptr(), kernels.stream_of(x),
    )
    kernels.check(lib, rc, "q40_gemv_q80")
    return out.reshape(*x.shape[:-1], out_f)


def _launch_gemm(x, q, d, layer: int) -> torch.Tensor:
    nb = q.shape[-2] // 4
    in_f = nb * Q_BLOCK
    out_f = q.shape[-1]
    xb = x.reshape(-1, in_f).to(torch.bfloat16).contiguous()
    rows = xb.shape[0]
    lib = kernels.load("q40_gemm", _GEMM_SIG)
    out = torch.empty((rows, out_f), dtype=torch.float32, device=x.device)
    rc = lib.q40_gemm_bf16(
        xb.data_ptr(), q.data_ptr(), d.data_ptr(), out.data_ptr(),
        rows, in_f, out_f, layer, kernels.stream_of(x),
    )
    kernels.check(lib, rc, "q40_gemm_bf16")
    return out.reshape(*x.shape[:-1], out_f)


def _check_groups(q, d, x, index):
    """A flat or [L, E] group stack, activations and a 1-D int32 group
    index, all on one device and contiguous."""
    if q.ndim < 3 or d.ndim != q.ndim or q.shape[:-2] != d.shape[:-2]:
        raise ValueError(f"expected [..., nb*4, out] / [..., nb, out] stacks, got "
                         f"{tuple(q.shape)} / {tuple(d.shape)}")
    if not (q.is_contiguous() and d.is_contiguous()):
        raise ValueError("q and d must be contiguous")
    _check_weight(q.reshape(-1, *q.shape[-2:]), d.reshape(-1, *d.shape[-2:]), x, stacked=True)
    if index.ndim != 1 or index.dtype != torch.int32:
        raise TypeError(f"the group index must be 1-D int32, got {index.dtype} {tuple(index.shape)}")
    if index.device != x.device:
        raise ValueError(f"the group index is on {index.device}, x on {x.device}")
    if not index.is_contiguous():
        raise ValueError("the group index must be contiguous")


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def q40_gemv_q80_stacked(x, q, d, layer) -> torch.Tensor:
    """K1 on layer `layer` of an all-layers stack (B1): x [..., in] with at
    most 8 rows, q [L, nb*4, out], d [L, nb, out] -> [..., out] f32."""
    _check_weight(q, d, x, stacked=True)
    li = _layer_index(layer, q.shape[0])
    if _device_kind(x) == "cpu":
        return q40_gemv_q80_plain(x, q[li], d[li])
    out = _launch_gemv(x, q, d, li)
    q40_gemv_q80_stacked.launches += 1
    return out


q40_gemv_q80_stacked.launches = 0


def q40_gemv_q80(x, q, d) -> torch.Tensor:
    """K1 on an unstacked weight (B2, the decode logits): the same kernel at
    layer 0."""
    _check_weight(q, d, x, stacked=False)
    if _device_kind(x) == "cpu":
        return q40_gemv_q80_plain(x, q, d)
    out = _launch_gemv(x, q, d, 0)
    q40_gemv_q80.launches += 1
    return out


q40_gemv_q80.launches = 0


def q40_gemm_bf16_stacked(x, q, d, layer) -> torch.Tensor:
    """K2 on layer `layer` of an all-layers stack (B3): x [..., in] (any row
    count), q [L, nb*4, out], d [L, nb, out] -> [..., out] f32."""
    _check_weight(q, d, x, stacked=True)
    li = _layer_index(layer, q.shape[0])
    if _device_kind(x) == "cpu":
        return q40_gemm_bf16_plain(x, q[li], d[li])
    out = _launch_gemm(x, q, d, li)
    q40_gemm_bf16_stacked.launches += 1
    return out


q40_gemm_bf16_stacked.launches = 0


def q40_gemm_bf16(x, q, d) -> torch.Tensor:
    """B3's math on an unstacked weight: the JAX package's
    `q40_matmul_pallas` (B5, the wcls at more than 8 rows: perplexity and
    speculative verify). Not ported to the card yet."""
    _check_weight(q, d, x, stacked=False)
    if _device_kind(x) == "cpu":
        return q40_gemm_bf16_plain(x, q, d)
    raise NotImplementedError(
        "the unstacked bf16-dequant matmul (wcls at more than 8 rows) has no "
        "CUDA kernel yet: ROADMAP queue B, item B5"
    )


def q40_gemv_q80_indexed(x, q, d, idx) -> torch.Tensor:
    """K1 against a group index held on the device (B1's MoE arm): row r of
    x [R, in] — or x's one row, shared by every slot — times group idx[r]
    of q [..., nb*4, out], d [..., nb, out] (leading axes flatten to groups:
    [L, E] stacks take idx = layer * E + expert). idx: [n <= 8] int32 on x's
    device. Returns [n, out] f32; a group out of range gives NaN rows."""
    _check_groups(q, d, x, idx)
    n = idx.shape[0]
    nb = q.shape[-2] // 4
    in_f, out_f = nb * Q_BLOCK, q.shape[-1]
    rows = x.numel() // in_f
    if not 1 <= n <= MAX_I8_ROWS:
        raise ValueError(f"q40_gemv_q80_indexed takes 1..{MAX_I8_ROWS} slots, got {n}")
    if rows not in (1, n):
        raise ValueError(f"x has {rows} rows for {n} slots (1 shared row or one per slot)")
    if _device_kind(x) == "cpu":
        return q40_gemv_q80_indexed_plain(x, q, d, idx)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    n_groups = q.numel() // (nb * 4 * out_f)
    lib = kernels.load("q40_gemv", _GEMV_SIG)
    out = torch.empty((n, out_f), dtype=torch.float32, device=x.device)
    x8, xs, bs = _q80_scratch(rows, nb, x.device)
    rc = lib.q40_gemv_q80_indexed(
        x.data_ptr(), int(x.dtype == torch.bfloat16), rows, q.data_ptr(), d.data_ptr(),
        idx.data_ptr(), n, n_groups, out.data_ptr(), in_f, out_f,
        x8.data_ptr(), xs.data_ptr(), bs.data_ptr(), kernels.stream_of(x),
    )
    kernels.check(lib, rc, "q40_gemv_q80_indexed")
    q40_gemv_q80_indexed.launches += 1
    return out


q40_gemv_q80_indexed.launches = 0


def q40_grouped_gemm_bf16(xp, q, d, block_expert, block_r: int) -> torch.Tensor:
    """K4 (B7): row block i of xp [R_pad, in] (cast to bf16) times group
    block_expert[i] of q [..., nb*4, out], d [..., nb, out] (leading axes
    flatten to groups; [L, E] stacks take layer * E + expert). block_r is
    8, 16, 32 or 64 and divides R_pad; block_expert is [R_pad // block_r]
    int32 on xp's device. Returns [R_pad, out] f32."""
    _check_groups(q, d, xp, block_expert)
    if xp.ndim != 2:
        raise ValueError(f"xp must be [R_pad, in], got {tuple(xp.shape)}")
    if block_r not in GROUPED_BLOCK_ROWS or xp.shape[0] % block_r:
        raise ValueError(f"block_r {block_r} must be one of {GROUPED_BLOCK_ROWS} and divide "
                         f"{xp.shape[0]} rows")
    n_blocks = xp.shape[0] // block_r
    if block_expert.shape[0] != n_blocks:
        raise ValueError(f"{block_expert.shape[0]} block groups for {n_blocks} row blocks")
    if _device_kind(xp) == "cpu":
        return q40_grouped_gemm_bf16_plain(xp, q, d, block_expert, block_r)
    nb = q.shape[-2] // 4
    in_f, out_f = nb * Q_BLOCK, q.shape[-1]
    xb = xp.to(torch.bfloat16).contiguous()
    lib = kernels.load("q40_grouped_gemm", _GROUPED_SIG)
    out = torch.empty((xp.shape[0], out_f), dtype=torch.float32, device=xp.device)
    rc = lib.q40_grouped_gemm_bf16(
        xb.data_ptr(), q.data_ptr(), d.data_ptr(), block_expert.data_ptr(), n_blocks,
        q.numel() // (nb * 4 * out_f), out.data_ptr(), block_r, in_f, out_f,
        kernels.stream_of(xp),
    )
    kernels.check(lib, rc, "q40_grouped_gemm_bf16")
    q40_grouped_gemm_bf16.launches += 1
    return out


q40_grouped_gemm_bf16.launches = 0


KERNELS = (
    q40_gemv_q80_stacked, q40_gemv_q80, q40_gemm_bf16_stacked,
    q40_gemv_q80_indexed, q40_grouped_gemm_bf16,
)
