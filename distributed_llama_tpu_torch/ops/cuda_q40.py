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
order of the f32 block sums differs. One launch a call does all three: its
blocking is `gemv_plan(nb, out_f)` (words a thread loads per weight row,
column tile, warps along the contraction, split-K count; the splits of a
column tile reduce in one thread-block cluster, in split order), from the
weight's shape alone, so a row's bits do not depend on the call's other
rows or slots; `q40_gemv_q80_blocked` repeats its order of sums and equals
it bit for bit. `launch_q80_prologue` and `launch_gemv_body` launch the
first K1 design's two kernels apart, step 1 alone and step 2 alone (the
latter at any CTA tile of GEMV_TILES; that K1's was FIRST_K1_TILE), for
the kernel probe P7 (probes/int4_prod.py).

K2 `q40_gemm_bf16_stacked` (csrc/q40_gemm.cu) replaces
`ops/pallas_q40.py:q40_matmul_pallas_stacked` (:253), body
`_dequant_dot_accum` (:160): w = bf16((u - 8) * bf16(scale)), one rounding,
then x (cast to bf16) @ w with f32 accumulation. `q40_gemm_bf16` is the
same kernel on an unstacked weight and replaces `q40_matmul_pallas` (:880),
B5. Its blocking is `gemm_plan(nb, out_f)`: column tile, split-K count
(the splits of a column tile reduce in one thread-block cluster, in split
order) and ring depth, from the weight's shape alone, so a row's bits do
not depend on the call's other rows; `q40_gemm_bf16_blocked` repeats its
order of sums on the CPU.

K1-indexed `q40_gemv_q80_indexed` (csrc/q40_gemv.cu) is K1's per-row
function for the MoE decode experts: B1 as the JAX package's
`models/transformer.py:_moe_decode_i8` calls it, with a flat `layer * E +
expert` index that stays on the device. Row r (or one row shared by every
slot) runs against group idx[r]; one launch covers all slots, at the
plan of the group's shape (`q40_gemv_q80_indexed_blocked` repeats it).

B9 `q40_i8_unpacked` (csrc/q40_i8_mma.cu) replaces `ops/pallas_q40.py:_i8_call`
(:657), body `_kernel_i8` (:323): the int8 matmul over pre-quantized
activations and an UNPACKED [nb, 32, out] int8 weight, one int8 tensor-core
MMA (m16n8k32, k = one Q40 block) per block and 8 columns. out = sum over
blocks of partial * (xs * dt) in f32, partial the exact integer dot. The
same kernel template runs its tile and scale-plane sweep P13
(probes/scales.py). P2, P3, P4, P5, P6 and P9 / P10 compute the same
function as one-row GEMVs (csrc/i8_gemv.cuh, probes/gemv.py).
Not ported to the serving path: `_i8_tiles` (:439, a v5e tile table) and
`_dt_operand`/`_scale_f32` (:112-143, a Mosaic workaround: Hopper loads
f16 natively); the raw-bits convert runs in the probes only.

K4 `q40_grouped_gemm_bf16` (csrc/q40_grouped_gemm.cu) replaces
`ops/pallas_q40.py:q40_matmul_pallas_grouped` (:779), body
`_kernel_grouped` (:772): K2's math on row block i against group
block_expert[i] of a flat expert stack (MoE prefill), with the weights as
the MMA's 16-row operand and one CTA per (row block, `grouped_plan`
column tile) over the whole contraction; `q40_grouped_gemm_bf16_blocked`
repeats its order of sums on the CPU. Its `exact_scale` instances form the
weights as the JAX package's gather arm does (`dequantize_t`), for the MoE
FFN's small-row arm, where JAX gathers.

Every wrapper takes its plain version for a tensor on the CPU, launches its
kernel for a tensor on the card (or raises), and counts its launches in a
plain int attribute `launches`, incremented where it launches and nowhere
else. On ``meta`` tensors, under a cost census only (ops/census.py), it
states its call's FLOPs and bytes (`_matmul_cost`: x, one group's weight
words and scales and the f32 output, each once) and returns an empty
result of its shape.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..formats.quants import Q_BLOCK
from . import census, kernels
from .quant import _f32_matmul, unpack_q

MAX_I8_ROWS = 8

GROUPED_BLOCK_ROWS = (8, 16, 32, 64)

_GEMV_SIG = {
    # x, x_is_bf16, q, d, out, rows, in, out, layer, vec, cols, kw, splits,
    # blocks per split, stream
    "q40_gemv_q80": (
        kernels.P, kernels.I, kernels.P, kernels.P, kernels.P,
        kernels.I, kernels.I, kernels.I, kernels.LL,
        kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.P,
    ),
    # x, x_is_bf16, x_rows, q, d, idx, n_slots, n_groups, out, in, out, vec,
    # cols, kw, splits, blocks per split, stream
    "q40_gemv_q80_indexed": (
        kernels.P, kernels.I, kernels.I, kernels.P, kernels.P, kernels.P,
        kernels.I, kernels.LL, kernels.P, kernels.I, kernels.I,
        kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.P,
    ),
    # x, x_is_bf16, rows, in, x8, xs, bs, stream
    "q40_quantize_q80": (
        kernels.P, kernels.I, kernels.I, kernels.I, kernels.P, kernels.P, kernels.P, kernels.P,
    ),
    # x8, xs, bs, q, d, out, rows, in, out, cols, ksplit, stream
    "q40_gemv_body": (
        kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
        kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.P,
    ),
}
# P7's tiles (csrc/q40_gemv.cu q40_gemv_body: output columns, warps that
# split the contraction), the tile of the first K1 design (its prologue
# and this tile's body were K1's call before the cluster split-K design;
# built at 1..8 rows) and the row counts the other tiles are built at
FIRST_K1_TILE = (32, 8)
GEMV_TILES = tuple((c, k) for c in (32, 64, 128) for k in (4, 8, 16))
BODY_ROWS = (1, 8)
# K1's plan (csrc/q40_gemv.cu): warps a CTA (256 threads, all along the
# contraction), the largest split count (the portable cluster size), the
# most blocks a split stages in shared memory (40 bytes a block and row),
# the fewest blocks a split or a one-word plan's CTA should hold, the
# blocks a CTA's warps keep in flight at one word a lane, and the CTAs a
# call may reach unsplit and split (the sweep of probes/k1_ab.py: past
# them, the CTAs' fixed costs outgrow the bytes in flight they add)
GEMV_WARPS = 8
GEMV_MAX_SPLITS = 8
GEMV_MAX_BPS = 256
GEMV_MIN_BPS = 32
GEMV_FLIGHT_BLOCKS = 64
GEMV_MAX_CTAS = 256
GEMV_SPLIT_CTAS = 128
_GROUPED_SIG = {
    # x (bf16), q, d, block_group, n_blocks, n_groups, out, block_r, in,
    # out, exact_scale, cols, stream
    "q40_grouped_gemm_bf16": (
        kernels.P, kernels.P, kernels.P, kernels.P, kernels.I, kernels.LL,
        kernels.P, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.P,
    ),
}
_I8_MMA_SIG = {
    # x8, xs, qt, dt, out, part, rows, nb, out, splits, stream
    "q40_i8_mma": (
        kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
        kernels.I, kernels.I, kernels.I, kernels.I, kernels.P,
    ),
}
I8_MMA_COLS = 64  # output columns per CTA
_GEMM_SIG = {
    # x (bf16), q, d, out, rows, in, out, layer, cols, splits, blocks per
    # split, stream
    "q40_gemm_bf16": (
        kernels.P, kernels.P, kernels.P, kernels.P,
        kernels.I, kernels.I, kernels.I, kernels.LL,
        kernels.I, kernels.I, kernels.I, kernels.P,
    ),
}
# K2's plan (csrc/q40_gemm.cu): rows per CTA, Q40 blocks per ring stage
# (one per warp along the contraction), ring depth, the largest split count
# (the portable cluster size) and the CTAs a call should reach (about two
# per SM of an H100 SXM's 132)
GEMM_ROWS = 32
GEMM_STAGE_BLOCKS = 4
GEMM_STAGES = 4
GEMM_MAX_SPLITS = 8
GEMM_TARGET_CTAS = 256


@dataclass(frozen=True)
class GemmPlan:
    """K2's blocking of one weight shape: `cols` output columns per CTA,
    the contraction cut into `splits` runs of `blocks_per_split` Q40 blocks
    (the last may be shorter), reduced in split order in one thread-block
    cluster; a ring of `stages` stages of GEMM_STAGE_BLOCKS blocks."""

    cols: int
    splits: int
    blocks_per_split: int
    stages: int

    def ctas(self, out_f: int, rows: int = GEMM_ROWS) -> int:
        return -(-out_f // self.cols) * self.splits * -(-rows // GEMM_ROWS)


@dataclass(frozen=True)
class GroupedPlan:
    """K4's blocking (csrc/q40_grouped_gemm.cu): `cols` output columns per
    CTA (4 warps of cols / 4), one row block per CTA over the whole
    contraction."""

    cols: int

    def ctas(self, out_f: int, n_blocks: int) -> int:
        return -(-out_f // self.cols) * n_blocks


def grouped_plan(nb: int, out_f: int, block_r: int) -> GroupedPlan:
    """K4's plan for a weight of nb Q40 blocks by out_f columns at block_r
    rows a block: a function of the shape alone. Tiles of 128 columns
    (each column tile reads its row block's x, so wider tiles read less of
    it; a 30B-A3B chunk still has 144 row blocks x 6 or 16 tiles), 64
    where the weight has no more columns than that. No split of the
    contraction, whatever nb or block_r: a row block's sums never depend
    on another block."""
    if block_r not in GROUPED_BLOCK_ROWS or nb < 1:
        raise ValueError(f"no K4 plan for nb {nb}, block_r {block_r}")
    return GroupedPlan(64 if out_f <= 64 else 128)


def gemm_plan(nb: int, out_f: int) -> GemmPlan:
    """K2's plan for a weight of nb Q40 blocks by out_f columns: a function
    of the shape alone, never of the row count or the data, so a row's sums
    are the same in every call. Tiles of 128 columns where two splits of
    them reach GEMM_TARGET_CTAS (1B's w13, the vocab widths): every column
    tile reads its rows' x, so wider tiles halve that traffic where enough
    of them remain. Else 64. Then the fewest splits, a power of two up to
    GEMM_MAX_SPLITS, that reach the target, each split at least
    GEMM_STAGE_BLOCKS blocks."""
    cols = 128 if 2 * -(-out_f // 128) >= GEMM_TARGET_CTAS else 64
    tiles = -(-out_f // cols)
    splits = 1
    while (splits < GEMM_MAX_SPLITS and tiles * splits < GEMM_TARGET_CTAS
           and 2 * splits * GEMM_STAGE_BLOCKS <= nb):
        splits *= 2
    return GemmPlan(cols, splits, -(-nb // splits), GEMM_STAGES)


@dataclass(frozen=True)
class GemvPlan:
    """K1's blocking of one weight shape: a lane loads `vec` neighbouring
    words of each weight row (4, 8 or 16 bytes) and owns those columns; a
    CTA of GEMV_WARPS warps owns `cols` output columns, `kw` of its warps
    split its contraction range into contiguous runs; the contraction is
    cut into `splits` runs of `blocks_per_split` Q40 blocks (the last may
    be shorter), reduced in split order in one thread-block cluster."""

    vec: int
    cols: int
    kw: int
    splits: int
    blocks_per_split: int

    def ctas(self, out_f: int) -> int:
        """The CTAs a call's work takes: column tiles x splits. A call
        launches at most 2 an SM, each walking every grid-th tile."""
        return -(-out_f // self.cols) * self.splits

    def split_range(self, s: int, nb: int) -> range:
        first = s * self.blocks_per_split
        return range(first, min(nb, first + self.blocks_per_split))

    def warp_range(self, kw: int, blocks: range) -> range:
        """Warp kw's run of a split's blocks: first + kw * n // KW .."""
        n = len(blocks)
        return range(blocks.start + kw * n // self.kw, blocks.start + (kw + 1) * n // self.kw)


def gemv_plan(nb: int, out_f: int) -> GemvPlan:
    """K1's plan for a weight of nb Q40 blocks by out_f columns: a function
    of the shape alone, never of the row or slot count or the data, so a
    row's sums are the same in every call. The 8 warps of a CTA split its
    contraction range. One word a lane (32-column tiles, 8 blocks a warp in
    flight) where the fewest splits that keep a CTA's range within
    GEMV_FLIGHT_BLOCKS leave at least GEMV_MIN_BPS blocks a split and at
    most GEMV_MAX_CTAS CTAs (GEMV_SPLIT_CTAS when split): the decode
    shapes of in 2048 and 4096. Else four words a lane (128-column tiles)
    and the most splits, a power of two up to GEMV_MAX_SPLITS, that keep
    GEMV_SPLIT_CTAS CTAs and GEMV_MIN_BPS blocks a split (1B's w2 takes 8,
    w13 and the vocab widths 1). Every split non-empty and within
    GEMV_MAX_BPS blocks."""
    if nb < 1 or out_f < 1:
        raise ValueError(f"no K1 plan for nb {nb}, out_f {out_f}")
    splits = 1
    while -(-nb // splits) > GEMV_FLIGHT_BLOCKS and splits < GEMV_MAX_SPLITS:
        splits *= 2
    bps = -(-nb // splits)
    ctas = -(-out_f // 32) * splits
    if bps >= GEMV_MIN_BPS and ctas <= (GEMV_MAX_CTAS if splits == 1 else GEMV_SPLIT_CTAS):
        vec = 1
    else:
        vec, tiles = 4, -(-out_f // 128)
        splits = 1
        while (2 * splits <= GEMV_MAX_SPLITS and 2 * splits * tiles <= GEMV_SPLIT_CTAS
               and -(-nb // (2 * splits)) >= GEMV_MIN_BPS):
            splits *= 2
        while -(-nb // splits) > GEMV_MAX_BPS and splits < GEMV_MAX_SPLITS:
            splits *= 2
    while (splits - 1) * -(-nb // splits) >= nb:  # an empty last split
        splits //= 2
    bps = -(-nb // splits)
    if bps > GEMV_MAX_BPS:
        raise ValueError(f"no K1 plan for nb {nb}: a split would stage {bps} blocks")
    return GemvPlan(vec, 32 * vec, GEMV_WARPS, splits, bps)


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
    # a tensor divisor: torch on CUDA turns division by a host scalar into a
    # product with its reciprocal, which can round the scale another way
    scale = amax / torch.full_like(amax, 127.0)
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    x8 = torch.clamp(torch.round(xb * inv), -127, 127)
    xs = scale.to(torch.float16).to(torch.float32).squeeze(-1)
    bs = x8.sum(dim=-1)  # small integers: exact in f32
    return x8, xs, bs


def q80_gemv_plain(x8: torch.Tensor, xs: torch.Tensor, bs: torch.Tensor, q: torch.Tensor,
                   d: torch.Tensor) -> torch.Tensor:
    """K1's GEMV on rows already quantized: x8 [R, nb*32] (or [R, nb, 32])
    int8 values in any dtype, xs [R, nb] f32, bs [R, nb] block sums (int32
    or f32), q [nb*4, out] int32, d [nb, out] f16 -> [R, out] f32."""
    nb = q.shape[-2] // 4
    x8 = x8.reshape(-1, nb, Q_BLOCK).to(torch.float32)
    u = (unpack_q(q) + 8).to(torch.float32)  # [nb, 32, out] unsigned nibbles
    # integer-valued f32 products and sums below 2^24: exact
    partial = torch.einsum("rbf,bfo->rbo", x8, u)
    pr = partial - 8.0 * bs.to(torch.float32).unsqueeze(-1)
    scale = xs.unsqueeze(-1) * d.to(torch.float32).unsqueeze(0)  # [R, nb, out]
    return (pr * scale).sum(dim=1)


def q40_gemv_q80_plain(x: torch.Tensor, q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """K1's plain version: x [..., in] (any float dtype), q [nb*4, out]
    int32, d [nb, out] f16 -> [..., out] f32."""
    nb = q.shape[-2] // 4
    lead = x.shape[:-1]
    x8, xs, bs = quantize_rows_q80(x.reshape(-1, nb * Q_BLOCK), nb)
    return q80_gemv_plain(x8, xs, bs, q, d).reshape(*lead, q.shape[-1])


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


def q40_gemm_bf16_blocked(x: torch.Tensor, q: torch.Tensor, d: torch.Tensor,
                          plan: GemmPlan) -> torch.Tensor:
    """K2's sums in the kernel's order, for the CPU tests: K2's plain
    weights and x, each Q40 block's 32 products summed in f32, the blocks a
    warp takes (block i of every stage of a split: i = (b - first) % 4)
    accumulated in block order, the four warps' partials added in warp
    order, then the splits in split order. Within a block the tensor cores
    sum in their own order, so this is the kernel's blocking, not its
    bits."""
    nb = q.shape[-2] // 4
    out_f = q.shape[-1]
    lead = x.shape[:-1]
    sb = d.to(torch.float32).to(torch.bfloat16).to(torch.float32)
    w = (unpack_q(q).to(torch.float32) * sb.unsqueeze(1)).to(torch.bfloat16).to(torch.float32)
    xb = x.reshape(-1, nb, Q_BLOCK).to(torch.bfloat16).to(torch.float32)
    per_block = torch.einsum("rbf,bfo->bro", xb, w)  # [nb, R, out] f32 block dots
    total = None
    for s in range(plan.splits):
        first = s * plan.blocks_per_split
        last = min(nb, first + plan.blocks_per_split)
        part = torch.zeros((xb.shape[0], out_f), dtype=torch.float32)
        for kw in range(GEMM_STAGE_BLOCKS):
            warp = torch.zeros_like(part)
            for b in range(first + kw, last, GEMM_STAGE_BLOCKS):
                warp = warp + per_block[b]
            part = warp if kw == 0 else part + warp
        total = part if total is None else total + part
    return total.reshape(*lead, out_f)


def i8_blocks_plain(x8: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                    dt: torch.Tensor) -> torch.Tensor:
    """The plain version of B9 and P13 (and the closed form the one-row
    GEMVs' orders are held to): x8 [R, nb*32] int8, xs [R, nb] f32, wq [nb,
    32, out] weight values in [-8, 7] (any integer dtype), dt [nb, out] f16
    -> [R, out] f32 = sum over blocks of partial * (xs * dt), JAX's
    association; every partial, |p| <= 32 * 127 * 8 < 2^24, is exact in
    f32."""
    nb = wq.shape[0]
    R = x8.shape[0]
    xb = x8.reshape(R, nb, Q_BLOCK).to(torch.float32)
    wf = wq.to(torch.float32)
    partial = torch.einsum("rbf,bfo->rbo", xb, wf)  # exact integers
    scale = xs.unsqueeze(-1) * dt.to(torch.float32).unsqueeze(0)  # [R, nb, out]
    return (partial * scale).sum(dim=1)


def q40_i8_unpacked_plain(x8, xs, qt, dt) -> torch.Tensor:
    """B9's plain version: x8 [R, in] int8, xs [R, nb] f32, qt [nb, 32, out]
    int8, dt [nb, out] f16 -> [R, out] f32."""
    return i8_blocks_plain(x8, xs, qt, dt)


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


def _gemv_terms(x8, xs, bs, q, d) -> torch.Tensor:
    """K1's per-block terms in f32, each rounded as the kernel rounds it:
    [nb, R, out] = (partial - 8 * bsum) * (xs * d), the partial an exact
    integer (every f32 product and sum below 2^24)."""
    nb = q.shape[-2] // 4
    u = (unpack_q(q) + 8).to(torch.float32)  # [nb, 32, out]
    partial = torch.einsum("rbf,bfo->bro", x8.reshape(-1, nb, Q_BLOCK).to(torch.float32), u)
    pr = partial - 8.0 * bs.to(torch.float32).t().unsqueeze(-1)
    scale = xs.t().unsqueeze(-1) * d.to(torch.float32).unsqueeze(1)  # [nb, R, out]
    return pr * scale


def _gemv_order(terms: torch.Tensor, plan: GemvPlan) -> torch.Tensor:
    """[nb, R, out] block terms summed in K1's order: blocks in order within
    a warp's run (from 0), the warps of a split in warp order, then the
    splits in split order -> [R, out]."""
    nb = terms.shape[0]
    total = None
    for s in range(plan.splits):
        blocks = plan.split_range(s, nb)
        cta = None
        for kw in range(plan.kw):
            acc = torch.zeros_like(terms[0])
            for b in plan.warp_range(kw, blocks):
                acc = acc + terms[b]
            cta = acc if cta is None else cta + acc
        total = cta if total is None else total + cta
    return total


def q40_gemv_q80_blocked(x: torch.Tensor, q: torch.Tensor, d: torch.Tensor,
                         plan: GemvPlan) -> torch.Tensor:
    """K1's sums in the kernel's order under `plan`: x [..., in], q [nb*4,
    out] int32, d [nb, out] f16 -> [..., out] f32, bit for bit what the
    kernel gives (K1 rounds each product and sum once, as these torch ops
    do)."""
    nb = q.shape[-2] // 4
    lead = x.shape[:-1]
    x8, xs, bs = quantize_rows_q80(x.reshape(-1, nb * Q_BLOCK), nb)
    return _gemv_order(_gemv_terms(x8, xs, bs, q, d), plan).reshape(*lead, q.shape[-1])


def q40_gemv_q80_indexed_blocked(x, q, d, idx, plan: GemvPlan) -> torch.Tensor:
    """K1-indexed's sums in the kernel's order: slot s is
    `q40_gemv_q80_blocked` of its row (or the one shared row) against group
    idx[s] -> [len(idx), out] f32."""
    qf, df = flat_groups(q, d)
    nb = qf.shape[-2] // 4
    x8, xs, bs = quantize_rows_q80(x.reshape(-1, nb * Q_BLOCK), nb)
    rows = []
    for s, g in enumerate(idx.long()):
        r = 0 if x8.shape[0] == 1 else s
        terms = _gemv_terms(x8[r:r + 1], xs[r:r + 1], bs[r:r + 1], qf[g], df[g])
        rows.append(_gemv_order(terms, plan))
    return torch.cat(rows)


def _grouped_weights(qf, df, sel, exact_scale: bool) -> torch.Tensor:
    """The groups `sel` of a flat stack as K4 forms them, [n, nb, 32, out]
    bf16: (u - 8) * bf16(scale) rounded to bf16 (K2's and JAX's grouped
    kernel's rounding), or with `exact_scale` bf16(f32(scale) * (u - 8)),
    the gather arm's `dequantize_t`."""
    scale = df[sel].to(torch.float32)
    if not exact_scale:
        scale = scale.to(torch.bfloat16).to(torch.float32)
    return (unpack_q(qf[sel]).to(torch.float32) * scale.unsqueeze(2)).to(torch.bfloat16)


def q40_grouped_gemm_bf16_plain(xp, q, d, block_expert, block_r: int,
                                exact_scale: bool = False) -> torch.Tensor:
    """K4's plain version: row block i of xp [R_pad, in] (cast to bf16)
    times group block_expert[i] of the flat stack, K2's rounding (or the
    gather arm's, `exact_scale`) -> [R_pad, out] f32."""
    qf, df = flat_groups(q, d)
    nb = qf.shape[-2] // 4
    out_f = qf.shape[-1]
    n_blocks = xp.shape[0] // block_r
    w = _grouped_weights(qf, df, block_expert.long(), exact_scale)
    w = w.reshape(n_blocks, nb * Q_BLOCK, out_f).to(torch.float32)
    xb = xp.reshape(n_blocks, block_r, nb * Q_BLOCK).to(torch.bfloat16).to(torch.float32)
    return _f32_matmul(xb, w).reshape(n_blocks * block_r, out_f)


def q40_grouped_gemm_bf16_blocked(xp, q, d, block_expert, block_r: int,
                                  exact_scale: bool = False) -> torch.Tensor:
    """K4's sums in the kernel's order, for the CPU tests: K2's plain
    weights and x, each Q40 block's 32 products summed in f32 (two
    16-feature MMA steps in the kernel), the blocks of a row block
    accumulated in block order by the one warp that owns the column, with
    nothing split. Within a block the tensor cores sum in their own order,
    so this is the kernel's blocking, not its bits."""
    qf, df = flat_groups(q, d)
    nb = qf.shape[-2] // 4
    out_f = qf.shape[-1]
    n_blocks = xp.shape[0] // block_r
    w = _grouped_weights(qf, df, block_expert.long(), exact_scale)
    w = w.to(torch.float32)  # [n_blocks, nb, 32, out]
    xb = xp.reshape(n_blocks, block_r, nb, Q_BLOCK).to(torch.bfloat16).to(torch.float32)
    per_block = torch.einsum("nrbf,nbfo->bnro", xb, w)  # [nb, n_blocks, block_r, out]
    acc = torch.zeros((n_blocks, block_r, out_f), dtype=torch.float32)
    for b in range(nb):
        acc = acc + per_block[b]
    return acc.reshape(n_blocks * block_r, out_f)


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


def _launch_gemv(x, q, d, layer: int, plan: GemvPlan | None = None, lib=None) -> torch.Tensor:
    """One K1 launch at `plan` (gemv_plan's by default) from `lib` (the
    port's build of csrc/q40_gemv.cu by default)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    nb = q.shape[-2] // 4
    in_f = nb * Q_BLOCK
    out_f = q.shape[-1]
    rows = x.numel() // in_f
    if not 1 <= rows <= MAX_I8_ROWS:
        raise ValueError(f"q40_gemv_q80 takes 1..{MAX_I8_ROWS} rows, got {rows}")
    plan = plan or gemv_plan(nb, out_f)
    lib = lib or kernels.load("q40_gemv", _GEMV_SIG)
    out = torch.empty((rows, out_f), dtype=torch.float32, device=x.device)
    kernels.launch(
        lib, "q40_gemv_q80", x,
        x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(), d.data_ptr(),
        out.data_ptr(), rows, in_f, out_f, layer,
        plan.vec, plan.cols, plan.kw, plan.splits, plan.blocks_per_split,
    )
    return out.reshape(*x.shape[:-1], out_f)


def launch_q80_prologue(x: torch.Tensor):
    """The first K1's prologue kernel alone on x [R, in] f32 or bf16
    (contiguous, on the card) -> (x8 [R, in] int8, xs [R, nb] f32, bs [R,
    nb] int32)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    rows, in_f = x.shape
    nb = in_f // Q_BLOCK
    lib = kernels.load("q40_gemv", _GEMV_SIG)
    x8 = torch.empty((rows, in_f), dtype=torch.int8, device=x.device)
    xs = torch.empty((rows, nb), dtype=torch.float32, device=x.device)
    bs = torch.empty((rows, nb), dtype=torch.int32, device=x.device)
    kernels.launch(
        lib, "q40_quantize_q80", x,
        x.data_ptr(), int(x.dtype == torch.bfloat16), rows, in_f,
        x8.data_ptr(), xs.data_ptr(), bs.data_ptr(),
    )
    return x8, xs, bs


def launch_gemv_body(x8, xs, bs, q, d, cols: int, ksplit: int) -> torch.Tensor:
    """The first K1's GEMV kernel alone at CTA tile (cols, ksplit), one of
    GEMV_TILES, on checked operands on the card -> [R, out] f32."""
    if (cols, ksplit) not in GEMV_TILES:
        raise ValueError(f"tile ({cols}, {ksplit}) is not one of {GEMV_TILES}")
    rows, in_f = x8.shape
    out_f = q.shape[-1]
    lib = kernels.load("q40_gemv", _GEMV_SIG)
    out = torch.empty((rows, out_f), dtype=torch.float32, device=x8.device)
    kernels.launch(
        lib, "q40_gemv_body", x8,
        x8.data_ptr(), xs.data_ptr(), bs.data_ptr(), q.data_ptr(), d.data_ptr(), out.data_ptr(),
        rows, in_f, out_f, cols, ksplit,
    )
    return out


def _launch_gemm(x, q, d, layer: int) -> torch.Tensor:
    nb = q.shape[-2] // 4
    in_f = nb * Q_BLOCK
    out_f = q.shape[-1]
    xb = x.reshape(-1, in_f).to(torch.bfloat16).contiguous()
    rows = xb.shape[0]
    plan = gemm_plan(nb, out_f)
    lib = kernels.load("q40_gemm", _GEMM_SIG)
    out = torch.empty((rows, out_f), dtype=torch.float32, device=x.device)
    kernels.launch(
        lib, "q40_gemm_bf16", x,
        xb.data_ptr(), q.data_ptr(), d.data_ptr(), out.data_ptr(),
        rows, in_f, out_f, layer, plan.cols, plan.splits, plan.blocks_per_split,
    )
    return out.reshape(*x.shape[:-1], out_f)


def _launch_gemv_indexed(x, q, d, idx, plan: GemvPlan | None = None, lib=None) -> torch.Tensor:
    """One K1-indexed launch at `plan` from `lib`, as `_launch_gemv`."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    n = idx.shape[0]
    nb = q.shape[-2] // 4
    in_f, out_f = nb * Q_BLOCK, q.shape[-1]
    plan = plan or gemv_plan(nb, out_f)
    lib = lib or kernels.load("q40_gemv", _GEMV_SIG)
    out = torch.empty((n, out_f), dtype=torch.float32, device=x.device)
    kernels.launch(
        lib, "q40_gemv_q80_indexed", x,
        x.data_ptr(), int(x.dtype == torch.bfloat16), x.numel() // in_f, q.data_ptr(),
        d.data_ptr(), idx.data_ptr(), n, q.numel() // (nb * 4 * out_f), out.data_ptr(), in_f,
        out_f, plan.vec, plan.cols, plan.kw, plan.splits, plan.blocks_per_split,
    )
    return out


def _launch_grouped(xp, q, d, block_expert, block_r: int,
                    exact_scale: bool = False) -> torch.Tensor:
    nb = q.shape[-2] // 4
    in_f, out_f = nb * Q_BLOCK, q.shape[-1]
    plan = grouped_plan(nb, out_f, block_r)
    xb = xp.to(torch.bfloat16).contiguous()  # w2's f32 rows: one cast launch
    lib = kernels.load("q40_grouped_gemm", _GROUPED_SIG)
    out = torch.empty((xp.shape[0], out_f), dtype=torch.float32, device=xp.device)
    kernels.launch(
        lib, "q40_grouped_gemm_bf16", xp,
        xb.data_ptr(), q.data_ptr(), d.data_ptr(), block_expert.data_ptr(),
        xp.shape[0] // block_r, q.numel() // (nb * 4 * out_f), out.data_ptr(), block_r, in_f,
        out_f, int(exact_scale), plan.cols,
    )
    return out


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


def _group_bytes(q: torch.Tensor, d: torch.Tensor) -> int:
    """Bytes of one group's (one layer's, one expert's) words and scales."""
    return (q.shape[-2] * q.shape[-1] * q.element_size()
            + d.shape[-2] * d.shape[-1] * d.element_size())


def _matmul_cost(name: str, x, q, d, rows: int, groups: int, extra: int = 0):
    """The census entry of one Q40 matmul call over `rows` rows against
    `groups` weight groups, returning an empty f32 [rows, out] (or [...,
    out] for x's leading shape) meta result."""
    in_f, out_f = (q.shape[-2] // 4) * Q_BLOCK, q.shape[-1]
    moved = census.nbytes(x) + groups * _group_bytes(q, d) + extra + rows * out_f * 4
    lead = x.shape[:-1] if x.numel() // in_f == rows else (rows,)
    return census.meta_kernel(name, 2.0 * rows * in_f * out_f, moved,
                              lambda: x.new_empty((*lead, out_f), dtype=torch.float32))


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def i8_mma_splits(nb: int, out_f: int) -> int:
    """Split-K of q40_i8_mma: enough CTAs (about 1,024) to fill the card
    when the 64-column tiles alone do not, at least 8 blocks a split. A
    function of the shape alone, so every instance sums in one order."""
    col_tiles = -(-out_f // I8_MMA_COLS)
    return max(1, min(1024 // col_tiles, nb // 8))


def check_i8_operands(x8, xs, w, dt, rows_per_block: int, w_dtype,
                      dt_dtypes=(torch.float16,)) -> None:
    """The operands of B9/P3/P4: x8 [R, nb*32] int8 with 1 <= R <= 8, xs
    [R, nb] f32, w [nb, rows_per_block, out] of `w_dtype`, dt [nb, out]
    f16 (or another of `dt_dtypes`), out % 8 == 0, all on one device and
    contiguous."""
    if w.ndim != 3 or w.shape[1] != rows_per_block or w.dtype != w_dtype:
        raise ValueError(f"expected a [nb, {rows_per_block}, out] {w_dtype} weight, got "
                         f"{w.dtype} {tuple(w.shape)}")
    _check_rows_and_plane(x8, xs, w, dt, w.shape[0], w.shape[2], dt_dtypes)


def _check_rows_and_plane(x8, xs, w, dt, nb: int, out_f: int, dt_dtypes) -> None:
    """x8 [R, nb*32] int8 with 1 <= R <= 8, xs [R, nb] f32, dt [nb, out]
    of one of `dt_dtypes`, out % 8 == 0, all on x8's device and contiguous."""
    if x8.ndim != 2 or x8.dtype != torch.int8 or x8.shape[1] != nb * Q_BLOCK:
        raise ValueError(f"x8 must be [R, {nb * Q_BLOCK}] int8, got {x8.dtype} {tuple(x8.shape)}")
    R = x8.shape[0]
    if not 1 <= R <= MAX_I8_ROWS:
        raise ValueError(f"the int8 matmul takes 1..{MAX_I8_ROWS} rows, got {R}")
    if xs.dtype != torch.float32 or tuple(xs.shape) != (R, nb):
        raise ValueError(f"xs must be [{R}, {nb}] float32, got {xs.dtype} {tuple(xs.shape)}")
    if dt.dtype not in dt_dtypes or tuple(dt.shape) != (nb, out_f):
        names = " or ".join(str(d).removeprefix("torch.") for d in dt_dtypes)
        raise ValueError(f"dt must be [{nb}, {out_f}] {names}, got {dt.dtype} {tuple(dt.shape)}")
    if out_f % 8:
        raise ValueError(f"out_features must be a multiple of 8, got {out_f}")
    for name, t in (("xs", xs), ("w", w), ("dt", dt)):
        if t.device != x8.device:
            raise ValueError(f"{name} is on {t.device}, x8 on {x8.device}")
    for name, t in (("x8", x8), ("xs", xs), ("w", w), ("dt", dt)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch_i8_mma(x8, xs, qt, dt) -> torch.Tensor:
    """One launch of csrc/q40_i8_mma.cu (B9) on checked operands on the
    card, its split-K summed by a second kernel."""
    if _device_kind(x8) != "cuda":
        raise ValueError(f"q40_i8_mma runs on a CUDA device, not {x8.device}")
    R, nb, out_f = x8.shape[0], qt.shape[0], qt.shape[2]
    splits = i8_mma_splits(nb, out_f)
    lib = kernels.load("q40_i8_mma", _I8_MMA_SIG)
    out = torch.empty((R, out_f), dtype=torch.float32, device=x8.device)
    part = torch.empty((splits, R, out_f) if splits > 1 else (1,), dtype=torch.float32,
                       device=x8.device)
    kernels.launch(
        lib, "q40_i8_mma", x8,
        x8.data_ptr(), xs.data_ptr(), qt.data_ptr(), dt.data_ptr(), out.data_ptr(),
        part.data_ptr(), R, nb, out_f, splits,
    )
    return out


def q40_i8_unpacked(x8, xs, qt, dt) -> torch.Tensor:
    """B9: x8 [R <= 8, in] int8 activations, xs [R, nb] f32 f16-rounded Q80
    scales (`quantize_rows_q80`), qt UNPACKED [nb, 32, out] int8 in [-8, 7],
    dt [nb, out] f16 -> [R, out] f32; out % 8 == 0."""
    check_i8_operands(x8, xs, qt, dt, Q_BLOCK, torch.int8)
    if x8.device.type == "meta":
        rows, out_f = x8.shape[0], qt.shape[-1]
        moved = sum(census.nbytes(t) for t in (x8, xs, qt, dt)) + rows * out_f * 4
        return census.meta_kernel("q40_i8_unpacked", 2.0 * rows * x8.shape[1] * out_f, moved,
                                  lambda: x8.new_empty((rows, out_f), dtype=torch.float32))
    if _device_kind(x8) == "cpu":
        return q40_i8_unpacked_plain(x8, xs, qt, dt)
    out = launch_i8_mma(x8, xs, qt, dt)
    q40_i8_unpacked.launches += 1
    return out


q40_i8_unpacked.launches = 0


def q40_gemv_q80_stacked(x, q, d, layer) -> torch.Tensor:
    """K1 on layer `layer` of an all-layers stack (B1): x [..., in] with at
    most 8 rows, q [L, nb*4, out], d [L, nb, out] -> [..., out] f32."""
    _check_weight(q, d, x, stacked=True)
    li = _layer_index(layer, q.shape[0])
    if x.device.type == "meta":
        return _matmul_cost("q40_gemv_q80_stacked", x, q, d, x.numel() // (q.shape[-2] * 8), 1)
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
    if x.device.type == "meta":
        return _matmul_cost("q40_gemv_q80", x, q, d, x.numel() // (q.shape[-2] * 8), 1)
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
    if x.device.type == "meta":
        return _matmul_cost("q40_gemm_bf16_stacked", x, q, d, x.numel() // (q.shape[-2] * 8), 1)
    if _device_kind(x) == "cpu":
        return q40_gemm_bf16_plain(x, q[li], d[li])
    out = _launch_gemm(x, q, d, li)
    q40_gemm_bf16_stacked.launches += 1
    return out


q40_gemm_bf16_stacked.launches = 0


def q40_gemm_bf16(x, q, d) -> torch.Tensor:
    """K2 on an unstacked weight (B5, the JAX package's `q40_matmul_pallas`
    :880): the wcls at more than 8 rows (perplexity's logits_mode "all",
    batched decode at batch > 8). The same kernel at layer 0: it masks the
    last column tile and the last split's ragged stage, so any block count
    and any out_features (the vocab widths 128256 and 151936 included) run
    as they are."""
    _check_weight(q, d, x, stacked=False)
    if x.device.type == "meta":
        return _matmul_cost("q40_gemm_bf16", x, q, d, x.numel() // (q.shape[-2] * 8), 1)
    if _device_kind(x) == "cpu":
        return q40_gemm_bf16_plain(x, q, d)
    out = _launch_gemm(x, q, d, 0)
    q40_gemm_bf16.launches += 1
    return out


q40_gemm_bf16.launches = 0


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
    if x.device.type == "meta":
        # the slots' groups, each read once (the distinct ones are data)
        return _matmul_cost("q40_gemv_q80_indexed", x, q, d, n, n, census.nbytes(idx))
    if _device_kind(x) == "cpu":
        return q40_gemv_q80_indexed_plain(x, q, d, idx)
    out = _launch_gemv_indexed(x, q, d, idx)
    q40_gemv_q80_indexed.launches += 1
    return out


q40_gemv_q80_indexed.launches = 0


def q40_grouped_gemm_bf16(xp, q, d, block_expert, block_r: int,
                          exact_scale: bool = False) -> torch.Tensor:
    """K4 (B7): row block i of xp [R_pad, in] (cast to bf16) times group
    block_expert[i] of q [..., nb*4, out], d [..., nb, out] (leading axes
    flatten to groups; [L, E] stacks take layer * E + expert). block_r is
    8, 16, 32 or 64 and divides R_pad; block_expert is [R_pad // block_r]
    int32 on xp's device. Each weight is (u - 8) * bf16(scale) rounded to
    bf16, as JAX's grouped kernel forms it, or with `exact_scale`
    bf16(f32(scale) * (u - 8)), as its gather arm does. Returns [R_pad,
    out] f32."""
    _check_groups(q, d, xp, block_expert)
    if xp.ndim != 2:
        raise ValueError(f"xp must be [R_pad, in], got {tuple(xp.shape)}")
    if block_r not in GROUPED_BLOCK_ROWS or xp.shape[0] % block_r:
        raise ValueError(f"block_r {block_r} must be one of {GROUPED_BLOCK_ROWS} and divide "
                         f"{xp.shape[0]} rows")
    n_blocks = xp.shape[0] // block_r
    if block_expert.shape[0] != n_blocks:
        raise ValueError(f"{block_expert.shape[0]} block groups for {n_blocks} row blocks")
    if xp.device.type == "meta":
        n_groups = q.numel() // (q.shape[-2] * q.shape[-1])
        return _matmul_cost("q40_grouped_gemm_bf16", xp, q, d, xp.shape[0],
                            min(n_blocks, n_groups), census.nbytes(block_expert))
    if _device_kind(xp) == "cpu":
        return q40_grouped_gemm_bf16_plain(xp, q, d, block_expert, block_r, exact_scale)
    out = _launch_grouped(xp, q, d, block_expert, block_r, exact_scale)
    q40_grouped_gemm_bf16.launches += 1
    return out


q40_grouped_gemm_bf16.launches = 0


KERNELS = (
    q40_gemv_q80_stacked, q40_gemv_q80, q40_gemm_bf16_stacked, q40_gemm_bf16,
    q40_gemv_q80_indexed, q40_grouped_gemm_bf16, q40_i8_unpacked,
)
