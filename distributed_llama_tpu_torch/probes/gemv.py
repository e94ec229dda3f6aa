"""The one-row GEMV of the kernel probes P2, P3 and P6 (csrc/i8_gemv.cuh):
the plan rule they share, their per-block terms, and the launch of
csrc/i4_gemv_probe.cu (P3's two arms and P6; P2's launch is
probes/scales.py:launch_scale_plane).

All three compute out[r, o] = sum over blocks b of p[r, b, o] * (xs[r, b]
* dt[b, o]), p the exact integer dot of the row block with the weight
block. A plan (`GemvPlan`: columns a lane, columns a CTA, warps along the
contraction, splits, blocks a split) fixes the order of the f32 sums;
`ops/cuda_q40.py:_gemv_order` repeats it on `block_terms` with torch ops,
equal to the kernels bit for bit.
A plan is a function of the weight's shape alone, so a row's bits are the
same in every call whatever the row count.
"""

from __future__ import annotations

import torch

from ..formats.quants import Q_BLOCK
from ..ops import cuda_q40, kernels
from ..ops.cuda_q40 import GemvPlan

SOURCE = "i4_gemv_probe"
_SIG = {
    # x8, xs, w, weights, dot, dt, scale_kind, out, rows, nb, out, vec,
    # cols, kw, splits, blocks_per_split, stream
    "i4_gemv": (
        kernels.P, kernels.P, kernels.P, kernels.I, kernels.I, kernels.P, kernels.I, kernels.P,
        kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I,
        kernels.P,
    ),
}
W_S4, W_I32 = 1, 2  # i4_gemv's weights codes (csrc/i8_gemv.cuh)
DOTS = {"int8": 0, "bf16": 1}
# the bf16 code runs each loader's chosen route (csrc/i4_gemv_probe.cu
# bf16_route: mma.sync for the s4 bytes, exact f32 products on the CUDA
# cores for the nibble words); a sweep build also takes this code, the
# other route
SWEEP_BF16_OTHER = 2
SCALE_KINDS = {torch.float16: 0, torch.float32: 1, torch.int16: 2}
WARPS = 8          # a CTA's warps
FLIGHT_WORDS = 64  # weight words a lane keeps in flight
MAX_SPLITS = 8     # the portable cluster size
MAX_BPS = 256      # blocks a split stages in shared memory
# P3's plan (csrc/i4_gemv_probe.cu): columns a lane and warps along the
# contraction (halved to P3_MIN_KW where the tiles pass the target), chosen
# by probes/p3_p6_ab.py --sweep at P3's five shapes
P3_VEC, P3_KW, P3_MIN_KW = 8, 8, 4
P3_TARGET_CTAS = 128  # CTAs the split-K aims a call at (132 SMs)
# P6's tiles: 4 columns a lane (one 16-byte load of a word row), cols = 128
# .. 1024 a CTA (8 / (cols / 128) warps along k), blocks a split
P6_VEC = 4
P6_COLS = tuple(32 * P6_VEC * cw for cw in (1, 2, 4, 8))


def block_words(weights: str, vec: int) -> int:
    """The words a lane loads of one weight block: int8 [nb, 32, out] 32
    rows of vec bytes, the s4 bytes [nb, 16, out] 16 rows of vec bytes,
    the nibble words [nb, 4, out] 4 rows of vec words."""
    return {"i8": 8 * vec, "s4": 4 * vec, "i32": 4 * vec}[weights]


def probe_plan(nb: int, out_f: int, vec: int, kw: int, flight: int, target_ctas: int,
               min_kw: int | None = None) -> GemvPlan:
    """The plan rule of the probes' GEMV for nb blocks by out_f columns (a
    multiple of 8): a lane owns `vec` columns, `kw` of a CTA's 8 warps
    split its contraction range, halved down to `min_kw` (the columns a CTA
    doubled) while the column tiles pass `target_ctas`; then the fewest
    splits, a power of two up to MAX_SPLITS, that reach `target_ctas` while
    every warp keeps `flight` blocks of loads in flight, and at most
    MAX_BPS blocks a split, none empty."""
    if nb < 1 or out_f < 8 or out_f % 8 or out_f % vec:
        raise ValueError(f"no GEMV plan for nb {nb}, out {out_f}")
    while kw > (min_kw or kw) and -(-out_f // (32 * vec * (WARPS // kw))) > target_ctas:
        kw //= 2
    cols = 32 * vec * (WARPS // kw)
    tiles = -(-out_f // cols)
    splits = 1
    while (2 * splits <= MAX_SPLITS and tiles * splits < target_ctas
           and -(-nb // (2 * splits)) >= kw * flight):
        splits *= 2
    while -(-nb // splits) > MAX_BPS and splits < MAX_SPLITS:
        splits *= 2
    while (splits - 1) * -(-nb // splits) >= nb:  # an empty last split
        splits //= 2
    bps = -(-nb // splits)
    if bps > MAX_BPS:
        raise ValueError(f"no GEMV plan for nb {nb}: a split would stage {bps} blocks")
    return GemvPlan(vec, cols, kw, splits, bps)


def i4_gemv_plan(nb: int, out_f: int) -> GemvPlan:
    """P3's plan for a 4-bit weight of nb blocks by out_f columns: the
    probes' rule at P3_VEC columns a lane and P3_KW warps along k (P3_MIN_KW
    where more than P3_TARGET_CTAS tiles: the vocab widths), the blocks in
    flight those of FLIGHT_WORDS words of half-byte weights."""
    flight = FLIGHT_WORDS // block_words("s4", P3_VEC)
    return probe_plan(nb, out_f, P3_VEC, P3_KW, flight, P3_TARGET_CTAS, P3_MIN_KW)


def tile_plan(nb: int, cols: int, blocks_per_cta: int) -> GemvPlan:
    """P6's tile as a plan: P6_VEC columns a lane, `cols` columns a CTA
    (one of P6_COLS; the warps not across the columns go along k),
    `blocks_per_cta` blocks a split (dividing nb, at most MAX_SPLITS
    splits of at most MAX_BPS blocks)."""
    if cols not in P6_COLS:
        raise ValueError(f"cols must be one of {P6_COLS}, got {cols}")
    if blocks_per_cta < 1 or nb % blocks_per_cta:
        raise ValueError(f"blocks_per_cta must divide nb = {nb}, got {blocks_per_cta}")
    splits = nb // blocks_per_cta
    if splits > MAX_SPLITS or blocks_per_cta > MAX_BPS:
        raise ValueError(f"{splits} splits of {blocks_per_cta} blocks: a cluster takes at most "
                         f"{MAX_SPLITS} of at most {MAX_BPS}")
    kw = WARPS // (cols // (32 * P6_VEC))
    return GemvPlan(P6_VEC, cols, kw, splits, blocks_per_cta)


def block_terms(x8, xs, wq, dt_f32) -> torch.Tensor:
    """The per-block terms [nb, R, out] = p * (xs * dt) in f32, each product
    rounded once as the kernels round it: x8 [R, nb*32] int8, xs [R, nb]
    f32, wq [nb, 32, out] weight values (any integer dtype), dt_f32 [nb,
    out] f32; p the exact integer dot (|p| <= 32 * 128 * 128 < 2^24, exact
    in f32)."""
    nb = wq.shape[0]
    x = x8.reshape(x8.shape[0], nb, Q_BLOCK).to(torch.float32)
    p = torch.einsum("rbk,bko->bro", x, wq.to(torch.float32))
    return p * (xs.t().unsqueeze(-1) * dt_f32.unsqueeze(1))


def launch_i4_gemv(x8, xs, w, weights: int, dot: int, dt, plan: GemvPlan,
                   lib=None) -> torch.Tensor:
    """One launch of csrc/i4_gemv_probe.cu's i4_gemv under `plan` on checked
    operands on the card, `dot` a code of DOTS (`lib`: another build of the
    source, whose sweep build also takes SWEEP_BF16_OTHER)."""
    if cuda_q40._device_kind(x8) != "cuda":
        raise ValueError(f"i4_gemv runs on a CUDA device, not {x8.device}")
    for t in (x8, w, dt):
        if t.data_ptr() % 16:
            raise ValueError("the GEMV's operands must start on a 16-byte boundary")
    R, nb, out_f = x8.shape[0], w.shape[0], w.shape[2]
    lib = lib or kernels.load(SOURCE, _SIG)
    out = torch.empty((R, out_f), dtype=torch.float32, device=x8.device)
    kernels.launch(
        lib, "i4_gemv", x8,
        x8.data_ptr(), xs.data_ptr(), w.data_ptr(), weights, dot, dt.data_ptr(),
        SCALE_KINDS[dt.dtype], out.data_ptr(), R, nb, out_f, plan.vec, plan.cols, plan.kw,
        plan.splits, plan.blocks_per_split,
    )
    return out
