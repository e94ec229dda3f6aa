"""The one-row GEMV of the kernel probes P2, P3, P5, P6 and P9/P10
(csrc/i8_gemv.cuh): the plan rule they share, their per-block terms, the
launch of csrc/i4_gemv_probe.cu (P3's two arms and P6; P2's launch is
probes/scales.py:launch_scale_plane) and of csrc/i4_codec_probe.cu (P5's
split-half bytes and P9/P10's feature-split words, the codecs that store
u = q + 8: their default plan `u4_gemv_plan`, their tiles as plans
`u4_tile_plan`, their operands' checks).

All compute out[r, o] = sum over blocks b of p[r, b, o] * (xs[r, b]
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
W_FS, W_SH = 3, 4  # u4_gemv's: the feature-split words, the split-half bytes
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
U4_SOURCE = "i4_codec_probe"
_U4_SIG = {
    # x8, xs, bs, w, weights, dt, scale_kind, out, rows, nb, out, vec, cols,
    # kw, splits, blocks_per_split, stream
    "u4_gemv": (
        kernels.P, kernels.P, kernels.P, kernels.P, kernels.I, kernels.P, kernels.I, kernels.P,
        kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I,
        kernels.P,
    ),
}
U4_SCALE_KINDS = {torch.float16: 0, torch.int16: 2}
# the codecs' columns a lane as csrc/i4_codec_probe.cu builds them (FS_VEC,
# SH_VEC: P9/P10's words, P5's bytes, each byte two output columns) and the
# output runs a lane's columns feed
U4_VEC = {W_FS: 8, W_SH: 4}
U4_RUNS = {W_FS: 1, W_SH: 2}
# the codecs' default plan: the probes' rule at U4_VEC, U4_KW warps along k
# halved to U4_MIN_KW where the tiles pass U4_TARGET_CTAS, splits doubled
# while each warp keeps U4_FLIGHT_BLOCKS blocks: probes/p5_p9_ab.py --sweep
# chose it (NVIDIA H100 80GB HBM3, 700 W): P5's best plan at each of the
# five shapes, 1 and 8 rows; P9 within 2% (1 row) and 13% (8 rows) of each
# shape's best, mean over the shapes
U4_KW, U4_MIN_KW, U4_TARGET_CTAS, U4_FLIGHT_BLOCKS = 8, 4, 128, 1
U4_BLOCKS = (8, 16, 32, 64, 128, 256)  # the JAX probes' tile_knb


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


def block_terms(x8, xs, wq, dt_f32, bs=None) -> torch.Tensor:
    """The per-block terms [nb, R, out] = p * (xs * dt) in f32, each product
    rounded once as the kernels round it: x8 [R, nb*32] int8, xs [R, nb]
    f32, wq [nb, 32, out] weight values (any integer dtype), dt_f32 [nb,
    out] f32; p the exact integer dot (|p| <= 32 * 128 * 128 < 2^24, exact
    in f32). With bs [R, nb] (the row blocks' sums of x8), wq holds the
    unsigned codecs' u = q + 8 and p = the dot less 8 * bs, as those
    kernels take it: the signed partial exactly."""
    nb = wq.shape[0]
    x = x8.reshape(x8.shape[0], nb, Q_BLOCK).to(torch.float32)
    p = torch.einsum("rbk,bko->bro", x, wq.to(torch.float32))
    if bs is not None:
        p = p - 8.0 * bs.to(torch.float32).t().unsqueeze(-1)
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


# ---------------------------------------------------------------------------
# P5 and P9/P10: the unsigned-nibble codecs (csrc/i4_codec_probe.cu)
# ---------------------------------------------------------------------------


def u4_tile_cols(weights: int) -> tuple:
    """The output columns a CTA of a codec's tiles: U4_VEC columns a lane,
    8 / kw warps across the tile for kw 8, 4, 2, 1 (W_SH: two runs)."""
    return tuple(U4_RUNS[weights] * 32 * U4_VEC[weights] * cw for cw in (1, 2, 4, 8))


def _u4_shape(out_f: int, weights: int) -> int:
    """A codec's weight row width (W_SH: bytes, out / 2) at out_f columns."""
    runs, vec = U4_RUNS[weights], U4_VEC[weights]
    if out_f % (8 * runs) or (out_f // runs) % vec:
        raise ValueError(f"no codec plan for out {out_f}: rows of {out_f // runs} "
                         f"{'bytes' if runs == 2 else 'words'} in lanes of {vec}")
    return out_f // runs


def u4_gemv_plan(nb: int, out_f: int, weights: int) -> GemvPlan:
    """A codec's default plan for nb blocks by out_f columns, a function of
    the shape alone: the probes' rule over its weight rows at U4_VEC
    columns a lane, U4_KW warps along k (U4_MIN_KW where more than
    U4_TARGET_CTAS tiles), splits while each warp keeps U4_FLIGHT_BLOCKS
    blocks; for W_SH the warps along k doubled until a CTA's cols / 2
    bytes divide out / 2 (the JAX grid's (out / 2) % tile_n)."""
    runs, vec = U4_RUNS[weights], U4_VEC[weights]
    row_w = _u4_shape(out_f, weights)
    kw, min_kw = U4_KW, U4_MIN_KW
    while True:
        p = probe_plan(nb, row_w, vec, kw, U4_FLIGHT_BLOCKS, U4_TARGET_CTAS, min_kw)
        if runs == 1 or row_w % p.cols == 0 or p.kw == WARPS:
            break
        kw = min_kw = 2 * p.kw
    if runs == 2 and row_w % p.cols:
        raise ValueError(f"no split-half plan for out {out_f}: no CTA's half divides {row_w}")
    return GemvPlan(vec, runs * p.cols, p.kw, p.splits, p.blocks_per_split)


def u4_tile_plan(nb: int, out_f: int, cols: int, blocks_per_cta: int, weights: int) -> GemvPlan:
    """A codec's tile as a plan: U4_VEC columns a lane, `cols` output
    columns a CTA (one of u4_tile_cols; the warps not across the columns go
    along k), `blocks_per_cta` blocks a split (dividing nb, at most
    MAX_SPLITS splits of at most MAX_BPS blocks); W_SH needs (out / 2) %
    (cols / 2) == 0."""
    runs, vec = U4_RUNS[weights], U4_VEC[weights]
    if cols not in u4_tile_cols(weights):
        raise ValueError(f"cols must be one of {u4_tile_cols(weights)}, got {cols}")
    if blocks_per_cta < 1 or nb % blocks_per_cta:
        raise ValueError(f"blocks_per_cta must divide nb = {nb}, got {blocks_per_cta}")
    splits = nb // blocks_per_cta
    if splits > MAX_SPLITS or blocks_per_cta > MAX_BPS:
        raise ValueError(f"{splits} splits of {blocks_per_cta} blocks: a cluster takes at most "
                         f"{MAX_SPLITS} of at most {MAX_BPS}")
    row_w = _u4_shape(out_f, weights)
    if runs == 2 and row_w % (cols // 2):
        raise ValueError(f"the split-half plane needs (out / 2) % (cols / 2) == 0: out {out_f}, "
                         f"cols {cols}")
    return GemvPlan(vec, cols, WARPS // (cols // (runs * 32 * vec)), splits, blocks_per_cta)


def u4_tiles_for(nb: int, out_f: int, weights: int) -> tuple[list, int]:
    """A codec's (cols, blocks_per_cta) tiles at nb blocks by out_f columns:
    every width of u4_tile_cols (for W_SH those whose half divides out / 2)
    by every JAX tile_knb of U4_BLOCKS that divides nb, and how many of
    those the cluster limit leaves out (more than MAX_SPLITS splits)."""
    runs = U4_RUNS[weights]
    points = [(c, k) for c in u4_tile_cols(weights) for k in U4_BLOCKS
              if k <= nb and nb % k == 0 and (runs == 1 or (out_f // 2) % (c // 2) == 0)]
    kept = [(c, k) for c, k in points if nb // k <= MAX_SPLITS]
    return kept, len(points) - len(kept)


def u4_p3_tile(nb: int, out_f: int, weights: int) -> tuple[int, int]:
    """The codec tile (cols, blocks_per_cta) that sums in P3's plan's order
    at (nb, out): P3's warps along k and its blocks a split, where it gives
    P3's int8 arm's bits on the same values."""
    plan = i4_gemv_plan(nb, out_f)
    return (U4_RUNS[weights] * 32 * U4_VEC[weights] * (WARPS // plan.kw),
            plan.blocks_per_split)


def check_u4_operands(x8, xs, bs, w, dt, weights: int) -> None:
    """The operands of the unsigned-nibble codecs (P5, P9, P10): x8 [R,
    nb*32] int8 with 1 <= R <= 8, xs [R, nb] f32, dt [nb, out] f16 or its
    int16 bits, bs [R, nb] int32 (the rows' block sums of x8), and w the
    codec's plane: for W_FS the feature-split words [nb, 4, out] int32 (the
    T layout), for W_SH the split-half bytes [nb, 32, out / 2] int8; all
    on one device and contiguous."""
    if weights == W_FS:
        ok = w.ndim == 3 and w.shape[1] == 4 and w.dtype == torch.int32
        want = "[nb, 4, out] int32"
    elif weights == W_SH:
        ok = w.ndim == 3 and w.shape[1] == Q_BLOCK and w.dtype == torch.int8
        want = "[nb, 32, out / 2] int8"
    else:
        raise ValueError(f"weights {weights} is not an unsigned-nibble storage")
    if not ok:
        raise ValueError(f"expected a {want} weight, got {w.dtype} {tuple(w.shape)}")
    nb = w.shape[0]
    out_f = w.shape[2] * U4_RUNS[weights]
    cuda_q40._check_rows_and_plane(x8, xs, w, dt, nb, out_f, tuple(U4_SCALE_KINDS))
    R = x8.shape[0]
    if bs.dtype != torch.int32 or tuple(bs.shape) != (R, nb):
        raise ValueError(f"bs must be [{R}, {nb}] int32, got {bs.dtype} {tuple(bs.shape)}")
    if bs.device != x8.device:
        raise ValueError(f"bs is on {bs.device}, x8 on {x8.device}")
    if not bs.is_contiguous():
        raise ValueError("bs must be contiguous")


def launch_u4_gemv(x8, xs, bs, w, weights: int, dt, plan: GemvPlan, lib=None) -> torch.Tensor:
    """One launch of csrc/i4_codec_probe.cu's u4_gemv under `plan` on
    checked operands on the card: w the feature-split words (W_FS) or the
    split-half bytes (W_SH), dt [nb, out] f16 or int16 -> [R, out] f32 in
    natural column order (`lib`: another build of the source, such as the
    sweep's)."""
    if cuda_q40._device_kind(x8) != "cuda":
        raise ValueError(f"u4_gemv runs on a CUDA device, not {x8.device}")
    for t in (x8, w, dt):
        if t.data_ptr() % 16:
            raise ValueError("the GEMV's operands must start on a 16-byte boundary")
    R, nb, out_f = x8.shape[0], xs.shape[1], dt.shape[1]
    lib = lib or kernels.load(U4_SOURCE, _U4_SIG)
    out = torch.empty((R, out_f), dtype=torch.float32, device=x8.device)
    kernels.launch(
        lib, "u4_gemv", x8,
        x8.data_ptr(), xs.data_ptr(), bs.data_ptr(), w.data_ptr(), weights, dt.data_ptr(),
        U4_SCALE_KINDS[dt.dtype], out.data_ptr(), R, nb, out_f, plan.vec, plan.cols, plan.kw,
        plan.splits, plan.blocks_per_split,
    )
    return out
