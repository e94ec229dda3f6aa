"""The decode-attention floor on a head-major cache: P11, P12 and P8 (the
counterparts of the JAX package's scripts/probe_att_floor.py,
scripts/probe_grouped_decode_att.py and scripts/probe_flash_headmajor.py).

All three read a head-major K/V cache [b, kv, S, hd] bf16:

  * P11 `pure_read(k, v)` (csrc/attention_probe.cu, probe_att_floor.py:68):
    out [b, 1, hd] f32 = the sum over (kv head, s) of K + V. The read alone:
    the floor of decode attention. One launch at `read_plan` (the shape
    alone), the splits of a row merged in a fixed order inside it;
    `pure_read_order_plain` repeats that order bit for bit,
    `pure_read_plain` is the closed form (torch's sum);
  * P12 `decode_attention(q, k, v, pos, col0)` (csrc/attention_probe.cu,
    probe_grouped_decode_att.py:73): grouped decode attention for one query
    token per row, q [b, h, hd], cache column s at position col0 + s and
    visible iff col0 + s <= pos -> [b, h, hd] in q's dtype. One launch: S
    is split into absolute column ranges by `attention_plan` (the shape
    alone), one thread-block cluster per (row, kv head), and the splits
    merge in rank order inside the launch;
  * P8 `flash_headmajor(q, k, v, pos_start)` (probe_flash_headmajor.py:26):
    the prefill flash kernel K3 (csrc/flash_attention.cu, through
    ops/cuda_attention.py) fed the head-major cache at t = 1, q [b, t, h,
    hd] -> [b, t, h, hd]. K3 reads its cache in place through strides, so
    the [b, S, kv, hd] view of a head-major cache costs no copy, as the
    head-major reshape costs none on the TPU. P8 adds no kernel: its
    launches are K3's. The JAX probe's block_s sweep has no counterpart
    (K3's 64-row KV tile is its own design); the probe sweeps S instead.

P11 and P12 take their plain version for CPU tensors, launch their kernel
for CUDA tensors or raise, and count their launches in `launches`.

    python -m distributed_llama_tpu_torch.probes.attention [--device cpu] [--seq S ...] [--seed N]

runs, at the Llama-3.2-1B shape (b 1, h 32, kv 8, hd 64), each S of --seq
(default 1024, 2048 and 32768) with pos = S - 10: P11, P12 and P8, each
against its plain version (and P12 against P8: both compute the same
attention), and then the JAX probe's control row, K1 on a packed 2048 ->
512 plane. The JAX control passes an unpacked [nb, 32, out] int8 plane to
`q40_matmul_pallas_i8`, which now takes the packed [nb*4, out] int32 plane
(ops/pallas_q40.py:686-694), so as written it no longer runs; the port runs
what it meant, the production decode matmul on a plane of the same size. On
the card each row gives the cold and hot µs of a call (probes/timing.py), a
chain of 16 x 64 calls in one CUDA graph (the JAX probes' 16-layer lax.scan,
64 times, on one cache, as they run it), GB/s against the bytes moved, and
the CTAs of the kernel. Without `--device cpu` it needs a CUDA device and
raises otherwise.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..ops import cuda_attention, cuda_q40, kernels
from ..ops.cuda_attention import NEG_INF
from ..ops.quant import _f32_matmul

HEAD_DIMS = (64, 128)
SEQS = (1024, 2048, 32768)
SHAPE_1B = dict(b=1, h=32, kv=8, hd=64)  # Llama-3.2-1B's attention
LAYERS, CHAIN = 16, 64  # the JAX probes' chain: 16 layers, 64 times
# csrc/attention_probe.cu's P11: a CTA of READ_THREADS threads reads a
# contiguous chunk of a row's flattened [kv * S, hd] K and V, READ_UNROLL[hd]
# rows' loads in flight a thread (the sweep build also READ_SWEEP_UNROLLS),
# as many CTAs a row as reach READ_TARGET_CTAS over the batch; a ticket's
# last CTA merges a row's splits. probes/p4_p11_ab.py --sweep chose them
READ_THREADS = 256
READ_UNROLL = {64: 4, 128: 4}
READ_SWEEP_UNROLLS = (4, 8)
READ_TARGET_CTAS = 256
# csrc/attention_probe.cu's P12: a CTA's warps each walk their own run of
# columns in tiles of cache rows; a cluster holds at most ATT_MAX_CLUSTER
# CTAs. ATT_VARIANT: (CTAs a cluster at most, warps a CTA, tile rows, tiles
# a warp's ring) by head_dim, chosen by probes/p2_p12_ab.py --sweep among
# ATT_SWEEP_VARIANTS, the (head_dim, warps, tile rows, ring depth) instances
# the source builds with -DDLT_P12_SWEEP
ATT_MAX_CLUSTER = 16
ATT_VARIANT = {64: (8, 8, 32, 2), 128: (8, 8, 16, 2)}
ATT_SWEEP_VARIANTS = ((64, 4, 32, 2), (64, 8, 32, 2), (64, 8, 16, 3), (64, 16, 16, 2),
                      (128, 4, 32, 2), (128, 8, 16, 2))
MAX_G = 8  # query heads a kv head: the MMA's rows 0..7 (rows 8..15 stay zero)
CHAIN_ONCE_MS = 100.0  # a chain longer than this is replayed once
CONTROL = (2048, 512)  # the JAX control row's plane, in -> out

_SIG = {
    # k, v, b, n_kv, S, hd, splits, chunk, unroll, part, tickets, out,
    # stream
    "pure_read": (
        kernels.P, kernels.P, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.LL,
        kernels.I, kernels.P, kernels.P, kernels.P, kernels.P,
    ),
    # q, q_is_f32, k, v, b, n_kv, g, S, hd, pos, col0, cluster, width,
    # warps, tile, stages, scale, out, max_clusters, stream
    "decode_attention": (
        kernels.P, kernels.I, kernels.P, kernels.P, kernels.I, kernels.I, kernels.I, kernels.I,
        kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I,
        kernels.F, kernels.P, kernels.P, kernels.P,
    ),
}


@dataclass(frozen=True)
class ReadPlan:
    """P11's split of a row's n_kv * S cache rows: `splits` CTAs, CTA i
    reading rows [i * chunk, (i + 1) * chunk) (the last may be shorter,
    none empty), `unroll` rows' loads in flight a thread."""

    splits: int
    chunk: int
    unroll: int


def read_plan(b: int, n_kv: int, S: int, hd: int, splits: int | None = None,
              unroll: int | None = None) -> ReadPlan:
    """P11's plan, a function of the shape (b, n_kv, S, hd) alone: chunks
    of whole iterations of a CTA (READ_THREADS / (hd / 8) rows, `unroll`
    times), as many a row as reach READ_TARGET_CTAS over the b rows, none
    empty. `splits` (CTAs a row at most) and `unroll` override the defaults
    (the sweep's plans)."""
    if hd not in HEAD_DIMS or min(b, n_kv, S) < 1:
        raise ValueError(f"no P11 plan for b {b}, kv {n_kv}, S {S}, hd {hd}")
    unroll = READ_UNROLL[hd] if unroll is None else unroll
    splits = -(-READ_TARGET_CTAS // b) if splits is None else splits
    if unroll not in READ_SWEEP_UNROLLS or splits < 1:
        raise ValueError(f"no P11 plan of {splits} splits at {unroll} rows in flight")
    unit = READ_THREADS // (hd // 8) * unroll
    units = -(-n_kv * S // unit)
    per = -(-units // min(splits, units))
    return ReadPlan(-(-units // per), per * unit, unroll)


@dataclass(frozen=True)
class AttentionPlan:
    """P12's split of a (row, kv head)'s S cache columns: `cluster` CTAs
    (one thread-block cluster), CTA c taking columns [c * width, (c + 1) *
    width) and each of its `warps` warps a contiguous run of width / warps
    of those, walked in tiles of `tile` rows, `stages` tiles a warp's
    ring."""

    cluster: int
    width: int
    warps: int
    tile: int
    stages: int

    @property
    def run(self) -> int:
        """Columns a warp's run."""
        return self.width // self.warps


def attention_plan(S: int, hd: int, max_cluster: int | None = None,
                   variant: tuple | None = None) -> AttentionPlan:
    """P12's plan for a cache of S columns at head_dim hd: a function of
    the shape alone, never of pos, col0 or the batch, so a row's bits do
    not depend on where its query sits. The instance (warps, tile rows,
    ring depth) and the cluster cap of ATT_VARIANT[hd], unless `variant` /
    `max_cluster` name others; then the fewest (warps x tile)-column units
    a CTA that keep at most that many CTAs a cluster, and no CTA past S."""
    if hd not in HEAD_DIMS or S < 1:
        raise ValueError(f"no P12 plan for S {S}, hd {hd}")
    cap, *default = ATT_VARIANT[hd]
    max_cluster = cap if max_cluster is None else max_cluster
    warps, tile, stages = default if variant is None else variant
    if ((hd, warps, tile, stages) not in ATT_SWEEP_VARIANTS
            or not 1 <= max_cluster <= ATT_MAX_CLUSTER):
        raise ValueError(f"P12 instance {(hd, warps, tile, stages)} at <= {max_cluster} CTAs "
                         f"a cluster is not built")
    unit = warps * tile
    units = -(-S // unit)
    width = -(-units // min(max_cluster, units)) * unit
    return AttentionPlan(-(-S // width), width, warps, tile, stages)


def visible_columns(S: int, pos: int, col0: int) -> int:
    """The cache columns s < visible that the query sees: col0 + s <= pos."""
    return max(0, min(S, pos - col0 + 1))


def _check_cache(k, v) -> None:
    if k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected K and V [b, kv, S, hd] of one shape, got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"the cache must be bfloat16, got {k.dtype} / {v.dtype}")
    if k.device != v.device:
        raise ValueError(f"K is on {k.device}, V on {v.device}")


def _check_launch(*ts) -> None:
    hd = ts[-1].shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous operands")


# ---------------------------------------------------------------------------
# P11: the pure read
# ---------------------------------------------------------------------------


def pure_read_plain(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """P11's plain version: [b, kv, S, hd] bf16 K and V -> [b, 1, hd] f32."""
    _check_cache(k, v)
    s = k.to(torch.float32).sum(dim=(1, 2)) + v.to(torch.float32).sum(dim=(1, 2))
    return s.unsqueeze(1)


def pure_read_order_plain(k: torch.Tensor, v: torch.Tensor,
                          plan: ReadPlan | None = None) -> torch.Tensor:
    """P11's plain version in the kernel's order under `plan` (by default
    `read_plan` of the shape), elementwise f32 adds, bit for bit the
    kernel's: a thread's rows r0 + ty, + RPI, .. (RPI = READ_THREADS / (hd
    / 8)), K then V of each into its sums; a CTA's RPI threads a column in
    turn; then the splits by Y = READ_THREADS / hd lanes, lane y summing
    splits y, y + Y, .. in turn, then the lanes in turn. Rows and splits
    past the end add zeros, which change no sum (no sum is -0)."""
    _check_cache(k, v)
    b, n_kv, S, hd = k.shape
    plan = plan or read_plan(b, n_kv, S, hd)
    rows, rpi = n_kv * S, READ_THREADS // (hd // 8)

    def chunks(c):  # [b, splits, chunk / rpi, rpi, hd] f32
        c = torch.nn.functional.pad(c.reshape(b, rows, hd).to(torch.float32),
                                    (0, 0, 0, plan.splits * plan.chunk - rows))
        return c.reshape(b, plan.splits, plan.chunk // rpi, rpi, hd)

    kc, vc = chunks(k), chunks(v)
    acc = torch.zeros((b, plan.splits, rpi, hd), dtype=torch.float32, device=k.device)
    for i in range(plan.chunk // rpi):
        acc = acc + kc[:, :, i]
        acc = acc + vc[:, :, i]
    cs = torch.zeros_like(acc[:, :, 0])
    for y in range(rpi):
        cs = cs + acc[:, :, y]
    lanes_n = READ_THREADS // hd
    n = -(-plan.splits // lanes_n)
    p = torch.nn.functional.pad(cs, (0, 0, 0, n * lanes_n - plan.splits))
    p = p.reshape(b, n, lanes_n, hd)
    lanes = torch.zeros_like(p[:, 0])
    for i in range(n):
        lanes = lanes + p[:, i]
    total = torch.zeros_like(lanes[:, 0])
    for y in range(lanes_n):
        total = total + lanes[:, y]
    return total.unsqueeze(1)


def _launch_read(k, v, plan: ReadPlan, lib=None) -> torch.Tensor:
    """One launch of csrc/attention_probe.cu's P11 under `plan` on checked
    CUDA operands -> [b, 1, hd] f32 (`lib`: another build of the source)."""
    b, n_kv, S, hd = k.shape
    lib = lib or kernels.load("attention_probe", _SIG)
    out = torch.empty((b, 1, hd), dtype=torch.float32, device=k.device)
    part = tickets = None
    if plan.splits > 1:  # K5's zeroed counters: each kernel leaves them zero
        part = torch.empty((b, plan.splits, hd), dtype=torch.float32, device=k.device)
        tickets = cuda_attention._tickets(k.device, b)
    kernels.launch(
        lib, "pure_read", k,
        k.data_ptr(), v.data_ptr(), b, n_kv, S, hd, plan.splits, plan.chunk, plan.unroll,
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), out.data_ptr(),
    )
    return out


def pure_read(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """P11: the sum over (kv head, s) of K + V, K and V [b, kv, S, hd] bf16
    -> [b, 1, hd] f32, one launch at `read_plan` of the shape."""
    _check_cache(k, v)
    if cuda_q40._device_kind(k) == "cpu":
        return pure_read_order_plain(k, v)
    _check_launch(k, v)
    out = _launch_read(k, v, read_plan(*k.shape))
    pure_read.launches += 1
    return out


pure_read.launches = 0

# ---------------------------------------------------------------------------
# P12: grouped decode attention
# ---------------------------------------------------------------------------


def _check_q(q, k) -> None:
    if q.ndim != 3 or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[3]:
        raise ValueError(f"q must be [b, h, hd] for a {tuple(k.shape)} cache, got {tuple(q.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"{q.shape[1]} query heads do not group over {k.shape[1]} kv heads")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.device != k.device:
        raise ValueError(f"q is on {q.device}, the cache on {k.device}")


def _merge(m, l, acc, dim: int):
    """Online-softmax states merged along `dim` in order, as the kernel
    merges its warps and then its cluster's CTAs: M = the largest m, then
    acc * e^(m - M) and l * e^(m - M) summed one by one from the first."""
    M = m.amax(dim=dim, keepdim=True)
    f = torch.exp(m - M)
    os, ls = acc * f, l * f
    O, L = os.select(dim, 0), ls.select(dim, 0)
    for i in range(1, m.shape[dim]):
        O, L = O + os.select(dim, i), L + ls.select(dim, i)
    return M.squeeze(dim), L, O


def decode_attention_plain(q, k, v, pos: int, col0: int = 0,
                           plan: AttentionPlan | None = None) -> torch.Tensor:
    """P12's plain version, in the kernel's order under `plan` (by default
    `attention_plan`): each warp's run of columns in tiles of plan.tile rows
    with its own online softmax (p rounded to bf16 against the run's
    running max), a tile skipped when none of its columns is visible, then
    the warps of a CTA merged in warp order and the CTAs in rank order. q
    [b, h, hd]; K/V [b, kv, S, hd] bf16 -> [b, h, hd] in q's dtype."""
    _check_cache(k, v)
    _check_q(q, k)
    b, h, hd = q.shape
    n_kv, S = k.shape[1], k.shape[2]
    g = h // n_kv
    plan = plan or attention_plan(S, hd)
    scale = 1.0 / (hd ** 0.5)
    visible = visible_columns(S, int(pos), int(col0))
    n_runs, n_t = plan.cluster * plan.warps, plan.run // plan.tile
    dev = q.device

    cols = torch.arange(n_runs * n_t * plan.tile, device=dev) < visible

    def tiles(c):  # [b, kv, S, hd] -> [b, kv, runs, tiles, rows, hd] f32, zero from visible on
        c = torch.nn.functional.pad(c.to(torch.float32), (0, 0, 0, plan.cluster * plan.width - S))
        c = torch.where(cols[:, None], c, 0.0)  # the kernel never reads them
        return c.reshape(b, n_kv, n_runs, n_t, plan.tile, hd)

    kt, vt = tiles(k), tiles(v)
    vis = cols.reshape(n_runs, n_t, 1, plan.tile)
    qf = q.to(torch.bfloat16).to(torch.float32).reshape(b, n_kv, 1, g, hd)
    m = torch.full((b, n_kv, n_runs, g, 1), NEG_INF, device=dev)
    l = torch.zeros((b, n_kv, n_runs, g, 1), device=dev)
    acc = torch.zeros((b, n_kv, n_runs, g, hd), device=dev)
    for t in range(n_t):
        mask = vis[:, t]  # [runs, 1, rows]
        seen = mask.any(dim=-1, keepdim=True)  # [runs, 1, 1]: the tile is walked
        s = _f32_matmul(qf, kt[:, :, :, t].transpose(-1, -2)) * scale
        s = torch.where(mask, s, NEG_INF)
        m_safe = torch.clamp(torch.maximum(s.amax(dim=-1, keepdim=True), m), min=NEG_INF / 2)
        corr = torch.exp(m - m_safe)
        p = torch.where(mask, torch.exp(s - m_safe), 0.0)
        pv = _f32_matmul(p.to(torch.bfloat16).to(torch.float32), vt[:, :, :, t])
        l = torch.where(seen, l * corr + p.sum(dim=-1, keepdim=True), l)
        acc = torch.where(seen, acc * corr + pv, acc)
        m = torch.where(seen, m_safe, m)
    split = (b, n_kv, plan.cluster, plan.warps, g)
    m, l, acc = _merge(m.reshape(*split, 1), l.reshape(*split, 1), acc.reshape(*split, hd), 3)
    _, l, acc = _merge(m, l, acc, 2)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, h, hd).to(q.dtype)


def _launch_attention(q, k, v, pos: int, col0: int, plan: AttentionPlan,
                      max_clusters: bool = False, lib=None):
    """One launch of csrc/attention_probe.cu's P12 under `plan` on checked
    CUDA operands -> [b, h, hd] in q's dtype (`lib`: another build of the
    source); with `max_clusters`, no launch: how many of the plan's clusters
    the card holds at once."""
    b, h, hd = q.shape
    n_kv, S = k.shape[1], k.shape[2]
    if h // n_kv > MAX_G:
        raise ValueError(f"{h // n_kv} query heads a kv head: at most {MAX_G}")
    lib = lib or kernels.load("attention_probe", _SIG)
    out = torch.empty_like(q)
    n = ctypes.c_int(0)
    kernels.launch(
        lib, "decode_attention", q,
        q.data_ptr(), int(q.dtype == torch.float32), k.data_ptr(), v.data_ptr(), b, n_kv,
        h // n_kv, S, hd, int(pos), int(col0), plan.cluster, plan.width, plan.warps, plan.tile,
        plan.stages, 1.0 / (hd ** 0.5), out.data_ptr(),
        ctypes.addressof(n) if max_clusters else None,
    )
    return n.value if max_clusters else out


def decode_attention(q, k, v, pos: int, col0: int = 0) -> torch.Tensor:
    """P12: grouped decode attention for one query token per row: q [b, h,
    hd] (f32 or bf16), head-major K/V [b, kv, S, hd] bf16, host ints pos
    (the query's position) and col0 (the position of cache column 0) ->
    [b, h, hd] in q's dtype. One launch at `attention_plan(S, hd)`."""
    _check_cache(k, v)
    _check_q(q, k)
    pos, col0 = int(pos), int(col0)
    if cuda_q40._device_kind(q) == "cpu":
        return decode_attention_plain(q, k, v, pos, col0)
    _check_launch(q, k, v)
    out = _launch_attention(q, k, v, pos, col0, attention_plan(k.shape[2], q.shape[2]))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

KERNELS = (pure_read, decode_attention)

# ---------------------------------------------------------------------------
# P8: K3 on the head-major cache
# ---------------------------------------------------------------------------


def headmajor_view(c: torch.Tensor) -> torch.Tensor:
    """A head-major cache [b, kv, S, hd] as K3's [b, S, kv, hd] view: no
    copy, strides (kv*S*hd, hd, S*hd, 1)."""
    return c.transpose(1, 2)


def flash_headmajor_plain(q, k, v, pos_start: int) -> torch.Tensor:
    """P8's plain version: K3's (`flash_attention_plain`) on the same view."""
    return cuda_attention.flash_attention_plain(q, headmajor_view(k), headmajor_view(v),
                                                int(pos_start))


def flash_headmajor(q, k, v, pos_start: int) -> torch.Tensor:
    """P8: K3 on a head-major cache. q [b, t, h, hd]; K/V [b, kv, S, hd]
    bf16; positions pos_start + arange(t) -> [b, t, h, hd] in q's dtype.
    Counted in K3's `cuda_attention.flash_attention.launches`."""
    _check_cache(k, v)
    return cuda_attention.flash_attention(q, headmajor_view(k), headmajor_view(v),
                                          int(pos_start))


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------


def make_operands(b: int, h: int, kv: int, hd: int, S: int, device, seed: int = 0):
    """Random q [b, h, hd] bf16 and distinct K, V [b, kv, S, hd] bf16, made
    on `device` from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    k = torch.randn((b, kv, S, hd), generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn((b, kv, S, hd), generator=gen, device=device).to(torch.bfloat16)
    q = torch.randn((b, h, hd), generator=gen, device=device).to(torch.bfloat16)
    return q, k, v


def work(b: int, h: int, kv: int, hd: int, S: int, visible: int) -> dict:
    """Bytes each call reads and writes once: P11 all of K and V and its
    f32 out; P12 and P8 the visible K/V rows, q and the bf16 out."""
    kv_row = b * kv * hd * 2
    return {"pure_read": 2 * S * kv_row + b * hd * 4,
            "attention": 2 * visible * kv_row + 2 * b * h * hd * 2}


def _timed(fn, operands: tuple, nbytes: int) -> dict:
    from . import timing

    cold, hot = timing.cold_hot_ms(fn, operands, nbytes)
    n = LAYERS * CHAIN
    chain = timing.graph_ms([lambda: fn(*operands)] * n, warm=False,
                            replays=1 if hot * n > CHAIN_ONCE_MS else 3)
    return {"cold_ms": cold, "hot_ms": hot, "chain_ms": chain, "gb_s_cold": nbytes / cold / 1e6,
            "gb_s_hot": nbytes / hot / 1e6, "gb_s_chain": nbytes / chain / 1e6}


def run_seq(S: int, device, seed: int = 0, timed: bool = True, shape=SHAPE_1B) -> list:
    """The three probes at one cache length S, pos = S - 10 (at least 0):
    each against its plain version, P12 against P8, and, timed on the card,
    each one's cold, hot and chained ms, its plain version's ms and its
    library call's: torch.sum of K and of V for P11 (the nearest call, not
    the same function), scaled_dot_product_attention with enable_gqa on the
    cache cut to pos + 1 for P12 and P8. Returns one dict a probe."""
    b, h, n_kv, hd = shape["b"], shape["h"], shape["kv"], shape["hd"]
    q, k, v = make_operands(b, h, n_kv, hd, S, device, seed)
    pos = max(S - 10, 0)
    visible = min(S, pos + 1)
    nbytes = work(b, h, n_kv, hd, S, visible)
    q4 = q.reshape(b, 1, h, hd)
    g = h // n_kv
    got = {"pure_read": pure_read(k, v), "decode_attention": decode_attention(q, k, v, pos),
           "flash_headmajor": flash_headmajor(q4, k, v, pos).reshape(b, h, hd)}
    want = {"pure_read": pure_read_order_plain(k, v),
            "decode_attention": decode_attention_plain(q, k, v, pos),
            "flash_headmajor": flash_headmajor_plain(q4, k, v, pos).reshape(b, h, hd)}
    p12_vs_p8 = (got["decode_attention"].float() - got["flash_headmajor"].float()).abs().max()
    ctas = {"pure_read": b * read_plan(b, n_kv, S, hd).splits,
            "decode_attention": b * n_kv * attention_plan(S, hd).cluster,
            "flash_headmajor": b * n_kv * -(-g // cuda_attention.FLASH_ROWS)
            * cuda_attention.plan_for(q4, headmajor_view(k)).splits}
    rows = []
    for name in ("pure_read", "decode_attention", "flash_headmajor"):
        err = (got[name].float() - want[name].float()).abs().max().item()
        rows.append({"probe": name, "S": S, "pos": pos, "b": b, "h": h, "kv": n_kv, "hd": hd,
                     "ctas": ctas[name], "max_abs_err": err,
                     "out_scale": want[name].float().abs().max().item(),
                     "p12_vs_p8": p12_vs_p8.item(),
                     "bytes": nbytes["pure_read" if name == "pure_read" else "attention"]})
    if not timed:
        return rows
    import torch.nn.functional as F

    from . import timing

    sq, sk, sv = q4.transpose(1, 2), k[:, :, :pos + 1], v[:, :, :pos + 1]
    fns = {
        "pure_read": (pure_read, pure_read_order_plain, (k, v),
                      lambda a, c: (torch.sum(a, dim=(1, 2), dtype=torch.float32)
                                    + torch.sum(c, dim=(1, 2), dtype=torch.float32)), (k, v)),
        "decode_attention": (decode_attention, decode_attention_plain, (q, k, v, pos),
                             lambda a, c, e: F.scaled_dot_product_attention(a, c, e,
                                                                            enable_gqa=True),
                             (sq, sk, sv)),
        "flash_headmajor": (flash_headmajor, flash_headmajor_plain, (q4, k, v, pos),
                            lambda a, c, e: F.scaled_dot_product_attention(a, c, e,
                                                                           enable_gqa=True),
                            (sq, sk, sv)),
    }
    for r in rows:
        fn, plain, ops, lib, lib_ops = fns[r["probe"]]
        r.update(_timed(fn, ops, r["bytes"]))
        r["plain_ms"] = timing.graph_ms([lambda: plain(*ops)], replays=3)
        r["library_cold_ms"], r["library_hot_ms"] = timing.cold_hot_ms(lib, lib_ops, r["bytes"])
    return rows


def run_control(device, seed: int = 0, timed: bool = True) -> dict:
    """The control row: K1 (the production decode matmul) on a packed
    2048 -> 512 Q40 plane, about the bytes of a layer's K/V at S 1024."""
    from .int4_prod import make_operands as q40_operands, work as q40_work

    in_f, out_f = CONTROL
    x, qp, d = q40_operands(in_f, out_f, device, seed)
    got = cuda_q40.q40_gemv_q80(x, qp, d)
    want = cuda_q40.q40_gemv_q80_plain(x, qp, d)
    nbytes = q40_work(1, in_f, out_f)["call"]
    row = {"probe": "control K1", "in": in_f, "out": out_f, "bytes": nbytes,
           "ctas": cuda_q40.gemv_plan(in_f // 32, out_f).ctas(out_f),
           "max_abs_err": (got - want).abs().max().item(),
           "out_scale": want.abs().max().item()}
    if timed:
        row.update(_timed(cuda_q40.q40_gemv_q80, (x, qp, d), nbytes))
    return row


def main(argv=None) -> list:
    """Run the probes at each --seq S and the control row; print one line a
    row and return the rows."""
    ap = argparse.ArgumentParser(prog="python -m distributed_llama_tpu_torch.probes.attention")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seq", type=int, nargs="+", default=list(SEQS), help="cache lengths S")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random operands")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    timed = device.type == "cuda"
    if timed:
        from . import timing

        print(f"card: {timing.card_line()}", flush=True)
    else:
        print("(CPU: the plain versions, correctness only; times not measured)", flush=True)
    s = SHAPE_1B
    print(f"shape: b {s['b']}, h {s['h']}, kv {s['kv']}, hd {s['hd']}; pos = S - 10", flush=True)
    rows = []
    for S in args.seq:
        for r in run_seq(S, device, seed=args.seed, timed=timed):
            line = (f"S {S:6d} {r['probe']:16s} {r['bytes'] / 1e6:7.2f} MB, {r['ctas']:4d} CTAs: "
                    f"max err vs plain {r['max_abs_err']:.3e}, P12 vs P8 {r['p12_vs_p8']:.3e}")
            if timed:
                line += (f"; cold {r['cold_ms'] * 1e3:.2f} us ({r['gb_s_cold']:.0f} GB/s), hot "
                         f"{r['hot_ms'] * 1e3:.2f} us, chain {r['chain_ms'] * 1e3:.2f} us a call "
                         f"({r['gb_s_chain']:.0f} GB/s); library cold "
                         f"{r['library_cold_ms'] * 1e3:.2f} us")
            print(line, flush=True)
            rows.append(r)
    r = run_control(device, seed=args.seed, timed=timed)
    line = (f"control: K1 {r['in']}->{r['out']} packed, {r['bytes'] / 1e6:.2f} MB, {r['ctas']} "
            f"CTAs: max err vs plain {r['max_abs_err']:.3e}")
    if timed:
        line += (f"; cold {r['cold_ms'] * 1e3:.2f} us ({r['gb_s_cold']:.0f} GB/s), hot "
                 f"{r['hot_ms'] * 1e3:.2f} us, chain {r['chain_ms'] * 1e3:.2f} us a call")
    print(line, flush=True)
    rows.append(r)
    print(json.dumps({"probe": "attention", "device": str(device), "rows": len(rows)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
