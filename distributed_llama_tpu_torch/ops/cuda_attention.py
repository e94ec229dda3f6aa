"""K3: causal GQA flash attention for prefill chunks, B8: its shard-local
partial for a sequence-parallel cache, and K5: int8 paged decode attention
through the page table, each beside its plain PyTorch version.

`flash_attention` (csrc/flash_attention.cu) replaces the JAX package's
`ops/pallas_attention.py:flash_attention` (:199), bodies `_attend_block`
(:46) and `_kernel` (:103): blocked causal attention from a scalar
`pos_start` with an f32 online softmax (m clamped to NEG_INF / 2, l to
1e-30, P cast to the V dtype before PV), the g query heads of a KV head
folded into the score rows. The position is a host int or, as the JAX
kernel's scalar-prefetch operand, a 0-d int32 or int64 tensor on the
device, which the kernel reads itself (`flash_attention_fwd_dev`), so a
CUDA graph of a prefill chunk or a verify round replays at any position.
The kernel reads the cache in place through its strides and splits the
view's KV tiles over CTAs by `plan_for`, a function of the shapes alone
(b, t, heads and the view's S), as the JAX kernel's grid is: a split past
the causal limit exits with neutral partials, and the splits combine in
split order, so a call's bits never depend on how its position reached
it. `flash_split_plain` repeats that blocking on the CPU. The plain version
repeats the Pallas kernel's blocking (query blocks of min(512, t), KV
blocks of min(1024, S), invisible blocks skipped) so that it follows the
JAX kernel's rounding as closely as torch allows.

`flash_attention_partial` (B8, the same source) replaces
`ops/pallas_attention.py:flash_attention_partial` (:398), body
`_kernel_partial` (:114): K3's loop over one shard of a sequence-parallel
cache whose row 0 is the global position `col_offset`, returning the
unnormalized triple (o, m, l) that `ops/attention.py:flash_attention_sp`
combines across shards. A row that sees no column of the shard gets o = 0,
l = 0 and the JAX kernel's m: NEG_INF / 2 where its query block (the JAX
kernel's block_t tokens) visits a KV block of the shard, NEG_INF (the
scratch init) where it visits none.

`paged_flash_attention` (csrc/paged_attention.cu, K5) replaces
`ops/pallas_attention.py:paged_flash_attention` (:313), body
`_paged_kernel` (:250): the int8 paged decode arm. Per (row, kv head) it
walks the row's first `n_read` page-table entries (clamped at 0), skips
pages past the row's last query position, dequantizes K and V in f32 and
runs the same online softmax as K3 with P . V in f32 (no bf16 rounding of
P). Per-row `pos_base` puts a parked row (pos_base = seq_len) on every
page; its output is junk the host discards. The kernel cuts the pages
into splits of `paged_plan(page_size, head_dim, g).split_pages` absolute
pages, one CTA of four warps each, merges the warps' runs of pages in
warp order, and the last CTA of a (row, kv head) to finish merges the
splits in split order; `paged_split_plain` repeats that blocking.
The plain version walks the pages in the same order with torch ops, the
skip as a per-row select.

Each wrapper takes its plain version for a tensor on the CPU, launches its
kernel for a tensor on the card (or raises), and counts its launches in
the plain int attribute `launches`. On ``meta`` tensors, under a cost
census only (ops/census.py), it states its call's FLOPs and bytes (q and
the output once, and the K/V rows the causal limit reads) and returns an
empty result of its shape.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import census, kernels
from .quant import _f32_matmul

NEG_INF = float(torch.finfo(torch.float32).min)
DEFAULT_BLOCK_T = 512
DEFAULT_BLOCK_S = 1024
HEAD_DIMS = (64, 128)

_SIG = {
    # q, q_is_f32, k, v, ksb, kss, ksh, o, b, t, S, n_heads, n_kv, hd,
    # pos_start, scale, split_tiles, splits, o_ws, m_ws, l_ws, stream
    "flash_attention_fwd": (
        kernels.P, kernels.I, kernels.P, kernels.P,
        kernels.LL, kernels.LL, kernels.LL, kernels.P,
        kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I,
        kernels.I, kernels.F, kernels.I, kernels.I,
        kernels.P, kernels.P, kernels.P, kernels.P,
    ),
    # q, q_is_f32, k, v, ksb, kss, ksh, o, b, t, S, n_heads, n_kv, hd,
    # pos_dev, pos_i64, row_dev, cache_b, scale, split_tiles, splits, o_ws,
    # m_ws, l_ws, stream
    "flash_attention_fwd_dev": (
        kernels.P, kernels.I, kernels.P, kernels.P,
        kernels.LL, kernels.LL, kernels.LL, kernels.P,
        kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I,
        kernels.P, kernels.I, kernels.P, kernels.I, kernels.F, kernels.I, kernels.I,
        kernels.P, kernels.P, kernels.P, kernels.P,
    ),
    # q, q_is_f32, k, v, ksb, kss, ksh, o, m, l, b, t, S, n_heads, n_kv, hd,
    # pos_start, col_offset, block_t, scale, split_tiles, splits, o_ws,
    # m_ws, l_ws, stream
    "flash_attention_partial_fwd": (
        kernels.P, kernels.I, kernels.P, kernels.P,
        kernels.LL, kernels.LL, kernels.LL, kernels.P, kernels.P, kernels.P,
        kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I,
        kernels.I, kernels.I, kernels.I, kernels.F, kernels.I, kernels.I,
        kernels.P, kernels.P, kernels.P, kernels.P,
    ),
}
# K3's and B8's plan (csrc/flash_attention.cu): score rows per CTA, KV rows
# per tile and the CTAs a call should reach (two per SM of an H100 SXM's 132)
FLASH_ROWS = 64
FLASH_TILE = 64
FLASH_TARGET_CTAS = 264


@dataclass(frozen=True)
class FlashPlan:
    """K3's and B8's split of the view's KV tiles: `splits` runs of
    `split_tiles` FLASH_TILE-row tiles (the last may be shorter), one CTA
    per (batch * kv head, `rows` score rows, split); a CTA whose run lies
    past its rows' causal limit exits with neutral partials."""

    rows: int
    split_tiles: int
    splits: int


def visible_tiles(t: int, S: int, pos_start: int, col_offset: int = 0) -> int:
    """KV tiles of a view of S rows whose row 0 is the global position
    col_offset that the chunk's last query (position pos_start + t - 1)
    sees."""
    kv_end = min(S, pos_start + t - col_offset)
    return -(-kv_end // FLASH_TILE) if kv_end > 0 else 0


def flash_plan(n_tiles: int, base_ctas: int) -> FlashPlan:
    """The split of `n_tiles` tiles over a grid of `base_ctas` (batch * kv
    head) x row-tile CTAs: the fewest splits of whole tiles that reach
    FLASH_TARGET_CTAS. A function of these two counts alone."""
    want = -(-FLASH_TARGET_CTAS // max(base_ctas, 1))
    splits = max(1, min(want, n_tiles))
    split_tiles = max(1, -(-n_tiles // splits))
    return FlashPlan(FLASH_ROWS, split_tiles, max(1, -(-n_tiles // split_tiles)))


def plan_for(q: torch.Tensor, k_view: torch.Tensor) -> FlashPlan:
    """The plan of one call: q [b, t, H, hd] against a [b, S, n_kv, hd]
    view, a function of these shapes alone (the JAX kernel's grid is):
    every tile of the view is some split's, whatever the position. K3 on
    a view and B8 on a shard of the same length split alike."""
    b, t, n_heads, _ = q.shape
    S, n_kv = k_view.shape[1], k_view.shape[2]
    base = b * n_kv * -(-(t * (n_heads // n_kv)) // FLASH_ROWS)
    return flash_plan(-(-S // FLASH_TILE), base)


_PAGED_SIG = {
    # q, q_is_f32, k_pool, v_pool, k_scale, v_scale, table, table_stride,
    # pos_base, out, b, t, n_heads, n_kv, hd, ps, n_read, n_pages, layer,
    # scale, split_pages, o_ws, m_ws, l_ws, tickets, stream
    "paged_attention_fwd": (
        kernels.P, kernels.I, kernels.P, kernels.P, kernels.P, kernels.P,
        kernels.P, kernels.I, kernels.P, kernels.P,
        kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I,
        kernels.I, kernels.LL, kernels.F, kernels.I,
        kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
    ),
}
PAGE_SIZE_MAX = 64
# K5's plan (csrc/paged_attention.cu): score rows per CTA, its warps, and
# the tokens a warp takes where pages are smaller
PAGED_ROWS = 4
PAGED_WARPS = 4
PAGED_WARP_TOKENS = 16


@dataclass(frozen=True)
class PagedPlan:
    """K5's split of a row's pages: split s covers the absolute pages
    [s * split_pages, (s + 1) * split_pages), one CTA per (batch * kv head,
    `rows` score rows, split); a CTA past its rows' last position exits."""

    rows: int
    split_pages: int

    def splits(self, n_read: int) -> int:
        """The grid's splits for a call reading n_read pages."""
        return -(-n_read // self.split_pages)

    def warp_pages(self) -> int:
        """The consecutive pages of a split that one of the CTA's
        PAGED_WARPS warps takes (the last warps of a short split none)."""
        return -(-self.split_pages // PAGED_WARPS)


def paged_plan(page_size: int, head_dim: int, g: int) -> PagedPlan:
    """K5's plan: a function of the page size, head_dim and the query heads
    per kv head alone, never of the batch, n_read or the positions, so a
    row's splits and sums are the same whoever shares its call and however
    many pages the bucket reads. A split is PAGED_WARPS warps' pages: one
    page a warp, or PAGED_WARP_TOKENS tokens of smaller pages, whatever
    head_dim and g (four 16-token pages: 512 CTAs for a batch-16 step at
    kv_len 256 at either model's width)."""
    return PagedPlan(PAGED_ROWS, PAGED_WARPS * max(1, PAGED_WARP_TOKENS // page_size))


def flash_attention_aligned(q: torch.Tensor, k_cache: torch.Tensor, t: int) -> bool:
    """The JAX package's gate (`flash_attention_aligned`): a prefill-sized q
    block, uniform head grouping, a lane-aligned cache length."""
    _, _, n_heads, head_dim = q.shape
    return (
        t >= 8
        and n_heads % k_cache.shape[2] == 0
        and head_dim % 8 == 0
        and k_cache.shape[1] % 128 == 0
    )


def _query_block(t: int, block_t: int = DEFAULT_BLOCK_T) -> int:
    """The JAX kernel's query block: min(block_t, t), halved until it
    divides t (`_flash_operands`)."""
    bt = min(block_t, t)
    while t % bt:
        bt //= 2
    return bt


def _flash_blocks(q, k_cache, v_cache, pos_start: int, col_offset: int, scale: float,
                  block_t: int, block_s: int):
    """The Pallas kernels' blocked loop (`_attend_block`) in torch: query
    blocks of `_query_block(t)` tokens, KV blocks of min(block_s, S) rows
    halved until they divide S, a block skipped unless its first global
    column col_offset + si * bs is at or before the query block's last
    position. Returns the unnormalized (acc [b * n_kv, t * g, hd], m, l
    [b * n_kv, t * g, 1]) in f32, rows folded as `_flash_operands` folds
    them. Dots take exact products of bf16 values in f32."""
    b, t, n_heads, hd = q.shape
    S, n_kv = k_cache.shape[1], k_cache.shape[2]
    g = n_heads // n_kv
    bt = _query_block(t, block_t)
    bs = min(block_s, S)
    while S % bs:
        bs //= 2
    cdt = k_cache.dtype if k_cache.dtype == torch.bfloat16 else q.dtype
    # rows = token * g + head-in-group, as _flash_operands folds them
    q4 = (
        q.reshape(b, t, n_kv, g, hd).permute(0, 2, 1, 3, 4)
        .reshape(b * n_kv, t * g, hd).to(cdt).to(torch.float32)
    )
    k3 = k_cache.permute(0, 2, 1, 3).reshape(b * n_kv, S, hd).to(torch.float32)
    v3 = v_cache.permute(0, 2, 1, 3).reshape(b * n_kv, S, hd)
    vdt = v3.dtype
    v3 = v3.to(torch.float32)
    rows = bt * g
    accs, ms, ls = [], [], []
    for ti in range(t // bt):
        qb = q4[:, ti * rows : (ti + 1) * rows]
        m = torch.full((b * n_kv, rows, 1), NEG_INF, device=q.device)
        l = torch.zeros((b * n_kv, rows, 1), device=q.device)
        acc = torch.zeros((b * n_kv, rows, hd), device=q.device)
        row_pos = pos_start + ti * bt + torch.arange(rows, device=q.device)[:, None] // g
        last_pos = pos_start + ti * bt + bt - 1
        for si in range(S // bs):
            if col_offset + si * bs > last_pos:
                continue
            s = torch.matmul(qb, k3[:, si * bs : (si + 1) * bs].transpose(1, 2)) * scale
            col_pos = col_offset + si * bs + torch.arange(bs, device=q.device)[None, :]
            vis = col_pos <= row_pos  # [rows, bs]
            s = torch.where(vis, s, NEG_INF)
            m_cur = torch.maximum(s.amax(dim=-1, keepdim=True), m)
            m_safe = torch.clamp(m_cur, min=NEG_INF / 2)
            corr = torch.exp(m - m_safe)
            p = torch.where(vis, torch.exp(s - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            pv = torch.matmul(p.to(vdt).to(torch.float32), v3[:, si * bs : (si + 1) * bs])
            acc = acc * corr + pv
            m = m_safe
        accs.append(acc)
        ms.append(m)
        ls.append(l)
    return torch.cat(accs, dim=1), torch.cat(ms, dim=1), torch.cat(ls, dim=1)


def _unfold(x: torch.Tensor, b: int, t: int, n_kv: int) -> torch.Tensor:
    """[b * n_kv, t * g, ...] folded rows -> [b, t, n_kv * g, ...]."""
    g = x.shape[1] // t
    rest = x.shape[2:]
    return (
        x.reshape(b, n_kv, t, g, *rest).transpose(1, 2).reshape(b, t, n_kv * g, *rest)
    )


def flash_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos_start,
    scale: float | None = None,
    block_t: int = DEFAULT_BLOCK_T,
    block_s: int = DEFAULT_BLOCK_S,
) -> torch.Tensor:
    """K3's plain version: q [b, t, H, hd], k/v [b, S, n_kv, hd] -> [b, t, H,
    hd] in q.dtype. `pos_start`: an int or a 0-d tensor (read on the
    host)."""
    b, t, _, hd = q.shape
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    acc, _, l = _flash_blocks(q, k_cache, v_cache, int(pos_start), 0, scale, block_t, block_s)
    out = acc / torch.clamp(l, min=1e-30)
    return _unfold(out, b, t, k_cache.shape[2]).to(q.dtype)


def flash_attention_partial_plain(
    q: torch.Tensor,
    k_local: torch.Tensor,
    v_local: torch.Tensor,
    pos_start: int,
    col_offset: int,
    scale: float | None = None,
    block_t: int = DEFAULT_BLOCK_T,
    block_s: int = DEFAULT_BLOCK_S,
) -> tuple:
    """B8's plain version: q [b, t, H, hd], one shard's k/v [b, S_local,
    n_kv, hd] whose row 0 is the global position `col_offset` -> (o [b, t,
    H, hd], m [b, t, H], l [b, t, H]), all f32, o unnormalized."""
    b, t, _, hd = q.shape
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    acc, m, l = _flash_blocks(q, k_local, v_local, pos_start, col_offset, scale, block_t,
                              block_s)
    n_kv = k_local.shape[2]
    return _unfold(acc, b, t, n_kv), _unfold(m[..., 0], b, t, n_kv), _unfold(l[..., 0], b, t, n_kv)


def _merge(parts) -> tuple:
    """Unnormalized (acc, m, l) states merged in order: M = max m_i, then acc
    and l summed with weights e^(m_i - M), as the kernel merges its warps
    and its splits."""
    M = parts[0][1]
    for _, m_i, _ in parts[1:]:
        M = torch.maximum(M, m_i)
    acc = l = None
    for a_i, m_i, l_i in parts:
        f = torch.exp(m_i - M)
        acc = a_i * f if acc is None else acc + a_i * f
        l = l_i * f if l is None else l + l_i * f
    return acc, M, l


def flash_split_plain(q, k_view, v_view, pos_start: int, col_offset: int = 0,
                      scale: float | None = None, plan: FlashPlan | None = None) -> tuple:
    """The kernel's blocking on the CPU: FLASH_ROWS-row tiles of folded
    score rows, each cutting its visible KV range (up to its own last
    row's position) into the plan's splits of FLASH_TILE-row tiles, the
    online softmax tile by tile within a split, and the splits combined in
    split order (M = max m_s, o and l summed with weights e^(m_s - M)).
    Returns B8's (o [b, t, H, hd], m, l [b, t, H]) f32, unnormalized, with
    the JAX kernel's m on rows that see no column; K3 is o / max(l, 1e-30).
    Dots take exact products of bf16 values in f32."""
    b, t, n_heads, hd = q.shape
    S, n_kv = k_view.shape[1], k_view.shape[2]
    g = n_heads // n_kv
    n_rows = t * g
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    if plan is None:
        plan = plan_for(q, k_view)
    q4 = (q.reshape(b, t, n_kv, g, hd).permute(0, 2, 1, 3, 4).reshape(b * n_kv, n_rows, hd)
          .to(torch.bfloat16).to(torch.float32))
    k3 = k_view.permute(0, 2, 1, 3).reshape(b * n_kv, S, hd).to(torch.float32)
    v3 = v_view.permute(0, 2, 1, 3).reshape(b * n_kv, S, hd).to(torch.float32)
    row_pos = pos_start + torch.arange(n_rows)[:, None] // g
    accs, ms, ls = [], [], []
    for r0 in range(0, n_rows, plan.rows):
        rows = slice(r0, min(r0 + plan.rows, n_rows))
        pos_r = row_pos[rows]
        n_t = visible_tiles(1, S, pos_start + (rows.stop - 1) // g, col_offset)
        parts = []
        for sp in range(plan.splits):
            m = torch.full((b * n_kv, rows.stop - r0, 1), NEG_INF)
            l = torch.zeros_like(m)
            acc = torch.zeros((b * n_kv, rows.stop - r0, hd))
            for j in range(sp * plan.split_tiles, min(n_t, (sp + 1) * plan.split_tiles)):
                cols = torch.arange(j * FLASH_TILE, min((j + 1) * FLASH_TILE, S))
                s = torch.matmul(q4[:, rows], k3[:, cols].transpose(1, 2)) * scale
                vis = col_offset + cols[None, :] <= pos_r
                s = torch.where(vis, s, NEG_INF)
                m_safe = torch.clamp(torch.maximum(s.amax(dim=-1, keepdim=True), m), min=NEG_INF / 2)
                corr = torch.exp(m - m_safe)
                p = torch.where(vis, torch.exp(s - m_safe), 0.0)
                l = l * corr + p.sum(dim=-1, keepdim=True)
                acc = acc * corr + torch.matmul(p.to(torch.bfloat16).to(torch.float32), v3[:, cols])
                m = m_safe
            parts.append((acc, m, l))
        acc, m, l = _merge(parts)
        accs.append(acc)
        ms.append(m)
        ls.append(l)
    acc, m, l = torch.cat(accs, dim=1), torch.cat(ms, dim=1)[..., 0], torch.cat(ls, dim=1)[..., 0]
    bt = _query_block(t)
    tok = torch.arange(n_rows) // g
    blind = torch.where(col_offset <= pos_start + (tok // bt) * bt + bt - 1, NEG_INF / 2, NEG_INF)
    m = torch.where(m > NEG_INF / 2, m, blind.expand_as(m))
    return _unfold(acc, b, t, n_kv), _unfold(m, b, t, n_kv), _unfold(l, b, t, n_kv)


def _check_launch(q, k_cache, v_cache) -> None:
    hd = q.shape[3]
    if k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16:
        raise TypeError("the flash kernels take a bfloat16 cache")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if k_cache.shape != v_cache.shape or k_cache.stride() != v_cache.stride():
        raise ValueError("k and v views must share shape and strides")
    if k_cache.stride(-1) != 1:
        raise ValueError("the cache's head_dim axis must have unit stride")
    for t_ in (q, k_cache, v_cache):
        if t_.device != q.device:
            raise ValueError("q, k and v must be on one device")


def _workspace(q, n_kv: int, plan: FlashPlan) -> tuple:
    """The splits' (o, m, l) for the combine pass (None with one split):
    [splits, b * n_kv, t * g, hd] and [splits, b * n_kv, t * g] f32."""
    if plan.splits == 1:
        return None, None, None
    b, t, n_heads, hd = q.shape
    rows = (plan.splits, b * n_kv, t * n_heads // n_kv)
    ml = torch.empty((2, *rows), dtype=torch.float32, device=q.device)
    return torch.empty((*rows, hd), dtype=torch.float32, device=q.device), ml[0], ml[1]


def _ptrs(tensors) -> list:
    return [None if x is None else x.data_ptr() for x in tensors]


def _check_device_position(pos: torch.Tensor, q: torch.Tensor) -> None:
    if pos.numel() != 1 or pos.ndim > 1 or pos.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"a device position is one int32 or int64, got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    if pos.device != q.device:
        raise ValueError(f"the position is on {pos.device}, q on {q.device}")


def _launch(q, k_cache, v_cache, pos_start, scale: float, row=None) -> torch.Tensor:
    """K3 at an int `pos_start` (`flash_attention_fwd`) or at a 0-d device
    tensor the kernel reads (`flash_attention_fwd_dev`, there with the
    cache row `row` read on the device too), on the one plan."""
    b, t, n_heads, hd = q.shape
    S, n_kv = k_cache.shape[1], k_cache.shape[2]
    _check_launch(q, k_cache, v_cache)
    plan = plan_for(q, k_cache)
    lib = kernels.load("flash_attention", _SIG)
    out = torch.empty((b, t, n_heads, hd), dtype=torch.float32, device=q.device)
    ws = _workspace(q, n_kv, plan)
    ksb, kss, ksh, _ = k_cache.stride()
    head = (q.data_ptr(), int(q.dtype == torch.float32), k_cache.data_ptr(),
            v_cache.data_ptr(), ksb, kss, ksh, out.data_ptr(), b, t, S, n_heads, n_kv, hd)
    if row is not None and not isinstance(pos_start, torch.Tensor):
        raise ValueError("a device row needs a device position")
    if isinstance(pos_start, torch.Tensor):
        _check_device_position(pos_start, q)
        kernels.launch(lib, "flash_attention_fwd_dev", q, *head, pos_start.data_ptr(),
                       int(pos_start.dtype == torch.int64),
                       None if row is None else row.data_ptr(), k_cache.shape[0], float(scale),
                       plan.split_tiles, plan.splits, *_ptrs(ws))
    else:
        kernels.launch(lib, "flash_attention_fwd", q, *head, int(pos_start), float(scale),
                       plan.split_tiles, plan.splits, *_ptrs(ws))
    return out.to(q.dtype)


def _launch_partial(q, k_local, v_local, pos_start: int, col_offset: int, scale: float) -> tuple:
    b, t, n_heads, hd = q.shape
    S, n_kv = k_local.shape[1], k_local.shape[2]
    _check_launch(q, k_local, v_local)
    plan = plan_for(q, k_local)
    lib = kernels.load("flash_attention", _SIG)
    o = torch.empty((b, t, n_heads, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, t, n_heads), dtype=torch.float32, device=q.device)
    l = torch.empty((b, t, n_heads), dtype=torch.float32, device=q.device)
    ws = _workspace(q, n_kv, plan)
    ksb, kss, ksh, _ = k_local.stride()
    kernels.launch(
        lib, "flash_attention_partial_fwd", q,
        q.data_ptr(), int(q.dtype == torch.float32), k_local.data_ptr(), v_local.data_ptr(),
        ksb, kss, ksh, o.data_ptr(), m.data_ptr(), l.data_ptr(), b, t, S, n_heads, n_kv, hd,
        pos_start, col_offset, _query_block(t), float(scale), plan.split_tiles, plan.splits,
        *_ptrs(ws),
    )
    return o, m, l


def _check_device_row(row: torch.Tensor, q: torch.Tensor, k_cache: torch.Tensor) -> None:
    if row.shape != (1,) or row.dtype != torch.int64:
        raise ValueError(f"a device row is one int64 in a [1] tensor, got {row.dtype} "
                         f"{tuple(row.shape)}")
    if row.device != q.device:
        raise ValueError(f"the row is on {row.device}, q on {q.device}")
    if q.shape[0] != 1:
        raise ValueError(f"a device row serves a one-row q, got {q.shape[0]} rows")


def _check_flash_shapes(q, k_cache) -> None:
    if q.ndim != 4 or k_cache.ndim != 4 or q.shape[0] != k_cache.shape[0]:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k_cache.shape)}")
    if q.shape[2] % k_cache.shape[2] or q.shape[3] != k_cache.shape[3]:
        raise ValueError("head counts or head_dim disagree")


def _visible_keys(t: int, pos_start: int, col_offset: int, S: int) -> tuple:
    """(sum over the t queries of the keys each sees, the most any sees):
    query i at pos_start + i sees the rows of [col_offset, col_offset + S)
    at or below its position."""
    vis = [min(max(pos_start + i + 1 - col_offset, 0), S) for i in range(t)]
    return sum(vis), max(vis)


def _attention_cost(name, q, k, pairs: int, rows: int, extra: int, make):
    """The census entry of one attention call: QK and PV dots over `pairs`
    (query, key) pairs a head; q, `rows` K and V rows a batch row, and
    `extra` bytes (the outputs, the paged tables and scales) moved once."""
    b, _, H, hd = q.shape
    kv_row = k.shape[-2] * k.shape[-1] * k.element_size()
    moved = census.nbytes(q) + 2 * b * rows * kv_row + extra
    return census.meta_kernel(name, 4.0 * b * H * hd * pairs, moved, make)


def flash_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos_start,
    scale: float | None = None,
    row: torch.Tensor | None = None,
) -> torch.Tensor:
    """Blocked causal GQA attention with positions = pos_start + arange(t);
    the contract of `gqa_attention`. q [b, t, H, hd]; k/v [b, S, n_kv, hd]
    (views of the stacked cache are read in place); `pos_start` an int or
    a 0-d int32/int64 tensor on q's device, which the kernel reads (no
    host sync: a CUDA graph's operand). `row`: a [1] int64 tensor on q's
    device naming the one cache row a one-row q reads from k/v [B, S, n_kv,
    hd] (with a device position): the kernel reads it too, so a graph of
    one batch row's chunk reads that row in place, at any row. Returns
    q.dtype."""
    if row is not None:
        _check_device_row(row, q, k_cache)
        k_one = k_cache[:1]
    else:
        k_one = k_cache
    _check_flash_shapes(q, k_one)
    if scale is None:
        scale = 1.0 / (q.shape[3] ** 0.5)
    if q.device.type == "meta":
        k_cache = k_one
        # a device position has no value here: the census takes the chunk
        # that ends at the view's last row, the most its causal limit reads
        p = (k_cache.shape[1] - q.shape[1] if isinstance(pos_start, torch.Tensor)
             else int(pos_start))
        pairs, rows = _visible_keys(q.shape[1], p, 0, k_cache.shape[1])
        return _attention_cost("flash_attention", q, k_cache, pairs, rows, census.nbytes(q),
                               lambda: torch.empty_like(q))
    if q.device.type == "cpu":
        if row is not None:
            k_cache, v_cache = k_cache.index_select(0, row), v_cache.index_select(0, row)
        return flash_attention_plain(q, k_cache, v_cache, pos_start, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = _launch(q, k_cache, v_cache,
                  pos_start if isinstance(pos_start, torch.Tensor) else int(pos_start), scale,
                  row)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_partial(
    q: torch.Tensor,
    k_local: torch.Tensor,
    v_local: torch.Tensor,
    pos_start: int,
    col_offset: int,
    scale: float | None = None,
) -> tuple:
    """Shard-local blocked attention (B8) for the sequence-parallel combine:
    q [b, t, H, hd] at positions pos_start + arange(t); one shard's k/v [b,
    S_local, n_kv, hd] (views read in place) whose row 0 is the global
    position `col_offset`. Returns the unnormalized (o [b, t, H, hd], m [b,
    t, H], l [b, t, H]), all f32, in fresh tensors."""
    _check_flash_shapes(q, k_local)
    if scale is None:
        scale = 1.0 / (q.shape[3] ** 0.5)
    if q.device.type == "meta":
        b, t, H, hd = q.shape
        pairs, rows = _visible_keys(t, int(pos_start), int(col_offset), k_local.shape[1])

        def make():
            f32 = dict(dtype=torch.float32, device=q.device)
            return (torch.empty((b, t, H, hd), **f32), torch.empty((b, t, H), **f32),
                    torch.empty((b, t, H), **f32))

        return _attention_cost("flash_attention_partial", q, k_local, pairs, rows,
                               b * t * H * (hd + 2) * 4, make)
    if q.device.type == "cpu":
        return flash_attention_partial_plain(q, k_local, v_local, int(pos_start),
                                             int(col_offset), scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = _launch_partial(q, k_local, v_local, int(pos_start), int(col_offset), scale)
    flash_attention_partial.launches += 1
    return out


flash_attention_partial.launches = 0


def paged_attention_eligible(q: torch.Tensor, n_kv: int, page_size: int) -> bool:
    """The JAX package's `_fused_paged_eligible` shape gate: decode-sized q
    blocks (at most one page of queries) and uniform head grouping. The
    caller adds the dtype conditions (an int8 pool, the bf16 kernel path)."""
    _, t, n_heads, head_dim = q.shape
    return t <= page_size and n_heads % n_kv == 0 and head_dim % 8 == 0


def _paged_fold(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q [b, t, H, hd] -> [b, n_kv, t * g, hd] f32, rows folded as
    `_paged_kernel` folds them (row R: token R // g, head kvh * g + R % g)."""
    b, t, n_heads, hd = q.shape
    g = n_heads // n_kv
    return (
        q.reshape(b, t, n_kv, g, hd).permute(0, 2, 1, 3, 4)
        .reshape(b, n_kv, t * g, hd).to(torch.float32)
    )


def _paged_pages(q4, k_pool, v_pool, k_scale, v_scale, layer: int, pos_base, page_table,
                 pages, page_size: int, t: int, scale: float) -> tuple:
    """The online softmax over `pages` (an index range) of every row, in
    order, from the empty state: a page past a row's last query position
    (pos_base + t - 1) leaves that row's state as it was. Returns the
    unnormalized (acc [b, n_kv, rows, hd], m, l [b, n_kv, rows, 1]) f32."""
    b, n_kv, rows, hd = q4.shape
    g = rows // t
    ps = page_size
    dev = q4.device
    table = page_table.clamp(min=0).long()
    pos = pos_base.long()
    row_pos = pos[:, None, None, None] + (torch.arange(rows, device=dev) // g)[None, None, :, None]
    last_pos = pos + t - 1
    m = torch.full((b, n_kv, rows, 1), NEG_INF, device=dev)
    l = torch.zeros((b, n_kv, rows, 1), device=dev)
    acc = torch.zeros((b, n_kv, rows, hd), device=dev)
    for si in pages:
        phys = table[:, si]
        k = k_pool[layer, phys].to(torch.float32) * k_scale[layer, phys].unsqueeze(-1)
        v = v_pool[layer, phys].to(torch.float32) * v_scale[layer, phys].unsqueeze(-1)
        k = k.permute(0, 2, 1, 3)  # [b, n_kv, ps, hd]
        v = v.permute(0, 2, 1, 3)
        s = _f32_matmul(q4, k.transpose(-1, -2)) * scale  # [b, n_kv, rows, ps]
        col_pos = si * ps + torch.arange(ps, device=dev)
        vis = col_pos <= row_pos  # [b, 1, rows, ps]
        s = torch.where(vis, s, NEG_INF)
        m_cur = torch.maximum(s.amax(dim=-1, keepdim=True), m)
        m_safe = torch.clamp(m_cur, min=NEG_INF / 2)
        corr = torch.exp(m - m_safe)
        p = torch.where(vis, torch.exp(s - m_safe), 0.0)
        l_new = l * corr + p.sum(dim=-1, keepdim=True)
        acc_new = acc * corr + _f32_matmul(p, v)
        live = (si * ps <= last_pos)[:, None, None, None]
        m = torch.where(live, m_safe, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    return acc, m, l


def _paged_unfold(out: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    b, t, n_heads, hd = q.shape
    n_kv = out.shape[1]
    return (
        out.reshape(b, n_kv, t, n_heads // n_kv, hd).permute(0, 2, 1, 3, 4)
        .reshape(b, t, n_heads, hd).to(q.dtype)
    )


def paged_flash_attention_plain(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    layer: int,
    pos_base: torch.Tensor,
    page_table: torch.Tensor,
    n_read: int,
    page_size: int,
    scale: float | None = None,
) -> torch.Tensor:
    """K5's plain version: q [b, t, H, hd]; pools [L, P, ps, n_kv, hd] int8
    with [L, P, ps, n_kv] f32 scales; pos_base [b]; page_table [b, >=
    n_read] (-1 = unmapped) -> [b, t, H, hd] in q.dtype. Page by page, as
    `_paged_kernel` walks them; a page past a row's last query position
    leaves that row's state as it was."""
    t, hd = q.shape[1], q.shape[3]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    q4 = _paged_fold(q, k_pool.shape[3])
    acc, _, l = _paged_pages(q4, k_pool, v_pool, k_scale, v_scale, layer, pos_base, page_table,
                             range(n_read), page_size, t, scale)
    return _paged_unfold(acc / torch.clamp(l, min=1e-30), q)


def paged_split_plain(q, k_pool, v_pool, k_scale, v_scale, layer: int, pos_base, page_table,
                      n_read: int, page_size: int, scale: float | None = None,
                      plan: PagedPlan | None = None) -> torch.Tensor:
    """The kernel's blocking on the CPU: the pages cut into splits of
    `plan.split_pages` absolute pages (default: `paged_plan`'s), each split
    into PAGED_WARPS runs of `plan.warp_pages()` pages (the CTA's warps),
    the online softmax page by page within a run from the empty state, the
    runs merged in warp order and the splits in split order (`_merge`),
    then o / max(l, 1e-30). A run or split past a row's last position adds
    exact zeros, as the kernel's warp or CTA that has nothing to read.
    Returns [b, t, H, hd] in q.dtype."""
    t, hd = q.shape[1], q.shape[3]
    n_kv = k_pool.shape[3]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    if plan is None:
        plan = paged_plan(page_size, hd, q.shape[2] // n_kv)
    q4 = _paged_fold(q, n_kv)
    wp = plan.warp_pages()
    splits = []
    for s0 in range(0, n_read, plan.split_pages):
        s1 = min(n_read, s0 + plan.split_pages)
        runs = [_paged_pages(q4, k_pool, v_pool, k_scale, v_scale, layer, pos_base, page_table,
                             range(w0, min(s1, w0 + wp)), page_size, t, scale)
                for w0 in range(s0, s0 + PAGED_WARPS * wp, wp)]
        splits.append(_merge(runs))
    acc, _, l = _merge(splits)
    return _paged_unfold(acc / torch.clamp(l, min=1e-30), q)


def _check_paged(q, k_pool, v_pool, k_scale, v_scale, layer, pos_base, page_table,
                 n_read, page_size) -> int:
    b, t, n_heads, hd = q.shape
    if k_pool.ndim != 5 or k_pool.shape != v_pool.shape:
        raise ValueError(f"expected [L, P, ps, n_kv, hd] pools, got {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)}")
    L, P, ps, n_kv, hd_pool = k_pool.shape
    if k_scale.shape != (L, P, ps, n_kv) or v_scale.shape != k_scale.shape:
        raise ValueError(f"scales {tuple(k_scale.shape)} do not match the pool {tuple(k_pool.shape)}")
    if hd_pool != hd or n_heads % n_kv or ps != page_size:
        raise ValueError("head counts, head_dim or page size disagree")
    if page_table.ndim != 2 or page_table.shape[0] != b or not 1 <= n_read <= page_table.shape[1]:
        raise ValueError(f"page table {tuple(page_table.shape)} for {b} rows and n_read {n_read}")
    if pos_base.shape != (b,):
        raise ValueError(f"pos_base must be [{b}], got {tuple(pos_base.shape)}")
    li = int(layer)
    if not 0 <= li < L:
        raise IndexError(f"layer {li} out of range for a {L}-layer pool")
    return li


def _launch_paged(q, k_pool, v_pool, k_scale, v_scale, layer, pos_base, page_table,
                  n_read, page_size, scale) -> torch.Tensor:
    b, t, n_heads, hd = q.shape
    _, P, ps, n_kv, _ = k_pool.shape
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise TypeError("paged_flash_attention's kernel takes an int8 pool")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("the pool's scales must be float32")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if ps > PAGE_SIZE_MAX or ps & (ps - 1) or t > ps:
        raise ValueError(f"page size {ps} must be a power of two <= {PAGE_SIZE_MAX} and >= t = {t}")
    if page_table.dtype != torch.int32 or pos_base.dtype != torch.int64:
        raise TypeError(f"page table must be int32 and pos_base int64, got {page_table.dtype} / "
                        f"{pos_base.dtype}")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("k_scale", k_scale),
                    ("v_scale", v_scale), ("pos_base", pos_base)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if page_table.device != q.device or page_table.stride(1) != 1:
        raise ValueError("the page table must be on q's device with unit column stride")
    if q.data_ptr() % 16:
        q = q.clone()  # the kernel loads q 16 bytes at a time
    plan = paged_plan(ps, hd, n_heads // n_kv)
    splits = plan.splits(int(n_read))
    lib = kernels.load("paged_attention", _PAGED_SIG)
    out = torch.empty_like(q)
    ws = (None,) * 4
    if splits > 1:
        rows = (splits, b * n_kv, t * n_heads // n_kv)
        ml = torch.empty((2, *rows), dtype=torch.float32, device=q.device)
        tiles = b * n_kv * -(-rows[2] // plan.rows)
        ws = (torch.empty((*rows, hd), dtype=torch.float32, device=q.device), ml[0], ml[1],
              _tickets(q.device, tiles))
    kernels.launch(
        lib, "paged_attention_fwd", q,
        q.data_ptr(), int(q.dtype == torch.float32), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(), page_table.stride(0),
        pos_base.data_ptr(), out.data_ptr(), b, t, n_heads, n_kv, hd, ps, int(n_read), P,
        int(layer), float(scale), plan.split_pages, *_ptrs(ws),
    )
    return out


_TICKETS: dict = {}  # device -> int32 counters, 0 between calls
_TICKETS_MIN = 1 << 14


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """K5's zeroed per-(batch * kv head, row tile) counters on `device`, at
    least n of them. The kernel's last CTA of each group resets its counter,
    so one buffer serves every call on the device (and a graph replay); it
    is reallocated only to grow. Calls on one device must not overlap on two
    streams."""
    buf = _TICKETS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, _TICKETS_MIN), dtype=torch.int32, device=device)
        _TICKETS[device] = buf
    return buf


def paged_flash_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    layer: int,
    pos_base: torch.Tensor,
    page_table: torch.Tensor,
    n_read: int,
    page_size: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Int8 paged GQA decode attention (B6): q [b, t <= page_size, H, hd];
    pools [L, P, ps, n_kv, hd] int8 with [L, P, ps, n_kv] f32 scales;
    `layer` a host int; pos_base [b] int64, each row's first query
    position; page_table [b, >= n_read] int32 (-1 = unmapped), both on the
    device. Returns [b, t, H, hd] in q.dtype. Nothing syncs with the host."""
    if q.ndim != 4:
        raise ValueError(f"q must be [b, t, H, hd], got {tuple(q.shape)}")
    li = _check_paged(q, k_pool, v_pool, k_scale, v_scale, layer, pos_base, page_table,
                      n_read, page_size)
    if scale is None:
        scale = 1.0 / (q.shape[3] ** 0.5)
    if q.device.type == "meta":
        # the rows' n_read pages of int8 K and V with their f32 scales, the
        # tables and positions once; where each row's causal limit falls is
        # data, so every key of the pages read counts
        b, t = q.shape[0], q.shape[1]
        rows = n_read * page_size
        scales = 2 * b * rows * k_scale.shape[-1] * k_scale.element_size()
        extra = census.nbytes(q) + scales + b * n_read * 4 + census.nbytes(pos_base)
        return _attention_cost("paged_flash_attention", q, k_pool, t * rows, rows, extra,
                               lambda: torch.empty_like(q))
    if q.device.type == "cpu":
        return paged_flash_attention_plain(q, k_pool, v_pool, k_scale, v_scale, li, pos_base,
                                           page_table, n_read, page_size, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = _launch_paged(q.contiguous(), k_pool, v_pool, k_scale, v_scale, li, pos_base,
                        page_table, n_read, page_size, scale)
    paged_flash_attention.launches += 1
    return out


paged_flash_attention.launches = 0

KERNELS = (flash_attention, flash_attention_partial, paged_flash_attention)
