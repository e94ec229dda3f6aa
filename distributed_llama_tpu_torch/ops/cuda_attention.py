"""K3: causal GQA flash attention for prefill chunks, beside its plain
PyTorch version.

`flash_attention` (csrc/flash_attention.cu) replaces the JAX package's
`ops/pallas_attention.py:flash_attention` (:199), bodies `_attend_block`
(:46) and `_kernel` (:103): blocked causal attention from a scalar
`pos_start` with an f32 online softmax (m clamped to NEG_INF / 2, l to
1e-30, P cast to the V dtype before PV), the g query heads of a KV head
folded into the score rows. The kernel reads the cache in place through its
strides; the plain version repeats the Pallas kernel's blocking (query
blocks of min(512, t), KV blocks of min(1024, S), invisible blocks skipped)
so that it follows the JAX kernel's rounding as closely as torch allows.

The wrapper takes the plain version for a tensor on the CPU, launches the
kernel for a tensor on the card (or raises), and counts its launches in the
plain int attribute `launches`.
"""

from __future__ import annotations

import torch

from . import kernels

NEG_INF = float(torch.finfo(torch.float32).min)
DEFAULT_BLOCK_T = 512
DEFAULT_BLOCK_S = 1024
HEAD_DIMS = (64, 128)

_SIG = {
    # q, q_is_f32, k, v, ksb, kss, ksh, o, b, t, S, n_heads, n_kv, hd,
    # pos_start, scale, stream
    "flash_attention_fwd": (
        kernels.P, kernels.I, kernels.P, kernels.P,
        kernels.LL, kernels.LL, kernels.LL, kernels.P,
        kernels.I, kernels.I, kernels.I, kernels.I, kernels.I, kernels.I,
        kernels.I, kernels.F, kernels.P,
    ),
}


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


def flash_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos_start: int,
    scale: float | None = None,
    block_t: int = DEFAULT_BLOCK_T,
    block_s: int = DEFAULT_BLOCK_S,
) -> torch.Tensor:
    """K3's plain version: q [b, t, H, hd], k/v [b, S, n_kv, hd] -> [b, t, H,
    hd] in q.dtype. Dots take exact products of bf16 values in f32."""
    b, t, n_heads, hd = q.shape
    S, n_kv = k_cache.shape[1], k_cache.shape[2]
    g = n_heads // n_kv
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    bt = min(block_t, t)
    while t % bt:
        bt //= 2
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
    out = torch.empty((b * n_kv, t * g, hd), dtype=torch.float32, device=q.device)
    rows = bt * g
    for ti in range(t // bt):
        qb = q4[:, ti * rows : (ti + 1) * rows]
        m = torch.full((b * n_kv, rows, 1), NEG_INF, device=q.device)
        l = torch.zeros((b * n_kv, rows, 1), device=q.device)
        acc = torch.zeros((b * n_kv, rows, hd), device=q.device)
        row_pos = pos_start + ti * bt + torch.arange(rows, device=q.device)[:, None] // g
        last_pos = pos_start + ti * bt + bt - 1
        for si in range(S // bs):
            if si * bs > last_pos:
                continue
            s = torch.matmul(qb, k3[:, si * bs : (si + 1) * bs].transpose(1, 2)) * scale
            col_pos = si * bs + torch.arange(bs, device=q.device)[None, :]
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
        out[:, ti * rows : (ti + 1) * rows] = acc / torch.clamp(l, min=1e-30)
    return (
        out.reshape(b, n_kv, t, g, hd).permute(0, 2, 1, 3, 4)
        .reshape(b, t, n_heads, hd).to(q.dtype)
    )


def _launch(q, k_cache, v_cache, pos_start: int, scale: float) -> torch.Tensor:
    b, t, n_heads, hd = q.shape
    S, n_kv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16:
        raise TypeError("flash_attention's kernel takes a bfloat16 cache")
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
    lib = kernels.load("flash_attention", _SIG)
    out = torch.empty((b, t, n_heads, hd), dtype=torch.float32, device=q.device)
    ksb, kss, ksh, _ = k_cache.stride()
    rc = lib.flash_attention_fwd(
        q.data_ptr(), int(q.dtype == torch.float32), k_cache.data_ptr(),
        v_cache.data_ptr(), ksb, kss, ksh, out.data_ptr(), b, t, S, n_heads,
        n_kv, hd, int(pos_start), float(scale), kernels.stream_of(q),
    )
    kernels.check(lib, rc, "flash_attention_fwd")
    return out.to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos_start: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Blocked causal GQA attention with positions = pos_start + arange(t);
    the contract of `gqa_attention`. q [b, t, H, hd]; k/v [b, S, n_kv, hd]
    (views of the stacked cache are read in place). Returns q.dtype."""
    if q.ndim != 4 or k_cache.ndim != 4 or q.shape[0] != k_cache.shape[0]:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k_cache.shape)}")
    if q.shape[2] % k_cache.shape[2] or q.shape[3] != k_cache.shape[3]:
        raise ValueError("head counts or head_dim disagree")
    if scale is None:
        scale = 1.0 / (q.shape[3] ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k_cache, v_cache, int(pos_start), scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = _launch(q, k_cache, v_cache, int(pos_start), scale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

KERNELS = (flash_attention,)
