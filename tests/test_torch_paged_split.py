"""The blocking of K5 (int8 paged decode attention) and K4 (the MoE grouped
Q40 GEMM) as the CUDA kernels run it, on the CPU: the planners
(`cuda_attention.paged_plan`, `cuda_q40.grouped_plan`), the plans and
workspaces the wrappers hand the kernels, and a plain torch rendition of
each blocking (`paged_split_plain`, `q40_grouped_gemm_bf16_blocked`)
against the JAX package's Pallas kernels run with interpret=True. Inputs
come from numpy with a seed. The kernels themselves:
tests/test_torch_kernels_gpu.py.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops import pallas_attention as jpa
from distributed_llama_tpu.ops import pallas_q40 as jp
from distributed_llama_tpu_torch.ops import cuda_attention as pca
from distributed_llama_tpu_torch.ops import cuda_q40, kernels
from distributed_llama_tpu_torch.ops.moe import _grouped_layout_direct
from distributed_llama_tpu_torch.ops.quant import pack_q

# tiny shapes: torch's intra-op threads would only contend with the JAX
# tests that share the CPU under pytest-xdist
torch.set_num_threads(1)


class _Captured:
    """kernels.load / kernels.launch stand-ins that record each launch's
    arguments, so the wrappers' launch paths run on the CPU."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(kernels, "load", lambda name, sig: name)
        monkeypatch.setattr(kernels, "launch", lambda lib, fn, t, *args: self.calls.append((fn, args)))


# -- K5: paged_plan and paged_split_plain --------------------------------------


def test_paged_plan_takes_the_shape_alone():
    assert list(inspect.signature(pca.paged_plan).parameters) == ["page_size", "head_dim", "g"]


@pytest.mark.parametrize("ps", [1, 4, 16, 32, 64])
@pytest.mark.parametrize("hd,g", [(64, 4), (128, 8), (64, 1), (128, 2)])
@pytest.mark.parametrize("n_read", [1, 3, 16, 37])
def test_paged_plan_splits_cover_every_visible_page_once(ps, hd, g, n_read):
    """For any n_read and last position, the visible splits are runs of
    whole pages on the absolute grid [s * SP, (s + 1) * SP), and together
    read pages 0 .. min(n_read, pos // ps + 1) - 1 each exactly once."""
    plan = pca.paged_plan(ps, hd, g)
    assert plan.rows == pca.PAGED_ROWS and plan.split_pages >= 1
    assert plan.split_pages == pca.PAGED_WARPS * plan.warp_pages()  # no warp idles
    assert plan.warp_pages() * ps == max(ps, pca.PAGED_WARP_TOKENS)
    assert plan.splits(n_read) == -(-n_read // plan.split_pages)
    sp = plan.split_pages
    for pos in (0, ps - 1, ps, 5 * ps + 1, n_read * ps - 1, n_read * ps + 40, 4096):
        # the kernel's CTA for split s reads pages s * sp .. up to the
        # tile's visible end, and exits where that lies before s * sp
        vis = min(n_read, pos // ps + 1)
        runs = [range(s * sp, min(vis, (s + 1) * sp)) for s in range(plan.splits(n_read))
                if s * sp < vis]
        assert [p for r in runs for p in r] == list(range(vis))
        assert all(len(r) > 0 for r in runs)


def _paged_case(rng, t, hd, g, n_read, ps=16, b=4, n_kv=2, L=2, seq_len=512):
    """A garbage-filled int8 pool, tables that permute pool pages; row 0
    live near the end of its view, row 1 parked at seq_len, row 2 live with
    -1 entries past its causal limit, row 3 at position 0."""
    P = b * n_read + 3
    kp = rng.integers(-127, 128, (L, P, ps, n_kv, hd)).astype(np.int8)
    vp = rng.integers(-127, 128, (L, P, ps, n_kv, hd)).astype(np.int8)
    ks = (rng.random((L, P, ps, n_kv)) * 0.05 + 1e-3).astype(np.float32)
    vs = (rng.random((L, P, ps, n_kv)) * 0.05 + 1e-3).astype(np.float32)
    tables = rng.permutation(P)[: b * n_read].reshape(b, n_read).astype(np.int32)
    pos = np.array([n_read * ps - t - 3, seq_len, min(ps + 3, n_read * ps - t), 0], np.int32)
    tables[2, (pos[2] + t - 1) // ps + 1:] = -1
    q = rng.standard_normal((b, t, n_kv * g, hd)).astype(np.float32)
    return q, kp, vp, ks, vs, tables, pos


@pytest.mark.parametrize("hd,g", [(64, 4), (128, 2)])
@pytest.mark.parametrize("t,ps", [(1, 16), (5, 16), (16, 16), (1, 8)])
@pytest.mark.parametrize("split_pages", [1, 2, 4, 9])
def test_paged_split_plain_matches_pallas(hd, g, t, ps, split_pages):
    """K5's blocking (absolute page splits, each in four warps' runs of
    pages with the online softmax page by page, the runs merged in warp
    order and the splits in split order) against
    paged_flash_attention(interpret=True), at split sizes 1, 2, 4 and past
    n_read (one split of 3-page runs), with a parked row, an unmapped tail
    and t up to the page size. f32 throughout: the merges only re-associate
    f32 sums, so 1e-5 of the output's scale (the parked row is junk by
    contract, held too)."""
    n_read = 6
    rng = np.random.default_rng(hd + g + t + ps + split_pages)
    q, kp, vp, ks, vs, tables, pos = _paged_case(rng, t, hd, g, n_read, ps)
    layer = 1
    want = np.asarray(jpa.paged_flash_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ks), jnp.asarray(vs),
        jnp.int32(layer), jnp.asarray(pos), jnp.asarray(tables), n_read=n_read, page_size=ps,
        interpret=True))
    got = pca.paged_split_plain(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in (kp, vp, ks, vs)), layer,
        torch.from_numpy(pos.astype(np.int64)), torch.from_numpy(tables), n_read, ps,
        plan=pca.PagedPlan(pca.PAGED_ROWS, split_pages)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def test_paged_split_plain_defaults_to_the_plan():
    rng = np.random.default_rng(0)
    q, kp, vp, ks, vs, tables, pos = _paged_case(rng, 1, 64, 4, 8)
    args = (torch.from_numpy(q), *(torch.from_numpy(a) for a in (kp, vp, ks, vs)), 0,
            torch.from_numpy(pos.astype(np.int64)), torch.from_numpy(tables), 8, 16)
    plan = pca.paged_plan(16, 64, 4)
    assert torch.equal(pca.paged_split_plain(*args), pca.paged_split_plain(*args, plan=plan))


@pytest.mark.parametrize("b,n_read,t", [(1, 1, 1), (1, 40, 1), (16, 16, 1), (3, 9, 16)])
@pytest.mark.parametrize("hd,g", [(64, 4), (128, 8)])
def test_k5_launches_its_plan_with_a_workspace_where_it_splits(monkeypatch, b, n_read, t, hd, g):
    """The wrapper hands the kernel paged_plan(ps, hd, g)'s split size
    whatever b and n_read, and a workspace of [splits, b * n_kv, t * g(,
    hd)] plus zeroed tickets exactly where the call has more than one
    split."""
    n_kv, ps = 2, 16
    q = torch.zeros((b, t, n_kv * g, hd))
    pool = torch.zeros((1, b * n_read + 1, ps, n_kv, hd), dtype=torch.int8)
    scales = torch.zeros((1, b * n_read + 1, ps, n_kv))
    table = torch.zeros((b, n_read), dtype=torch.int32)
    pos = torch.zeros((b,), dtype=torch.int64)
    cap = _Captured(monkeypatch)
    monkeypatch.setattr(pca, "_TICKETS", {})
    pca._launch_paged(q, pool, pool, scales, scales, 0, pos, table, n_read, ps, 0.125)
    ((fn, args),) = cap.calls
    plan = pca.paged_plan(ps, hd, g)
    assert fn == "paged_attention_fwd"
    assert args[20] == plan.split_pages
    ws = args[21:]
    assert all((p is not None) == (plan.splits(n_read) > 1) for p in ws)
    if plan.splits(n_read) > 1:
        tickets = pca._TICKETS[q.device]
        assert tickets.dtype == torch.int32 and not tickets.any()
        assert tickets.numel() >= b * n_kv * -(-(t * g) // plan.rows)
        assert ws[3] == tickets.data_ptr()


# -- K4: grouped_plan and the blocked plain version ----------------------------


def test_grouped_plan_takes_the_shape_alone():
    assert list(inspect.signature(cuda_q40.grouped_plan).parameters) == ["nb", "out_f", "block_r"]


@pytest.mark.parametrize("nb,out_f", [(64, 768), (24, 2048), (8, 256), (1, 8), (3, 200),
                                      (9, 100), (65, 384), (2, 64)])
@pytest.mark.parametrize("block_r", cuda_q40.GROUPED_BLOCK_ROWS)
def test_grouped_plan_covers_every_column_once(nb, out_f, block_r):
    plan = cuda_q40.grouped_plan(nb, out_f, block_r)
    assert plan.cols in (64, 128)
    tiles = [range(n0, min(out_f, n0 + plan.cols)) for n0 in range(0, out_f, plan.cols)]
    assert [n for r in tiles for n in r] == list(range(out_f))
    assert all(len(r) > 0 for r in tiles)
    assert plan.ctas(out_f, 5) == 5 * len(tiles)


def test_grouped_plan_fills_the_card_at_30b_a3b_width():
    """A 32-token chunk of Qwen3-30B-A3B: 144 row blocks of 8 rows, and at
    least five CTAs an SM of an H100 SXM's 132 for every role."""
    for in_f, out_f in ((2048, 768), (768, 2048)):
        assert cuda_q40.grouped_plan(in_f // 32, out_f, 8).ctas(out_f, 144) >= 5 * 132


def _q40(rng, groups, in_f, out_f):
    nb = in_f // 32
    qt = rng.integers(-8, 8, size=(groups, nb, 32, out_f)).astype(np.int8)
    dt = (rng.random((groups, nb, out_f)) * 0.02 - 0.01).astype(np.float16)
    return pack_q(qt), dt


@pytest.mark.parametrize("block_r", [8, 16, 32])
@pytest.mark.parametrize("in_f,out_f", [(256, 384), (160, 64), (96, 200)])
def test_k4_blocked_sums_match_pallas_grouped(block_r, in_f, out_f):
    """K4's order of sums (each Q40 block's dot, the blocks of a row block
    in order by one warp, nothing split) against q40_matmul_pallas_grouped
    in interpret mode on a flat [L * E] stack with the layer folded into
    the index: bf16 operands, exact products, f32 sums over `in` terms in
    another order (1e-5 of the output's scale)."""
    rng = np.random.default_rng(block_r + in_f + out_f)
    L, E, layer = 2, 6, 1
    q, d = _q40(rng, L * E, in_f, out_f)
    g = rng.integers(0, E, size=3 * block_r).astype(np.int32)
    _, be, R_pad = _grouped_layout_direct(torch.from_numpy(g), E, block_r)
    flat_be = (be + layer * E).numpy()
    xp = rng.standard_normal((R_pad, in_f)).astype(np.float32)
    want = np.asarray(jp.q40_matmul_pallas_grouped(
        jnp.asarray(xp), jnp.asarray(q), jnp.asarray(d), jnp.asarray(flat_be), block_r,
        interpret=True))
    got = cuda_q40.q40_grouped_gemm_bf16_blocked(
        torch.from_numpy(xp), torch.from_numpy(q), torch.from_numpy(d), torch.from_numpy(flat_be),
        block_r).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("block_r", cuda_q40.GROUPED_BLOCK_ROWS)
def test_k4_launches_its_plan(monkeypatch, block_r):
    """The wrapper hands the kernel grouped_plan's column tile, for a
    bf16 or f32 input alike."""
    rng = np.random.default_rng(block_r)
    q, d = (torch.from_numpy(a) for a in _q40(rng, 4, 256, 384))
    be = torch.tensor([0, 3], dtype=torch.int32)
    cap = _Captured(monkeypatch)
    for dtype in (torch.float32, torch.bfloat16):
        cuda_q40._launch_grouped(torch.zeros((2 * block_r, 256), dtype=dtype), q, d, be, block_r)
    plan = cuda_q40.grouped_plan(8, 384, block_r)
    assert [fn for fn, _ in cap.calls] == ["q40_grouped_gemm_bf16"] * 2
    assert all(args[-1] == plan.cols and args[7] == block_r for _, args in cap.calls)


@pytest.mark.parametrize("exact_scale", [False, True])
def test_k4_hands_the_kernel_its_rounding(monkeypatch, exact_scale):
    """The wrapper hands the kernel its weight rounding (`exact_scale`,
    the small-row MoE arm's) beside the plan's column tile, and counts the
    launch."""
    rng = np.random.default_rng(3)
    q, d = (torch.from_numpy(a) for a in _q40(rng, 4, 256, 384))
    be = torch.tensor([0, 3], dtype=torch.int32)
    cap = _Captured(monkeypatch)
    cuda_q40._launch_grouped(torch.zeros((16, 256)), q, d, be, 8, exact_scale)
    (fn, args), = cap.calls
    assert fn == "q40_grouped_gemm_bf16" and args[-2:] == (int(exact_scale), 128)
