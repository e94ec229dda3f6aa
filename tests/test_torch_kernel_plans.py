"""The blocking of K2 (the Q40 prefill GEMM) and K3/B8 (prefill flash
attention and its shard-local partial) as the CUDA kernels run it, on the
CPU: the two planners (`cuda_q40.gemm_plan`, `cuda_attention.flash_plan`),
the plans the wrappers hand the kernels, and a plain torch rendition of
each blocking (`q40_gemm_bf16_blocked`, `flash_split_plain`) against the
JAX package's Pallas kernels run with interpret=True. Inputs come from
numpy with a seed. The kernels themselves: tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops import pallas_attention as jpa
from distributed_llama_tpu.ops import pallas_q40 as jp
from distributed_llama_tpu_torch.ops import cuda_attention as pca
from distributed_llama_tpu_torch.ops import cuda_q40, kernels
from distributed_llama_tpu_torch.ops.quant import pack_q

# tiny shapes: torch's intra-op threads would only contend with the JAX
# tests that share the CPU under pytest-xdist
torch.set_num_threads(1)

NEG_INF = float(np.finfo(np.float32).min)
SMS = 132  # an H100 SXM

# (in, out) of every K2 call at the two models' widths: Llama-3.2-1B wqkv,
# wo, w13, w2, wcls; Qwen3-30B-A3B wqkv, wo, wcls
SERVING = [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048), (2048, 128256),
           (2048, 5120), (4096, 2048), (2048, 151936)]


def _runs(n: int, per: int, count: int):
    return [range(s * per, min(n, (s + 1) * per)) for s in range(count)]


@pytest.mark.parametrize("nb,out_f", [(in_f // 32, out_f) for in_f, out_f in SERVING]
                         + [(1, 8), (3, 200), (8, 384), (9, 100), (32, 128), (65, 384),
                            (256, 64), (1024, 128256)])
def test_gemm_plan_splits_cover_the_contraction_once(nb, out_f):
    plan = cuda_q40.gemm_plan(nb, out_f)
    assert plan.cols in (64, 128) and plan.stages == cuda_q40.GEMM_STAGES
    assert 1 <= plan.splits <= cuda_q40.GEMM_MAX_SPLITS
    assert plan.splits & (plan.splits - 1) == 0  # a cluster of 1, 2, 4 or 8
    runs = _runs(nb, plan.blocks_per_split, plan.splits)
    assert all(len(r) > 0 for r in runs)
    assert [b for r in runs for b in r] == list(range(nb))
    assert plan.splits == 1 or plan.blocks_per_split >= cuda_q40.GEMM_STAGE_BLOCKS


@pytest.mark.parametrize("in_f,out_f", SERVING)
def test_gemm_plan_fills_the_card_at_serving_widths(in_f, out_f):
    plan = cuda_q40.gemm_plan(in_f // 32, out_f)
    assert plan.ctas(out_f, rows=16) >= SMS
    assert plan.ctas(out_f, rows=32) == plan.ctas(out_f, rows=16)


class _Captured:
    """kernels.load / kernels.launch stand-ins that record each launch's
    arguments, so the wrappers' launch paths run on the CPU."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(kernels, "load", lambda name, sig: name)
        monkeypatch.setattr(kernels, "launch", lambda lib, fn, t, *args: self.calls.append((fn, args)))


def _q40(in_f, out_f, layers=2, seed=0):
    rng = np.random.default_rng(seed)
    nb = in_f // 32
    qt = rng.integers(-8, 8, size=(layers, nb, 32, out_f)).astype(np.int8)
    dt = (rng.random((layers, nb, out_f)) * 0.02 - 0.01).astype(np.float16)
    return pack_q(qt), dt


@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048), (2080, 384)])
def test_k2_launches_its_plan_whatever_the_row_count(monkeypatch, in_f, out_f):
    """The plan the wrapper hands the kernel is gemm_plan(nb, out) at
    every row count: a row's sums never depend on how many rows share its
    call."""
    q, d = (torch.from_numpy(a) for a in _q40(in_f, out_f, layers=2))
    cap = _Captured(monkeypatch)
    for rows in (9, 16, 32, 40):
        cuda_q40._launch_gemm(torch.zeros((1, rows, in_f)), q, d, 1)
        cuda_q40._launch_gemm(torch.zeros((rows, in_f)), q[0], d[0], 0)
    plan = cuda_q40.gemm_plan(in_f // 32, out_f)
    assert len(cap.calls) == 8
    for fn, args in cap.calls:
        assert fn == "q40_gemm_bf16"
        assert args[-3:] == (plan.cols, plan.splits, plan.blocks_per_split)


@pytest.mark.parametrize("n_tiles", [0, 1, 2, 3, 5, 16, 64, 95, 96, 256, 512])
@pytest.mark.parametrize("base", [1, 4, 8, 16, 300])
def test_flash_plan_splits_cover_the_visible_tiles_once(n_tiles, base):
    plan = pca.flash_plan(n_tiles, base)
    assert plan.rows == pca.FLASH_ROWS and plan.splits >= 1
    runs = _runs(n_tiles, plan.split_tiles, plan.splits)
    assert [j for r in runs for j in r] == list(range(n_tiles))
    if n_tiles:
        assert all(len(r) > 0 for r in runs)
    # runs as long as reaching the target allows (one tile where the tiles
    # run out first)
    want = -(-pca.FLASH_TARGET_CTAS // base)
    assert plan.split_tiles == max(1, -(-n_tiles // max(1, min(want, n_tiles))))


@pytest.mark.parametrize("hd,n_heads,n_kv", [(64, 32, 8), (128, 32, 4)])
@pytest.mark.parametrize("t,pos", [(32, 64), (32, 6000), (8, 4080), (32, 4080), (1, 32758)])
def test_flash_plan_fills_the_card_at_serving_widths(hd, n_heads, n_kv, t, pos):
    """At both models' widths a chunk gets at least one CTA per SM where
    its visible tiles allow it (one tile a split at most); the plan is the
    view's, the same at every position."""
    S = 32768
    q, k = torch.zeros((1, t, n_heads, hd)), torch.zeros((1, S, n_kv, hd))
    plan = pca.plan_for(q, k)
    base = n_kv * -(-(t * n_heads // n_kv) // pca.FLASH_ROWS)
    assert base * plan.splits >= min(SMS, base * pca.visible_tiles(t, S, pos))


@pytest.mark.parametrize("pos", [0, 40, 1000, 4064])
@pytest.mark.parametrize("hd,g", [(64, 4), (128, 8)])
def test_k3_and_b8_on_shard_0_launch_the_same_plan(monkeypatch, pos, hd, g):
    """A chunk inside shard 0: K3 over a view of the shard's length (the
    first 4096 rows of the 16384-row cache) and B8 on the first 4096-row
    shard hand the kernel the same splits (and so the same sums), with a
    workspace of the plan's size where it has more than one split. The
    plan is the shapes' alone: the whole cache's view splits otherwise,
    and no position moves either."""
    t, n_kv, S, local = 32, 2, 16384, 4096
    q = torch.zeros((1, t, n_kv * g, hd))
    kv = torch.zeros((1, S, n_kv, hd), dtype=torch.bfloat16)
    plan = pca.plan_for(q, kv[:, :local])
    assert plan.split_tiles * plan.splits >= local // pca.FLASH_TILE
    assert pca.plan_for(q, kv).split_tiles > plan.split_tiles
    cap = _Captured(monkeypatch)
    pca._launch(q, kv[:, :local], kv[:, :local], pos, 0.125)
    pca._launch_partial(q, kv[:, :local], kv[:, :local], pos, 0, 0.125)
    (k3, a3), (b8, a8) = cap.calls
    assert (k3, b8) == ("flash_attention_fwd", "flash_attention_partial_fwd")
    assert a3[16:18] == a8[20:22] == (plan.split_tiles, plan.splits)
    # the combine's workspace exactly where there is more than one split
    for args in (a3, a8):
        assert all((p is not None) == (plan.splits > 1) for p in args[-3:])


def _bf16_pair(x):
    """The same bf16 values for JAX and torch."""
    j = jnp.asarray(x.astype(np.float32), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("rows", [16, 40])
@pytest.mark.parametrize("in_f,out_f", [(256, 384), (1024, 128), (2080, 256)])
def test_k2_blocked_sums_match_pallas_stacked(rows, in_f, out_f):
    """K2's split-K order (blocks per warp, warps, then splits in order)
    over the plan's splits against the Pallas kernel: bf16 operands, exact
    products, f32 sums over `in` terms in another order (1e-5 of the
    output's scale)."""
    q, d = _q40(in_f, out_f, seed=rows + in_f)
    x = np.random.default_rng(rows).standard_normal((rows, in_f)).astype(np.float32)
    plan = cuda_q40.gemm_plan(in_f // 32, out_f)
    want = np.asarray(jp.q40_matmul_pallas_stacked(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(d), jnp.int32(1), interpret=True))
    got = cuda_q40.q40_gemm_bf16_blocked(torch.from_numpy(x), torch.from_numpy(q[1]),
                                         torch.from_numpy(d[1]), plan).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def _att_case(t, S, g, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, t, 2 * g, hd)).astype(np.float32)
    kb, kt = _bf16_pair(rng.standard_normal((1, S, 2, hd)))
    vb, vt = _bf16_pair(rng.standard_normal((1, S, 2, hd)))
    return q, kb, vb, kt, vt


def _held_to_pallas(got, want):
    """The bound of a kernel whose KV tiles are not the Pallas kernel's
    blocks (tests/test_torch_kernels_gpu.py `_b8_bound`): P rounds to bf16
    against each 64-row tile's running maximum, not the whole block's, so
    outputs agree within 5e-3 of their largest value, never above 1e-2."""
    bound = min(1e-2, 5e-3 * float(np.abs(want).max()))
    assert np.abs(got - want).max() <= bound


@pytest.mark.parametrize("hd,g", [(64, 4), (128, 2)])
@pytest.mark.parametrize("t,S,pos", [(8, 512, 400), (32, 1024, 900), (32, 512, 64)])
@pytest.mark.parametrize("split_tiles", [None, 1])
def test_k3_split_and_combine_matches_pallas(hd, g, t, S, pos, split_tiles):
    """K3's blocking (64-row score tiles, the visible range in splits,
    the splits combined in order, then o / max(l, 1e-30)) against
    flash_attention(interpret=True), with the plan's splits and with one
    tile a split."""
    q, kb, vb, kt, vt = _att_case(t, S, g, hd, seed=t + S + pos + hd)
    qt = torch.from_numpy(q)
    plan = pca.plan_for(qt, kt)
    if split_tiles:
        n = S // pca.FLASH_TILE
        plan = pca.FlashPlan(plan.rows, split_tiles, n)
    want = np.asarray(jpa.flash_attention(jnp.asarray(q), kb, vb, jnp.int32(pos), interpret=True))
    o, _, l = pca.flash_split_plain(qt, kt, vt, pos, 0, plan=plan)
    got = (o / torch.clamp(l, min=1e-30)[..., None]).numpy()
    _held_to_pallas(got, want)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("pos,col", [(100, 0), (500, 0), (500, 512), (508, 512), (500, 1024)])
def test_b8_split_and_combine_matches_pallas_partial(hd, pos, col):
    """B8's blocking on one 512-row shard whose row 0 is the global column
    col, one tile a split, against flash_attention_partial(interpret=True):
    rows that see no column of the shard exactly (o = 0, l = 0, the JAX
    kernel's m); the others m to 1e-5 of its scale, l to 1e-4 relative (f32
    rescalings at other tile boundaries), o / l within `_held_to_pallas`."""
    t, S = 32, 512
    q, kb, vb, kt, vt = _att_case(t, S, 4, hd, seed=pos + col + hd)
    qt = torch.from_numpy(q)
    n = pca.visible_tiles(t, S, pos, col)
    plan = pca.FlashPlan(pca.FLASH_ROWS, 1, max(n, 1))
    jo, jm, jl = (np.asarray(a) for a in jpa.flash_attention_partial(
        jnp.asarray(q), kb, vb, jnp.int32(pos), jnp.int32(col), interpret=True))
    o, m, l = (a.numpy() for a in pca.flash_split_plain(qt, kt, vt, pos, col, plan=plan))
    seen = jl > 0
    assert np.array_equal(seen, l > 0)
    np.testing.assert_array_equal(m[~seen], jm[~seen])
    assert (o[~seen] == 0).all() and (l[~seen] == 0).all()
    if col == 1024:
        assert not seen.any() and (m == NEG_INF).all()
    if not seen.any():
        return
    np.testing.assert_allclose(m[seen], jm[seen], rtol=0, atol=1e-5 * np.abs(jm[seen]).max())
    np.testing.assert_allclose(l[seen], jl[seen], rtol=1e-4)
    _held_to_pallas(o[seen] / l[seen][:, None], jo[seen] / jl[seen][:, None])
