"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. These tests import neither jax nor the JAX package, so they also run
where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Without a CUDA device every test skips (the fixture decides, at run time).
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import attention as ops_attention
from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40
from distributed_llama_tpu_torch.ops.quant import pack_q
from distributed_llama_tpu_torch.parallel import make_mesh
from distributed_llama_tpu_torch.probes import (
    attention, dma, gemv, i4_tiles, int4, int4_prod, int4b, int4c, scales)
from distributed_llama_tpu_torch.probes.operands import scale_planes
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
from distributed_llama_tpu_torch.testing import tiny_header, write_tiny_model

# P12 and P8 against their plain versions, of the plain output's largest value
ATT_REL_TOL = 2.0 ** -6

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _weights(in_f, out_f, layers=2, seed=0):
    rng = np.random.default_rng(seed)
    nb = in_f // 32
    qt = rng.integers(-8, 8, size=(layers, nb, 32, out_f)).astype(np.int8)
    dt = (rng.random((layers, nb, out_f)) * 0.02 + 0.001).astype(np.float16)
    return torch.from_numpy(pack_q(qt)), torch.from_numpy(dt)


def _x(rows, in_f, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((rows, in_f)).astype(np.float32))


@pytest.mark.parametrize("rows", [1, 4, 8])
@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048)])
def test_k1_kernel_matches_plain(cuda, rows, in_f, out_f):
    q, d = (t.to(cuda) for t in _weights(in_f, out_f))
    x = _x(rows, in_f).to(cuda)
    before = cuda_q40.q40_gemv_q80_stacked.launches
    got = cuda_q40.q40_gemv_q80_stacked(x, q, d, 1)
    want = cuda_q40.q40_gemv_q80_plain(x, q[1], d[1])
    torch.cuda.synchronize()
    assert cuda_q40.q40_gemv_q80_stacked.launches == before + 1
    # exact integer partials; only the order of the f32 block sums differs
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_k1_unstacked_kernel_matches_plain(cuda):
    q, d = (t.to(cuda) for t in _weights(2048, 4096, layers=1))
    x = _x(1, 2048).to(cuda)
    got = cuda_q40.q40_gemv_q80(x, q[0], d[0])
    want = cuda_q40.q40_gemv_q80_plain(x, q[0], d[0])
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# (in, out) of every K1 call on the main paths: Llama-3.2-1B wqkv, wo, w13,
# w2, wcls; Qwen3-30B-A3B wqkv, wo, wcls; K1-indexed's w1/w3 and w2
K1_SHAPES = [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048), (2048, 128256),
             (2048, 5120), (4096, 2048), (2048, 151936), (2048, 768), (768, 2048)]


def _k1_x(cuda, rows, in_f, seed, dtype=torch.float32):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn((rows, in_f), device=cuda, generator=gen).to(dtype)


@pytest.mark.parametrize("in_f,out_f", K1_SHAPES)
def test_k1_equals_its_blocked_order_and_rows_stand_alone(cuda, in_f, out_f):
    """K1-stacked (layer 1) and K1 (unstacked) at 1..8 rows equal
    q40_gemv_q80_blocked at gemv_plan bit for bit, and rows 0..R-1 of an
    R-row call equal the 1-row calls of those rows bit for bit."""
    q, d = _flat_stack(cuda, 2, in_f, out_f, seed=in_f + out_f)
    plan = cuda_q40.gemv_plan(in_f // 32, out_f)
    x8 = _k1_x(cuda, 8, in_f, seed=out_f)
    solo = [cuda_q40.q40_gemv_q80_stacked(x8[r:r + 1], q, d, 1) for r in range(8)]
    for r in range(8):
        assert torch.equal(solo[r], cuda_q40.q40_gemv_q80_blocked(x8[r:r + 1], q[1], d[1], plan))
    for rows in range(1, 9):
        x = x8[:rows]
        before = cuda_q40.q40_gemv_q80_stacked.launches
        got = cuda_q40.q40_gemv_q80_stacked(x, q, d, 1)
        assert cuda_q40.q40_gemv_q80_stacked.launches == before + 1
        assert torch.equal(got, torch.cat(solo[:rows]))
        assert torch.equal(cuda_q40.q40_gemv_q80(x, q[1].contiguous(), d[1].contiguous()), got)
    want = cuda_q40.q40_gemv_q80_plain(x8, q[1], d[1])
    assert (torch.cat(solo) - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("in_f,out_f,shared", [(2048, 768, True), (768, 2048, False),
                                               (2048, 768, False), (768, 2048, True)])
def test_k1_indexed_equals_its_blocked_order_and_slots_stand_alone(cuda, in_f, out_f, shared):
    """K1-indexed at 1..8 slots equals q40_gemv_q80_indexed_blocked bit for
    bit, and each slot equals its 1-slot call."""
    q, d = _flat_stack(cuda, 64, in_f, out_f, seed=in_f)
    plan = cuda_q40.gemv_plan(in_f // 32, out_f)
    idx = torch.tensor([63, 0, 17, 17, 40, 5, 62, 33], dtype=torch.int32, device=cuda)
    x = _k1_x(cuda, 1 if shared else 8, in_f, seed=out_f)
    full = cuda_q40.q40_gemv_q80_indexed(x, q, d, idx)
    assert torch.equal(full, cuda_q40.q40_gemv_q80_indexed_blocked(x, q, d, idx, plan))
    for n in range(1, 9):
        got = cuda_q40.q40_gemv_q80_indexed(x if shared else x[:n], q, d, idx[:n])
        assert torch.equal(got, full[:n])
    for s in range(8):
        one = cuda_q40.q40_gemv_q80_indexed(x if shared else x[s:s + 1], q, d, idx[s:s + 1])
        assert torch.equal(one[0], full[s])


@pytest.mark.parametrize("in_f,out_f", [(2048, 200), (1056, 100), (96, 130), (2048, 3072)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_equals_its_blocked_order_on_ragged_and_unaligned_operands(cuda, in_f, out_f, dtype):
    """Widths whose rows do not take vector loads (out % 4 != 0), bf16 x,
    and x at a storage offset that breaks its 16-byte alignment: the
    element-wise load paths give the blocked order's bits too."""
    q, d = _flat_stack(cuda, 2, in_f, out_f, seed=out_f)
    plan = cuda_q40.gemv_plan(in_f // 32, out_f)
    base = _k1_x(cuda, 5, in_f + 1, seed=in_f, dtype=dtype).reshape(-1)
    for x in (base[:3 * in_f].reshape(3, in_f), base[1:1 + 3 * in_f].reshape(3, in_f)):
        got = cuda_q40.q40_gemv_q80_stacked(x, q, d, 1)
        assert torch.equal(got, cuda_q40.q40_gemv_q80_blocked(x, q[1], d[1], plan))


def test_k1_replays_from_a_cuda_graph_bit_for_bit(cuda):
    """K1-stacked and K1-indexed captured in one CUDA graph: two replays
    give the eager call's bits (no state survives a call)."""
    q, d = _flat_stack(cuda, 2, 8192, 2048, seed=7)
    qe, de = _flat_stack(cuda, 16, 2048, 768, seed=8)
    x = _k1_x(cuda, 4, 8192, seed=1)
    xe = _k1_x(cuda, 1, 2048, seed=2)
    idx = torch.tensor([3, 15, 0, 9, 9, 1, 2, 4], dtype=torch.int32, device=cuda)
    eager = (cuda_q40.q40_gemv_q80_stacked(x, q, d, 1), cuda_q40.q40_gemv_q80_indexed(xe, qe, de, idx))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_q40.q40_gemv_q80_stacked(x, q, d, 1)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = (cuda_q40.q40_gemv_q80_stacked(x, q, d, 1),
               cuda_q40.q40_gemv_q80_indexed(xe, qe, de, idx))
    for _ in range(2):
        for o in out:
            o.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, eager))


@pytest.mark.parametrize("rows", [16, 32, 40])
def test_k2_kernel_matches_plain(cuda, rows):
    q, d = (t.to(cuda) for t in _weights(2048, 3072))
    x = _x(rows, 2048).to(cuda)
    got = cuda_q40.q40_gemm_bf16_stacked(x, q, d, 1)
    want = cuda_q40.q40_gemm_bf16_plain(x, q[1], d[1])
    torch.cuda.synchronize()
    # exact bf16 products; tensor-core f32 accumulation in another order
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("hd,g,t,pos", [(64, 4, 32, 64), (128, 2, 8, 100), (64, 1, 16, 0)])
def test_flash_kernel_matches_plain(cuda, hd, g, t, pos):
    gen = torch.Generator().manual_seed(hd + g + t + pos)
    n_kv, S = 2, 512
    q = torch.randn((1, t, n_kv * g, hd), generator=gen).to(cuda)
    cache = torch.randn((3, 1, 1024, n_kv, hd), generator=gen).to(torch.bfloat16).to(cuda)
    k, v = cache[1, :, :S], cache[2, :, :S]  # strided views, as on the main path
    got = cuda_attention.flash_attention(q, k, v, pos)
    want = cuda_attention.flash_attention_plain(q, k, v, pos)
    torch.cuda.synchronize()
    # P rounds to bf16 against each KV tile's running max, and the kernel's
    # 64-row tiles are not the plain version's blocks: bf16-level on |v| ~ 1
    assert (got - want).abs().max().item() <= 1e-2


# B8's normalized output (and the shards' combine) against its plain
# version (and K3), as a share of the reference's largest value: chip_smoke.py's
# B8_OUT_REL_TOL (P rounds to bf16 against each 64-row tile's running max),
# never above the absolute 1e-2 it replaced
B8_OUT_REL_TOL = 5e-3


def _b8_bound(ref: torch.Tensor) -> float:
    return min(1e-2, B8_OUT_REL_TOL * ref.abs().max().item())


def _b8_check(o, m, l, po, pm, pl):
    """B8 against its plain version. Rows that see no column of the shard:
    exact (o = 0, l = 0, the JAX kernel's m). Rows that do: m to the f32
    order of the score dots (1e-5 of its scale), l to the f32 rescalings of
    other tile boundaries (1e-4 relative), and o / l, the shard's normalized
    output, within `_b8_bound` of it."""
    seen = pl > 0
    assert torch.equal(seen, l > 0)
    blind = ~seen
    assert torch.equal(m[blind], pm[blind])
    assert (o[blind] == 0).all() and (l[blind] == 0).all()
    if seen.any():
        assert (m[seen] - pm[seen]).abs().max().item() <= 1e-5 * pm[seen].abs().max().item()
        assert ((l[seen] - pl[seen]).abs() / pl[seen]).max().item() <= 1e-4
        ref = po[seen] / pl[seen][:, None]
        d = o[seen] / l[seen][:, None] - ref
        assert d.abs().max().item() <= _b8_bound(ref)
    return seen


@pytest.mark.parametrize("hd,g", [(64, 4), (128, 8)])
@pytest.mark.parametrize("t", [8, 32])
@pytest.mark.parametrize("pos,col", [(100, 0), (508, 0), (508, 512), (500, 512), (508, 1024)])
def test_b8_kernel_matches_plain(cuda, hd, g, t, pos, col):
    """B8 on one 512-row shard whose row 0 is the global position col: a
    chunk wholly inside it, one straddling into it (its first rows see none
    of it: m = NEG_INF / 2), and shards wholly in the chunk's future (m =
    NEG_INF, nothing loaded, everything still written)."""
    gen = torch.Generator().manual_seed(hd + g + t + pos + col)
    n_kv, S = 2, 512
    q = torch.randn((1, t, n_kv * g, hd), generator=gen).to(cuda)
    cache = torch.randn((3, 1, 1024, n_kv, hd), generator=gen).to(torch.bfloat16).to(cuda)
    k, v = cache[1, :, :S], cache[2, :, :S]  # strided views, as on the main path
    before = cuda_attention.flash_attention_partial.launches
    o, m, l = cuda_attention.flash_attention_partial(q, k, v, pos, col)
    po, pm, pl = cuda_attention.flash_attention_partial_plain(q, k, v, pos, col)
    torch.cuda.synchronize()
    assert cuda_attention.flash_attention_partial.launches == before + 1
    assert o.dtype == m.dtype == l.dtype == torch.float32
    seen = _b8_check(o, m, l, po, pm, pl)
    if pos + t - 1 < col:
        assert not seen.any() and (m == torch.finfo(torch.float32).min).all()


@pytest.mark.parametrize("hd,g", [(64, 4), (128, 8)])
@pytest.mark.parametrize("pos", [0, 300, 1020, 2016])
def test_flash_attention_sp_on_the_card_matches_k3(cuda, hd, g, pos):
    """The four-shard combine of B8's triples against K3 over the whole
    2048-row cache: equal up to the bf16 rounding of P against other
    running maxima (`_b8_bound` of K3's output); bit for bit while the
    chunk lies inside shard 0's first tile range, where the other shards
    add exact zeros and shard 0 runs K3's own loop."""
    gen = torch.Generator().manual_seed(hd + g + pos)
    n_kv, S, sp, t = 2, 2048, 4, 32
    q = torch.randn((1, t, n_kv * g, hd), generator=gen).to(cuda)
    k = torch.randn((1, S, n_kv, hd), generator=gen).to(torch.bfloat16).to(cuda)
    v = torch.randn((1, S, n_kv, hd), generator=gen).to(torch.bfloat16).to(cuda)
    local = S // sp
    got = ops_attention.flash_attention_sp(
        q, [k[:, i * local : (i + 1) * local] for i in range(sp)],
        [v[:, i * local : (i + 1) * local] for i in range(sp)], pos, [i * local for i in range(sp)])
    want = cuda_attention.flash_attention(q, k, v, pos)
    torch.cuda.synchronize()
    if pos + t <= local:
        assert torch.equal(got, cuda_attention.flash_attention(q, k[:, :local], v[:, :local], pos))
    assert (got - want).abs().max().item() <= _b8_bound(want)


def _cards(n: int) -> int:
    """How many cards a multi-card test spreads over: n (or 4 where there
    are four); skips where fewer than n are visible."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        pytest.skip(f"needs {n} CUDA devices, have {have}")
    return 4 if have >= 4 else n


def test_b8_on_each_card_matches_its_launch_on_the_first(cuda):
    """B8 on a tensor of card i while card 0 is current: the wrapper makes
    card i current and launches on its stream, so the result is card 0's
    bit for bit and within `_b8_bound` of the plain version."""
    n = _cards(2)
    gen = torch.Generator().manual_seed(9)
    q = torch.randn((1, 32, 8, 64), generator=gen)
    k, v = torch.randn((2, 1, 512, 2, 64), generator=gen).to(torch.bfloat16)
    want = cuda_attention.flash_attention_partial(q.to(cuda), k.to(cuda), v.to(cuda), 600, 256)
    for i in range(1, n):
        dev = torch.device("cuda", i)
        with torch.cuda.device(0):
            got = cuda_attention.flash_attention_partial(q.to(dev), k.to(dev), v.to(dev), 600, 256)
        torch.cuda.synchronize(dev)
        assert all(g.device == dev for g in got)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu())
        _b8_check(*got, *cuda_attention.flash_attention_partial_plain(
            q.to(dev), k.to(dev), v.to(dev), 600, 256))


@pytest.fixture(scope="module")
def sp_model(tmp_path_factory):
    """A two-layer Llama with head_dim 64 (B8's), a 512-row context."""
    path = str(tmp_path_factory.mktemp("sp") / "m.m")
    write_tiny_model(path, tiny_header(dim=256, hidden_dim=256, n_layers=2, n_heads=4,
                                       n_kv_heads=2, seq_len=512), seed=21)
    return path


def test_sp_engine_over_distinct_cards_equals_one_card(cuda, sp_model):
    """make_mesh(sp=n) with no devices puts shard i on card i: greedy
    generation there (a 149-token prefill in 24-row chunks through B8, then
    decode) gives the tokens and the next logits of the same mesh with
    every shard on card 0, bit for bit, and leaves each shard's cache on
    its card."""
    n = _cards(2)
    prompt = [(7 * i) % 200 + 1 for i in range(150)]
    spread = InferenceEngine(sp_model, max_chunk=24, mesh=make_mesh(sp=n))
    assert [c.k.device for c in spread.cache] == [torch.device("cuda", i) for i in range(n)]
    shared = InferenceEngine(sp_model, max_chunk=24,
                             mesh=make_mesh(sp=n, devices=[torch.device("cuda", 0)] * n))
    before = cuda_attention.flash_attention_partial.launches
    got = spread.generate(prompt, 190, sampler=None).tokens
    assert cuda_attention.flash_attention_partial.launches > before
    assert got == shared.generate(prompt, 190, sampler=None).tokens
    la = spread.decode_one(prompt[-1], len(prompt) - 1)
    lb = shared.decode_one(prompt[-1], len(prompt) - 1)
    assert np.isfinite(la).all() and np.array_equal(la, lb)
    for a, b in zip(spread.cache, shared.cache):
        assert torch.equal(a.k.cpu(), b.k.cpu()) and torch.equal(a.v.cpu(), b.v.cpu())


def test_b8_wrapper_raises_instead_of_falling_back(cuda):
    q = torch.randn((1, 8, 8, 64), device=cuda)
    k = torch.randn((1, 256, 2, 64), device=cuda)
    with pytest.raises(TypeError):  # an f32 cache: the kernel takes bf16
        cuda_attention.flash_attention_partial(q, k, k, 0, 256)
    kb = torch.randn((1, 256, 2, 96), device=cuda).bfloat16()
    with pytest.raises(ValueError):  # head_dim 96
        cuda_attention.flash_attention_partial(torch.randn((1, 8, 8, 96), device=cuda), kb, kb, 0, 0)


def test_wrappers_raise_instead_of_falling_back(cuda):
    q, d = (t.to(cuda) for t in _weights(256, 384, layers=1))
    with pytest.raises(ValueError):
        cuda_q40.q40_gemm_bf16(_x(16, 128).to(cuda), q[0], d[0])  # 128 features, weight 256
    with pytest.raises(ValueError):
        cuda_q40.q40_gemv_q80_stacked(_x(9, 256).to(cuda), q, d, 0)
    args = _paged_inputs(cuda, L=1, n_kv=2, g=4, hd=64, b=2, n_read=2)
    qq, k, v, ks, vs, pos, table = args
    with pytest.raises(TypeError):  # a bf16 pool: the kernel takes int8
        cuda_attention.paged_flash_attention(qq, k.bfloat16(), v.bfloat16(), ks, vs, 0, pos,
                                             table, 2, 16)
    with pytest.raises(TypeError):  # an int64 page table
        cuda_attention.paged_flash_attention(qq, k, v, ks, vs, 0, pos, table.long(), 2, 16)
    with pytest.raises(ValueError):  # more queries than a page holds
        cuda_attention.paged_flash_attention(qq.repeat(1, 17, 1, 1), k, v, ks, vs, 0, pos,
                                             table, 2, 16)


def _flat_stack(cuda, groups, in_f, out_f, seed=0):
    """A flat [groups, nb*4, out] stack drawn on the card: any int32 word is
    a valid nibble pattern."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    nb = in_f // 32
    q = torch.randint(-2**31, 2**31 - 1, (groups, nb * 4, out_f), dtype=torch.int32,
                      device=cuda, generator=gen)
    d = (torch.rand((groups, nb, out_f), device=cuda, generator=gen) * 0.016 + 0.004).half()
    return q, d


@pytest.mark.parametrize("in_f,out_f", [(2048, 768), (768, 2048)])
@pytest.mark.parametrize("shared", [True, False])
def test_k1_indexed_kernel_matches_plain(cuda, in_f, out_f, shared):
    q, d = _flat_stack(cuda, 64, in_f, out_f)
    idx = torch.tensor([63, 0, 17, 17, 40, 5, 62, 33], dtype=torch.int32, device=cuda)
    x = _x(1 if shared else 8, in_f).to(cuda)
    before = cuda_q40.q40_gemv_q80_indexed.launches
    got = cuda_q40.q40_gemv_q80_indexed(x, q, d, idx)
    want = cuda_q40.q40_gemv_q80_indexed_plain(x, q, d, idx)
    torch.cuda.synchronize()
    assert cuda_q40.q40_gemv_q80_indexed.launches == before + 1
    assert got.shape == (8, out_f)
    # K1's tolerance: exact integer partials, f32 block sums re-associated
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_k1_indexed_reaches_past_2gb(cuda):
    """Groups whose byte offset in q passes 2^31 (Qwen3-30B-A3B's w1 width:
    786,432 B a group, so from group 2,731 up) and the last group."""
    q, d = _flat_stack(cuda, 2800, 2048, 768, seed=3)
    idx = torch.tensor([2730, 2731, 2799, 0], dtype=torch.int32, device=cuda)
    x = _x(1, 2048).to(cuda)
    got = cuda_q40.q40_gemv_q80_indexed(x, q, d, idx)
    want = cuda_q40.q40_gemv_q80_indexed_plain(x, q, d, idx)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("block_r,rows,E", [(8, 256, 128), (16, 512, 32), (32, 512, 16),
                                            (64, 1024, 8)])
def test_k4_kernel_matches_plain(cuda, block_r, rows, E):
    from distributed_llama_tpu_torch.ops.moe import _grouped_layout_direct

    L, layer, dim, ff = 3, 2, 2048, 768
    q1, d1 = _flat_stack(cuda, L * E, dim, ff, seed=block_r)
    q2, d2 = _flat_stack(cuda, L * E, ff, dim, seed=block_r + 1)
    gen = torch.Generator(device=cuda).manual_seed(rows)
    g = torch.randint(0, E, (rows,), dtype=torch.int32, device=cuda, generator=gen)
    dest, be, R_pad = _grouped_layout_direct(g, E, block_r)
    be = be + layer * E
    xp = torch.zeros((R_pad, dim), device=cuda)
    xp[dest] = torch.randn((rows, dim), device=cuda, generator=gen)
    before = cuda_q40.q40_grouped_gemm_bf16.launches
    got1 = cuda_q40.q40_grouped_gemm_bf16(xp, q1, d1, be, block_r)
    want1 = cuda_q40.q40_grouped_gemm_bf16_plain(xp, q1, d1, be, block_r)
    h = torch.randn((R_pad, ff), device=cuda, generator=gen)
    got2 = cuda_q40.q40_grouped_gemm_bf16(h, q2, d2, be, block_r)
    want2 = cuda_q40.q40_grouped_gemm_bf16_plain(h, q2, d2, be, block_r)
    torch.cuda.synchronize()
    assert cuda_q40.q40_grouped_gemm_bf16.launches == before + 2
    # K2's tolerance: exact bf16 products, tensor-core f32 sums in another order
    for got, want in ((got1, want1), (got2, want2)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("rows,E", [(40, 128), (10, 16)])
def test_k4_exact_scale_matches_plain(cuda, rows, E):
    """K4's exact-scale instances (the small-row MoE arm: block_r 8, fewer
    expert rows than experts) within K2's tolerance of their plain version,
    whose weights are the JAX gather arm's; the default instances form
    other weights (each scale rounded to bf16 first)."""
    from distributed_llama_tpu_torch.ops.moe import _grouped_layout_direct

    dim, ff = 2048, 768
    q, d = _flat_stack(cuda, E, dim, ff, seed=rows)
    gen = torch.Generator(device=cuda).manual_seed(rows)
    g = torch.randint(0, E, (rows,), dtype=torch.int32, device=cuda, generator=gen)
    dest, be, R_pad = _grouped_layout_direct(g, E, 8)
    xp = torch.zeros((R_pad, dim), device=cuda)
    xp[dest] = torch.randn((rows, dim), device=cuda, generator=gen)
    got = cuda_q40.q40_grouped_gemm_bf16(xp, q, d, be, 8, True)
    want = cuda_q40.q40_grouped_gemm_bf16_plain(xp, q, d, be, 8, True)
    other = cuda_q40.q40_grouped_gemm_bf16(xp, q, d, be, 8)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert (other - want).abs().max().item() > 1e-4 * want.abs().max().item()


def test_k4_reaches_past_2gb(cuda):
    q, d = _flat_stack(cuda, 2800, 2048, 768, seed=5)
    be = torch.tensor([2730, 2731, 2799, 0, 2799], dtype=torch.int32, device=cuda)
    xp = torch.randn((5 * 8, 2048), device=cuda)
    got = cuda_q40.q40_grouped_gemm_bf16(xp, q, d, be, 8)
    want = cuda_q40.q40_grouped_gemm_bf16_plain(xp, q, d, be, 8)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_new_wrappers_raise_instead_of_falling_back(cuda):
    q, d = _flat_stack(cuda, 8, 256, 256)
    x = _x(1, 256).to(cuda)
    idx = torch.tensor([1, 2], dtype=torch.int32, device=cuda)
    bad = (
        (torch.tensor([1, 2], device=cuda), TypeError),  # int64 index
        (idx.cpu(), ValueError),  # index on another device
        (torch.zeros(9, dtype=torch.int32, device=cuda), ValueError),  # 9 slots
    )
    for i, err in bad:
        with pytest.raises(err):
            cuda_q40.q40_gemv_q80_indexed(x, q, d, i)
    with pytest.raises(ValueError):  # 3 rows for 2 slots
        cuda_q40.q40_gemv_q80_indexed(_x(3, 256).to(cuda), q, d, idx)
    with pytest.raises(TypeError):  # a float16 activation
        cuda_q40.q40_gemv_q80_indexed(x.half(), q, d, idx)
    with pytest.raises(ValueError):  # a weight that is not contiguous
        cuda_q40.q40_gemv_q80_indexed(x, q[:, :, :128], d[:, :, :128], idx)
    xp = _x(16, 256).to(cuda)
    be = torch.tensor([0, 7], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # block_r 12
        cuda_q40.q40_grouped_gemm_bf16(_x(24, 256).to(cuda), q, d, be, 12)
    with pytest.raises(ValueError):  # 2 block groups for 1 block
        cuda_q40.q40_grouped_gemm_bf16(xp, q, d, be, 16)
    with pytest.raises(ValueError):  # x on the CPU, weights on the card
        cuda_q40.q40_grouped_gemm_bf16(xp.cpu(), q, d, be.cpu(), 8)


def test_out_of_range_groups_give_nan(cuda):
    q, d = _flat_stack(cuda, 8, 256, 256)
    idx = torch.tensor([3, 8], dtype=torch.int32, device=cuda)
    out = cuda_q40.q40_gemv_q80_indexed(_x(1, 256).to(cuda), q, d, idx)
    be = torch.tensor([-1, 2], dtype=torch.int32, device=cuda)
    out4 = cuda_q40.q40_grouped_gemm_bf16(_x(16, 256).to(cuda), q, d, be, 8)
    torch.cuda.synchronize()
    assert torch.isfinite(out[0]).all() and torch.isnan(out[1]).all()
    assert torch.isnan(out4[:8]).all() and torch.isfinite(out4[8:]).all()


@pytest.mark.parametrize("rows,in_f,out_f", [(16, 2048, 128256), (32, 2048, 128256),
                                             (9, 2048, 151936), (12, 2080, 384)])
def test_b5_kernel_matches_plain(cuda, rows, in_f, out_f):
    """B5: K2 on an unstacked weight at the vocab widths and a ragged block
    count (65 blocks)."""
    q, d = _flat_stack(cuda, 1, in_f, out_f, seed=rows)
    x = _x(rows, in_f).to(cuda)
    before = cuda_q40.q40_gemm_bf16.launches
    got = cuda_q40.q40_gemm_bf16(x, q[0], d[0])
    want = cuda_q40.q40_gemm_bf16_plain(x, q[0], d[0])
    torch.cuda.synchronize()
    assert cuda_q40.q40_gemm_bf16.launches == before + 1
    # K2's tolerance: exact bf16 products, tensor-core f32 sums in another order
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def _paged_inputs(cuda, L, n_kv, g, hd, b, n_read, ps=16, t=1, seed=0):
    """An int8 pool with b * n_read mapped pages in random order, row 1
    parked (pos_base = seq_len), the other rows live."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    P = b * n_read + 4
    k = torch.randint(-127, 128, (L, P, ps, n_kv, hd), dtype=torch.int8, device=cuda, generator=gen)
    v = torch.randint(-127, 128, (L, P, ps, n_kv, hd), dtype=torch.int8, device=cuda, generator=gen)
    ks = torch.rand((L, P, ps, n_kv), device=cuda, generator=gen) * 0.02 + 1e-3
    vs = torch.rand((L, P, ps, n_kv), device=cuda, generator=gen) * 0.02 + 1e-3
    table = torch.randperm(P, device=cuda, generator=gen)[: b * n_read].reshape(b, n_read)
    table = table.to(torch.int32).contiguous()
    pos = torch.randint(0, n_read * ps - t + 1, (b,), device=cuda, generator=gen)
    pos[min(1, b - 1)] = 4096
    table[0, int(pos[0] + t - 1) // ps + 1 :] = -1  # row 0's unmapped tail
    q = torch.randn((b, t, n_kv * g, hd), device=cuda, generator=gen)
    return q, k, v, ks, vs, pos.contiguous(), table


@pytest.mark.parametrize("hd,n_kv,g", [(64, 8, 4), (128, 4, 8)])
@pytest.mark.parametrize("ps,t,n_read", [(16, 1, 16), (16, 1, 64), (16, 5, 8), (32, 1, 8),
                                         (64, 16, 4)])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_k5_kernel_matches_plain(cuda, hd, n_kv, g, ps, t, n_read, q_dtype):
    """K5 (B6) at both models' head shapes, page sizes 16-64, decode (t = 1)
    and verify-sized (t > 1) query blocks, a parked row and unmapped
    entries. f32 q: f32 sums in another order (1e-4 of the output scale);
    bf16 q (output in bf16): plus one bf16 rounding of the output."""
    q, k, v, ks, vs, pos, table = _paged_inputs(cuda, 2, n_kv, g, hd, 6, n_read, ps, t, seed=hd + t)
    q = q.to(q_dtype)
    before = cuda_attention.paged_flash_attention.launches
    got = cuda_attention.paged_flash_attention(q, k, v, ks, vs, 1, pos, table, n_read, ps)
    want = cuda_attention.paged_flash_attention_plain(q, k, v, ks, vs, 1, pos, table, n_read, ps)
    torch.cuda.synchronize()
    assert cuda_attention.paged_flash_attention.launches == before + 1
    assert got.dtype == q_dtype and got.shape == q.shape
    scale = want.float().abs().max().item()
    tol = 1e-4 * scale if q_dtype == torch.float32 else 1e-4 * scale + 2.0 ** -8 * scale
    assert (got.float() - want.float()).abs().max().item() <= tol


def _paged_row_alone(args, r, n_read):
    """Row r of a paged call as a b = 1 call reading n_read table entries:
    its own entries first, then -1 (unmapped) padding where n_read is
    larger."""
    q, k, v, ks, vs, pos, table = args
    row = table[r : r + 1, : min(n_read, table.shape[1])]
    if n_read > row.shape[1]:
        pad = torch.full((1, n_read - row.shape[1]), -1, dtype=torch.int32, device=row.device)
        row = torch.cat([row, pad], dim=1)
    return q[r : r + 1].contiguous(), k, v, ks, vs, pos[r : r + 1].contiguous(), row.contiguous()


@pytest.mark.parametrize("hd,n_kv,g", [(64, 8, 4), (128, 4, 8)])
@pytest.mark.parametrize("t", [1, 4])
def test_k5_row_bits_do_not_depend_on_batch_or_n_read(cuda, hd, n_kv, g, t):
    """K5's splits are absolute page ranges from paged_plan (page size,
    head_dim, g): a live row of a b = 16 call equals, bit for bit, the same
    row called alone with a larger and a smaller n_read (each covering its
    visible pages)."""
    n_read, ps = 16, 16
    args = _paged_inputs(cuda, 2, n_kv, g, hd, 16, n_read, ps, t, seed=hd + t + 7)
    q, k, v, ks, vs, pos, table = args
    full = cuda_attention.paged_flash_attention(q, k, v, ks, vs, 1, pos, table, n_read, ps)
    torch.cuda.synchronize()
    live = [r for r in range(16) if int(pos[r]) < n_read * ps]
    assert len(live) >= 10
    for r in live:
        need = (int(pos[r]) + t - 1) // ps + 1
        for nr in sorted({need, n_read + 24}):
            rq, *rest, rpos, rtab = _paged_row_alone(args, r, nr)
            alone = cuda_attention.paged_flash_attention(rq, *rest, 1, rpos, rtab, nr, ps)
            torch.cuda.synchronize()
            assert torch.equal(alone[0], full[r]), (r, nr)


@pytest.mark.parametrize("hd,n_kv,g", [(64, 8, 4), (128, 4, 8)])
@pytest.mark.parametrize("ps", [16, 32])
def test_k5_matches_split_plain_at_every_split_edge(cuda, hd, n_kv, g, ps):
    """K5 against paged_split_plain (the same splits, warps' runs and
    ordered merges) with the rows' positions on either side of every page
    edge, so of every warp's run and split edge, up to n_read pages: f32
    dots and P . V sums in another order, 1e-5 of the output's scale."""
    n_read = 12
    assert n_read > cuda_attention.paged_plan(ps, hd, g).split_pages
    edges = [e * ps + d for e in range(1, n_read) for d in (-1, 0)]
    b = len(edges) + 1
    q, k, v, ks, vs, pos, table = _paged_inputs(cuda, 2, n_kv, g, hd, b, n_read, ps, 1, seed=ps)
    pos = torch.tensor([0] + edges, dtype=torch.int64, device=cuda)
    got = cuda_attention.paged_flash_attention(q, k, v, ks, vs, 0, pos, table, n_read, ps)
    want = cuda_attention.paged_split_plain(q, k, v, ks, vs, 0, pos, table, n_read, ps)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_k5_in_a_cuda_graph_resets_its_tickets(cuda):
    """K5 with several splits captured in a CUDA graph and replayed twice:
    both replays equal the eager call bit for bit, so the last CTA of each
    (row, kv head) left its ticket at 0 for the next launch."""
    n_read, ps = 16, 16
    q, k, v, ks, vs, pos, table = _paged_inputs(cuda, 2, 8, 4, 64, 4, n_read, ps, 1, seed=9)
    assert cuda_attention.paged_plan(ps, 64, 4).splits(n_read) > 1
    eager = cuda_attention.paged_flash_attention(q, k, v, ks, vs, 1, pos, table, n_read, ps)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cuda_attention.paged_flash_attention(q, k, v, ks, vs, 1, pos, table, n_read, ps)
    replays = []
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    again = cuda_attention.paged_flash_attention(q, k, v, ks, vs, 1, pos, table, n_read, ps)
    torch.cuda.synchronize()
    assert torch.equal(replays[0], eager) and torch.equal(replays[1], eager)
    assert torch.equal(again, eager)


@pytest.mark.parametrize("block_r", [8, 16, 32, 64])
def test_k4_row_block_bits_do_not_depend_on_other_blocks(cuda, block_r):
    """A row block's K4 output equals, bit for bit, the same block launched
    alone: one CTA per (row block, column tile) over the whole
    contraction, no split."""
    E, dim, ff = 8, 2048, 768
    for in_f, out_f in ((dim, ff), (ff, dim)):
        q, d = _flat_stack(cuda, 2 * E, in_f, out_f, seed=block_r + in_f)
        be = torch.tensor([3, 9, 0, 15, 9], dtype=torch.int32, device=cuda)
        xp = torch.randn((5 * block_r, in_f), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(block_r))
        full = cuda_q40.q40_grouped_gemm_bf16(xp, q, d, be, block_r)
        for i in (1, 4):
            rows = slice(i * block_r, (i + 1) * block_r)
            alone = cuda_q40.q40_grouped_gemm_bf16(xp[rows].contiguous(), q, d, be[i : i + 1].contiguous(),
                                                   block_r)
            torch.cuda.synchronize()
            assert torch.equal(alone, full[rows])


# -- B9 (csrc/q40_i8_mma.cu), P3 and P4 (csrc/i4_gemv_probe.cu), P14 ---------


@pytest.mark.parametrize("rows", [1, 4, 8])
@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (2176, 264), (8192, 2048)])
def test_b9_kernel_matches_plain(cuda, rows, in_f, out_f):
    """B9 at 1-8 rows, a ragged block count (68) and a column count that is
    a multiple of 8 but not of the CTA's 64: exact integer partials, f32
    block sums in another order (1e-5 of the output scale)."""
    x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, rows, cuda, seed=rows)
    before = cuda_q40.q40_i8_unpacked.launches
    got = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt)
    want = cuda_q40.q40_i8_unpacked_plain(x8, xs, qt, dt)
    torch.cuda.synchronize()
    assert cuda_q40.q40_i8_unpacked.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (2176, 264)])
def test_p3_p4_instances_match_plain_and_b9_exactly(cuda, rows, in_f, out_f):
    """P3's two arms (the one-row GEMV at i4_gemv_plan) and P4's three (at
    i32_plan) equal to their plain order and each family's arms to each
    other bit for bit (exact partials in every dot type, one plan's order of
    the f32 sums), and within 1e-5 of B9 (the f32 block sums in another
    order)."""
    x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, rows, cuda, seed=7)
    ref = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt)
    scale = ref.abs().max().item()
    got = {}
    for label, fn, plain, w, dot, _ in int4.variants(qt)[1:]:
        before = fn.launches
        got[label] = fn(x8, xs, w, dt)
        want = plain(x8, xs, w, dt, dot)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, label
        assert torch.equal(got[label], want), label
        assert (got[label] - ref).abs().max().item() <= 1e-5 * scale, label
    assert torch.equal(got["s4 int8-dot"], got["s4 bf16-dot"])
    p4 = [g for label, g in got.items() if label.startswith("i32")]
    assert all(torch.equal(g, p4[0]) for g in p4)


@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048), (2176, 264), (2048, 128256)])
def test_p4_equals_its_plain_order_at_every_row_count(cuda, in_f, out_f):
    """P4's three arms at 1..8 rows: one launch a call at i32_plan, equal
    to the plain order bit for bit, so to each other and, on the same
    values, to P3's int8 instance launched at P4's plan; each row equal to
    its one-row call; within 1e-5 of B9."""
    x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, 8, cuda, seed=in_f + 3 * out_f)
    qw, qt4 = int4.pack_i32_t(qt), int4.pack_s4(qt)
    full = int4.i32_call_plain(x8, xs, qw, dt)
    plan = int4.i32_plan(in_f // 32, out_f)
    for rows in range(1, 9):
        p3 = gemv.launch_i4_gemv(x8[:rows], xs[:rows], qt4, gemv.W_S4, gemv.DOTS["int8"], dt,
                                 plan)
        ref = cuda_q40.q40_i8_unpacked(x8[:rows], xs[:rows], qt, dt)
        for fn in (int4.i32_call_int8, int4.i32_call_bf16, int4.i32_call_f32):
            before = fn.launches
            got = fn(x8[:rows], xs[:rows], qw, dt)
            torch.cuda.synchronize()
            assert fn.launches == before + 1
            assert torch.equal(got, full[:rows]), (fn.__name__, rows)
            assert torch.equal(got, p3), (fn.__name__, rows)
            assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048), (2176, 264), (2048, 128256)])
def test_p3_equals_its_plain_order_at_every_row_count(cuda, in_f, out_f):
    """P3's two arms at 1..8 rows: one launch a call at i4_gemv_plan, equal
    to the plain order and to each other bit for bit, each row equal to its
    one-row call (the plan never reads R)."""
    x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, 8, cuda, seed=in_f + out_f)
    qt4 = int4.pack_s4(qt)
    full = int4.i4_call_plain(x8, xs, qt4, dt)
    for rows in range(1, 9):
        got = {}
        for fn in (int4.i4_call_int8, int4.i4_call_bf16):
            before = fn.launches
            got[fn] = fn(x8[:rows], xs[:rows], qt4, dt)
            torch.cuda.synchronize()
            assert fn.launches == before + 1
            assert torch.equal(got[fn], full[:rows]), (fn.__name__, rows)
        assert torch.equal(got[int4.i4_call_int8], got[int4.i4_call_bf16]), rows


def test_probe_wrappers_raise_instead_of_falling_back(cuda):
    x8, xs, qt, dt, _ = int4.make_operands(256, 64, 1, cuda)
    qt4, qw = int4.pack_s4(qt), int4.pack_i32_t(qt)
    x9, xs9, _, _, _ = int4.make_operands(256, 64, 9, cuda)
    with pytest.raises(ValueError):  # more than 8 rows
        cuda_q40.q40_i8_unpacked(x9, xs9, qt, dt)
    with pytest.raises(ValueError):  # out % 8
        cuda_q40.q40_i8_unpacked(x8, xs, qt[:, :, :60].contiguous(), dt[:, :60].contiguous())
    with pytest.raises(ValueError):  # weights on the CPU, rows on the card
        int4.i4_call(x8, xs, qt4.cpu(), dt)
    with pytest.raises(ValueError):  # the wrong storage for the instance
        int4.i32_call(x8, xs, qt4, dt, dot="f32")
    bias, qp = dma.make_plane(2048, 512, cuda)
    with pytest.raises(ValueError):  # a tile that does not divide the plane
        dma.stream_call(bias, qp, 384, 8)
    with pytest.raises(ValueError):
        dma.stream_call(bias.cpu(), qp, 128, 8)


@pytest.mark.parametrize("in_f,out_f,tile_n,tile_knb",
                         [(2048, 3072, 1024, 8), (2048, 3072, 128, 64), (8192, 2048, 2048, 16),
                          (2048, 128256, 256, 32)])
def test_stream_probe_matches_plain(cuda, in_f, out_f, tile_n, tile_knb):
    """P14: the corner sum is an exact 64-bit sum rounded once, and the
    checksums are XORs: both equal the plain version's exactly."""
    bias, qp = dma.make_plane(in_f, out_f, cuda, seed=in_f + tile_n)
    before = dma.stream_call.launches
    out, chk = dma.stream_call(bias, qp, tile_n, tile_knb)
    p_out, p_chk = dma.stream_call_plain(bias, qp, tile_n, tile_knb)
    torch.cuda.synchronize()
    assert dma.stream_call.launches == before + 1
    assert chk.shape == (out_f // tile_n, in_f // 8 // (4 * tile_knb))
    assert torch.equal(out, p_out)
    assert torch.equal(chk, p_chk)


def test_stream_probe_leaves_its_accumulator_zero(cuda):
    """P14 keeps one accumulator a device across calls: each call, graph
    replays included, reads it from zero and leaves it zero."""
    bias, qp = dma.make_plane(2048, 3072, cuda, seed=5)
    p_out, _ = dma.stream_call_plain(bias, qp, 1024, 8)
    outs = [dma.stream_call(bias, qp, 1024, 8)[0] for _ in range(3)]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        g_out, _ = dma.stream_call(bias, qp, 1024, 8)
    for _ in range(3):
        g.replay()
        outs.append(g_out.clone())
    torch.cuda.synchronize()
    assert all(torch.equal(o, p_out) for o in outs)
    assert not dma._ACC[qp.device].any()


def test_probe_shapes_run_on_the_card(cuda):
    """Each probe's per-shape routine, untimed, at one small shape."""
    rows = int4.run_shape("1024->512", 1024, 512, cuda, timed=False)
    for r in rows:  # P3 and P4 in their plan's order, B9 in its own
        assert r["max_err_vs_b9"] <= (1e-5 * r["out_scale"] if r["kernel"] != "q40_i8_unpacked"
                                      else 0.0)
    best = dma.run_shape("2048->2048", 2048, 2048, cuda, timed=False)
    assert best["checksums_equal_all_tiles"] and best["max_rel_err_all_tiles"] == 0.0


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("b,n_kv,S", [(1, 8, 1024), (2, 4, 1000), (1, 2, 37)])
def test_pure_read_matches_plain(cuda, hd, b, n_kv, S):
    """P11: one launch, bit for bit its plain order; against torch's sum (f32
    sums of bf16 values in another order) within 1e-6 of the column's sum
    of magnitudes."""
    _, k, v = attention.make_operands(b, n_kv, n_kv, hd, S, cuda, seed=S)
    before = attention.pure_read.launches
    got = attention.pure_read(k, v)
    want = attention.pure_read_plain(k, v)
    mag = (k.float().abs().sum(dim=(1, 2)) + v.float().abs().sum(dim=(1, 2))).unsqueeze(1)
    torch.cuda.synchronize()
    assert attention.pure_read.launches == before + 1
    assert got.shape == (b, 1, hd) and got.dtype == torch.float32
    assert torch.equal(got, attention.pure_read_order_plain(k, v))
    assert bool(((got - want).abs() <= 1e-6 * mag).all())


@pytest.mark.parametrize("hd,b,n_kv,S", [(64, 1, 8, 1024), (128, 4, 8, 32768), (64, 3, 2, 37)])
def test_pure_read_graph_replays_leave_its_tickets_zero(cuda, hd, b, n_kv, S):
    """P11's ticket merge: eager calls and three replays of a captured call
    each equal the plain order bit for bit, and leave every ticket zero."""
    _, k, v = attention.make_operands(b, n_kv, n_kv, hd, S, cuda, seed=hd + S)
    want = attention.pure_read_order_plain(k, v)
    outs = [attention.pure_read(k, v) for _ in range(3)]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        g_out = attention.pure_read(k, v)
    for _ in range(3):
        g.replay()
        outs.append(g_out.clone())
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)
    assert not cuda_attention._tickets(k.device, b).any()


@pytest.mark.parametrize("hd,g,S,pos,col0", [
    (64, 4, 1024, 1014, 0), (64, 8, 2048, 700, 0), (128, 4, 512, 300, 100),
    (128, 8, 1024, 1023, 0), (64, 4, 256, 20, 0), (64, 4, 300, 200, 10), (128, 2, 4096, 4000, 0),
])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_matches_plain(cuda, hd, g, S, pos, col0, q_dtype):
    """P12: one launch a call; p rounds to bf16 against the same running
    maxima as the plain version's (the plan's runs and tiles), so only the
    f32 sums' order and exp differ: within 2^-6 of the plain output's
    largest value (a few bf16 ulps; the output shrinks as 1/sqrt(S), so an
    absolute bound would hide a lost split at long S)."""
    n_kv = 2
    q, k, v = attention.make_operands(1, n_kv * g, n_kv, hd, S, cuda, seed=hd + g + S)
    q = q.to(q_dtype)
    before = attention.decode_attention.launches
    got = attention.decode_attention(q, k, v, pos, col0)
    want = attention.decode_attention_plain(q, k, v, pos, col0)
    torch.cuda.synchronize()
    assert attention.decode_attention.launches == before + 1
    assert got.dtype == q_dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= ATT_REL_TOL * want.float().abs().max().item()


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("max_cluster", [8, 16])
def test_decode_attention_every_plan_matches_plain(cuda, hd, max_cluster):
    """The plan's instance at clusters of up to 8 and 16 CTAs, at S 32768
    and 1000 (a ragged last tile), b 2: within 2^-6 of the plain version in
    that plan's order; the cache past the visible columns is never read
    (NaN there changes nothing)."""
    for S, pos in ((32768, 32000), (1000, 999)):
        q, k, v = attention.make_operands(2, 16, 4, hd, S, cuda, seed=S + hd)
        k[:, :, pos + 1:] = float("nan")
        v[:, :, pos + 1:] = float("nan")
        plan = attention.attention_plan(S, hd, max_cluster)
        got = attention._launch_attention(q, k, v, pos, 0, plan)
        want = attention.decode_attention_plain(q, k, v, pos, 0, plan)
        torch.cuda.synchronize()
        assert torch.isfinite(want).all()
        assert (got.float() - want.float()).abs().max().item() <= \
            ATT_REL_TOL * want.float().abs().max().item(), (S, plan)


def test_decode_attention_with_nothing_visible_is_zero(cuda):
    q, k, v = attention.make_operands(1, 8, 2, 64, 256, cuda)
    got = attention.decode_attention(q, k, v, pos=5, col0=10)
    torch.cuda.synchronize()
    assert torch.equal(got, attention.decode_attention_plain(q, k, v, 5, 10))
    assert not got.any()


@pytest.mark.parametrize("S,pos", [(1024, 1014), (2048, 100)])
def test_flash_headmajor_runs_k3_on_the_view(cuda, S, pos):
    """P8: K3 on the head-major cache's [b, S, kv, hd] view, no copy; the
    same attention as P12; each within 2^-6 of the output's largest value,
    P8 against P12 within twice that (two roundings apart)."""
    q, k, v = attention.make_operands(1, 32, 8, 64, S, cuda, seed=S)
    view = attention.headmajor_view(k)
    assert view.data_ptr() == k.data_ptr() and view.stride() == (8 * S * 64, 64, S * 64, 1)
    q4 = q.reshape(1, 1, 32, 64)
    before = cuda_attention.flash_attention.launches
    got = attention.flash_headmajor(q4, k, v, pos)
    want = attention.flash_headmajor_plain(q4, k, v, pos)
    p12 = attention.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert cuda_attention.flash_attention.launches == before + 1
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= ATT_REL_TOL * scale
    assert (got.reshape(1, 32, 64).float() - p12.float()).abs().max().item() <= 2 * ATT_REL_TOL * scale


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048), (2176, 200)])
def test_fs_call_tiles_match_plain_and_k1(cuda, rows, in_f, out_f):
    """P7: every tile within 1e-5 of the output scale of its plain version
    (exact integer partials, f32 block sums in the tile's order); K1's call
    equal to its blocked plain version bit for bit; the prologue alone
    equal to its plain version (the same f32 operations, round half to
    even). The tiles other than the first K1's are built at 1 and 8 rows
    only and refuse 3."""
    x, q, d = int4_prod.make_operands(in_f, out_f, cuda, seed=rows, rows=rows)
    x8, xs, bs = int4_prod.q80_prologue(x)
    for got, want in zip((x8, xs, bs), int4_prod.q80_prologue_plain(x)):
        assert torch.equal(got, want)
    k1 = cuda_q40.q40_gemv_q80(x, q, d)
    plan = cuda_q40.gemv_plan(in_f // 32, out_f)
    assert torch.equal(k1, cuda_q40.q40_gemv_q80_blocked(x, q, d, plan))
    want = int4_prod.fs_call_tiles_plain(x8, xs, bs, q, d, *cuda_q40.FIRST_K1_TILE)
    scale = want.abs().max().item()
    for cols, ksplit in cuda_q40.GEMV_TILES:
        before = int4_prod.fs_call_tiles.launches
        if (cols, ksplit) != cuda_q40.FIRST_K1_TILE and rows not in cuda_q40.BODY_ROWS:
            with pytest.raises(ValueError):
                int4_prod.fs_call_tiles(x8, xs, bs, q, d, cols, ksplit)
            assert int4_prod.fs_call_tiles.launches == before
            continue
        got = int4_prod.fs_call_tiles(x8, xs, bs, q, d, cols, ksplit)
        torch.cuda.synchronize()
        assert int4_prod.fs_call_tiles.launches == before + 1
        assert (got - want).abs().max().item() <= 1e-5 * scale, (cols, ksplit)


def test_floor_wrappers_raise_instead_of_falling_back(cuda):
    q, k, v = attention.make_operands(1, 8, 2, 96, 128, cuda)
    with pytest.raises(ValueError):  # head_dim 96
        attention.pure_read(k, v)
    with pytest.raises(ValueError):
        attention.decode_attention(q, k, v, 100)
    q, k, v = attention.make_operands(1, 8, 2, 64, 128, cuda)
    with pytest.raises(ValueError):  # a cache that is not contiguous
        attention.pure_read(k.transpose(2, 3).contiguous().transpose(2, 3), v)
    with pytest.raises(ValueError):  # V on the CPU
        attention.decode_attention(q, k, v.cpu(), 100)
    with pytest.raises(TypeError):  # an f32 cache
        attention.pure_read(k.float(), v.float())
    x, qp, d = int4_prod.make_operands(256, 64, cuda)
    x8, xs, bs = int4_prod.q80_prologue(x)
    with pytest.raises(ValueError):  # a tile that is not built
        int4_prod.fs_call_tiles(x8, xs, bs, qp, d, 256, 8)
    with pytest.raises(ValueError):  # bs as f32
        int4_prod.fs_call_tiles(x8, xs, bs.float(), qp, d, 32, 8)
    with pytest.raises(ValueError):  # rows on the CPU
        int4_prod.fs_call_tiles(x8.cpu(), xs.cpu(), bs.cpu(), qp, d, 32, 8)


def test_floor_probes_run_on_the_card(cuda):
    """Each probe's per-shape routine, untimed, at one small shape."""
    rows = attention.run_seq(256, cuda, timed=False)
    assert [r["probe"] for r in rows] == ["pure_read", "decode_attention", "flash_headmajor"]
    # P11: 1e-6 of a column's sum of magnitudes (2 * 8 * 256 values, |x| < 4)
    assert rows[0]["max_abs_err"] <= 1e-6 * 2 * 8 * 256 * 4
    for row in rows[1:]:
        assert row["max_abs_err"] <= ATT_REL_TOL * row["out_scale"]
    assert rows[1]["p12_vs_p8"] <= 2 * ATT_REL_TOL * rows[1]["out_scale"]
    row = int4_prod.run_shape("1024->512", 1024, 512, cuda, timed=False)
    assert row["k1_vs_blocked"] == 0.0 and row["max_abs_err"] <= 1e-5 * row["out_scale"]


# -- P1, P13 (csrc/i8_tile_probe.cu), P2, P6 (the GEMV of csrc/i8_gemv.cuh) --


@pytest.mark.parametrize("n", [65536, 65533, 1])
def test_f16bits_convert_matches_plain_bit_for_bit(cuda, n):
    """P1 on every f16 bit pattern (and a tail that is not a multiple of
    the 4 elements a thread converts): equal to the plain version bit for
    bit through int32 views, inf/NaN patterns included."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)[:n].to(cuda)
    before = scales.f16bits_to_f32.launches
    got = scales.f16bits_to_f32(bits)
    want = scales.f16bits_to_f32_plain(bits)
    torch.cuda.synchronize()
    assert scales.f16bits_to_f32.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ref = bits.view(torch.float16).float()
    finite = torch.isfinite(ref)
    assert torch.equal(got[finite], ref[finite]) and torch.isfinite(got).all()


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 264)])
def test_i8_tile_instances_match_plain_and_each_other(cuda, rows, in_f, out_f):
    """P13 at every tile: each plane within 1e-5 of the output scale of the
    plain version (exact integer partials, f32 block sums in the tile's
    order), and the f16, f32 and i16 planes equal bit for bit (the same
    f32 scale for every finite f16)."""
    x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, rows, cuda, seed=rows + in_f)
    planes = scale_planes(dt)
    want = cuda_q40.i8_blocks_plain(x8, xs, qt, dt)
    scale = want.abs().max().item()
    for cols, blocks in scales.tiles_for(in_f // 32):
        outs = []
        for plane, d in planes.items():
            before = scales.i8_tile_call.launches
            outs.append(scales.i8_tile_call(x8, xs, qt, d, cols, blocks))
            torch.cuda.synchronize()
            assert scales.i8_tile_call.launches == before + 1
            assert (outs[-1] - want).abs().max().item() <= 1e-5 * scale, (plane, cols, blocks)
        assert all(torch.equal(outs[0], o) for o in outs[1:]), (cols, blocks)


@pytest.mark.parametrize("in_f,out_f", [(2048, 2048), (2048, 32768), (8192, 2048),
                                        (4096, 14336)])
def test_i8_tile_at_b9s_tile_is_b9(cuda, in_f, out_f):
    """P13 at 64 columns and B9's split is B9's kernel: equal bit for bit
    on each of the three planes."""
    nb = in_f // 32
    splits = cuda_q40.i8_mma_splits(nb, out_f)
    assert nb % splits == 0
    x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, 1, cuda, seed=3)
    ref = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt)
    for plane, d in scale_planes(dt).items():
        assert torch.equal(scales.i8_tile_call(x8, xs, qt, d, 64, nb // splits), ref), plane


def test_scale_plane_call_matches_plain_and_p13(cuda):
    """P2 at its shape at 1..8 rows: one launch a call at `i8_gemv_plan`,
    equal to its plain version bit for bit (the plan's order), each row
    equal to its one-row call, the f32 and i16 planes equal bit for bit,
    and within 1e-5 of P13 at P2_TILE (exact integer partials, f32 block
    sums in another order)."""
    x8, xs, qt, dt, _ = int4.make_operands(2048, 8192, 8, cuda, seed=2)
    planes = scale_planes(dt)
    p13 = scales.i8_tile_call(x8, xs, qt, planes["f16"], *scales.P2_TILE)
    ones = {p: torch.cat([scales.scale_plane_call(x8[r:r + 1], xs[r:r + 1], qt, planes[p])
                          for r in range(8)]) for p in ("f32", "i16")}
    for rows in range(1, 9):
        outs = {}
        for plane in ("f32", "i16"):
            before = scales.scale_plane_call.launches
            got = scales.scale_plane_call(x8[:rows], xs[:rows], qt, planes[plane])
            torch.cuda.synchronize()
            assert scales.scale_plane_call.launches == before + 1
            assert torch.equal(got, scales.scale_plane_call_plain(x8[:rows], xs[:rows], qt,
                                                                  planes[plane])), (plane, rows)
            assert torch.equal(got, ones[plane][:rows]), (plane, rows)
            want = p13[:rows]
            assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
            outs[plane] = got
        assert torch.equal(outs["f32"], outs["i16"]), rows


@pytest.mark.parametrize("in_f,out_f", [(2048, 2048), (8192, 2048), (1024, 264), (4096, 14336)])
def test_scale_plane_call_every_plan_matches_its_plain_order(cuda, in_f, out_f):
    """The built (vec, kw) pair at 1 and 4 splits, and the shape's own
    plan: bit for bit the plain version in that plan's order, at 1 and 3
    rows."""
    nb = in_f // 32
    for rows in (1, 3):
        x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, rows, cuda, seed=rows + in_f)
        plane = scale_planes(dt)["i16"]
        plans = [scales.i8_gemv_plan(nb, out_f)]
        vec, kw = scales.P2_VEC, scales.P2_KW
        for splits in (1, 4):
            bps = -(-nb // splits)
            if (splits - 1) * bps < nb:
                plans.append(scales.GemvPlan(vec, 32 * vec * (8 // kw), kw, splits, bps))
        for plan in plans:
            got = scales.launch_scale_plane(x8, xs, qt, plane, plan)
            torch.cuda.synchronize()
            assert torch.equal(got, scales.scale_plane_call_plain(x8, xs, qt, plane, plan)), plan


def test_scale_plane_call_on_every_bit_pattern(cuda):
    """P2's i16 plane holding all 65,536 f16 bit patterns (inf and NaN
    included): the kernel's convert gives the JAX integer algorithm's value
    for each, so it equals the plain version and the f32 plane of those
    values bit for bit."""
    nb, out_f = 256, 256
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).reshape(nb, out_f)
    x8, xs, qt, _, _ = int4.make_operands(nb * 32, out_f, 2, cuda, seed=9)
    plane = bits.to(cuda)
    got = scales.scale_plane_call(x8, xs, qt, plane)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, scales.scale_plane_call_plain(x8, xs, qt, plane))
    assert torch.equal(got, scales.scale_plane_call(x8, xs, qt, scales.plane_f32(plane)))


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048), (2048, 264)])
def test_i4_sweep_matches_plain_and_p4(cuda, rows, in_f, out_f):
    """P6 at every tile, one launch a call whatever the variant, equal to
    its plain order bit for bit and within 1e-5 of P4's bf16 instance; at
    P3's plan equal to P3's bf16 arm, and at P4's (where P6's tiles include
    it) to P4's bf16 arm, bit for bit."""
    nb = in_f // 32
    x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, rows, cuda, seed=rows)
    qw = int4.pack_i32_t(qt)
    bits = dt.view(torch.int16)
    p4 = int4.i32_call(x8, xs, qw, dt, dot="bf16")
    scale = p4.abs().max().item()
    tiles, _ = i4_tiles.tiles_for(nb)
    for cols, blocks in tiles:
        want = i4_tiles.i4_sweep_call_plain(x8, xs, qw, bits, cols, blocks)
        for variant in i4_tiles.VARIANTS:
            before = i4_tiles.i4_sweep_call.launches
            got = i4_tiles.i4_sweep_call(x8, xs, qw, bits, cols, blocks, variant)
            torch.cuda.synchronize()
            assert i4_tiles.i4_sweep_call.launches == before + 1
            assert torch.equal(got, want), (cols, blocks, variant)
            assert (got - p4).abs().max().item() <= 1e-5 * scale, (cols, blocks, variant)
    p3 = i4_tiles.p3_tile(nb, out_f)
    assert torch.equal(i4_tiles.i4_sweep_call(x8, xs, qw, bits, *p3),
                       int4.i4_call_bf16(x8, xs, int4.pack_s4(qt), dt))
    at_p4 = i4_tiles.plan_tile(int4.i32_plan(nb, out_f))
    assert at_p4 in tiles
    assert torch.equal(i4_tiles.i4_sweep_call(x8, xs, qw, bits, *at_p4), p4)


@pytest.mark.parametrize("cols,blocks", [(128, 8), (1024, 64), (256, 16)])
def test_i4_sweep_equals_its_plain_order_at_every_row_count(cuda, cols, blocks):
    """P6 at 1..8 rows: equal to its plain order bit for bit, each row
    equal to its one-row call."""
    x8, xs, qt, dt, _ = int4.make_operands(2048, 3072, 8, cuda, seed=cols + blocks)
    qw, bits = int4.pack_i32_t(qt), dt.view(torch.int16)
    full = i4_tiles.i4_sweep_call_plain(x8, xs, qw, bits, cols, blocks)
    for rows in range(1, 9):
        got = i4_tiles.i4_sweep_call(x8[:rows], xs[:rows], qw, bits, cols, blocks)
        torch.cuda.synchronize()
        assert torch.equal(got, full[:rows]), rows


def test_tile_probe_wrappers_raise_instead_of_falling_back(cuda):
    x8, xs, qt, dt, _ = int4.make_operands(2048, 256, 1, cuda)
    qw, bits = int4.pack_i32_t(qt), dt.view(torch.int16)
    for cols, blocks in ((48, 8), (64, 3), (64, 0), (256, 8)):  # tiles that are not built
        with pytest.raises(ValueError):
            scales.i8_tile_call(x8, xs, qt, dt, cols, blocks)
    # P6: not a tile column width, not a divisor, none, 16 splits past the cluster
    for cols, blocks in ((48, 8), (128, 3), (128, 0), (2048, 8), (128, 4)):
        with pytest.raises(ValueError):
            i4_tiles.i4_sweep_call(x8, xs, qw, bits, cols, blocks)
    with pytest.raises(ValueError):  # B9's own f16 plane is not one of P2's
        scales.scale_plane_call(x8, xs, qt, dt)
    with pytest.raises(ValueError):  # a bf16 plane
        scales.i8_tile_call(x8, xs, qt, dt.to(torch.bfloat16), 64, 8)
    with pytest.raises(ValueError):  # a variant the JAX probe does not have
        i4_tiles.i4_sweep_call(x8, xs, qw, bits, 128, 8, "concat-f32")
    with pytest.raises(ValueError):  # P6 reads the int16 bits, not the f16 plane
        i4_tiles.i4_sweep_call(x8, xs, qw, dt, 128, 8)
    with pytest.raises(ValueError):  # the plane on the CPU
        scales.i8_tile_call(x8, xs, qt, dt.cpu(), 64, 8)
    with pytest.raises(ValueError):  # f16 storage, not its int16 bits
        scales.f16bits_to_f32(dt)
    with pytest.raises(ValueError):  # an odd start
        scales.f16bits_to_f32(dt.view(torch.int16).reshape(-1)[1:])


def test_scale_probes_run_on_the_card(cuda):
    """Each probe's routines, untimed, at small shapes."""
    rows = scales.sweep_shape("1024->512", 1024, 512, cuda, time_it=False, quick=True)
    assert len(rows) == 3 * len(scales.tiles_for(32, quick=True))
    assert all(r["planes_bit_equal"] and r["max_abs_err"] <= 1e-5 * r["out_scale"] for r in rows)
    assert all(r["bit_equal_plain"] and r["equal_f16_on_finite"]
               for r in scales.convert_rows(cuda, time_it=False))
    got = i4_tiles.sweep_shape("1024->512", 1024, 512, cuda, time_it=False)
    assert all(r["variants"] == list(i4_tiles.VARIANTS) and r["bit_equal_plain"]
               and r["max_abs_err_vs_b9"] <= 1e-5 * r["out_scale"] for r in got["tiles"])
    assert [r["equals_p3"] for r in got["tiles"] if r["p3_plan"]] == [True]


def _codec_operands(in_f, out_f, rows, device, seed):
    """x8, xs, bs, qt, the f16 plane and both codecs' planes of one draw."""
    x8, xs, qt, dt, _ = int4.make_operands(in_f, out_f, rows, device, seed=seed)
    bs = int4b.block_sums(x8, in_f // 32)
    return x8, xs, bs, qt, dt, int4c.pack_feature_split(qt), int4b.pack_split_half(qt)


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048), (2048, 264)])
def test_feature_split_instances_match_plain_and_each_other(cuda, rows, in_f, out_f):
    """P9 at every tile and plane bit for bit equal to the plain order of
    the tile's plan (exact corrected partials, f32 block sums in the plan's
    order; 264 columns leave a ragged last tile), one launch a call; P10 on
    the [nb, 4, out] view and the i16 plane equal to P9 on the f16 plane."""
    nb = in_f // 32
    x8, xs, bs, qt, dt, qp, _ = _codec_operands(in_f, out_f, rows, cuda, rows + in_f)
    qp2d = qp.view(nb * 4, out_f)
    tiles, _ = int4c.tiles_for(nb, out_f)
    assert tiles
    for cols, blocks in tiles:
        outs = []
        for d in int4b.planes(dt).values():
            before = (int4c.fs2d_call.launches, int4c.fs_call.launches)
            outs += [int4c.fs2d_call(x8, xs, bs, qp2d, d, cols, blocks),
                     int4c.fs_call(x8, xs, bs, qp, d, cols, blocks)]
            torch.cuda.synchronize()
            assert (int4c.fs2d_call.launches, int4c.fs_call.launches) == (before[0] + 1,
                                                                          before[1] + 1)
            want = int4c.fs2d_call_plain(x8, xs, bs, qp2d, d, cols, blocks)
            assert torch.equal(outs[-1], want), (d.dtype, cols, blocks)
        assert all(torch.equal(outs[0], o) for o in outs[1:]), (cols, blocks)


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048), (2048, 2560)])
def test_split_half_instances_match_plain_and_each_other(cuda, rows, in_f, out_f):
    """P5 at every tile whose half-width divides out / 2 (at 2560 the two
    narrower widths: the others raise), each plane and storage bit for bit
    equal to the plain order of the tile's plan, [R, 2, out / 2] in natural
    column order; the two storages and the two planes equal."""
    nb = in_f // 32
    x8, xs, bs, qt, dt, _, qp = _codec_operands(in_f, out_f, rows, cuda, rows + out_f)
    dt2 = {p: d.reshape(nb, 2, out_f // 2) for p, d in int4b.planes(dt).items()}
    tiles, _ = int4b.tiles_for(nb, out_f)
    for cols in gemv.u4_tile_cols(gemv.W_SH):
        if (out_f // 2) % (cols // 2):
            assert all(c != cols for c, _ in tiles)
            with pytest.raises(ValueError):
                int4b.sh_call(x8, xs, bs, qp, dt2["f16"], cols, nb)
    assert tiles
    for cols, blocks in tiles:
        outs = []
        for d in dt2.values():
            want = int4b.sh_call_plain(x8, xs, bs, qp, d, cols, blocks)
            for storage in int4b.STORAGES:
                before = int4b.sh_call.launches
                outs.append(int4b.sh_call(x8, xs, bs, int4b.storage_view(qp, storage), d, cols,
                                          blocks, storage))
                torch.cuda.synchronize()
                assert int4b.sh_call.launches == before + 1
                assert outs[-1].shape == (rows, 2, out_f // 2)
                assert torch.equal(outs[-1], want), (storage, cols, blocks)
        assert all(torch.equal(outs[0], o) for o in outs[1:]), (cols, blocks)


CODEC_SHAPES = [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048), (2048, 32768)]


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("in_f,out_f", CODEC_SHAPES)
def test_codecs_at_p3s_plan_are_p3_and_near_b9(cuda, rows, in_f, out_f):
    """At P3's plan's warps along k and blocks a split, both codecs on
    either plane equal P3's int8 arm bit for bit (a plan's order does not
    depend on the loader), and every codec output is within 1e-5 of B9's
    largest value (the same exact partials, f32 sums in another order)."""
    nb = in_f // 32
    x8, xs, bs, qt, dt, qp, qsh = _codec_operands(in_f, out_f, rows, cuda, 5)
    p3 = int4.i4_call_int8(x8, xs, int4.pack_s4(qt), dt)
    b9 = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt)
    tol = 1e-5 * b9.abs().max().item()
    fs_tile = gemv.u4_p3_tile(nb, out_f, gemv.W_FS)
    sh_tile = gemv.u4_p3_tile(nb, out_f, gemv.W_SH)
    for d in int4b.planes(dt).values():
        got = int4c.fs2d_call(x8, xs, bs, qp.view(nb * 4, out_f), d, *fs_tile)
        assert torch.equal(got, p3), d.dtype
        sh = int4b.sh_call(x8, xs, bs, qsh, d.reshape(nb, 2, out_f // 2), *sh_tile)
        assert torch.equal(sh.reshape(rows, out_f), p3), d.dtype
        for w in (gemv.W_FS, gemv.W_SH):
            plan = gemv.u4_gemv_plan(nb, out_f, w)
            got = (int4c.fs_call(x8, xs, bs, qp, d, plan.cols, plan.blocks_per_split)
                   if w == gemv.W_FS else
                   int4b.sh_call(x8, xs, bs, qsh, d.reshape(nb, 2, out_f // 2), plan.cols,
                                 plan.blocks_per_split).reshape(rows, out_f))
            assert (got - b9).abs().max().item() <= tol, (w, d.dtype)


@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048), (2048, 32768)])
def test_codecs_default_plan_rows_equal_one_row_calls(cuda, in_f, out_f):
    """At each codec's default plan (a function of the shape alone), 1..8
    rows: each row bit for bit its one-row call, one launch a call."""
    nb = in_f // 32
    x8, xs, bs, qt, dt, qp, qsh = _codec_operands(in_f, out_f, 8, cuda, 8)
    bits = dt.view(torch.int16)
    fs = gemv.u4_gemv_plan(nb, out_f, gemv.W_FS)
    sh = gemv.u4_gemv_plan(nb, out_f, gemv.W_SH)

    def call(w, r0, r1):
        if w == gemv.W_FS:
            return int4c.fs_call(x8[r0:r1], xs[r0:r1], bs[r0:r1], qp, bits, fs.cols,
                                 fs.blocks_per_split)
        return int4b.sh_call(x8[r0:r1], xs[r0:r1], bs[r0:r1], qsh, bits.reshape(nb, 2, -1),
                             sh.cols, sh.blocks_per_split).reshape(r1 - r0, out_f)

    for w in (gemv.W_FS, gemv.W_SH):
        singles = torch.cat([call(w, r, r + 1) for r in range(8)])
        for rows in range(1, 9):
            before = (int4c.fs_call.launches, int4b.sh_call.launches)
            got = call(w, 0, rows)
            torch.cuda.synchronize()
            after = (int4c.fs_call.launches, int4b.sh_call.launches)
            assert sum(after) - sum(before) == 1
            assert torch.equal(got, singles[:rows]), (w, rows)


def test_codec_wrappers_raise_instead_of_falling_back(cuda):
    x8, xs, bs, qt, dt, qp, qsh = _codec_operands(2048, 256, 1, cuda, 0)
    qp2d, dt2 = qp.view(256, 256), dt.reshape(64, 2, 128)
    # tiles that are not built, and 16 splits: past the cluster limit
    for cols, blocks in ((48, 8), (256, 3), (256, 0), (300, 8), (256, 4)):
        with pytest.raises(ValueError):
            int4c.fs2d_call(x8, xs, bs, qp2d, dt, cols, blocks)
        with pytest.raises(ValueError):
            int4b.sh_call(x8, xs, bs, qsh, dt2, cols, blocks)
    with pytest.raises(ValueError):  # bs as f32, as the JAX probes hold it
        int4c.fs_call(x8, xs, bs.float(), qp, dt, 256, 8)
    with pytest.raises(ValueError):  # bs on the CPU
        int4c.fs_call(x8, xs, bs.cpu(), qp, dt, 256, 8)
    with pytest.raises(ValueError):  # one row's sums for three rows
        int4c.fs_call(x8.expand(3, -1).contiguous(), xs.expand(3, -1).contiguous(), bs, qp, dt,
                      256, 8)
    with pytest.raises(ValueError):  # B9's unpacked weight, not the words
        int4c.fs_call(x8, xs, bs, qt, dt, 256, 8)
    with pytest.raises(ValueError):  # the split-half bytes as i32st without the view
        int4b.sh_call(x8, xs, bs, qsh, dt2, 256, 8, "i32st")
    with pytest.raises(ValueError):  # a storage the JAX probe does not have
        int4b.sh_call(x8, xs, bs, qsh, dt2, 256, 8, "u8ops")
    with pytest.raises(ValueError):  # a bf16 plane
        int4c.fs_call(x8, xs, bs, qp, dt.to(torch.bfloat16), 256, 8)
    with pytest.raises(ValueError):  # the plane on the CPU
        int4b.sh_call(x8, xs, bs, qsh, dt2.cpu(), 256, 8)
    x8w, xsw, bsw, _, dtw, _, qshw = _codec_operands(2048, 264, 1, cuda, 0)
    for cols in gemv.u4_tile_cols(gemv.W_SH):  # (out / 2) % (cols / 2) != 0: 132 bytes
        with pytest.raises(ValueError):
            int4b.sh_call(x8w, xsw, bsw, qshw, dtw.reshape(64, 2, 132), cols, 8)


def test_codec_probes_run_on_the_card(cuda):
    """Each codec probe's routine, untimed, at a small shape."""
    for mod, flag in ((int4b, "storages_bit_equal"), (int4c, "views_bit_equal")):
        got = mod.sweep_shape("1024->512", 1024, 512, cuda, time_it=False)
        assert [r["probe"] for r in got["baseline"]] == ["B9 baseline", "first K1 body"]
        assert len(got["tiles"]) == 2 * len(mod.tiles_for(32, 512)[0])
        assert all(r[flag] and r["planes_bit_equal"] and r["bit_equal_plain"]
                   and r["max_abs_err_vs_b9"] <= 1e-5 * r["out_scale"] for r in got["tiles"])
        assert [r["equals_p3"] for r in got["tiles"] if r["p3_plan"]] == [True, True]


# ---------------------------------------------------------------------------
# K2 and K3/B8 as redesigned for the card: split-K in a cluster, split-S
# with a combine pass
# ---------------------------------------------------------------------------

# K2's serving shapes (in, out): Llama-3.2-1B wqkv, wo, w13, w2; Qwen3-30B-A3B
# wqkv, wo; both vocab widths
K2_SHAPES = [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048), (2048, 5120),
             (4096, 2048), (2048, 128256), (2048, 151936)]


def _signed_stack(cuda, groups, in_f, out_f, seed=0):
    """`_flat_stack` with scales of both signs (a Q40 scale takes the sign
    of its block's largest value), so -0 weights occur too."""
    q, d = _flat_stack(cuda, groups, in_f, out_f, seed)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    sign = torch.randint(0, 2, d.shape, device=cuda, generator=gen) * 2 - 1
    return q, (d * sign).half()


@pytest.mark.parametrize("rows", [9, 16, 32, 40])
@pytest.mark.parametrize("in_f,out_f", K2_SHAPES)
def test_k2_matches_plain_at_every_serving_shape(cuda, in_f, out_f, rows):
    """K2 stacked (layer 1) and unstacked (B5) within 1e-4 of the plain
    version's output scale: the dequantized weights are the plain
    version's bits and only the f32 order of sums differs (tensor-core
    accumulation within a block, warps, then splits)."""
    q, d = _signed_stack(cuda, 2, in_f, out_f, seed=in_f + out_f + rows)
    x = torch.randn((1, rows, in_f), device=cuda, generator=torch.Generator(device=cuda).manual_seed(rows))
    want = cuda_q40.q40_gemm_bf16_plain(x, q[1], d[1])
    got = cuda_q40.q40_gemm_bf16_stacked(x, q, d, 1)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    if out_f > 100_000:
        got0 = cuda_q40.q40_gemm_bf16(x, q[0].contiguous(), d[0].contiguous())
        want0 = cuda_q40.q40_gemm_bf16_plain(x, q[0], d[0])
        torch.cuda.synchronize()
        assert (got0 - want0).abs().max().item() <= 1e-4 * want0.abs().max().item()


@pytest.mark.parametrize("rows", [9, 40])
@pytest.mark.parametrize("in_f,out_f", [(2080, 200), (96, 13), (32, 1), (4096, 2052)])
def test_k2_matches_plain_at_ragged_shapes(cuda, in_f, out_f, rows):
    """Shapes no model serves still run: a block count that no split or
    stage divides, widths whose word and scale rows are not 16-byte
    aligned (loaded element by element) and a masked last column tile."""
    q, d = _signed_stack(cuda, 2, in_f, out_f, seed=in_f + out_f + rows)
    x = torch.randn((rows, in_f), device=cuda, generator=torch.Generator(device=cuda).manual_seed(rows))
    want = cuda_q40.q40_gemm_bf16_plain(x, q[1], d[1])
    got = cuda_q40.q40_gemm_bf16_stacked(x, q, d, 1)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048), (2048, 16384), (2048, 128256)])
def test_k2_row_bits_do_not_depend_on_other_rows(cuda, in_f, out_f):
    """A row's output bits depend on its own input only: rows 0-15 of a
    40-row call equal a 16-row call of those rows, the 40-row call's tail
    equals the same rows called alone, and two launches are equal."""
    q, d = _signed_stack(cuda, 2, in_f, out_f, seed=out_f)
    x = torch.randn((40, in_f), device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    full = cuda_q40.q40_gemm_bf16_stacked(x, q, d, 1)
    head = cuda_q40.q40_gemm_bf16_stacked(x[:16].contiguous(), q, d, 1)
    tail = cuda_q40.q40_gemm_bf16_stacked(x[32:].contiguous(), q, d, 1)
    again = cuda_q40.q40_gemm_bf16_stacked(x, q, d, 1)
    torch.cuda.synchronize()
    assert torch.equal(full[:16], head)
    assert torch.equal(full[32:], tail)
    assert torch.equal(full, again)


def test_k2_and_k3_wrappers_raise_instead_of_falling_back(cuda):
    q, d = _flat_stack(cuda, 2, 256, 384)
    with pytest.raises(IndexError):  # a layer past the stack
        cuda_q40.q40_gemm_bf16_stacked(_x(16, 256).to(cuda), q, d, 2)
    with pytest.raises(ValueError):  # 128 features, weight 256
        cuda_q40.q40_gemm_bf16_stacked(_x(16, 128).to(cuda), q, d, 0)
    qq = torch.randn((1, 8, 8, 64), device=cuda)
    k = torch.randn((1, 256, 2, 64), device=cuda)
    with pytest.raises(TypeError):  # an f32 cache: the kernel takes bf16
        cuda_attention.flash_attention(qq, k, k, 0)
    kb = torch.randn((1, 256, 2, 96), device=cuda).bfloat16()
    with pytest.raises(ValueError):  # head_dim 96
        cuda_attention.flash_attention(torch.randn((1, 8, 8, 96), device=cuda), kb, kb, 0)


def _long_cache(cuda, hd, S_view, n_kv, seed):
    """K and V [b, S_view, n_kv, hd] as strided views of one stacked bf16
    cache, as the main path passes them."""
    gen = torch.Generator().manual_seed(seed)
    cache = torch.randn((2, 1, S_view + 256, n_kv, hd), generator=gen).to(torch.bfloat16).to(cuda)
    return cache[0, :, :S_view], cache[1, :, :S_view]


@pytest.mark.parametrize("hd,g", [(64, 4), (128, 8)])
@pytest.mark.parametrize("t", [8, 32])
@pytest.mark.parametrize("pos", [4080, 6000])
def test_k3_with_splits_matches_plain(cuda, hd, g, t, pos):
    """K3 over an 8192-row view with the visible range cut into several
    splits and combined: within K3's 1e-2 of the plain version."""
    n_kv = 2
    q = torch.randn((1, t, n_kv * g, hd), generator=torch.Generator().manual_seed(pos + t)).to(cuda)
    k, v = _long_cache(cuda, hd, 8192, n_kv, seed=hd + pos)
    assert cuda_attention.plan_for(q, k).splits > 1
    before = cuda_attention.flash_attention.launches
    got = cuda_attention.flash_attention(q, k, v, pos)
    want = cuda_attention.flash_attention_plain(q, k, v, pos)
    torch.cuda.synchronize()
    assert cuda_attention.flash_attention.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-2


@pytest.mark.parametrize("hd,g", [(64, 4), (128, 8)])
def test_k3_device_row_reads_the_row_in_place(cuda, hd, g):
    """K3 at a device position and a device row of a 16-row cache equals
    K3 on a view of that row bit for bit (the same bytes, the same
    one-row plan); a row outside the cache gives NaN."""
    n_kv, t, S = 2, 32, 1024
    gen = torch.Generator().manual_seed(hd)
    cache = torch.randn((2, 16, S + 128, n_kv, hd), generator=gen).to(torch.bfloat16).to(cuda)
    k, v = cache[0, :, :S], cache[1, :, :S]
    q = torch.randn((1, t, n_kv * g, hd), generator=gen).to(cuda)
    pos = torch.tensor(300, device=cuda)
    for r in (0, 5, 15):
        row = torch.tensor([r], device=cuda)
        got = cuda_attention.flash_attention(q, k, v, pos, row=row)
        want = cuda_attention.flash_attention(q, k[r:r + 1], v[r:r + 1], pos)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    bad = cuda_attention.flash_attention(q, k, v, pos, row=torch.tensor([16], device=cuda))
    torch.cuda.synchronize()
    assert bad.isnan().all()


@pytest.mark.parametrize("hd,g", [(64, 4), (128, 8)])
@pytest.mark.parametrize("t", [8, 32])
@pytest.mark.parametrize("pos", [4080, 6000])
@pytest.mark.parametrize("col", [0, 4096, 8192])
def test_b8_with_splits_matches_plain(cuda, hd, g, t, pos, col):
    """B8 on the 4096-row shard at col of a 12288-row cache: several
    splits where the shard is visible, one straddling tile, or nothing
    (the shard wholly in the chunk's future), each within `_b8_check`."""
    n_kv, S = 2, 4096
    q = torch.randn((1, t, n_kv * g, hd), generator=torch.Generator().manual_seed(pos + t + col)).to(cuda)
    k, v = _long_cache(cuda, hd, 3 * S, n_kv, seed=hd + pos + col)
    ks, vs = k[:, col:col + S], v[:, col:col + S]
    plan = cuda_attention.plan_for(q, ks)
    if col == 0:
        assert plan.splits > 1
    o, m, l = cuda_attention.flash_attention_partial(q, ks, vs, pos, col)
    po, pm, pl = cuda_attention.flash_attention_partial_plain(q, ks, vs, pos, col)
    torch.cuda.synchronize()
    seen = _b8_check(o, m, l, po, pm, pl)
    if pos + t - 1 < col:
        assert not seen.any()


@pytest.mark.parametrize("hd,g", [(64, 4), (128, 8)])
@pytest.mark.parametrize("pos", [40, 1000, 4064, 6000, 16352])
def test_sp_combine_with_splits_matches_k3(cuda, hd, g, pos):
    """The four-shard combine of B8's triples over a 16384-row cache
    against K3 over all of it, within `_b8_bound` of K3's output; bit for
    bit with K3 over a view of shard 0's length while the chunk lies inside
    shard 0, whose splits are that view's (the plan is the shapes' alone)
    and whose factor is exactly 1 while the other shards add exact
    zeros."""
    n_kv, sp, t = 2, 4, 32
    S = 16384
    local = S // sp
    q = torch.randn((1, t, n_kv * g, hd), generator=torch.Generator().manual_seed(pos)).to(cuda)
    k, v = _long_cache(cuda, hd, S, n_kv, seed=hd + pos)
    got = ops_attention.flash_attention_sp(
        q, [k[:, i * local:(i + 1) * local] for i in range(sp)],
        [v[:, i * local:(i + 1) * local] for i in range(sp)], pos, [i * local for i in range(sp)])
    want = cuda_attention.flash_attention(q, k, v, pos)
    torch.cuda.synchronize()
    if pos + t <= local:
        view = cuda_attention.flash_attention(q, k[:, :local], v[:, :local], pos)
        torch.cuda.synchronize()
        assert torch.equal(got, view)
    assert (got - want).abs().max().item() <= _b8_bound(want)


# -- graphed decode (runtime/graphs.py): CUDA-graph replays against eager --

GRAPH_PROMPT = [(7 * i) % 500 + 1 for i in range(230)]


@pytest.fixture(scope="module")
def graph_model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("graphs") / "m.m")
    write_tiny_model(path, tiny_header(dim=256, hidden_dim=512, n_layers=2, n_heads=4,
                                       n_kv_heads=2, vocab_size=512, seq_len=1024), seed=8)
    return path


def _graph_runs(eng):
    from distributed_llama_tpu_torch.tokenizer import Sampler

    out = []
    for graphs in (False, True):
        eng.cuda_graphs = graphs
        eng.reset()
        greedy = eng.generate(GRAPH_PROMPT, len(GRAPH_PROMPT) + 60).tokens
        g_logits = eng.last_logits.clone()
        eng.reset()
        sampled = eng.generate(GRAPH_PROMPT[:50], 90, sampler=Sampler(512, 0.8, 0.9, 7)).tokens
        s_logits = eng.last_logits.clone()
        eng.reset()
        full = eng.generate(GRAPH_PROMPT[:50], 90, sampler=Sampler(512, 0.8, 1.0, 8)).tokens
        out.append((greedy, g_logits, sampled, s_logits, full, eng.last_logits.clone()))
    return out


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_graphed_decode_equals_eager(cuda, graph_model, layout, kv_dtype, batch):
    eng = InferenceEngine(graph_model, device="cuda", decode_chunk_size=16, batch=batch,
                          kv_layout=layout, cache_dtype=kv_dtype)
    eager, graphed = _graph_runs(eng)
    assert graphed[0] == eager[0] and graphed[2] == eager[2] and graphed[4] == eager[4]
    assert all(torch.equal(graphed[i], eager[i]) for i in (1, 3, 5))
    # kv 256 and 512 greedy, 256 top-p and 256 full distribution
    assert sum(k.kind == "decode" for k in eng._graphs.graphs) == 4


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_graphed_batch_session_equals_eager(cuda, graph_model, layout):
    from distributed_llama_tpu_torch.runtime.batch_session import BatchSession

    eng = InferenceEngine(graph_model, device="cuda", batch=4, kv_layout=layout,
                          cache_dtype="int8")
    out = []
    for graphs in (False, True):
        eng.cuda_graphs = graphs
        s = BatchSession(eng)
        for r in range(4):
            s.admit(r, GRAPH_PROMPT[: 20 + 30 * r], temperature=0.7 if r % 2 else 0.0, seed=r)
        toks = [s.step(8) for _ in range(5)]
        s.release(1)
        s.admit(1, GRAPH_PROMPT[:77])
        toks += [s.step(8) for _ in range(5)]
        out.append((np.concatenate(toks, axis=1), eng.last_logits.clone()))
    assert np.array_equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def test_graphed_launch_counts_equal_eager(cuda, graph_model):
    """A replay adds the launches its capture took back: the counters count
    what ran, as on the eager path."""
    eng = InferenceEngine(graph_model, device="cuda", decode_chunk_size=16)
    counted = (*cuda_q40.KERNELS, *cuda_attention.KERNELS)
    got = []
    for graphs in (False, True):
        eng.cuda_graphs = graphs
        eng.reset()
        eng.prefill(GRAPH_PROMPT[:-1])
        torch.cuda.synchronize()
        for k in counted:
            k.launches = 0
        tok = torch.tensor([GRAPH_PROMPT[-1]], device="cuda")
        eng._decode_chunk(tok, len(GRAPH_PROMPT) - 1, 16)
        eng._decode_chunk(tok, len(GRAPH_PROMPT) - 1, 16)
        torch.cuda.synchronize()
        got.append({k.__name__: k.launches for k in counted})
    assert got[0] == got[1] and got[0]["q40_gemv_q80_stacked"] > 0


def test_no_recapture_after_warmup(cuda, graph_model):
    from distributed_llama_tpu_torch.runtime.batch_session import BatchSession

    eng = InferenceEngine(graph_model, device="cuda", batch=4, kv_layout="paged",
                          cache_dtype="int8", max_seq_len=1024)
    stats = eng.warmup()
    n_prefill = sum(k[0] in ("prefill", "prefill_row") for k in eng.warm_plan())
    assert stats["captures"] == 2 * 3 * len(eng._kv_buckets()) + n_prefill and stats["sealed"]
    assert stats["pool_bytes"] > 0
    eng.generate(GRAPH_PROMPT, len(GRAPH_PROMPT) + 60, on_token=lambda t: None)
    s = BatchSession(eng)
    s.admit(0, GRAPH_PROMPT[:100], temperature=0.5)
    s.step(8)
    s.step(64)
    s.release(0)
    assert eng.graph_stats()["recaptures_after_warmup"] == 0


# -- the prefix cache (runtime/prefix_cache.py) with graphed decode --------

PREFIX_HEAD = GRAPH_PROMPT[:150]
PREFIX_PROMPTS = (GRAPH_PROMPT[:200], GRAPH_PROMPT[:200],
                  PREFIX_HEAD + [(11 * i) % 500 + 3 for i in range(50)])


def _prefix_runs(eng, n_new=32):
    """Each PREFIX_PROMPTS request from a reset: tokens, hit tokens and the
    last decode step's logits."""
    out = []
    for prompt in PREFIX_PROMPTS:
        eng.reset()
        toks = eng.generate(prompt, len(prompt) + n_new).tokens
        out.append((toks, eng.last_prefix_hit_tokens, eng.last_logits.clone()))
    return out


@pytest.mark.parametrize("layout,kv_dtype", [("contiguous", None), ("paged", None),
                                             ("paged", "int8")])
def test_prefix_hit_equals_cold_with_graphed_decode(cuda, graph_model, layout, kv_dtype):
    """bf16 on the card, decode graphed: the first request publishes 231
    tokens as a 128-token entry; the same prompt and a prompt sharing its
    first 150 tokens hit it at 128, a multiple of max_chunk, so the resumed
    prefill takes the cold run's chunks from there and K2, K3 and K5 see the
    cold run's shapes. Tokens and last logits equal the cold engine's bit
    for bit."""
    kw = dict(device="cuda", decode_chunk_size=16, kv_layout=layout, cache_dtype=kv_dtype)
    got = _prefix_runs(InferenceEngine(graph_model, prefix_cache_mb=64, **kw))
    want = _prefix_runs(InferenceEngine(graph_model, **kw))
    assert [g[1] for g in got] == [0, 128, 128] and [w[1] for w in want] == [0, 0, 0]
    for g, w in zip(got, want):
        assert g[0] == w[0] and torch.equal(g[2], w[2])


def test_no_recapture_after_warmup_across_prefix_hits(cuda, graph_model):
    """warmup(), then cold, hit and partial-hit requests and a BatchSession
    admission that hits: 0 captures after warmup, and the hits equal the
    cold engine's tokens."""
    from distributed_llama_tpu_torch.runtime.batch_session import BatchSession

    kw = dict(device="cuda", decode_chunk_size=16, kv_layout="paged", cache_dtype="int8")

    def session_row(eng):
        s = BatchSession(eng)
        s.admit(1, PREFIX_PROMPTS[2])
        row = np.concatenate([s.step(16)[1] for _ in range(2)]).tolist()
        s.release(1)
        return row

    eng = InferenceEngine(graph_model, batch=2, prefix_cache_mb=64, **kw)
    eng.warmup()
    assert eng.prefix_cache.n_entries == 0
    got = _prefix_runs(eng), session_row(eng)
    assert eng.prefix_cache.counters["prefix_hits"] == 3
    assert eng.graph_stats()["recaptures_after_warmup"] == 0
    cold = InferenceEngine(graph_model, batch=2, **kw)
    want = _prefix_runs(cold), session_row(cold)
    assert [g[0] for g in got[0]] == [w[0] for w in want[0]] and got[1] == want[1]
