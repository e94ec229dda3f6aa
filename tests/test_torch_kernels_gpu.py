"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. These tests import neither jax nor the JAX package, so they also run
where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Without a CUDA device every test skips (the fixture decides, at run time).
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40
from distributed_llama_tpu_torch.ops.quant import pack_q

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


def test_wrappers_raise_instead_of_falling_back(cuda):
    q, d = (t.to(cuda) for t in _weights(256, 384, layers=1))
    with pytest.raises(NotImplementedError, match="B5"):
        cuda_q40.q40_gemm_bf16(_x(16, 256).to(cuda), q[0], d[0])
    with pytest.raises(ValueError):
        cuda_q40.q40_gemv_q80_stacked(_x(9, 256).to(cuda), q, d, 0)


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
