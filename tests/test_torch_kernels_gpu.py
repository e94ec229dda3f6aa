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
