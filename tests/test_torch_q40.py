"""The Q40 matmuls: the port's plain versions of K1 (Q80 x Q40 integer dot)
and K2 (bf16-dequant GEMM) against the JAX package's Pallas kernels run with
interpret=True, and the f32 arm against `_quant_matmul_xla`. The CUDA
kernels against these plain versions: tests/test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops import pallas_q40 as jp
from distributed_llama_tpu.ops import quant as jquant
from distributed_llama_tpu_torch.ops import cuda_q40
from distributed_llama_tpu_torch.ops import quant as pquant

# tiny shapes: torch's intra-op threads would only contend with the JAX
# tests that share the CPU under pytest-xdist
torch.set_num_threads(1)

IN = 256  # nb = 8: passes the stacked kernels' nb % 8 gate
OUT = 384  # lane-aligned, not a power of two
L = 2


def _weights(seed=0, in_f=IN, out_f=OUT, layers=L):
    """Random T-layout weights from the file codec's values (numpy)."""
    rng = np.random.default_rng(seed)
    nb = in_f // 32
    qt = rng.integers(-8, 8, size=(layers, nb, 32, out_f)).astype(np.int8)
    dt = (rng.random((layers, nb, out_f)) * 0.02 + 0.001).astype(np.float16)
    return jquant.pack_q(qt), dt


def _x(rows, seed=1, in_f=IN):
    return np.random.default_rng(seed).standard_normal((rows, in_f)).astype(np.float32)


def _k1_tol(want: np.ndarray) -> float:
    # integer partials are exact on both sides; only the order of the nb = 8
    # f32 block sums differs: a few ulp of the output scale
    return 1e-5 * float(np.abs(want).max())


@pytest.mark.parametrize("rows", range(1, 9))
def test_k1_plain_matches_pallas_stacked_i8(rows):
    q, d = _weights()
    x = _x(rows)
    want = np.asarray(jp.q40_matmul_pallas_stacked_i8(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(d), jnp.int32(1), interpret=True))
    got = cuda_q40.q40_gemv_q80_stacked(
        torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(d), 1).numpy()
    assert got.shape == (rows, OUT)
    np.testing.assert_allclose(got, want, rtol=0, atol=_k1_tol(want))


@pytest.mark.parametrize("rows", range(1, 9))
def test_k1_plain_matches_pallas_unstacked_i8(rows):
    q, d = _weights(seed=2, layers=1)
    x = _x(rows, seed=3)
    want = np.asarray(jp.q40_matmul_pallas_i8(
        jnp.asarray(x), jnp.asarray(q[0]), jnp.asarray(d[0]), interpret=True))
    got = cuda_q40.q40_gemv_q80(torch.from_numpy(x), torch.from_numpy(q[0]), torch.from_numpy(d[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_k1_tol(want))


def test_k1_quantization_is_the_pallas_prologue():
    """x * (1/scale), half-to-even rounding, the f16-rounded scale and the
    block sums: exactly `_quantize_rows_q80_split`."""
    x = _x(3, seed=4)
    x[0, :32] = 0.0  # an all-zero block: scale 0, inverse 0
    x[1, 5] = 2.5 * np.abs(x[1, :32]).max()  # a dominant value
    nb = IN // 32
    x8a, x8b, xs, bs = jp._quantize_rows_q80_split(jnp.asarray(x), nb)
    x8, scale, bsum = cuda_q40.quantize_rows_q80(torch.from_numpy(x), nb)
    x8 = x8.numpy()
    np.testing.assert_array_equal(x8[:, :, :16].reshape(3, -1), np.asarray(x8a))
    np.testing.assert_array_equal(x8[:, :, 16:].reshape(3, -1), np.asarray(x8b))
    np.testing.assert_array_equal(scale.numpy().T, np.asarray(xs)[:, ::128])
    np.testing.assert_array_equal(bsum.numpy().T, np.asarray(bs)[:, ::128])


@pytest.mark.parametrize("rows", [16, 32])
def test_k2_plain_matches_pallas_stacked(rows):
    q, d = _weights(seed=5)
    x = _x(rows, seed=6)
    want = np.asarray(jp.q40_matmul_pallas_stacked(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(d), jnp.int32(1), interpret=True))
    got = cuda_q40.q40_gemm_bf16_stacked(
        torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(d), 1).numpy()
    # bf16 operands, exact products, f32 sums over in = 256 in another order
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla_arm_matches_quant_matmul_xla(dtype):
    q, d = _weights(seed=7, layers=1)
    x = _x(5, seed=8)
    want = np.asarray(jquant._quant_matmul_xla(
        jnp.asarray(x), jnp.asarray(q[0]), jnp.asarray(d[0]), jnp.dtype(dtype)))
    got = pquant._quant_matmul_xla(
        torch.from_numpy(x), torch.from_numpy(q[0]), torch.from_numpy(d[0]), getattr(torch, dtype))
    # f32: exact products, f32 re-association over 256 terms
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows,layer", [(1, 0), (6, 1), (12, 1), (1, None), (24, None)])
def test_quant_matmul_takes_the_same_arm_as_jax(rows, layer):
    """quant_matmul keeps the JAX dispatch predicates: <= 8 bf16 rows take
    the integer-dot arm, more rows the bf16-dequant arm, stacked or not."""
    q, d = _weights(seed=9)
    x = _x(rows, seed=10)
    if layer is None:
        jw = jquant.QuantTensor(q=jnp.asarray(q[0]), d=jnp.asarray(d[0]))
        pw = pquant.QuantTensor(q=torch.from_numpy(q[0]), d=torch.from_numpy(d[0]))
        want = jquant.quant_matmul(jnp.asarray(x), jw, dtype=jnp.bfloat16, pallas="interpret")
    else:
        jw = jquant.QuantTensor(q=jnp.asarray(q), d=jnp.asarray(d))
        pw = pquant.QuantTensor(q=torch.from_numpy(q), d=torch.from_numpy(d))
        want = jquant.quant_matmul(
            jnp.asarray(x), jw, dtype=jnp.bfloat16, pallas="interpret", layer=jnp.int32(layer))
    got = pquant.quant_matmul(torch.from_numpy(x), pw, dtype=torch.bfloat16, layer=layer)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def test_unpack_and_dequant_match_jax():
    q, d = _weights(seed=11, layers=1)
    np.testing.assert_array_equal(
        pquant.unpack_q(torch.from_numpy(q)).numpy(), np.asarray(jquant.unpack_q(jnp.asarray(q))))
    want = np.asarray(jquant.dequantize_t(jquant.QuantTensor(q=jnp.asarray(q[0]), d=jnp.asarray(d[0]))))
    got = pquant.dequantize_t(pquant.QuantTensor(q=torch.from_numpy(q[0]), d=torch.from_numpy(d[0])))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_refuse_bad_inputs():
    q, d = _weights()
    x = torch.from_numpy(_x(1))
    qt, dt = torch.from_numpy(q), torch.from_numpy(d)
    with pytest.raises(TypeError):
        cuda_q40.q40_gemv_q80_stacked(x, qt, dt.to(torch.float32), 0)
    with pytest.raises(IndexError):
        cuda_q40.q40_gemv_q80_stacked(x, qt, dt, 2)
    with pytest.raises(ValueError):
        cuda_q40.q40_gemm_bf16_stacked(x[:, :128], qt, dt, 0)
