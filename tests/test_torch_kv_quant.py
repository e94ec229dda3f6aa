"""The int8 KV cache: the port's `ops/kv_quant.py` against the JAX
package's, bit for bit, and the laws `tests/test_kv_quant.py` pins there
(zero vectors exact, idempotent requantization, half-to-even rounding);
the config, cache and pool sizing that carry the int8 arm."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.config import config_from_header as j_config
from distributed_llama_tpu.ops import kv_quant as jkv
from distributed_llama_tpu.runtime import paged_kv as jpaged
from distributed_llama_tpu_torch.models import config_from_header, init_kv_cache
from distributed_llama_tpu_torch.ops import kv_quant as pkv
from distributed_llama_tpu_torch.runtime import paged_kv as ppaged
from distributed_llama_tpu_torch.testing import tiny_header

torch.set_num_threads(1)


def _bf16(a: np.ndarray) -> tuple:
    """The same bf16 values on both sides (JAX rounds, torch takes its bits)."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    bits = np.asarray(j).view(np.int16)
    return j, torch.from_numpy(bits.copy()).view(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 7, 64), (2, 16, 4, 128), (3, 1)])
def test_quantize_matches_jax_bit_for_bit(dtype, shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * rng.choice([1e-3, 1.0, 40.0], size=shape[:-1] + (1,)))
    x = x.astype(np.float32)
    if dtype == "bfloat16":
        jx, px = _bf16(x)
    else:
        jx, px = jnp.asarray(x), torch.from_numpy(x)
    jq, js = jkv.quantize_kv(jx)
    pq, ps = pkv.quantize_kv(px)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32 and ps.shape == px.shape[:-1]
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    for out in ("float32", "bfloat16"):
        want = np.asarray(jkv.dequantize_kv(jq, js, jnp.dtype(out))).astype(np.float32)
        got = pkv.dequantize_kv(pq, ps, getattr(torch, out)).to(torch.float32).numpy()
        np.testing.assert_array_equal(got, want)


def test_zero_vectors_stay_exact():
    q, s = pkv.quantize_kv(torch.zeros((3, 16)))
    assert (q == 0).all()
    assert torch.allclose(s, torch.full((3,), pkv.KV_SCALE_FLOOR))
    assert (pkv.dequantize_kv(q, s) == 0).all()
    assert pkv.KV_SCALE_FLOOR == jkv.KV_SCALE_FLOOR


def test_roundtrip_bound_and_idempotent_requantization():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 7, 16)).astype(np.float32) * 3)
    q, s = pkv.quantize_kv(x)
    # symmetric absmax: each element within half a step of its row's scale
    assert ((pkv.dequantize_kv(q, s) - x).abs() <= s[..., None] * 0.5 + 1e-7).all()
    q2, s2 = pkv.quantize_kv(pkv.dequantize_kv(q, s))
    assert torch.equal(q2, q)
    assert torch.allclose(s2, s, rtol=1e-6)


def test_rounding_is_half_to_even():
    # scale = 127 / 127 = 1: x / scale lands exactly on the .5 ties
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.0]])
    q, s = pkv.quantize_kv(x)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2, 3]]
    jq, _ = jkv.quantize_kv(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_int8_config_and_cache_layout():
    h = tiny_header(n_layers=2, n_heads=4, n_kv_heads=2, dim=64, seq_len=64)
    cfg = config_from_header(h, cache_dtype="int8")
    assert cfg.kv_quantized and cfg.kv_dtype == torch.int8
    assert not config_from_header(h).kv_quantized
    c = init_kv_cache(cfg, batch=3, device="cpu")
    assert c.k.dtype == torch.int8 and c.k.shape == (2, 3, 64, 2, 16)
    assert c.k_scale.dtype == torch.float32 and c.k_scale.shape == (2, 3, 64, 2)
    assert init_kv_cache(config_from_header(h), batch=1, device="cpu").k_scale is None
    with pytest.raises(ValueError):
        config_from_header(h, cache_dtype="int4")


@pytest.mark.parametrize("cache_dtype", ["int8", "bfloat16", "float32"])
def test_pool_bytes_match_jax(cache_dtype):
    h = tiny_header(n_layers=3, n_heads=4, n_kv_heads=2, dim=128, seq_len=128)
    cfg = config_from_header(h, cache_dtype=cache_dtype)
    jcfg = j_config(h, cache_dtype=cache_dtype)
    for n_pages, ps in ((1, 16), (37, 32)):
        assert ppaged.page_pool_bytes(cfg, n_pages, ps) == jpaged.page_pool_bytes(jcfg, n_pages, ps)
    pool = ppaged.init_kv_pool(cfg, 5, 16, device="cpu")
    # five allocatable pages and the sink
    assert pool.k.shape == (3, 6, 16, 2, 32)
    stored = sum(t.numel() * t.element_size() for t in pool.tensors())
    assert stored == ppaged.page_pool_bytes(cfg, 6, 16)


def test_kv_dtype_resolver_matches_jax(monkeypatch):
    monkeypatch.delenv("DLT_KV_DTYPE", raising=False)
    for v in (None, "int8", "bf16", "BFLOAT16", "float32"):
        assert ppaged.resolve_kv_dtype(v) == jpaged.resolve_kv_dtype(v)
    monkeypatch.setenv("DLT_KV_DTYPE", "int8")
    assert ppaged.resolve_kv_dtype(None) == jpaged.resolve_kv_dtype(None) == "int8"
    with pytest.raises(ValueError):
        ppaged.resolve_kv_dtype("int4")
