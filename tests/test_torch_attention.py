"""Attention and the per-op glue: the port's plain flash attention (K3)
against the JAX package's Pallas `flash_attention(..., interpret=True)`, and
gqa_attention, rms_norm, both ropes and the rope tables against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops import attention as jatt
from distributed_llama_tpu.ops import norm as jnorm
from distributed_llama_tpu.ops import pallas_attention as jpa
from distributed_llama_tpu.ops import rope as jrope
from distributed_llama_tpu.testing import tiny_header as j_header
from distributed_llama_tpu_torch.ops import attention as patt
from distributed_llama_tpu_torch.ops import cuda_attention as pca
from distributed_llama_tpu_torch.ops import norm as pnorm
from distributed_llama_tpu_torch.ops import rope as prope
from distributed_llama_tpu_torch.testing import tiny_header as p_header

# tiny shapes: torch's intra-op threads would only contend with the JAX
# tests that share the CPU under pytest-xdist
torch.set_num_threads(1)

N_KV = 2


def _flash_case(t, S, g, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, t, N_KV * g, hd)).astype(np.float32)
    k = rng.standard_normal((1, S, N_KV, hd)).astype(np.float32)
    v = rng.standard_normal((1, S, N_KV, hd)).astype(np.float32)
    kb = jnp.asarray(k, jnp.bfloat16)
    vb = jnp.asarray(v, jnp.bfloat16)
    # the same bf16 cache bits on both sides
    kt = torch.from_numpy(np.array(kb.astype(jnp.float32))).to(torch.bfloat16)
    vt = torch.from_numpy(np.array(vb.astype(jnp.float32))).to(torch.bfloat16)
    return q, kb, vb, kt, vt


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("S", [256, 512])
@pytest.mark.parametrize("t", [8, 32])
def test_flash_plain_matches_pallas(t, S, g, hd):
    q, kb, vb, kt, vt = _flash_case(t, S, g, hd, seed=t + S + g + hd)
    for pos in (0, 100):
        want = np.asarray(jpa.flash_attention(jnp.asarray(q), kb, vb, jnp.int32(pos), interpret=True))
        got = pca.flash_attention(torch.from_numpy(q), kt, vt, pos)
        assert got.dtype == torch.float32 and got.shape == q.shape
        # Same blocking and the same bf16 rounding of q and P, so most rows
        # agree to f32 summation order (2e-5). But torch's exp and XLA's
        # differ in the last ulp for ~10% of inputs, and where a weight sits
        # on a bf16 rounding boundary that flips its rounding: one bf16 ulp
        # (2^-7 relative) of one weight moves its row by <= 2^-7 * |v| (5e-3
        # here, |v| <= 4.5). Such rows are rare; a wrong kernel moves all.
        d = np.abs(got.numpy() - want)
        rows_off = (d.max(axis=-1) > 2e-5).mean()
        assert rows_off <= 0.1, f"pos={pos}: {rows_off:.0%} of rows differ"
        assert d.max() <= 5e-3, f"pos={pos}: max abs err {d.max()}"


def test_flash_reads_a_strided_cache_view():
    """A [b, S, n_kv, hd] view of the stacked [L, b, S_full, ...] cache, cut
    at the kv bucket, gives the same result as a compact copy."""
    rng = np.random.default_rng(0)
    full = torch.from_numpy(rng.standard_normal((3, 2, 1024, N_KV, 64)).astype(np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((2, 16, 8, 64)).astype(np.float32))
    view = full[1, :, :256]
    assert not view.is_contiguous()
    a = pca.flash_attention(q, view, view, 40)
    b = pca.flash_attention(q, view.contiguous(), view.contiguous(), 40)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flash_gate_is_the_jax_gate():
    for t, S, nh, nkv, hd in [(8, 256, 4, 2, 64), (7, 256, 4, 2, 64), (8, 200, 4, 2, 64), (8, 256, 6, 4, 64)]:
        qj, kj = jnp.zeros((1, t, nh, hd)), jnp.zeros((1, S, nkv, hd))
        qt, kt = torch.zeros((1, t, nh, hd)), torch.zeros((1, S, nkv, hd))
        assert pca.flash_attention_aligned(qt, kt, t) == jpa.flash_attention_aligned(qj, kj, t)


@pytest.mark.parametrize("q_len,pos", [(1, 37), (5, 0), (12, 200)])
def test_gqa_attention_matches_jax(q_len, pos):
    rng = np.random.default_rng(q_len)
    q = rng.standard_normal((1, q_len, 8, 64)).astype(np.float32)
    k = rng.standard_normal((1, 256, 2, 64)).astype(np.float32)
    v = rng.standard_normal((1, 256, 2, 64)).astype(np.float32)
    positions = (pos + np.arange(q_len, dtype=np.int32))[None, :]
    want = np.asarray(jatt.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions)))
    got = patt.gqa_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(positions).long())
    # f32 throughout: softmax and einsum summation order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    want = np.asarray(jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = pnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)  # f32 mean order


_ROPES = {
    "llama": dict(rope_type=0, head_dim=64),
    "llama31_scaled": dict(rope_type=2, head_dim=64, rope_theta=500000.0, rope_scaling_factor=32.0),
    "falcon_hd128": dict(rope_type=1, head_dim=128, rope_theta=1000000.0),
}


@pytest.mark.parametrize("kind", sorted(_ROPES))
def test_rope_matches_jax(kind):
    kw = dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, seq_len=4096, **_ROPES[kind])
    jt = jrope.build_rope_tables(j_header(**kw))
    pt = prope.build_rope_tables(p_header(**kw))
    np.testing.assert_array_equal(pt.cos.numpy(), np.asarray(jt.cos))
    np.testing.assert_array_equal(pt.sin.numpy(), np.asarray(jt.sin))
    hd = kw["head_dim"]
    x = np.random.default_rng(5).standard_normal((1, 6, 4, hd)).astype(np.float32)
    positions = np.array([[0, 1, 2, 1000, 2047, 4095]], dtype=np.int32)
    rt = kw["rope_type"]
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jt, jnp.asarray(positions), rt))
    got = prope.apply_rope(torch.from_numpy(x), pt, torch.from_numpy(positions).long(), rt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)  # one f32 mul-add


def test_rope_table_is_capped_at_max_seq_len(tmp_path):
    """A Llama-3.2 header says seq_len 131072; the reader caps it at
    max_seq_len and the table follows."""
    from distributed_llama_tpu_torch.formats.mfile import MFileReader
    from distributed_llama_tpu_torch.testing import write_tiny_model

    h = p_header(dim=64, hidden_dim=128, n_layers=1, n_heads=4, n_kv_heads=2, seq_len=131072,
                 vocab_size=256)
    path = str(tmp_path / "m.m")
    write_tiny_model(path, h, seed=0)
    with MFileReader(path, max_seq_len=4096) as r:
        tables = prope.build_rope_tables(r.header)
    assert tables.cos.shape == (4096, 8)
