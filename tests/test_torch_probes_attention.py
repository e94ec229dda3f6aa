"""The decode-attention floor probes' port (probes/attention.py) against the
JAX probes on the CPU: P12's plain version against `decode_attention`
(scripts/probe_grouped_decode_att.py) and P8's against `flash_headmajor`
(scripts/probe_flash_headmajor.py), both in interpret mode, on the same
operands made with numpy; P11's against its closed form."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu_torch.ops import cuda_attention
from distributed_llama_tpu_torch.probes import attention
from scripts import probe_flash_headmajor as jflash
from scripts import probe_grouped_decode_att as jgrouped


def _bf16(a: np.ndarray):
    """One bf16 array for both sides: (jax array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _cache(b, h, kv, hd, S, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, kv, S, hd)).astype(np.float32)
    v = rng.standard_normal((b, kv, S, hd)).astype(np.float32)
    return q, _bf16(k), _bf16(v)


def _close(got: torch.Tensor, want, tol: float):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    assert np.abs(got.float().numpy() - want).max() <= tol


# (hd, g, S, pos, col0, block_s): pos in the first block, mid-block and at
# S - 1, col0 0 and > 0 (a block past pos is skipped, a ragged last block
# of visible columns is masked)
P12_CASES = [
    (64, 4, 256, 100, 0, 512),
    (128, 8, 256, 255, 0, 512),
    (64, 8, 512, 50, 0, 128),
    (128, 4, 512, 300, 0, 128),
    (64, 4, 512, 511, 0, 128),
    (128, 8, 512, 400, 96, 128),
    (64, 4, 256, 300, 64, 512),
    (128, 4, 256, 20, 64, 128),
]


@pytest.mark.parametrize("hd,g,S,pos,col0,block_s", P12_CASES)
def test_p12_plain_matches_jax_decode_attention(hd, g, S, pos, col0, block_s):
    """The plain version walks the kernel's split-S runs (32-row tiles, one
    online softmax a warp's run, merged in warp and then rank order), where
    the Pallas kernel walks block_s-row blocks in one pass: p rounds to bf16
    against other running maxima and the f32 sums run in another order. So
    the two are held in f32, on a query of bf16 values given as f32 (both
    cast it to bf16 and return f32): within one bf16 rounding (2^-8
    relative) of the largest output. A bf16 query gives, on each side,
    exactly that f32 output rounded to bf16 (both round only at the end)."""
    kv = 2
    q, (jk, tk), (jv, tv) = _cache(1, kv * g, kv, hd, S, seed=hd + g + S + pos)
    jq, tq = _bf16(q)
    want = jgrouped.decode_attention(jq.astype(jnp.float32), jk, jv, pos, col0,
                                     block_s=block_s, interpret=True)
    got = attention.decode_attention_plain(tq.float(), tk, tv, pos, col0)
    assert got.dtype == torch.float32
    tol = 2.0 ** -8 * float(np.abs(np.asarray(want)).max())
    _close(got, want, tol)
    want16 = jgrouped.decode_attention(jq, jk, jv, pos, col0, block_s=block_s, interpret=True)
    got16 = attention.decode_attention_plain(tq, tk, tv, pos, col0)
    assert got16.dtype == torch.bfloat16 and torch.equal(got16, got.to(torch.bfloat16))
    _close(torch.from_numpy(np.asarray(want)).to(torch.bfloat16), want16, 0.0)
    # the wrapper on CPU tensors: the plain version
    assert torch.equal(attention.decode_attention(tq, tk, tv, pos, col0), got16)


def test_p12_plain_takes_an_f32_query_as_jax_does():
    """An f32 query is cast to bf16 and the output stays f32. pos 20 puts
    every visible column in the plain version's first 32-row tile and in
    the Pallas kernel's one 256-row block, so both round p against the
    same max and only the f32 sums' order differs: within 1e-5 of the
    largest output. (Over many tiles the f32 query is held to 2^-8 in
    test_p12_plain_matches_jax_decode_attention.)"""
    q, (jk, tk), (jv, tv) = _cache(2, 8, 2, 64, 256, seed=3)
    want = jgrouped.decode_attention(jnp.asarray(q), jk, jv, 20, interpret=True)
    got = attention.decode_attention_plain(torch.from_numpy(q), tk, tv, 20)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5 * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("S,pos", [(256, 100), (256, 255), (512, 400)])
def test_p8_plain_matches_jax_flash_headmajor(S, pos):
    """P8's plain version is K3's on the head-major view. At S 256 its
    blocks are the JAX probe's (256 rows); at S 512 K3's plain takes one
    512-row block where the probe takes two, so p rounds to bf16 against
    another running max: one bf16 rounding of the largest output."""
    q, (jk, tk), (jv, tv) = _cache(1, 32, 8, 64, S, seed=S + pos)
    jq, tq = _bf16(q.reshape(1, 1, 32, 64))
    want = jflash.flash_headmajor(jq, jk, jv, pos, interpret=True)
    got = attention.flash_headmajor_plain(tq, tk, tv, pos)
    tol = 2.0 ** -8 * float(np.abs(np.asarray(want.astype(jnp.float32))).max())
    _close(got, want, tol)
    before = cuda_attention.flash_attention.launches
    assert torch.equal(attention.flash_headmajor(tq, tk, tv, pos), got)
    assert cuda_attention.flash_attention.launches == before


def test_p8_view_is_free():
    """K3 reads the head-major cache through the strides of its [b, S, kv,
    hd] view: no copy."""
    k = torch.zeros((2, 8, 512, 64), dtype=torch.bfloat16)
    view = attention.headmajor_view(k)
    assert view.shape == (2, 512, 8, 64) and view.data_ptr() == k.data_ptr()
    assert view.stride() == (8 * 512 * 64, 64, 512 * 64, 1)


@pytest.mark.parametrize("b,kv,S,hd", [(1, 8, 1024, 64), (2, 4, 300, 128)])
def test_p11_plain_matches_its_closed_form(b, kv, S, hd):
    """The JAX pure read is a closure inside `probe_att_floor.main` (:68),
    which cannot be imported; so the plain version is held to its closed
    form, the float64 sum over (kv head, s) of K + V, within 1e-6 of the
    column's sum of magnitudes (f32 sums of bf16 values)."""
    _, (_, tk), (_, tv) = _cache(b, kv, kv, hd, S, seed=S)
    k64, v64 = tk.double().numpy(), tv.double().numpy()
    want = (k64.sum(axis=(1, 2)) + v64.sum(axis=(1, 2)))[:, None, :]
    mag = (np.abs(k64).sum(axis=(1, 2)) + np.abs(v64).sum(axis=(1, 2)))[:, None, :]
    got = attention.pure_read_plain(tk, tv)
    assert got.shape == (b, 1, hd) and got.dtype == torch.float32
    assert (np.abs(got.double().numpy() - want) <= 1e-6 * mag).all()
    assert torch.equal(attention.pure_read(tk, tv), attention.pure_read_order_plain(tk, tv))


@pytest.mark.parametrize("b,kv,S,hd", [(1, 8, 1024, 64), (2, 4, 300, 128), (4, 8, 1024, 64),
                                       (3, 2, 37, 64), (16, 8, 512, 128)])
def test_p11_order_plain_matches_its_closed_form(b, kv, S, hd):
    """The kernel's order (per-thread strides, the CTA's reduction, the
    merge) at its plan and at other split counts: within 1e-6 of the
    column's sum of magnitudes of the float64 closed form."""
    _, (_, tk), (_, tv) = _cache(b, kv, kv, hd, S, seed=S + b)
    k64, v64 = tk.double().numpy(), tv.double().numpy()
    want = (k64.sum(axis=(1, 2)) + v64.sum(axis=(1, 2)))[:, None, :]
    mag = (np.abs(k64).sum(axis=(1, 2)) + np.abs(v64).sum(axis=(1, 2)))[:, None, :]
    plans = {attention.read_plan(b, kv, S, hd)}
    plans |= {attention.read_plan(b, kv, S, hd, splits) for splits in (1, 3, 16)}
    for plan in plans:
        got = attention.pure_read_order_plain(tk, tv, plan)
        assert got.shape == (b, 1, hd) and got.dtype == torch.float32
        assert (np.abs(got.double().numpy() - want) <= 1e-6 * mag).all(), plan


def test_wrappers_take_the_plain_version_on_the_cpu_and_count_nothing():
    q, k, v = attention.make_operands(1, 8, 2, 64, 128, "cpu")
    counts = [k_.launches for k_ in (*attention.KERNELS, cuda_attention.flash_attention)]
    assert torch.equal(attention.pure_read(k, v), attention.pure_read_order_plain(k, v))
    assert torch.equal(attention.decode_attention(q, k, v, 100),
                       attention.decode_attention_plain(q, k, v, 100))
    q4 = q.reshape(1, 1, 8, 64)
    assert torch.equal(attention.flash_headmajor(q4, k, v, 100),
                       attention.flash_headmajor_plain(q4, k, v, 100))
    assert counts == [k_.launches for k_ in (*attention.KERNELS, cuda_attention.flash_attention)]


def test_wrappers_check_their_operands():
    q, k, v = attention.make_operands(1, 8, 2, 64, 128, "cpu")
    with pytest.raises(TypeError):
        attention.pure_read(k.float(), v.float())
    with pytest.raises(ValueError):
        attention.pure_read(k, v[:, :, :64])
    with pytest.raises(ValueError):  # 5 query heads over 2 kv heads
        attention.decode_attention(q[:, :5].contiguous(), k, v, 10)
    with pytest.raises(TypeError):
        attention.decode_attention(q.half(), k, v, 10)


@pytest.mark.parametrize("b,n_kv,S", [(1, 8, 1024), (1, 8, 32768), (16, 8, 2048), (1, 2, 40)])
def test_splits_are_a_function_of_the_shape(b, n_kv, S):
    """P12's plan reads (S, hd) only: its C <= 16 CTAs a (row, kv head)
    cover S once in whole units of its warps' tiles, none past S; b and
    n_kv only count the clusters (b * n_kv). P11's plan covers the row's
    cache once in whole iterations of a CTA."""
    for hd in attention.HEAD_DIMS:
        plan = attention.attention_plan(S, hd)
        assert 1 <= plan.cluster <= attention.ATT_MAX_CLUSTER
        assert plan.width % (plan.warps * plan.tile) == 0
        assert plan.cluster * plan.width >= S > (plan.cluster - 1) * plan.width
        assert (plan.warps, plan.tile, plan.stages) == attention.ATT_VARIANT[hd][1:]
    assert b * n_kv * plan.cluster <= b * n_kv * attention.ATT_MAX_CLUSTER
    r = attention.read_plan(b, n_kv, S, 64)
    assert r.splits * r.chunk >= n_kv * S > (r.splits - 1) * r.chunk
    assert r == attention.read_plan(b, n_kv, S, 64)


def test_attention_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):  # the card, unless told the CPU
        attention.main(["--seq", "256"])
    rows = attention.main(["--device", "cpu", "--seq", "256", "--seed", "1"])
    assert [r["probe"] for r in rows] == ["pure_read", "decode_attention", "flash_headmajor",
                                          "control K1"]
    assert all(r["max_abs_err"] == 0.0 for r in rows)
    assert rows[1]["p12_vs_p8"] <= 1e-2 and rows[1]["pos"] == 246
    assert rows[0]["bytes"] == 2 * 256 * 8 * 64 * 2 + 64 * 4
    assert rows[1]["bytes"] == 2 * 247 * 8 * 64 * 2 + 2 * 32 * 64 * 2
    assert rows[3]["in"] == 2048 and rows[3]["out"] == 512
    out = capsys.readouterr().out
    assert "not measured" in out and "b 1, h 32, kv 8, hd 64" in out
