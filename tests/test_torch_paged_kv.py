"""The paged KV layout: the port's `runtime/paged_kv.py` host allocator
against the JAX package's, call for call; `copy_page`; K5's plain version
(`paged_flash_attention_plain`, B6) against the JAX package's
`paged_flash_attention` in interpret mode; the port's paged engine against
its own contiguous engine and against the JAX package's paged int8 engine.

Tolerances. The B6 plain version repeats the Pallas kernel's page walk in
f32: f32 q agrees to f32 summation order (1e-5 of the output scale), bf16
q to one bf16 rounding of the output (its ulp at the output scale). Paged
and contiguous in the port read the same values through another index
map, so f32 logits agree to 1e-6 and greedy tokens are equal. The port's
paged int8 engine against JAX's: f32 within 1e-4 (the port's f32 arm
gathers and dequantizes where JAX's interpret mode runs the fused kernel:
another summation order); bf16 within 5% of the logits' scale, the
near-tie bound of tests/test_torch_engine.py, with tokens equal on a
pinned model seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.formats.mfile import ArchType
from distributed_llama_tpu.models.config import config_from_header as j_config
from distributed_llama_tpu.models.params import KVCache as JCache
from distributed_llama_tpu.ops.pallas_attention import paged_flash_attention as j_paged
from distributed_llama_tpu.runtime import paged_kv as jpaged
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu.testing import tiny_header, write_tiny_model
from distributed_llama_tpu_torch.models import config_from_header
from distributed_llama_tpu_torch.ops import cuda_attention as ca
from distributed_llama_tpu_torch.runtime import paged_kv as ppaged
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine

torch.set_num_threads(1)

_ARCHS = {
    "llama": dict(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                  vocab_size=512, seq_len=512),
    "qwen3": dict(arch=ArchType.QWEN3, dim=256, hidden_dim=512, n_layers=2, n_heads=4,
                  n_kv_heads=2, head_dim=64, vocab_size=512, seq_len=512),
}
PROMPT = [(7 * i) % 500 + 1 for i in range(60)]


@pytest.fixture(scope="module", params=sorted(_ARCHS))
def model(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp(request.param) / "m.m")
    write_tiny_model(path, tiny_header(**_ARCHS[request.param]), seed=8)
    return path


# -- the host allocator --------------------------------------------------------


def _pool_state(pool):
    return pool.tables.copy(), pool.refs.copy(), pool.free_pages, pool.version


def _random_ops(rng, n_rows, max_slots, ps, n):
    ops = []
    for _ in range(n):
        kind = rng.choice(["ensure", "ensure", "ensure", "share", "release_row"])
        row = int(rng.integers(n_rows))
        if kind == "ensure":
            start = int(rng.integers(max_slots * ps))
            ops.append(("ensure", row, start, start + int(rng.integers(1, 3 * ps))))
        elif kind == "share":
            ops.append(("share", row, int(rng.integers(n_rows)), int(rng.integers(1, 4))))
        else:
            ops.append((kind, row))
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_pool_follows_jax_call_for_call(seed):
    """Random ensure / share / release_row sequences on both pools: equal
    tables, refcounts, free counts and copy-on-write plans after every
    call, and exhaustion at the same call."""
    rng = np.random.default_rng(seed)
    n_pages, ps, n_rows, seq_len = 12, 16, 3, 128
    jp = jpaged.PagePool(n_pages, ps, n_rows, seq_len)
    pp = ppaged.PagePool(n_pages, ps, n_rows, seq_len)
    exhausted = 0
    for op in _random_ops(rng, n_rows, pp.max_slots, ps, 60):
        if op[0] == "ensure":
            outs = []
            for pool, exc in ((jp, jpaged.PagePoolExhausted), (pp, ppaged.PagePoolExhausted)):
                try:
                    outs.append(pool.ensure(*op[1:]))
                except exc:
                    outs.append("exhausted")
            assert outs[0] == outs[1], op
            exhausted += outs[0] == "exhausted"
        elif op[0] == "share":
            _, row, src, n = op
            pages = [int(p) for p in pp.tables[src, :n] if p >= 0]
            jp.share(row, pages)
            pp.share(row, pages)
        else:
            jp.release_row(op[1])
            pp.release_row(op[1])
        for a, b in zip(_pool_state(jp), _pool_state(pp)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jp.device_tables(), pp.device_tables())
    assert pp.free_pages == jp.free_pages and pp.used_pages == jp.used_pages
    assert exhausted > 0 or seed != 0  # seed 0 reaches exhaustion


def test_pool_cow_plan_and_release():
    """tests/test_paged_kv.py's share / copy-on-write case on the port's pool."""
    pool = ppaged.PagePool(n_pages=8, page_size=16, n_rows=2, seq_len=128)
    assert pool.ensure(0, 0, 64) == []
    pages = [int(p) for p in pool.tables[0, :4]]
    pool.share(1, pages[:2])
    assert [int(pool.refs[p]) for p in pages] == [2, 2, 1, 1]
    assert pool.ensure(1, 0, 16) == []  # page-aligned: remap, no copy
    cows = pool.ensure(1, 24, 32)  # mid-page over a shared page: a copy
    assert len(cows) == 1 and cows[0][0] == pages[1]
    assert [int(p) for p in pool.tables[0, :4]] == pages
    assert [int(pool.refs[p]) for p in pages] == [1, 1, 1, 1]
    pool.release_row(0), pool.release_row(1)
    assert pool.used_pages == 0
    pool.ensure(0, 0, 128 + 16)  # the span clamps at seq_len: all 8 pages
    with pytest.raises(ppaged.PagePoolExhausted):
        pool.ensure(1, 0, 16)


def test_resolvers_match_jax(monkeypatch):
    for name in ("DLT_KV_LAYOUT", "DLT_KV_PAGE", "DLT_KV_POOL_MB"):
        monkeypatch.delenv(name, raising=False)
    assert ppaged.resolve_kv_layout(None) == jpaged.resolve_kv_layout(None) == "contiguous"
    assert ppaged.resolve_kv_layout(None, default="paged") == "paged"
    monkeypatch.setenv("DLT_KV_LAYOUT", "paged")
    assert ppaged.resolve_kv_layout(None) == jpaged.resolve_kv_layout(None) == "paged"
    assert ppaged.resolve_kv_layout("contiguous") == "contiguous"
    with pytest.raises(ValueError):
        ppaged.resolve_kv_layout("strided")
    for v in (None, 8, 64):
        assert ppaged.resolve_page_size(v) == jpaged.resolve_page_size(v)
    with pytest.raises(ValueError):
        ppaged.resolve_page_size(24)
    monkeypatch.setenv("DLT_KV_POOL_MB", "3")
    for mb in (None, 0, 2):
        assert ppaged.resolve_pool_pages(mb, 65536, 100) == jpaged.resolve_pool_pages(mb, 65536, 100)


@pytest.mark.parametrize("cache_dtype", ["int8", "bfloat16"])
def test_copy_page_matches_jax(cache_dtype):
    h = tiny_header(n_layers=2, n_heads=4, n_kv_heads=2, dim=64, seq_len=64)
    jcfg, cfg = j_config(h, cache_dtype=cache_dtype), config_from_header(h, cache_dtype=cache_dtype)
    rng = np.random.default_rng(5)
    n_pages, ps = 6, 16
    pool = ppaged.init_kv_pool(cfg, n_pages, ps, device="cpu")
    for t in pool.tensors():
        t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32) * 50))
    arrays = {k: getattr(pool, k) for k in ("k", "v", "k_scale", "v_scale")
              if getattr(pool, k) is not None}

    def to_jax(t):  # the allocatable pages, without the sink
        a = t[:, :n_pages].to(torch.float32).numpy()
        return jnp.asarray(a).astype(jnp.dtype(cache_dtype) if t.dtype != torch.float32 else jnp.float32)

    jc = JCache(**{k: to_jax(t) for k, t in arrays.items()})
    jc = jpaged.copy_page(jc, jnp.int32(4), jnp.int32(1))
    ppaged.copy_page(pool, 4, 1)
    for name, t in arrays.items():
        np.testing.assert_array_equal(
            t[:, :n_pages].to(torch.float32).numpy(), np.asarray(getattr(jc, name)).astype(np.float32))
    assert jcfg.kv_quantized == cfg.kv_quantized


# -- B6: K5's plain version against the Pallas kernel -------------------------


def _paged_inputs(rng, t, hd, g, n_kv=2, b=3, n_read=4, ps=16, L=2, layer=1, seq_len=256):
    """A garbage-filled int8 pool whose mapped pages hold quantized K/V,
    tables that permute pool pages, row 0 live, row 1 parked at seq_len,
    row 2 live with -1 entries past its causal limit."""
    P = b * n_read + 3
    kp = rng.integers(-127, 128, (L, P, ps, n_kv, hd)).astype(np.int8)
    vp = rng.integers(-127, 128, (L, P, ps, n_kv, hd)).astype(np.int8)
    ks = (rng.random((L, P, ps, n_kv)) * 0.05 + 1e-3).astype(np.float32)
    vs = (rng.random((L, P, ps, n_kv)) * 0.05 + 1e-3).astype(np.float32)
    tables = rng.permutation(P)[: b * n_read].reshape(b, n_read).astype(np.int32)
    pos = np.array([n_read * ps - t - 5, seq_len, ps + 3], np.int32)
    tables[2, (pos[2] + t - 1) // ps + 1 :] = -1
    q = rng.standard_normal((b, t, n_kv * g, hd)).astype(np.float32)
    return q, kp, vp, ks, vs, tables, pos, n_read, ps, layer


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,g", [(64, 4), (128, 8)])
@pytest.mark.parametrize("t", [1, 5])
def test_b6_plain_matches_pallas_interpret(t, hd, g, q_dtype):
    rng = np.random.default_rng(t * 1000 + hd + g)
    q, kp, vp, ks, vs, tables, pos, n_read, ps, layer = _paged_inputs(rng, t, hd, g)
    jq = jnp.asarray(q).astype(jnp.dtype(q_dtype))
    want = np.asarray(j_paged(
        jq, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ks), jnp.asarray(vs),
        jnp.int32(layer), jnp.asarray(pos), jnp.asarray(tables),
        n_read=n_read, page_size=ps, interpret=True,
    ).astype(jnp.float32))
    pq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(getattr(torch, q_dtype))
    got = ca.paged_flash_attention(
        pq, *(torch.from_numpy(a) for a in (kp, vp, ks, vs)), layer,
        torch.from_numpy(pos.astype(np.int64)), torch.from_numpy(tables), n_read, ps,
    )
    assert got.dtype == pq.dtype and got.shape == q.shape
    got = got.to(torch.float32).numpy()
    scale = float(np.abs(want).max())
    if q_dtype == "float32":
        tol = 1e-5 * scale
    else:  # one bf16 rounding of the output, at the output's scale
        tol = 2.0 ** (np.floor(np.log2(scale)) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_b6_plain_equals_attention_over_the_dequantized_view():
    """Independent of the Pallas kernel: live rows equal masked attention
    over their pages gathered and dequantized (unmapped pages past the
    causal limit contribute nothing)."""
    from distributed_llama_tpu_torch.ops.attention import gqa_attention

    rng = np.random.default_rng(11)
    q, kp, vp, ks, vs, tables, pos, n_read, ps, layer = _paged_inputs(rng, 1, 64, 4)
    args = [torch.from_numpy(a) for a in (kp, vp, ks, vs)]
    got = ca.paged_flash_attention_plain(
        torch.from_numpy(q), *args, layer, torch.from_numpy(pos.astype(np.int64)),
        torch.from_numpy(tables), n_read, ps)
    pages = torch.from_numpy(tables).clamp(min=0).long()
    b, _, n_kv, hd = q.shape[0], None, kp.shape[3], kp.shape[4]
    kv = [(torch.from_numpy(x)[layer, pages].float() * torch.from_numpy(s)[layer, pages][..., None])
          .reshape(b, n_read * ps, n_kv, hd) for x, s in ((kp, ks), (vp, vs))]
    want = gqa_attention(torch.from_numpy(q), *kv, torch.from_numpy(pos.astype(np.int64))[:, None])
    for r in (0, 2):  # the parked row's output is junk by contract
        torch.testing.assert_close(got[r], want[r], rtol=1e-5, atol=1e-5)


def test_b6_wrapper_refuses_bad_inputs():
    rng = np.random.default_rng(0)
    q, kp, vp, ks, vs, tables, pos, n_read, ps, layer = _paged_inputs(rng, 1, 64, 4)
    args = [torch.from_numpy(a) for a in (kp, vp, ks, vs)]
    qt, pt, tt = torch.from_numpy(q), torch.from_numpy(pos.astype(np.int64)), torch.from_numpy(tables)
    with pytest.raises(IndexError):
        ca.paged_flash_attention(qt, *args, 2, pt, tt, n_read, ps)
    with pytest.raises(ValueError):
        ca.paged_flash_attention(qt, *args, 0, pt, tt, n_read + 1, ps)
    with pytest.raises(ValueError):
        ca.paged_flash_attention(qt, *args, 0, pt, tt, n_read, 32)
    with pytest.raises(ValueError):
        ca.paged_flash_attention(qt, *args[:2], args[2][:, :1], args[3], 0, pt, tt, n_read, ps)


# -- the engine: paged against contiguous, and against JAX ---------------------


@pytest.mark.parametrize("page_size", [16, 32])
def test_paged_equals_contiguous_f32(model, page_size):
    """The same tokens and, after them, logits within 1e-6: the paged view
    holds the values the contiguous slab holds."""
    kw = dict(compute_dtype="float32", device="cpu", decode_chunk_size=16)
    ec = InferenceEngine(model, kv_layout="contiguous", **kw)
    ep = InferenceEngine(model, kv_layout="paged", kv_page_size=page_size, **kw)
    steps = len(PROMPT) + 24
    tc = ec.generate(PROMPT, steps).tokens
    tp = ep.generate(PROMPT, steps).tokens
    assert tc == tp
    lc = ec.decode_one(tc[-1], steps)
    lp = ep.decode_one(tp[-1], steps)
    np.testing.assert_allclose(lp, lc, rtol=0, atol=1e-6 * float(np.abs(lc).max()))
    assert ep.page_pool.used_pages == -(-(steps + 1) // page_size)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_paged_equals_contiguous_bf16_tokens(model, cache_dtype):
    kw = dict(device="cpu", decode_chunk_size=16, cache_dtype=cache_dtype)
    steps = len(PROMPT) + 24
    tc = InferenceEngine(model, kv_layout="contiguous", **kw).generate(PROMPT, steps).tokens
    tp = InferenceEngine(model, kv_layout="paged", **kw).generate(PROMPT, steps).tokens
    assert tc == tp


def test_paged_copy_on_write_carries_the_shared_page(tmp_path):
    """Row 1 shares row 0's first two pages, then writes from position 20,
    mid page 1: the copy-on-write must copy that page (positions 16..19
    are live context) before the write, and row 1's continuation must equal
    a contiguous run of the same sequence."""
    from distributed_llama_tpu_torch.runtime.batch_session import BatchSession

    path = str(tmp_path / "m.m")
    write_tiny_model(path, tiny_header(**_ARCHS["llama"]), seed=3)
    kw = dict(compute_dtype="float32", device="cpu", max_chunk=8)
    ep = InferenceEngine(path, kv_layout="paged", batch=2, **kw)
    s = BatchSession(ep)
    first, tail = PROMPT[:30], [41, 42, 43, 44, 45, 46]
    s.admit(0, first)
    pool = ep.page_pool
    shared = [int(p) for p in pool.tables[0, :2]]
    pool.share(1, shared)
    cows = pool.ensure(1, 20, 26)
    assert len(cows) == 1 and cows[0][0] == shared[1]
    ppaged.copy_page(ep.cache, *cows[0])
    s.begin_admit(1, first[:20] + tail)
    s._pending[1]["done"] = 20  # positions below 20 live on the shared pages
    assert s.prefill_pending(1) == 0
    got = [int(t) for t in s.step(8)[1]]
    solo = InferenceEngine(path, kv_layout="contiguous", **kw)
    want = solo.generate(first[:20] + tail, 26 + 8).tokens[26:]
    assert got == want[:8]
    assert [int(p) for p in pool.tables[0, :2]] == shared  # row 0 untouched


def _jax_engine(path, monkeypatch, dtype, layout):
    monkeypatch.setenv("DLT_PALLAS_INTERPRET", "1")
    return JEngine(path, compute_dtype=dtype, cache_dtype="int8", kv_layout=layout,
                   decode_chunk_size=16, speculative="off", prefix_cache_mb=0, grammar=False)


def test_paged_int8_f32_matches_jax(tmp_path, monkeypatch):
    path = str(tmp_path / "m.m")
    write_tiny_model(path, tiny_header(**_ARCHS["qwen3"]), seed=8)
    je = _jax_engine(path, monkeypatch, "float32", "paged")
    pe = InferenceEngine(path, compute_dtype="float32", cache_dtype="int8", kv_layout="paged",
                         device="cpu", decode_chunk_size=16)
    prompt = PROMPT[:40]
    je.prefill(prompt[:-1])
    pe.prefill(prompt[:-1])
    jl = je.decode_one(prompt[-1], len(prompt) - 1)
    pl = pe.decode_one(prompt[-1], len(prompt) - 1)
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)
    je.reset(), pe.reset()
    steps = len(prompt) + 20
    assert pe.generate(prompt, steps).tokens == je.generate(prompt, steps).tokens


def test_paged_int8_bf16_matches_interpret_mode_jax(tmp_path, monkeypatch):
    """bf16 on the fused-kernel arm on both sides (K5's plain version here,
    the Pallas kernel in interpret mode there)."""
    path = str(tmp_path / "m.m")
    write_tiny_model(path, tiny_header(**_ARCHS["llama"]), seed=8)
    je = _jax_engine(path, monkeypatch, "bfloat16", "paged")
    pe = InferenceEngine(path, cache_dtype="int8", kv_layout="paged", device="cpu",
                         decode_chunk_size=16)
    steps = len(PROMPT) + 24
    want = je.generate(PROMPT, steps).tokens
    got = pe.generate(PROMPT, steps).tokens
    assert got == want
    jl = je.decode_one(want[-1], steps)
    pl = pe.decode_one(got[-1], steps)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=5e-2 * float(np.abs(jl).max()))


def test_forward_drops_parked_and_unmapped_writes():
    """A parked row (pos = seq_len) and a row whose slot is unmapped write
    only the sink page; every mapped page keeps its content."""
    from distributed_llama_tpu_torch.models import forward
    from distributed_llama_tpu_torch.models.params import params_from_jax
    from distributed_llama_tpu_torch.ops.rope import build_rope_tables
    from distributed_llama_tpu_torch.testing import tiny_header as p_header

    h = p_header(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                 vocab_size=64, seq_len=64, weight_type=0)
    cfg = config_from_header(h, compute_dtype="float32", cache_dtype="int8")
    rng = np.random.default_rng(0)
    L, dim = cfg.n_layers, cfg.dim
    qkv = cfg.q_dim + 2 * cfg.kv_dim

    def w(*s):
        return (rng.standard_normal(s) * 0.1).astype(np.float32)

    params = params_from_jax({
        "embedding": w(64, dim), "final_norm": np.ones(dim, np.float32), "wcls": w(64, dim),
        "layers": {"wqkv": w(L, qkv, dim), "wo": w(L, dim, cfg.q_dim), "w13": w(L, 256, dim),
                   "w2": w(L, dim, 128), "norm0": np.ones((L, dim), np.float32),
                   "norm1": np.ones((L, dim), np.float32)},
    }, device="cpu")
    rope = build_rope_tables(h, device="cpu")
    pool = ppaged.init_kv_pool(cfg, 8, 16, device="cpu")
    for t in pool.tensors():
        t.copy_(torch.full(t.shape, 3, dtype=t.dtype))
    table = torch.tensor([[0, 1, 2, 3], [4, -1, -1, -1]], dtype=torch.int32)
    before = [t[:, :8].clone() for t in pool.tensors()]
    pos = torch.tensor([cfg.seq_len, 20])  # row 0 parked, row 1 in an unmapped slot
    logits = forward(cfg, params, rope, pool, torch.tensor([[5], [6]]), pos, kv_len=64,
                     page_table=table, page_size=16)
    assert torch.isfinite(logits[1]).all()
    for b, t in zip(before, pool.tensors()):
        assert torch.equal(b, t[:, :8])
