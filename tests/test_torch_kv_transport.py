"""The port's KV movement layer held to the JAX package's, on the CPU.

The wire codec (runtime/kv_transport.py): the same payload bytes from the
same arrays, f32 and bf16 (the port's bf16 travels as uint16 words; JAX's
as ml_dtypes), each package parsing the other's payload to equal arrays
and header; page naming, doubling segments and the matching-pages count;
`verify_transfer` accepting and rejecting each tampered surface with the
same error class and message; a seeded fuzz of clean errors only with the
same verdict as JAX's on every mutation; version rejection at the header.

The pool and the prefix cache (runtime/paged_kv.py, prefix_cache.py):
`gather_pages`, `scatter_pages` and `allocate_pages` on the same seeded
pools give JAX's arrays, page ids and refcounts (f32 and int8); and
`insert_external` on the same tiny model (contiguous f32, paged f32, paged
int8, and a partial merge onto a held base) gives JAX's entries, pages,
pool contents and counters.
"""

import random

import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.params import KVCache as JKVCache
from distributed_llama_tpu.runtime import kv_transport as jkt
from distributed_llama_tpu.runtime import paged_kv as j_paged
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu.testing import tiny_header, write_tiny_model
from distributed_llama_tpu_torch.models.params import KVCache as PKVCache
from distributed_llama_tpu_torch.runtime import kv_transport as pkt
from distributed_llama_tpu_torch.runtime import paged_kv as p_paged
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine as PEngine


def _header(k, start=0, n_tokens=None, dtype=None):
    n_tokens = n_tokens if n_tokens is not None else k.shape[1] + start
    toks = [(i * 7) % 250 + 1 for i in range(n_tokens)]
    spans = jkt.doubling_segments(start, n_tokens)
    return {
        "v": jkt.WIRE_VERSION,
        "tokens": toks,
        "p": n_tokens,
        "start": start,
        "page_tokens": jkt.KEY_PAGE_TOKENS,
        "page_keys": [format(h, "x") for h in jkt.page_keys(toks)],
        "k_shape": list(k.shape),
        "v_shape": list(k.shape),
        "dtype": dtype or str(k.dtype),
        "k_sums": [format(jkt.segment_checksum(k[:, a - start:b - start].tobytes()), "x")
                   for a, b in spans],
        "v_sums": [format(jkt.segment_checksum((k + 1)[:, a - start:b - start].tobytes()), "x")
                   for a, b in spans],
        "prefill_us": 5,
    }, toks


def _f32(n_tokens=64, start=0, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, n_tokens - start, 2, 4)).astype(np.float32)


# -- the codec ---------------------------------------------------------------


def test_page_naming_and_segments_equal_jax():
    rng = random.Random(3)
    for _ in range(20):
        toks = [rng.randrange(1, 300) for _ in range(rng.randrange(0, 200))]
        assert pkt.page_keys(toks) == jkt.page_keys(toks)
        other = list(toks)
        if other:
            other[rng.randrange(len(other))] += 1
        assert (pkt.matching_pages(pkt.page_keys(toks), pkt.page_keys(other))
                == jkt.matching_pages(jkt.page_keys(toks), jkt.page_keys(other)))
    for start, end in ((0, 512), (16, 2048), (128, 1024), (32, 48)):
        assert pkt.doubling_segments(start, end) == jkt.doubling_segments(start, end)
    assert pkt.WIRE_VERSION == jkt.WIRE_VERSION and pkt.KEY_PAGE_TOKENS == jkt.KEY_PAGE_TOKENS
    assert pkt.segment_checksum(b"abc") == jkt.segment_checksum(b"abc")


@pytest.mark.parametrize("start", [0, 32])
def test_f32_payload_bytes_equal_jax_both_ways(start):
    k = _f32(64, start)
    h, _ = _header(k, start)
    body_j = jkt.kv_payload(h, k, k + 1)
    body_p = pkt.kv_payload(h, k, k + 1)
    assert body_p == body_j
    for parse in (pkt.parse_kv_payload, jkt.parse_kv_payload):
        h2, k2, v2 = parse(body_p)
        assert h2 == dict(h)
        np.testing.assert_array_equal(k2, k)
        np.testing.assert_array_equal(v2, k + 1)


def test_bf16_payload_bytes_equal_jax_both_ways():
    import ml_dtypes

    f = _f32(64, 0, seed=5) * 3
    k_j = f.astype(ml_dtypes.bfloat16)
    v_j = (f + 0.5).astype(ml_dtypes.bfloat16)
    # the port's host arrays: the tensors' raw words, via to_wire
    k_p = pkt.to_wire(torch.from_numpy(f).to(torch.bfloat16))
    v_p = pkt.to_wire(torch.from_numpy(f + 0.5).to(torch.bfloat16))
    assert k_p.dtype == np.uint16 and pkt.wire_name(k_p) == "bfloat16" == str(k_j.dtype)
    np.testing.assert_array_equal(k_p, k_j.view(np.uint16))
    h = {"tokens": list(range(64)), "p": 64, "k_shape": list(f.shape),
         "v_shape": list(f.shape), "dtype": "bfloat16", "prefill_us": 0}
    body_j = jkt.kv_payload(h, k_j, v_j)
    assert pkt.kv_payload(h, k_p, v_p) == body_j
    h2, k2, v2 = pkt.parse_kv_payload(body_j)
    assert h2["dtype"] == "bfloat16" and k2.dtype == np.uint16
    np.testing.assert_array_equal(k2, k_j.view(np.uint16))
    np.testing.assert_array_equal(v2, v_j.view(np.uint16))
    h3, k3, v3 = jkt.parse_kv_payload(pkt.kv_payload(h, k_p, v_p))
    assert str(k3.dtype) == "bfloat16"
    np.testing.assert_array_equal(k3.view(np.uint16), k_p)
    # and back onto the card's dtype, bit for bit
    t = pkt.from_wire(k2)
    assert t.dtype == torch.bfloat16
    assert torch.equal(t.view(torch.int16), torch.from_numpy(k_p.view(np.int16)))


def test_truncation_raises_clean_codec_errors():
    k = np.zeros((1, 16, 1, 4), np.float32)
    h = {"tokens": list(range(16)), "p": 16, "k_shape": list(k.shape),
         "v_shape": list(k.shape), "dtype": "float32", "prefill_us": 0}
    body = pkt.kv_payload(h, k, k)
    for cut in (0, 2, 6, len(body) - 17):
        with pytest.raises(pkt.KvCodecError):
            pkt.parse_kv_payload(body[:cut])
        with pytest.raises(jkt.KvCodecError):
            jkt.parse_kv_payload(body[:cut])


def _verdict(mod, header, k, v, toks, path="http", P=64):
    res = mod.TransferResult(header, k, v, path, 0)
    try:
        mod.verify_transfer(res, toks, P)
        return "ok"
    except mod.KvCodecError as e:
        return f"{type(e).__name__}: {e}"


def _tampered(start=0):
    k = _f32(64, start, seed=1)
    v = k + 1
    h, toks = _header(k, start)
    kk = k.copy()
    kk.flat[100] += 1
    h_keys = dict(h, page_keys=list(h["page_keys"]))
    h_keys["page_keys"][-1] = format(int(h_keys["page_keys"][-1], 16) ^ 1, "x")
    no_sums = {a: b for a, b in h.items() if a not in ("k_sums", "v_sums")}
    return [
        ("valid", h, k, v, toks, "http"),
        ("flipped byte", h, kk, v, toks, "http"),
        ("page_keys echo", h_keys, k, v, toks, "http"),
        ("different tokens", h, k, v, [t + 1 for t in toks], "http"),
        ("misaligned start", dict(h, start=7), k, v, toks, "http"),
        ("no checksums", no_sums, k, v, toks, "http"),
        ("future version", dict(h, v=jkt.WIRE_VERSION + 1), k, v, toks, "http"),
        ("short shapes", h, k[:, :-1], v[:, :-1], toks, "http"),
        ("device valid", h, k, v, toks, "device"),
        ("device short", h, k[:, :-1], v, toks, "device"),
        ("device segments", h, [k, k], [v, v], toks, "device"),
        ("device dtype", h, k, v.astype(np.float16), toks, "device"),
    ]


@pytest.mark.parametrize("start", [0, 32])
def test_verify_transfer_verdicts_equal_jax(start):
    for name, h, k, v, toks, path in _tampered(start):
        j = _verdict(jkt, h, k, v, toks, path)
        p = _verdict(pkt, h, k, v, toks, path)
        assert p == j, name
        assert (p == "ok") == name.endswith("valid"), (name, p)
    # the device path checks torch tensors on the same metadata
    k = torch.from_numpy(_f32(64, start, seed=1))
    h, toks = _header(k.numpy(), start)
    assert _verdict(pkt, h, k, k + 1, toks, "device") == "ok"
    assert _verdict(pkt, h, k, (k + 1).half(), toks, "device").startswith("KvIntegrityError")


def test_version_rejected_at_the_header():
    k = _f32(64)
    h, _ = _header(k)
    for body in (pkt.kv_payload(dict(h, v=jkt.WIRE_VERSION + 7), k, k),
                 pkt.kv_payload({"v": jkt.WIRE_VERSION + 7}, np.zeros(3, np.float32), k)):
        with pytest.raises(pkt.KvVersionError):
            pkt.parse_kv_payload(body)
        with pytest.raises(jkt.KvVersionError):
            jkt.parse_kv_payload(body)


def test_codec_fuzz_clean_errors_and_jax_verdicts():
    """~1k seeded truncations, bit flips and garbage through parse + verify:
    each is a clean pass or a KvCodecError, the same verdict as JAX's."""
    k = _f32(64, seed=2)
    h, toks = _header(k)
    body = pkt.kv_payload(h, k, k + 1)
    rng = random.Random(0xD17)
    rejected = 0

    def run(mod, mut):
        try:
            hdr, kk, vv = mod.parse_kv_payload(mut)
            mod.verify_transfer(mod.TransferResult(hdr, kk, vv, "http", len(mut)), toks, 64)
            return "ok"
        except mod.KvCodecError as e:
            return type(e).__name__

    for _ in range(1000):
        mode = rng.randrange(4)
        if mode == 0:
            mut = body[: rng.randrange(len(body))]
        elif mode == 1:
            off = rng.randrange(len(body))
            mut = body[:off] + bytes([body[off] ^ (1 << rng.randrange(8))]) + body[off + 1:]
        elif mode == 2:
            mut = rng.randbytes(rng.randrange(1, 64)) + body
        else:
            mut = rng.randbytes(rng.randrange(0, 256))
        p = run(pkt, mut)
        assert p == run(jkt, mut)
        rejected += p != "ok"
    assert rejected > 900, rejected


def test_device_registry_and_chaos_modes():
    class P:
        role = "prefill"

    p = P()
    pkt.register_device_peer(59999, p)
    try:
        assert pkt.device_peer(59999) is p and pkt.device_peer(59998) is None
    finally:
        pkt.unregister_device_peer(59999)
    assert pkt.device_peer(59999) is None
    assert pkt.DEVICE_CORRUPT_MODES == jkt.DEVICE_CORRUPT_MODES
    with pytest.raises(ValueError):
        pkt.set_device_chaos(corrupt="nope")
    pkt.set_device_chaos(None)


# -- the pool's page movers --------------------------------------------------


def _pools(int8: bool, n_pages=9, seed=0):
    """A JAX pool and a port pool (with its sink page) of the same seeded
    contents: [L=2, n_pages, ps=16, kv=2, hd=8]."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    shape = (2, n_pages, 16, 2, 8)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.random(shape[:-1]).astype(np.float32) / 50
        vs = rng.random(shape[:-1]).astype(np.float32) / 50
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    j = JKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                 k_scale=None if ks is None else jnp.asarray(ks),
                 v_scale=None if vs is None else jnp.asarray(vs))

    def sink(a):  # the port's pool carries one more page, the sink
        return torch.from_numpy(np.concatenate([a, np.zeros_like(a[:, :1])], axis=1))

    p = PKVCache(k=sink(k), v=sink(v), k_scale=None if ks is None else sink(ks),
                 v_scale=None if vs is None else sink(vs))
    return j, p


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_gather_and_scatter_pages_equal_jax(int8):
    j, p = _pools(int8)
    pages = [3, 0, 7]
    jk, jv = j_paged.gather_pages(j, np.asarray(pages, np.int32))
    pk, pv = p_paged.gather_pages(p, pages)
    assert pk.dtype == torch.float32
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    # the gather owns its storage: a scatter into the same pages leaves it
    seg = np.random.default_rng(9).standard_normal((2, 32, 2, 8)).astype(np.float32)
    before = pk.clone()
    dst = [5, 3]
    j2 = j_paged.scatter_pages(j, seg, seg + 1, np.asarray(dst, np.int32))
    k_ptr = p.k.data_ptr()
    p_paged.scatter_pages(p, torch.from_numpy(seg), torch.from_numpy(seg + 1), dst)
    assert p.k.data_ptr() == k_ptr  # in place: the live tensors are kept
    assert torch.equal(pk, before)
    for name in ("k", "v", "k_scale", "v_scale"):
        a = getattr(j2, name)
        if a is None:
            continue
        got = getattr(p, name)[:, :-1].numpy()
        if name.endswith("scale"):
            # amax / 127: the jitted JAX program's division may round one
            # ulp from the eager one (the port's, equal to JAX's eager
            # quantize_kv: tests/test_torch_kv_quant.py); the int8 payload
            # above is equal bit for bit
            np.testing.assert_allclose(got, np.asarray(a), rtol=2.5e-7, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(got, np.asarray(a), name)


def test_allocate_pages_equal_jax():
    kw = dict(n_pages=10, page_size=16, n_rows=2, seq_len=64)
    jp, pp = j_paged.PagePool(**kw), p_paged.PagePool(**kw)
    out = []
    for pool in (jp, pp):
        pool.ensure(0, 0, 40)
        a = pool.allocate_pages(3)
        pool.release(a[:1])
        b = pool.allocate_pages(2)
        pool.release_row(0)
        c = pool.allocate_pages(0)
        out.append((a, b, c, pool.refs.tolist(), list(pool._free)))
    assert out[1] == out[0]
    for pool in (jp, pp):
        with pytest.raises(Exception, match="exhausted"):
            pool.allocate_pages(100)


# -- insert_external on the engines -------------------------------------------


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("kvt")
    path = str(d / "m.m")
    write_tiny_model(path, tiny_header(seq_len=256), seed=11)
    return path


def _engines(path, **kw):
    kw = dict(compute_dtype="float32", max_chunk=16, decode_chunk_size=8, prefix_cache_mb=64,
              **kw)
    return JEngine(path, **kw), PEngine(path, device="cpu", **kw)


def _slice(eng_p, P, seed):
    L, h, d = eng_p.cfg.n_layers, eng_p.cfg.n_kv_heads, eng_p.cfg.head_dim
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((L, P, h, d)).astype(np.float32),
            rng.standard_normal((L, P, h, d)).astype(np.float32))


def _assert_pools_equal(got, want):
    """k and v bit for bit; the int8 arm's scales within the one ulp that
    the jitted JAX division may round differently (see above)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if i < 2:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=2.5e-7, atol=0)


def _pool_at(cache, pages, port):
    out = []
    for name in ("k", "v", "k_scale", "v_scale"):
        a = getattr(cache, name)
        if a is None:
            continue
        a = a.numpy() if port else np.asarray(a)
        out.append(a[:, list(pages)])
    return out


@pytest.mark.parametrize("layout,dtype", [("contiguous", None), ("paged", None),
                                          ("paged", "int8")],
                         ids=["contiguous", "paged-f32", "paged-int8"])
def test_insert_external_equals_jax(model_path, layout, dtype):
    je, pe = _engines(model_path, kv_layout=layout, cache_dtype=dtype)
    try:
        toks = [(i * 5) % 200 + 1 for i in range(64)]
        k, v = _slice(pe, 32, seed=4)
        # one whole slice, then a deeper one as per-segment lists (start 0)
        assert je.prefix_cache.insert_external(je, toks[:32], k, v)
        assert pe.prefix_cache.insert_external(pe, toks[:32], k, v)
        k64, v64 = _slice(pe, 64, seed=5)
        segs = pkt.doubling_segments(0, 64)
        ks = [k64[:, a:b] for a, b in segs]
        vs = [v64[:, a:b] for a, b in segs]
        assert je.prefix_cache.insert_external(je, toks, ks, vs)
        assert pe.prefix_cache.insert_external(pe, toks, [torch.from_numpy(x) for x in ks],
                                               [torch.from_numpy(x) for x in vs])
        # refusals: off-bucket length, bad shapes
        bad = np.zeros((k.shape[0], 17, k.shape[2], k.shape[3]), np.float32)
        for eng in (je, pe):
            assert not eng.prefix_cache.insert_external(eng, toks[:17], bad, bad)
            assert not eng.prefix_cache.insert_external(eng, toks[:16], k[:, :16], k[:, :16, :, :1])
        for key in (tuple(toks[:32]), tuple(toks)):
            ej, ep = je.prefix_cache._entries[key], pe.prefix_cache._entries[key]
            assert ep.pages == ej.pages and ep.nbytes == ej.nbytes
            if layout == "contiguous":
                np.testing.assert_array_equal(ep.k.numpy(), np.asarray(ej.k))
                np.testing.assert_array_equal(ep.v.numpy(), np.asarray(ej.v))
            else:
                _assert_pools_equal(_pool_at(pe.cache, ep.pages, True),
                                    _pool_at(je.cache, ej.pages, False))
        assert pe.page_pool is None or pe.page_pool.refs.tolist() == je.page_pool.refs.tolist()
        cj, cp = je.stats.counters_snapshot(), pe.stats.counters_snapshot()
        assert {k_: cp.get(k_, 0) for k_ in cj if k_.startswith(("prefix_", "kv_pool"))} == \
            {k_: v_ for k_, v_ in cj.items() if k_.startswith(("prefix_", "kv_pool"))}
    finally:
        je.close()
        pe.close()


def test_insert_external_partial_merge_equals_jax(model_path):
    """A partial send (start 32) onto a held base: the merged entry retains
    the base's pages and scatters the shipped [32, 64) into new ones, in
    both packages alike; the base pin releases."""
    je, pe = _engines(model_path, kv_layout="paged")
    try:
        toks = [(i * 3) % 200 + 1 for i in range(64)]
        k, v = _slice(pe, 32, seed=7)
        k2, v2 = _slice(pe, 32, seed=8)
        results = []
        for eng, port in ((je, False), (pe, True)):
            pc = eng.prefix_cache
            assert pc.insert_external(eng, toks[:32], k, v)
            covered, base = pc.match_pinned(toks)
            assert covered == 32 and base.refs == 1
            arr = (lambda a: torch.from_numpy(a)) if port else (lambda a: a)
            assert pc.insert_external(eng, toks, arr(k2), arr(v2), start=32, base_entry=base)
            pc.entry_release(base)
            assert base.refs == 0
            merged = pc._entries[tuple(toks)]
            assert merged.pages[:2] == base.pages
            results.append((merged.pages, _pool_at(eng.cache, merged.pages, port),
                            eng.page_pool.refs.tolist()))
        assert results[1][0] == results[0][0] and results[1][2] == results[0][2]
        _assert_pools_equal(results[1][1], results[0][1])
        # a base whose tokens disagree with the slice is refused
        other = [t + 1 for t in toks]
        covered, base = pe.prefix_cache.match_pinned(toks)
        assert not pe.prefix_cache.insert_external(pe, other, k2, v2, start=32, base_entry=base)
        pe.prefix_cache.entry_release(base)
    finally:
        je.close()
        pe.close()
