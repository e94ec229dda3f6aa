"""The port's radix prefix cache (runtime/prefix_cache.py) against the JAX
package's, on the CPU.

Host side, the port's helpers and tree give the JAX cache's answers on
the same inputs: buckets, boundaries, budgets, and every (covered, entry)
of a scripted run of inserts, matches, pins and evictions (the cases of
tests/test_prefix_cache.py:66-117 among them), with the same counters.

Engine side, a pinned trace (cold, full hit, a partial hit whose
boundary falls below one chunk, eviction then a miss) runs through both
engines on the contiguous and the paged layout, f32 and paged int8:
both make the same hits at the same boundaries and count the same; the
port's hits give its own cold run's tokens and next-token logits bit for
bit (tolerance 0, as the JAX package's test_engine_hit_paths_bit_identical
holds its own); greedy tokens equal the JAX engine's on the pinned seed.
Likewise for BatchSession admissions, generate_batch, a pool small
enough that `ensure` evicts through the reclaim hook (the same tables,
refcounts and free list as the JAX pool), the gates, the static decode
step after a paged share, and the CLI's budget and tokens.
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu import cli as jcli
from distributed_llama_tpu.runtime import paged_kv as jpaged
from distributed_llama_tpu.runtime import prefix_cache as jpc
from distributed_llama_tpu.runtime.batch_session import BatchSession as JSession
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu.runtime.telemetry import StepStats
from distributed_llama_tpu_torch import cli as pcli
from distributed_llama_tpu_torch.parallel import make_mesh
from distributed_llama_tpu_torch.runtime import paged_kv as ppaged
from distributed_llama_tpu_torch.runtime import prefix_cache as ppc
from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
from distributed_llama_tpu_torch.runtime.graphs import DecodeGraphs
from distributed_llama_tpu_torch.testing import tiny_header, write_tiny_model, write_tiny_tokenizer

torch.set_num_threads(1)

COUNTERS = ppc.COUNTERS
# (layout, kv dtype) arms the cache serves; contiguous int8 has none
ARMS = [("contiguous", None), ("paged", None), ("paged", "int8")]
A = [(i % 100) + 1 for i in range(48)]
HEAD24 = A[:24] + [(i % 90) + 7 for i in range(24)]  # boundary 16 < max_chunk 32
C = [(i % 95) + 3 for i in range(48)]
N_NEW = 16


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("pfx") / "m.m")
    write_tiny_model(p, tiny_header(seq_len=256), seed=11)
    return p


def _port(path, layout="contiguous", kv=None, **kw):
    kw.setdefault("compute_dtype", "float32")
    kw.setdefault("max_chunk", 32)
    kw.setdefault("decode_chunk_size", 8)
    return InferenceEngine(path, kv_layout=layout, cache_dtype=kv, device="cpu", **kw)


def _jax(path, layout="contiguous", kv=None, **kw):
    kw.setdefault("compute_dtype", "float32")
    kw.setdefault("max_chunk", 32)
    kw.setdefault("decode_chunk_size", 8)
    return JEngine(path, kv_layout=layout, cache_dtype=kv, speculative="off", grammar=False, **kw)


def _jcounters(stats) -> dict:
    snap = stats.counters_snapshot()
    return {k: snap.get(k, 0) for k in COUNTERS}


# -- the helpers ---------------------------------------------------------------


@pytest.mark.parametrize("seq_len", [0, 16, 31, 32, 33, 64, 100, 256, 4096, 131072])
def test_prefix_buckets_and_bucket_down_match_jax(seq_len):
    assert ppc.prefix_buckets(seq_len) == jpc.prefix_buckets(seq_len)
    for n in [0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 100, 1024, 5000, 70000, 131072]:
        assert ppc.bucket_down(n, seq_len) == jpc.bucket_down(n, seq_len), n


@pytest.mark.parametrize("max_chunk", [1, 8, 16, 32, 64, 128])
def test_resume_boundary_matches_jax(max_chunk):
    p = ppc.PrefixCache(1 << 20, seq_len=4096, max_chunk=max_chunk)
    j = jpc.PrefixCache(1 << 20, seq_len=4096, max_chunk=max_chunk)
    for m in range(0, 300):
        assert p.resume_boundary(m) == j.resume_boundary(m), m


@pytest.mark.parametrize("explicit,env,default", [
    (None, None, 0), (None, None, 512), (None, "", 512), (None, "64", 0), (None, "64", 512),
    (None, "junk", 512), (None, "0", 512), (0, "64", 512), (32, None, 0), (-1, None, 512)])
def test_resolve_budget_mb_matches_jax(monkeypatch, explicit, env, default):
    if env is None:
        monkeypatch.delenv("DLT_PREFIX_CACHE_MB", raising=False)
    else:
        monkeypatch.setenv("DLT_PREFIX_CACHE_MB", env)
    assert ppc.resolve_budget_mb(explicit, default) == jpc.resolve_budget_mb(explicit, default)


# -- the tree ------------------------------------------------------------------


def _add(pc, entry_cls, tokens, nbytes=100):
    """A published entry without an engine, as tests/test_prefix_cache.py
    builds them."""
    e = entry_cls(tokens=tuple(tokens), k=None, v=None, nbytes=nbytes)
    with pc._lock:
        pc._insert(e)
        pc._entries[e.tokens] = e
        pc._bytes += e.nbytes
        pc._clock += 1
        e.last_used = pc._clock
    return e


def _view(res):
    covered, entry = res
    return covered, None if entry is None else entry.tokens


def test_scripted_tree_run_matches_jax():
    """Inserts, matches (full chain, mid-edge divergence, ancestor
    fallback, miss), pinned splice lookups, releases and evictions, step by
    step through both caches."""
    stats = StepStats()
    j = jpc.PrefixCache(250, seq_len=4096, max_chunk=16, stats=stats)
    p = ppc.PrefixCache(250, seq_len=4096, max_chunk=16)
    a = [1, 2, 3, 4] * 8
    b = a + [9] * 32
    c = [7] * 16
    queries = [a, b + [5, 5], a + [9] * 4 + [1] * 8, [5, 5, 5, 5], [7] * 10, [7] * 40,
               a[:20] + [8] * 30, b[:50], [], [1, 2, 3]]
    for toks in (a, b, c):
        _add(j, jpc.PrefixEntry, toks)
        _add(p, ppc.PrefixEntry, toks)
    steps = []
    for q in queries:
        steps.append((_view(p.match(q)), _view(j.match(q))))
    pinned = []
    for q in queries:
        pr, jr = p.match_for_splice(q), j.match_for_splice(q)
        steps.append((_view(pr), _view(jr)))
        if pr[1] is not None:
            pinned.append((pr, jr))
    for (pb, pe), (jb, je) in pinned[::2]:
        p.record_hit(pb)
        j.record_hit(jb)
        p.entry_release(pe)
        j.entry_release(je)
    pinned_keys = lambda pc: sorted(e.tokens for e in pc._entries.values() if e.refs)
    assert pinned_keys(p) == pinned_keys(j)
    # budget 250 holds two of the three: the first evictions skip pins
    for target in (250, 150, 50, 0):
        assert p._evict_until(target) == j._evict_until(target)
        assert sorted(p._entries) == sorted(j._entries)
    for pc in (p, j):
        for e in pc._entries.values():
            e.refs = 0
    while True:
        got = p.evict_one()
        assert got == j.evict_one()
        if not got:
            break
    for q in queries:
        steps.append((_view(p.match(q)), _view(j.match(q))))
    for got, want in steps:
        assert got == want
    assert p.n_entries == j.n_entries == 0 and p.total_bytes == j.total_bytes == 0
    assert p.counters == _jcounters(stats)
    assert p.counters["prefix_hits"] > 0 and p.counters["prefix_misses"] > 0
    assert p.counters["prefix_evictions"] == 3


def test_radix_match_semantics_cases():
    """tests/test_prefix_cache.py:66-88's cases through the port alone:
    full chain, extension, mid-edge divergence, miss, ancestor fallback."""
    pc = ppc.PrefixCache(1 << 20, seq_len=4096, max_chunk=16)
    a = _add(pc, ppc.PrefixEntry, [1, 2, 3, 4] * 8)
    b = _add(pc, ppc.PrefixEntry, [1, 2, 3, 4] * 8 + [9] * 32)
    c = _add(pc, ppc.PrefixEntry, [7] * 16)
    covered, hit = pc.match(list(a.tokens))
    assert covered == 32 and hit in (a, b)
    assert pc.match(list(b.tokens) + [5, 5]) == (64, b)
    assert pc.match(list(a.tokens) + [9] * 4 + [1] * 8) == (36, b)
    assert pc.match([5, 5, 5, 5]) == (0, None)
    assert pc.match([7] * 10) == (10, c)


def test_lru_eviction_respects_pins_and_budget():
    pc = ppc.PrefixCache(250, seq_len=4096, max_chunk=16)
    a, b, c = (_add(pc, ppc.PrefixEntry, [t] * 16) for t in (1, 2, 3))
    a.refs = 1
    assert pc._evict_until(250)
    assert b.tokens not in pc._entries and a.tokens in pc._entries
    assert not pc._evict_until(50)
    assert a.tokens in pc._entries and c.tokens not in pc._entries
    a.refs = 0
    assert pc._evict_until(0)
    assert pc.n_entries == 0 and pc.total_bytes == 0


# -- the engines ---------------------------------------------------------------


def _trace(eng, counters, cache):
    """The pinned trace: A cold, A hit, HEAD24 (a 24-token shared head:
    boundary 16), then a one-entry budget, C cold (evicting), A again (a
    miss). Returns [(tokens, hit tokens, counters)] per request."""
    out = []

    def run(prompt):
        eng.reset()
        toks = eng.generate(prompt, len(prompt) + N_NEW, sampler=None).tokens
        out.append((toks, eng.last_prefix_hit_tokens, counters()))

    run(A)
    run(A)
    run(HEAD24)
    pc = cache()
    pc.budget_bytes = next(iter(pc._entries.values())).nbytes
    run(C)
    run(A)
    return out


@pytest.mark.parametrize("layout,kv", ARMS)
def test_engine_trace_matches_jax_and_hits_equal_cold(path, layout, kv):
    pe = _port(path, layout, kv, prefix_cache_mb=64)
    got = _trace(pe, lambda: dict(pe.prefix_cache.counters), lambda: pe.prefix_cache)
    je = _jax(path, layout, kv, prefix_cache_mb=64)
    want = _trace(je, lambda: _jcounters(je.stats), lambda: je.prefix_cache)
    je.close()
    assert [g[1] for g in got] == [w[1] for w in want] == [0, 32, 16, 0, 0]
    assert [g[2] for g in got] == [w[2] for w in want]
    assert got[-1][2]["prefix_evictions"] >= 2
    # the port's hits against its own cold runs: tokens bit for bit
    cold = _port(path, layout, kv)
    for prompt, (toks, _, _) in zip((A, A, HEAD24, C, A), got):
        cold.reset()
        assert toks == cold.generate(prompt, len(prompt) + N_NEW, sampler=None).tokens
    # greedy tokens equal the JAX engine's on the pinned seed
    assert [g[0] for g in got] == [w[0] for w in want]


@pytest.mark.parametrize("layout,kv", ARMS)
@pytest.mark.parametrize("prompt", [A, HEAD24], ids=["full", "head24"])
def test_hit_next_token_logits_equal_cold(path, layout, kv, prompt):
    """A hit's prefill, then the decode step on the last prompt token: its
    logits equal the cold engine's bit for bit, at a chunk boundary (32)
    and below one chunk (16)."""
    eng = _port(path, layout, kv, prefix_cache_mb=64)
    eng.generate(A, len(A) + N_NEW, sampler=None)  # publishes A[:32]
    eng.reset()
    eng.prefill(prompt[:-1], publish=False)
    assert eng.last_prefix_hit_tokens == (32 if prompt is A else 16)
    got = eng.decode_one(prompt[-1], len(prompt) - 1)
    cold = _port(path, layout, kv)
    cold.prefill(prompt[:-1])
    want = cold.decode_one(prompt[-1], len(prompt) - 1)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("layout,kv", ARMS)
def test_prefill_publishes_and_resumes_like_jax(path, layout, kv):
    """`prefill` publishes by default, `publish=False` does not; a second
    prefill of a longer prompt resumes at the published boundary."""
    pe = _port(path, layout, kv, prefix_cache_mb=64)
    je = _jax(path, layout, kv, prefix_cache_mb=64)
    for eng in (pe, je):
        eng.prefill(A[:40], publish=False)
        assert eng.prefix_cache.n_entries == 0
        eng.reset()
        eng.prefill(A[:40])
        eng.reset()
        eng.prefill(A)
    assert pe.last_prefix_hit_tokens == je.last_prefix_hit_tokens == 32
    assert pe.prefix_cache.n_entries == je.prefix_cache.n_entries == 1
    assert pe.prefix_cache.total_bytes == je.prefix_cache.total_bytes
    assert pe.prefix_cache.counters == _jcounters(je.stats)
    je.close()


def _session_trace(eng, session_cls, counters):
    """Cold admission (publishes at arming), a hit on another row, a
    staged admission released before its splice, a partial hit through
    budgeted prefill_pending, and a publish_row. Returns tokens, resumes,
    pins and counters."""
    s = session_cls(eng)
    toks, resumes, pins = {}, [], []
    pinned = lambda: sorted(e.refs for e in eng.prefix_cache._entries.values())
    s.admit(0, A)
    toks[0] = [int(t) for _ in range(3) for t in s.step(8)[0]]
    s.begin_admit(1, A)
    resumes.append(s.pending_resume(1))
    pins.append(pinned())
    s.prefill_pending(1)
    pins.append(pinned())
    toks[1] = [int(t) for _ in range(3) for t in s.step(8)[1]]
    s.release(0)
    s.begin_admit(0, A)
    pins.append(pinned())
    s.release(0)
    pins.append(pinned())
    s.begin_admit(2, HEAD24)
    resumes.append(s.pending_resume(2))
    remaining = []
    while True:
        remaining.append(s.prefill_pending(2, 8))
        if not remaining[-1]:
            break
    toks[2] = [int(t) for _ in range(3) for t in s.step(8)[2]]
    s.publish_row(1, A + toks[1])
    resumes.append(s.pending_resume(3))
    return toks, resumes, pins, remaining, counters(), eng.prefix_cache.n_entries


@pytest.mark.parametrize("layout,kv", ARMS)
def test_batch_session_matches_jax_and_solo(path, layout, kv):
    pe = _port(path, layout, kv, batch=3, prefix_cache_mb=64)
    got = _session_trace(pe, BatchSession, lambda: dict(pe.prefix_cache.counters))
    je = _jax(path, layout, kv, batch=3, prefix_cache_mb=64)
    want = _session_trace(je, JSession, lambda: _jcounters(je.stats))
    je.close()
    assert got[1:] == want[1:]
    assert got[1] == [32, 16, 0] and got[2] == [[1], [0], [1], [0]]
    assert got[3] == [23, 15, 7, 0]  # budgeted chunks from the boundary 16
    assert got[4]["prefix_hits"] == 2 and got[4]["prefix_hit_tokens"] == 48
    assert got[5] == 3  # A[:32], HEAD24[:32], and publish_row's A[:64]
    # every row equals its solo stream, hit or cold, and the JAX session's
    solo = _port(path, layout, kv)
    for row, prompt in ((0, A), (1, A), (2, HEAD24)):
        solo.reset()
        assert got[0][row] == solo.generate(prompt, len(prompt) + 25,
                                            sampler=None).tokens[len(prompt):][:24]
    assert got[0] == want[0]


@pytest.mark.parametrize("layout,kv", ARMS)
def test_generate_batch_shared_prefix_hit_equals_cold(path, layout, kv):
    prompts = [A[:40] + [(i * (r + 2) % 80) + 5 for i in range(8)] for r in range(2)]
    cold = _port(path, layout, kv, batch=2).generate_batch(prompts, 8)
    pe = _port(path, layout, kv, batch=2, prefix_cache_mb=64)
    je = _jax(path, layout, kv, batch=2, prefix_cache_mb=64)
    hits = []
    for eng in (pe, je):
        first = eng.generate_batch(prompts, 8, sampler=None)
        hits.append(eng.last_prefix_hit_tokens)
        eng.reset()
        second = eng.generate_batch(prompts, 8, sampler=None)
        hits.append(eng.last_prefix_hit_tokens)
        if eng is pe:
            assert first == cold and second == cold
        else:
            assert first == cold  # greedy tokens equal the JAX engine's
    assert hits[:2] == hits[2:] == [0, 32]
    assert pe.prefix_cache.counters == _jcounters(je.stats)
    je.close()


def _pool_state(pool):
    return pool.tables.tolist(), pool.refs.tolist(), list(pool._free)


def test_tight_pool_evicts_through_reclaim_like_jax(tmp_path):
    """An 8-page pool: the third and fourth requests need the pages that
    entries retain, so `ensure` evicts through `_reclaim_pages`; the pool's
    tables, refcounts and free list equal the JAX pool's after every
    request, and tokens equal a cold engine's."""
    p = str(tmp_path / "m.m")
    write_tiny_model(p, tiny_header(dim=256, hidden_dim=256, n_layers=4, n_heads=4,
                                    n_kv_heads=4, seq_len=256), seed=4)
    kw = dict(kv_pool_mb=1, prefix_cache_mb=64)
    pe, je = _port(p, "paged", **kw), _jax(p, "paged", **kw)
    assert pe.page_pool.n_pages == je.page_pool.n_pages == 8
    cold = _port(p, "paged")
    prompts = [[(i * (k + 3)) % 200 + 1 for i in range(48)] for k in range(4)] + [A]
    for prompt in prompts:
        toks = []
        for eng in (pe, je):
            eng.reset()
            toks.append(eng.generate(prompt, len(prompt) + N_NEW, sampler=None).tokens)
        cold.reset()
        assert toks[0] == toks[1] == cold.generate(prompt, len(prompt) + N_NEW).tokens
        assert _pool_state(pe.page_pool) == _pool_state(je.page_pool)
    assert pe.prefix_cache.counters == _jcounters(je.stats)
    assert pe.prefix_cache.counters["prefix_evictions"] >= 2
    je.close()


def test_pool_hooks_match_jax():
    """row_pages, retain, release (the double release clamped), share and
    ensure with a reclaim hook, op by op against the JAX pool."""
    held = {"p": [], "j": []}

    def reclaim(which, pool):
        def hook():
            if not held[which]:
                return False
            pool.release(held[which].pop(0))
            return True
        return hook

    p = ppaged.PagePool(6, 16, 2, 96)
    j = jpaged.PagePool(6, 16, 2, 96)
    p.reclaim, j.reclaim = reclaim("p", p), reclaim("j", j)
    for pool in (p, j):
        pool.ensure(0, 0, 64)
    assert p.row_pages(0, 4) == j.row_pages(0, 4)
    for which, pool in (("p", p), ("j", j)):
        pages = pool.row_pages(0, 2)
        pool.retain(pages)
        held[which].append(pages)
        pool.share(1, pages)
        pool.release_row(0)
        assert pool.ensure(1, 24, 40) == [(pages[1], pool.tables[1, 1])]
        pool.ensure(1, 40, 96)  # needs a page only a reclaim frees
    assert _pool_state(p) == _pool_state(j)
    with pytest.raises(ppaged.PagePoolExhausted):
        p.ensure(0, 0, 96)
    with pytest.raises(jpaged.PagePoolExhausted):
        j.ensure(0, 0, 96)
    assert _pool_state(p) == _pool_state(j)
    with pytest.raises(ValueError, match="unmapped"):
        p.row_pages(0, 1)
    p.release([0, 0])
    j.release([0, 0])
    assert _pool_state(p) == _pool_state(j) and p.double_releases >= 1


def test_gates_turn_the_cache_off_in_both_packages(path, tmp_path):
    """Contiguous int8, an sp = 2 mesh and a context too short for a bucket
    build no cache in either package; a budget of 0 neither."""
    assert _port(path, "contiguous", "int8", prefix_cache_mb=64).prefix_cache is None
    je = _jax(path, "contiguous", "int8", prefix_cache_mb=64)
    assert je.prefix_cache is None
    je.close()
    assert _port(path, prefix_cache_mb=0).prefix_cache is None
    short = str(tmp_path / "short.m")
    write_tiny_model(short, tiny_header(seq_len=24), seed=1)
    assert _port(short, prefix_cache_mb=64, max_chunk=8).prefix_cache is None
    je = _jax(short, prefix_cache_mb=64, max_chunk=8)
    assert je.prefix_cache is None
    je.close()
    from distributed_llama_tpu.parallel import make_mesh as jmake_mesh

    sp = str(tmp_path / "sp.m")
    write_tiny_model(sp, tiny_header(dim=128, hidden_dim=128, n_layers=2, n_heads=4,
                                     n_kv_heads=4, seq_len=256), seed=33)
    pe = InferenceEngine(sp, compute_dtype="float32", max_chunk=16, prefix_cache_mb=64,
                         mesh=make_mesh(sp=2, devices=["cpu"] * 2))
    assert pe.prefix_cache is None
    je = JEngine(sp, compute_dtype="float32", max_chunk=16, mesh=jmake_mesh(sp=2),
                 prefix_cache_mb=64, speculative="off", grammar=False)
    assert je.prefix_cache is None
    je.close()


@pytest.mark.parametrize("layout,kv", ARMS)
def test_engine_is_freed_without_a_collection(path, layout, kv):
    """The pool's reclaim hook makes no reference cycle: a dropped engine
    frees its caches, entries and graphs at once, not at a later garbage
    collection, which could run inside another engine's graph capture."""
    import gc
    import weakref

    eng = _port(path, layout, kv, prefix_cache_mb=64)
    eng.generate(A, len(A) + N_NEW, sampler=None)
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_env_budget_builds_a_library_cache(path, monkeypatch):
    monkeypatch.setenv("DLT_PREFIX_CACHE_MB", "3")
    assert _port(path).prefix_cache.budget_bytes == 3 << 20
    monkeypatch.delenv("DLT_PREFIX_CACHE_MB")
    assert _port(path).prefix_cache is None


@pytest.mark.parametrize("kv", [None, "int8"])
def test_static_decode_after_a_paged_share_equals_eager(path, kv):
    """The static-buffer decode step (`DecodeGraphs("cpu", capture=False)`)
    right after a hit maps shared pages: the table buffer is uploaded
    before the step, and tokens and logits equal the eager engine's."""
    runs = []
    for static in (False, True):
        eng = _port(path, "paged", kv, prefix_cache_mb=64, batch=2)
        if static:
            eng._graphs = DecodeGraphs("cpu", capture=False)
        out = []
        for prompt in (A, A, HEAD24):
            eng.reset()
            out.append(eng.generate(prompt, len(prompt) + N_NEW, sampler=None).tokens)
            out.append(eng.last_prefix_hit_tokens)
            out.append(eng.last_logits.clone())
        runs.append(out)
    assert runs[1][1::3] == [0, 32, 16]
    for got, want in zip(runs[1], runs[0]):
        assert torch.equal(got, want) if isinstance(got, torch.Tensor) else got == want


def test_warmup_leaves_the_cache_empty(path):
    eng = _port(path, "paged", prefix_cache_mb=64)
    eng.generate(A, len(A) + N_NEW, sampler=None)
    assert eng.prefix_cache.n_entries == 1
    eng.warmup()
    assert eng.prefix_cache.n_entries == 0 and not eng._in_warmup
    assert eng.page_pool.free_pages == eng.page_pool.n_pages
    eng.generate(A, len(A) + N_NEW, sampler=None)
    assert eng.last_prefix_hit_tokens == 0 and eng.prefix_cache.n_entries == 1


# -- the CLI -------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pfx_cli")
    mp, tp = str(d / "m.m"), str(d / "t.t")
    write_tiny_model(mp, tiny_header(dim=256, hidden_dim=512, n_layers=2, n_heads=4,
                                     n_kv_heads=2, vocab_size=512, seq_len=512), seed=5)
    write_tiny_tokenizer(tp, pad_to=512)
    return mp, tp


@pytest.mark.parametrize("flag,env,want_mb", [(None, None, 512), ("0", None, None),
                                              ("64", None, 64), (None, "32", 32),
                                              ("16", "32", 16)])
def test_cli_budget_equals_the_jax_cli(files, monkeypatch, flag, env, want_mb):
    mp, tp = files
    monkeypatch.setenv("DLT_GRAMMAR", "0")
    if env is None:
        monkeypatch.delenv("DLT_PREFIX_CACHE_MB", raising=False)
    else:
        monkeypatch.setenv("DLT_PREFIX_CACHE_MB", env)
    argv = ["inference", "--model", mp, "--tokenizer", tp]
    if flag is not None:
        argv += ["--prefix-cache-mb", flag]
    je = jcli.make_engine(jcli.build_arg_parser().parse_args(argv))
    pe = pcli.make_engine(pcli.build_arg_parser().parse_args(argv + ["--device", "cpu"]))
    budget = lambda e: None if e.prefix_cache is None else e.prefix_cache.budget_bytes
    assert budget(pe) == budget(je)
    assert budget(pe) == (None if want_mb is None else want_mb << 20)
    je.close()


def test_cli_warns_where_a_requested_cache_cannot_be_built(files, capsys):
    mp, tp = files
    pcli.make_engine(pcli.build_arg_parser().parse_args(
        ["inference", "--model", mp, "--tokenizer", tp, "--device", "cpu", "--kv-layout",
         "contiguous", "--kv-dtype", "int8"]))
    assert "prefix cache unavailable on this topology" in capsys.readouterr().out
    pcli.make_engine(pcli.build_arg_parser().parse_args(
        ["inference", "--model", mp, "--tokenizer", tp, "--device", "cpu",
         "--prefix-cache-mb", "64"]))
    assert "prefix cache unavailable" not in capsys.readouterr().out


def _pred_texts(out: str) -> list:
    return [line.split("|", 1)[1] for line in out.splitlines() if line.startswith("🔶 Pred")]


def test_cli_defaults_print_the_jax_cli_tokens(files, monkeypatch, capsys):
    """Both CLIs at their defaults (paged bf16, a 512 MB prefix cache), each
    with only `--speculative off`: the same greedy tokens."""
    mp, tp = files
    args = ["inference", "--model", mp, "--tokenizer", tp, "--prompt",
            "hello world, the brown fox jumps over the lazy dog", "--steps", "80",
            "--temperature", "0"]
    monkeypatch.setenv("DLT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DLT_GRAMMAR", "0")
    monkeypatch.delenv("DLT_PREFIX_CACHE_MB", raising=False)
    assert jcli.main(args + ["--speculative", "off"]) == 0
    want = _pred_texts(capsys.readouterr().out)
    assert pcli.main(args + ["--device", "cpu", "--speculative", "off"]) == 0
    out = capsys.readouterr().out
    assert want and _pred_texts(out) == want
    assert "prefix cache unavailable" not in out
