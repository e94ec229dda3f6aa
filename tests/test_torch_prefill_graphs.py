"""The port's compiled prefill on the CPU: prefill and admission chunks on
the static buffers (runtime/graphs.py "prefill", "prefill_row"), K3 at a
device position with its shape-only plan, the pipelined chunk loop, and
the prefill overlap probe, against the port's eager path and the JAX
package.

A CUDA graph captures and replays only on the card (chip_smoke.py phase 5j
holds graphed against eager there). Here the graph cache runs without
capture: each chunk is the capture-safe step (the chunk's tokens, position
and row in one device operand, the static page tables) run eagerly on the
static buffers, and each key registers once. That step must write the KV
cache the int-position eager path writes, bit for bit, and the decode that
follows must give the same tokens and logits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.ops import pallas_attention as jpa
from distributed_llama_tpu.runtime import profiling as jprof
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu_torch.ops import cuda_attention as pca
from distributed_llama_tpu_torch.runtime import profiling as pprof
from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
from distributed_llama_tpu_torch.runtime.graphs import KINDS, DecodeGraphs, StepBuffers
from distributed_llama_tpu_torch.testing import tiny_header, write_tiny_model

torch.set_num_threads(1)

# 299 prefill tokens: nine 32-row chunks and an 11-token tail padded to
# 16 rows, across the 256 kv bucket
PROMPT = [(7 * i) % 500 + 1 for i in range(300)]
N_DECODE = 12
LAYOUTS = [("contiguous", None), ("contiguous", "int8"), ("paged", None), ("paged", "int8")]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("prefill_graphs") / "m.m")
    write_tiny_model(p, tiny_header(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                                    vocab_size=512, seq_len=512), seed=8)
    return p


def _engine(path, static: bool, **kw):
    kw.setdefault("decode_chunk_size", 16)
    eng = InferenceEngine(path, device="cpu", **kw)
    if static:
        eng._graphs = DecodeGraphs("cpu", capture=False)
    return eng


def _kv(eng) -> list:
    return [t.clone() for t in eng._cache_tensors()]


def _solo(eng, prompt=PROMPT):
    """`prompt[:-1]` prefilled in every row: the cache's bytes, then greedy
    decode's tokens and last logits."""
    eng.prefill(prompt[:-1])
    kv = _kv(eng)
    tok = torch.tensor([prompt[-1]] * eng.batch)
    toks, _ = eng._decode_chunk(tok, len(prompt) - 1, N_DECODE)
    return kv, toks, eng.last_logits.clone()


def _assert_same(got, want):
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0])), "KV cache bytes differ"
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,kv", LAYOUTS)
def test_static_prefill_equals_eager(path, layout, kv, dtype, batch):
    kw = dict(kv_layout=layout, cache_dtype=kv, compute_dtype=dtype, batch=batch)
    want = _solo(_engine(path, False, **kw))
    eng = _engine(path, True, **kw)
    got = _solo(eng)
    _assert_same(got, want)
    keys = {(k.kind, k.size, k.kv_bucket) for k in eng._graphs.graphs if k.kind == "prefill"}
    assert keys == {("prefill", 32, 256), ("prefill", 32, 512), ("prefill", 16, 512)}


@pytest.mark.parametrize("layout,kv", LAYOUTS)
def test_static_admission_equals_eager(path, layout, kv):
    """A BatchSession's admission chunks ("prefill_row": one row alone, the
    row a device operand, one graph for every row) write the rows' KV as
    the eager per-row path does; the session's chunks then agree."""
    prompts = [PROMPT[:40], PROMPT[5:120], PROMPT[:7], PROMPT[50:300]]

    def run(static):
        eng = _engine(path, static, batch=4, kv_layout=layout, cache_dtype=kv)
        s = BatchSession(eng)
        for r in (2, 0, 3, 1):
            s.admit(r, prompts[r])
        kv_ = _kv(eng)
        return kv_, torch.as_tensor(s.step(8)), eng.last_logits.clone(), eng

    *want, _ = run(False)
    *got, eng = run(True)
    _assert_same(got, want)
    rows = {k for k in eng._graphs.graphs if k.kind == "prefill_row"}
    # one key a (chunk size, kv bucket), whichever rows it served
    assert len(rows) == len({(k.size, k.kv_bucket) for k in rows}) == 2  # 32 and 8 rows
    assert all(k.batch == 4 for k in rows)


def test_static_generate_batch_prefill_equals_eager(path):
    prompts = [PROMPT[:30], PROMPT[:45], PROMPT[:12]]
    want_eng = _engine(path, False, batch=3, kv_layout="paged")
    want = want_eng.generate_batch(prompts, [20, 9, 14])
    eng = _engine(path, True, batch=3, kv_layout="paged")
    assert eng.generate_batch(prompts, [20, 9, 14]) == want
    assert torch.equal(eng.last_logits, want_eng.last_logits)
    assert any(k.kind == "prefill" and k.batch == 3 for k in eng._graphs.graphs)


def test_prefill_operand_layout(path):
    """A chunk's one host operand (tokens, position, row) and its views on
    the static buffer."""
    eng = _engine(path, True, batch=2)
    host = eng._chunk_operand([[1, 2, 3, 4], [5, 6, 7, 8]], 40, 1)
    assert host.tolist() == [1, 2, 3, 4, 5, 6, 7, 8, 40, 1]
    bufs = StepBuffers(2, 8, "cpu")
    io = bufs.prefill(4)
    assert io.shape == (10,) and bufs.prefill(4) is io
    io.copy_(torch.from_numpy(host))
    toks, pos, row = StepBuffers.prefill_views(io, 4)
    assert toks.tolist() == [[1, 2, 3, 4], [5, 6, 7, 8]] and pos.ndim == 0 and int(pos) == 40
    assert row.tolist() == [1] and toks.data_ptr() == io.data_ptr()
    one = bufs.prefill(4, row=True)
    assert one.shape == (6,) and one is not io
    assert "prefill" in KINDS and "prefill_row" in KINDS


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_pipelined_and_serial_arms_are_equal(path, layout):
    """`_pipelined_chunks`: the pipelined arm and the serial arm run the
    same chunks on the same operands, prefill and generate_batch."""
    got = []
    for pipelined in (True, False):
        eng = _engine(path, True, kv_layout=layout, prefill_pipelined=pipelined, batch=2)
        solo = _solo(eng)
        eng.reset()
        batch = eng.generate_batch([PROMPT[:77], PROMPT[3:40]], 10)
        got.append((solo, batch, eng.last_prefill_timing["n_chunks"]))
    _assert_same(got[0][0], got[1][0])
    assert got[0][1] == got[1][1] and got[0][2] == got[1][2] == 10


def test_pipelined_chunks_order_and_env(path, monkeypatch):
    eng = _engine(path, False)
    assert eng.prefill_pipelined
    seen = []
    for pipelined in (True, False):
        eng.prefill_pipelined = pipelined
        out = eng._pipelined_chunks(4, lambda i: i * 10, lambda i, op: seen.append((i, op)) or op)
        assert out == 30
    assert seen == [(i, i * 10) for i in range(4)] * 2
    monkeypatch.setenv("DLT_PREFILL_PIPELINE", "0")
    assert not _engine(path, False).prefill_pipelined
    monkeypatch.setenv("DLT_PREFILL_PIPELINE", "1")
    assert _engine(path, False).prefill_pipelined


def test_prefill_matches_the_jax_engine(path, monkeypatch):
    """The port's prefill on the static path against the JAX engine's (its
    Pallas kernels in interpret mode, the same bf16 arm): the first decode
    logits after the 299-token prefill within 5% of their scale (one bf16
    rounding step moves them ~1%); greedy tokens equal over 72 steps from
    tests/test_torch_engine.py's pinned prompt on its pinned model (its
    docstring gives the bf16 roundings that part other seeds at a
    near-tie)."""
    monkeypatch.setenv("DLT_PALLAS_INTERPRET", "1")
    je = JEngine(path, decode_chunk_size=16, kv_layout="contiguous", speculative="off",
                 prefix_cache_mb=0, grammar=False)
    pe = _engine(path, True)
    je.prefill(PROMPT[:-1])
    pe.prefill(PROMPT[:-1])
    jl = je.decode_one(PROMPT[-1], len(PROMPT) - 1)
    pl = pe.decode_one(PROMPT[-1], len(PROMPT) - 1)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=5e-2 * float(np.abs(jl).max()))
    pinned = [(7 * i) % 500 + 1 for i in range(230)]
    steps = len(pinned) - 1 + 72
    je.reset()
    pe.reset()
    want = je.generate(pinned, steps, sampler=None).tokens
    assert pe.generate(pinned, steps, sampler=None).tokens == want
    assert any(k.kind == "prefill" for k in pe._graphs.graphs)


@pytest.mark.parametrize("batch", [1, 3])
def test_warm_plan_lists_the_jax_prefill_keys(path, batch):
    kw = dict(batch=batch, max_seq_len=512, kv_layout="paged", decode_chunk_size=16)
    jeng = JEngine(path, speculative="off", prefix_cache_mb=0, grammar=False, **kw)
    kinds = ("prefill", "prefill_row")
    want = [t for t in jeng.warm_plan() if t[0] in kinds]
    got = [t for t in InferenceEngine(path, device="cpu", **kw).warm_plan() if t[0] in kinds]
    assert got == want and ({t[0] for t in got} == set(kinds)) == (batch > 1)


def test_warmup_captures_the_prefill_ladder(path):
    """warmup() registers every prefill and prefill_row key of the ladder;
    prompts across both kv buckets, a generate_batch and admissions then
    register none."""
    eng = _engine(path, True, batch=2, kv_layout="paged", cache_dtype="int8")
    eng.warmup()
    plan = {k for k in eng.warm_plan() if k[0].startswith("prefill")}
    got = {(k.kind, k.size, k.kv_bucket) for k in eng._graphs.graphs
           if k.kind.startswith("prefill")}
    assert got == plan
    for n in (20, 250, 300):
        eng.reset()
        eng.generate(PROMPT[:n], n + 8)
    eng.generate_batch([PROMPT[:100], PROMPT[:290]], 8)
    s = BatchSession(eng)
    s.admit(0, PROMPT[:33])
    s.admit(1, PROMPT[:261])
    s.step(4)
    assert eng.graph_stats()["recaptures_after_warmup"] == 0


def _att(t, S, g, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, t, 2 * g, hd)).astype(np.float32)
    kv = [jnp.asarray(rng.standard_normal((1, S, 2, hd)).astype(np.float32), jnp.bfloat16)
          for _ in range(2)]
    return q, kv, [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in kv]


@pytest.mark.parametrize("hd,g", [(64, 4), (128, 2)])
@pytest.mark.parametrize("t,pos", [(8, 0), (9, 300), (32, 480), (32, 992)])
def test_k3_plain_at_a_device_position_matches_pallas(hd, g, t, pos):
    """K3's plain version at a 0-d position tensor, inside one 1,024-row
    bucket, against flash_attention(interpret=True) at the same scalar: the
    same blocking, f32 sums in another order, which can flip P's bf16
    rounding (tests/test_torch_kernel_plans.py `_held_to_pallas`: 5e-3 of
    the scale, never above 1e-2); the int position gives the same bits."""
    S = 1024
    q, (kj, vj), (kt, vt) = _att(t, S, g, hd, seed=t + pos + hd)
    want = np.asarray(jpa.flash_attention(jnp.asarray(q), kj, vj, jnp.int32(pos), interpret=True))
    qt = torch.from_numpy(q)
    got = pca.flash_attention(qt, kt, vt, torch.tensor(pos, dtype=torch.int64))
    bound = min(1e-2, 5e-3 * float(np.abs(want).max()))
    assert np.abs(got.numpy() - want).max() <= bound
    assert torch.equal(got, pca.flash_attention(qt, kt, vt, pos))


@pytest.mark.parametrize("t,n_heads,n_kv,hd", [(8, 32, 8, 64), (9, 32, 8, 64), (32, 32, 4, 128)])
@pytest.mark.parametrize("S", [256, 1024, 4096])
def test_k3_plan_is_independent_of_the_position(monkeypatch, t, n_heads, n_kv, hd, S):
    """The plan the wrapper hands K3 is the view's alone: the int entry at
    every position and the device entry launch the same splits, covering
    every tile of the view."""
    q = torch.zeros((1, t, n_heads, hd))
    kv = torch.zeros((1, S, n_kv, hd), dtype=torch.bfloat16)
    calls = []
    monkeypatch.setattr(pca.kernels, "load", lambda name, sig: name)
    monkeypatch.setattr(pca.kernels, "launch", lambda lib, fn, x, *args: calls.append((fn, args)))
    for pos in (0, 5, S // 2, S - t):
        pca._launch(q, kv, kv, pos, 0.125)
    pca._launch(q, kv, kv, torch.tensor(7, dtype=torch.int64), 0.125)
    plan = pca.plan_for(q, kv)
    assert plan.split_tiles * plan.splits >= S // pca.FLASH_TILE
    assert [fn for fn, _ in calls] == ["flash_attention_fwd"] * 4 + ["flash_attention_fwd_dev"]
    for fn, args in calls:
        # the device entry takes (ptr, is_i64, row ptr, cache rows)
        at = 16 if fn == "flash_attention_fwd" else 19
        assert args[at:at + 2] == (plan.split_tiles, plan.splits)
        assert all((p is not None) == (plan.splits > 1) for p in args[-3:])


def test_k3_device_position_is_checked():
    q = torch.zeros((1, 8, 8, 64))
    kv = torch.zeros((1, 256, 2, 64), dtype=torch.bfloat16)
    for bad in (torch.zeros((2,), dtype=torch.int64), torch.zeros((), dtype=torch.float32)):
        with pytest.raises(ValueError, match="device position"):
            pca._check_device_position(bad, q)
    pca._check_device_position(torch.zeros((), dtype=torch.int32), q)
    assert pca.flash_attention_plain(q, kv, kv, torch.tensor(3)).shape == q.shape


def test_k3_device_row_reads_one_cache_row(monkeypatch):
    """A one-row q may name its cache row on the device (a graphed
    admission chunk of a contiguous cache): the plain version reads that
    row, as a view of it would; the launch hands K3 the row's pointer and
    the cache's row count, at the one-row plan; a row needs a device
    position and a one-row q."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((1, 32, 8, 64), generator=gen)
    k = torch.randn((4, 256, 2, 64), generator=gen).to(torch.bfloat16)
    v = torch.randn((4, 256, 2, 64), generator=gen).to(torch.bfloat16)
    pos = torch.tensor(100)
    row = torch.tensor([2])
    got = pca.flash_attention(q, k, v, pos, row=row)
    assert torch.equal(got, pca.flash_attention(q, k[2:3], v[2:3], pos))
    calls = []
    monkeypatch.setattr(pca.kernels, "load", lambda name, sig: name)
    monkeypatch.setattr(pca.kernels, "launch", lambda lib, fn, x, *args: calls.append((fn, args)))
    pca._launch(q, k, v, pos, 0.125, row)
    (fn, args), = calls
    plan = pca.plan_for(q, k[:1])
    assert fn == "flash_attention_fwd_dev" and args[8] == 1
    assert args[16:18] == (row.data_ptr(), 4) and args[19:21] == (plan.split_tiles, plan.splits)
    with pytest.raises(ValueError, match="device position"):
        pca._launch(q, k, v, 100, 0.125, row)
    with pytest.raises(ValueError, match="one-row q"):
        pca.flash_attention(q.expand(2, -1, -1, -1), k, v, pos, row=row)
    with pytest.raises(ValueError, match="int64"):
        pca.flash_attention(q, k, v, pos, row=row.to(torch.int32))


def test_prefill_overlap_probe_keys_match_jax(path):
    """The probe's arms carry the JAX probe's keys, from the same sources
    (`last_prefill_timing`, the prefill_dispatch series)."""
    want = jprof.prefill_overlap_probe(path, 40, reps=1, max_chunk=16, compute_dtype="float32")
    got = pprof.prefill_overlap_probe(path, 40, reps=1, max_chunk=16, compute_dtype="float32",
                                      device="cpu")
    assert [a["pipelined"] for a in got] == [a["pipelined"] for a in want] == [True, False]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["n_chunks"] == w["n_chunks"] == 3 and g["n_tokens"] == 40
        assert g["dispatch_series"].keys() == w["dispatch_series"].keys()
