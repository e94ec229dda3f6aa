"""The port's graphed decode (runtime/graphs.py) on the CPU.

A CUDA graph captures and replays only on the card (tests/
test_torch_kernels_gpu.py holds graphed against eager there). Here the
graph cache runs without capture: each step is the capture-safe step
(device positions, the static page table, the device step counter) run
eagerly on the same static buffers, and each key registers once. That
step must give what the int-position eager path gives, tokens and logits
bit for bit; `warm_plan` must list the JAX engine's decode ladder; the
warm ladder must cover a pinned trace; the eager-only arms follow a rule
of shapes.
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu_torch.formats.mfile import ArchType
from distributed_llama_tpu_torch.parallel import make_mesh
from distributed_llama_tpu_torch.runtime.batch_session import BatchSession, Rows
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
from distributed_llama_tpu_torch.runtime.graphs import (
    DecodeGraphs, GraphKey, LaunchCounts, StepBuffers,
)
from distributed_llama_tpu_torch.runtime.paged_kv import DeviceTables, PagePool
from distributed_llama_tpu_torch.testing import tiny_header, write_tiny_model
from distributed_llama_tpu_torch.tokenizer import Sampler

torch.set_num_threads(1)

# decode runs from position 229 in 16-token chunks across the 256 bucket
PROMPT = [(7 * i) % 500 + 1 for i in range(230)]
N_DECODE = 40
MOE = dict(arch=ArchType.QWEN3_MOE, dim=256, hidden_dim=256, n_layers=2, n_heads=4,
           n_kv_heads=2, head_dim=64, n_experts=16, n_active_experts=2, moe_hidden_dim=256,
           vocab_size=512, seq_len=512)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("graphs") / "m.m")
    write_tiny_model(p, tiny_header(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                                    vocab_size=512, seq_len=512), seed=8)
    return p


@pytest.fixture(scope="module")
def moe_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("graphs_moe") / "m.m")
    write_tiny_model(p, tiny_header(**MOE), seed=3)
    return p


def _engine(path, static: bool, **kw):
    kw.setdefault("decode_chunk_size", 16)
    eng = InferenceEngine(path, device="cpu", **kw)
    if static:
        eng._graphs = DecodeGraphs("cpu", capture=False)
    return eng


def _runs(eng):
    """Greedy and sampled generations and the last decode step's logits of each."""
    greedy = eng.generate(PROMPT, len(PROMPT) + N_DECODE)
    g_logits = eng.last_logits.clone()
    eng.reset()
    sampled = eng.generate(PROMPT[:50], 50 + 24, sampler=Sampler(512, 0.8, 0.9, 7))
    return greedy.tokens, g_logits, sampled.tokens, eng.last_logits.clone()


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_static_step_equals_int_position_path(path, layout, kv_dtype, batch):
    kw = dict(kv_layout=layout, cache_dtype=kv_dtype, batch=batch)
    want = _runs(_engine(path, False, **kw))
    eng = _engine(path, True, **kw)
    got = _runs(eng)
    assert got[0] == want[0] and got[2] == want[2]
    assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
    # one decode graph a (kv bucket, sampler): 256 and 512 greedy, 256 sampled
    assert sum(k.kind == "decode" for k in eng._graphs.graphs) == 3
    assert eng._graphs.captures == len(eng._graphs.graphs)


@pytest.mark.parametrize("batch", [1, 3])
def test_static_full_distribution_arm_equals_eager(path, batch):
    """Sampling at top-p 1.0 takes the "full" arm's graph (no sort), with
    the eager path's tokens and logits; a BatchSession whose sampled rows
    all sample the full distribution takes it too."""
    def run(static):
        eng = _engine(path, static, batch=batch, kv_layout="paged")
        res = eng.generate(PROMPT[:50], 50 + 24, sampler=Sampler(512, 0.8, 1.0, 5))
        return res.tokens, eng.last_logits.clone(), eng

    want, want_logits, _ = run(False)
    got, got_logits, eng = run(True)
    assert got == want and torch.equal(got_logits, want_logits)
    assert {k.sampler for k in eng._graphs.graphs if k.kind == "decode"} == {"full"}
    if batch > 1:
        out = []
        for static in (False, True):
            eng = _engine(path, static, batch=batch)
            s = BatchSession(eng)
            s.admit(0, PROMPT[:30], temperature=0.7, topp=1.0, seed=1)
            s.admit(1, PROMPT[:40])  # greedy, at the default top-p 0.9
            out.append((s.step(8), eng.last_logits.clone(), eng))
        assert np.array_equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
        assert {k.sampler for k in out[1][2]._graphs.graphs
                if k.kind == "batch_decode"} == {"full"}


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_static_batch_session_equals_eager(path, layout):
    def run(static):
        eng = _engine(path, static, batch=4, kv_layout=layout, cache_dtype="int8")
        s = BatchSession(eng)
        for r in range(4):
            s.admit(r, PROMPT[: 20 + 30 * r], temperature=0.7 if r % 2 else 0.0, seed=r)
        toks = [s.step(8) for _ in range(3)]
        s.release(1)
        s.admit(1, PROMPT[:77])
        toks += [s.step(8) for _ in range(3)]
        return np.concatenate(toks, axis=1), eng.last_logits.clone(), eng

    want, want_logits, _ = run(False)
    got, got_logits, eng = run(True)
    assert np.array_equal(got, want) and torch.equal(got_logits, want_logits)
    assert all(k.kind in ("batch_decode", "prefill_row") and k.batch == 4
               for k in eng._graphs.graphs)


def test_static_generate_batch_equals_eager(path):
    prompts = [PROMPT[:30], PROMPT[:45], PROMPT[:12]]
    want = _engine(path, False, batch=3, kv_layout="paged").generate_batch(prompts, [20, 9, 14])
    eng = _engine(path, True, batch=3, kv_layout="paged")
    assert eng.generate_batch(prompts, [20, 9, 14]) == want
    assert {k.kind for k in eng._graphs.graphs} == {"prefill", "batch_decode"}
    sampler = Sampler(512, 0.8, 0.9, 11)
    want = _engine(path, False, batch=3).generate_batch(prompts, 12, sampler=sampler)
    assert _engine(path, True, batch=3).generate_batch(prompts, 12, sampler=sampler) == want


@pytest.mark.parametrize("decode_chunk_size", [64, 16, 5])
@pytest.mark.parametrize("batch,max_seq_len,layout", [
    (1, 0, "contiguous"), (4, 0, "paged"), (2, 300, "contiguous"), (1, 200, "paged"),
])
def test_warm_plan_matches_the_jax_decode_ladder(path, batch, max_seq_len, layout,
                                                 decode_chunk_size):
    kw = dict(batch=batch, max_seq_len=max_seq_len, kv_layout=layout,
              decode_chunk_size=decode_chunk_size)
    jeng = JEngine(path, speculative="off", prefix_cache_mb=0, grammar=False, **kw)
    want = [t for t in jeng.warm_plan()
            if t[0] in ("prefill", "decode", "prefill_row", "batch_decode")]
    eng = InferenceEngine(path, device="cpu", **kw)
    assert eng.warm_plan() == want
    assert eng._kv_buckets() == jeng._kv_buckets()


def test_warm_plan_without_device_decode_matches_jax(path):
    kw = dict(batch=4, device_decode=False)
    jeng = JEngine(path, speculative="off", prefix_cache_mb=0, grammar=False, **kw)
    want = [t for t in jeng.warm_plan()
            if t[0] in ("prefill", "decode", "prefill_row", "batch_decode")]
    assert InferenceEngine(path, device="cpu", **kw).warm_plan() == want
    assert {t[0] for t in want} == {"prefill", "decode"}


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_warmup_covers_the_pinned_trace(path, layout):
    """After warmup, a prompt whose decode crosses two kv buckets and a
    BatchSession admit/step/release cycle register no new key."""
    eng = _engine(path, True, batch=4, kv_layout=layout, cache_dtype="int8", max_seq_len=512)
    stats = eng.warmup()
    n_buckets = len(eng._kv_buckets())
    n_prefill = sum(k[0] in ("prefill", "prefill_row") for k in eng.warm_plan())
    # 2 decode kinds x 3 arms a bucket, and one graph a prefill key
    assert stats["sealed"] and stats["captures"] == 2 * 3 * n_buckets + n_prefill
    assert stats["recaptures_after_warmup"] == 0
    eng.generate(PROMPT, len(PROMPT) + 60, on_token=lambda t: None)  # 229 -> 289: 256, 512
    eng.generate(PROMPT[:40], 60, sampler=Sampler(512, 0.5, 0.9, 3))
    s = BatchSession(eng)
    s.admit(0, PROMPT[:100], temperature=0.5)
    s.admit(2, PROMPT[:200])
    s.step(8)
    s.step(64)
    s.release(0)
    s.step(16)
    assert eng.graph_stats()["recaptures_after_warmup"] == 0
    assert eng.graph_stats()["captures"] == stats["captures"]


def test_a_key_outside_the_ladder_counts_as_a_recapture(path):
    eng = _engine(path, True)
    eng.warmup()
    key = eng._graph_key("decode", 999, "greedy")
    assert key not in eng._graphs
    eng._step_buffers().pos.zero_()
    eng._run_graphed(eng._graphs, "decode", 2, 999, "greedy")
    assert eng.graph_stats()["recaptures_after_warmup"] == 1


def test_warmup_leaves_the_cache_as_reset_does(path):
    eng = _engine(path, True, kv_layout="contiguous")
    eng.warmup()
    assert all(not t.any() for t in eng.cache.tensors())
    paged = _engine(path, True, kv_layout="paged", batch=2)
    paged.page_pool.ensure(0, 0, 40)
    paged.warmup()
    assert paged.page_pool.used_pages == 0
    # the same tokens as an engine that never warmed
    assert paged.generate(PROMPT, len(PROMPT) + 20).tokens == \
        _engine(path, False, kv_layout="paged", batch=2).generate(PROMPT, len(PROMPT) + 20).tokens


def test_static_page_table_keeps_its_storage():
    pool = PagePool(n_pages=32, page_size=16, n_rows=3, seq_len=128)
    tables = DeviceTables(pool, "cpu")
    buf = tables.operand(pool)
    ptr = buf.data_ptr()
    assert buf.shape == (3, 8) and (buf == -1).all()
    pool.ensure(1, 0, 40)
    got = tables.operand(pool)
    assert got is buf and got.data_ptr() == ptr
    assert got.tolist() == pool.device_tables().tolist()
    # no upload while the version stands still
    buf[0, 0] = 99
    assert tables.operand(pool)[0, 0].item() == 99
    pool.release_row(1)
    assert tables.operand(pool).data_ptr() == ptr and (buf == -1).all()


def test_engine_page_table_operand_is_the_step_buffers_table(path):
    eng = _engine(path, True, kv_layout="paged", batch=2)
    ptr = eng._pt_operand().data_ptr()
    eng.generate(PROMPT[:40], 80)
    assert eng._pt_operand().data_ptr() == ptr == eng._step_buffers().table.data_ptr()


def test_graph_eligible_is_a_rule_of_shapes(path, moe_path):
    dense = InferenceEngine(path, device="cpu")
    assert dense.graph_eligible("decode") and dense.graph_eligible("batch_decode", 64)
    moe = InferenceEngine(moe_path, device="cpu")  # 16 experts, 2 active
    assert moe.graph_eligible("decode")
    assert moe.graph_eligible("batch_decode", 7)  # 14 rows: the small-row K4 arm
    # 16 rows: the grouped arm, K4 on the bf16 kernel path (captured) and
    # the plain arm in f32 (eager: it reads its group sizes back)
    assert moe.graph_eligible("batch_decode", 8) and moe.graph_eligible("decode", 16)
    moe32 = InferenceEngine(moe_path, device="cpu", compute_dtype="float32")
    assert moe32.graph_eligible("batch_decode", 7)  # 14 rows: the gather arm
    assert not moe32.graph_eligible("batch_decode", 8)
    assert not moe32.graph_eligible("decode", 16)
    assert not moe32.graph_eligible("prefill", 1, size=8)
    assert moe32.graph_eligible("prefill_row", 8, size=4)  # one row of 4 tokens
    mesh = InferenceEngine(path, mesh=make_mesh(sp=2, devices=["cpu"] * 2))
    assert not mesh.graph_eligible("decode") and not mesh.graph_eligible("batch_decode", 1)
    with pytest.raises(ValueError):
        dense.graph_eligible("prefix_copy")


def test_the_grouped_moe_arm_stays_eager(moe_path):
    """An f32 MoE engine at b * k >= E (the grouped plain arm, which reads
    its group sizes back) captures none of its steps, warmup included, and
    decodes as the eager engine does: warmup captures only the admission
    chunks of fewer than E / k tokens, which take the gather arm."""
    eng = _engine(moe_path, True, batch=8, compute_dtype="float32")
    assert eng.warmup()["captures"] == len(eng._graphs.graphs)
    assert {(k.kind, k.size) for k in eng._graphs.graphs} == {
        ("prefill_row", s) for s in (1, 2, 4)}
    prompts = [PROMPT[i : i + 9] for i in range(8)]
    got = eng.generate_batch(prompts, 6)
    assert eng.graph_stats()["recaptures_after_warmup"] == 0
    assert got == _engine(moe_path, False, batch=8,
                          compute_dtype="float32").generate_batch(prompts, 6)


def test_moe_batch_one_decode_is_graphed(moe_path):
    want = _runs(_engine(moe_path, False))
    eng = _engine(moe_path, True)
    got = _runs(eng)
    assert got[0] == want[0] and got[2] == want[2] and torch.equal(got[1], want[1])
    assert sum(k.kind == "decode" for k in eng._graphs.graphs) == 3


def test_cpu_engines_capture_nothing(path):
    eng = InferenceEngine(path, device="cpu", batch=2)
    assert eng.warmup()["captures"] == 0 and eng._graphs is None
    eng.generate(PROMPT[:20], 40)
    assert eng._graphs is None


def test_cuda_graphs_off_runs_eagerly(path):
    eng = _engine(path, True)
    eng.cuda_graphs = False
    eng.generate(PROMPT[:20], 40)
    assert eng._graphs.captures == 0


def test_launch_accounting():
    """A capture's launches are taken back and kept as the graph's; each
    replay adds them again."""
    def kernel():
        pass

    a, b = kernel, (lambda: None)
    a.launches, b.launches = 5, 2
    counts = LaunchCounts((a, b))
    before = counts.snapshot()
    a.launches += 3  # a capture runs the wrappers once
    b.launches += 1
    per_replay = counts.since(before)
    counts.restore(before)
    assert per_replay == (3, 1) and (a.launches, b.launches) == (5, 2)
    for _ in range(7):
        counts.add(per_replay)
    counts.add(per_replay, times=4)
    assert (a.launches, b.launches) == (5 + 11 * 3, 2 + 11)


def test_step_buffers():
    bufs = StepBuffers(batch=2, cap=4, device="cpu")
    bufs.load(Rows([7, 8], [10, 20], [1, 2], [0, 0], [0.0, 0.5], [0.9, 0.9]))
    assert bufs.seeds.tolist() == [1, 2] and bufs.temperature.tolist() == [0.0, 0.5]
    bufs.begin(3)
    for tok in ([1, 2], [3, 4], [5, 6]):
        bufs.advance(torch.tensor(tok))
    assert bufs.out[:, :3].tolist() == [[1, 3, 5], [2, 4, 6]]
    assert bufs.token.tolist() == [5, 6] and bufs.pos.tolist() == [13, 23]
    assert bufs.step.item() == 3
    bufs.begin(4)
    assert bufs.step.item() == 0
    with pytest.raises(ValueError):
        bufs.begin(5)


def test_graph_key_names_every_axis(path):
    eng = InferenceEngine(path, device="cpu", batch=2, kv_layout="paged", cache_dtype="int8")
    assert eng._graph_key("batch_decode", 512, "topp") == GraphKey(
        "batch_decode", 2, 512, "paged", "int8", "topp")
