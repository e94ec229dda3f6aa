"""Batched serving in the port: `generate_batch` and `BatchSession` against
solo runs (the cases of tests/test_batch_session.py and
tests/test_paged_kv.py that apply to one device), on the contiguous and
the paged layout, and the port's session against the JAX package's.

Rows equal their solo runs exactly on the f32 arm: every op of the
forward pass treats rows independently, and prefill takes the same
chunk ladder. Against the JAX package, bf16 with the Pallas kernels in
interpret mode (the int8 paged decode kernel among them), on a pinned
model seed: tokens equal (tests/test_torch_engine.py gives the near-tie
reason a seed is pinned).
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu.runtime.batch_session import BatchSession as JSession
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu.testing import tiny_header, write_tiny_model
from distributed_llama_tpu_torch.ops import sampling
from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine

torch.set_num_threads(1)

LAYOUTS = ["contiguous", "paged"]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("batch") / "m.m")
    write_tiny_model(p, tiny_header(dim=64, n_layers=2, vocab_size=128, seq_len=128), seed=31)
    return p


def _engine(path, layout, batch=2, **kw):
    kw.setdefault("compute_dtype", "float32")
    return InferenceEngine(path, batch=batch, max_chunk=8, kv_layout=layout, device="cpu",
                           decode_chunk_size=8, **kw)


_SOLO = {}


def _solo(path, prompt, n):
    key = (path, tuple(prompt), n)
    if key not in _SOLO:
        eng = InferenceEngine(path, compute_dtype="float32", max_chunk=8, device="cpu")
        _SOLO[key] = eng.generate(prompt, len(prompt) + n + 1).tokens[len(prompt):][:n]
    return _SOLO[key]


def _collect(host, row, out):
    out.extend(int(t) for t in host[row])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_generate_batch_rows_equal_solo(path, layout):
    prompts = [[5, 9, 17, 3, 8, 11, 2, 6, 4, 1], [7, 1], list(range(1, 21))]
    budgets = [12, 20, 6]
    eng = _engine(path, layout, batch=3)
    out = eng.generate_batch(prompts, budgets)
    for p, n, got in zip(prompts, budgets, out):
        assert got == _solo(path, p, n)


def test_generate_batch_finished_rows_past_seq_len(tmp_path):
    """A long prompt with a short budget rides the chunks of a short prompt
    with a long budget past seq_len: its writes land nowhere, and the
    long-budget row still equals its solo run."""
    p = str(tmp_path / "m.m")
    write_tiny_model(p, tiny_header(dim=64, n_layers=2, vocab_size=128, seq_len=48), seed=2)
    prompts = [list(range(1, 41)), [3, 4]]
    for layout in LAYOUTS:
        eng = InferenceEngine(p, compute_dtype="float32", batch=2, max_chunk=8, kv_layout=layout,
                              device="cpu", decode_chunk_size=8)
        out = eng.generate_batch(prompts, [4, 40])
        solo = InferenceEngine(p, compute_dtype="float32", max_chunk=8, device="cpu")
        assert out[0] == solo.generate(prompts[0], 44).tokens[40:44]
        solo.reset()
        assert out[1] == solo.generate(prompts[1], 42).tokens[2:42]


def test_generate_batch_stops_per_row(path):
    eng = _engine(path, "paged", batch=2)
    want = [_solo(path, [5, 9, 17, 3], 10), _solo(path, [7, 1], 10)]
    stop_at = want[0][3]
    out = eng.generate_batch([[5, 9, 17, 3], [7, 1]], 10, stop_fn=lambda r, t: r == 0 and t == stop_at)
    assert out[0] == want[0][: want[0].index(stop_at) + 1]
    assert out[1] == want[1]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_session_single_row_matches_solo(path, layout):
    prompt = [5, 9, 17, 3]
    s = BatchSession(_engine(path, layout))
    s.admit(0, prompt)
    got = []
    for _ in range(3):
        _collect(s.step(4), 0, got)
    assert got == _solo(path, prompt, 12)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_rolling_admission_mid_stream(path, layout):
    pa, pb = [5, 9, 17, 3], [7, 1]
    s = BatchSession(_engine(path, layout))
    s.admit(0, pa)
    got_a, got_b = [], []
    _collect(s.step(4), 0, got_a)
    s.admit(1, pb)
    for _ in range(2):
        h = s.step(4)
        _collect(h, 0, got_a)
        _collect(h, 1, got_b)
    assert got_a == _solo(path, pa, 12)
    assert got_b == _solo(path, pb, 8)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_release_and_readmit(path, layout):
    pa, pb, pc = [5, 9, 17, 3], [7, 1], [44, 2, 60]
    eng = _engine(path, layout)
    s = BatchSession(eng)
    s.admit(0, pa)
    s.admit(1, pb)
    got_a, got_b, got_c = [], [], []
    h = s.step(4)
    _collect(h, 0, got_a)
    _collect(h, 1, got_b)
    used = eng.page_pool.used_pages if eng.paged else 0
    s.release(1)
    if eng.paged:
        assert eng.page_pool.used_pages < used  # the row's pages went back
    assert 1 in s.free_rows() and s.active_rows() == [0]
    _collect(s.step(4), 0, got_a)
    s.admit(1, pc)
    for _ in range(2):
        h = s.step(4)
        _collect(h, 0, got_a)
        _collect(h, 1, got_c)
    assert got_a == _solo(path, pa, 16)
    assert got_b == _solo(path, pb, 4)
    assert got_c == _solo(path, pc, 8)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_parked_rows_preserve_cache_tail(path, layout):
    prompt = [5, 9, 17, 3]
    s = BatchSession(_engine(path, layout))
    s.admit(0, prompt)
    got = []
    _collect(s.step(4), 0, got)
    s.active[0] = False
    pos0, tok0 = int(s.pos[0]), int(s.token[0])
    s.pos[0] = s.seq_len
    s.admit(1, [7, 1])
    s.step(4)
    s.step(4)
    s.active[0] = True
    s.pos[0] = pos0
    s.token[0] = tok0
    for _ in range(2):
        _collect(s.step(4), 0, got)
    assert got == _solo(path, prompt, 12)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_interleaved_admission_token_identical(path, layout):
    pa = [5, 9, 17, 3]
    pb = [(i % 120) + 1 for i in range(30)]
    s = BatchSession(_engine(path, layout))
    s.admit(0, pa)
    got_a, got_b = [], []
    _collect(s.step(4), 0, got_a)
    s.begin_admit(1, pb)
    assert s.pending_rows() == [1] and 1 not in s.free_rows()
    remaining = len(pb) - 1
    while remaining:
        remaining = s.prefill_pending(1, 8)
        _collect(s.step(4), 0, got_a)
    assert s.active[1] and s.pending_rows() == []
    for _ in range(2):
        h = s.step(4)
        _collect(h, 0, got_a)
        _collect(h, 1, got_b)
    assert got_a == _solo(path, pa, len(got_a))
    assert got_b == _solo(path, pb, 8)


def test_prefill_pending_budget_exact_and_odd_boundaries(path):
    pb = [(i % 120) + 1 for i in range(20)]  # 19 prefill tokens
    s = BatchSession(_engine(path, "paged"))
    s.begin_admit(1, pb)
    assert s.prefill_pending(1, 5) == 14  # exactly 5, not a whole chunk
    assert s.prefill_pending(1, 6) == 8
    while s.prefill_pending(1, 6):
        pass
    got = []
    for _ in range(2):
        _collect(s.step(4), 1, got)
    assert got == _solo(path, pb, 8)


def test_release_mid_prefill_clears_pending(path):
    s = BatchSession(_engine(path, "paged"))
    s.begin_admit(1, [(i % 120) + 1 for i in range(20)])
    s.prefill_pending(1, 8)
    s.release(1)
    assert s.pending_rows() == [] and 1 in s.free_rows()
    s.admit(1, [7, 1])
    got = []
    for _ in range(2):
        _collect(s.step(4), 1, got)
    assert got == _solo(path, [7, 1], 8)


def test_admission_errors(tmp_path):
    p = str(tmp_path / "m.m")
    write_tiny_model(p, tiny_header(dim=64, n_layers=2, vocab_size=128, seq_len=32), seed=31)
    s = BatchSession(_engine(p, "paged"))
    s.begin_admit(0, [5, 9, 17])
    with pytest.raises(ValueError, match="pending admission"):
        s.begin_admit(0, [7, 1])
    with pytest.raises(ValueError, match="empty"):
        s.begin_admit(1, [])
    with pytest.raises(ValueError, match="context window"):
        s.begin_admit(1, list(range(1, 33)))
    s.prefill_pending(0)
    with pytest.raises(ValueError, match="still active"):
        s.admit(0, [1, 2])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_step_overrunning_seq_len_raises(tmp_path, layout):
    p = str(tmp_path / "m.m")
    write_tiny_model(p, tiny_header(dim=64, n_layers=2, vocab_size=128, seq_len=32), seed=31)
    s = BatchSession(_engine(p, layout))
    s.admit(0, [5, 9, 17, 3])
    for _ in range(3):
        s.step(8)  # pos 3 -> 27
    with pytest.raises(ValueError, match="overrun seq_len"):
        s.step(8)  # 27 + 1 + 8 > 32


def test_seeded_stream_independent_of_cobatch(path):
    prompt = [5, 9, 17]
    s = BatchSession(_engine(path, "paged"))
    s.admit(0, prompt, temperature=0.8, topp=0.9, seed=123456)
    alone = []
    for _ in range(2):
        _collect(s.step(4), 0, alone)
    s2 = BatchSession(_engine(path, "contiguous", batch=3))
    s2.admit(2, [7, 1, 2, 9], temperature=0.3, topp=0.5)
    s2.admit(1, prompt, temperature=0.8, topp=0.9, seed=123456)
    s2.admit(0, [9, 9, 9], temperature=1.2, topp=1.0, seed=5)
    shared = []
    for _ in range(2):
        _collect(s2.step(4), 1, shared)
    assert shared == alone
    # another seed draws another stream
    s3 = BatchSession(_engine(path, "paged"))
    s3.admit(0, prompt, temperature=0.8, topp=0.9, seed=654321)
    other = []
    for _ in range(2):
        _collect(s3.step(4), 0, other)
    assert other != alone


def test_mixed_temperature_rows_one_chunk(path):
    prompt = [5, 9, 17, 3]
    s = BatchSession(_engine(path, "paged"))
    s.admit(0, prompt, temperature=0.0)
    s.admit(1, [7, 1], temperature=0.9, topp=0.8)
    got = []
    for _ in range(2):
        _collect(s.step(4), 0, got)
    assert got == _solo(path, prompt, 8)


def test_row_coins_depend_on_seed_and_count_only():
    seeds = torch.tensor([1, 2, 1, (7 << 40) + 3])
    counts = torch.tensor([0, 0, 5, 9])
    c = sampling.row_coins(seeds, counts)
    assert c.shape == (4, 1) and ((c >= 0) & (c < 1)).all()
    one = sampling.row_coins(seeds[2:3], counts[2:3])
    assert one.item() == c[2].item()
    assert c[0].item() != c[2].item() != c[1].item()
    draws = sampling.row_coins(torch.full((4096,), 99), torch.arange(4096))
    assert abs(draws.mean().item() - 0.5) < 0.02  # roughly uniform


def test_per_row_sampling_arms():
    logits = torch.tensor([[0.0, 3.0, 1.0, 3.0], [5.0, 0.0, 0.0, 0.0], [0.0, 0.0, 9.0, 0.0]])
    temp = torch.tensor([0.0, 1.0, 1.0])
    topp = torch.tensor([0.9, 0.5, 1.0])
    coin = torch.tensor([[0.99], [0.99], [0.0]])
    out = sampling.sample_logits_per_row(logits, coin, temp, topp)
    # greedy takes the first maximum; the top-p row keeps only token 0; the
    # full-distribution row's coin 0 picks the first token with mass
    assert out.tolist() == [1, 0, 0]


def test_moe_batch_rows_equal_solo(tmp_path):
    """Tiny Qwen3-MoE (E = 16, k = 2) at batch 3: prefill chunks take the
    grouped arm, batched decode (b * k = 6 < E) the gather arm."""
    from distributed_llama_tpu.formats.mfile import ArchType

    p = str(tmp_path / "moe.m")
    write_tiny_model(p, tiny_header(arch=ArchType.QWEN3_MOE, dim=256, hidden_dim=256, n_layers=2,
                                    n_heads=4, n_kv_heads=2, head_dim=64, n_experts=16,
                                    n_active_experts=2, moe_hidden_dim=256, vocab_size=512,
                                    seq_len=128), seed=4)
    prompts = [[(5 * i) % 500 + 1 for i in range(n)] for n in (9, 3, 14)]
    eng = InferenceEngine(p, compute_dtype="float32", batch=3, max_chunk=8, kv_layout="paged",
                          device="cpu", decode_chunk_size=8)
    out = eng.generate_batch(prompts, 8)
    solo = InferenceEngine(p, compute_dtype="float32", max_chunk=8, device="cpu")
    for pr, got in zip(prompts, out):
        solo.reset()
        assert got == solo.generate(pr, len(pr) + 8).tokens[len(pr) : len(pr) + 8]


def test_session_matches_interpret_mode_jax(tmp_path, monkeypatch):
    """The port's paged int8 session against the JAX package's, bf16, the
    Pallas kernels in interpret mode: the same rolling admission and
    release, the same greedy tokens."""
    p = str(tmp_path / "m.m")
    write_tiny_model(p, tiny_header(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                                    vocab_size=512, seq_len=256), seed=0)
    monkeypatch.setenv("DLT_PALLAS_INTERPRET", "1")
    je = JEngine(p, batch=2, max_chunk=8, kv_layout="paged", cache_dtype="int8",
                 speculative="off", prefix_cache_mb=0, grammar=False)
    pe = InferenceEngine(p, batch=2, max_chunk=8, kv_layout="paged", cache_dtype="int8",
                         device="cpu")
    pa, pb, pc = [(7 * i) % 500 + 1 for i in range(20)], [3, 1, 4, 1, 5], [9, 2, 6]
    outs = []
    for sess in (JSession(je), BatchSession(pe)):
        got = []

        def step():  # the active rows' tokens; parked rows' are junk
            rows = sess.active_rows()
            got.extend(np.asarray(sess.step(8))[r].tolist() for r in rows)

        sess.admit(0, pa)
        step()
        sess.admit(1, pb)
        step()
        sess.release(0)
        sess.admit(0, pc)
        step()
        outs.append(got)
    assert outs[0] == outs[1]
