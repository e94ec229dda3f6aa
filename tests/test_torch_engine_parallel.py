"""The port's engine on a mesh against the JAX engine's and its own single
device, on the CPU.

Twins of tests/test_engine_parallel.py (the pp, tp, tp x pp, sp and dp
engines, the microbatched prefill, generate_batch on tp2, tp2 x pp2 and
dp2 x tp2 against solo runs, the fused-kernel case of :127), tests/test_batch_session.py:149
(BatchSession on tp2), tests/test_prefix_cache.py:379 (a prefix hit on
pp2), tests/test_kv_quant.py:314 (int8 on a mesh warns and falls back) and
tests/test_kv_transport.py:157-198 (the mesh-paged token identity and the
topology refusals); the CLI, the server and the cost table on a mesh are
in test_torch_mesh_cli.py. f32 greedy throughout, where the port's mesh engines give the
JAX mesh engines' tokens and the port's single device's; the port's pp
and dp meshes give its single device's logits bit for bit.
"""


import numpy as np
import pytest
import torch

from distributed_llama_tpu.parallel import make_mesh as j_make_mesh
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu.testing import tiny_header, write_tiny_model
from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40
from distributed_llama_tpu_torch.parallel import make_mesh
from distributed_llama_tpu_torch.parallel.pipeline import COUNTS
from distributed_llama_tpu_torch.parallel.sharding import MeshKV, MeshParams
from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine

torch.set_num_threads(1)

PROMPT = [3, 17, 99, 4, 56, 23, 8, 41, 77, 5]


def _cpu_mesh(**shape):
    return make_mesh(**shape, devices=["cpu"] * int(np.prod(list(shape.values()))))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """tests/test_engine_parallel.py's model, with room for 32-token chunks."""
    path = str(tmp_path_factory.mktemp("ep") / "m.m")
    write_tiny_model(path, tiny_header(dim=128, hidden_dim=128, n_layers=4, n_heads=4,
                                       n_kv_heads=4, seq_len=256), seed=21)
    return path


def _engine(path, **kw):
    kw.setdefault("compute_dtype", "float32")
    kw.setdefault("max_chunk", 8)
    if "mesh" not in kw:
        kw["device"] = "cpu"
    return InferenceEngine(path, **kw)


def _solo_tokens(path, prompt, steps, **kw):
    e = _engine(path, **kw)
    try:
        return e.generate(prompt, steps, sampler=None).tokens
    finally:
        e.close()


def _solo_new(path, prompt, n, **kw):
    """The n tokens a single-device greedy `generate` adds to `prompt`."""
    return _solo_tokens(path, prompt, len(prompt) + n - 1, **kw)[len(prompt):]


# (mesh, against the JAX mesh engine too): the sp and tp 4 meshes are held
# to JAX's in tests/test_torch_sequence_parallel.py and test_torch_pipeline.py
MESHES = [(dict(pp=2), True), (dict(tp=2), True), (dict(tp=2, pp=2), True), (dict(dp=2), True),
          (dict(tp=4), False), (dict(sp=2), False)]


@pytest.mark.parametrize("shape,vs_jax", MESHES,
                         ids=["x".join(f"{k}{v}" for k, v in s.items()) for s, _ in MESHES])
def test_engine_mesh_matches_solo_and_jax(model, shape, vs_jax):
    """tests/test_engine_parallel.py :20, :33, :80, :91: the mesh engine's
    greedy tokens equal the single device's and the JAX mesh engine's; its
    weights and cache are shards on the mesh (MeshParams / MeshKV)."""
    batch = shape.get("dp", 1)
    kw = dict(batch=batch, decode_chunk_size=8)
    want = _solo_tokens(model, PROMPT, 32, **kw)
    eng = _engine(model, mesh=_cpu_mesh(**shape), **kw)
    assert eng.use_pipeline and isinstance(eng.params, MeshParams)
    assert isinstance(eng.cache, MeshKV) and len(eng.cache) == eng.mesh.size // eng.mesh.ep
    got = eng.generate(PROMPT, 32, sampler=None).tokens
    assert got == want
    assert "mesh " in eng.memory_report()
    if vs_jax:
        je = JEngine(model, compute_dtype="float32", max_chunk=8, mesh=j_make_mesh(**shape),
                     speculative="off", prefix_cache_mb=0, grammar=False,
                     kv_layout="contiguous", **kw)
        assert got == je.generate(PROMPT, 32, sampler=None).tokens
    eng.close()
    assert eng.params is None and eng.cache is None


def test_engine_pp_prefill_microbatches_bit_for_bit(model):
    """tests/test_engine_parallel.py:50: 32-token chunks run in pp
    microbatches (two hand-offs a chunk at pp 2), and the pp engine's prefill
    and decode logits equal the single device's bit for bit."""
    prompt = [(7 * i) % 200 + 1 for i in range(70)]
    solo = _engine(model, max_chunk=32)
    eng = _engine(model, max_chunk=32, mesh=_cpu_mesh(pp=2))
    COUNTS.reset()
    eng.prefill(prompt[:-1])
    assert COUNTS.pp_handoff == 2 * 2 + 1 * 1  # chunks of 32, 32 (2 microbatches) and 8 (1)
    solo.prefill(prompt[:-1])
    np.testing.assert_array_equal(eng.decode_one(prompt[-1], 69), solo.decode_one(prompt[-1], 69))
    np.testing.assert_array_equal(eng.forward_tokens(prompt[:32], 0, "all"),
                                  solo.forward_tokens(prompt[:32], 0, "all"))


@pytest.mark.parametrize("shape,batch", [(dict(tp=2), 2), (dict(tp=2, pp=2), 2),
                                         (dict(dp=2, tp=2), 4)],
                         ids=["tp2", "tp2xpp2", "dp2xtp2"])
def test_generate_batch_mesh_matches_solo(model, shape, batch):
    """tests/test_engine_parallel.py:190, :210, :229: each row of a mesh
    generate_batch equals its solo run."""
    prompts = [PROMPT[: 3 + 2 * r] for r in range(batch)]
    budgets = [12, 9, 7, 10][:batch]
    eng = _engine(model, mesh=_cpu_mesh(**shape), batch=batch)
    got = eng.generate_batch(prompts, budgets)
    for r in range(batch):
        assert got[r] == _solo_new(model, prompts[r], budgets[r]), r


def test_tp_engine_reaches_the_kernel_wrappers(tmp_path, monkeypatch):
    """tests/test_engine_parallel.py:127: at bf16 on a tp = 4 mesh every
    shard's matmuls and prefill attention reach the kernel wrappers (K1,
    K2, K3; on the CPU their plain versions), and the greedy tokens stay
    within the bf16 bound of the single device's logits."""
    path = str(tmp_path / "wide.m")
    write_tiny_model(path, tiny_header(dim=1024, hidden_dim=1024, n_layers=2, n_heads=8,
                                       n_kv_heads=4, seq_len=256), seed=22)
    calls = {}
    for mod, names in ((cuda_q40, ("q40_gemv_q80_stacked", "q40_gemm_bf16_stacked",
                                   "q40_gemm_bf16", "q40_gemv_q80")),
                       (cuda_attention, ("flash_attention",))):
        for name in names:
            orig = getattr(mod, name)

            def spy(*a, _orig=orig, _name=name, **kw):
                calls[(_name, tuple(a[0].shape[-1:]))] = calls.get(
                    (_name, tuple(a[0].shape[-1:])), 0) + 1
                return _orig(*a, **kw)

            monkeypatch.setattr(mod, name, spy)
    from distributed_llama_tpu_torch.models import transformer

    monkeypatch.setattr(transformer, "flash_attention", cuda_attention.flash_attention)
    eng = InferenceEngine(path, compute_dtype="bfloat16", max_chunk=16, mesh=_cpu_mesh(tp=4))
    eng.prefill(PROMPT * 3)
    got = eng.decode_one(5, 30)
    names = {n for n, _ in calls}
    assert {"q40_gemv_q80_stacked", "q40_gemm_bf16_stacked", "flash_attention"} <= names
    # the shards' shapes: wo and w2 take a quarter of the 1024 inputs
    assert ("q40_gemm_bf16_stacked", (256,)) in calls
    solo = InferenceEngine(path, compute_dtype="bfloat16", max_chunk=16, device="cpu")
    solo.prefill(PROMPT * 3)
    want = solo.decode_one(5, 30)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * scale)


def _collect(host, row, out):
    out.extend(int(t) for t in host[row])


def test_batch_session_on_tp2(model):
    """tests/test_batch_session.py:149: mid-stream admission on a tp = 2
    mesh (the parked-row prefill) gives each row its solo tokens."""
    pa, pb = [3, 17, 99, 4], [12, 6]
    want_a = _solo_new(model, pa, 12)
    want_b = _solo_new(model, pb, 8)
    eng = _engine(model, batch=2, mesh=_cpu_mesh(tp=2))
    s = BatchSession(eng)
    s.admit(0, pa)
    got_a, got_b = [], []
    _collect(s.step(4), 0, got_a)
    s.admit(1, pb)
    for _ in range(2):
        h = s.step(4)
        _collect(h, 0, got_a)
        _collect(h, 1, got_b)
    assert got_a == want_a and got_b == want_b


def test_prefix_cache_hit_on_pp2(tmp_path):
    """tests/test_prefix_cache.py:379: on a pp = 2 mesh the cold run and
    the hit give the single device's tokens; the entry holds one slice per
    (pp, tp) shard in the shard's layout."""
    path = str(tmp_path / "mesh.m")
    write_tiny_model(path, tiny_header(dim=128, hidden_dim=128, n_layers=2, n_heads=4,
                                       n_kv_heads=4, seq_len=256), seed=32)
    prompt = [(i % 100) + 3 for i in range(40)]
    want = _solo_tokens(path, prompt, len(prompt) + 9, max_chunk=16)[len(prompt):][:8]
    eng = _engine(path, max_chunk=16, mesh=_cpu_mesh(pp=2), prefix_cache_mb=64)
    cold = eng.generate(prompt, len(prompt) + 9, sampler=None).tokens[len(prompt):][:8]
    assert cold == want
    entry = next(iter(eng.prefix_cache._entries.values()))
    assert set(entry.k) == {(0, 0), (1, 0)}
    assert tuple(entry.k[(1, 0)].shape) == (1, entry.length, 4, 32)
    eng.reset()
    hit = eng.generate(prompt, len(prompt) + 9, sampler=None).tokens[len(prompt):][:8]
    assert eng.last_prefix_hit_tokens > 0 and hit == want
    sp = InferenceEngine(path, compute_dtype="float32", mesh=_cpu_mesh(sp=2), prefix_cache_mb=64)
    assert sp.prefix_cache is None


def test_int8_kv_on_a_mesh_falls_back_with_the_warning(model):
    """tests/test_kv_quant.py:314."""
    with pytest.warns(UserWarning, match="single-chip"):
        eng = _engine(model, mesh=_cpu_mesh(tp=2), cache_dtype="int8", batch=2)
    assert not eng.cfg.kv_quantized
    assert all(shard.k_scale is None for shard in eng.cache)


@pytest.mark.parametrize("shape", [dict(pp=2), dict(tp=2), dict(pp=2, tp=2)],
                         ids=["pp2", "tp2", "pp2xtp2"])
def test_mesh_paged_identity(model, shape):
    """tests/test_kv_transport.py:157-181: the paged mesh engine's greedy
    tokens equal the contiguous one's (bit for bit: the same logits), the
    batched per-row path too; one pool a (pp, tp) shard."""
    ec = _engine(model, mesh=_cpu_mesh(**shape), kv_layout="contiguous", batch=2)
    ep = _engine(model, mesh=_cpu_mesh(**shape), kv_layout="paged", batch=2)
    assert ep.cache.paged and len(ep.cache) == ep.mesh.pp * ep.mesh.tp
    assert ep.generate(PROMPT, 40, sampler=None).tokens == ec.generate(PROMPT, 40,
                                                                      sampler=None).tokens
    ep.reset()
    ec.reset()
    prompts = [PROMPT, PROMPT[:7]]
    assert ep.generate_batch(prompts, 10) == ec.generate_batch(prompts, 10)


def test_mesh_rules_match_the_jax_engine(model):
    """tests/test_kv_transport.py:184 and the JAX engine's mesh checks
    (:274-299, :345-356): the same refusals with the same messages; the
    gspmd arm names A13b where JAX would run it."""
    cases = [
        (dict(mesh_shape=dict(pp=2, sp=2), kv_layout="paged", batch=2), ValueError),
        (dict(mesh_shape=dict(dp=2, tp=2), kv_layout="paged", batch=2), ValueError),
        (dict(mesh_shape=dict(dp=2), batch=3), ValueError),
        (dict(mesh_shape=dict(pp=2), execution="gspmd"), ValueError),
        (dict(mesh_shape=None, execution="pipeline"), ValueError),
        (dict(mesh_shape=dict(tp=2), execution="fast"), ValueError),
    ]
    for kw, exc in cases:
        shape = kw.pop("mesh_shape")
        msgs = []
        for ctor, mk in ((JEngine, lambda s: j_make_mesh(**s)), (InferenceEngine, lambda s:
                                                                 _cpu_mesh(**s))):
            extra = {} if ctor is JEngine or shape is not None else {"device": "cpu"}
            with pytest.raises(exc) as err:
                ctor(model, compute_dtype="float32", mesh=None if shape is None else mk(shape),
                     **kw, **extra)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], msgs
    with pytest.raises(NotImplementedError, match="A13b"):
        InferenceEngine(model, mesh=_cpu_mesh(tp=2), execution="gspmd")
    with pytest.raises(ValueError, match="n_layers"):
        InferenceEngine(model, mesh=_cpu_mesh(pp=8))


