"""The port's sequence-parallel path (the mesh's sp axis) against the JAX
package's, on the CPU.

The JAX side runs as tests/test_sequence_parallel.py runs it: `make_mesh(sp=n)`
over the host devices that tests/conftest.py forces, `shard_map` around the
per-shard functions, Pallas in interpret mode (or DLT_PALLAS_INTERPRET=1 for
engines). The port's mesh names the CPU n times: one process drives every
shard, and on the CPU each kernel wrapper takes its plain version (B8's is
`flash_attention_partial_plain`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_llama_tpu import cli as jcli
from distributed_llama_tpu.formats.mfile import MFileReader as JReader
from distributed_llama_tpu.models import config_from_header as j_config
from distributed_llama_tpu.models import init_kv_cache as j_init_cache
from distributed_llama_tpu.models import load_params as j_load_params
from distributed_llama_tpu.ops import attention as jatt
from distributed_llama_tpu.ops import build_rope_tables as j_rope
from distributed_llama_tpu.ops import pallas_attention as jpa
from distributed_llama_tpu.parallel import make_mesh as j_make_mesh
from distributed_llama_tpu.parallel.pipeline import pipeline_forward as j_pipeline_forward
from distributed_llama_tpu.parallel.pipeline import pp_cache_sharding, pp_param_shardings
from distributed_llama_tpu.parallel.pipeline import shard_map
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu.testing import tiny_header, write_tiny_model, write_tiny_tokenizer
from distributed_llama_tpu_torch import cli as pcli
from distributed_llama_tpu_torch.formats.mfile import MFileReader
from distributed_llama_tpu_torch.models import config_from_header, forward, init_kv_cache, load_params
from distributed_llama_tpu_torch.ops import attention as patt
from distributed_llama_tpu_torch.ops import cuda_attention as pca
from distributed_llama_tpu_torch.ops.rope import build_rope_tables
from distributed_llama_tpu_torch.parallel import make_mesh
from distributed_llama_tpu_torch.parallel.pipeline import pipeline_forward
from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine

# tiny shapes: torch's intra-op threads would only contend with the JAX
# tests that share the CPU under pytest-xdist
torch.set_num_threads(1)

NEG_INF = float(np.finfo(np.float32).min)


def _cpu_mesh(sp):
    return make_mesh(sp=sp, devices=["cpu"] * sp)


def _bf16_pair(x):
    """The same bf16 bits for JAX and torch."""
    xb = jnp.asarray(x, jnp.bfloat16)
    return xb, torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)


def _sp_call(mesh, body, n_in):
    """shard_map over the sp axis: q and the scalars replicated, the cache
    operands split along their sequence axis."""
    cache_spec = P(None, "sp", None, None)
    return jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P(),) + (cache_spec,) * n_in + (P(),),
        out_specs=P(), check_vma=False,
    ))


# -- B8: the shard-local partial -------------------------------------------


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S", [256, 512])
@pytest.mark.parametrize("t", [8, 32])
def test_b8_plain_matches_pallas_interpret(t, S, hd):
    """flash_attention_partial's plain version against the JAX kernel in
    interpret mode, on one shard at col_offset 0, S (the chunk straddles
    into the shard) and 3 S (the shard lies wholly in the chunk's future).

    Tolerances: m on rows that see a column agrees to the f32 order of the
    score dots (1e-5 of its scale); l is a sum of f32 exponentials (1e-5
    relative); o / l, the shard's normalized output, holds K3's bound
    against Pallas (tests/test_torch_attention.py): an exp ulp can flip the
    bf16 rounding of one weight of P, so a few rows move by <= 2^-7 * |v|.
    Rows that see no column of the shard are exact: o = 0, l = 0, and m is
    NEG_INF / 2 where the row's query block visits a block of the shard,
    NEG_INF where it visits none, on both sides."""
    rng = np.random.default_rng(t + S + hd)
    g, n_kv = 4, 2
    q = rng.standard_normal((1, t, n_kv * g, hd)).astype(np.float32)
    kb, kt = _bf16_pair(rng.standard_normal((1, S, n_kv, hd)))
    vb, vt = _bf16_pair(rng.standard_normal((1, S, n_kv, hd)))
    qt = torch.from_numpy(q)
    cases = [(0, 0), (100, 0), (S - t // 2, 0), (S - t // 2, S), (S - t // 2, 3 * S)]
    for pos, col in cases:
        jo, jm, jl = (np.asarray(x) for x in jpa.flash_attention_partial(
            jnp.asarray(q), kb, vb, jnp.int32(pos), jnp.int32(col), interpret=True))
        o, m, l = (x.numpy() for x in pca.flash_attention_partial(qt, kt, vt, pos, col))
        assert o.shape == q.shape and m.shape == q.shape[:3] == l.shape
        assert o.dtype == m.dtype == l.dtype == np.float32
        seen = jl > 0
        assert np.array_equal(seen, l > 0)
        blind = ~seen
        np.testing.assert_array_equal(m[blind], jm[blind])
        assert (o[blind] == 0).all() and (jo[blind] == 0).all() and (l[blind] == 0).all()
        if col == 3 * S:
            assert blind.all() and (m == NEG_INF).all()
        if col == S:
            assert blind.any() and seen.any() and (m[blind] == NEG_INF / 2).all()
        if not seen.any():
            continue
        np.testing.assert_allclose(m[seen], jm[seen], rtol=0, atol=1e-5 * np.abs(jm[seen]).max())
        np.testing.assert_allclose(l[seen], jl[seen], rtol=1e-5)
        d = np.abs(o[seen] / l[seen][:, None] - jo[seen] / jl[seen][:, None])
        assert (d.max(axis=-1) > 2e-5).mean() <= 0.1, f"pos={pos} col={col}"
        assert d.max() <= 5e-3, f"pos={pos} col={col}: max abs err {d.max()}"


def test_k3_plain_is_b8_plain_at_col_offset_zero_normalized():
    """K3's plain version is B8's at col_offset 0, divided by max(l, 1e-30),
    bit for bit: the same blocks in the same order."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 16, 8, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 256, 2, 64)).astype(np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((2, 256, 2, 64)).astype(np.float32)).to(torch.bfloat16)
    o, _, l = pca.flash_attention_partial_plain(q, k, v, 40, 0)
    want = pca.flash_attention_plain(q, k, v, 40)
    torch.testing.assert_close(o / torch.clamp(l, min=1e-30)[..., None], want, rtol=0, atol=0)


# -- the cross-shard combine ------------------------------------------------


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("hd", [8, 64])
def test_flash_attention_sp_matches_jax_and_the_whole_cache(sp, hd):
    """flash_attention_sp over sp shards against JAX's under shard_map
    (interpret mode), and against the port's flash_attention_plain over the
    whole cache, for a prefill chunk landing in shard 0, inside a later
    shard, across a boundary and at the end.

    Against JAX: the same blocks, bf16 roundings and combine, so K3's bound
    (few rows past 2e-5, none past 5e-3). Against the whole cache: the
    whole-cache kernel rounds P to bf16 against the running max of other
    blocks, so rows move by a bf16 rounding (2^-8 relative) of their
    weights: JAX's own test bound, 2e-2."""
    rng = np.random.default_rng(7 + sp + hd)
    b, t, n_heads, n_kv, seq = 1, 8, 4, 2, 512
    q = rng.standard_normal((b, t, n_heads, hd)).astype(np.float32)
    qb, qt = _bf16_pair(q)
    kb, kt = _bf16_pair(rng.standard_normal((b, seq, n_kv, hd)))
    vb, vt = _bf16_pair(rng.standard_normal((b, seq, n_kv, hd)))
    local = seq // sp
    jmesh = j_make_mesh(sp=sp)

    def body(q, k_l, v_l, ps):
        off = jax.lax.axis_index("sp") * local
        return jatt.flash_attention_sp(q, k_l, v_l, ps, off, interpret=True)

    run = _sp_call(jmesh, body, 2)
    ks = [kt[:, i * local : (i + 1) * local] for i in range(sp)]
    vs = [vt[:, i * local : (i + 1) * local] for i in range(sp)]
    offsets = [i * local for i in range(sp)]
    for pos0 in [0, 100, local - 4, seq - t]:
        want = np.asarray(run(qb, kb, vb, jnp.int32(pos0)), np.float32)
        got = patt.flash_attention_sp(qt.to(torch.bfloat16), ks, vs, pos0, offsets)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        d = np.abs(got - want)
        assert (d.max(axis=-1) > 2e-5).mean() <= 0.1, f"pos0={pos0}"
        assert d.max() <= 5e-3 + 2 ** -8 * np.abs(want).max(), f"pos0={pos0}: {d.max()}"
        whole = pca.flash_attention_plain(qt.to(torch.bfloat16), kt, vt, pos0).float().numpy()
        np.testing.assert_allclose(got, whole, rtol=2e-2, atol=2e-2, err_msg=f"pos0={pos0}")


def test_combine_of_one_live_shard_is_its_own_epilogue():
    """With the chunk inside shard 0 the other shards add exact zeros, so
    the combine is shard 0's o / max(l, 1e-30): K3's epilogue, bit for bit."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((1, 16, 8, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1024, 2, 64)).astype(np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((1, 1024, 2, 64)).astype(np.float32)).to(torch.bfloat16)
    got = patt.flash_attention_sp(q, [k[:, i * 256 : (i + 1) * 256] for i in range(4)],
                                  [v[:, i * 256 : (i + 1) * 256] for i in range(4)],
                                  100, [0, 256, 512, 768])
    want = pca.flash_attention(q, k[:, :256], v[:, :256], 100)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- the cache write and the einsum arm ------------------------------------


def test_scatter_straddles_shards_like_jax():
    """A chunk crossing a shard boundary writes each row to its shard and
    nothing else, exactly as JAX's scatter (tests/test_sequence_parallel.py
    :64), and rows below a shard do not wrap to its end."""
    b, t, n_kv, hd, seq, sp = 2, 4, 2, 8, 32, 4
    local = seq // sp
    rng = np.random.default_rng(5)
    new = rng.standard_normal((b, t, n_kv, hd)).astype(np.float32)
    jmesh = j_make_mesh(sp=sp)

    @jax.jit
    @lambda f: shard_map(f, mesh=jmesh, in_specs=(P(None, "sp", None, None), P(), P()),
                         out_specs=P(None, "sp", None, None), check_vma=False)
    def run(cache_l, new, positions):
        off = jax.lax.axis_index("sp") * local
        return jatt.scatter_cache_update_sp(cache_l, new, positions, off)

    for pos0 in (6, 14, 29):
        positions = pos0 + np.arange(t, dtype=np.int32)[None, :].repeat(b, 0)
        want = np.asarray(run(jnp.zeros((b, seq, n_kv, hd)), jnp.asarray(new), jnp.asarray(positions)))
        shards = [torch.zeros((b, local, n_kv, hd)) for _ in range(sp)]
        for i, shard in enumerate(shards):
            assert patt.scatter_cache_update_sp(shard, torch.from_numpy(new), pos0, i * local) is shard
        np.testing.assert_array_equal(torch.cat(shards, dim=1).numpy(), want)
    # the stacked form: one layer of [L, b, local, ...], the others untouched
    stack = torch.zeros((3, b, local, n_kv, hd))
    patt.scatter_cache_update_sp(stack, torch.from_numpy(new), 6, 0, layer=1)
    assert stack[0].abs().sum() == 0 and stack[2].abs().sum() == 0
    np.testing.assert_array_equal(stack[1, :, 6:].numpy(), new[:, :2])


def test_gqa_attention_sp_matches_jax():
    """The einsum arm (decode, and chunks the flash gate refuses) over 4
    shards against JAX's under shard_map, for query positions in every
    shard (tests/test_sequence_parallel.py :36), and against the port's
    unsharded gqa_attention; f32 throughout, so only the order of f32 sums
    differs (JAX's own bound, 2e-5)."""
    rng = np.random.default_rng(4)
    b, t, n_heads, n_kv, hd, seq, sp = 1, 4, 4, 2, 8, 32, 4
    local = seq // sp
    q = rng.standard_normal((b, t, n_heads, hd)).astype(np.float32)
    k = rng.standard_normal((b, seq, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, seq, n_kv, hd)).astype(np.float32)
    jmesh = j_make_mesh(sp=sp)

    def body(q, k_l, v_l, positions):
        return jatt.gqa_attention_sp(q, k_l, v_l, positions, jax.lax.axis_index("sp") * local)

    run = _sp_call(jmesh, body, 2)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    for pos0 in [0, 6, 17, 27]:
        positions = pos0 + np.arange(t, dtype=np.int32)[None, :]
        want = np.asarray(run(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions)))
        pt = torch.from_numpy(positions).long()
        got = patt.gqa_attention_sp(qt, [kt[:, i * local : (i + 1) * local] for i in range(sp)],
                                    [vt[:, i * local : (i + 1) * local] for i in range(sp)], pt,
                                    [i * local for i in range(sp)])
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5, err_msg=f"pos0={pos0}")
        np.testing.assert_allclose(got.numpy(), patt.gqa_attention(qt, kt, vt, pt).numpy(),
                                   rtol=2e-5, atol=2e-5)


# -- pipeline_forward --------------------------------------------------------

KW = dict(dim=128, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=4, seq_len=64)


def _port(path):
    reader = MFileReader(path)
    cfg = config_from_header(reader.header, compute_dtype="float32")
    return cfg, load_params(reader, cfg, device="cpu"), build_rope_tables(reader.header, device="cpu")


def _jax_sp(path, mesh):
    reader = JReader(path)
    cfg = j_config(reader.header, compute_dtype="float32")
    params = j_load_params(reader, cfg, shardings=pp_param_shardings(mesh, moe=False), tp=1)
    cache = jax.device_put(j_init_cache(cfg, batch=1), pp_cache_sharding(mesh))
    return cfg, params, j_rope(reader.header), cache


@pytest.mark.parametrize("kv_len", [8, 16, 32])
def test_pipeline_forward_bounded_kv_matches_unsharded_and_jax(tmp_path, kv_len):
    """Under sp = 4 (16-row shards) a global kv_len bucket clamps each
    shard's reads to min(kv_len, local_seq): exact, so the logits equal the
    unsharded forward's with the same bucket (f32 sum order: 1e-5) and JAX's
    sp pipeline_forward (tests/test_sequence_parallel.py :124's bound,
    2e-4), through a prefill and a decode step; then decode steps crossing
    the shard 0/1 boundary."""
    path = str(tmp_path / "m.m")
    write_tiny_model(path, tiny_header(**KW), seed=5)
    cfg, params, rope = _port(path)
    mesh = _cpu_mesh(4)
    whole = init_kv_cache(cfg, batch=1, device="cpu")
    shards = [init_kv_cache(cfg, batch=1, seq_len=16, device="cpu") for _ in range(4)]
    jmesh = j_make_mesh(sp=4)
    jcfg, jparams, jrope, jcache = _jax_sp(path, jmesh)
    steps = [([3, 99, 41, 7], 0), ([5], 4)]
    if kv_len == 32:
        steps += [([t], p) for p, t in enumerate([8, 42, 7, 11, 13, 2, 9, 1, 4, 66, 12, 14, 3], start=5)]
    for toks, pos in steps:
        arr = torch.tensor([toks])
        want = forward(cfg, params, rope, whole, arr, pos, kv_len=kv_len)
        got = pipeline_forward(cfg, mesh, params, rope, shards, arr, pos, kv_len=kv_len)
        jgot, jcache = j_pipeline_forward(jcfg, jmesh, jparams, jrope, jcache,
                                          jnp.asarray([toks], jnp.int32), jnp.int32(pos),
                                          kv_len=kv_len)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(torch.cat([s.k for s in shards], dim=2).numpy(), whole.k.numpy(),
                               rtol=1e-5, atol=1e-5)


# -- the engine -------------------------------------------------------------

ENGINE_KW = dict(dim=128, hidden_dim=128, n_layers=4, n_heads=4, n_kv_heads=2, seq_len=512)
# 149 tokens of prefill in 24-row chunks: the chunk at 120 straddles the
# shard 0/1 boundary at sp = 4 (128-row shards); decode then runs to 190
ENGINE_PROMPT = [(7 * i) % 200 + 1 for i in range(150)]
ENGINE_STEPS = 190


def _jax_engine(path, monkeypatch, dtype, mesh=None):
    if dtype == "bfloat16":
        monkeypatch.setenv("DLT_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("DLT_PALLAS_INTERPRET", raising=False)
    return JEngine(path, compute_dtype=dtype, max_chunk=24, mesh=mesh, kv_layout="contiguous",
                   speculative="off", prefix_cache_mb=0, grammar=False)


@pytest.fixture(scope="module")
def engine_model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sp") / "m.m")
    write_tiny_model(path, tiny_header(**ENGINE_KW), seed=21)
    return path


@pytest.mark.parametrize("sp", [2, 4])
def test_f32_engine_tokens_match_sp1_and_the_jax_sp_mesh(engine_model, monkeypatch, sp):
    """The tests/test_engine_parallel.py:80 pattern: greedy tokens of the
    port's engine on an sp mesh equal its sp = 1 tokens and the JAX engine's
    on an sp mesh of the same size (the f32 XLA arm: equal to f32 sum
    order, so the same greedy tokens)."""
    eng = InferenceEngine(engine_model, compute_dtype="float32", max_chunk=24, mesh=_cpu_mesh(sp))
    assert eng.use_pipeline and len(eng.cache) == sp
    got = eng.generate(ENGINE_PROMPT, ENGINE_STEPS, sampler=None).tokens
    solo = InferenceEngine(engine_model, compute_dtype="float32", max_chunk=24, device="cpu")
    assert got == solo.generate(ENGINE_PROMPT, ENGINE_STEPS, sampler=None).tokens
    je = _jax_engine(engine_model, monkeypatch, "float32", mesh=j_make_mesh(sp=sp))
    assert je.use_pipeline
    assert got == je.generate(ENGINE_PROMPT, ENGINE_STEPS, sampler=None).tokens


@pytest.mark.parametrize("sp", [2, 4])
def test_bf16_engine_logits_match_the_jax_sp_mesh(engine_model, monkeypatch, sp):
    """bf16, B8's plain version on every shard against the JAX sp mesh with
    its Pallas kernels in interpret mode: after the 149-token prefill the
    first decode logits hold the engine tests' bound (5% of their scale,
    tests/test_torch_engine.py: bf16 cache and P roundings flip on ulps of
    f32 order), and the same bound against the port at sp = 1."""
    eng = InferenceEngine(engine_model, max_chunk=24, mesh=_cpu_mesh(sp))
    je = _jax_engine(engine_model, monkeypatch, "bfloat16", mesh=j_make_mesh(sp=sp))
    assert je.cfg.pallas_interpret
    solo = InferenceEngine(engine_model, max_chunk=24, device="cpu")
    n = len(ENGINE_PROMPT) - 1
    for e in (eng, je, solo):
        e.prefill(ENGINE_PROMPT[:-1])
    pl = eng.decode_one(ENGINE_PROMPT[-1], n)
    jl = je.decode_one(ENGINE_PROMPT[-1], n)
    sl = solo.decode_one(ENGINE_PROMPT[-1], n)
    scale = float(np.abs(jl).max())
    np.testing.assert_allclose(pl, jl, rtol=0, atol=5e-2 * scale)
    np.testing.assert_allclose(pl, sl, rtol=0, atol=5e-2 * scale)
    assert np.corrcoef(pl[0], jl[0])[0, 1] > 0.999


def test_engine_refuses_what_a_mesh_does_not_run(engine_model):
    """Paged KV on a mesh raises as in the JAX engine; shards must be
    multiples of 128 rows; the batched entry points and per-row positions
    on a mesh raise naming A13; int8 KV falls back to float with JAX's
    warning."""
    mesh = _cpu_mesh(2)
    with pytest.raises(ValueError, match="paged"):
        InferenceEngine(engine_model, mesh=mesh, kv_layout="paged")
    with pytest.raises(ValueError, match="multiple of 128"):
        InferenceEngine(engine_model, mesh=_cpu_mesh(8), max_seq_len=512)
    with pytest.raises(ValueError, match="not both"):
        InferenceEngine(engine_model, mesh=mesh, device="cpu")
    eng = InferenceEngine(engine_model, mesh=mesh)
    with pytest.raises(NotImplementedError, match="A13"):
        eng.generate_batch([[1, 2]], 4)
    with pytest.raises(NotImplementedError, match="A13"):
        BatchSession(eng)
    with pytest.raises(NotImplementedError, match="A13"):
        pipeline_forward(eng.cfg, mesh, eng.params, eng.rope, eng.cache, torch.tensor([[1]]),
                         torch.tensor([3]))
    with pytest.warns(UserWarning, match="single-chip only"):
        e8 = InferenceEngine(engine_model, mesh=mesh, cache_dtype="int8")
    assert not e8.cfg.kv_quantized


# -- make_mesh ----------------------------------------------------------------


def test_make_mesh_raises_as_jax_does(monkeypatch):
    """Too few devices raises JAX's message; any axis but sp raises naming
    ROADMAP A13; with no devices given the mesh takes the visible cards, so
    without a GPU it raises."""
    with pytest.raises(ValueError, match="mesh needs 16 devices, have 8"):
        j_make_mesh(sp=16)
    with pytest.raises(ValueError, match="mesh needs 16 devices, have 8"):
        make_mesh(sp=16, devices=["cpu"] * 8)
    for axis in ("tp", "pp", "dp", "ep"):
        with pytest.raises(NotImplementedError, match="A13"):
            make_mesh(**{axis: 2}, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 0"):
        make_mesh(sp=2)
    mesh = _cpu_mesh(4)
    assert mesh.shape == {"dp": 1, "pp": 1, "ep": 1, "tp": 1, "sp": 4}
    assert mesh.devices == (torch.device("cpu"),) * 4


# -- the CLI --------------------------------------------------------------------


def _pred_texts(out: str) -> list[str]:
    return [line.split("|", 1)[1] for line in out.splitlines() if line.startswith("🔶 Pred")]


def test_cli_sp_prints_the_jax_cli_tokens(tmp_path, monkeypatch, capsys):
    """`--sp 2 --device cpu` at the CLI's paged default: the port falls back
    to contiguous with the JAX CLI's warning and prints the JAX CLI's greedy
    tokens (bf16; the JAX side in interpret mode on its sp mesh)."""
    mp, tp = str(tmp_path / "m.m"), str(tmp_path / "t.t")
    write_tiny_model(mp, tiny_header(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                                     vocab_size=512, seq_len=512), seed=5)
    write_tiny_tokenizer(tp, pad_to=512)
    args = ["inference", "--model", mp, "--tokenizer", tp, "--prompt",
            "hello world, the brown fox jumps over the lazy dog", "--steps", "80",
            "--temperature", "0", "--sp", "2"]
    monkeypatch.setenv("DLT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DLT_GRAMMAR", "0")
    assert jcli.main(args + ["--speculative", "off", "--prefix-cache-mb", "0"]) == 0
    jout = capsys.readouterr().out
    want = _pred_texts(jout)
    assert pcli.main(args + ["--device", "cpu", "--speculative", "off"]) == 0
    out = capsys.readouterr().out
    assert want and _pred_texts(out) == want
    warning = next(line for line in jout.splitlines() if "--kv-layout paged covers" in line)
    assert warning in out.splitlines()
    assert "sp 2 shards of 256 rows" in out


def test_cli_sp_on_missing_cards_raises(tmp_path, monkeypatch):
    mp = str(tmp_path / "m.m")
    write_tiny_model(mp, tiny_header(**ENGINE_KW), seed=5)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 1"):
        pcli.main(["inference", "--model", mp, "--tokenizer", mp, "--prompt", "x",
                   "--steps", "4", "--sp", "4"])
