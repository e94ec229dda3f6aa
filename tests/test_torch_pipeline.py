"""The port's PP x TP shard loop against the JAX package's shard_map
pipeline and against the port's own single device, on the CPU.

Twins of tests/test_pipeline.py (JAX's `pipeline_forward` on its 8 forced
host devices, f32, at its bound rtol 2e-4) and of the expert-parallel cases
of tests/test_moe_dispatch.py (:113, :130, :245). A mesh with tp = ep = 1
(pp and dp) runs the single device's arithmetic and is held to it bit for
bit; tp and ep split the sums, so those meshes are held to the port's
single device within the f32 sum order (1e-5). One forward on each mesh
counts its collectives against `collective_budget`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.formats.mfile import ArchType, RopeType
from distributed_llama_tpu.formats.mfile import MFileReader as JReader
from distributed_llama_tpu.models import config_from_header as j_config
from distributed_llama_tpu.models import init_kv_cache as j_init_cache
from distributed_llama_tpu.models import load_params as j_load_params
from distributed_llama_tpu.ops import build_rope_tables as j_rope
from distributed_llama_tpu.ops import moe as jmoe
from distributed_llama_tpu.ops.activations import silu as j_silu
from distributed_llama_tpu.parallel import make_mesh as j_make_mesh
from distributed_llama_tpu.parallel.pipeline import pipeline_forward as j_pipeline_forward
from distributed_llama_tpu.parallel.pipeline import pp_cache_sharding, pp_param_shardings
from distributed_llama_tpu.testing import tiny_header, write_tiny_model
from distributed_llama_tpu_torch.formats.mfile import MFileReader
from distributed_llama_tpu_torch.models import (
    config_from_header, forward, init_kv_cache, load_params,
)
from distributed_llama_tpu_torch.models import transformer as ptf
from distributed_llama_tpu_torch.ops.activations import silu
from distributed_llama_tpu_torch.ops.moe import ep_local_route, moe_ffn_ragged, moe_router
from distributed_llama_tpu_torch.ops.rope import build_rope_tables
from distributed_llama_tpu_torch.parallel import make_mesh
from distributed_llama_tpu_torch.parallel.pipeline import (
    COUNTS, collective_budget, microbatch_count, pipeline_batch_decode_chunk,
    pipeline_decode_chunk, pipeline_forward,
)
from distributed_llama_tpu_torch.parallel.sharding import mesh_kv, shard_params
from distributed_llama_tpu_torch.runtime.batch_session import Rows

torch.set_num_threads(1)

KW = dict(arch=ArchType.LLAMA, dim=128, hidden_dim=128, n_layers=4, n_heads=4, n_kv_heads=4)
ARCHS = {
    "llama": KW,
    "qwen3": dict(arch=ArchType.QWEN3, dim=128, rope_type=RopeType.FALCON, n_layers=4,
                  n_heads=8, n_kv_heads=4, hidden_dim=128),
    "qwen3_moe": dict(arch=ArchType.QWEN3_MOE, dim=128, rope_type=RopeType.FALCON, n_layers=4,
                      n_heads=4, n_kv_heads=4, hidden_dim=128, n_experts=4,
                      n_active_experts=2, moe_hidden_dim=128),
}
JAX_TOL = dict(rtol=2e-4, atol=2e-4)
SUM_ORDER = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    out = {}
    for name, kw in ARCHS.items():
        out[name] = str(d / f"{name}.m")
        write_tiny_model(out[name], tiny_header(**kw), seed=5)
    return out


def _n(shape) -> int:
    return int(np.prod(list(shape.values())))


def _jax(path, shape, batch=1):
    jr = JReader(path)
    jcfg = j_config(jr.header, compute_dtype="float32")
    mesh = j_make_mesh(**shape)
    params = j_load_params(jr, jcfg, shardings=pp_param_shardings(mesh, moe=jcfg.is_moe),
                           tp=mesh.shape["tp"])
    cache = jax.device_put(j_init_cache(jcfg, batch=batch), pp_cache_sharding(mesh))
    return jcfg, mesh, params, j_rope(jr.header), cache


def _port(path, shape, batch=1):
    with MFileReader(path) as r:
        cfg = config_from_header(r.header, compute_dtype="float32")
        params = load_params(r, cfg, device="cpu")
        rope = build_rope_tables(r.header, device="cpu")
    mesh = make_mesh(**shape, devices=["cpu"] * _n(shape))
    return (cfg, params, rope, mesh, shard_params(cfg, params, mesh),
            mesh_kv(cfg, mesh, batch))


def _global_k(kv, mesh) -> np.ndarray:
    """The mesh cache's k as one [L, b, S, kv, hd] array (dp over rows, pp
    over layers, sp over positions, tp over heads)."""
    rows = []
    for d in range(mesh.dp):
        layers = [torch.cat([torch.cat([kv.shards[(d, p, t, s)].k for t in range(mesh.tp)], dim=3)
                             for s in range(mesh.sp)], dim=2)
                  for p in range(mesh.pp)]
        rows.append(torch.cat(layers, dim=0))
    return torch.cat(rows, dim=1).numpy()


def _check(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **SUM_ORDER)


PP_TP = [(2, 1), (2, 2), (4, 2), (2, 4)]


@pytest.mark.parametrize("pp,tp", PP_TP)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_pipeline_matches_single_device_and_jax(models, arch, pp, tp):
    """tests/test_pipeline.py:40 on llama, qwen3 and qwen3_moe: logits and
    cache against JAX's pipeline_forward and the port's single device."""
    tokens = [3, 99, 41, 7]
    shape = dict(pp=pp, tp=tp)
    cfg, params, rope, mesh, mp, kv = _port(models[arch], shape)
    solo = init_kv_cache(cfg, batch=1, device="cpu")
    arr = torch.tensor([tokens])
    want = forward(cfg, params, rope, solo, arr, 0)
    got = pipeline_forward(cfg, mesh, mp, rope, kv, arr, 0)
    jcfg, jmesh, jp, jr, jc = _jax(models[arch], shape)
    jgot, jc = j_pipeline_forward(jcfg, jmesh, jp, jr, jc, jnp.asarray([tokens], jnp.int32),
                                  jnp.int32(0))
    _check(got.numpy(), want.numpy(), exact=tp == 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **JAX_TOL)
    _check(_global_k(kv, mesh), solo.k.numpy(), exact=tp == 1)
    np.testing.assert_allclose(_global_k(kv, mesh), np.asarray(jc.k), **SUM_ORDER)


def test_pipeline_decode_sequence(models):
    """tests/test_pipeline.py:60: decode steps on pp 2 x tp 2 against JAX
    and the single device."""
    tokens = [5, 42, 7, 12, 90, 3]
    shape = dict(pp=2, tp=2)
    cfg, params, rope, mesh, mp, kv = _port(models["llama"], shape)
    solo = init_kv_cache(cfg, batch=1, device="cpu")
    jcfg, jmesh, jp, jr, jc = _jax(models["llama"], shape)
    for p, t in enumerate(tokens):
        arr = torch.tensor([[t]])
        want = forward(cfg, params, rope, solo, arr, p)
        got = pipeline_forward(cfg, mesh, mp, rope, kv, arr, p)
        jgot, jc = j_pipeline_forward(jcfg, jmesh, jp, jr, jc, jnp.asarray([[t]], jnp.int32),
                                      jnp.int32(p))
        np.testing.assert_allclose(got.numpy(), want.numpy(), **SUM_ORDER)
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **JAX_TOL)


@pytest.mark.parametrize("pp,tp,micro", [(2, 2, 4), (2, 1, 2), (4, 1, 4)])
def test_pipeline_microbatched_prefill(models, pp, tp, micro):
    """tests/test_pipeline.py:78: microbatched "all" logits equal the
    single-shot prefill, JAX's at the same microbatch count; at tp = 1 the
    port's equal its single device bit for bit."""
    tokens = [3, 99, 41, 7, 5, 42, 7, 12]
    shape = dict(pp=pp, tp=tp)
    cfg, params, rope, mesh, mp, kv = _port(models["llama"], shape)
    arr = torch.tensor([tokens])
    want = forward(cfg, params, rope, init_kv_cache(cfg, batch=1, device="cpu"), arr, 0,
                   logits_mode="all")
    COUNTS.reset()
    got = pipeline_forward(cfg, mesh, mp, rope, kv, arr, 0, logits_mode="all",
                           microbatches=micro)
    assert COUNTS.pp_handoff == (pp - 1) * micro
    jcfg, jmesh, jp, jr, jc = _jax(models["llama"], shape)
    jgot, _ = j_pipeline_forward(jcfg, jmesh, jp, jr, jc, jnp.asarray([tokens], jnp.int32),
                                 jnp.int32(0), logits_mode="all", microbatches=micro)
    _check(got.numpy(), want.numpy(), exact=tp == 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **JAX_TOL)
    with pytest.raises(ValueError, match="must divide the token length"):
        pipeline_forward(cfg, mesh, mp, rope, kv, arr, 0, microbatches=3)


@pytest.mark.parametrize("shape", [dict(pp=2, tp=2), dict(dp=2, tp=2), dict(tp=2, sp=2)],
                         ids=["pp2xtp2", "dp2xtp2", "tp2xsp2"])
def test_per_row_positions_and_parked_rows(models, shape):
    """Per-row positions (batched serving): each row at its own position,
    a row at seq_len parked writes nothing, against JAX's per-row
    pipeline_forward and the single device."""
    cfg, params, rope, mesh, mp, kv = _port(models["qwen3"], shape, batch=4)
    solo = init_kv_cache(cfg, batch=4, device="cpu")
    jcfg, jmesh, jp, jr, jc = _jax(models["qwen3"], shape, batch=4)
    rng = np.random.default_rng(3)
    pre = rng.integers(1, 200, size=(4, 6))
    steps = [(pre, np.zeros(4, np.int64)),
             (rng.integers(1, 200, size=(4, 2)), np.array([6, 6, cfg.seq_len, 3])),
             (rng.integers(1, 200, size=(4, 1)), np.array([8, 8, cfg.seq_len, 5]))]
    parked_before = None
    for toks, pos in steps:
        if pos[2] == cfg.seq_len and parked_before is None:
            parked_before = _global_k(kv, mesh)[:, 2].copy()
        arr, pv = torch.from_numpy(toks), torch.from_numpy(pos)
        want = forward(cfg, params, rope, solo, arr, pv)
        got = pipeline_forward(cfg, mesh, mp, rope, kv, arr, pv)
        jgot, jc = j_pipeline_forward(jcfg, jmesh, jp, jr, jc, jnp.asarray(toks, jnp.int32),
                                      jnp.asarray(pos, jnp.int32))
        live = pos < cfg.seq_len
        np.testing.assert_allclose(got.numpy()[live], want.numpy()[live], **SUM_ORDER)
        np.testing.assert_allclose(got.numpy()[live], np.asarray(jgot)[live], **JAX_TOL)
    np.testing.assert_array_equal(_global_k(kv, mesh)[:, 2], parked_before)


def test_decode_chunks_through_the_mesh(models):
    """pipeline_decode_chunk and pipeline_batch_decode_chunk: the
    single-device chunks' tokens, bit for bit on pp 2."""
    from distributed_llama_tpu_torch.runtime.batch_session import batch_decode_chunk
    from distributed_llama_tpu_torch.runtime.decode import decode_chunk

    shape = dict(pp=2)
    cfg, params, rope, mesh, mp, kv = _port(models["llama"], shape, batch=2)
    solo = init_kv_cache(cfg, batch=2, device="cpu")
    tok = torch.tensor([5, 9])
    want = decode_chunk(cfg, params, rope, solo, tok, 0, 6)
    got = pipeline_decode_chunk(cfg, mesh, mp, rope, kv, tok, 0, 6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    rows = Rows(torch.tensor([3, 4]), torch.tensor([6, cfg.seq_len]), torch.tensor([1, 2]),
                torch.tensor([0, 0]), torch.tensor([0.0, 0.0]), torch.tensor([0.9, 0.9]))
    want = batch_decode_chunk(cfg, params, rope, solo, rows, 4, sampler="greedy")
    got = pipeline_batch_decode_chunk(cfg, mesh, mp, rope, kv, rows, 4, sampler="greedy")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_microbatch_rule():
    """JAX's pp-divides-t rule, kept only where the microbatch takes the
    chunk's own arms."""
    cfg = config_from_header(tiny_header(**KW))
    moe = config_from_header(tiny_header(**ARCHS["qwen3_moe"]))
    assert microbatch_count(cfg, 1, 1, 32) == 1
    assert microbatch_count(cfg, 2, 1, 32) == 2  # 16 rows: K2 and flash both
    assert microbatch_count(cfg, 2, 1, 16) == 1  # 8 rows would take K1
    assert microbatch_count(cfg, 4, 1, 32) == 1  # likewise
    assert microbatch_count(cfg, 2, 1, 4) == 2  # K1 and the plain attention both
    assert microbatch_count(cfg, 2, 1, 8) == 1  # 4 queries would leave flash
    assert microbatch_count(cfg, 2, 4, 8) == 1  # 16 rows, but 4 queries
    assert microbatch_count(cfg, 2, 1, 33) == 1
    assert microbatch_count(cfg, 4, 2, 64) == 4
    # K3's split of the KV tiles: 32 queries at 64 over 256 rows split the
    # 2 visible tiles as 16 do; at 3000 over 4096 rows a 16-query
    # microbatch would split the 48 tiles finer than the whole chunk
    wide = dataclasses.replace(cfg, n_heads=32, n_kv_heads=8)  # Llama-3.2-1B's heads
    assert microbatch_count(wide, 2, 1, 32, 64, 256) == 2
    assert microbatch_count(wide, 2, 1, 32, 3000, 4096) == 1
    assert microbatch_count(moe, 1, 1, 32) == 1
    assert microbatch_count(moe, 2, 1, 32) == 1  # a MoE chunk runs whole


BUDGET_MESHES = [dict(pp=2), dict(tp=2), dict(pp=2, tp=2), dict(pp=4, tp=2), dict(dp=2, tp=2),
                 dict(ep=2), dict(ep=2, tp=2), dict(ep=2, pp=2), dict(sp=2)]


@pytest.mark.parametrize("shape", BUDGET_MESHES,
                         ids=["x".join(f"{k}{v}" for k, v in s.items()) for s in BUDGET_MESHES])
@pytest.mark.parametrize("t", [1, 32])
def test_collective_budget(models, shape, t):
    """One forward counts 2 L M tp reduces and one logits gather (tp > 1),
    (pp - 1) M hand-offs and L M ep combines (ep > 1): the counts JAX's
    jaxpr budget holds statically (tests/test_kv_transport.py:200)."""
    arch = "qwen3_moe" if "ep" in shape else "llama"
    batch = shape.get("dp", 1)
    cfg, params, rope, mesh, mp, kv = _port(models[arch], shape, batch=batch)
    arr = torch.randint(1, 200, (batch, t), generator=torch.Generator().manual_seed(t))
    M = microbatch_count(mp.scfg, mesh.pp, 1, t, 0, kv.seq_len)
    assert M == (2 if (shape == dict(pp=2) and t == 32) else M)
    COUNTS.reset()
    pipeline_forward(cfg, mesh, mp, rope, kv, arr, 0)
    assert COUNTS.snapshot() == collective_budget(cfg, mesh, M)


# -- expert parallelism (tests/test_moe_dispatch.py) ------------------------


def _qstack(rng, E, out, inf):
    from distributed_llama_tpu.formats.quants import quantize_q40, unpack_q40
    from distributed_llama_tpu.ops.quant import q40_to_t_layout

    qs, ds = [], []
    for _ in range(E):
        w = rng.standard_normal((out, inf)).astype(np.float32) * 0.05
        q, d = unpack_q40(quantize_q40(w), w.size)
        qt, dt = q40_to_t_layout(q.reshape(out, inf // 32, 32), d.reshape(out, inf // 32))
        qs.append(qt)
        ds.append(dt)
    return np.stack(qs), np.stack(ds)


def _ep_split(w, ep, e):
    from distributed_llama_tpu_torch.ops.quant import QuantTensor

    n = w.q.shape[0] // ep
    return QuantTensor(q=w.q[e * n:(e + 1) * n].contiguous(), d=w.d[e * n:(e + 1) * n].contiguous())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grouped_arm_under_ep(dtype):
    """tests/test_moe_dispatch.py:245: the grouped arm over an ep = 2 split
    (K4's plain version at bf16, the per-expert arm at f32), each shard on
    its `ep_local_route`, the shards' partials summed, against the unsharded call (bf16: the same rows, so
    the same bits per row, summed in another order: within 1e-6 of its
    scale) and against JAX's unsharded materialized path (JAX's bound,
    5e-2)."""
    from distributed_llama_tpu.ops.quant import QuantTensor as JQuant
    from distributed_llama_tpu_torch.ops.quant import QuantTensor

    rng = np.random.default_rng(5)
    E, t, k, dim, ff = 8, 16, 2, 256, 256
    stacks = [_qstack(rng, E, ff, dim), _qstack(rng, E, ff, dim), _qstack(rng, E, dim, ff)]
    ws = [QuantTensor(q=torch.from_numpy(q), d=torch.from_numpy(d)) for q, d in stacks]
    gate = rng.standard_normal((E, dim)).astype(np.float32)
    yb = jnp.asarray(rng.standard_normal((1, t, dim)) * 0.1, jnp.bfloat16)
    tdt = getattr(torch, dtype)
    y = torch.from_numpy(np.asarray(yb.astype(jnp.float32))).to(tdt)
    idx, wts = moe_router(y, torch.from_numpy(gate), k)
    whole = moe_ffn_ragged(y, idx, wts, *ws, silu, tdt)
    parts = [moe_ffn_ragged(y, *ep_local_route(idx, wts, (e * E // 2, E // 2)),
                            *(_ep_split(w, 2, e) for w in ws), silu, tdt) for e in range(2)]
    got = (parts[0].float() + parts[1].float()).to(tdt)
    scale = float(whole.float().abs().max())
    np.testing.assert_allclose(got.float().numpy(), whole.float().numpy(), rtol=0,
                               atol=1e-6 * scale if dtype == "float32" else 1e-2 * scale)
    jws = [JQuant(q=jnp.asarray(q), d=jnp.asarray(d)) for q, d in stacks]
    jidx, jwts = jmoe.moe_router(yb.astype(jnp.float32 if dtype == "float32" else jnp.bfloat16),
                                 jnp.asarray(gate), k)
    want = jmoe.moe_ffn_ragged(yb, jidx, jwts, *jws, j_silu, jnp.bfloat16, pallas=False)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("t", [1, 2])
def test_small_chunk_arm_under_ep(t):
    """JAX transformer.py:228-250: slots routed to another shard are
    clamped to a local expert and zero-weighted, on the gather arm (f32)
    and on K1-indexed's arm (bf16, one token, aligned stacks: its plain
    version); the ep shards' sum equals the unsharded FFN."""
    from distributed_llama_tpu_torch.models.params import LayerParams
    from distributed_llama_tpu_torch.ops.quant import QuantTensor

    rng = np.random.default_rng(7)
    E, L, dim, ff = 8, 2, 256, 256
    stacks = [_qstack(rng, E * L, ff, dim), _qstack(rng, E * L, ff, dim),
              _qstack(rng, E * L, dim, ff)]

    def lay(q, d):
        return QuantTensor(q=torch.from_numpy(q).reshape(L, E, *q.shape[1:]),
                           d=torch.from_numpy(d).reshape(L, E, *d.shape[1:]))

    w1, w3, w2 = (lay(*s) for s in stacks)
    gate = torch.from_numpy(rng.standard_normal((L, E, dim)).astype(np.float32))
    for dtype in ("float32", "bfloat16") if t == 1 else ("float32",):
        cfg = config_from_header(tiny_header(**{**ARCHS["qwen3_moe"], "dim": dim,
                                                "n_experts": E, "moe_hidden_dim": ff}),
                                 compute_dtype=dtype)
        lp = LayerParams(wqkv=None, wo=None, w13=None, w2=w2, norm0=None, norm1=None, w1=w1,
                         w3=w3, moe_gate=gate)
        y = torch.from_numpy(rng.standard_normal((1, t, dim)).astype(np.float32))
        assert ptf._moe_decode_i8_eligible(cfg, y, lp) == (dtype == "bfloat16")
        whole = ptf._moe_ffn(cfg, y, lp, 1)
        route = moe_router(y, gate[1], cfg.n_active_experts)
        total = 0
        for e in range(2):
            sl = slice(e * E // 2, (e + 1) * E // 2)
            part = LayerParams(wqkv=None, wo=None, w13=None, norm0=None, norm1=None,
                               **{n: QuantTensor(q=w.q[:, sl].contiguous(),
                                                 d=w.d[:, sl].contiguous())
                                  for n, w in (("w1", w1), ("w2", w2), ("w3", w3))})
            total = total + ptf._moe_ffn(cfg, y, part, 1, route, (e * E // 2, E // 2))
        np.testing.assert_allclose(total.numpy(), whole.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [dict(dp=2, tp=2), dict(pp=2, tp=2), dict(tp=2, sp=2)],
                         ids=["dp2xtp2", "pp2xtp2", "tp2xsp2"])
def test_row_view_admission_writes_its_row_alone(models, shape):
    """An admission chunk on a mesh (`prefill_row` on `MeshKV.row_view`)
    runs its row alone at a scalar position: the row's cache equals a
    batch-1 cache after the same step on the same mesh shape bit for bit,
    and every other row stays zero."""
    from distributed_llama_tpu_torch.runtime.batch_session import prefill_row

    cfg, params, rope, mesh, mp, kv = _port(models["llama"], shape, batch=4)
    toks = torch.tensor([[3, 99, 41, 7, 12, 5, 8, 1]])
    prefill_row(cfg, mp, rope, kv, toks, 0, 3)
    one_shape = {**shape, "dp": 1}
    _, _, _, one_mesh, one_mp, one_kv = _port(models["llama"], one_shape)
    pipeline_forward(cfg, one_mesh, one_mp, rope, one_kv, toks, 0)
    got, want = _global_k(kv, mesh), _global_k(one_kv, one_mesh)
    np.testing.assert_array_equal(got[:, 3], want[:, 0])
    assert not got[:, :3].any()
    view = kv.row_view(3)
    assert view.mesh.dp == 1 and view[0].k.shape[1] == 1
    assert all(c.k.untyped_storage().data_ptr() == kv.shards[(mesh.dp - 1, *k[1:])].k
               .untyped_storage().data_ptr() for k, c in view.shards.items())
