"""The port's mesh bookkeeping against the JAX package's, on the CPU.

Twins of tests/test_parallel.py's topology cases; `make_mesh` over every
axis against JAX's mesh over its 8 forced host devices (tests/conftest.py);
the shards `parallel/sharding.py` cuts, role by role, against the blocks
JAX's `device_put` with `pp_param_shardings` leaves on each device; and
`params_from_jax(tp=)` undoing the JAX loader's per-shard interleave.
Shards compare as numpy arrays, bit for bit: a cut moves bytes only.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributed_llama_tpu.formats.mfile import ArchType, RopeType
from distributed_llama_tpu.formats.mfile import MFileReader as JReader
from distributed_llama_tpu.formats.quants import FloatType
from distributed_llama_tpu.models import config_from_header as j_config
from distributed_llama_tpu.models import load_params as j_load_params
from distributed_llama_tpu.parallel import PPxTPTopology as JTopology
from distributed_llama_tpu.parallel import make_mesh as j_make_mesh
from distributed_llama_tpu.parallel.pipeline import pp_param_shardings
from distributed_llama_tpu.testing import tiny_header, write_tiny_model
from distributed_llama_tpu_torch.formats.mfile import MFileReader
from distributed_llama_tpu_torch.models import config_from_header, load_params
from distributed_llama_tpu_torch.models.params import params_from_jax
from distributed_llama_tpu_torch.ops.quant import QuantTensor
from distributed_llama_tpu_torch.parallel import PPxTPTopology, make_mesh
from distributed_llama_tpu_torch.parallel.sharding import (
    check_mesh, join_global, mesh_kv, shard_config, shard_params, split_global,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")


# -- topology (tests/test_parallel.py:TestTopology) ------------------------


def _both(n, pp):
    return PPxTPTopology(n_nodes=n, pp_size=pp), JTopology(n_nodes=n, pp_size=pp)


def test_placement_row_major():
    mine, theirs = _both(8, 2)
    assert mine.tp_size == theirs.tp_size == 4
    for r in range(8):
        assert (mine.pp_rank(r), mine.tp_rank(r)) == (theirs.pp_rank(r), theirs.tp_rank(r))
        assert mine.rank(mine.pp_rank(r), mine.tp_rank(r)) == r


def test_tp_group():
    mine, theirs = _both(8, 2)
    for r in range(8):
        assert mine.tp_group(r) == theirs.tp_group(r)
    assert mine.tp_group(6) == (4, 8)


@pytest.mark.parametrize("n,pp", [(6, 4), (0, 1), (4, 0)])
def test_divisibility_validation(n, pp):
    msgs = []
    for cls in (PPxTPTopology, JTopology):
        with pytest.raises(ValueError) as err:
            cls(n_nodes=n, pp_size=pp)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_layer_range_remainder_to_last_stage():
    for n_layers in (5, 10, 16):
        mine, theirs = _both(4, 4)
        for s in range(4):
            assert mine.layer_range(s, n_layers) == theirs.layer_range(s, n_layers)
    assert mine.layer_range(3, 10) == (6, 10)


def test_pp1_single_stage_and_rank_errors():
    mine, theirs = _both(4, 1)
    assert mine.tp_size == 4 and mine.layer_range(0, 5) == theirs.layer_range(0, 5) == (0, 5)
    for bad in (lambda t: t.pp_rank(4), lambda t: t.rank(1, 0)):
        msgs = []
        for t in (mine, theirs):
            with pytest.raises(ValueError) as err:
                bad(t)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# -- make_mesh ----------------------------------------------------------------

SHAPES = [dict(tp=2), dict(tp=4), dict(pp=2), dict(pp=4), dict(dp=2), dict(ep=2), dict(sp=2),
          dict(pp=2, tp=2), dict(pp=4, tp=2), dict(pp=2, tp=4), dict(dp=2, tp=2),
          dict(ep=2, tp=2), dict(ep=2, pp=2), dict(dp=2, pp=2, ep=2)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(f"{k}{v}" for k, v in s.items()))
def test_make_mesh_lays_devices_out_as_jax(shape):
    """The same axis extents and the same device at every coordinate."""
    jm = j_make_mesh(**shape)
    pm = make_mesh(**shape, devices=[torch.device("cpu", i) for i in range(8)])
    assert pm.shape == dict(jm.shape)
    assert pm.grid.shape == jm.devices.shape
    for coord in np.ndindex(*jm.devices.shape):
        assert pm.grid[coord].index == jm.devices[coord].id
    assert pm.size == jm.devices.size and pm.first == pm.grid.reshape(-1)[0]


def test_make_mesh_errors_match_jax():
    for shape in (dict(tp=16), dict(pp=3, tp=3), dict(dp=2, ep=2, sp=4)):
        msgs = []
        for fn, devs in ((j_make_mesh, None), (make_mesh, ["cpu"] * 8)):
            with pytest.raises(ValueError) as err:
                fn(**shape, **({} if devs is None else {"devices": devs}))
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh(tp=0, devices=["cpu"])


# -- the shards ---------------------------------------------------------------

ARCHS = {
    "llama_q40": dict(arch=ArchType.LLAMA, dim=128, n_heads=4, n_kv_heads=4, hidden_dim=256,
                      n_layers=4),
    "llama_dense": dict(arch=ArchType.LLAMA, dim=128, n_heads=4, n_kv_heads=4, hidden_dim=256,
                        n_layers=4, weight_type=FloatType.F32),
    "qwen3": dict(arch=ArchType.QWEN3, dim=128, rope_type=RopeType.FALCON, n_heads=8,
                  n_kv_heads=4, hidden_dim=128, n_layers=4),
    "qwen3_moe": dict(arch=ArchType.QWEN3_MOE, rope_type=RopeType.FALCON, dim=128, n_heads=4,
                      n_kv_heads=4, n_experts=4, n_active_experts=2, moe_hidden_dim=128,
                      hidden_dim=128, n_layers=4),
}
SHARD_MESHES = [dict(tp=2), dict(tp=4), dict(pp=2), dict(pp=4), dict(pp=2, tp=2),
                dict(ep=2), dict(ep=2, tp=2), dict(dp=2, tp=2)]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    out = {}
    for name, kw in ARCHS.items():
        path = str(d / f"{name}.m")
        write_tiny_model(path, tiny_header(**kw), seed=11)
        out[name] = path
    return out


def _jax_tree(p) -> dict:
    """A JAX ModelParams as params_from_jax takes it (test_torch_moe.py's)."""
    def conv(w):
        if w is None:
            return None
        if hasattr(w, "q") and hasattr(w, "d"):
            return {"q": np.asarray(w.q), "d": np.asarray(w.d)}
        return np.asarray(w)

    layers = {f.name: conv(getattr(p.layers, f.name)) for f in dataclasses.fields(p.layers)}
    return {"embedding": conv(p.embedding), "final_norm": conv(p.final_norm),
            "wcls": conv(p.wcls), "layers": layers}


def _assert_same(a, b, name):
    if a is None or b is None:
        assert a is None and b is None, name
    elif isinstance(a, QuantTensor):
        _assert_same(a.q, b.q, name + ".q")
        _assert_same(a.d, b.d, name + ".d")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def _np(t) -> np.ndarray:
    return t.numpy()


def _shard_on(arr, dev) -> np.ndarray:
    return np.asarray(next(s.data for s in arr.addressable_shards if s.device == dev))


def _assert_shard(jw, pw, dev, name):
    if jw is None:
        assert pw is None, name
        return
    if isinstance(pw, QuantTensor):
        for part in ("q", "d"):
            np.testing.assert_array_equal(_np(getattr(pw, part)),
                                          _shard_on(getattr(jw, part), dev), err_msg=name)
    else:
        np.testing.assert_array_equal(_np(pw), _shard_on(jw, dev), err_msg=name)


def _assert_wcls_shard(jw, pw, width, dev, name):
    """The classifier's shard: JAX's block in its first `width` columns,
    and a Q40 shard's lane padding past them all zeros."""
    if isinstance(pw, QuantTensor):
        assert pw.out_features % 128 == 0 or pw.out_features == width, name
        for part in ("q", "d"):
            x = _np(getattr(pw, part))
            np.testing.assert_array_equal(x[..., :width], _shard_on(getattr(jw, part), dev),
                                          err_msg=name)
            assert not x[..., width:].any(), name
    else:
        _assert_shard(jw, pw, dev, name)


def _mesh_id(shape) -> str:
    return "x".join(f"{k}{v}" for k, v in shape.items())


# ep splits expert stacks: the MoE model only
SHARD_CASES = [(a, s) for a in ARCHS for s in SHARD_MESHES if a == "qwen3_moe" or "ep" not in s]


@pytest.mark.parametrize("arch,shape", SHARD_CASES,
                         ids=[f"{a}-{_mesh_id(s)}" for a, s in SHARD_CASES])
def test_shards_equal_the_jax_device_blocks(models, arch, shape):
    """Every role's shard in every mesh cell equals the block JAX's
    pipeline shardings leave on that cell's device."""
    path = models[arch]
    jr = JReader(path)
    jcfg = j_config(jr.header, compute_dtype="float32")
    jmesh = j_make_mesh(**shape)
    jp = j_load_params(jr, jcfg, shardings=pp_param_shardings(jmesh, moe=jcfg.is_moe),
                       tp=jmesh.shape["tp"])
    with MFileReader(path) as r:
        cfg = config_from_header(r.header, compute_dtype="float32")
        params = load_params(r, cfg, device="cpu")
    n = int(np.prod(list(shape.values())))
    pmesh = make_mesh(**shape, devices=["cpu"] * n)
    mp = shard_params(cfg, params, pmesh)
    roles = [f.name for f in dataclasses.fields(mp.stage(0, 0, 0, CPU))]
    expert_roles = ("w1", "w2", "w3") if cfg.is_moe else ()
    for coord in np.ndindex(*jmesh.devices.shape):
        d, p, e, t, s = coord
        jdev = jmesh.devices[coord]
        for role in roles:
            if role in ("q", "k", "v"):
                continue
            cell = mp.stage(p, e if role in expert_roles else 0, t, CPU)
            _assert_shard(getattr(jp.layers, role), getattr(cell, role), jdev, f"{role}@{coord}")
        _assert_wcls_shard(jp.wcls, mp.wcls[(t, CPU)], mp.vocab_shard, jdev, f"wcls@{coord}")
        np.testing.assert_array_equal(_np(mp.replicated("embedding", CPU)),
                                      _shard_on(jp.embedding, jdev))
        np.testing.assert_array_equal(_np(mp.replicated("final_norm", CPU)),
                                      _shard_on(jp.final_norm, jdev))
    scfg = shard_config(cfg, pmesh)
    assert (scfg.n_heads, scfg.n_kv_heads, scfg.n_layers) == (
        cfg.n_heads // pmesh.tp, cfg.n_kv_heads // pmesh.tp, cfg.n_layers // pmesh.pp)
    assert scfg.n_experts == cfg.n_experts
    for w in mp.tensors():
        assert w.is_contiguous()


@pytest.mark.parametrize("arch", ["llama_q40", "llama_dense", "qwen3_moe"])
@pytest.mark.parametrize("tp", [2, 4])
def test_params_from_jax_undoes_the_tp_interleave(models, arch, tp):
    """JAX params loaded for a tp mesh (fused wqkv / w13 interleaved per
    shard) carry across to the port's tp = 1 load exactly."""
    path = models[arch]
    jr = JReader(path)
    jp = j_load_params(jr, j_config(jr.header, compute_dtype="float32"), tp=tp)
    with MFileReader(path) as r:
        cfg = config_from_header(r.header, compute_dtype="float32")
        mine = load_params(r, cfg, device="cpu")
    carried = params_from_jax(_jax_tree(jp), device="cpu", tp=tp)
    for f in ("embedding", "final_norm", "wcls"):
        _assert_same(getattr(mine, f), getattr(carried, f), f)
    for f in dataclasses.fields(mine.layers):
        _assert_same(getattr(mine.layers, f.name), getattr(carried.layers, f.name), f.name)
    # the JAX layout really was interleaved: taken as it is, it differs
    plain = params_from_jax(_jax_tree(jp), device="cpu")
    w, v = plain.layers.wqkv, mine.layers.wqkv
    assert not torch.equal(*((w.q, v.q) if isinstance(w, QuantTensor) else (w, v)))


@pytest.mark.parametrize("arch,shape,match", [
    ("llama_q40", dict(pp=3), "n_layers"),
    ("qwen3", dict(tp=8), "n_kv_heads"),
    ("llama_q40", dict(ep=2), "expert count"),
    ("qwen3_moe", dict(ep=8), "expert count"),
])
def test_check_mesh_refuses_what_does_not_split(models, arch, shape, match):
    with MFileReader(models[arch]) as r:
        cfg = config_from_header(r.header, compute_dtype="float32")
    n = int(np.prod(list(shape.values())))
    with pytest.raises(ValueError, match=match):
        check_mesh(cfg, make_mesh(**shape, devices=["cpu"] * n))


def test_mesh_kv_layout_and_global_split_join(models):
    """The cache's shards are JAX's `pp_cache_sharding` blocks' shapes; a
    global prefix slice splits into (pp, tp) blocks and joins back."""
    with MFileReader(models["qwen3"]) as r:
        cfg = config_from_header(r.header, compute_dtype="float32")
    mesh = make_mesh(dp=2, pp=2, tp=2, devices=["cpu"] * 8)
    kv = mesh_kv(cfg, mesh, batch=4, seq_len=256)
    assert len(kv) == 8 and kv.seq_len == 256
    for shard in kv:
        assert tuple(shard.k.shape) == (cfg.n_layers // 2, 2, 256, cfg.n_kv_heads // 2,
                                        cfg.head_dim)
    x = torch.randn(cfg.n_layers, 48, cfg.n_kv_heads, cfg.head_dim,
                    generator=torch.Generator().manual_seed(0))
    blocks = split_global(x, mesh, 0, 2)
    assert blocks[(1, 1)].shape == (cfg.n_layers // 2, 48, cfg.n_kv_heads // 2, cfg.head_dim)
    assert torch.equal(join_global(blocks, mesh, 0, 2), x)


def test_jax_sees_eight_host_devices():
    assert len(jax.devices()) == 8
