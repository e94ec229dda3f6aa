"""Weights: the JAX loader's ModelParams carried over with params_from_jax
equal the port's own load_params bit for bit (tiny Llama and Qwen3)."""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_llama_tpu.formats.mfile import ArchType, MFileReader as JReader
from distributed_llama_tpu.models import config_from_header as j_config
from distributed_llama_tpu.models import load_params as j_load
from distributed_llama_tpu.testing import tiny_header, write_tiny_model
from distributed_llama_tpu_torch.formats.mfile import MFileReader
from distributed_llama_tpu_torch.models import config_from_header, load_params, params_from_jax
from distributed_llama_tpu_torch.models.params import init_kv_cache
from distributed_llama_tpu_torch.ops.quant import QuantTensor

# tiny shapes: torch's intra-op threads would only contend with the JAX
# tests that share the CPU under pytest-xdist
torch.set_num_threads(1)

_ARCHS = {
    "llama": dict(dim=256, hidden_dim=512, n_layers=3, n_heads=4, n_kv_heads=2,
                  vocab_size=512, seq_len=512),
    "qwen3": dict(arch=ArchType.QWEN3, dim=256, hidden_dim=512, n_layers=2, n_heads=4,
                  n_kv_heads=2, head_dim=64, vocab_size=512, seq_len=512),
}


def jax_params_to_numpy(p) -> dict:
    """The JAX ModelParams as numpy, keyed by its field names."""

    def conv(w):
        if w is None:
            return None
        if hasattr(w, "q") and hasattr(w, "d"):
            return {"q": np.asarray(w.q), "d": np.asarray(w.d)}
        return np.asarray(w)

    layers = {f.name: conv(getattr(p.layers, f.name)) for f in dataclasses.fields(p.layers)}
    return {"embedding": conv(p.embedding), "final_norm": conv(p.final_norm),
            "wcls": conv(p.wcls), "layers": layers}


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.cpu()
    if a.dtype in (torch.float16, torch.bfloat16):
        a = a.view(torch.int16)
    return a.numpy()


def _assert_same(a, b, name):
    if a is None or b is None:
        assert a is None and b is None, name
        return
    if isinstance(a, QuantTensor):
        assert isinstance(b, QuantTensor), name
        _assert_same(a.q, b.q, name + ".q")
        _assert_same(a.d, b.d, name + ".d")
        return
    assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


@pytest.mark.parametrize("arch", sorted(_ARCHS))
def test_params_from_jax_equals_load_params(tmp_path, arch):
    path = str(tmp_path / "m.m")
    write_tiny_model(path, tiny_header(**_ARCHS[arch]), seed=11)
    with JReader(path) as jr:
        jparams = j_load(jr, j_config(jr.header, compute_dtype="bfloat16"))
        tree = jax_params_to_numpy(jparams)
    with MFileReader(path) as r:
        cfg = config_from_header(r.header, compute_dtype="bfloat16")
        mine = load_params(r, cfg, device="cpu")
    carried = params_from_jax(tree, device="cpu")
    for f in ("embedding", "final_norm", "wcls"):
        _assert_same(getattr(mine, f), getattr(carried, f), f)
    for f in dataclasses.fields(mine.layers):
        _assert_same(getattr(mine.layers, f.name), getattr(carried.layers, f.name), f.name)
    # layouts the kernels rely on
    assert mine.embedding.dtype == torch.float32
    assert mine.layers.wqkv.q.shape == (cfg.n_layers, cfg.dim // 8, cfg.q_dim + 2 * cfg.kv_dim)
    assert mine.layers.wqkv.d.dtype == torch.float16
    assert (mine.layers.q_norm is not None) == (arch == "qwen3")


def test_params_from_jax_refuses_unfused_fields():
    tree = {"embedding": np.zeros((4, 4), np.float32), "final_norm": np.zeros(4, np.float32),
            "wcls": np.zeros((4, 4), np.float32), "layers": {"q": np.zeros((1, 4, 4), np.float32)}}
    with pytest.raises(ValueError, match="'q'"):
        params_from_jax(tree)


def test_kv_cache_layout():
    h = tiny_header(**_ARCHS["llama"])
    cfg = config_from_header(h)
    c = init_kv_cache(cfg, batch=1, device="cpu")
    assert c.k.shape == (3, 1, 512, 2, 64) and c.k.dtype == torch.bfloat16
    assert config_from_header(h, compute_dtype="float32").kv_dtype == torch.float32
