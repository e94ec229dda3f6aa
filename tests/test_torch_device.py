"""The port's library functions put their tensors on the card unless the
caller asks for the CPU, as the JAX package's land on the default device:
with no device given and no GPU present they raise instead of falling back."""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.device import resolve_device
from distributed_llama_tpu_torch.formats.mfile import MFileReader
from distributed_llama_tpu_torch.models import (
    config_from_header,
    init_kv_cache,
    load_params,
    params_from_jax,
)
from distributed_llama_tpu_torch.models.params import kv_cache_of_shape
from distributed_llama_tpu_torch.ops.rope import build_rope_tables
from distributed_llama_tpu_torch.runtime.paged_kv import init_kv_pool
from distributed_llama_tpu_torch.testing import tiny_header, write_tiny_model


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def header():
    return tiny_header(n_layers=2, n_heads=4, n_kv_heads=2, dim=64, seq_len=64)


def test_resolve_device(no_gpu):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_load_params_needs_a_gpu_by_default(no_gpu, tmp_path, header):
    path = str(tmp_path / "m.m")
    write_tiny_model(path, header, seed=0)
    with MFileReader(path) as r:
        cfg = config_from_header(r.header)
        with pytest.raises(RuntimeError):
            load_params(r, cfg)
        assert load_params(r, cfg, device="cpu").embedding.device.type == "cpu"


def test_init_kv_cache_needs_a_gpu_by_default(no_gpu, header):
    cfg = config_from_header(header)
    with pytest.raises(RuntimeError):
        init_kv_cache(cfg, batch=1)
    assert init_kv_cache(cfg, batch=1, device="cpu").k.device.type == "cpu"


def test_kv_cache_of_shape_needs_a_gpu_by_default(no_gpu, header):
    cfg = config_from_header(header, cache_dtype="int8")
    with pytest.raises(RuntimeError):
        kv_cache_of_shape(cfg, (2, 1, 8, 2, 16))
    assert kv_cache_of_shape(cfg, (2, 1, 8, 2, 16), device="cpu").k_scale.shape == (2, 1, 8, 2)


def test_init_kv_pool_needs_a_gpu_by_default(no_gpu, header):
    cfg = config_from_header(header)
    with pytest.raises(RuntimeError):
        init_kv_pool(cfg, 4, 16)
    assert init_kv_pool(cfg, 4, 16, device="cpu").k.shape[1] == 5


def test_build_rope_tables_needs_a_gpu_by_default(no_gpu, header):
    with pytest.raises(RuntimeError):
        build_rope_tables(header)
    assert build_rope_tables(header, device="cpu").cos.device.type == "cpu"


def test_params_from_jax_needs_a_gpu_by_default(no_gpu):
    """The weights carried across from the JAX package land on the card,
    as the loader's do."""
    L, dim = 2, 64
    w = np.ones((L, dim, dim), np.float32)
    tree = {"embedding": np.ones((32, dim), np.float32), "final_norm": np.ones(dim, np.float32),
            "wcls": np.ones((32, dim), np.float32),
            "layers": {"wqkv": w, "wo": w, "w13": w, "w2": w,
                       "norm0": np.ones((L, dim), np.float32), "norm1": np.ones((L, dim), np.float32)}}
    with pytest.raises(RuntimeError):
        params_from_jax(tree)
    p = params_from_jax(tree, device="cpu")
    assert p.embedding.device.type == "cpu" and p.layers.wqkv.device.type == "cpu"
