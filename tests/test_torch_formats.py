"""The port's copies of the host codecs (formats/, tokenizer.py, testing.py)
against the JAX package's originals: same bytes written, same values read.
Exact equality throughout — these are the same numpy algorithms."""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_llama_tpu import testing as jt
from distributed_llama_tpu import tokenizer as jtok
from distributed_llama_tpu.formats import mfile as jm
from distributed_llama_tpu.formats import quants as jq
from distributed_llama_tpu.formats import tfile as jtf
from distributed_llama_tpu.ops import quant as jquant
from distributed_llama_tpu_torch import testing as pt
from distributed_llama_tpu_torch import tokenizer as ptok
from distributed_llama_tpu_torch.formats import mfile as pm
from distributed_llama_tpu_torch.formats import quants as pq
from distributed_llama_tpu_torch.formats import tfile as ptf
from distributed_llama_tpu_torch.ops import quant as pquant

# tiny shapes: torch's intra-op threads would only contend with the JAX
# tests that share the CPU under pytest-xdist
torch.set_num_threads(1)

_HEADERS = {
    "llama": dict(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                  vocab_size=512, seq_len=512),
    "llama31_hd128": dict(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                          head_dim=128, vocab_size=512, seq_len=512, rope_type=2,
                          rope_scaling_factor=32.0, rope_theta=500000.0),
    "qwen3": dict(arch=pm.ArchType.QWEN3, dim=256, hidden_dim=512, n_layers=2, n_heads=4,
                  n_kv_heads=2, head_dim=64, vocab_size=512, seq_len=512),
}


@pytest.mark.parametrize("kind", sorted(_HEADERS))
@pytest.mark.parametrize("seed", [0, 7])
def test_write_tiny_model_is_byte_identical(tmp_path, kind, seed):
    a, b = tmp_path / "jax.m", tmp_path / "port.m"
    jt.write_tiny_model(str(a), jt.tiny_header(**_HEADERS[kind]), seed=seed)
    pt.write_tiny_model(str(b), pt.tiny_header(**_HEADERS[kind]), seed=seed)
    assert a.read_bytes() == b.read_bytes()


def test_write_tiny_tokenizer_is_byte_identical(tmp_path):
    a, b = tmp_path / "jax.t", tmp_path / "port.t"
    jt.write_tiny_tokenizer(str(a), pad_to=600, chat_template="{{x}}")
    pt.write_tiny_tokenizer(str(b), pad_to=600, chat_template="{{x}}")
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("kind", sorted(_HEADERS))
def test_mfile_reads_back_identically(tmp_path, kind):
    path = str(tmp_path / "m.m")
    jt.write_tiny_model(path, jt.tiny_header(**_HEADERS[kind]), seed=3)
    with jm.MFileReader(path, max_seq_len=300) as jr, pm.MFileReader(path, max_seq_len=300) as pr:
        assert dataclasses.asdict(jr.header) == dataclasses.asdict(pr.header)
        assert pr.header.seq_len == 300 and pr.header.orig_seq_len == 512
        assert [(s.name, s.shape, s.offset, s.float_type) for s in jr.specs] == [
            (s.name, s.shape, s.offset, s.float_type) for s in pr.specs
        ]
        for js, ps in zip(jr.specs, pr.specs):
            np.testing.assert_array_equal(jr.tensor_f32(js), pr.tensor_f32(ps))
            if js.float_type == jq.FloatType.Q40:
                for x, y in zip(jr.tensor_q40(js), pr.tensor_q40(ps)):
                    np.testing.assert_array_equal(x, y)


def test_q40_bytes_regroup_equals_the_jax_t_layout(tmp_path):
    """The loader's byte regroup gives the JAX package's packed T layout bit
    for bit, at an out that is not a power of two."""
    path = str(tmp_path / "m.m")
    jt.write_tiny_model(path, jt.tiny_header(**_HEADERS["llama"]), seed=5)
    with jm.MFileReader(path) as r:
        for name in ("q.l0", "k.l1", "w2.l0", "wcls"):
            spec = r.by_name[name]
            want_q, want_d = jquant.q40_to_t_layout(*r.tensor_q40(spec))
            raw = torch.from_numpy(np.frombuffer(r.raw(spec), np.uint8).copy())
            got_q, got_d = pquant.q40_bytes_to_t_layout(raw, *spec.shape)
            np.testing.assert_array_equal(got_q.numpy(), want_q)
            np.testing.assert_array_equal(got_d.numpy().view(np.uint16), want_d.view(np.uint16))
            # and the port's own numpy codec agrees with both
            pq_q, pq_d = pquant.q40_to_t_layout(*r.tensor_q40(spec))
            np.testing.assert_array_equal(pq_q, want_q)
            np.testing.assert_array_equal(pquant.unpack_q(got_q).numpy(),
                                          np.transpose(r.tensor_q40(spec)[0], (1, 2, 0)))


def test_quant_codecs_agree():
    x = np.random.default_rng(0).standard_normal(32 * 40).astype(np.float32)
    assert jq.quantize_q40(x) == pq.quantize_q40(x)
    assert jq.quantize_q80(x) == pq.quantize_q80(x)
    np.testing.assert_array_equal(
        jq.dequantize_q40(jq.quantize_q40(x), x.size), pq.dequantize_q40(pq.quantize_q40(x), x.size)
    )


def test_tfile_and_tokenizer_agree(tmp_path):
    path = str(tmp_path / "t.t")
    jt.write_tiny_tokenizer(path, pad_to=700, chat_template="<|im_start|>")
    assert dataclasses.asdict(jtf.read_tfile(path)) == dataclasses.asdict(ptf.read_tfile(path))
    jtk, ptk = jtok.Tokenizer(path), ptok.Tokenizer(path)
    for text in ("hello world", "hello wo<s>rld </s> x", "\xe4\xbd\xa0好 bytes", ""):
        ids = jtk.encode(text)
        assert ptk.encode(text) == ids
        assert [ptk.decode(t) for t in ids] == [jtk.decode(t) for t in ids]
    js, ps = jtok.Sampler(700, 0.7, 0.9, 42), ptok.Sampler(700, 0.7, 0.9, 42)
    logits = np.random.default_rng(1).standard_normal(700).astype(np.float32)
    assert [js.sample(logits) for _ in range(20)] == [ps.sample(logits) for _ in range(20)]
