"""The q80_activations parity mode: the port's Q80 round trip and its f32
engines against the JAX package's, on the CPU.

`quantize_q80_activations` is plain torch glue (XLA glue in JAX): the
same float32 inputs give the same bits, all-zero blocks included. With
`q80_activations=True` every Q40 matmul's input goes through it (linear,
the gather arm's experts, the MoE plain arm's rows and h); the JAX
engine's f32 path does the same.

The two engines sum f32 in other orders, so an input may land a last ulp
apart from JAX's; where that ulp sits on a rounding boundary of its
block, the two round it to neighbouring int8 steps (a step is 1/127 of
the block's largest value), and the later round trips carry the step on.
Over model seeds 0-11 at these shapes (`_run` below, both engines) the
first logits after PROMPT agreed to < 5e-7 of their scale on 6 (Llama),
3 (Qwen3) and 4 (Qwen3-MoE) seeds; on the others such a step moved them by 0.6-1.6% of
their scale (41% on one Qwen3-MoE seed, where it changed a token's
expert), and the greedy chains then part at a near-tie. A step is
rounding, not a fault of either side: the JAX package's own parity test
against the reference holds its deep q80 leg statistically for it. So the
engine test uses one seed per architecture on which no step happens over
the run (Llama 5, Qwen3 9, Qwen3-MoE 6, from that scan): the greedy
tokens equal JAX's and the first logits agree to LOGITS_TOL of their
scale, while the engine with the mode off lies 2-7% of it away.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops.quant import quantize_q80_activations as j_q80
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu_torch.formats.mfile import ArchType
from distributed_llama_tpu_torch.models import config_from_header
from distributed_llama_tpu_torch.ops.quant import quantize_q80_activations
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
from distributed_llama_tpu_torch.testing import tiny_header, write_tiny_model

torch.set_num_threads(1)

# the first logits' largest difference against JAX's, as a share of their
# scale, where no input rounds to another int8 step (measured < 5e-7)
LOGITS_TOL = 1e-5
# a seed a architecture with no such step over the run (module docstring)
SEEDS = {"llama": 5, "qwen3": 9, "qwen3_moe": 6}
ARCHS = {
    "llama": dict(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                  vocab_size=512, seq_len=512),
    "qwen3": dict(arch=ArchType.QWEN3, dim=256, hidden_dim=512, n_layers=2, n_heads=4,
                  n_kv_heads=2, head_dim=64, vocab_size=512, seq_len=512),
    # E = 16, k = 2: the 32-row prefill chunk takes the MoE plain (ragged)
    # arm, the tail and decode the gather arm
    "qwen3_moe": dict(arch=ArchType.QWEN3_MOE, dim=256, hidden_dim=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, head_dim=64, n_experts=16, n_active_experts=2,
                      moe_hidden_dim=256, vocab_size=512, seq_len=512),
}
# prefill 39 tokens: a 32-row chunk and a 7-token tail padded to 8 rows
PROMPT = [(7 * i) % 500 + 1 for i in range(40)]
N_DECODE = 48
CHUNK = 16


@pytest.mark.parametrize("scale", [1e-4, 1.0, 300.0])
@pytest.mark.parametrize("shape", [(64,), (3, 256), (2, 5, 96)])
def test_round_trip_equals_jax_bit_for_bit(scale, shape):
    rng = np.random.default_rng(int(scale * 10) + len(shape))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x.reshape(-1, 32)[::3] = 0.0  # all-zero blocks: scale 0, values 0
    want = np.asarray(j_q80(jnp.asarray(x)))
    got = quantize_q80_activations(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not np.any(got.reshape(-1, 32)[::3])


def test_round_trip_is_blockwise_q80():
    """Each block: int8 steps of the f16-rounded scale, the largest value
    at +-127 steps; bf16 inputs come back in bf16."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    y = quantize_q80_activations(x).reshape(-1, 32)
    amax = x.reshape(-1, 32).abs().amax(dim=-1, keepdim=True)
    d16 = (amax / 127.0).to(torch.float16).to(torch.float32)
    steps = y / d16
    assert torch.equal(steps, steps.round()) and steps.abs().max() <= 127
    assert (steps.abs().amax(dim=-1) == 127).all()
    xb = x.to(torch.bfloat16)
    assert quantize_q80_activations(xb).dtype == torch.bfloat16


def test_the_config_field_and_the_engine_argument(tmp_path):
    path = str(tmp_path / "m.m")
    write_tiny_model(path, tiny_header(**ARCHS["llama"]), seed=1)
    e = InferenceEngine(path, compute_dtype="float32", device="cpu", q80_activations=True)
    assert e.cfg.q80_activations
    assert not config_from_header(e.header).q80_activations
    assert not InferenceEngine(path, compute_dtype="float32", device="cpu").cfg.q80_activations


def _run(engine):
    engine.prefill(PROMPT[:-1])
    logits = np.asarray(engine.decode_one(PROMPT[-1], len(PROMPT) - 1))
    engine.reset()
    toks = engine.generate(PROMPT, len(PROMPT) - 1 + N_DECODE, sampler=None).tokens
    return logits, toks[len(PROMPT):]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_f32_q80_engine_matches_the_jax_engine(tmp_path, arch):
    path = str(tmp_path / "m.m")
    write_tiny_model(path, tiny_header(**ARCHS[arch]), seed=SEEDS[arch])
    kw = dict(compute_dtype="float32", decode_chunk_size=CHUNK, kv_layout="contiguous",
              q80_activations=True)
    jl, jt = _run(JEngine(path, speculative="off", prefix_cache_mb=0, grammar=False, **kw))
    pl, pt = _run(InferenceEngine(path, device="cpu", **kw))
    assert pt == jt
    scale = float(np.abs(jl).max())
    assert float(np.abs(pl - jl).max()) <= LOGITS_TOL * scale
    # the mode is on: without the round trip the logits lie percents away
    off = InferenceEngine(path, device="cpu", **{**kw, "q80_activations": False})
    ol, _ = _run(off)
    assert float(np.abs(ol - jl).max()) > 1e-3 * scale
