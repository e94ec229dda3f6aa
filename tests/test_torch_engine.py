"""The slice as a whole: the port's engine and CLI against the JAX package's.

bf16: the port on the CPU (every kernel wrapper takes its plain version)
against the JAX engine with its Pallas kernels in interpret mode
(DLT_PALLAS_INTERPRET=1) — the same numerics arm. f32: the port against the
JAX engine's default CPU path (the exact XLA arm).

On the bf16 arm the two sides compute the same function up to the order of
f32 sums (torch's and XLA's reductions, dots and exp differ in the last
ulp). Three roundings turn such ulps into discrete steps: the bf16 cast of
each matmul input, the int8 re-quantization of each decode matmul input,
and the bf16 rounding of the cache and of flash attention's P. After a long
prefill about 10% of the cached bf16 values differ by one bf16 ulp, the
logits by ~1% of their scale, and greedy decoding follows the same tokens
until a near-tie: over model seeds 0-19 at this shape the first differing
token came after 0 to 72+ tokens (median ~30). The token test below uses a
model seed on which both architectures agree over the whole run; the logits
tests hold every seed to a stated bound.
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu import cli as jcli
from distributed_llama_tpu.formats.mfile import ArchType
from distributed_llama_tpu.ops.sampling import _sample_topp as j_sample_topp
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu.testing import tiny_header, write_tiny_model, write_tiny_tokenizer
from distributed_llama_tpu_torch import cli as pcli
from distributed_llama_tpu_torch.ops.sampling import (
    _sample_topp,
    sample_logits_device,
    sample_logits_per_row,
    sample_logits_traced,
    sampler_arm,
)
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine, chunk_plan

# tiny shapes: torch's intra-op threads would only contend with the JAX
# tests that share the CPU under pytest-xdist
torch.set_num_threads(1)

_ARCHS = {
    "llama": dict(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                  vocab_size=512, seq_len=512),
    "qwen3": dict(arch=ArchType.QWEN3, dim=256, hidden_dim=512, n_layers=2, n_heads=4,
                  n_kv_heads=2, head_dim=64, vocab_size=512, seq_len=512),
}
# prefill covers 229 tokens: seven 32-row chunks (the bf16-dequant arm and
# flash at t=32) and a 5-token tail padded to 8 rows (the integer-dot arm
# and flash at t=8). Decode then runs 16-token chunks from position 229
# across the 256 kv-bucket boundary.
PROMPT = [(7 * i) % 500 + 1 for i in range(230)]
N_DECODE = 72
CHUNK = 16


def _jax_engine(path, monkeypatch, interpret, dtype):
    if interpret:
        monkeypatch.setenv("DLT_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("DLT_PALLAS_INTERPRET", raising=False)
    return JEngine(path, compute_dtype=dtype, decode_chunk_size=CHUNK, kv_layout="contiguous",
                   speculative="off", prefix_cache_mb=0, grammar=False)


@pytest.fixture(scope="module", params=sorted(_ARCHS))
def model(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp(request.param) / "m.m")
    write_tiny_model(path, tiny_header(**_ARCHS[request.param]), seed=8)
    return path


def test_prefill_plan_covers_both_arms():
    plan = list(chunk_plan(len(PROMPT) - 1, 0, 32, 512))
    sizes = [s for _, s, _ in plan]
    assert max(sizes) > 8 and min(sizes) <= 8
    assert len(PROMPT) - 1 + N_DECODE > 256 > len(PROMPT) - 1


def test_bf16_greedy_tokens_match_interpret_mode_jax(model, monkeypatch):
    steps = len(PROMPT) - 1 + N_DECODE
    je = _jax_engine(model, monkeypatch, interpret=True, dtype="bfloat16")
    assert je.cfg.pallas_interpret
    want = je.generate(PROMPT, steps, sampler=None).tokens[len(PROMPT):]
    pe = InferenceEngine(model, device="cpu", decode_chunk_size=CHUNK)
    got = pe.generate(PROMPT, steps, sampler=None).tokens[len(PROMPT):]
    assert len(want) == N_DECODE
    assert got == want
    # the next step's logits, after the same tokens: the module docstring's
    # bf16/int8 rounding steps leave them ~1% of their scale apart
    pos = len(PROMPT) - 1 + N_DECODE
    jl = je.decode_one(want[-1], pos)
    pl = pe.decode_one(got[-1], pos)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=5e-2 * float(np.abs(jl).max()))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_prefill", [8, 32])
def test_bf16_first_logits_match_interpret_mode_jax(tmp_path, monkeypatch, seed, n_prefill):
    """Every seed, after an 8-row prefill (the integer-dot arm, flash at
    t=8) or a 32-row one (the bf16-dequant arm): the first decode logits are
    equal to f32 order when no rounding step of the module docstring flips,
    and ~1% of their scale apart when one does; the bound is 5% of their
    scale. A wrong kernel or layout moves logits by their whole scale."""
    path = str(tmp_path / "m.m")
    write_tiny_model(path, tiny_header(**_ARCHS["llama"]), seed=seed)
    je = _jax_engine(path, monkeypatch, interpret=True, dtype="bfloat16")
    pe = InferenceEngine(path, device="cpu", decode_chunk_size=CHUNK)
    prompt = PROMPT[: n_prefill + 1]
    je.prefill(prompt[:-1])
    pe.prefill(prompt[:-1])
    jl = je.decode_one(prompt[-1], n_prefill)
    pl = pe.decode_one(prompt[-1], n_prefill)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=5e-2 * float(np.abs(jl).max()))
    assert np.corrcoef(pl[0], jl[0])[0, 1] > 0.999


def test_f32_logits_match_the_jax_xla_arm(model, monkeypatch):
    je = _jax_engine(model, monkeypatch, interpret=False, dtype="float32")
    pe = InferenceEngine(model, compute_dtype="float32", device="cpu", decode_chunk_size=CHUNK)
    prompt = PROMPT[:40]
    je.prefill(prompt[:-1])
    pe.prefill(prompt[:-1])
    jl = je.decode_one(prompt[-1], len(prompt) - 1)
    pl = pe.decode_one(prompt[-1], len(prompt) - 1)
    # f32 throughout with exact dequantized weights: summation order only
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)
    steps = len(prompt) + 20
    je.reset()
    pe.reset()
    assert pe.generate(prompt, steps).tokens == je.generate(prompt, steps).tokens


def _pred_texts(out: str) -> list[str]:
    return [line.split("|", 1)[1] for line in out.splitlines() if line.startswith("🔶 Pred")]


def test_cli_prints_the_jax_cli_tokens(tmp_path, monkeypatch, capsys):
    mp, tp = str(tmp_path / "m.m"), str(tmp_path / "t.t")
    write_tiny_model(mp, tiny_header(**_ARCHS["llama"]), seed=5)
    write_tiny_tokenizer(tp, pad_to=512)
    args = ["inference", "--model", mp, "--tokenizer", tp, "--prompt",
            "hello world, the brown fox jumps over the lazy dog", "--steps", "80",
            "--temperature", "0"]
    monkeypatch.setenv("DLT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DLT_GRAMMAR", "0")
    assert jcli.main(args + ["--kv-layout", "contiguous", "--speculative", "off",
                             "--prefix-cache-mb", "0"]) == 0
    want = _pred_texts(capsys.readouterr().out)
    assert pcli.main(args + ["--device", "cpu", "--speculative", "off"]) == 0
    out = capsys.readouterr().out
    assert want and _pred_texts(out) == want
    assert "Prediction" in out and "tokens/s:" in out


def _cli_speculation_tokens(tmp_path, monkeypatch, capsys, header, seed):
    """(the JAX CLI's Pred lines, the port's) at both CLIs' defaults (ngram
    speculation), then the port's with `--speculative off`."""
    mp, tp = str(tmp_path / "m.m"), str(tmp_path / "t.t")
    write_tiny_model(mp, tiny_header(**header), seed=seed)
    write_tiny_tokenizer(tp, pad_to=512)
    args = ["inference", "--model", mp, "--tokenizer", tp, "--prompt",
            "hello world, the brown fox jumps over the lazy dog", "--steps", "80",
            "--temperature", "0"]
    monkeypatch.setenv("DLT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DLT_GRAMMAR", "0")
    for name in ("DLT_SPECULATIVE", "DLT_DRAFT_K", "DLT_PREFIX_CACHE_MB"):
        monkeypatch.delenv(name, raising=False)
    assert jcli.main(args) == 0
    want = _pred_texts(capsys.readouterr().out)
    assert pcli.main(args + ["--device", "cpu"]) == 0
    got = _pred_texts(capsys.readouterr().out)
    assert pcli.main(args + ["--device", "cpu", "--speculative", "off"]) == 0
    return want, got, _pred_texts(capsys.readouterr().out)


def test_cli_defaults_print_the_jax_cli_tokens_with_speculation(tmp_path, monkeypatch, capsys):
    """Neither CLI given `--speculative`: both run ngram speculation, their
    default, and print the same greedy tokens in the same rounds (a Pred
    line per verify round or fallback chunk)."""
    want, got, off = _cli_speculation_tokens(tmp_path, monkeypatch, capsys, _ARCHS["llama"], 5)
    assert want and got == want
    # the rounds are not the chunks of a run without speculation
    assert off != got


_MOE = dict(arch=ArchType.QWEN3_MOE, dim=256, hidden_dim=256, n_layers=2, n_heads=4,
            n_kv_heads=2, head_dim=64, n_experts=16, n_active_experts=2, moe_hidden_dim=256,
            vocab_size=512, seq_len=512)


def test_cli_defaults_print_the_jax_cli_tokens_with_speculation_on_moe(tmp_path, monkeypatch,
                                                                       capsys):
    """The same on the tiny Qwen3-MoE model: both CLIs speculate by
    default, and the port's rounds of 2-15 tokens run the MoE FFN on K4 at
    the gather arm's weights (`moe_small_rows_grouped`), where JAX gathers:
    the same rounds and tokens."""
    want, got, off = _cli_speculation_tokens(tmp_path, monkeypatch, capsys, _MOE, 0)
    assert want and got == want
    assert off != got


def test_cli_refuses_what_is_not_ported(tmp_path):
    """`--speculative model` without `--draft-model` raises ValueError in
    every mode, as in the JAX CLI (`make_engine`)."""
    mp = str(tmp_path / "m.m")
    write_tiny_model(mp, tiny_header(**_ARCHS["llama"]), seed=5)
    base = ["inference", "--model", mp, "--tokenizer", mp, "--prompt", "x", "--steps", "4",
            "--device", "cpu"]
    for mode in ("inference", "perplexity", "chat"):
        with pytest.raises(ValueError, match="--draft-model"):
            pcli.main([mode] + base[1:] + ["--speculative", "model"])


def test_engine_without_device_needs_a_gpu(monkeypatch, tmp_path):
    mp = str(tmp_path / "m.m")
    write_tiny_model(mp, tiny_header(**_ARCHS["llama"]), seed=5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(mp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(mp, device="cuda")


@pytest.mark.parametrize("topp", [0.3, 0.9])
def test_topp_matches_jax(topp):
    rng = np.random.default_rng(int(topp * 10))
    logits = rng.standard_normal((3, 512)).astype(np.float32) * 3
    logits[1, 7] = logits[1, 9] = logits[1].max() + 1  # a tie at the top
    probs = torch.softmax(torch.from_numpy(logits), dim=-1)
    coin = rng.random((3, 1)).astype(np.float32)
    import jax.numpy as jnp

    want = np.asarray(j_sample_topp(jnp.asarray(probs.numpy()), None, topp, coin=jnp.asarray(coin)))
    got = _sample_topp(probs, topp, torch.from_numpy(coin))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temperature,topp", [
    (0.0, 0.9), (0.7, 0.3), (0.7, 0.9), (1.0, 1.0), (0.8, 1.5), (1.3, 0.0)])
def test_sampled_step_matches_jax_traced_arms(temperature, topp):
    """The decode step's sampling math (`sample_logits_device`, which the
    eager and the graphed batch-1 step run) against the JAX program's
    scalar arms (`sample_logits_traced`: greedy, the top-p arm, and the
    full distribution at topp outside (0, 1)) on the same logits, with the
    port handed the coin JAX draws from its key."""
    import jax
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.sampling import sample_logits_traced as j_traced

    b = 4
    rng = np.random.default_rng(int(temperature * 10 + topp * 100))
    logits = rng.standard_normal((b, 512)).astype(np.float32) * 3
    logits[1, 7] = logits[1, 9] = logits[1].max() + 1  # a tie at the top
    key = jax.random.PRNGKey(int(topp * 10))
    want = np.asarray(j_traced(jnp.asarray(logits), key, jnp.float32(temperature),
                               jnp.float32(topp)))
    coin = torch.from_numpy(np.array(jax.random.uniform(key, (b, 1))))
    lt = torch.from_numpy(logits)
    temp, topp_v = torch.full((b,), temperature), torch.full((b,), topp)
    np.testing.assert_array_equal(sample_logits_per_row(lt, coin, temp, topp_v).numpy(), want)
    # the step's one draw a row from its generator, then that math
    drawn = torch.rand((b, 1), generator=torch.Generator().manual_seed(3))
    got = sample_logits_device(lt, temp, topp_v, torch.Generator().manual_seed(3))
    assert torch.equal(got, sample_logits_per_row(lt, drawn, temp, topp_v))
    traced = sample_logits_traced(lt, temperature, topp, torch.Generator().manual_seed(3))
    assert torch.equal(traced, got if temperature > 0 else torch.argmax(lt, dim=-1))


def test_sampler_arm_reads_the_host_settings():
    assert sampler_arm(0.0, 0.9) == "greedy" and sampler_arm(-1.0, 0.5) == "greedy"
    assert sampler_arm(0.8, 0.9) == "topp"
    assert sampler_arm(0.8, 1.0) == "full" and sampler_arm(0.8, 0.0) == "full"
    assert sampler_arm(0.8, 1.5) == "full"
    assert sampler_arm(0.8, 1 - 1e-9) == "full"  # 1.0 in f32, as on the device
    # per row: a greedy row's top-p does not count
    assert sampler_arm(np.array([0.0, 0.0]), np.array([0.9, 0.9])) == "greedy"
    assert sampler_arm(np.array([0.0, 0.7]), np.array([0.9, 1.0])) == "full"
    assert sampler_arm(np.array([0.7, 0.7]), np.array([1.0, 0.5])) == "topp"


@pytest.mark.parametrize("topp", [[1.0, 1.0, 0.0, 0.9], [1.5, 1.0, 1.0, 0.3]])
def test_full_arm_skips_the_sort_with_the_same_tokens(topp):
    """Without the top-p arm (no sampled row's topp in (0, 1); the last
    row here is greedy) the rows take the same tokens, bit for bit."""
    rng = np.random.default_rng(17)
    logits = torch.from_numpy(rng.standard_normal((4, 512)).astype(np.float32) * 3)
    coin = torch.from_numpy(rng.random((4, 1)).astype(np.float32))
    temp = torch.tensor([0.7, 1.0, 1.3, 0.0])
    topp_v = torch.tensor(topp)
    assert sampler_arm(temp.numpy(), topp_v.numpy()) == "full"
    want = sample_logits_per_row(logits, coin, temp, topp_v)
    assert torch.equal(sample_logits_per_row(logits, coin, temp, topp_v, topp_arm=False), want)


def test_greedy_takes_the_first_maximum():
    logits = torch.tensor([[0.0, 3.0, 1.0, 3.0], [5.0, 5.0, 5.0, 5.0]])
    assert sample_logits_traced(logits, 0.0, 0.9).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    draws = sample_logits_traced(logits.repeat(50, 1), 1.0, 0.9, generator=gen)
    assert set(draws.tolist()) <= {0, 1, 2, 3}
