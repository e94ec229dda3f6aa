"""Qwen3-MoE: the port's MoE block, loader, engine and CLI against the JAX
package's, on the CPU.

The same inputs, made from a seed with numpy, go through both. The JAX side
runs its Pallas kernels in interpret mode (its bf16 kernel arm) or its XLA
arm (f32); the port's kernel wrappers take their plain versions, which the
card's kernels are held to in tests/test_torch_kernels_gpu.py and
chip_smoke.py.

Router inputs are drawn so that no token has a near-tie at its k-th expert
(the test asserts the gap): a flipped expert moves a row by O(1), which
says nothing about the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu import cli as jcli
from distributed_llama_tpu.formats.mfile import ArchType, MFileReader as JReader
from distributed_llama_tpu.models import config_from_header as j_config
from distributed_llama_tpu.models import load_params as j_load
from distributed_llama_tpu.models import transformer as jtf
from distributed_llama_tpu.ops import moe as jmoe
from distributed_llama_tpu.ops.activations import silu as j_silu
from distributed_llama_tpu.ops.pallas_q40 import q40_matmul_pallas_grouped
from distributed_llama_tpu.ops.quant import QuantTensor as JQuant
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu.testing import tiny_header, write_tiny_model, write_tiny_tokenizer
from distributed_llama_tpu_torch import cli as pcli
from distributed_llama_tpu_torch import testing as pt
from distributed_llama_tpu_torch.formats.mfile import MFileReader
from distributed_llama_tpu_torch.models import config_from_header, load_params, params_from_jax
from distributed_llama_tpu_torch.models import transformer as ptf
from distributed_llama_tpu_torch.ops import cuda_q40, moe
from distributed_llama_tpu_torch.ops.activations import silu
from distributed_llama_tpu_torch.ops.quant import QuantTensor, pack_q
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine

from numpy_reference import NumpyModel

# tiny shapes: torch's intra-op threads would only contend with the JAX
# tests that share the CPU under pytest-xdist
torch.set_num_threads(1)

# E = 16, k = 2: rows = 2t, so a chunk of t >= 8 takes the grouped arm, t = 2
# or 4 the gather arm, decode t = 1 the indexed arm; dim and the expert
# width meet the stacked kernels' alignment (nb % 8, out % 128)
MOE = dict(arch=ArchType.QWEN3_MOE, dim=256, hidden_dim=256, n_layers=2, n_heads=4,
           n_kv_heads=2, head_dim=64, n_experts=16, n_active_experts=2, moe_hidden_dim=256,
           vocab_size=512, seq_len=512)
# prefill 35 tokens: a 32-row chunk (grouped arm) and a 3-token tail padded
# to 4 rows (gather arm); decode runs 16-token chunks from position 35
PROMPT = [(7 * i) % 500 + 1 for i in range(36)]
CHUNK = 16


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _q40_stack(rng, lead, out_f, in_f):
    """Random packed T-layout weights [*lead, nb*4, out] / [*lead, nb, out]."""
    nb = in_f // 32
    qt = rng.integers(-8, 8, size=(*lead, nb, 32, out_f)).astype(np.int8)
    dt = (rng.random((*lead, nb, out_f)) * 0.016 + 0.004).astype(np.float16)
    return pack_q(qt), dt


def _router_inputs(rng, n_tok, E, k, dim):
    """Tokens and a gate whose top-k choice has a margin of 1e-5 of the top
    probability (~100 f32 ulp) for every token: the first such draw of the
    generator."""
    gate = (rng.standard_normal((E, dim)) * 0.2).astype(np.float32)
    for _ in range(50):
        y = rng.standard_normal((1, n_tok, dim)).astype(np.float32)
        probs = torch.softmax(torch.from_numpy(y[0] @ gate.T), dim=-1).numpy()
        srt = -np.sort(-probs, axis=-1)
        if (srt[:, k - 1] - srt[:, k] > 1e-5 * srt[:, 0]).all():
            return y, gate
    raise AssertionError("no draw without a near-tie")


@pytest.mark.parametrize("E,k,n_tok", [(16, 2, 12), (128, 8, 32)])
def test_router_matches_jax(E, k, n_tok):
    y, gate = _router_inputs(np.random.default_rng(E + k), n_tok, E, k, 256)
    ji, jw = jmoe.moe_router(jnp.asarray(y), jnp.asarray(gate), k)
    pi, pw = moe.moe_router(torch.from_numpy(y), torch.from_numpy(gate), k)
    assert pi.dtype == torch.int32 and pi.shape == (1, n_tok, k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    # f32 products and softmax in another order: a few ulp
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)


@pytest.mark.parametrize("rows,E,block_r", [(256, 128, 8), (64, 16, 8), (24, 16, 8),
                                             (128, 4, 32), (512, 8, 64), (5, 128, 8)])
def test_grouped_layout_matches_jax(rows, E, block_r):
    rng = np.random.default_rng(rows + E)
    # leave a third of the groups empty
    live = rng.choice(E, size=max(1, 2 * E // 3), replace=False)
    g = rng.choice(live, size=rows).astype(np.int32)
    jd, jb, jr = jmoe._grouped_layout_direct(jnp.asarray(g), E, block_r)
    pd, pb, pr = moe._grouped_layout_direct(torch.from_numpy(g), E, block_r)
    assert pr == jr
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    assert pb.dtype == torch.int32


@pytest.mark.parametrize("block_r", [8, 16])
def test_grouped_plain_matches_pallas_interpret(block_r):
    """K4's plain version against q40_matmul_pallas_grouped in interpret
    mode, on a flat [L * E] stack with the layer folded into the index."""
    rng = np.random.default_rng(block_r)
    L, E, dim, ff, layer = 3, 8, 256, 384, 2
    q, d = _q40_stack(rng, (L, E), ff, dim)
    g = rng.integers(0, E, size=40).astype(np.int32)
    _, block_expert, R_pad = moe._grouped_layout_direct(torch.from_numpy(g), E, block_r)
    flat_be = (block_expert + layer * E).numpy()
    xp = (rng.standard_normal((R_pad, dim))).astype(np.float32)
    want = q40_matmul_pallas_grouped(
        jnp.asarray(xp), jnp.asarray(q), jnp.asarray(d), jnp.asarray(flat_be), block_r,
        interpret=True,
    )
    got = cuda_q40.q40_grouped_gemm_bf16(
        torch.from_numpy(xp), torch.from_numpy(q), torch.from_numpy(d),
        torch.from_numpy(flat_be), block_r,
    )
    assert got.shape == (R_pad, ff) and got.dtype == torch.float32
    # the same bf16 products, f32 sums in another order
    assert _rel_err(got.numpy(), want) <= 1e-4


def _moe_case(seed, t, E=16, k=2, L=2, dim=256, ff=256):
    rng = np.random.default_rng(seed)
    w1, w3 = _q40_stack(rng, (L, E), ff, dim), _q40_stack(rng, (L, E), ff, dim)
    w2 = _q40_stack(rng, (L, E), dim, ff)
    y, gate = _router_inputs(rng, t, E, k, dim)
    return y, gate, w1, w3, w2


@pytest.mark.parametrize("E,k,t", [(16, 2, 8), (16, 2, 32), (128, 8, 16)])
def test_moe_ffn_ragged_matches_jax(E, k, t):
    y, gate, w1, w3, w2 = _moe_case(E + t, t, E=E, k=k)
    layer = 1
    ji, jw = jmoe.moe_router(jnp.asarray(y), jnp.asarray(gate), k)
    want = jmoe.moe_ffn_ragged(
        jnp.asarray(y), ji, jw, *(JQuant(q=jnp.asarray(a), d=jnp.asarray(b)) for a, b in (w1, w3, w2)),
        j_silu, jnp.bfloat16, pallas="interpret", layer=jnp.int32(layer),
    )
    pi, pw = moe.moe_router(torch.from_numpy(y), torch.from_numpy(gate), k)
    got = moe.moe_ffn_ragged(
        torch.from_numpy(y), pi, pw,
        *(QuantTensor(q=torch.from_numpy(a), d=torch.from_numpy(b)) for a, b in (w1, w3, w2)),
        silu, torch.bfloat16, layer=layer,
    )
    # the same bf16 products, f32 sums in another order (measured < 1e-6 of
    # the scale). h rounds to bf16 for w2, so an f32-order ulp could flip one
    # h element by 2^-8; these pinned inputs do not, and 1e-4 (K2's bound)
    # would catch a wrong expert or row, which moves outputs by O(1)
    assert _rel_err(got.numpy(), want) <= 1e-4


def _tiny_moe(tmp_path, seed):
    path = str(tmp_path / "moe.m")
    write_tiny_model(path, tiny_header(**MOE), seed=seed)
    return path


def _both_params(path, dtype="bfloat16"):
    with JReader(path) as jr:
        jcfg = dataclasses.replace(j_config(jr.header, compute_dtype=dtype), pallas_interpret=True)
        jp = j_load(jr, jcfg)
    with MFileReader(path) as r:
        cfg = config_from_header(r.header, compute_dtype=dtype)
        pp = load_params(r, cfg, device="cpu")
    return jcfg, jp, cfg, pp


@pytest.mark.parametrize("layer", [0, 1])
def test_moe_decode_i8_matches_jax(tmp_path, layer):
    jcfg, jp, cfg, pp = _both_params(_tiny_moe(tmp_path, seed=4))
    rng = np.random.default_rng(layer)
    y = rng.standard_normal((1, 1, cfg.dim)).astype(np.float32)
    gate = np.asarray(jp.layers.moe_gate[layer])
    ji, jw = jmoe.moe_router(jnp.asarray(y), jnp.asarray(gate), cfg.n_active_experts)
    assert ptf._moe_decode_i8_eligible(cfg, torch.from_numpy(y), pp.layers)
    assert jtf._moe_decode_i8_eligible(jcfg, jnp.asarray(y), jp.layers)
    want = jtf._moe_decode_i8(jcfg, jnp.asarray(y), jp.layers, jnp.int32(layer), ji, jw)
    got = ptf._moe_decode_i8(cfg, torch.from_numpy(y), pp.layers, layer,
                             torch.from_numpy(np.array(ji)), torch.from_numpy(np.array(jw)))
    # exact integer partials; f32 block sums and the slot sum in another
    # order (h re-quantizes to int8 for w2, where an ulp could flip a rint)
    assert got.shape == (1, 1, cfg.dim)
    assert _rel_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("t", [2, 3, 7])
def test_gather_arm_matches_jax(tmp_path, t):
    """rows = 2t < E = 16 and t > 1: both sides gather each row's experts."""
    jcfg, jp, cfg, pp = _both_params(_tiny_moe(tmp_path, seed=6))
    y = np.random.default_rng(t).standard_normal((1, t, cfg.dim)).astype(np.float32)
    want = jtf._moe_ffn(jcfg, jnp.asarray(y), jp.layers, jnp.int32(1))
    got = ptf._moe_ffn(cfg, torch.from_numpy(y), pp.layers, 1)
    # bf16 weights and inputs, exact products, f32 sums in another order
    # (measured < 1e-6); h rounds to bf16 for w2 as in the grouped arm
    assert _rel_err(got.numpy(), want) <= 1e-4


def _jax_tree(p) -> dict:
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
    return (a.view(torch.int16) if a.dtype in (torch.float16, torch.bfloat16) else a).numpy()


def _assert_same(a, b, name):
    if a is None or b is None:
        assert a is None and b is None, name
    elif isinstance(a, QuantTensor):
        _assert_same(a.q, b.q, name + ".q")
        _assert_same(a.d, b.d, name + ".d")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


def test_load_params_equals_the_jax_loader(tmp_path):
    path = _tiny_moe(tmp_path, seed=11)
    _, jp, cfg, mine = _both_params(path)
    carried = params_from_jax(_jax_tree(jp), device="cpu")
    for f in ("embedding", "final_norm", "wcls"):
        _assert_same(getattr(mine, f), getattr(carried, f), f)
    for f in dataclasses.fields(mine.layers):
        _assert_same(getattr(mine.layers, f.name), getattr(carried.layers, f.name), f.name)
    L, E, dim, ff = cfg.n_layers, cfg.n_experts, cfg.dim, cfg.hidden_dim
    assert mine.layers.w13 is None
    assert mine.layers.w1.q.shape == (L, E, dim // 8, ff) and mine.layers.w1.d.dtype == torch.float16
    assert mine.layers.w2.q.shape == (L, E, ff // 8, dim)
    assert mine.layers.moe_gate.shape == (L, E, dim) and mine.layers.moe_gate.dtype == torch.float32
    with pytest.raises(ValueError, match="'w13'"):
        tree = _jax_tree(jp)
        tree["layers"]["w13"] = tree["layers"]["w1"]
        params_from_jax(tree)


def _jax_engine(path, monkeypatch, interpret, dtype):
    if interpret:
        monkeypatch.setenv("DLT_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("DLT_PALLAS_INTERPRET", raising=False)
    return JEngine(path, compute_dtype=dtype, decode_chunk_size=CHUNK, kv_layout="contiguous",
                   speculative="off", prefix_cache_mb=0, grammar=False)


N_DECODE = 40


def test_bf16_greedy_tokens_match_interpret_mode_jax(tmp_path, monkeypatch):
    """All three arms: a grouped 32-row chunk and a gather 4-row tail in
    prefill, then indexed decode across 40 tokens. The bf16 roundings of
    tests/test_torch_engine.py's docstring apply here too: over model seeds
    0-11, 9 agree over all 40 tokens and 3 part at a near-tie (after 6, 16
    and 28 tokens). The pinned seed is one that agrees."""
    path = _tiny_moe(tmp_path, seed=0)
    steps = len(PROMPT) - 1 + N_DECODE
    je = _jax_engine(path, monkeypatch, interpret=True, dtype="bfloat16")
    want = je.generate(PROMPT, steps, sampler=None).tokens[len(PROMPT):]
    pe = InferenceEngine(path, device="cpu", decode_chunk_size=CHUNK)
    got = pe.generate(PROMPT, steps, sampler=None).tokens[len(PROMPT):]
    assert len(want) == N_DECODE
    assert got == want


@pytest.mark.parametrize("seed", [0, 1, 3])
@pytest.mark.parametrize("n_prefill", [8, 35])
def test_bf16_first_logits_match_interpret_mode_jax(tmp_path, monkeypatch, seed, n_prefill):
    """Every seed: after prefill the first decode logits are within 5% of
    their scale (a wrong kernel, layout or routing moves them by their
    whole scale; one bf16/int8 rounding step moves them ~1%)."""
    path = _tiny_moe(tmp_path, seed=seed)
    je = _jax_engine(path, monkeypatch, interpret=True, dtype="bfloat16")
    pe = InferenceEngine(path, device="cpu", decode_chunk_size=CHUNK)
    prompt = PROMPT[: n_prefill + 1]
    je.prefill(prompt[:-1])
    pe.prefill(prompt[:-1])
    jl = je.decode_one(prompt[-1], n_prefill)
    pl = pe.decode_one(prompt[-1], n_prefill)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=5e-2 * float(np.abs(jl).max()))
    assert np.corrcoef(pl[0], jl[0])[0, 1] > 0.999


def test_f32_logits_match_the_jax_xla_arm_and_numpy(tmp_path, monkeypatch):
    path = _tiny_moe(tmp_path, seed=9)
    je = _jax_engine(path, monkeypatch, interpret=False, dtype="float32")
    pe = InferenceEngine(path, compute_dtype="float32", device="cpu", decode_chunk_size=CHUNK)
    prompt = PROMPT[:12]  # prefill 11: an 8-row grouped-size chunk, a 4-row gather chunk
    je.prefill(prompt[:-1])
    pe.prefill(prompt[:-1])
    jl = je.decode_one(prompt[-1], len(prompt) - 1)
    pl = pe.decode_one(prompt[-1], len(prompt) - 1)
    # f32 throughout with exact dequantized weights: summation order only
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)
    with JReader(path) as r:
        ref = NumpyModel(r)
        cache = ref.new_cache()
        for pos, tok in enumerate(prompt):
            nl = ref.forward_token(tok, pos, cache)
    np.testing.assert_allclose(pl[0], nl, rtol=1e-4, atol=1e-4)


def _pred_texts(out: str) -> list[str]:
    return [line.split("|", 1)[1] for line in out.splitlines() if line.startswith("🔶 Pred")]


def test_cli_prints_the_jax_cli_tokens(tmp_path, monkeypatch, capsys):
    mp, tp = _tiny_moe(tmp_path, seed=0), str(tmp_path / "t.t")
    write_tiny_tokenizer(tp, pad_to=512)
    args = ["inference", "--model", mp, "--tokenizer", tp, "--prompt",
            "hello world, the brown fox jumps over the lazy dog", "--steps", "72",
            "--temperature", "0"]
    monkeypatch.setenv("DLT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DLT_GRAMMAR", "0")
    assert jcli.main(args + ["--kv-layout", "contiguous", "--speculative", "off",
                             "--prefix-cache-mb", "0"]) == 0
    want = _pred_texts(capsys.readouterr().out)
    assert pcli.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert want and _pred_texts(out) == want


def test_write_random_q40_model_reads_back(tmp_path):
    path = str(tmp_path / "r.m")
    h = pt.write_random_q40_model(path, pt.tiny_header(**MOE), seed=5)
    with MFileReader(path) as r, JReader(path) as jr:
        assert r.header.file_bytes == jr.header.file_bytes
        assert [s.name for s in r.specs] == [s.name for s in jr.specs]
        q, d = r.tensor_q40(r.by_name["w1.l1.e3"])
        assert q.min() >= -8 and q.max() <= 7
        df = d.astype(np.float32)
        assert df.min() >= 0.0039 and df.max() < 0.0201
        cfg = config_from_header(r.header)
        p = load_params(r, cfg, device="cpu")
    assert p.layers.w1.q.shape == (h.n_layers, h.n_experts, h.dim // 8, h.moe_hidden_dim)
    assert torch.isfinite(p.embedding).all() and p.layers.moe_gate.shape == (2, 16, 256)
    e = InferenceEngine(path, device="cpu", decode_chunk_size=CHUNK)
    toks = e.generate(PROMPT[:20], 30, sampler=None).tokens[20:]  # positions 19..29
    assert len(toks) == 11 and all(0 <= t < h.vocab_size for t in toks)
