"""The CLI's perplexity and chat modes and its KV flags, against the JAX
package's CLI, and B5 (`q40_gemm_bf16`, the unstacked bf16-dequant matmul
perplexity's logits take) against the JAX package's `q40_matmul_pallas` in
interpret mode.

Tolerances: B5's plain version has B3's exact bf16 products with f32 sums
in another order (1e-4 of the output scale, K2's bound). Perplexity in f32
is the exact XLA arm on both sides (1e-5 relative); in bf16 against
interpret-mode JAX the bf16 and int8 rounding steps of
tests/test_torch_engine.py move each probability by ~1% (1e-2 relative).
Chat in f32 at temperature 0 prints the same text.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu import cli as jcli
from distributed_llama_tpu.ops import pallas_q40 as jp
from distributed_llama_tpu.ops import quant as jquant
from distributed_llama_tpu.testing import tiny_header, write_tiny_model
from distributed_llama_tpu_torch import cli as pcli
from distributed_llama_tpu_torch.formats.tfile import write_tfile
from distributed_llama_tpu_torch.ops import cuda_q40
from distributed_llama_tpu_torch.ops import quant as pquant
from distributed_llama_tpu_torch.runtime.paged_kv import page_pool_bytes
from distributed_llama_tpu_torch.testing import byte_vocab_tokenizer, write_tiny_tokenizer

torch.set_num_threads(1)

LLAMA = dict(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512,
             seq_len=512)
TEXT = "hello world, the quick brown fox jumps over the lazy dog and runs"


@pytest.mark.parametrize("in_f,out_f,rows", [(256, 384, 16), (288, 256, 12), (96, 128, 33)])
def test_b5_plain_matches_pallas_interpret(in_f, out_f, rows):
    """Block counts 8, 9 (ragged: B5's gate has no nb % 8 rule) and 3."""
    rng = np.random.default_rng(in_f + rows)
    nb = in_f // 32
    q = jquant.pack_q(rng.integers(-8, 8, size=(nb, 32, out_f)).astype(np.int8))
    d = (rng.random((nb, out_f)) * 0.02 + 0.001).astype(np.float16)
    x = rng.standard_normal((rows, in_f)).astype(np.float32)
    want = np.asarray(jp.q40_matmul_pallas(jnp.asarray(x), jnp.asarray(q), jnp.asarray(d),
                                           interpret=True))
    got = cuda_q40.q40_gemm_bf16(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(d))
    tol = 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # quant_matmul sends an unstacked weight at more than 8 bf16 rows here
    w = pquant.QuantTensor(q=torch.from_numpy(q), d=torch.from_numpy(d))
    via = pquant.quant_matmul(torch.from_numpy(x), w, dtype=torch.bfloat16)
    np.testing.assert_allclose(via.numpy(), want, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    mp, tp = str(d / "m.m"), str(d / "t.t")
    write_tiny_model(mp, tiny_header(**LLAMA), seed=5)
    write_tiny_tokenizer(tp, pad_to=512)
    return mp, tp


_JAX_OFF = ["--speculative", "off", "--prefix-cache-mb", "0"]


def _perplexity(out: str) -> float:
    return float(re.search(r"perplexity: ([0-9.]+)", out).group(1))


def _probs(out: str) -> list:
    return [float(m) for m in re.findall(r"prob=([0-9.]+)", out)]


@pytest.mark.parametrize("dtype,layout", [("float32", "paged"), ("float32", "contiguous"),
                                          ("bfloat16", "paged")])
def test_perplexity_matches_the_jax_cli(files, monkeypatch, capsys, dtype, layout):
    mp, tp = files
    args = ["perplexity", "--model", mp, "--tokenizer", tp, "--prompt", TEXT,
            "--compute-dtype", dtype, "--kv-layout", layout, "--max-batch-size", "16"]
    monkeypatch.setenv("DLT_GRAMMAR", "0")
    if dtype == "bfloat16":
        monkeypatch.setenv("DLT_PALLAS_INTERPRET", "1")
    assert jcli.main(args + _JAX_OFF) == 0
    want = capsys.readouterr().out
    assert pcli.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    rel = 1e-5 if dtype == "float32" else 1e-2
    assert _perplexity(got) == pytest.approx(_perplexity(want), rel=rel)
    assert len(_probs(got)) == len(_probs(want)) > 16
    np.testing.assert_allclose(_probs(got), _probs(want), rtol=10 * rel, atol=1e-6)


def _chat_tokenizer(path, eos_token: int):
    """The byte tokenizer with `eos_token` (a filler token this model
    emits in its first reply) as its stop token, so a reply ends and the
    chat takes a second turn."""
    t = byte_vocab_tokenizer(pad_to=512)
    t.eos_token_ids = [eos_token]
    write_tfile(path, t)


def _replies(out: str) -> list:
    parts = out.split("🤖 Assistant")[1:]
    return [p.split("👱 User")[0].split("(end of context)")[0].strip() for p in parts]


def test_chat_two_turns_match_the_jax_cli(files, monkeypatch, capsys, tmp_path):
    mp, _ = files
    tp = str(tmp_path / "chat.t")
    _chat_tokenizer(tp, eos_token=383)  # <pad383>: the model's 3rd reply token
    lines = ["", "hello there", "and again"]

    def scripted(_prompt=""):
        if not lines:
            raise EOFError
        return lines.pop(0)

    args = ["chat", "--model", mp, "--tokenizer", tp, "--temperature", "0",
            "--compute-dtype", "float32", "--chat-template", "chatml"]
    monkeypatch.setenv("DLT_GRAMMAR", "0")
    monkeypatch.setattr("builtins.input", scripted)
    assert jcli.main(args + _JAX_OFF) == 0
    want = _replies(capsys.readouterr().out)
    lines[:] = ["", "hello there", "and again"]
    assert pcli.main(args + ["--device", "cpu"]) == 0
    got = _replies(capsys.readouterr().out)
    assert len(want) == 2 and want[0] and want[1]
    assert got == want


def test_kv_flags_and_defaults(files):
    mp, tp = files
    base = ["inference", "--model", mp, "--tokenizer", tp, "--device", "cpu"]
    args = pcli.build_arg_parser().parse_args(base)
    assert (args.kv_layout, args.kv_page_size, args.kv_pool_mb, args.cache_dtype) == (None, 0, 0, None)
    e = pcli.make_engine(args)
    assert e.paged and e.page_size == 16 and e.batch == 1  # paged, as the JAX CLI
    assert e.page_pool.n_pages == LLAMA["seq_len"] // 16  # contiguous parity
    e = pcli.make_engine(pcli.build_arg_parser().parse_args(
        base + ["--kv-dtype", "int8", "--kv-page-size", "32", "--kv-pool-mb", "1", "--batch", "2"]))
    assert e.cfg.kv_quantized and e.page_size == 32 and e.batch == 2
    assert e.page_pool.n_pages == (1 << 20) // page_pool_bytes(e.cfg, 1, 32)
    e = pcli.make_engine(pcli.build_arg_parser().parse_args(base + ["--kv-layout", "contiguous"]))
    assert not e.paged and e.page_pool is None
    with pytest.raises(ValueError):
        pcli.make_engine(pcli.build_arg_parser().parse_args(base + ["--kv-page-size", "24"]))


def test_inference_paged_int8_batch_prints_row_zero(files, capsys):
    """`--batch 2 --kv-dtype int8` at the paged default: every row runs the
    prompt; the CLI prints row 0's stream, the same as batch 1's. Without
    speculation: a batch-2 verify round of 10 rows takes K2's bf16 arm
    where batch 1's 5 rows take K1's Q80 arm, so the greedy chains may part
    at a near-tie (the JAX package picks its arms by the same row count)."""
    mp, tp = files
    args = ["inference", "--model", mp, "--tokenizer", tp, "--prompt", TEXT, "--steps", "90",
            "--temperature", "0", "--kv-dtype", "int8", "--device", "cpu", "--speculative", "off"]
    assert pcli.main(args) == 0
    one = [l for l in capsys.readouterr().out.splitlines() if l.startswith("🔶 Pred")]
    assert pcli.main(args + ["--batch", "2"]) == 0
    two = [l for l in capsys.readouterr().out.splitlines() if l.startswith("🔶 Pred")]
    assert [l.split("|", 1)[1] for l in one] == [l.split("|", 1)[1] for l in two]


def test_inference_paged_int8_batch_prints_row_zero_at_the_default(files, monkeypatch, capsys):
    """The same at the CLI's default, ngram speculation. Batch 1's rounds of
    5 rows take decode's arms (K1 quantizes x to Q80) and print the text of
    the run without speculation. Batch 2's rounds of 10 rows take K2's bf16
    arm, so its row 0 may part from batch 1 (the help text says so). With
    every dense matmul on K2's bf16 arm, the verify rounds' arm, batch 2's
    row 0 prints batch 1's text."""
    mp, tp = files
    args = ["inference", "--model", mp, "--tokenizer", tp, "--prompt", TEXT, "--steps", "90",
            "--temperature", "0", "--kv-dtype", "int8", "--device", "cpu"]

    def pred(extra):
        assert pcli.main(args + extra) == 0
        return [l.split("|", 1)[1] for l in capsys.readouterr().out.split("\n")
                if l.startswith("🔶 Pred")]

    def text(lines):
        return "".join(re.sub(r"^ (\(\d+ tokens\) )?", "", l).replace("~", "") for l in lines)

    one, off = pred([]), pred(["--speculative", "off"])
    assert text(one) == text(off) and one != off
    monkeypatch.setattr(cuda_q40, "q40_gemv_q80_stacked", cuda_q40.q40_gemm_bf16_stacked)
    monkeypatch.setattr(cuda_q40, "q40_gemv_q80", cuda_q40.q40_gemm_bf16)
    one, two = pred([]), pred(["--batch", "2"])
    assert text(one) == text(two)


_COMPAT = ["--nthreads", "4", "--buffer-float-type", "q80", "--net-turbo", "1",
           "--prefill-chunk-threshold", "64"]


def test_compat_flags_parse_as_in_the_jax_cli():
    """The reference CLI's knobs that the JAX CLI parses and ignores: the
    port parses them to the same values and defaults."""
    for argv in (["inference"], ["inference"] + _COMPAT):
        j = jcli.build_arg_parser().parse_args(argv)
        p = pcli.build_arg_parser().parse_args(argv)
        for name in ("nthreads", "buffer_float_type", "net_turbo", "prefill_chunk_threshold"):
            assert getattr(p, name) == getattr(j, name), name


def test_inference_with_compat_flags_prints_the_jax_cli_tokens(files, monkeypatch, capsys):
    mp, tp = files
    args = ["inference", "--model", mp, "--tokenizer", tp, "--prompt", TEXT, "--steps", "96",
            "--temperature", "0", "--compute-dtype", "float32", "--kv-layout", "contiguous",
            *_COMPAT]
    monkeypatch.setenv("DLT_GRAMMAR", "0")
    assert jcli.main(args + _JAX_OFF) == 0
    want = [l.split("|", 1)[1] for l in capsys.readouterr().out.splitlines()
            if l.startswith("🔶 Pred")]
    assert pcli.main(args + ["--device", "cpu", "--speculative", "off"]) == 0
    got = [l.split("|", 1)[1] for l in capsys.readouterr().out.splitlines()
           if l.startswith("🔶 Pred")]
    assert want and got == want


@pytest.mark.parametrize("where", ["first", "after the flags"])
def test_worker_mode_prints_the_jax_cli_migration_text(files, capsys, where):
    """`worker`, first in argv or after the flags, gives the JAX CLI's
    stderr and exit code 2 in both CLIs, and nothing on stdout."""
    mp, _ = files
    argv = ["worker"] if where == "first" else ["--model", mp, "--tokenizer", "unused", "worker"]
    want_rc = jcli.main(list(argv))
    want = capsys.readouterr()
    got_rc = pcli.main(list(argv))
    got = capsys.readouterr()
    assert want_rc == got_rc == 2
    assert got.err == want.err and "no worker processes" in got.err
    assert got.out == want.out == ""
