"""The port's mesh flags at the CLI and the server, and the cost table of a
mesh engine, against the JAX package's, on the CPU.

Twins of tests/test_engine_parallel.py:229 (generate_batch on dp2 x tp2
against the JAX mesh engine), the JAX CLI's `--tp`, `--pp`, `--dp` and
`--batch` handling (cli.py:58-62, :180-213), a port server at --tp 2
against the JAX server, and the cost table's keys on mesh engines against
the JAX mesh engine's warm_plan. f32 greedy throughout.
"""

import json
import os
import socket
import threading
import urllib.request

import numpy as np
import pytest
import torch

from distributed_llama_tpu import cli as jcli
from distributed_llama_tpu.cli import build_arg_parser as j_build_arg_parser
from distributed_llama_tpu.parallel import make_mesh as j_make_mesh
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu.server import api as j_api
from distributed_llama_tpu.testing import tiny_header, write_tiny_model, write_tiny_tokenizer
from distributed_llama_tpu_torch import cli as pcli
from distributed_llama_tpu_torch.cli import build_arg_parser as p_build_arg_parser
from distributed_llama_tpu_torch.parallel import make_mesh
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
from distributed_llama_tpu_torch.server import api as p_api

torch.set_num_threads(1)

PROMPT = [3, 17, 99, 4, 56, 23, 8, 41, 77, 5]


def _cpu_mesh(**shape):
    return make_mesh(**shape, devices=["cpu"] * int(np.prod(list(shape.values()))))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mc") / "m.m")
    write_tiny_model(path, tiny_header(dim=128, hidden_dim=128, n_layers=4, n_heads=4,
                                       n_kv_heads=4, seq_len=256), seed=21)
    return path


def _engine(path, **kw):
    kw.setdefault("compute_dtype", "float32")
    kw.setdefault("max_chunk", 8)
    return InferenceEngine(path, **kw)


def test_generate_batch_dp_tp_matches_the_jax_mesh_engine(model):
    prompts = [PROMPT[:4], PROMPT[2:9], PROMPT[:2], PROMPT[1:6]]
    eng = _engine(model, mesh=_cpu_mesh(dp=2, tp=2), batch=4)
    je = JEngine(model, compute_dtype="float32", max_chunk=8, batch=4,
                 mesh=j_make_mesh(dp=2, tp=2), speculative="off", prefix_cache_mb=0,
                 grammar=False, kv_layout="contiguous")
    assert eng.generate_batch(prompts, 8) == je.generate_batch(prompts, 8)



def test_cost_table_keys_on_a_mesh_equal_jax(model):
    """The cost table of a mesh engine (a census over the mesh's shards,
    which `serve()` builds after warmup) covers its plan, whose keys are
    the JAX mesh engine's warm_plan."""
    from distributed_llama_tpu_torch.runtime.profiling import build_cost_table, cost_problems

    for shape, layout in ((dict(pp=2, tp=2), "paged"), (dict(dp=2), "contiguous")):
        eng = _engine(model, mesh=_cpu_mesh(**shape), batch=2, kv_layout=layout,
                      prefix_cache_mb=64, speculative="ngram")
        table = build_cost_table(eng)
        assert not table.failures and not cost_problems(eng, table)
        je = JEngine(model, compute_dtype="float32", max_chunk=8, batch=2,
                     mesh=j_make_mesh(**shape), speculative="ngram", prefix_cache_mb=64,
                     grammar=False, kv_layout=layout)
        assert set(table.entries) == {tuple(k) for k in je.warm_plan()}
        assert eng.cost_plan() == [tuple(k) for k in je.warm_plan()]


# -- the CLI --------------------------------------------------------------------


def _pred_texts(out: str) -> list[str]:
    return [line.split("|", 1)[1] for line in out.splitlines() if line.startswith("🔶 Pred")]


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    mp, tp = str(d / "m.m"), str(d / "t.t")
    write_tiny_model(mp, tiny_header(dim=128, hidden_dim=256, n_layers=4, n_heads=4,
                                     n_kv_heads=4, vocab_size=512, seq_len=256), seed=5)
    write_tiny_tokenizer(tp, pad_to=512)
    return mp, tp


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--pp", "2"], ["--tp", "2", "--pp", "2"],
                                   ["--dp", "2", "--tp", "2", "--batch", "2"]],
                         ids=["tp2", "pp2", "tp2xpp2", "dp2xtp2"])
def test_cli_mesh_flags_print_the_jax_cli_tokens(cli_files, monkeypatch, capsys, flags):
    """`inference --device cpu` with the mesh flags prints the JAX CLI's
    greedy tokens on the same flags (f32; paged where the mesh is pure
    pp x tp, contiguous with the JAX CLI's notice elsewhere)."""
    mp, tp = cli_files
    args = ["inference", "--model", mp, "--tokenizer", tp, "--prompt",
            "hello world, the brown fox", "--steps", "32", "--temperature", "0",
            "--compute-dtype", "float32", "--speculative", "off", "--prefix-cache-mb", "0",
            *flags]
    monkeypatch.setenv("DLT_GRAMMAR", "0")
    assert jcli.main(args) == 0
    jout = capsys.readouterr().out
    assert pcli.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    want = _pred_texts(jout)
    assert want and _pred_texts(out) == want
    notice = "--kv-layout paged covers"
    assert (notice in jout) == (notice in out) == ("--dp" in flags)


def test_cli_batch_and_dp_errors_match_jax(cli_files, monkeypatch):
    mp, tp = cli_files
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    base = ["inference", "--model", mp, "--tokenizer", tp, "--prompt", "x", "--steps", "4"]
    msgs = []
    for main in (jcli.main, pcli.main):
        with pytest.raises(ValueError) as err:
            main(base + ["--dp", "2", "--batch", "3"])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        pcli.main(base + ["--tp", "2"])


# -- the server -------------------------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _serve(api_mod, parser, argv):
    p = parser()
    p.add_argument("--port", type=int, default=0)
    port = _free_port()
    httpd = api_mod.serve(p.parse_args(argv + ["--port", str(port)]))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return port, httpd


def test_server_at_tp2_answers_as_the_jax_server(tmp_path, monkeypatch):
    """A port server at --tp 2 (its engine built through the CLI, its cost
    table after warmup) gives the JAX server's greedy response."""
    mp, tp = str(tmp_path / "m.m"), str(tmp_path / "t.t")
    write_tiny_model(mp, tiny_header(dim=64, hidden_dim=128, n_layers=2, seq_len=256,
                                     vocab_size=288, n_heads=4, n_kv_heads=2), seed=3)
    write_tiny_tokenizer(tp, pad_to=288,
                         chat_template="{% for m in messages %}<|im_start|>...{% endfor %}")
    monkeypatch.setenv("DLT_NO_WARMUP", "1")
    monkeypatch.setenv("DLT_GRAMMAR", "0")
    argv = ["inference", "--model", mp, "--tokenizer", tp, "--compute-dtype", "float32",
            "--temperature", "0.0", "--tp", "2"]
    jport, jhttpd = _serve(j_api, j_build_arg_parser, argv)
    pport, phttpd = _serve(p_api, p_build_arg_parser, argv + ["--device", "cpu"])
    try:
        assert phttpd.api_state.engine.use_pipeline
        payload = {"messages": [{"role": "user", "content": "hello there"}], "max_tokens": 24,
                   "temperature": 0.0}
        answers = []
        for port in (jport, pport):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions",
                                         data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                answers.append(json.loads(r.read())["choices"][0]["message"]["content"])
        assert answers[0] == answers[1]
    finally:
        jhttpd.shutdown()
        phttpd.shutdown()
        os.environ.pop("DLT_NO_WARMUP", None)
