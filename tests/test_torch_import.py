"""The port imports neither jax nor anything of the JAX package."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import json, sys
import distributed_llama_tpu_torch
import distributed_llama_tpu_torch.cli
import distributed_llama_tpu_torch.runtime.engine
import distributed_llama_tpu_torch.ops.cuda_q40
import distributed_llama_tpu_torch.ops.cuda_attention
import distributed_llama_tpu_torch.ops.moe
import distributed_llama_tpu_torch.testing
print(json.dumps(sorted(sys.modules)))
"""


def _is_forbidden(name: str) -> bool:
    # the prefix matters: distributed_llama_tpu_torch is the port itself
    return (
        name == "jax"
        or name.startswith("jax.")
        or name == "distributed_llama_tpu"
        or name.startswith("distributed_llama_tpu.")
    )


def test_prefix_rule_tells_the_port_from_the_reference():
    assert _is_forbidden("distributed_llama_tpu")
    assert _is_forbidden("distributed_llama_tpu.ops.quant")
    assert _is_forbidden("jax.numpy")
    assert not _is_forbidden("distributed_llama_tpu_torch")
    assert not _is_forbidden("distributed_llama_tpu_torch.ops")
    assert not _is_forbidden("jaxlib_lookalike")


def test_fresh_import_loads_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    mods = json.loads(out.strip().splitlines()[-1])
    assert "distributed_llama_tpu_torch.runtime.engine" in mods
    assert "distributed_llama_tpu_torch.ops.moe" in mods
    assert [m for m in mods if _is_forbidden(m)] == []
