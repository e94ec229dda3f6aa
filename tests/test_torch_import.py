"""The port imports neither jax, nor ml_dtypes, nor anything of the JAX
package, nor the JAX package's scripts (the kernel probes there import
jax)."""

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
import distributed_llama_tpu_torch.ops.kv_quant
import distributed_llama_tpu_torch.runtime.batch_session
import distributed_llama_tpu_torch.runtime.paged_kv
import distributed_llama_tpu_torch.runtime.prefix_cache
import distributed_llama_tpu_torch.runtime.graphs
import distributed_llama_tpu_torch.runtime.decode
import distributed_llama_tpu_torch.runtime.speculative
import distributed_llama_tpu_torch.runtime.grammar
import distributed_llama_tpu_torch.runtime.telemetry
import distributed_llama_tpu_torch.runtime.tracing
import distributed_llama_tpu_torch.runtime.supervisor
import distributed_llama_tpu_torch.runtime.kv_transport
import distributed_llama_tpu_torch.runtime.kv_tiering
import distributed_llama_tpu_torch.runtime.profiling
import distributed_llama_tpu_torch.ops.census
import distributed_llama_tpu_torch.server
import distributed_llama_tpu_torch.server.disagg
import distributed_llama_tpu_torch.server.router
import distributed_llama_tpu_torch.server.quarantine
import distributed_llama_tpu_torch.server.scheduler
import distributed_llama_tpu_torch.server.api
import distributed_llama_tpu_torch.testing
import distributed_llama_tpu_torch.probes.int4
import distributed_llama_tpu_torch.probes.dma
import distributed_llama_tpu_torch.probes.timing
import distributed_llama_tpu_torch.probes.operands
import distributed_llama_tpu_torch.probes.attention
import distributed_llama_tpu_torch.probes.int4_prod
import distributed_llama_tpu_torch.probes.k1_step
import distributed_llama_tpu_torch.probes.scales
import distributed_llama_tpu_torch.probes.i4_tiles
import distributed_llama_tpu_torch.probes.int4b
import distributed_llama_tpu_torch.probes.int4c
import distributed_llama_tpu_torch.probes.k2_k3_ab
import distributed_llama_tpu_torch.probes.k4_k5_ab
import distributed_llama_tpu_torch.probes.k1_ab
import distributed_llama_tpu_torch.probes.p2_p12_ab
import distributed_llama_tpu_torch.probes.gemv
import distributed_llama_tpu_torch.probes.p3_p6_ab
import distributed_llama_tpu_torch.probes.p5_p9_ab
import distributed_llama_tpu_torch.probes.p4_p11_ab
import distributed_llama_tpu_torch.parallel
import distributed_llama_tpu_torch.parallel.mesh
import distributed_llama_tpu_torch.parallel.pipeline
print(json.dumps(sorted(sys.modules)))
"""


def _is_forbidden(name: str) -> bool:
    # the prefix matters: distributed_llama_tpu_torch is the port itself
    return (
        name == "jax"
        or name.startswith("jax.")
        or name == "distributed_llama_tpu"
        or name.startswith("distributed_llama_tpu.")
        or name == "scripts"
        or name.startswith("scripts.")
        or name == "ml_dtypes"
        or name.startswith("ml_dtypes.")
    )


def test_prefix_rule_tells_the_port_from_the_reference():
    assert _is_forbidden("distributed_llama_tpu")
    assert _is_forbidden("distributed_llama_tpu.ops.quant")
    assert _is_forbidden("jax.numpy")
    assert not _is_forbidden("distributed_llama_tpu_torch")
    assert not _is_forbidden("distributed_llama_tpu_torch.ops")
    assert not _is_forbidden("jaxlib_lookalike")
    assert _is_forbidden("scripts.probe_int4")
    assert _is_forbidden("ml_dtypes")
    assert not _is_forbidden("distributed_llama_tpu_torch.probes.int4")


def test_fresh_import_loads_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    mods = json.loads(out.strip().splitlines()[-1])
    assert "distributed_llama_tpu_torch.runtime.engine" in mods
    assert "distributed_llama_tpu_torch.ops.moe" in mods
    assert "distributed_llama_tpu_torch.runtime.batch_session" in mods
    assert "distributed_llama_tpu_torch.runtime.grammar" in mods
    assert "distributed_llama_tpu_torch.runtime.telemetry" in mods
    assert "distributed_llama_tpu_torch.runtime.tracing" in mods
    assert "distributed_llama_tpu_torch.runtime.supervisor" in mods
    assert "distributed_llama_tpu_torch.server.api" in mods
    assert "distributed_llama_tpu_torch.server.scheduler" in mods
    assert "distributed_llama_tpu_torch.server.quarantine" in mods
    assert "distributed_llama_tpu_torch.server.router" in mods
    for name in ("runtime.kv_transport", "runtime.kv_tiering", "runtime.profiling",
                 "server.disagg"):
        assert f"distributed_llama_tpu_torch.{name}" in mods
    assert "distributed_llama_tpu_torch.probes.operands" in mods
    assert "distributed_llama_tpu_torch.probes.attention" in mods
    assert "distributed_llama_tpu_torch.probes.k1_step" in mods
    assert "distributed_llama_tpu_torch.probes.k1_ab" in mods
    assert "distributed_llama_tpu_torch.probes.p2_p12_ab" in mods
    assert "distributed_llama_tpu_torch.probes.p3_p6_ab" in mods
    assert "distributed_llama_tpu_torch.probes.p5_p9_ab" in mods
    assert "distributed_llama_tpu_torch.probes.p4_p11_ab" in mods
    assert "distributed_llama_tpu_torch.probes.gemv" in mods
    assert "distributed_llama_tpu_torch.probes.int4_prod" in mods
    assert "distributed_llama_tpu_torch.probes.int4c" in mods
    assert "distributed_llama_tpu_torch.parallel.pipeline" in mods
    assert [m for m in mods if _is_forbidden(m)] == []
