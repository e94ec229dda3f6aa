"""Kernel times on the card: CUDA events around replays of a CUDA graph.

The counterpart of the JAX probes' `dev_ms`, `dev_us` and `chain`
(scripts/probe_int4.py:50-86, scripts/probe_dma.py:56-84). Those re-read
one buffer in a chained loop; on an H100, whose L2 holds 50 MB, an operand
set smaller than that would then time the L2 and not the device memory. So
`cold_hot_ms` gives two numbers, each per launch:

* cold: one graph holds n launches, launch i on copy i of the operands, the
  n copies together at least RING_BYTES (200 MB, 4x the L2). Copy i was
  last touched n - 1 launches earlier, so no launch finds its operands in
  L2. This is the headline;
* hot: the same n launches, all on copy 0: the L2 number, for contrast.

The graph holds the launches, so Python's launch cost is not in either
number. Timing needs a CUDA device; it raises elsewhere.
"""

from __future__ import annotations

import statistics
import subprocess
from functools import partial

import torch

RING_BYTES = 200_000_000  # 4x the H100's 50 MB L2


def ring_size(nbytes: int) -> int:
    """Copies of an `nbytes` operand set that together reach RING_BYTES."""
    return max(1, -(-RING_BYTES // max(int(nbytes), 1)))


def graph_ms(calls, replays: int = 20, budget_ms: float = 500.0, warm: bool = True) -> float:
    """Median device time of one replay of a CUDA graph that holds `calls`
    (zero-argument callables) in order, divided by their number: `replays`
    replays, or as many as fit `budget_ms` once three are done. `warm=False`
    skips the eager pass that builds, loads and allocates, for calls that
    have run before; a single replay also skips the untimed first one (for
    a graph long enough that uploading it is lost in its run)."""
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device")
    if warm:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for c in calls:
                c()
        torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for c in calls:
            c()
    if replays > 1:
        g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
        if len(times) >= 3 and sum(times) > budget_ms:
            break
    del g
    return statistics.median(times) / len(calls)


def cold_ms(fn, operands: tuple, nbytes: int) -> float:
    """Cold ms of one call fn(*operands), whose operands take `nbytes`
    together: over a ring of copies of every tensor operand (other
    arguments are shared)."""
    copies = [operands] + [
        tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in operands)
        for _ in range(ring_size(nbytes) - 1)
    ]
    return graph_ms([partial(fn, *ops) for ops in copies])


def hot_ms(fn, operands: tuple, nbytes: int) -> float:
    """Hot ms of one call fn(*operands): the ring's launch count, every
    launch on the operands themselves."""
    return graph_ms([partial(fn, *operands)] * ring_size(nbytes))


def cold_hot_ms(fn, operands: tuple, nbytes: int) -> tuple[float, float]:
    """(cold_ms, hot_ms) of one call."""
    return cold_ms(fn, operands, nbytes), hot_ms(fn, operands, nbytes)


def card_line() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them for the current device."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if len(out) > torch.cuda.current_device() else out[0]
