"""The cost census of one step: what a kernel wrapper reports of a call.

runtime/profiling.py builds the warm-ladder cost table (the JAX package's
`runtime/profiling.py` walks each program's jaxpr; the port has none) by
running one step of each program on ``meta`` tensors, which carry shapes
and no data, while a census is open on the thread. Torch glue ops are
counted there from their operands. A kernel wrapper (ops/cuda_q40.py,
ops/cuda_attention.py) given meta tensors states the FLOPs and HBM bytes
of its call instead, from the shapes alone: the same arithmetic as the
kernel table's bound in PERF.md (each input read once, each output
written once; the attention kernels read only the K/V the causal limit
needs) — and returns an empty meta result of the kernel's shape without
running anything. Meta tensors reach a wrapper only under a census.
"""

from __future__ import annotations

import threading

_local = threading.local()


class Census:
    """The running totals of one censused step. `depth` > 0 while a
    wrapper builds its meta result, so the glue counter skips it."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_flops = 0.0  # the wrappers' share of flops and bytes
        self.kernel_bytes = 0.0
        self.depth = 0
        self.kernels: dict = {}  # wrapper name -> calls


def current() -> Census | None:
    """The census open on this thread, or None."""
    return getattr(_local, "census", None)


class counting:
    """``with counting() as c:`` opens a census on this thread."""

    def __enter__(self) -> Census:
        self.prev = current()
        self.census = Census()
        _local.census = self.census
        return self.census

    def __exit__(self, *exc):
        _local.census = self.prev
        return False


def nbytes(t) -> int:
    return t.numel() * t.element_size() if t is not None else 0


def meta_kernel(name: str, flops: float, moved: float, make):
    """A wrapper's call on meta tensors: add its `flops` and `moved` bytes
    to the open census and return `make()`, the empty meta result (built
    with the glue counter paused). Raises outside a census."""
    c = current()
    if c is None:
        raise ValueError(f"{name}: meta tensors are only for a cost census")
    c.flops += float(flops)
    c.bytes += float(moved)
    c.kernel_flops += float(flops)
    c.kernel_bytes += float(moved)
    c.kernels[name] = c.kernels.get(name, 0) + 1
    c.depth += 1
    try:
        return make()
    finally:
        c.depth -= 1
