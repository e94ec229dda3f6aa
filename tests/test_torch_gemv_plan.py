"""The blocking of K1 (the Q80 x Q40 decode GEMV: K1-stacked, K1 and
K1-indexed) as the CUDA kernel runs it, on the CPU: the planner
`cuda_q40.gemv_plan`, the plan and launches the wrappers hand the kernel,
and the plain renditions of its order of sums (`q40_gemv_q80_blocked`,
`q40_gemv_q80_indexed_blocked`) against the JAX package's int8 Pallas
kernels run with interpret=True. Inputs come from numpy with a seed. The
kernel itself: tests/test_torch_kernels_gpu.py.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops import pallas_q40 as jp
from distributed_llama_tpu_torch.ops import cuda_q40, kernels
from distributed_llama_tpu_torch.ops.quant import pack_q

# tiny shapes: torch's intra-op threads would only contend with the JAX
# tests that share the CPU under pytest-xdist
torch.set_num_threads(1)

# The CTAs and weight bytes in flight a call must reach at the main-path
# shapes. probes/k1_ab.py's sweep on an H100 (132 SMs) chose 64-160 CTAs
# there: each CTA pays its prologue, barriers and cluster syncs again, so
# more CTAs than ~1 an SM lost even where SMs sat idle (1B wo: 64 CTAs beat
# 128). What a call needs is its weight loads in flight: well over the ~18
# KB an SM that keep 3.35 TB/s busy, in every CTA.
MIN_CTAS = 64
MIN_FLIGHT_BYTES = 2 * 18 * 1024
# (in, out, slots) of every K1 call on the main paths: Llama-3.2-1B wqkv,
# wo, w13, w2, wcls; Qwen3-30B-A3B wqkv, wo, wcls; K1-indexed's w1/w3 and
# w2 at 8 slots
MAIN_PATH = [(2048, 3072, 1), (2048, 2048, 1), (2048, 16384, 1), (8192, 2048, 1),
             (2048, 128256, 1), (2048, 5120, 1), (4096, 2048, 1), (2048, 151936, 1),
             (2048, 768, 8), (768, 2048, 8)]
# integer partials are exact on both sides; the f32 block sums run in
# another order than the Pallas kernel's: a few ulp of the output's scale
REL_TOL = 1e-5


def _weights(in_f, out_f, layers, seed):
    rng = np.random.default_rng(seed)
    nb = in_f // 32
    qt = rng.integers(-8, 8, size=(layers, nb, 32, out_f)).astype(np.int8)
    dt = (rng.random((layers, nb, out_f)) * 0.02 - 0.01).astype(np.float16)
    return pack_q(qt), dt


def _x(rows, in_f, seed):
    return np.random.default_rng(seed).standard_normal((rows, in_f)).astype(np.float32)


def _held(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_TOL * float(np.abs(want).max()))


def test_gemv_plan_takes_the_shape_alone():
    assert list(inspect.signature(cuda_q40.gemv_plan).parameters) == ["nb", "out_f"]
    assert cuda_q40.gemv_plan(64, 3072) == cuda_q40.gemv_plan(64, 3072)


@pytest.mark.parametrize("out_f", [200, 768, 128256, 151936])
@pytest.mark.parametrize("nb", [1, 3, 24, 64, 128, 256, 257])
def test_gemv_plan_splits_cover_every_block_once(nb, out_f):
    plan = cuda_q40.gemv_plan(nb, out_f)
    assert plan.vec in (1, 2, 4) and plan.kw in (2, 4, 8)
    assert plan.cols == 32 * plan.vec * (cuda_q40.GEMV_WARPS // plan.kw)
    assert 1 <= plan.splits <= cuda_q40.GEMV_MAX_SPLITS
    assert plan.splits & (plan.splits - 1) == 0  # a cluster of 1, 2, 4 or 8
    assert plan.blocks_per_split <= cuda_q40.GEMV_MAX_BPS
    splits = [plan.split_range(s, nb) for s in range(plan.splits)]
    assert all(len(r) > 0 for r in splits)
    assert [b for r in splits for b in r] == list(range(nb))
    for r in splits:  # the warps' runs cover their split once, in order
        runs = [plan.warp_range(kw, r) for kw in range(plan.kw)]
        assert [b for w in runs for b in w] == list(r)


@pytest.mark.parametrize("in_f,out_f,slots", MAIN_PATH)
def test_gemv_plan_fills_the_card_at_main_path_shapes(in_f, out_f, slots):
    plan = cuda_q40.gemv_plan(in_f // 32, out_f)
    assert plan.ctas(out_f) * slots >= MIN_CTAS
    assert plan.splits <= 8  # the portable cluster size
    # a lane keeps 8 / vec blocks in flight, 18 * vec bytes each (4 word
    # rows and the scales); a warp's run is blocks_per_split / kw blocks
    run = -(-plan.blocks_per_split // plan.kw)
    in_flight = cuda_q40.GEMV_WARPS * 32 * min(run, 8 // plan.vec) * 18 * plan.vec
    assert in_flight >= MIN_FLIGHT_BYTES


@pytest.mark.parametrize("plan", [None, cuda_q40.GemvPlan(1, 32, 8, 8, 1),
                                  cuda_q40.GemvPlan(2, 128, 4, 2, 4),
                                  cuda_q40.GemvPlan(4, 512, 2, 4, 2)])
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_k1_blocked_sums_match_pallas_stacked_i8(rows, plan):
    """The kernel's order of sums under several plans, against the Pallas
    int8 kernel on layer 1 of a stacked weight (nb 8)."""
    q, d = _weights(256, 384, layers=2, seed=rows)
    x = _x(rows, 256, seed=rows + 1)
    plan = plan or cuda_q40.gemv_plan(8, 384)
    want = np.asarray(jp.q40_matmul_pallas_stacked_i8(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(d), jnp.int32(1), interpret=True))
    got = cuda_q40.q40_gemv_q80_blocked(torch.from_numpy(x), torch.from_numpy(q[1]),
                                        torch.from_numpy(d[1]), plan)
    _held(got.numpy(), want)


@pytest.mark.parametrize("in_f,out_f", [(768, 256), (4096, 128)])
@pytest.mark.parametrize("rows", [1, 8])
def test_k1_blocked_sums_match_pallas_unstacked_i8(rows, in_f, out_f):
    """gemv_plan's own plans (nb 24: four words a lane, unsplit; nb 128:
    one word a lane, 2 splits) against the unstacked Pallas kernel."""
    q, d = _weights(in_f, out_f, layers=1, seed=in_f)
    x = _x(rows, in_f, seed=rows)
    plan = cuda_q40.gemv_plan(in_f // 32, out_f)
    want = np.asarray(jp.q40_matmul_pallas_i8(jnp.asarray(x), jnp.asarray(q[0]),
                                              jnp.asarray(d[0]), interpret=True))
    got = cuda_q40.q40_gemv_q80_blocked(torch.from_numpy(x), torch.from_numpy(q[0]),
                                        torch.from_numpy(d[0]), plan)
    _held(got.numpy(), want)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("slots", [1, 3, 8])
def test_k1_indexed_blocked_sums_match_pallas_per_slot(slots, shared):
    """Slot s against group idx[s] of a flat [L * E] stack: the oracle is
    the stacked Pallas kernel on that flat index, a slot at a time."""
    q, d = _weights(768, 256, layers=6, seed=slots)
    x = _x(1 if shared else slots, 768, seed=slots + 7)
    idx = np.array([5, 0, 3, 3, 1, 4, 2, 5][:slots], dtype=np.int32)
    plan = cuda_q40.gemv_plan(24, 256)
    got = cuda_q40.q40_gemv_q80_indexed_blocked(
        torch.from_numpy(x), torch.from_numpy(q).reshape(2, 3, 96, 256),
        torch.from_numpy(d).reshape(2, 3, 24, 256), torch.from_numpy(idx), plan).numpy()
    assert got.shape == (slots, 256)
    for s, g in enumerate(idx):
        want = np.asarray(jp.q40_matmul_pallas_stacked_i8(
            jnp.asarray(x[0 if shared else s][None]), jnp.asarray(q), jnp.asarray(d),
            jnp.int32(g), interpret=True))
        _held(got[s:s + 1], want)


class _Captured:
    """kernels.load / kernels.launch stand-ins that record each launch, and
    a count of the tensors the launch path allocates, so the wrappers'
    launch paths run on the CPU as on the card."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.allocs = 0
        monkeypatch.setattr(kernels, "load", lambda name, sig: name)
        monkeypatch.setattr(kernels, "launch",
                            lambda lib, fn, t, *args: self.calls.append((fn, args)))
        monkeypatch.setattr(cuda_q40, "_device_kind", lambda t: "cuda")
        empty = torch.empty

        def counted(*a, **k):
            self.allocs += 1
            return empty(*a, **k)

        monkeypatch.setattr(torch, "empty", counted)


def _plan_args(plan):
    return (plan.vec, plan.cols, plan.kw, plan.splits, plan.blocks_per_split)


@pytest.mark.parametrize("in_f,out_f", [(2048, 3072), (8192, 2048), (2080, 200)])
def test_k1_launches_its_plan_once_whatever_the_row_count(monkeypatch, in_f, out_f):
    """K1-stacked and K1 hand the kernel gemv_plan(nb, out) at 1..8 rows,
    launch once a call, allocate only the output (no prologue scratch) and
    count each launch once."""
    q, d = (torch.from_numpy(a) for a in _weights(in_f, out_f, layers=2, seed=0))
    cap = _Captured(monkeypatch)
    plan = cuda_q40.gemv_plan(in_f // 32, out_f)
    for rows in range(1, 9):
        for x, fn, args in ((torch.zeros((1, rows, in_f)), cuda_q40.q40_gemv_q80_stacked, (q, d, 1)),
                            (torch.zeros((rows, in_f)).bfloat16(), cuda_q40.q40_gemv_q80,
                             (q[0], d[0]))):
            before, calls, allocs = fn.launches, len(cap.calls), cap.allocs
            out = fn(x, *args)
            assert fn.launches == before + 1
            assert len(cap.calls) == calls + 1 and cap.allocs == allocs + 1
            assert out.shape == (*x.shape[:-1], out_f)
            name, launched = cap.calls[-1]
            assert name == "q40_gemv_q80"
            assert launched[5:9] == (rows, in_f, out_f, 1 if fn is cuda_q40.q40_gemv_q80_stacked else 0)
            assert launched[-5:] == _plan_args(plan)


@pytest.mark.parametrize("in_f,out_f", [(2048, 768), (768, 2048)])
@pytest.mark.parametrize("shared", [True, False])
def test_k1_indexed_launches_its_plan_once_whatever_the_slot_count(monkeypatch, in_f, out_f,
                                                                   shared):
    q, d = (torch.from_numpy(a) for a in _weights(in_f, out_f, layers=4, seed=1))
    q, d = q.reshape(2, 2, *q.shape[1:]), d.reshape(2, 2, *d.shape[1:])
    cap = _Captured(monkeypatch)
    plan = cuda_q40.gemv_plan(in_f // 32, out_f)
    for n in range(1, 9):
        idx = torch.arange(n, dtype=torch.int32) % 4
        x = torch.zeros((1 if shared else n, in_f))
        before, allocs = cuda_q40.q40_gemv_q80_indexed.launches, cap.allocs
        out = cuda_q40.q40_gemv_q80_indexed(x, q, d, idx)
        assert cuda_q40.q40_gemv_q80_indexed.launches == before + 1
        assert cap.allocs == allocs + 1 and out.shape == (n, out_f)
        name, launched = cap.calls[-1]
        assert name == "q40_gemv_q80_indexed"
        assert launched[2] == (1 if shared else n) and launched[6:8] == (n, 4)
        assert launched[-5:] == _plan_args(plan)
    assert len(cap.calls) == 8
