"""P7's port (probes/int4_prod.py) against the JAX probe on the CPU: the
plain version of K1's body against scripts/probe_int4_prod.py's
`fs_call_tiles` (under `force_tpu_interpret_mode`: it has no `interpret`
argument), on the split prologue's operands carried across by
`split_operands_from_jax`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from distributed_llama_tpu.ops.pallas_q40 import _dt_operand, _quantize_rows_q80_split
from distributed_llama_tpu.ops.quant import pack_q
from distributed_llama_tpu_torch.ops import cuda_q40
from distributed_llama_tpu_torch.probes import int4_prod, k1_step
from distributed_llama_tpu_torch.probes.operands import split_operands_from_jax
from scripts import probe_int4_prod as jprod

# exact integer partials; the f32 block sums run in another order
REL_TOL = 1e-5


def _jax_operands(in_f, out_f, rows, seed):
    """The JAX probe's operands from numpy: x (bf16 rows, as f32), the
    split prologue's (x8a, x8b, xs, bs), the packed plane and dt as
    `_dt_operand` gives it."""
    rng = np.random.default_rng(seed)
    nb = in_f // 32
    qt = rng.integers(-8, 8, (nb, 32, out_f), dtype=np.int8)
    dt = (rng.random((nb, out_f), np.float32) * 0.02 + 0.001).astype(np.float16)
    x = np.array(jnp.asarray(rng.standard_normal((rows, in_f)), jnp.bfloat16)
                 .astype(jnp.float32))
    x8a, x8b, xs, bs = _quantize_rows_q80_split(jnp.asarray(x), nb)
    return x, (x8a, x8b, xs, bs), pack_q(qt).reshape(nb * 4, out_f), _dt_operand(jnp.asarray(dt))


@pytest.mark.parametrize("tile_n,tile_knb,cols,ksplit", [(256, 32, 32, 8), (128, 64, 128, 16)])
def test_p7_plain_matches_jax_fs_call_tiles(tile_n, tile_knb, cols, ksplit):
    _, split, qp, dt = _jax_operands(2048, 256, 1, seed=tile_n)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jprod.fs_call_tiles(*split, jnp.asarray(qp), dt, tile_n, tile_knb))
    x8, xs, bs, q, d = split_operands_from_jax(*split, qp, dt, device="cpu")
    got = int4_prod.fs_call_tiles(x8, xs, bs, q, d, cols, ksplit)  # CPU: the plain version
    assert got.shape == (1, 256) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= REL_TOL * np.abs(want).max()
    assert torch.equal(got, int4_prod.fs_call_tiles_plain(x8, xs, bs, q, d, cols, ksplit))


@pytest.mark.parametrize("rows", [1, 3])
def test_split_operands_are_the_port_prologue(rows):
    """The JAX split prologue carried across gives the port's own prologue
    exactly: the same int8 row, f16-rounded scales and block sums."""
    x, split, qp, dt = _jax_operands(1024, 128, rows, seed=rows)
    x8, xs, bs, q, d = split_operands_from_jax(*split, qp, dt, device="cpu")
    p8, ps, pb = int4_prod.q80_prologue(torch.from_numpy(x))
    assert (x8.dtype, xs.dtype, bs.dtype) == (torch.int8, torch.float32, torch.int32)
    assert torch.equal(x8, p8) and torch.equal(xs, ps) and torch.equal(bs, pb)
    assert torch.equal(q, torch.from_numpy(qp)) and d.dtype == torch.float16
    assert torch.equal(d.view(torch.int16), torch.from_numpy(np.asarray(dt)))


def test_split_operands_check_their_layout():
    _, (x8a, x8b, xs, bs), qp, dt = _jax_operands(256, 64, 2, seed=9)
    with pytest.raises(ValueError):
        split_operands_from_jax(x8a, x8b, xs[:, :128], bs, qp, dt, device="cpu")
    with pytest.raises(ValueError):
        split_operands_from_jax(x8a, x8b[:1], xs, bs, qp, dt, device="cpu")
    with pytest.raises(ValueError):
        split_operands_from_jax(x8a, x8b, xs, bs, qp[:8], dt, device="cpu")


def test_k1_tile_is_k1_on_the_cpu():
    """On CPU tensors the body at the first K1's tile and K1's call are
    both K1's plain version: one function on the same row."""
    x, q, d = int4_prod.make_operands(1024, 96, "cpu", seed=4, rows=2)
    x8, xs, bs = int4_prod.q80_prologue(x)
    assert torch.equal(int4_prod.fs_call_tiles(x8, xs, bs, q, d, *cuda_q40.FIRST_K1_TILE),
                       cuda_q40.q40_gemv_q80(x, q, d))


def test_wrappers_take_the_plain_version_on_the_cpu_and_count_nothing():
    x, q, d = int4_prod.make_operands(512, 64, "cpu")
    counts = [k.launches for k in int4_prod.KERNELS]
    x8, xs, bs = int4_prod.q80_prologue(x)
    for got, want in zip((x8, xs, bs), int4_prod.q80_prologue_plain(x)):
        assert torch.equal(got, want)
    for cols, ksplit in cuda_q40.GEMV_TILES:
        int4_prod.fs_call_tiles(x8, xs, bs, q, d, cols, ksplit)
    assert counts == [k.launches for k in int4_prod.KERNELS]


def test_body_checks_its_operands():
    x, q, d = int4_prod.make_operands(256, 64, "cpu")
    x8, xs, bs = int4_prod.q80_prologue(x)
    with pytest.raises(ValueError):  # a tile that is not built
        int4_prod.fs_call_tiles(x8, xs, bs, q, d, 48, 8)
    with pytest.raises(ValueError):  # block sums as f32
        int4_prod.fs_call_tiles(x8, xs, bs.float(), q, d, 32, 8)
    with pytest.raises(ValueError):  # 9 rows
        x9, xs9, bs9 = int4_prod.q80_prologue(torch.randn(9, 256))
        int4_prod.fs_call_tiles(x9, xs9, bs9, q, d, 32, 8)
    x3, xs3, bs3 = int4_prod.q80_prologue(torch.randn(3, 256))
    int4_prod.fs_call_tiles(x3, xs3, bs3, q, d, *cuda_q40.FIRST_K1_TILE)  # 1..8 rows
    with pytest.raises(ValueError):  # the other tiles: 1 or 8 rows
        int4_prod.fs_call_tiles(x3, xs3, bs3, q, d, 64, 8)
    with pytest.raises(ValueError):
        int4_prod.q80_prologue(torch.randn(2, 100))


def test_int4_prod_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):  # the card, unless told the CPU
        int4_prod.main(["--shape", "256,64"])
    rows = int4_prod.main(["--device", "cpu", "--shape", "1024,256", "--shape", "2048,128",
                           "--seed", "2"])
    assert [(r["in"], r["out"]) for r in rows] == [(1024, 256), (2048, 128)]
    for r in rows:
        # the CPU's K1 is its plain version, which sums in another order
        # than the blocked one: exact integer partials, a few f32 ulps
        assert r["k1_vs_blocked"] <= 1e-5 * r["out_scale"] and r["max_abs_err"] == 0.0
        assert [(t["cols"], t["ksplit"]) for t in r["tiles"]] == list(cuda_q40.GEMV_TILES)
    assert rows[0]["body"] == 1024 * 256 // 2 + 32 * 256 * 2 + 1024 + 32 * 8 + 256 * 4
    out = capsys.readouterr().out
    assert "not measured" in out and "K1 against its blocked order" in out
    assert int4_prod.SHAPES[0] == ("wqkv 2048->3072", 2048, 3072)


def test_k1_step_main_on_the_cpu(monkeypatch, capsys):
    """The K1-stacked timing probe: the card unless told the CPU; on the
    CPU each layer's four calls equal K1's plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        k1_step.main(["--layers", "1"])
    rows = k1_step.main(["--device", "cpu", "--layers", "1", "--seed", "3"])
    assert rows == [{"calls": 4, "max_abs_err": 0.0, "k1_stacked_ms": "not measured"}]
    assert "not measured" in capsys.readouterr().out
    step = k1_step.make_step("cpu", layers=2, shapes=(("a", 256, 64), ("b", 512, 32)))
    assert len(k1_step.step_calls(step)) == 4
    assert [tuple(c().shape) for c in k1_step.step_calls(step)] == [(1, 1, 64), (1, 1, 32)] * 2
