"""P6's port (probes/i4_tiles.py) against the JAX probe on the CPU: the
plain version against scripts/sweep_i4_tiles.py's `i4_sweep_call` (with
`interpret=True`) for each of its three variants and two tiles, and
against `_i8_call`, on the same operands carried across by
`operands_from_jax`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.ops.pallas_q40 import _dt_operand, _i8_call, _quantize_rows_q80
from distributed_llama_tpu_torch.ops import cuda_q40
from distributed_llama_tpu_torch.probes import i4_tiles, int4
from distributed_llama_tpu_torch.probes.operands import operands_from_jax
from scripts import probe_int4 as jint4
from scripts import sweep_i4_tiles as jsweep

# exact integer partials in every variant; the f32 block sums run in
# another order
REL_TOL = 1e-5


def _jax_operands(in_f, out_f, seed):
    """The JAX sweep's operands from numpy: x8, xs from `_quantize_rows_q80`
    of one f32 row, qt [nb, 32, out], qw its i32 words and dt as
    `_dt_operand` gives it (the f16 plane's int16 bits)."""
    rng = np.random.default_rng(seed)
    nb = in_f // 32
    qt = rng.integers(-8, 8, (nb, 32, out_f), dtype=np.int8)
    dt = (rng.random((nb, out_f), np.float32) * 0.02 + 0.001).astype(np.float16)
    x = rng.standard_normal((1, in_f), np.float32)
    x8, xs = _quantize_rows_q80(jnp.asarray(x), nb)
    return x8, xs, qt, jint4.pack_i32(qt), _dt_operand(jnp.asarray(dt))


@pytest.mark.parametrize("variant", i4_tiles.VARIANTS)
@pytest.mark.parametrize("tile_n,tile_knb,cols,blocks",
                         [(512, 8, 512, 8), (1024, 32, 128, 32), (256, 16, 1024, 16)])
def test_p6_plain_matches_jax_i4_sweep_call(variant, tile_n, tile_knb, cols, blocks):
    x8, xs, qt, qw, dt = _jax_operands(1024, 1024, seed=tile_knb)
    want = np.asarray(jsweep.i4_sweep_call(x8, xs, jnp.asarray(qw), dt, tile_n, tile_knb,
                                           variant, interpret=True))
    px8, pxs, pqw, pdt = operands_from_jax(x8, xs, qw, dt, device="cpu")
    assert pqw.dtype == torch.int32 and pdt.dtype == torch.float16
    bits = pdt.view(torch.int16)  # the JAX kernel's `_dt_operand` plane
    got = i4_tiles.i4_sweep_call(px8, pxs, pqw, bits, cols, blocks, variant)  # CPU: plain
    assert got.shape == (1, 1024) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= REL_TOL * np.abs(want).max()


def test_p6_plain_matches_jax_i8_call():
    """Every variant is `_i8_call`'s function on the i32 words."""
    x8, xs, qt, qw, dt = _jax_operands(2048, 256, seed=9)
    want = np.asarray(_i8_call(x8, xs, jnp.asarray(qt), dt, interpret=True))
    px8, pxs, pqw, pdt = operands_from_jax(x8, xs, qw, dt, device="cpu")
    bits = pdt.view(torch.int16)
    for variant in i4_tiles.VARIANTS:
        got = i4_tiles.i4_sweep_call(px8, pxs, pqw, bits, 128, 16, variant).numpy()
        assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_nothing():
    x8, xs, qt, dt, _ = int4.make_operands(1024, 128, 3, "cpu", seed=4)
    qw = int4.pack_i32_t(qt)
    before = i4_tiles.i4_sweep_call.launches
    ref = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt)
    for variant in i4_tiles.VARIANTS:
        for cols, blocks in ((128, 8), (256, 16), (1024, 32)):
            got = i4_tiles.i4_sweep_call(x8, xs, qw, dt.view(torch.int16), cols, blocks, variant)
            assert torch.equal(got, i4_tiles.i4_sweep_call_plain(
                x8, xs, qw, dt.view(torch.int16), cols, blocks, variant))
            # exact partials, the f32 block sums in the tile's order
            assert (got - ref).abs().max() <= REL_TOL * ref.abs().max()
    assert i4_tiles.i4_sweep_call.launches == before


def test_checks_refuse_what_is_not_built():
    x8, xs, qt, dt, _ = int4.make_operands(1024, 128, 1, "cpu")
    qw, bits = int4.pack_i32_t(qt), dt.view(torch.int16)
    with pytest.raises(ValueError):
        i4_tiles.i4_sweep_call(x8, xs, qw, bits, 128, 8, "concat-f32")
    # not a tile width, not a divisor of nb, 16 splits past the cluster limit
    for cols, blocks in ((48, 8), (64, 8), (128, 5), (512, 2)):
        with pytest.raises(ValueError):
            i4_tiles.i4_sweep_call(x8, xs, qw, bits, cols, blocks)
    with pytest.raises(ValueError):  # B9's unpacked weight, not the words
        i4_tiles.i4_sweep_call(x8, xs, qt, bits, 128, 8)
    with pytest.raises(ValueError):  # an f32 plane
        i4_tiles.i4_sweep_call(x8, xs, qw, dt.float(), 128, 8)
    with pytest.raises(ValueError):  # the f16 plane, not its int16 bits
        i4_tiles.i4_sweep_call(x8, xs, qw, dt, 128, 8)


def test_i4_tiles_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):  # the card, unless told the CPU
        i4_tiles.main(["--shape", "256,64"])
    rows = i4_tiles.main(["--device", "cpu", "--shape", "512,128", "--shape", "1024,64",
                          "--only", "1024", "--seed", "2"])
    assert [r["probe"] for r in rows][:1] == ["B9 baseline"] and rows[0]["in"] == 1024
    tiles = rows[1:]
    assert len(tiles) == len(i4_tiles.tiles_for(32)[0])
    assert all(r["variants"] == list(i4_tiles.VARIANTS) and r["max_abs_err"] == 0.0
               and r["bit_equal_plain"] and r["max_abs_err_vs_b9"] <= REL_TOL * r["out_scale"]
               for r in tiles)
    assert [r["equals_p3"] for r in tiles if r["p3_plan"]] == [True]
    assert tiles[0]["bytes"] == 1024 * 64 // 2 + 32 * 64 * 2 + 1024 + 32 * 4 + 64 * 4
    out = capsys.readouterr().out
    assert "not measured" in out and "one instance" in out and "0 tiles left out" in out
    assert [s[1:] for s in i4_tiles.SHAPES] == [(2048, 3072), (2048, 2048), (2048, 16384),
                                                (8192, 2048), (2048, 32768)]
