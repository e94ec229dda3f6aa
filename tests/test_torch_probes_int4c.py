"""P9 and P10's port (probes/int4c.py) against the JAX probe on the CPU: the
plain version against scripts/probe_int4c.py's `fs2d_call` and `fs_call`
(with `interpret=True`) at two tiles and against `_i8_call`, on the same
numpy draw; the port's `pack_feature_split` byte for byte against the
script's and against the port's T layout (`ops/quant.py:pack_q`). The JAX
tile_n stays the script's; `cols` and `blocks` are tiles of the port's plan
(probes/gemv.py `u4_tile_plan`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.ops.pallas_q40 import _dt_operand, _i8_call, _quantize_rows_q80
from distributed_llama_tpu_torch.ops import cuda_q40
from distributed_llama_tpu_torch.ops.cuda_q40 import _gemv_order
from distributed_llama_tpu_torch.ops.quant import pack_q
from distributed_llama_tpu_torch.probes import gemv, int4, int4b, int4c
from distributed_llama_tpu_torch.probes.operands import operands_from_jax
from scripts import probe_int4b as jb
from scripts import probe_int4c as jc

# exact corrected partials; the f32 block sums run in another order (the
# JAX kernel sums a k tile's blocks, then adds the tiles)
REL_TOL = 1e-5


def _jax_operands(in_f, out_f, seed, rows=1):
    """The JAX probe's operands from numpy: x8, xs from `_quantize_rows_q80`
    of f32 rows, bs from the script's `block_sums`, qt [nb, 32, out] and dt
    as `_dt_operand` gives it (the f16 plane's int16 bits)."""
    rng = np.random.default_rng(seed)
    nb = in_f // 32
    qt = rng.integers(-8, 8, (nb, 32, out_f), dtype=np.int8)
    dt = (rng.random((nb, out_f), np.float32) * 0.02 + 0.001).astype(np.float16)
    x = rng.standard_normal((rows, in_f), np.float32)
    x8, xs = _quantize_rows_q80(jnp.asarray(x), nb)
    return x8, xs, jb.block_sums(x8, nb), qt, _dt_operand(jnp.asarray(dt))


def _port(x8, xs, bs, qt, dt):
    """The same operands in the port's layouts on the CPU: x8, xs [R, nb],
    bs [R, nb] int32 (row r's sum at lane r*128 of the script's), qt and
    the raw-bits plane."""
    px8, pxs, pqt, pdt = operands_from_jax(x8, xs, qt, dt, device="cpu")
    pbs = torch.from_numpy(np.ascontiguousarray(np.asarray(bs)[:, ::128].T).astype(np.int32))
    return px8, pxs, pbs, pqt, pdt.view(torch.int16)


CASES = [(512, 512, 256, 8, 256, 8), (512, 512, 128, 16, 512, 16), (1024, 264, 88, 32, 256, 32)]


@pytest.mark.parametrize("in_f,out_f,tile_n,tile_knb,cols,blocks", CASES)
def test_p9_plain_matches_jax_fs2d_call(in_f, out_f, tile_n, tile_knb, cols, blocks):
    x8, xs, bs, qt, dt = _jax_operands(in_f, out_f, seed=tile_knb)
    nb = in_f // 32
    qp2d = jc.pack_feature_split(qt).reshape(nb * 4, out_f)
    want = np.asarray(jc.fs2d_call(x8, xs, bs, jnp.asarray(qp2d), dt, tile_n, tile_knb,
                                   interpret=True))
    px8, pxs, pbs, _, bits = _port(x8, xs, bs, qt, dt)
    got = int4c.fs2d_call(px8, pxs, pbs, torch.from_numpy(qp2d), bits, cols, blocks)  # plain
    assert got.shape == (1, out_f) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("in_f,out_f,tile_n,tile_knb,cols,blocks", CASES)
def test_p10_plain_matches_jax_fs_call(in_f, out_f, tile_n, tile_knb, cols, blocks):
    x8, xs, bs, qt, dt = _jax_operands(in_f, out_f, seed=tile_n)
    qp = jc.pack_feature_split(qt)
    want = np.asarray(jc.fs_call(x8, xs, bs, jnp.asarray(qp), dt, tile_n, tile_knb,
                                 interpret=True))
    px8, pxs, pbs, _, bits = _port(x8, xs, bs, qt, dt)
    got = int4c.fs_call(px8, pxs, pbs, torch.from_numpy(qp), bits, cols, blocks)
    assert got.shape == (1, out_f)
    assert np.abs(got.numpy() - want).max() <= REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("rows", [1, 3])
def test_p9_p10_compute_i8_calls_function(rows):
    """Both wrappers, both planes, at 1 and 3 rows: `_i8_call`'s function on
    the unpacked weight."""
    x8, xs, bs, qt, dt = _jax_operands(2048, 256, seed=9, rows=rows)
    want = np.asarray(_i8_call(x8, xs, jnp.asarray(qt), dt, interpret=True))
    px8, pxs, pbs, pqt, bits = _port(x8, xs, bs, qt, dt)
    qp = int4c.pack_feature_split(pqt)
    for d in (bits, bits.view(torch.float16)):
        for got in (int4c.fs_call(px8, pxs, pbs, qp, d, 256, 16),
                    int4c.fs2d_call(px8, pxs, pbs, qp.view(-1, 256), d, 512, 8)):
            assert np.abs(got.numpy() - want).max() <= REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("nb,out_f", [(16, 256), (4, 264), (2, 8)])
def test_pack_feature_split_is_the_scripts_and_the_t_layout(nb, out_f):
    qt = np.random.default_rng(nb).integers(-8, 8, (nb, 32, out_f), dtype=np.int8)
    qt[0, :, 0] = 7  # every nibble 15: the words' top byte 0xFF, the sign bit set
    got = int4c.pack_feature_split(torch.from_numpy(qt))
    assert got.dtype == torch.int32 and got.shape == (nb, 4, out_f)
    assert np.array_equal(got.numpy(), jc.pack_feature_split(qt))
    assert np.array_equal(got.reshape(nb * 4, out_f).numpy(), pack_q(qt))


def test_wrappers_take_the_plain_version_on_the_cpu_and_count_nothing():
    """On CPU tensors both wrappers give, at every tile on either plane, the
    signed weight's block terms (`block_terms`, no bs) summed in the tile's
    plan's order bit for bit, within 1e-5 of K1's plain GEMV on the same
    words and of B9; no launch is counted."""
    x8, xs, qt, dt, _ = int4.make_operands(1024, 128, 3, "cpu", seed=4)
    bs = int4b.block_sums(x8, 32)
    qp = int4c.pack_feature_split(qt)
    qp2d = qp.view(128, 128)
    before = (int4c.fs2d_call.launches, int4c.fs_call.launches)
    k1 = cuda_q40.q80_gemv_plain(x8, xs, bs, qp2d, dt)
    b9 = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt)
    terms = gemv.block_terms(x8, xs, qt, dt.float())
    tiles, left_out = int4c.tiles_for(32, 128)
    assert len(tiles) == 12 and left_out == 0
    for cols, blocks in tiles:
        ref = _gemv_order(terms, gemv.u4_tile_plan(32, 128, cols, blocks, gemv.W_FS))
        for d in (dt, dt.view(torch.int16)):
            assert torch.equal(int4c.fs2d_call(x8, xs, bs, qp2d, d, cols, blocks), ref)
            assert torch.equal(int4c.fs_call(x8, xs, bs, qp, d, cols, blocks), ref)
        for other in (k1, b9):
            assert (ref - other).abs().max().item() <= REL_TOL * other.abs().max().item()
    assert (int4c.fs2d_call.launches, int4c.fs_call.launches) == before


def test_checks_refuse_what_is_not_built():
    x8, xs, qt, dt, _ = int4.make_operands(1024, 128, 1, "cpu")
    bs = int4b.block_sums(x8, 32)
    qp = int4c.pack_feature_split(qt)
    qp2d = qp.view(128, 128)
    # tiles that are not built, and 16 splits of 2 blocks: past the cluster limit
    for cols, blocks in ((48, 8), (64, 8), (300, 8), (256, 5), (256, 2)):
        with pytest.raises(ValueError):
            int4c.fs2d_call(x8, xs, bs, qp2d, dt, cols, blocks)
    with pytest.raises(ValueError):
        int4c.fs_call(x8, xs, bs, qt, dt, 256, 8)  # B9's [nb, 32, out] int8
    with pytest.raises(ValueError):
        int4c.fs_call(x8, xs, bs, qp.view(torch.uint8), dt, 256, 8)  # bytes, not words
    for q, d, b in (
        (qp2d[:127], dt, bs),  # not a whole number of blocks
        (qp2d.t(), dt, bs),  # not contiguous
        (qp2d, dt.to(torch.bfloat16), bs),  # a bf16 plane
        (qp2d, dt.float(), bs),  # an f32 plane
        (qp2d, dt, bs.float()),  # bs as f32, as the JAX probe holds it
        (qp2d, dt, bs[:, :16]),  # bs of half the blocks
        (qp2d, dt, torch.cat([bs, bs])),  # two rows' sums for one row
    ):
        with pytest.raises(ValueError):
            int4c.fs2d_call(x8, xs, b, q, d, 256, 8)


def test_int4c_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):  # the card, unless told the CPU
        int4c.main(["--shape", "256,64"])
    rows = int4c.main(["--device", "cpu", "--shape", "512,128", "--shape", "1024,64",
                       "--only", "1024", "--seed", "2"])
    assert [r["probe"] for r in rows[:2]] == ["B9 baseline", "first K1 body"]
    tiles = rows[2:]
    assert len(tiles) == 2 * len(int4c.tiles_for(32, 64)[0]) == 24
    assert all(r["probe"] == "P9" and r["views_bit_equal"] and r["planes_bit_equal"]
               and r["bit_equal_plain"] and r["max_abs_err_vs_b9"] <= REL_TOL * r["out_scale"]
               for r in tiles)
    assert sum(r["default_plan"] for r in tiles) == 2
    assert [r["equals_p3"] for r in tiles if r["p3_plan"]] == [True, True]
    assert {r["plane"] for r in tiles} == {"f16", "i16"}
    assert tiles[0]["bytes"] == 1024 * 64 // 2 + 32 * 64 * 2 + 1024 + 32 * 8 + 64 * 4
    assert tiles[0]["phys_bytes"] == 1024 * 64 // 2 + 32 * 64 * 2
    out = capsys.readouterr().out
    assert "not measured" in out and "one instance" in out
    assert [s[1:] for s in int4c.SHAPES] == [(2048, 3072), (2048, 2048), (2048, 16384),
                                             (8192, 2048), (2048, 32768)]
