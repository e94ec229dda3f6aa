"""P5's port (probes/int4b.py) against the JAX probe on the CPU: the plain
version against scripts/probe_int4b.py's `sh_call` (with `interpret=True`)
for both storages at two tiles and against `_i8_call`, on the same numpy
draw; the port's `pack_split_half` and `block_sums` byte for byte against
the script's. The JAX tile_n stays the script's; `cols` and `blocks` are
tiles of the port's plan (probes/gemv.py `u4_tile_plan`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.ops.pallas_q40 import _dt_operand, _i8_call, _quantize_rows_q80
from distributed_llama_tpu_torch.ops import cuda_q40
from distributed_llama_tpu_torch.ops.cuda_q40 import _gemv_order
from distributed_llama_tpu_torch.probes import gemv, int4, int4b
from distributed_llama_tpu_torch.probes.operands import operands_from_jax
from scripts import probe_int4b as jb

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


def _storage(p8: np.ndarray, storage: str) -> np.ndarray:
    """The script's two storages of one byte plane."""
    if storage == "i8ops":
        return p8
    nb, _, half = p8.shape
    return np.ascontiguousarray(p8).view(np.int32).reshape(nb, 32, half // 4)


@pytest.mark.parametrize("storage", int4b.STORAGES)
@pytest.mark.parametrize("in_f,out_f,tile_n,tile_knb,cols,blocks",
                         [(512, 512, 256, 8, 512, 8), (1024, 768, 128, 16, 256, 16)])
def test_p5_plain_matches_jax_sh_call(storage, in_f, out_f, tile_n, tile_knb, cols, blocks):
    x8, xs, bs, qt, dt = _jax_operands(in_f, out_f, seed=tile_knb)
    nb, half = in_f // 32, out_f // 2
    qp = _storage(jb.pack_split_half(qt), storage)
    dt2 = dt.reshape(nb, 2, half)
    want = np.asarray(jb.sh_call(x8, xs, bs, jnp.asarray(qp), dt2, tile_n, tile_knb, storage,
                                 interpret=True))
    px8, pxs, pbs, _, bits = _port(x8, xs, bs, qt, dt)
    got = int4b.sh_call(px8, pxs, pbs, torch.from_numpy(qp), bits.reshape(nb, 2, half), cols,
                        blocks, storage)  # CPU: the plain version
    assert got.shape == (1, 2, half) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("rows", [1, 3])
def test_p5_computes_i8_calls_function_in_natural_order(rows):
    """Both storages and planes, at 1 and 3 rows: [R, 2, out / 2] reshaped
    is `_i8_call`'s [R, out]."""
    x8, xs, bs, qt, dt = _jax_operands(2048, 256, seed=9, rows=rows)
    want = np.asarray(_i8_call(x8, xs, jnp.asarray(qt), dt, interpret=True))
    px8, pxs, pbs, pqt, bits = _port(x8, xs, bs, qt, dt)
    qp = int4b.pack_split_half(pqt)
    for d in (bits, bits.view(torch.float16)):
        for storage in int4b.STORAGES:
            got = int4b.sh_call(px8, pxs, pbs, int4b.storage_view(qp, storage),
                                d.reshape(64, 2, 128), 256, 16, storage).reshape(rows, 256)
            assert np.abs(got.numpy() - want).max() <= REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("nb,out_f", [(16, 256), (4, 264), (2, 8)])
def test_pack_split_half_is_the_scripts(nb, out_f):
    qt = np.random.default_rng(nb).integers(-8, 8, (nb, 32, out_f), dtype=np.int8)
    qt[0, 0, :] = 7  # every nibble 15: bytes 0xFF
    qt[0, 1, :] = -8  # every nibble 0
    got = int4b.pack_split_half(torch.from_numpy(qt))
    want = jb.pack_split_half(qt)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    if out_f % 8 == 0:
        i32 = int4b.storage_view(got, "i32st")
        assert i32.dtype == torch.int32 and np.array_equal(i32.numpy(), _storage(want, "i32st"))
    assert torch.equal(int4b.unpack_split_half(got), torch.from_numpy(qt))


@pytest.mark.parametrize("rows", [1, 3])
def test_block_sums_are_the_scripts(rows):
    x8, _, bs, _, _ = _jax_operands(1024, 8, seed=rows, rows=rows)
    got = int4b.block_sums(torch.from_numpy(np.array(x8)), 32)
    assert got.dtype == torch.int32 and got.shape == (rows, 32)
    want = np.asarray(bs).reshape(32, rows, 128)
    assert np.array_equal(np.broadcast_to(got.numpy().T[:, :, None], want.shape), want)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_nothing():
    """On CPU tensors sh_call gives, in natural column order at every tile,
    storage and plane, the signed weight's block terms (`block_terms`, no
    bs) summed in the tile's plan's order bit for bit, within 1e-5 of B9's
    plain result; no launch is counted."""
    x8, xs, qt, dt, _ = int4.make_operands(1024, 512, 3, "cpu", seed=4)
    bs = int4b.block_sums(x8, 32)
    qp = int4b.pack_split_half(qt)
    before = int4b.sh_call.launches
    b9 = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt)
    terms = gemv.block_terms(x8, xs, qt, dt.float())
    tiles, left_out = int4b.tiles_for(32, 512)
    assert len(tiles) == 6 and left_out == 0
    for cols, blocks in tiles:
        ref = _gemv_order(terms, gemv.u4_tile_plan(32, 512, cols, blocks, gemv.W_SH))
        for d in (dt, dt.view(torch.int16)):
            for storage in int4b.STORAGES:
                got = int4b.sh_call(x8, xs, bs, int4b.storage_view(qp, storage),
                                    d.reshape(32, 2, 256), cols, blocks, storage)
                assert got.shape == (3, 2, 256) and torch.equal(got.reshape(3, 512), ref)
        assert (ref - b9).abs().max().item() <= REL_TOL * b9.abs().max().item()
    assert int4b.sh_call.launches == before


def test_checks_refuse_what_is_not_built():
    x8, xs, qt, dt, _ = int4.make_operands(1024, 256, 1, "cpu")
    bs = int4b.block_sums(x8, 32)
    qp, dt2 = int4b.pack_split_half(qt), dt.reshape(32, 2, 128)
    # tiles that are not built (512 columns: 256 bytes a CTA, past 128 a row),
    # and 16 splits of 2 blocks: past the cluster limit
    for cols, blocks in ((48, 8), (64, 8), (256, 5), (512, 8), (256, 2)):
        with pytest.raises(ValueError):
            int4b.sh_call(x8, xs, bs, qp, dt2, cols, blocks)
    for q, d, b, storage in (
        (qp, dt2, bs, "u8ops"),  # a storage the JAX probe does not have
        (qp, dt2, bs, "i32st"),  # the bytes without their int32 view
        (qp.view(torch.int32), dt2, bs, "i8ops"),  # the words as i8ops
        (qp.view(torch.uint8), dt2, bs, "i8ops"),  # uint8, not the script's int8
        (qt, dt2, bs, "i8ops"),  # B9's unpacked weight read as bytes: a 256-column plane
        (qp, dt, bs, "i8ops"),  # the [nb, out] plane, not [nb, 2, out / 2]
        (qp, dt2.to(torch.bfloat16), bs, "i8ops"),  # a bf16 plane
        (qp, dt2, bs.float(), "i8ops"),  # bs as f32, as the JAX probe holds it
        (qp, dt2, bs[:, 1:], "i8ops"),  # bs short of a block
    ):
        with pytest.raises(ValueError):
            int4b.sh_call(x8, xs, b, q, d, 256, 8, storage)
    # (out / 2) % (cols / 2) != 0: 132 bytes a row take no 128-byte CTA
    x8, xs, qt, dt, _ = int4.make_operands(1024, 264, 1, "cpu")
    qp, dt2 = int4b.pack_split_half(qt), dt.reshape(32, 2, 132)
    for cols in gemv.u4_tile_cols(gemv.W_SH):
        with pytest.raises(ValueError):
            int4b.sh_call(x8, xs, int4b.block_sums(x8, 32), qp, dt2, cols, 8)


def test_int4b_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):  # the card, unless told the CPU
        int4b.main(["--shape", "256,64"])
    rows = int4b.main(["--device", "cpu", "--shape", "512,128", "--shape", "1024,256",
                       "--only", "1024", "--seed", "2"])
    assert [r["probe"] for r in rows[:2]] == ["B9 baseline", "first K1 body"]
    tiles = rows[2:]
    # out / 2 = 128 bytes a row: only TN 256 (128 bytes a CTA) fits
    assert len(tiles) == 2 * len(int4b.tiles_for(32, 256)[0]) == 6
    assert all(r["probe"] == "P5" and r["storages"] == list(int4b.STORAGES)
               and r["storages_bit_equal"] and r["planes_bit_equal"] and r["bit_equal_plain"]
               and r["max_abs_err_vs_b9"] <= REL_TOL * r["out_scale"] for r in tiles)
    assert sum(r["default_plan"] for r in tiles) == 2
    assert [r["equals_p3"] for r in tiles if r["p3_plan"]] == [True, True]
    assert tiles[0]["bytes"] == 1024 * 256 // 2 + 32 * 256 * 2 + 1024 + 32 * 8 + 256 * 4
    out = capsys.readouterr().out
    assert "not measured" in out and "one instance" in out
    assert [s[1:] for s in int4b.SHAPES] == [(2048, 3072), (2048, 2048), (2048, 16384),
                                             (8192, 2048), (2048, 32768)]
