"""The kernel probes' port (distributed_llama_tpu_torch/probes) against the
JAX probes on the CPU: B9's plain version against `_i8_call`, P3's against
`i4_call` and P4's against `i32_call` (interpret mode), and P14's against
`stream_call` (under `force_tpu_interpret_mode`), on the same operands
carried across by `operands_from_jax`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from distributed_llama_tpu.ops.pallas_q40 import _dt_operand, _i8_call, _quantize_rows_q80
from distributed_llama_tpu.ops.quant import pack_q
from distributed_llama_tpu_torch.ops import cuda_q40
from distributed_llama_tpu_torch.ops.cuda_q40 import quantize_rows_q80
from distributed_llama_tpu_torch.probes import dma, gemv, int4
from distributed_llama_tpu_torch.probes.operands import operands_from_jax
from scripts import probe_dma as jdma
from scripts import probe_int4 as jint4

# B9/P3/P4: exact integer partials; the f32 block sums run in another order
REL_TOL = 1e-5


def _jax_operands(in_f, out_f, rows, seed):
    """The JAX probe's operands from numpy: x8, xs ([nb, R*128]) from
    `_quantize_rows_q80`, qt [nb, 32, out] int8, dt as `_dt_operand` gives it."""
    rng = np.random.default_rng(seed)
    nb = in_f // 32
    qt = rng.integers(-8, 8, (nb, 32, out_f), dtype=np.int8)
    dt = (rng.random((nb, out_f), np.float32) * 0.02 + 0.001).astype(np.float16)
    x = rng.standard_normal((rows, in_f), np.float32)
    x8, xs = _quantize_rows_q80(jnp.asarray(x), nb)
    return x, x8, xs, qt, _dt_operand(jnp.asarray(dt))


def _within(got, want):
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= REL_TOL * scale


@pytest.mark.parametrize("rows,in_f,out_f", [(1, 2176, 256), (4, 1024, 512)])
def test_b9_plain_matches_jax_i8_call(rows, in_f, out_f):
    _, x8, xs, qt, dt = _jax_operands(in_f, out_f, rows, seed=rows)
    want = np.asarray(_i8_call(x8, xs, jnp.asarray(qt), dt, interpret=True))
    px8, pxs, pqt, pdt = operands_from_jax(x8, xs, qt, dt, device="cpu")
    got = cuda_q40.q40_i8_unpacked(px8, pxs, pqt, pdt)  # CPU tensors: the plain version
    assert got.shape == (rows, out_f) and got.dtype == torch.float32
    _within(got.numpy(), want)
    _within(cuda_q40.q40_i8_unpacked_plain(px8, pxs, pqt, pdt).numpy(), want)


@pytest.mark.parametrize("dot", ["int8", "bf16"])
def test_p3_plain_matches_jax_i4_call(dot):
    _, x8, xs, qt, dt = _jax_operands(2176, 256, 1, seed=3)
    qt4 = jnp.asarray(qt).astype(jnp.int4)
    wconv = {"int8": jnp.int8, "bf16": jnp.bfloat16}[dot]
    want = np.asarray(jint4.i4_call(x8, xs, qt4, dt, wconv=wconv, interpret=True))
    px8, pxs, pqt4, pdt = operands_from_jax(x8, xs, qt4, dt, device="cpu")
    assert pqt4.dtype == torch.uint8 and pqt4.shape == (68, 16, 256)
    _within(int4.i4_call(px8, pxs, pqt4, pdt, dot=dot).numpy(), want)
    _within(int4.i4_call_plain(px8, pxs, pqt4, pdt, dot).numpy(), want)


@pytest.mark.parametrize("dot", ["int8", "bf16"])
def test_p3_plain_matches_jax_i4_call_at_w2_depth(dot):
    """At the 1B w2's depth (nb 256) P3's plan splits the contraction (8
    splits of 32 blocks at 256 columns): the plain order against JAX's
    `i4_call`, within REL_TOL of the output's largest value (exact integer
    partials, the f32 block sums in another order)."""
    _, x8, xs, qt, dt = _jax_operands(8192, 256, 1, seed=5)
    assert gemv.i4_gemv_plan(256, 256).splits > 1
    qt4 = jnp.asarray(qt).astype(jnp.int4)
    wconv = {"int8": jnp.int8, "bf16": jnp.bfloat16}[dot]
    want = np.asarray(jint4.i4_call(x8, xs, qt4, dt, wconv=wconv, interpret=True))
    px8, pxs, pqt4, pdt = operands_from_jax(x8, xs, qt4, dt, device="cpu")
    _within(int4.i4_call(px8, pxs, pqt4, pdt, dot=dot).numpy(), want)


@pytest.mark.parametrize("dot", ["int8", "bf16", "f32"])
def test_p4_plain_matches_jax_i32_call(dot):
    _, x8, xs, qt, dt = _jax_operands(1024, 384, 1, seed=4)
    qw = jint4.pack_i32(qt)
    wconv = {"int8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}[dot]
    want = np.asarray(jint4.i32_call(x8, xs, jnp.asarray(qw), dt, wconv=wconv, interpret=True))
    px8, pxs, pqw, pdt = operands_from_jax(x8, xs, qw, dt, device="cpu")
    _within(int4.i32_call(px8, pxs, pqw, pdt, dot=dot).numpy(), want)
    _within(int4.i32_call_plain(px8, pxs, pqw, pdt, dot).numpy(), want)


def test_port_q80_operands_equal_jax():
    """The port's Q80 prologue gives the JAX probe's x8 and (carried
    across) xs exactly, so both sides start from the same bytes."""
    x, x8, xs, qt, dt = _jax_operands(1024, 256, 3, seed=5)
    px8, pxs, _, pdt = operands_from_jax(x8, xs, qt, dt, device="cpu")
    q8, qs, _ = quantize_rows_q80(torch.from_numpy(x), 32)
    assert torch.equal(q8.to(torch.int8).reshape(3, 1024), px8)
    assert torch.equal(qs, pxs)
    assert pdt.dtype == torch.float16


def test_operands_from_jax_layouts():
    rng = np.random.default_rng(6)
    R, nb = 3, 5
    scales = rng.random((R, nb), np.float32)
    xs = np.repeat(scales.T[:, :, None], 128, axis=2).reshape(nb, R * 128)
    x8 = rng.integers(-127, 128, (R, nb * 32), dtype=np.int8)
    dt16 = rng.random((nb, 64)).astype(np.float16)
    qt = rng.integers(-8, 8, (nb, 32, 64), dtype=np.int8)
    got = operands_from_jax(x8, xs, np.asarray(jnp.asarray(qt).astype(jnp.int4)),
                            dt16.view(np.int16), device="cpu")
    assert torch.equal(got[1], torch.from_numpy(scales))
    assert torch.equal(int4.unpack_s4(got[2]), torch.from_numpy(qt))
    assert torch.equal(got[3], torch.from_numpy(dt16))
    for w in (qt, jint4.pack_i32(qt)):  # int8 and int32 planes pass as they are
        assert np.array_equal(operands_from_jax(x8, xs, w, dt16, device="cpu")[2].numpy(), w)
    with pytest.raises(ValueError):
        operands_from_jax(x8, xs[:, :128], qt, dt16, device="cpu")


def test_pack_i32_equals_the_script_byte_for_byte():
    qt = np.random.default_rng(7).integers(-8, 8, (9, 32, 40), dtype=np.int8)
    want = jint4.pack_i32(qt)
    assert int4.pack_i32(qt).tobytes() == want.tobytes()
    assert int4.pack_i32_t(torch.from_numpy(qt)).numpy().tobytes() == want.tobytes()
    assert torch.equal(int4.unpack_i32(torch.from_numpy(want)), torch.from_numpy(qt))


def test_pack_s4_round_trip_and_layout():
    qt = torch.from_numpy(np.random.default_rng(8).integers(-8, 8, (6, 32, 24), dtype=np.int8))
    qt4 = int4.stage_a(qt)
    assert qt4.dtype == torch.uint8 and qt4.shape == (6, 16, 24)
    assert torch.equal(int4.unpack_s4(qt4), qt)
    # byte [b, i, o]: q[b, 2i, o] in the low nibble, q[b, 2i + 1, o] in the high one
    lo = (qt4.to(torch.int16) & 0xF) - (((qt4.to(torch.int16) & 0xF) & 8) << 1)
    assert torch.equal(lo.to(torch.int8), qt[:, 0::2, :])


@pytest.mark.parametrize("tile_n,tile_knb", [(256, 4), (128, 8)])
def test_stream_plain_matches_jax_stream_call(tile_n, tile_knb):
    rng = np.random.default_rng(tile_n)
    nb, out_f = 16, 512
    qt = rng.integers(-8, 8, (nb, 32, out_f), dtype=np.int8)
    qp = pack_q(qt).reshape(nb * 4, out_f)
    bias = rng.standard_normal((8, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jdma.stream_call(jnp.asarray(bias), jnp.asarray(qp), tile_n, tile_knb))
    out, chk = dma.stream_call(torch.from_numpy(bias), torch.from_numpy(qp), tile_n, tile_knb)
    # JAX adds f32 corners in grid order; the port sums them exactly, once
    assert np.abs(out.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    grid_j, grid_k = out_f // tile_n, nb // tile_knb
    tiles = qp.reshape(grid_k, 4 * tile_knb, grid_j, tile_n)
    want_chk = np.bitwise_xor.reduce(np.bitwise_xor.reduce(tiles, axis=3), axis=1).T
    assert chk.shape == (grid_j, grid_k)
    assert np.array_equal(chk.numpy(), want_chk)


def test_stream_call_checks_its_tile():
    bias, qp = dma.make_plane(1024, 512, "cpu")
    for tn, tk in ((384, 8), (64, 8), (512, 3), (512, 1)):
        with pytest.raises(ValueError):
            dma.stream_call(bias, qp, tn, tk)
    assert dma.tiles_for(2048, 128256) == [(tn, tk) for tn in (128, 256) for tk in (8, 16, 32, 64)]


def test_wrappers_take_the_plain_version_on_the_cpu_and_count_nothing():
    x8, xs, qt, dt, _ = int4.make_operands(512, 128, 2, "cpu")
    counts = [k.launches for k in (cuda_q40.q40_i8_unpacked, *int4.KERNELS, *dma.KERNELS)]
    ref = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt)
    qt4 = int4.pack_s4(qt)
    # exact partials: at one plan's order P3's bits, whatever the storage or dot
    p3 = {"s4": int4.i4_call_int8(x8, xs, qt4, dt),
          "i32": int4.i4_call_plain(x8, xs, qt4, dt, "int8", int4.i32_plan(16, 128))}
    for label, fn, plain, w, dot, _ in int4.variants(qt)[1:]:
        got = fn(x8, xs, w, dt)
        assert torch.equal(got, plain(x8, xs, w, dt, dot))
        assert torch.equal(got, p3[label.split()[0].split("-")[0]]), fn.__name__
        _within(got.numpy(), ref.numpy())
    dma.stream_call(*dma.make_plane(1024, 512, "cpu"), 256, 8)
    assert counts == [k.launches for k in (cuda_q40.q40_i8_unpacked, *int4.KERNELS,
                                            *dma.KERNELS)]


def test_b9_operand_checks():
    x8, xs, qt, dt, _ = int4.make_operands(256, 64, 1, "cpu")
    x9, xs9, _, _, _ = int4.make_operands(256, 64, 9, "cpu")
    with pytest.raises(ValueError):
        cuda_q40.q40_i8_unpacked(x9, xs9, qt, dt)  # 9 rows
    with pytest.raises(ValueError):
        cuda_q40.q40_i8_unpacked(x8, xs, qt[:, :, :60].contiguous(), dt[:, :60].contiguous())
    with pytest.raises(ValueError):
        cuda_q40.q40_i8_unpacked(x8, xs, int4.pack_s4(qt), dt)  # P3's storage
    with pytest.raises(ValueError):
        cuda_q40.q40_i8_unpacked(x8, xs.t(), qt, dt)


@pytest.mark.parametrize("nb,out_f", [(64, 3072), (256, 2048), (68, 256), (64, 128256), (4, 64)])
def test_split_k_is_a_function_of_the_shape(nb, out_f):
    s = cuda_q40.i8_mma_splits(nb, out_f)
    assert 1 <= s <= max(1, nb // 8)
    assert s == cuda_q40.i8_mma_splits(nb, out_f)


def test_int4_run_shape_on_the_cpu():
    rows = int4.run_shape("1024->256", 1024, 256, "cpu", timed=False)
    assert [r["probe"] for r in rows] == ["i8 baseline", "s4 int8-dot", "s4 bf16-dot",
                                          "i32-unpack i8-dot", "i32-unpack bf16-dot",
                                          "i32-unpack f32-dot"]
    for r in rows:  # P3 and P4 sum in their plan's order, B9 in its own
        assert r["max_err_vs_b9"] <= (REL_TOL * r["out_scale"] if r["kernel"] != "q40_i8_unpacked"
                                      else 0.0)
    assert rows[0]["bytes"] == 1024 * 256 + 32 * 256 * 2 + 1024 + 32 * 4 + 256 * 4


def test_dma_run_shape_on_the_cpu():
    best = dma.run_shape("2048->512", 2048, 512, "cpu", timed=False)
    assert best["tiles"] == len(dma.tiles_for(2048, 512)) > 0
    assert best["checksums_equal_all_tiles"] and best["max_rel_err_all_tiles"] == 0.0


def test_probe_mains_need_a_gpu_unless_told_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (int4.main, dma.main):
        with pytest.raises(RuntimeError):
            main(["--shape", "256,64"])
    assert len(int4.main(["--device", "cpu", "--shape", "256,64"])) == 6
    assert len(dma.main(["--device", "cpu", "--shape", "2048,256"])) == 1
    out = capsys.readouterr().out
    assert "not measured" in out and "maxerr vs B9 0.000e+00" in out


@pytest.mark.parametrize("dot", ["int8", "bf16", "f32"])
def test_p4_plain_matches_jax_i32_call_at_w2_depth(dot):
    """At the 1B w2's depth (nb 256) P4's plan splits the contraction (8
    splits of 32 blocks at 256 columns): the plain order against JAX's
    `i32_call`, within REL_TOL of the output's largest value (exact integer
    partials, the f32 block sums in another order), and the wrapper on CPU
    tensors equal to it."""
    _, x8, xs, qt, dt = _jax_operands(8192, 256, 1, seed=6)
    assert int4.i32_plan(256, 256).splits > 1
    qw = jint4.pack_i32(qt)
    wconv = {"int8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}[dot]
    want = np.asarray(jint4.i32_call(x8, xs, jnp.asarray(qw), dt, wconv=wconv, interpret=True))
    px8, pxs, pqw, pdt = operands_from_jax(x8, xs, qw, dt, device="cpu")
    got = int4.i32_call_plain(px8, pxs, pqw, pdt, dot)
    _within(got.numpy(), want)
    assert torch.equal(int4.i32_call(px8, pxs, pqw, pdt, dot=dot), got)
