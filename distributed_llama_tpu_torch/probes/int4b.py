"""P5: the split-half unsigned-nibble codec for the int8 decode matmul (the
counterpart of the JAX package's scripts/probe_int4b.py), and what the two
unsigned codecs share (probes/int4c.py holds P9 and P10).

Both codecs store u = q + 8 in half a byte a weight and take the integer
dot with u, then subtract 8 * bs[r, b], the row block's sum of x8
(`block_sums`), before they scale: the corrected partial is the signed one
exactly. On the card they are two loaders of the one-row GEMV template
(csrc/i8_gemv.cuh, with P2, P3 and P6) behind one C entry,
csrc/i4_codec_probe.cu: __dp4a on the CUDA cores, the nibbles unpacked in
registers, one launch a call (probes/gemv.py: `launch_u4_gemv`, the plans,
`check_u4_operands`).

P5's plane (`pack_split_half`): byte [b, k, c] of [nb, 32, out / 2] holds
column c's u in its low nibble and column c + out / 2's in its high nibble,
so one byte feeds two output columns. `sh_call(x8, xs, bs, qp, dt2, cols,
blocks_per_cta, storage)` (scripts/probe_int4b.py:119, body `_kernel_sh`
:71) reads the plane as int8 bytes ("i8ops", [nb, 32, out / 2]) or as int32
words ("i32st", [nb, 32, out / 8]): the same bytes, one instance on the
card. dt2 is the [nb, out] scale plane viewed as [nb, 2, out / 2], f16 or
its raw int16 bits (the JAX probe's `_dt_operand`), and the result is
[R, 2, out / 2], which reshapes to natural column order. The tile is the
plan (`gemv.u4_tile_plan`): a CTA owns `cols` output columns (one of
`gemv.u4_tile_cols(W_SH)`): cols / 2 bytes of each k row, a lane 4 of
them, whose low nibbles give cols / 2 columns of the first half and whose
high nibbles give the same cols / 2 columns of the second. So (out / 2) %
(cols / 2) must be 0: the JAX grid's (out / 2) % tile_n, with tile_n bytes
(a TPU lane width) giving 2 * tile_n columns. `blocks_per_cta` is
tile_knb, the blocks of one split (a divisor of nb, at most 8 splits: the
cluster limit; `tiles_for` leaves out and counts the JAX tiles past it).
The plain version sums in the plan's order and equals the kernel bit for
bit; `gemv.u4_gemv_plan(nb, out, W_SH)` is the default plan.

The wrapper takes its plain version for CPU tensors, launches its kernel
for CUDA tensors or raises, and counts its launches in `launches`.

    python -m distributed_llama_tpu_torch.probes.int4b [--device cpu] [--only LABEL]
        [--seed N] [--shape IN,OUT ...]

runs the JAX script's five Llama-3.2-1B shapes (or the `--shape`s given;
`--only` keeps the shapes whose label holds LABEL): B9's baseline and the first K1's
body at its tile on the same weights, then every tile of `tiles_for` with
the f16 and the i16 plane (one launch a storage), each bit for bit against
the plain version and within 1e-5 of B9, at P3's plan against P3's int8
arm; on the card each point's cold and hot µs a call
(probes/timing.py) and a chain of 64 calls in one CUDA graph, GB/s against
the bytes the script counts (half a byte a weight, 2 a block), its CTAs
and its speed against B9 and the first K1's body; then the best tile per shape and plane.
Without `--device cpu` it needs a CUDA device and raises otherwise.
"""

from __future__ import annotations

import argparse
import json
from functools import partial

import torch

from ..device import resolve_device
from ..formats.quants import Q_BLOCK
from ..ops import cuda_q40
from ..ops.cuda_q40 import FIRST_K1_TILE, _gemv_order
from ..ops.quant import pack_q
from . import gemv, parse_shape
from .gemv import W_SH
from .int4 import i4_call_int8, make_operands, pack_s4
from .int4_prod import fs_call_tiles, fs_call_tiles_plain
from .scales import library_ms, plane_f32, timed

STORAGES = ("i8ops", "i32st")
# the JAX script's shapes (Llama-3.2-1B; wcls cut to 32768)
SHAPES = (
    ("wqkv 2048->3072", 2048, 3072),
    ("wo   2048->2048", 2048, 2048),
    ("w13  2048->16384", 2048, 16384),
    ("w2   8192->2048", 8192, 2048),
    ("wcls 2048->32768", 2048, 32768),
)

# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------


def block_sums(x8: torch.Tensor, nb: int) -> torch.Tensor:
    """[R, nb*32] int8 -> [R, nb] int32 block sums (the script's, without
    its [nb, R*128] lane layout)."""
    return x8.reshape(x8.shape[0], nb, Q_BLOCK).to(torch.int32).sum(dim=-1, dtype=torch.int32)


def pack_split_half(qt: torch.Tensor) -> torch.Tensor:
    """[nb, 32, out] int8 in [-8, 7] -> [nb, 32, out / 2] int8 bytes: byte
    [b, k, c] = (q[b, k, c] + 8) | ((q[b, k, c + out / 2] + 8) << 4)."""
    half = qt.shape[2] // 2
    u = qt.to(torch.int16) + 8
    return (u[:, :, :half] | (u[:, :, half:] << 4)).to(torch.uint8).view(torch.int8)


def unpack_split_half(qp: torch.Tensor) -> torch.Tensor:
    """`pack_split_half`'s inverse: [nb, 32, out / 2] bytes -> [nb, 32, out]
    int8 in [-8, 7]."""
    u = qp.view(torch.uint8).to(torch.int16)
    return torch.cat([(u & 0xF) - 8, (u >> 4) - 8], dim=2).to(torch.int8)


def storage_view(qp: torch.Tensor, storage: str) -> torch.Tensor:
    """The split-half bytes as `storage` holds them: "i8ops" [nb, 32, out / 2]
    int8 as they are, "i32st" their little-endian [nb, 32, out / 8] int32
    view."""
    _check_storage(storage)
    return qp if storage == "i8ops" else qp.view(torch.int32)


def _check_storage(storage: str) -> None:
    if storage not in STORAGES:
        raise ValueError(f"storage must be one of {STORAGES}, got {storage!r}")


def tiles_for(nb: int, out_f: int) -> tuple[list, int]:
    """P5's (cols, blocks_per_cta) tiles at nb blocks by out_f columns, and
    the count of the JAX tiles past the cluster limit left out."""
    return gemv.u4_tiles_for(nb, out_f, W_SH)


# ---------------------------------------------------------------------------
# P5: plain version and wrapper
# ---------------------------------------------------------------------------


def _operands(x8, xs, bs, qp, dt2, cols: int, blocks_per_cta: int, storage: str):
    """Check P5's operands and tile; return the byte plane [nb, 32, out / 2]
    int8 and the scale plane [nb, out], both views of what was given, and
    the tile's plan."""
    _check_storage(storage)
    want = (torch.int8, 1) if storage == "i8ops" else (torch.int32, 4)
    if qp.ndim != 3 or qp.shape[1] != Q_BLOCK or qp.dtype != want[0]:
        raise ValueError(f"{storage} takes a [nb, 32, out / {2 * want[1]}] {want[0]} plane, got "
                         f"{qp.dtype} {tuple(qp.shape)}")
    if dt2.ndim != 3 or dt2.shape[1] != 2:
        raise ValueError(f"dt2 must be [nb, 2, out / 2], got {tuple(dt2.shape)}")
    for name, t in (("qp", qp), ("dt2", dt2)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    w8 = qp.view(torch.int8)
    dt = dt2.reshape(dt2.shape[0], 2 * dt2.shape[2])
    gemv.check_u4_operands(x8, xs, bs, w8, dt, W_SH)
    nb, out_f = dt.shape
    return w8, dt, gemv.u4_tile_plan(nb, out_f, cols, blocks_per_cta, W_SH)


def sh_call_plain(x8, xs, bs, qp, dt2, cols: int, blocks_per_cta: int,
                  storage: str = "i8ops") -> torch.Tensor:
    """P5's plain version: the bytes unpacked to u = q + 8, each block's
    dot less 8 * bs times xs * dt on the plane's f32 values
    (`gemv.block_terms`), summed in the tile's plan's order
    (`_gemv_order`) -> [R, 2, out / 2] f32, bit for bit the kernel's."""
    w8, dt, plan = _operands(x8, xs, bs, qp, dt2, cols, blocks_per_cta, storage)
    u = unpack_split_half(w8) + 8
    out = _gemv_order(gemv.block_terms(x8, xs, u, plane_f32(dt), bs), plan)
    return out.reshape(x8.shape[0], 2, dt.shape[1] // 2)


def sh_call(x8, xs, bs, qp, dt2, cols: int, blocks_per_cta: int,
            storage: str = "i8ops") -> torch.Tensor:
    """P5: x8 [R <= 8, in] int8, xs [R, nb] f32, bs [R, nb] int32 block sums
    of x8, qp the split-half plane as `storage` holds it, dt2 [nb, 2, out / 2]
    f16 or int16 (raw f16 bits) -> [R, 2, out / 2] f32, at a CTA of `cols`
    columns owning `blocks_per_cta` blocks (the plan `gemv.u4_tile_plan`),
    one launch. Both storages run the one instance."""
    if cuda_q40._device_kind(x8) == "cpu":
        return sh_call_plain(x8, xs, bs, qp, dt2, cols, blocks_per_cta, storage)
    w8, dt, plan = _operands(x8, xs, bs, qp, dt2, cols, blocks_per_cta, storage)
    out = gemv.launch_u4_gemv(x8, xs, bs, w8, W_SH, dt, plan)
    sh_call.launches += 1
    return out.reshape(x8.shape[0], 2, dt.shape[1] // 2)


sh_call.launches = 0

KERNELS = (sh_call,)

# ---------------------------------------------------------------------------
# what the two codecs' probes share
# ---------------------------------------------------------------------------


def planes(dt16: torch.Tensor) -> dict:
    """The f16 plane and its raw bits: {"f16": K1's and B9's own, "i16":
    the JAX probes' `_dt_operand`}."""
    return {"f16": dt16, "i16": dt16.view(torch.int16)}


def work(R: int, in_f: int, out_f: int) -> dict:
    """(bytes, phys_bytes, ops) of one codec call: half a byte a weight,
    the 2-byte scale plane, int8 rows, f32 row scales, int32 block sums and
    the f32 output once each; `phys_bytes` the script's `phys_mb` (weights
    and scales alone); 2 ops a weight a row."""
    nb = in_f // Q_BLOCK
    phys = in_f * out_f // 2 + nb * out_f * 2
    return {"bytes": phys + R * in_f + R * nb * 8 + R * out_f * 4, "phys_bytes": phys,
            "ops": 2 * R * in_f * out_f}


def err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.reshape(want.shape) - want).abs().max().item()


def baselines(label: str, in_f: int, out_f: int, x8, xs, bs, qt, q2d, dt16, x,
              time_it: bool) -> tuple[list, dict]:
    """B9 (`q40_i8_unpacked`, 1 byte a weight) and the first K1's body at its tile
    (`fs_call_tiles`, the T layout q2d) on one shape's operands, each
    against its plain version and, on the card, timed. Returns (the two
    rows, the library call's cold and hot ms: torch.matmul of the bf16 row
    against the bf16-dequantized plane)."""
    nb = in_f // Q_BLOCK
    w = work(1, in_f, out_f)
    b9_bytes = in_f * out_f + nb * out_f * 2 + in_f + nb * 4 + out_f * 4
    rows = [
        {"probe": "B9 baseline", "kernel": "q40_i8_unpacked", "shape": label, "in": in_f,
         "out": out_f, "bytes": b9_bytes, "phys_bytes": in_f * out_f + nb * out_f * 2,
         "ops": w["ops"], "cols": cuda_q40.I8_MMA_COLS,
         "max_abs_err": err(cuda_q40.q40_i8_unpacked(x8, xs, qt, dt16),
                            cuda_q40.q40_i8_unpacked_plain(x8, xs, qt, dt16))},
        {"probe": "first K1 body", "kernel": "fs_call_tiles", "shape": label, "in": in_f,
         "out": out_f, **w, "cols": FIRST_K1_TILE[0], "ksplit": FIRST_K1_TILE[1],
         "max_abs_err": err(fs_call_tiles(x8, xs, bs, q2d, dt16, *FIRST_K1_TILE),
                            fs_call_tiles_plain(x8, xs, bs, q2d, dt16, *FIRST_K1_TILE))},
    ]
    rows[0]["out_scale"] = cuda_q40.q40_i8_unpacked_plain(x8, xs, qt, dt16).abs().max().item()
    rows[1]["out_scale"] = rows[0]["out_scale"]
    if not time_it:
        return rows, {}
    rows[0].update(timed(cuda_q40.q40_i8_unpacked, (x8, xs, qt, dt16), b9_bytes))
    rows[1].update(timed(lambda *a: fs_call_tiles(*a, *FIRST_K1_TILE), (x8, xs, bs, q2d, dt16),
                         w["bytes"]))
    for r in rows:
        r["gb_s_phys"] = r["phys_bytes"] / r["cold_ms"] / 1e6
    return rows, library_ms(x, qt, dt16)


def point(label: str, in_f: int, out_f: int, probe: str, kernel: str, plane: str, cols: int,
          blocks: int, got, want, b9, extra: dict) -> dict:
    """One (tile, plane) row of a codec sweep, untimed."""
    nb = in_f // Q_BLOCK
    return {"probe": probe, "kernel": kernel, "shape": label, "in": in_f, "out": out_f,
            "plane": plane, "cols": cols, "blocks_per_cta": blocks, "splits": nb // blocks,
            "ctas": -(-out_f // cols) * (nb // blocks), "max_abs_err": err(got, want),
            "max_abs_err_vs_b9": err(got, b9), "out_scale": want.abs().max().item(),
            **work(1, in_f, out_f), **extra}


def time_point(row: dict, fn, operands: tuple, base: list, extra: dict) -> None:
    """Time a sweep row's call on the card: cold, hot and chained, GB/s
    against the script's bytes, its speed against B9 and the first K1's body."""
    row.update(timed(fn, operands, row["bytes"]), **extra)
    row["gb_s_phys"] = row["phys_bytes"] / row["cold_ms"] / 1e6
    row["x_b9"] = base[0]["cold_ms"] / row["cold_ms"]
    row["x_first_k1"] = base[1]["cold_ms"] / row["cold_ms"]


def plain_ms(fn, *args) -> float:
    """The plain version's time on the card, one call in a graph."""
    from . import timing

    return timing.graph_ms([partial(fn, *args)], replays=5)


def print_shape(label: str, base: list, rows: list, time_it: bool, flags: tuple) -> None:
    """One shape's lines: the baselines, a line a point (with its `flags`,
    the names of the row's bit-equality checks), and the best tile a plane."""
    for b in base:
        line = f"  {b['probe']}: maxerr vs plain {b['max_abs_err']:.3e}"
        if time_it:
            line += (f"; cold {b['cold_ms'] * 1e3:.2f} us ({b['gb_s_phys']:.0f} GB/s), hot "
                     f"{b['hot_ms'] * 1e3:.2f} us, chain {b['chain_ms'] * 1e3:.2f} us")
        print(line, flush=True)
    for r in rows:
        line = (f"  {r['probe']} {r['plane']} TN {r['cols']:4d} x {r['blocks_per_cta']:3d} "
                f"blocks ({r['ctas']:5d} CTAs): maxerr vs plain {r['max_abs_err']:.3e}, vs B9 "
                f"{r['max_abs_err_vs_b9']:.3e}")
        line += "".join(f", {f} {r[f]}" for f in flags if f in r)
        if time_it and "cold_ms" in r:
            line += (f"; cold {r['cold_ms'] * 1e3:.2f} us ({r['gb_s_phys']:.0f} GB/s, "
                     f"{r['x_b9']:.2f}x B9, {r['x_first_k1']:.2f}x first K1), hot "
                     f"{r['hot_ms'] * 1e3:.2f} us, "
                     f"chain {r['chain_ms'] * 1e3:.2f} us")
        print(line, flush=True)
    if time_it:
        for plane in ("f16", "i16"):
            for what, r in (("BEST", best(rows, plane)), ("DEFAULT", default_row(rows, plane))):
                print(f"  {what} {label} {plane}: TN {r['cols']} x {r['blocks_per_cta']} blocks "
                      f"{r['cold_ms'] * 1e3:.2f} us cold ({r['gb_s_phys']:.0f} GB/s, "
                      f"{r['x_b9']:.2f}x B9, {r['x_first_k1']:.2f}x first K1)", flush=True)


def best(rows: list, plane: str) -> dict:
    """The timed row of least cold time on `plane`."""
    return min((r for r in rows if r["plane"] == plane and "cold_ms" in r),
               key=lambda r: r["cold_ms"])


def default_row(rows: list, plane: str) -> dict:
    """The row of the default plan's tile on `plane`."""
    return next(r for r in rows if r["plane"] == plane and r.get("default_plan"))


def parse_args(prog: str, argv):
    ap = argparse.ArgumentParser(prog=f"python -m distributed_llama_tpu_torch.probes.{prog}")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--only", default=None, help="keep the shapes whose label holds this")
    ap.add_argument("--shape", action="append", type=parse_shape, help="IN,OUT (repeatable)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random operands")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    time_it = device.type == "cuda"
    if time_it:
        from . import timing

        print(f"card: {timing.card_line()}", flush=True)
    else:
        print("(CPU: the plain versions, correctness only; times not measured)", flush=True)
    return args, device, time_it


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------


def sweep_shape(label: str, in_f: int, out_f: int, device, seed: int = 0,
                time_it: bool = True) -> dict:
    """One shape: the baselines, then every tile with each plane, both
    storages launched (one instance: bit-equal) against the plain order
    of the tile's plan bit for bit and against B9; at P3's plan against
    P3's int8 arm; the i8ops launch timed. Returns {"baseline": rows,
    "tiles": rows, "left_out": the JAX tiles past the cluster limit}."""
    nb = in_f // Q_BLOCK
    x8, xs, qt, dt16, x = make_operands(in_f, out_f, 1, device, seed)
    bs = block_sums(x8, nb)
    q2d = torch.from_numpy(pack_q(qt.cpu().numpy())).to(device)  # K1's T layout
    base, lib = baselines(label, in_f, out_f, x8, xs, bs, qt, q2d, dt16, x, time_it)
    del q2d
    qp = pack_split_half(qt)
    views = {s: storage_view(qp, s) for s in STORAGES}
    b9 = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt16)
    dt2 = {p: d.reshape(nb, 2, out_f // 2) for p, d in planes(dt16).items()}
    tiles, left_out = tiles_for(nb, out_f)
    if not tiles:
        raise ValueError(f"{label}: no CTA width's half divides out / 2 = {out_f // 2}")
    # the signed weight's block terms, without bs: in a plan's order, the
    # codec's output at that plan, from the unpacked weight alone
    terms = {p: gemv.block_terms(x8, xs, qt, plane_f32(d)) for p, d in planes(dt16).items()}
    default = gemv.u4_gemv_plan(nb, out_f, W_SH)
    default = (default.cols, default.blocks_per_split)
    p3 = gemv.u4_p3_tile(nb, out_f, W_SH)
    p3_out = i4_call_int8(x8, xs, pack_s4(qt), dt16) if p3 in tiles else None
    extra = {p: {"plain_ms": plain_ms(sh_call_plain, x8, xs, bs, qp, d, *default), **lib}
             for p, d in dt2.items()} if time_it else {}
    rows = []
    for cols, blocks in tiles:
        plan = gemv.u4_tile_plan(nb, out_f, cols, blocks, W_SH)
        outs = {}
        for plane, d in dt2.items():
            got = {s: sh_call(x8, xs, bs, views[s], d, cols, blocks, s) for s in STORAGES}
            outs[plane] = got["i8ops"]
            want = _gemv_order(terms[plane], plan)
            flags = {"storages": list(STORAGES),
                     "storages_bit_equal": torch.equal(got["i8ops"], got["i32st"]),
                     "bit_equal_plain": torch.equal(got["i8ops"].reshape(want.shape), want),
                     "default_plan": (cols, blocks) == default, "p3_plan": (cols, blocks) == p3}
            if flags["p3_plan"]:
                flags["equals_p3"] = torch.equal(got["i8ops"].reshape(p3_out.shape), p3_out)
            row = point(label, in_f, out_f, "P5", "sh_call", plane, cols, blocks, got["i8ops"],
                        want, b9, flags)
            if time_it:
                time_point(row, sh_call, (x8, xs, bs, qp, d, cols, blocks), base, extra[plane])
            rows.append(row)
        for row in rows[-len(dt2):]:
            row["planes_bit_equal"] = torch.equal(outs["f16"], outs["i16"])
    return {"baseline": base, "tiles": rows, "left_out": left_out}


# the checks a sweep row prints beside its own bit-equalities
FLAGS = ("bit_equal_plain", "planes_bit_equal", "default_plan", "p3_plan", "equals_p3")


def main(argv=None) -> list:
    """Run P5 over its shapes; print the baselines, one line a point and
    the best tile per shape and plane; return the rows."""
    args, device, time_it = parse_args("int4b", argv)
    cols = "/".join(map(str, gemv.u4_tile_cols(W_SH)))
    print(f"storages {', '.join(STORAGES)}: one instance on the card (the same bytes); JAX "
          f"tile_n (bytes, a TPU lane width) has no CTA counterpart: TN sweeps {cols} columns a "
          f"CTA, TN / 2 bytes of each k row, 4 a lane; tile_knb -> blocks a split, at most "
          f"{gemv.MAX_SPLITS} splits", flush=True)
    rows = []
    for label, in_f, out_f in args.shape or SHAPES:
        if args.only and args.only not in label:
            continue
        got = sweep_shape(label, in_f, out_f, device, args.seed, time_it)
        w = work(1, in_f, out_f)
        print(f"== {label} packed {w['phys_bytes'] / 1e6:.2f} MB | {got['left_out']} JAX tiles "
              f"left out (more than {gemv.MAX_SPLITS} splits) ==", flush=True)
        print_shape(label, got["baseline"], got["tiles"], time_it, ("storages_bit_equal", *FLAGS))
        rows.extend(got["baseline"])
        rows.extend(got["tiles"])
    print(json.dumps({"probe": "int4b", "device": str(device), "rows": len(rows)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
