"""P3 and P4: true 4-bit weight storage for the int8 decode matmul, against
B9 (the counterpart of the JAX package's scripts/probe_int4.py).

B9 (`ops/cuda_q40.py:q40_i8_unpacked`) feeds unpacked int8 weights [nb, 32,
out] (1 byte a weight) to the int8 tensor cores. The probe asks what the
same matmul costs from half a byte a weight:

  A. the 4-bit plane made on the device from int8 (`pack_s4`, plain torch),
     checked by a round trip (`stage_a`);
  B. P3 (`i4_call`, scripts/probe_int4.py:153): the port's s4 storage with
     an int8 dot (__dp4a on the CUDA cores) or a bf16 dot (mma.sync), as a
     one-row GEMV that unpacks the nibbles in registers
     (csrc/i4_gemv_probe.cu, the template of csrc/i8_gemv.cuh), one launch
     a call at `i4_gemv_plan(nb, out)` (probes/gemv.py), a function of the
     shape alone;
  C. P4 (`i32_call`, :219): [nb, 4, out] int32 words, value q[b, 4j + g,
     o] + 8 in nibble j of word [b, g, o] (`pack_i32`), with an int8, a
     bf16 or an f32 dot, on the same GEMV template (the W_I32 loader of
     csrc/i4_gemv_probe.cu, P6's), one launch a call at `i32_plan`: the int8
     arm on __dp4a, the bf16 arm on exact f32 products on the CUDA cores,
     and the f32 arm, JAX's f32 dot of exact integers, the bf16 arm's
     instance under its own name and launch counter.

Every partial is an exact integer in every dot type. P3's two arms agree
with each other and P4's three with each other, each with its plain
version, which repeats the plan's order of f32 sums, bit for bit; P4 with
P3 where their plans agree, and both with B9 to within the f32 rounding of
another order. Each wrapper takes the plain version for CPU
tensors, launches its kernel for CUDA tensors or raises, and counts its
launches in `launches`.

    python -m distributed_llama_tpu_torch.probes.int4 [--device cpu] [--shape IN,OUT ...]

prints, per shape, each instance's max error against B9 and its cold and
hot time (probes/timing.py), with the card's name and power limit. Without
`--device cpu` it needs a CUDA device and raises otherwise.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..formats.quants import Q_BLOCK
from ..ops import cuda_q40
from ..ops.cuda_q40 import _gemv_order, quantize_rows_q80
from . import gemv, parse_shape

# the probe's four shapes (Llama-3.2-1B layer shapes) and the 1B's full
# wcls, the one main-path shape the probe's list cuts
SHAPES = (
    ("wqkv 2048->3072", 2048, 3072),
    ("w13  2048->16384", 2048, 16384),
    ("w2   8192->2048", 8192, 2048),
    ("wcls 2048->32768", 2048, 32768),
    ("wcls 2048->128256", 2048, 128256),
)

# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------


def pack_i32(qt: np.ndarray) -> np.ndarray:
    """[nb, 32, out] int8 in [-8,7] -> [nb, 4, out] int32; value[b, 4j+g, o]+8
    lives in nibble j of word [b, g, o]."""
    nb, _, out = qt.shape
    u = (qt.astype(np.int32) + 8).astype(np.uint32)  # [nb, 32, out] in 0..15
    w = np.zeros((nb, 4, out), np.uint32)
    for j in range(8):
        w |= u[:, 4 * j : 4 * j + 4, :] << np.uint32(4 * j)
    return w.astype(np.int32)


def pack_i32_t(qt: torch.Tensor) -> torch.Tensor:
    """`pack_i32` in torch, on qt's device."""
    u = qt.to(torch.int32) + 8
    w = torch.zeros((qt.shape[0], 4, qt.shape[2]), dtype=torch.int32, device=qt.device)
    for j in range(8):
        w |= u[:, 4 * j : 4 * j + 4, :] << (4 * j)  # nibble 7 wraps into the sign bit
    return w


def unpack_i32(qw: torch.Tensor) -> torch.Tensor:
    """[nb, 4, out] int32 nibble words -> [nb, 32, out] int8 in [-8, 7]."""
    planes = [((qw >> (4 * j)) & 0xF) - 8 for j in range(8)]  # rows 4j..4j+3
    return torch.cat(planes, dim=1).to(torch.int8)


def pack_s4(qt: torch.Tensor) -> torch.Tensor:
    """The port's 4-bit storage: [nb, 32, out] int8 in [-8, 7] -> [nb, 16,
    out] uint8, two's-complement nibbles, byte [b, i, o] holding q[b, 2i, o]
    in its low nibble and q[b, 2i + 1, o] in its high nibble. Plain torch on
    qt's device (JAX's `jnp.int4` leaves the packing to XLA)."""
    u = qt.to(torch.int16) & 0xF
    return (u[:, 0::2, :] | (u[:, 1::2, :] << 4)).to(torch.uint8)


def unpack_s4(qt4: torch.Tensor) -> torch.Tensor:
    """`pack_s4`'s inverse: [nb, 16, out] uint8 -> [nb, 32, out] int8."""
    u = qt4.to(torch.int16)
    lo, hi = u & 0xF, u >> 4
    q = torch.stack([lo, hi], dim=2).reshape(qt4.shape[0], 2 * qt4.shape[1], qt4.shape[2])
    return (q - ((q & 8) << 1)).to(torch.int8)  # sign-extend the nibble


def stage_a(qt: torch.Tensor) -> torch.Tensor:
    """Stage A: the 4-bit plane of qt made on qt's device, checked by a
    round trip. Returns the plane."""
    qt4 = pack_s4(qt)
    if not torch.equal(unpack_s4(qt4), qt):
        raise AssertionError("pack_s4 / unpack_s4 round trip lost values")
    return qt4


# ---------------------------------------------------------------------------
# plain versions and wrappers
# ---------------------------------------------------------------------------


def i4_call_plain(x8, xs, qt4, dt, dot: str = "int8", plan=None) -> torch.Tensor:
    """P3's plain version: the per-block terms of the unpacked s4 plane
    summed in the kernel's order under `plan` (by default `i4_gemv_plan`),
    bit for bit the kernel's. Both dots give the same exact partials, so
    the same bits."""
    if dot not in gemv.DOTS:
        raise ValueError(f"P3's dot is one of {tuple(gemv.DOTS)}, got {dot!r}")
    plan = plan or gemv.i4_gemv_plan(qt4.shape[0], qt4.shape[2])
    return _gemv_order(gemv.block_terms(x8, xs, unpack_s4(qt4), dt.to(torch.float32)), plan)


P4_DOTS = ("int8", "bf16", "f32")


def i32_plan(nb: int, out_f: int) -> gemv.GemvPlan:
    """P4's plan, a function of the shape alone: the codecs' rule at the
    feature-split words' geometry (`gemv.u4_gemv_plan` of W_FS, whose loads
    are W_I32's: 8 words a lane), which probes/p4_p11_ab.py --sweep chose
    over P3's `i4_gemv_plan`."""
    return gemv.u4_gemv_plan(nb, out_f, gemv.W_FS)


def i32_call_plain(x8, xs, qw, dt, dot: str = "int8", plan=None) -> torch.Tensor:
    """P4's plain version: the per-block terms of the unpacked nibble words
    summed in the kernel's order under `plan` (by default `i32_plan`), bit
    for bit the kernel's. The three dots give the same exact partials, so
    the same bits, and at P3's plan P3's."""
    if dot not in P4_DOTS:
        raise ValueError(f"P4's dot is one of {P4_DOTS}, got {dot!r}")
    plan = plan or i32_plan(qw.shape[0], qw.shape[2])
    return _gemv_order(gemv.block_terms(x8, xs, unpack_i32(qw), dt.to(torch.float32)), plan)


def _p4_instance(name: str, dot: str):
    # the f32 dot is the bf16 arm's route (exact f32 products): one instance
    code = gemv.DOTS["int8" if dot == "int8" else "bf16"]

    def call(x8, xs, qw, dt):
        cuda_q40.check_i8_operands(x8, xs, qw, dt, 4, torch.int32)
        if cuda_q40._device_kind(x8) == "cpu":
            return i32_call_plain(x8, xs, qw, dt, dot)
        out = gemv.launch_i4_gemv(x8, xs, qw, gemv.W_I32, code, dt,
                                  i32_plan(qw.shape[0], qw.shape[2]))
        call.launches += 1
        return out

    call.__name__ = call.__qualname__ = name
    call.__doc__ = (f"x8 [R <= 8, in] int8, xs [R, nb] f32, qw [nb, 4, out] int32, dt [nb, "
                    f"out] f16 -> [R, out] f32, with a {dot} dot, one launch at "
                    f"i32_plan(nb, out).")
    call.launches = 0
    return call


def _p3_instance(name: str, dot: str):
    def call(x8, xs, qt4, dt):
        cuda_q40.check_i8_operands(x8, xs, qt4, dt, Q_BLOCK // 2, torch.uint8)
        if cuda_q40._device_kind(x8) == "cpu":
            return i4_call_plain(x8, xs, qt4, dt, dot)
        plan = gemv.i4_gemv_plan(qt4.shape[0], qt4.shape[2])
        out = gemv.launch_i4_gemv(x8, xs, qt4, gemv.W_S4, gemv.DOTS[dot], dt, plan)
        call.launches += 1
        return out

    call.__name__ = call.__qualname__ = name
    call.__doc__ = (f"x8 [R <= 8, in] int8, xs [R, nb] f32, qt4 [nb, 16, out] uint8, dt "
                    f"[nb, out] f16 -> [R, out] f32, with a {dot} dot, one launch at "
                    f"i4_gemv_plan(nb, out).")
    call.launches = 0
    return call


i4_call_int8 = _p3_instance("i4_call_int8", "int8")
i4_call_bf16 = _p3_instance("i4_call_bf16", "bf16")
i32_call_int8 = _p4_instance("i32_call_int8", "int8")
i32_call_bf16 = _p4_instance("i32_call_bf16", "bf16")
i32_call_f32 = _p4_instance("i32_call_f32", "f32")

_I4 = {"int8": i4_call_int8, "bf16": i4_call_bf16}
_I32 = {"int8": i32_call_int8, "bf16": i32_call_bf16, "f32": i32_call_f32}


def i4_call(x8, xs, qt4, dt, dot: str = "int8") -> torch.Tensor:
    """P3: the int8 decode matmul from the port's s4 storage qt4 [nb, 16,
    out] uint8, with an int8 or a bf16 dot."""
    return _I4[dot](x8, xs, qt4, dt)


def i32_call(x8, xs, qw, dt, dot: str = "int8") -> torch.Tensor:
    """P4: the int8 decode matmul from [nb, 4, out] int32 nibble words, with
    an int8, a bf16 or an f32 dot."""
    return _I32[dot](x8, xs, qw, dt)


KERNELS = (i4_call_int8, i4_call_bf16, i32_call_int8, i32_call_bf16, i32_call_f32)

# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------


def make_operands(in_f: int, out_f: int, rows: int, device, seed: int = 0):
    """Random operands made on `device` from `seed`: x8 [rows, in] int8 and
    xs [rows, nb] f32 (Q80 of a normal row), qt [nb, 32, out] int8 in
    [-8, 7], dt [nb, out] f16 in [0.001, 0.021), and the f32 rows x."""
    nb = in_f // Q_BLOCK
    gen = torch.Generator(device=device).manual_seed(seed)
    qt = torch.randint(-8, 8, (nb, Q_BLOCK, out_f), generator=gen, device=device, dtype=torch.int8)
    dt = (torch.rand((nb, out_f), generator=gen, device=device) * 0.02 + 0.001).to(torch.float16)
    x = torch.randn((rows, in_f), generator=gen, device=device)
    x8, xs, _ = quantize_rows_q80(x, nb)
    return x8.to(torch.int8).reshape(rows, in_f), xs.contiguous(), qt, dt, x


def dequantized_bf16(qt: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """[in, out] bf16 weight q * d: the library yardstick's operand."""
    w = qt.to(torch.float32) * dt.to(torch.float32).unsqueeze(1)
    return w.reshape(-1, qt.shape[2]).to(torch.bfloat16)


def variants(qt: torch.Tensor):
    """(label, wrapper, plain(x8, xs, w, dt, dot), weight, dot, weight bytes
    per value) of B9 and the five instances, the storages made from qt on
    its device."""
    qt4 = stage_a(qt)
    qw = pack_i32_t(qt)
    return (
        ("i8 baseline", cuda_q40.q40_i8_unpacked,
         lambda x8, xs, w, dt, _dot: cuda_q40.q40_i8_unpacked_plain(x8, xs, w, dt), qt, "int8",
         1.0),
        ("s4 int8-dot", i4_call_int8, i4_call_plain, qt4, "int8", 0.5),
        ("s4 bf16-dot", i4_call_bf16, i4_call_plain, qt4, "bf16", 0.5),
        ("i32-unpack i8-dot", i32_call_int8, i32_call_plain, qw, "int8", 0.5),
        ("i32-unpack bf16-dot", i32_call_bf16, i32_call_plain, qw, "bf16", 0.5),
        ("i32-unpack f32-dot", i32_call_f32, i32_call_plain, qw, "f32", 0.5),
    )


def work(R: int, in_f: int, out_f: int, wbytes: float) -> tuple[int, int]:
    """(bytes, ops) of one call: weights, f16 scales, int8 rows, f32 row
    scales and the f32 output once each; 2 ops a weight a row."""
    nb = in_f // Q_BLOCK
    nbytes = int(in_f * out_f * wbytes) + nb * out_f * 2 + R * in_f + R * nb * 4 + R * out_f * 4
    return nbytes, 2 * R * in_f * out_f


def run_shape(label: str, in_f: int, out_f: int, device, seed: int = 0, timed: bool = True):
    """One shape of the probe at one activation row: B9 and the five
    instances on the same operands, each one's max error against B9, and
    (timed, on the card) its cold and hot ms, its plain version's ms and
    the library call's (torch.matmul of the bf16 row against the
    bf16-dequantized weight). Returns one dict per instance."""
    x8, xs, qt, dt, x = make_operands(in_f, out_f, 1, device, seed)
    found = variants(qt)
    ref = cuda_q40.q40_i8_unpacked(x8, xs, qt, dt)
    lib = None
    if timed:
        from . import timing

        w_bf16, xb = dequantized_bf16(qt, dt), x.to(torch.bfloat16)
        lib = timing.cold_hot_ms(torch.matmul, (xb, w_bf16), w_bf16.numel() * 2)
        del w_bf16
    out = []
    for name, fn, plain, w, dot, wb in found:
        got = fn(x8, xs, w, dt)
        nbytes, nops = work(1, in_f, out_f, wb)
        row = {"shape": label, "in": in_f, "out": out_f, "probe": name, "kernel": fn.__name__,
               "dot": dot, "max_err_vs_b9": (got - ref).abs().max().item(),
               "out_scale": ref.abs().max().item(), "bytes": nbytes, "ops": nops}
        if timed:
            cold, hot = timing.cold_hot_ms(fn, (x8, xs, w, dt), nbytes)
            row.update(cold_ms=cold, hot_ms=hot, gb_s_cold=nbytes / cold / 1e6,
                       plain_ms=timing.graph_ms([lambda: plain(x8, xs, w, dt, dot)], replays=5),
                       library_cold_ms=lib[0], library_hot_ms=lib[1])
        out.append(row)
    return out


def main(argv=None) -> list:
    """Run the probe over its shapes (or the `--shape`s given); print one
    line an instance and return the rows."""
    ap = argparse.ArgumentParser(prog="python -m distributed_llama_tpu_torch.probes.int4")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--shape", action="append", type=parse_shape, help="IN,OUT (repeatable)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    timed = device.type == "cuda"
    if timed:
        from . import timing

        print(f"card: {timing.card_line()}", flush=True)
    else:
        print("(CPU: the plain versions, correctness only; times not measured)", flush=True)
    rows = []
    for label, in_f, out_f in args.shape or SHAPES:
        shape_rows = run_shape(label, in_f, out_f, device, timed=timed)
        print(f"== {label} (int8 bytes: {in_f * out_f / 1e6:.1f} MB) ==", flush=True)
        for r in shape_rows:
            line = f"  {r['probe']}: maxerr vs B9 {r['max_err_vs_b9']:.3e}"
            if timed:
                line += (f", cold {r['cold_ms'] * 1e3:.1f} us ({r['gb_s_cold']:.0f} GB/s), "
                         f"hot {r['hot_ms'] * 1e3:.1f} us")
            print(line, flush=True)
        if timed:
            r = shape_rows[0]
            print(f"  library torch.matmul bf16: cold {r['library_cold_ms'] * 1e3:.1f} us, "
                  f"hot {r['library_hot_ms'] * 1e3:.1f} us", flush=True)
        rows.extend(shape_rows)
    print(json.dumps({"probe": "int4", "device": str(device), "rows": len(rows)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
