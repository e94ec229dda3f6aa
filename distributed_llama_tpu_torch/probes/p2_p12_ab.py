"""P2 (the int8 decode matmul on an f32 or raw-bits scale plane) and P12
(grouped decode attention on a head-major cache) against their earlier
designs, and the sweeps that choose their plans, in one process on one
card.

    python -m distributed_llama_tpu_torch.probes.p2_p12_ab --old DIR [--out FILE]
    python -m distributed_llama_tpu_torch.probes.p2_p12_ab --sweep [p2 | p12] [--out FILE]

`--old`: DIR holds an earlier `attention_probe.cu` with the C entry point
of P12 before the one-launch cluster design (a partials buffer and a second
pass; the caller's split count), for example from `git show
<commit>:distributed_llama_tpu_torch/csrc/attention_probe.cu`. It is
compiled here with the port's nvcc flags into build/kernels/ and called
through its own C signature. P2's earlier arm needs no old source: it was
P13's int8-MMA instance at P2_TILE (128 columns, 64 blocks a CTA), which
the current build still holds. Each case is timed old, new, new, old (CUDA
events over CUDA-graph replays, probes/timing.graph_ms), cold: a case's
calls walk copies of their operands that together take at least
timing.RING_BYTES (4x the L2). Beside them: the bound (bytes moved over the
card's memory rate: each input read once, the output written once; P12
only the visible K/V rows), one PyTorch call's time (P2: `torch.matmul` of
the bf16 row against the bf16-dequantized weight; P12:
`scaled_dot_product_attention` with enable_gqa on the cache cut to pos +
1), the plain version's, and the new output against the old one and against
its plain version (P2 bit for bit, P12 relative to the output's largest
value).

`--sweep`: compiles csrc/i8_gemv_probe.cu with -DDLT_P2_SWEEP (every (vec,
kw) pair a plan can name) and times every P2 plan at 2048 -> 8192 (4 or 8
columns a lane x 2, 4 or 8 warps along k x 1..8 splits) at 1 and 8 rows on
both planes, each held to its plain order bit for bit; and P12 at clusters
of up to 8 and 16 CTAs and every instance (warps a CTA, tile rows, ring
depth) that csrc/attention_probe.cu builds with -DDLT_P12_SWEEP, at S 1024,
2048 and 32768, hd 64 and 128, each within
ATT_REL_TOL of its plain version, with the number of its clusters the card
holds at once (cudaOccupancyMaxActiveClusters) and SDPA's time beside it.

Prints one JSON line a case and the card's `nvidia-smi` name and power
limit; `--out` also writes them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..formats.quants import Q_BLOCK
from ..ops import kernels
from . import attention, scales, timing
from .int4 import dequantized_bf16
from .operands import scale_planes

BW = 3.35e12  # H100 SXM data sheet: bytes/s
ATT_REL_TOL = 2.0 ** -6  # P12 against its plain version, of the output's largest value
P2_ROWS = (1, 8)
# every (columns a lane, warps along k) pair csrc/i8_gemv_probe.cu builds
# with -DDLT_P2_SWEEP
P2_SWEEP_PAIRS = ((4, 2), (4, 4), (4, 8), (8, 2), (8, 4), (8, 8))
SEQS = (1024, 2048, 32768)
# (label, h, kv, hd): the Llama-3.2-1B attention, the same at hd 128, and
# Qwen3-30B-A3B's (kv 4, g 8, hd 128)
ATT_SHAPES = (("1B h 32 kv 8 hd 64", 32, 8, 64), ("h 32 kv 8 hd 128", 32, 8, 128),
              ("30B-A3B h 32 kv 4 hd 128", 32, 4, 128))

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, q_is_f32, k, v, b, n_kv, g, S, hd, pos, col0, splits, scale, m_part,
# l_part, acc_part, out, stream
OLD_SIG = {"decode_attention": (P, I, P, P, I, I, I, I, I, I, I, I, F, P, P, P, P, P)}


def old_splits(b: int, n_kv: int, S: int) -> int:
    """The earlier P12's split of S per (row, kv head): about 512 CTAs, at
    least one 64-row tile each."""
    return max(1, min(-(-S // 64), 512 // (b * n_kv)))


def build_old(src_dir: Path) -> ctypes.CDLL:
    """Compile the earlier attention_probe.cu with the port's flags."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kernels.BUILD_DIR / "libold_attention_probe.so"
    cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", str(out),
           str(src_dir / "attention_probe.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the earlier attention_probe.cu:\n{proc.stdout}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in OLD_SIG.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.dlt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dlt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def old_attention(lib, q, k, v, pos: int) -> torch.Tensor:
    """The earlier P12: a first pass into partials, a second pass merging
    them, at `old_splits`."""
    b, h, hd = q.shape
    n_kv, S = k.shape[1], k.shape[2]
    g = h // n_kv
    splits = old_splits(b, n_kv, S)
    m_part = torch.empty((b * n_kv, splits, g), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b * n_kv, splits, g, hd), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    kernels.check(lib, lib.decode_attention(
        q.data_ptr(), int(q.dtype == torch.float32), k.data_ptr(), v.data_ptr(), b, n_kv, g, S,
        hd, pos, 0, splits, 1.0 / (hd ** 0.5), m_part.data_ptr(), l_part.data_ptr(),
        acc_part.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "old decode_attention")
    return out


def _turns(old, new) -> dict:
    """old, new, new, old: each a list of zero-argument calls in one graph,
    ms a call."""
    t = [timing.graph_ms(c) for c in (old, new, new, old)]
    return {"old_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2, "turns_ms": t}


def _emit(row: dict, rows: list) -> None:
    if "old_ms" in row:
        row["speedup"] = row["old_ms"] / row["new_ms"]
    print(json.dumps(row), flush=True)
    rows.append(row)


def p2_operands(gen, rows: int):
    """Copies of P2's operands at 2048 -> 8192 that together reach the
    ring: [(x8, xs, qt, {plane: dt})], and the bf16 rows and dequantized
    weights of the library call."""
    _, in_f, out_f = scales.P2_SHAPE
    nb = in_f // Q_BLOCK
    nbytes = scales.work(rows, in_f, out_f, 1.0, 4)[0]
    sets, lib = [], []
    for _ in range(timing.ring_size(nbytes)):
        qt = torch.randint(-8, 8, (nb, Q_BLOCK, out_f), generator=gen, device="cuda",
                           dtype=torch.int8)
        dt16 = (torch.randn((nb, out_f), generator=gen, device="cuda") * 0.01).half()
        x = torch.randn((rows, in_f), generator=gen, device="cuda").bfloat16().float()
        x8, xs, _ = scales.quantize_rows_q80(x, nb)
        x8 = x8.to(torch.int8).reshape(rows, in_f)
        planes = scale_planes(dt16)
        sets.append((x8, xs.contiguous(), qt, planes))
        lib.append((x.to(torch.bfloat16), dt16))
    return sets, lib


def p2_cases(gen) -> list:
    out = []
    _, in_f, out_f = scales.P2_SHAPE
    plan = scales.i8_gemv_plan(in_f // Q_BLOCK, out_f)
    for rows in P2_ROWS:
        sets, lib_in = p2_operands(gen, rows)
        lib_w = [dequantized_bf16(s[2], d16) for s, (_, d16) in zip(sets, lib_in)]
        x8, xs, qt, pl = sets[0]
        got = {p: scales.scale_plane_call(x8, xs, qt, pl[p]) for p in ("f32", "i16")}
        p13 = scales.i8_tile_call(x8, xs, qt, pl["f16"], *scales.P2_TILE)
        for plane in ("f32", "i16"):
            want = scales.scale_plane_call_plain(x8, xs, qt, pl[plane])
            old = [lambda s=s, p=plane: scales.i8_tile_call(s[0], s[1], s[2], s[3][p],
                                                            *scales.P2_TILE) for s in sets]
            new = [lambda s=s, p=plane: scales.scale_plane_call(s[0], s[1], s[2], s[3][p])
                   for s in sets]
            nbytes = scales.work(rows, in_f, out_f, 1.0, pl[plane].element_size())[0]
            row = {"case": f"P2 {in_f}->{out_f} {plane} plane, {rows} rows", "rows": rows,
                   "plane": plane, **_turns(old, new), "bound_ms": nbytes / BW * 1e3,
                   "bound_by": "bytes",
                   "library_ms": timing.graph_ms([lambda x=x, w=w: torch.matmul(x, w)
                                                  for (x, _), w in zip(lib_in, lib_w)]),
                   "plain_ms": timing.graph_ms([lambda: scales.scale_plane_call_plain(
                       x8, xs, qt, pl[plane])], replays=3),
                   "new_equals_plain": torch.equal(got[plane], want),
                   "planes_bit_equal": torch.equal(got["f32"], got["i16"]),
                   "new_vs_old_max_abs": (got[plane] - p13).abs().max().item(),
                   "out_scale": want.abs().max().item(), "plan": plan.__dict__,
                   "ctas": plan.ctas(out_f), "old_ctas": -(-out_f // scales.P2_TILE[0])
                   * (in_f // Q_BLOCK // scales.P2_TILE[1])}
            _emit(row, out)
        if rows > 1:  # each row equals its one-row call
            singles = torch.cat([scales.scale_plane_call(x8[r:r + 1], xs[r:r + 1], qt, pl["i16"])
                                 for r in range(rows)])
            out[-1]["rows_equal_one_row_calls"] = torch.equal(singles, got["i16"])
        del sets, lib_in, lib_w
        torch.cuda.empty_cache()
    return out


def att_operands(gen, h: int, kv: int, hd: int, S: int):
    """Copies of P12's q, K, V (b 1) that together reach the ring."""
    nbytes = 2 * kv * S * hd * 2
    return [(torch.randn((1, h, hd), generator=gen, device="cuda").bfloat16(),
             torch.randn((1, kv, S, hd), generator=gen, device="cuda").bfloat16(),
             torch.randn((1, kv, S, hd), generator=gen, device="cuda").bfloat16())
            for _ in range(timing.ring_size(nbytes))]


def _att_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def p12_cases(lib, gen) -> list:
    import torch.nn.functional as Fn

    out = []
    for label, h, kv, hd in ATT_SHAPES:
        for S in SEQS:
            sets = att_operands(gen, h, kv, hd, S)
            pos = S - 10
            q, k, v = sets[0]
            plan = attention.attention_plan(S, hd)
            got = attention.decode_attention(q, k, v, pos)
            old1 = old_attention(lib, q, k, v, pos)
            want = attention.decode_attention_plain(q, k, v, pos)
            nbytes = 2 * (pos + 1) * kv * hd * 2 + 2 * h * hd * 2
            sq = [s[0].reshape(1, 1, h, hd).transpose(1, 2) for s in sets]
            before = attention.decode_attention.launches
            attention.decode_attention(q, k, v, pos)
            launches = attention.decode_attention.launches - before
            row = {"case": f"P12 {label}, S {S}, pos {pos}", "S": S, "hd": hd, "kv": kv,
                   **_turns([lambda s=s: old_attention(lib, *s, pos) for s in sets],
                            [lambda s=s: attention.decode_attention(*s, pos) for s in sets]),
                   "bound_ms": nbytes / BW * 1e3, "bound_by": "bytes",
                   "library_ms": timing.graph_ms([
                       lambda a=a, s=s: Fn.scaled_dot_product_attention(
                           a, s[1][:, :, :pos + 1], s[2][:, :, :pos + 1], enable_gqa=True)
                       for a, s in zip(sq, sets)]),
                   "plain_ms": timing.graph_ms([lambda: attention.decode_attention_plain(
                       q, k, v, pos)], replays=3),
                   "new_vs_plain_rel": _att_err(got, want), "new_vs_old_rel": _att_err(got, old1),
                   "launches_a_call": launches,
                   "old_launches_a_call": 2, "plan": plan.__dict__,
                   "ctas": kv * plan.cluster, "old_ctas": kv * old_splits(1, kv, S),
                   "max_active_clusters": attention._launch_attention(q, k, v, pos, 0, plan,
                                                                      max_clusters=True)}
            _emit(row, out)
            del sets
            torch.cuda.empty_cache()
    return out


def p2_sweep(gen) -> list:
    from .k1_ab import _compile, _open

    lib_path = kernels.BUILD_DIR / "libp2_sweep.so"
    lib = _open(_compile(kernels.CSRC / f"{scales.P2_SOURCE}.cu", lib_path, ("-DDLT_P2_SWEEP",)),
                lib_path, scales._P2_SIG, f"{scales.P2_SOURCE}.cu -DDLT_P2_SWEEP")
    out = []
    _, in_f, out_f = scales.P2_SHAPE
    nb = in_f // Q_BLOCK
    for rows in P2_ROWS:
        sets, _ = p2_operands(gen, rows)
        x8, xs, qt, pl = sets[0]
        for vec, kw in P2_SWEEP_PAIRS:
            cols = 32 * vec * (scales.P2_WARPS // kw)
            for splits in (1, 2, 4, 8):
                bps = -(-nb // splits)
                plan = scales.GemvPlan(vec, cols, kw, splits, bps)
                for plane in ("f32", "i16"):
                    got = scales.launch_scale_plane(x8, xs, qt, pl[plane], plan, lib)
                    ms = timing.graph_ms([lambda s=s, p=plan, d=plane: scales.launch_scale_plane(
                        s[0], s[1], s[2], s[3][d], p, lib) for s in sets])
                    nbytes = scales.work(rows, in_f, out_f, 1.0, pl[plane].element_size())[0]
                    _emit({"sweep": "P2", "rows": rows, "plane": plane, "plan": plan.__dict__,
                           "ctas": plan.ctas(out_f), "ms": ms, "bound_ms": nbytes / BW * 1e3,
                           "equals_plain": torch.equal(got, scales.scale_plane_call_plain(
                               x8, xs, qt, pl[plane], plan))}, out)
        del sets
        torch.cuda.empty_cache()
    return out


def p12_sweep(gen) -> list:
    import torch.nn.functional as Fn

    from .k1_ab import _compile, _open

    lib_path = kernels.BUILD_DIR / "libp12_sweep.so"
    lib = _open(_compile(kernels.CSRC / "attention_probe.cu", lib_path, ("-DDLT_P12_SWEEP",)),
                lib_path, attention._SIG, "attention_probe.cu -DDLT_P12_SWEEP")
    out = []
    for label, h, kv, hd in ATT_SHAPES:
        for S in SEQS:
            sets = att_operands(gen, h, kv, hd, S)
            pos = S - 10
            q, k, v = sets[0]
            lib_ms = timing.graph_ms([
                lambda s=s: Fn.scaled_dot_product_attention(
                    s[0].reshape(1, 1, h, hd).transpose(1, 2), s[1][:, :, :pos + 1],
                    s[2][:, :, :pos + 1], enable_gqa=True) for s in sets])
            for max_cluster in (8, 16):
                for variant in [v[1:] for v in attention.ATT_SWEEP_VARIANTS if v[0] == hd]:
                    plan = attention.attention_plan(S, hd, max_cluster, variant)
                    got = attention._launch_attention(q, k, v, pos, 0, plan, lib=lib)
                    want = attention.decode_attention_plain(q, k, v, pos, 0, plan)
                    ms = timing.graph_ms([lambda s=s, p=plan: attention._launch_attention(
                        *s, pos, 0, p, lib=lib) for s in sets])
                    _emit({"sweep": "P12", "shape": label, "S": S, "plan": plan.__dict__,
                           "ctas": kv * plan.cluster, "ms": ms, "library_ms": lib_ms,
                           "bound_ms": (2 * (pos + 1) * kv * hd * 2 + 2 * h * hd * 2) / BW * 1e3,
                           "rel_err_vs_plain": _att_err(got, want),
                           "max_active_clusters": attention._launch_attention(
                               q, k, v, pos, 0, plan, max_clusters=True, lib=lib)}, out)
            del sets
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--old", type=Path, help="directory of the earlier attention_probe.cu")
    mode.add_argument("--sweep", nargs="?", const="all", choices=("all", "p2", "p12"),
                      help="time every plan of P2 and P12 (or of one of them)")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("p2_p12_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = timing.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels.build([scales.SOURCE, scales.P2_SOURCE, "attention_probe"])
    if args.sweep:
        rows = ((p2_sweep(gen) if args.sweep != "p12" else [])
                + (p12_sweep(gen) if args.sweep != "p2" else []))
    else:
        lib = build_old(args.old)
        rows = p2_cases(gen) + p12_cases(lib, gen)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows) + card + "\n")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
