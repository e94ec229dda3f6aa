"""P5 (the int8 decode matmul from split-half nibble bytes) and P9/P10 (the
same from the T layout's feature-split words, two views of one instance)
against their earlier design, and the sweep that chooses their default
plans, in one process on one card.

    python -m distributed_llama_tpu_torch.probes.p5_p9_ab --old DIR [--out FILE]
    python -m distributed_llama_tpu_torch.probes.p5_p9_ab --sweep [--out FILE]

`--old`: DIR holds an earlier `i4_codec_probe.cu` and `q40_i8_mma.cuh` in
which P5 and P9/P10 ran the int8-MMA template (a CTA of 4 warps on 32, 64
or 128 columns, each block staged in shared memory, split-K summed by a
second kernel), for example from `git show
<commit>:distributed_llama_tpu_torch/csrc/<file>`. They are compiled here
with the port's nvcc flags and `-I DIR` into build/kernels/, so the old
source takes the old header, and called through its own C signature
(`q40_u4_mma`). The new arm is the current build (csrc/i4_codec_probe.cu,
the one-row GEMV of csrc/i8_gemv.cuh). Cases (`cases`): the JAX probes'
five Llama-3.2-1B shapes (probes/int4b.py SHAPES) at 1 and 8 rows, each
plane (f16, and its raw bits as the JAX probes' `_dt_operand` gives
them), P5 in both storages and P9 and P10 in both views. For each shape,
row count, plane and codec the old arm is timed at every old tile (32, 64
or 128 columns by the blocks a CTA that divide nb) and the new at every
tile of its `tiles_for`, each to find its best; then every case is timed
old (best tile), new (default plan), new (best tile), new (best tile), new
(default plan), old: CUDA events over CUDA-graph replays
(probes/timing.graph_ms), cold, a case's calls walking copies of their
operands that together take at least timing.RING_BYTES (4x the L2), and
hot, every call on one copy. Beside them: the bound (bytes moved over the
card's memory rate: weights, scales, rows, row scales, block sums read
once, the output written once), one PyTorch call's time (`torch.matmul` of
the bf16 rows against the bf16-dequantized weight), the plain version's
time, the launches a call and the checks: the new output at the default
plan and at the best tile equal to its plain order bit for bit, each of 8
rows equal to its one-row call, at P3's plan equal to P3's int8 arm, and
the new output against the old one relative to the output's largest value.

`--sweep`: compiles csrc/i4_codec_probe.cu with -DDLT_U4_SWEEP and
-DDLT_GEMV_ROWS_1_8 (every (columns a lane, warps along k) pair of
SWEEP_PAIRS at 1 and 8 rows, the raw-bits plane) and times every plan
(each pair by 1, 2, 4 or 8 splits) at the five shapes, 1 and 8 rows, each
codec, each held to its plain order bit for bit: how `gemv.u4_gemv_plan`'s
constants were chosen.

Prints one JSON line a case and the card's `nvidia-smi` name and power
limit; `--out` also writes them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from ..formats.quants import Q_BLOCK
from ..ops import cuda_q40, kernels
from ..ops.cuda_q40 import GemvPlan, _gemv_order
from . import gemv, int4, int4b, int4c, timing
from .k1_ab import _compile, _open
from .scales import SWEEP_BLOCKS, plane_f32

BW = 3.35e12  # H100 SXM data sheet: bytes/s
ROWS = (1, 8)
PLANES = ("f16", "i16")
CODECS = {"P5": gemv.W_SH, "P9": gemv.W_FS}
# the arms of a codec: (probe, variant); the variants of one codec are one
# instance on the card
ARMS = {"P5": (("P5", "i8ops"), ("P5", "i32st")), "P9": (("P9", "fs2d"), ("P10", "fs"))}
OLD_SOURCES = ("i4_codec_probe.cu", "q40_i8_mma.cuh")
OLD_COLS = (32, 64, 128)  # the int8-MMA template's TN
P, I = ctypes.c_void_p, ctypes.c_int
OLD_SIG = {
    # x8, xs, bs, w, weights, dt, scale_kind, out, part, rows, nb, out, cols,
    # blocks_per_cta, stream
    "q40_u4_mma": (P, P, P, P, I, P, I, P, P, I, I, I, I, I, P),
}
SWEEP_PAIRS = {gemv.W_FS: tuple((v, kw) for v in (4, 8, 16) for kw in (2, 4, 8)),
               gemv.W_SH: tuple((v, kw) for v in (4, 8) for kw in (2, 4, 8))}


def cases() -> list:
    """The A/B's cases: each shape, row count, plane and arm, as dicts."""
    return [{"shape": label, "in": in_f, "out": out_f, "rows": rows, "plane": plane,
             "codec": codec, "probe": probe, "variant": variant}
            for label, in_f, out_f in int4b.SHAPES for rows in ROWS for plane in PLANES
            for codec, arms in ARMS.items() for probe, variant in arms]


def old_sources(src_dir: Path) -> dict:
    """The earlier sources in `src_dir`: {file name: path}; raises if one
    is missing."""
    src_dir = Path(src_dir)
    missing = [f for f in OLD_SOURCES if not (src_dir / f).is_file()]
    if missing:
        raise FileNotFoundError(f"{src_dir} lacks the earlier {', '.join(missing)}")
    return {f: src_dir / f for f in OLD_SOURCES}


def build_old(src_dir: Path) -> ctypes.CDLL:
    """Compile the earlier i4_codec_probe.cu against the header beside it."""
    src = old_sources(src_dir)["i4_codec_probe.cu"]
    out = kernels.BUILD_DIR / "libold_i4_codec_probe.so"
    return _open(_compile(src, out, include=Path(src_dir)), out, OLD_SIG,
                 "the earlier i4_codec_probe.cu")


def old_call(lib, x8, xs, bs, w, weights: int, dt, cols: int, blocks: int) -> torch.Tensor:
    """The earlier design: the int8-MMA template's codec instance at a
    (cols, blocks_per_cta) tile, its splits summed by a second kernel ->
    [R, out] f32 in natural column order."""
    R, nb, out_f = x8.shape[0], xs.shape[1], dt.shape[1]
    splits = nb // blocks
    out = torch.empty((R, out_f), dtype=torch.float32, device=x8.device)
    part = torch.empty((splits, R, out_f) if splits > 1 else (1,), dtype=torch.float32,
                       device=x8.device)
    kernels.check(lib, lib.q40_u4_mma(
        x8.data_ptr(), xs.data_ptr(), bs.data_ptr(), w.data_ptr(), weights, dt.data_ptr(),
        gemv.U4_SCALE_KINDS[dt.dtype], out.data_ptr(), part.data_ptr(), R, nb, out_f, cols,
        blocks, torch.cuda.current_stream().cuda_stream), "old q40_u4_mma")
    return out


def old_tiles(nb: int, out_f: int, weights: int) -> list:
    """The earlier probes' tiles: 32, 64 or 128 columns by the blocks a CTA
    of SWEEP_BLOCKS that divide nb (P5: where cols / 2 divides out / 2)."""
    return [(c, k) for c in OLD_COLS for k in SWEEP_BLOCKS if k <= nb and nb % k == 0
            and (weights == gemv.W_FS or (out_f // 2) % (c // 2) == 0)]


def operand_ring(in_f: int, out_f: int, rows: int, seed: int):
    """Copies of the codecs' operands at in -> out that together reach the
    ring: [{x8, xs, bs, fs (the words [nb, 4, out]), sh (the split-half
    bytes), f16, i16}], the first copy's unpacked weight qt, and the
    library call's operands [(bf16 rows, bf16-dequantized weight)]."""
    nb = in_f // Q_BLOCK
    nbytes = int4b.work(rows, in_f, out_f)["bytes"]
    sets, lib, qt0 = [], [], None
    for i in range(timing.ring_size(nbytes)):
        x8, xs, qt, dt16, x = int4.make_operands(in_f, out_f, rows, "cuda", seed=seed + i)
        sets.append({"x8": x8, "xs": xs, "bs": int4b.block_sums(x8, nb),
                     "fs": int4c.pack_feature_split(qt), "sh": int4b.pack_split_half(qt),
                     "f16": dt16, "i16": dt16.view(torch.int16)})
        if i == 0:
            qt0 = qt
        if len(lib) * in_f * out_f * 2 < timing.RING_BYTES:
            lib.append((x.to(torch.bfloat16), int4.dequantized_bf16(qt, dt16)))
        del qt
    return sets, qt0, lib


def arm_call(probe: str, variant: str, s: dict, plane: str, cols: int, blocks: int):
    """One call of a new arm on operand set `s`."""
    nb, out_f = s["xs"].shape[1], s["f16"].shape[1]
    d = s[plane]
    if probe == "P5":
        q = int4b.storage_view(s["sh"], variant)
        return int4b.sh_call(s["x8"], s["xs"], s["bs"], q, d.reshape(nb, 2, out_f // 2), cols,
                             blocks, variant)
    if probe == "P9":
        return int4c.fs2d_call(s["x8"], s["xs"], s["bs"], s["fs"].view(nb * 4, out_f), d, cols,
                               blocks)
    return int4c.fs_call(s["x8"], s["xs"], s["bs"], s["fs"], d, cols, blocks)


def arm_plain(probe: str, variant: str, s: dict, plane: str, cols: int, blocks: int):
    nb, out_f = s["xs"].shape[1], s["f16"].shape[1]
    d = s[plane]
    if probe == "P5":
        q = int4b.storage_view(s["sh"], variant)
        return int4b.sh_call_plain(s["x8"], s["xs"], s["bs"], q, d.reshape(nb, 2, out_f // 2),
                                   cols, blocks, variant)
    return int4c.fs_call_plain(s["x8"], s["xs"], s["bs"], s["fs"], d, cols, blocks)


def _old_arm(lib, codec: str, s: dict, plane: str, tile):
    weights = CODECS[codec]
    w = s["sh"] if weights == gemv.W_SH else s["fs"]
    return old_call(lib, s["x8"], s["xs"], s["bs"], w, weights, s[plane], *tile)


def _ms(calls, replays: int = 20) -> float:
    return timing.graph_ms(calls, replays=replays)


def _rel(got, want) -> float:
    return ((got.reshape(want.shape) - want).abs().max() / want.abs().max()).item()


def _emit(row: dict, rows: list) -> None:
    print(json.dumps(row), flush=True)
    rows.append(row)


def ab_cases(old_lib) -> list:
    out = []
    for label, in_f, out_f in int4b.SHAPES:
        nb = in_f // Q_BLOCK
        for rows in ROWS:
            sets, qt, lib_in = operand_ring(in_f, out_f, rows, seed=15 + rows)
            s0 = sets[0]
            lib_ms = _ms([lambda x=x, w=w: torch.matmul(x, w) for x, w in lib_in])
            lib_hot = _ms([lambda: torch.matmul(*lib_in[0])] * len(lib_in))
            del lib_in
            p3 = int4.i4_call_int8(s0["x8"], s0["xs"], int4.pack_s4(qt), s0["f16"])
            del qt
            nbytes = int4b.work(rows, in_f, out_f)["bytes"]
            for plane in PLANES:
                for codec, arms in ARMS.items():
                    weights = CODECS[codec]
                    plan = gemv.u4_gemv_plan(nb, out_f, weights)
                    default = (plan.cols, plan.blocks_per_split)
                    new_tiles, left_out = gemv.u4_tiles_for(nb, out_f, weights)
                    olds = old_tiles(nb, out_f, weights)
                    old_t = {t: _ms([lambda s=s, t=t: _old_arm(old_lib, codec, s, plane, t)
                                     for s in sets], replays=5) for t in olds}
                    new_t = {t: _ms([lambda s=s, t=t: arm_call(*arms[0], s, plane, *t)
                                     for s in sets], replays=5) for t in new_tiles}
                    ot, nt = min(old_t, key=old_t.get), min(new_t, key=new_t.get)
                    old1 = _old_arm(old_lib, codec, s0, plane, ot)
                    p3_tile = gemv.u4_p3_tile(nb, out_f, weights)
                    for probe, variant in arms:
                        fn = {"P5": int4b.sh_call, "P9": int4c.fs2d_call,
                              "P10": int4c.fs_call}[probe]

                        def calls(tile, ops=sets):
                            return [lambda s=s: arm_call(probe, variant, s, plane, *tile)
                                    for s in ops]

                        olds_c = [lambda s=s: _old_arm(old_lib, codec, s, plane, ot)
                                  for s in sets]
                        t = [_ms(c) for c in (olds_c, calls(default), calls(nt), calls(nt),
                                              calls(default), olds_c)]
                        before = fn.launches
                        got = arm_call(probe, variant, s0, plane, *default)
                        launches = fn.launches - before
                        best = arm_call(probe, variant, s0, plane, *nt)
                        row = {
                            "case": f"{probe} {variant} {label.strip()}, {rows} rows, {plane}",
                            "shape": label, "rows": rows, "plane": plane, "probe": probe,
                            "variant": variant, "old_ms": (t[0] + t[5]) / 2,
                            "new_ms": (t[1] + t[4]) / 2, "new_best_ms": (t[2] + t[3]) / 2,
                            "turns_ms": t,
                            "old_hot_ms": _ms([olds_c[0]] * len(sets)),
                            "new_hot_ms": _ms(calls(default, [s0] * len(sets))),
                            "bound_ms": nbytes / BW * 1e3, "bound_by": "bytes",
                            "library_ms": lib_ms, "library_hot_ms": lib_hot,
                            "plain_ms": _ms([lambda: arm_plain(probe, variant, s0, plane,
                                                               *default)], replays=3),
                            "default_plan": plan.__dict__, "default_ctas": plan.ctas(out_f),
                            "new_best_tile": nt, "old_best_tile": ot,
                            "old_ctas": -(-out_f // ot[0]) * (nb // ot[1]),
                            "left_out": left_out,
                            "new_equals_plain": torch.equal(
                                got, arm_plain(probe, variant, s0, plane, *default)),
                            "new_best_equals_plain": torch.equal(
                                best, arm_plain(probe, variant, s0, plane, *nt)),
                            "equals_p3_at_its_plan": p3_tile in new_tiles and torch.equal(
                                arm_call(probe, variant, s0, plane, *p3_tile).reshape(
                                    p3.shape), p3),
                            "new_vs_old_rel": _rel(got, old1),
                            "launches_a_call": launches,
                            "old_launches_a_call": 1 if nb // ot[1] == 1 else 2,
                            "old_tiles_ms": {f"{c}x{k}": v for (c, k), v in old_t.items()},
                            "new_tiles_ms": {f"{c}x{k}": v for (c, k), v in new_t.items()},
                        }
                        row["speedup"] = row["old_ms"] / row["new_ms"]
                        if rows > 1:
                            singles = torch.cat([
                                arm_call(probe, variant, {**s0, "x8": s0["x8"][r:r + 1],
                                                          "xs": s0["xs"][r:r + 1],
                                                          "bs": s0["bs"][r:r + 1]},
                                         plane, *default).reshape(1, out_f)
                                for r in range(rows)])
                            row["rows_equal_one_row_calls"] = torch.equal(
                                singles, got.reshape(rows, out_f))
                        _emit(row, out)
            del sets, p3
            torch.cuda.empty_cache()
    return out


def sweep_lib() -> ctypes.CDLL:
    """csrc/i4_codec_probe.cu built with -DDLT_U4_SWEEP and -DDLT_GEMV_ROWS_1_8."""
    out_path = kernels.BUILD_DIR / "libi4_codec_sweep.so"
    return _open(_compile(kernels.CSRC / f"{gemv.U4_SOURCE}.cu", out_path,
                          ("-DDLT_U4_SWEEP", "-DDLT_GEMV_ROWS_1_8")),
                 out_path, gemv._U4_SIG, f"{gemv.U4_SOURCE}.cu -DDLT_U4_SWEEP")


def sweep_plans(nb: int, out_f: int, weights: int) -> list:
    """Every plan of SWEEP_PAIRS[weights] by 1, 2, 4 and 8 splits at (nb,
    out): none with an empty split or past MAX_BPS; for W_SH only those
    whose CTA's bytes divide out / 2."""
    runs = gemv.U4_RUNS[weights]
    row_w = out_f // runs
    plans = []
    for vec, kw in SWEEP_PAIRS[weights]:
        bt = 32 * vec * (gemv.WARPS // kw)
        if row_w % vec or (runs == 2 and row_w % bt):
            continue
        for splits in (1, 2, 4, 8):
            bps = -(-nb // splits)
            if (splits - 1) * bps >= nb or bps > gemv.MAX_BPS:
                continue
            plans.append(GemvPlan(vec, runs * bt, kw, splits, bps))
    return plans


def sweep(lib) -> list:
    out = []
    for label, in_f, out_f in int4b.SHAPES:
        nb = in_f // Q_BLOCK
        for rows in ROWS:
            sets, qt, _ = operand_ring(in_f, out_f, rows, seed=rows)
            s0 = sets[0]
            terms = gemv.block_terms(s0["x8"], s0["xs"], qt, plane_f32(s0["i16"]))
            del qt
            nbytes = int4b.work(rows, in_f, out_f)["bytes"]
            for codec, weights in CODECS.items():
                key = "sh" if weights == gemv.W_SH else "fs"
                default = gemv.u4_gemv_plan(nb, out_f, weights)
                for plan in sweep_plans(nb, out_f, weights):
                    got = gemv.launch_u4_gemv(s0["x8"], s0["xs"], s0["bs"], s0[key], weights,
                                              s0["i16"], plan, lib)
                    ms = _ms([lambda s=s, p=plan: gemv.launch_u4_gemv(
                        s["x8"], s["xs"], s["bs"], s[key], weights, s["i16"], p, lib)
                        for s in sets], replays=10)
                    _emit({"sweep": codec, "shape": label, "rows": rows, "plan": plan.__dict__,
                           "ctas": plan.ctas(out_f), "ms": ms, "bound_ms": nbytes / BW * 1e3,
                           "default": plan.kw == default.kw and plan.vec == default.vec
                           and plan.splits == default.splits,
                           "equals_plain": torch.equal(got.reshape(rows, out_f),
                                                       _gemv_order(terms, plan))}, out)
            del sets, terms
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--old", type=Path, help="directory of the earlier codec sources")
    mode.add_argument("--sweep", action="store_true", help="time every codec plan")
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if args.old is not None:
        old_sources(args.old)
    if not torch.cuda.is_available():
        print("p5_p9_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = timing.card_line()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}", flush=True)
    if args.sweep:
        rows = sweep(sweep_lib())
    else:
        old_lib = build_old(args.old)
        kernels.build([gemv.U4_SOURCE, gemv.SOURCE])
        rows = ab_cases(old_lib)
        keys = ("shape", "rows", "plane", "probe", "variant")
        assert [[r[k] for k in keys] for r in rows] == [[c[k] for k in keys] for c in cases()]
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows) + card + "\n")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
