"""P7: the first K1 design's GEMV body alone, its Q80 prologue alone, and
the production call (the counterpart of the JAX package's
scripts/probe_int4_prod.py).

The first K1 design was two dependent kernels a call: the prologue
quantized the activation rows to Q80 (x8 int8, f16-rounded block scales
xs, int32 block sums bs), then the GEMV took the integer dot with the
packed Q40 weight. K1 (`ops/cuda_q40.py:q40_gemv_q80`, csrc/q40_gemv.cu) now
fuses both into one launch; the two kernels stay as P7's. The JAX probe
times its body `_kernel_fs_i8` alone on pre-quantized operands
(`fs_call_tiles`, :49). Here:

  * `fs_call_tiles(x8, xs, bs, q, d, cols, ksplit)`: the first K1's GEMV
    kernel alone (csrc/q40_gemv.cu q40_gemv_body) at CTA tile (cols output
    columns, ksplit warps splitting the contraction), one of
    `cuda_q40.GEMV_TILES`. Its tile (32, 8) (`FIRST_K1_TILE`) takes 1..8
    rows, and with the prologue is that K1's call bit for bit; the other
    tiles sum the f32 block partials in another order and take 1 or 8 rows
    (`cuda_q40.BODY_ROWS`);
  * `q80_prologue(x)`: the first K1's prologue kernel alone
    (q40_quantize_q80).

Each wrapper takes its plain version for CPU tensors, launches its kernel
for CUDA tensors or raises, and counts its launches in `launches`.

    python -m distributed_llama_tpu_torch.probes.int4_prod [--device cpu] [--shape IN,OUT ...] [--seed N]

prints, at the five Llama-3.2-1B shapes, the JAX probe's four numbers per
shape: (a) the body alone at the first K1's tile, (b) the production call
(K1, one launch), (c) the prologue alone, and comp = b - a - c (negative
where the fused call costs less than the two kernels apart), each cold and
hot (probes/timing.py); then the body at every tile. Without `--device cpu` it
needs a CUDA device and raises otherwise.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..device import resolve_device
from ..formats.quants import Q_BLOCK
from ..ops import cuda_q40
from ..ops.cuda_q40 import BODY_ROWS, FIRST_K1_TILE, GEMV_TILES, MAX_I8_ROWS
from ..ops.quant import unpack_q
from . import parse_shape
from .int4 import dequantized_bf16

# the JAX probe's five shapes (Llama-3.2-1B layer shapes, wcls cut to 32768)
SHAPES = (
    ("wqkv 2048->3072", 2048, 3072),
    ("wo 2048->2048", 2048, 2048),
    ("w13 2048->16384", 2048, 16384),
    ("w2 8192->2048", 8192, 2048),
    ("wcls 2048->32768", 2048, 32768),
)


def _check(x8, xs, bs, q, d, cols: int, ksplit: int) -> None:
    """The body's operands: x8 [R, nb*32] int8 (1 <= R <= 8), xs [R, nb]
    f32, bs [R, nb] int32, q [nb*4, out] int32, d [nb, out] f16, one
    device, contiguous; a tile of GEMV_TILES, and R in BODY_ROWS unless
    the tile is the first K1's."""
    if (cols, ksplit) not in GEMV_TILES:
        raise ValueError(f"tile ({cols}, {ksplit}) is not one of {GEMV_TILES}")
    if q.ndim != 2 or q.dtype != torch.int32 or q.shape[0] % 4:
        raise ValueError(f"q must be [nb*4, out] int32, got {q.dtype} {tuple(q.shape)}")
    nb, out_f = q.shape[0] // 4, q.shape[1]
    if d.dtype != torch.float16 or tuple(d.shape) != (nb, out_f):
        raise ValueError(f"d must be [{nb}, {out_f}] float16, got {d.dtype} {tuple(d.shape)}")
    if x8.ndim != 2 or x8.dtype != torch.int8 or x8.shape[1] != nb * Q_BLOCK:
        raise ValueError(f"x8 must be [R, {nb * Q_BLOCK}] int8, got {x8.dtype} {tuple(x8.shape)}")
    R = x8.shape[0]
    if not 1 <= R <= MAX_I8_ROWS:
        raise ValueError(f"the body takes 1..{MAX_I8_ROWS} rows, got {R}")
    if (cols, ksplit) != FIRST_K1_TILE and R not in BODY_ROWS:
        raise ValueError(f"tile ({cols}, {ksplit}) is built at {BODY_ROWS} rows, got {R}")
    for name, t, dt in (("xs", xs, torch.float32), ("bs", bs, torch.int32)):
        if t.dtype != dt or tuple(t.shape) != (R, nb):
            raise ValueError(f"{name} must be [{R}, {nb}] {dt}, got {t.dtype} {tuple(t.shape)}")
    for name, t in (("x8", x8), ("xs", xs), ("bs", bs), ("q", q), ("d", d)):
        if t.device != x8.device:
            raise ValueError(f"{name} is on {t.device}, x8 on {x8.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fs_call_tiles_plain(x8, xs, bs, q, d, cols: int, ksplit: int) -> torch.Tensor:
    """P7's plain version: K1's math on quantized rows, which the tile does
    not change (only the order of the f32 block sums) -> [R, out] f32."""
    _check(x8, xs, bs, q, d, cols, ksplit)
    return cuda_q40.q80_gemv_plain(x8, xs, bs, q, d)


def fs_call_tiles(x8, xs, bs, q, d, cols: int, ksplit: int) -> torch.Tensor:
    """P7: the first K1's GEMV body on pre-quantized rows at CTA tile (cols, ksplit):
    x8 [R <= 8, in] int8, xs [R, nb] f32, bs [R, nb] int32, q [nb*4, out]
    int32, d [nb, out] f16 -> [R, out] f32."""
    _check(x8, xs, bs, q, d, cols, ksplit)
    if x8.device.type == "cpu":
        return cuda_q40.q80_gemv_plain(x8, xs, bs, q, d)
    if x8.device.type != "cuda":
        raise ValueError(f"unsupported device {x8.device}")
    out = cuda_q40.launch_gemv_body(x8, xs, bs, q, d, cols, ksplit)
    fs_call_tiles.launches += 1
    return out


fs_call_tiles.launches = 0


def q80_prologue_plain(x: torch.Tensor):
    """The prologue's plain version: x [R, in] -> (x8 [R, in] int8, xs
    [R, nb] f32, bs [R, nb] int32)."""
    R, in_f = x.shape
    x8, xs, bs = cuda_q40.quantize_rows_q80(x, in_f // Q_BLOCK)
    return x8.to(torch.int8).reshape(R, in_f), xs, bs.to(torch.int32)


def q80_prologue(x: torch.Tensor):
    """The first K1's Q80 prologue alone: x [R, in] f32 or bf16, in % 32 == 0 ->
    (x8 [R, in] int8, xs [R, nb] f32, bs [R, nb] int32)."""
    if x.ndim != 2 or x.shape[1] % Q_BLOCK or x.shape[1] == 0 or x.shape[0] == 0:
        raise ValueError(f"x must be [R, nb*32], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cpu":
        return q80_prologue_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = cuda_q40.launch_q80_prologue(x)
    q80_prologue.launches += 1
    return out


q80_prologue.launches = 0

KERNELS = (fs_call_tiles, q80_prologue)

# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------


def make_operands(in_f: int, out_f: int, device, seed: int = 0, rows: int = 1):
    """Random operands made on `device` from `seed`, as the JAX probe makes
    them: a packed plane q [in/8, out] int32 (every word a valid nibble
    pattern), d [in/32, out] f16 in [0.001, 0.021), and the bf16 rows x
    [rows, in]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randint(-2**31, 2**31 - 1, (in_f // 8, out_f), generator=gen, device=device,
                      dtype=torch.int32)
    d = (torch.rand((in_f // Q_BLOCK, out_f), generator=gen, device=device) * 0.02
         + 0.001).to(torch.float16)
    x = torch.randn((rows, in_f), generator=gen, device=device).to(torch.bfloat16)
    return x, q, d


def work(R: int, in_f: int, out_f: int) -> dict:
    """Bytes each call reads and writes once: the body (packed weight, f16
    scales, int8 rows, f32 scales, int32 sums, f32 out), the prologue (bf16
    rows in, its three outputs) and the production call (bf16 rows, weight,
    scales, out)."""
    nb = in_f // Q_BLOCK
    weight = in_f * out_f // 2 + nb * out_f * 2
    q80 = R * in_f + R * nb * 8
    return {"body": weight + q80 + R * out_f * 4, "prologue": R * in_f * 2 + q80,
            "call": R * in_f * 2 + weight + R * out_f * 4, "ops": 2 * R * in_f * out_f}


def run_shape(label: str, in_f: int, out_f: int, device, seed: int = 0, timed: bool = True,
              prologue_ms: dict | None = None):
    """One shape at one bf16 activation row: the body at every tile against
    its plain version, K1's call against its blocked plain version
    (`k1_vs_blocked`: 0 on the card, where the two sum in one order), and,
    timed on the card, (a), (b), (c) and comp cold and hot, every tile's
    cold ms, the plain version's ms and the library call's (torch.matmul of
    the bf16 row against the bf16-dequantized plane). (c) depends on the
    row's width alone: `prologue_ms` {in: (cold, hot)} keeps it from one
    shape to the next (its cold ring of a 6.6 KB operand set holds 30,000
    launches). Returns one dict."""
    x, q, d = make_operands(in_f, out_f, device, seed)
    x8, xs, bs = q80_prologue(x)
    k1 = cuda_q40.q40_gemv_q80(x, q, d)
    blocked = cuda_q40.q40_gemv_q80_blocked(x, q, d, cuda_q40.gemv_plan(in_f // Q_BLOCK, out_f))
    want = fs_call_tiles_plain(x8, xs, bs, q, d, *FIRST_K1_TILE)
    scale = want.abs().max().item()
    nbytes = work(1, in_f, out_f)
    row = {"shape": label, "in": in_f, "out": out_f, "out_scale": scale, **nbytes, "tiles": [],
           "k1_vs_blocked": (k1 - blocked).abs().max().item()}
    for cols, ksplit in GEMV_TILES:
        got = fs_call_tiles(x8, xs, bs, q, d, cols, ksplit)
        t = {"cols": cols, "ksplit": ksplit, "max_abs_err": (got - want).abs().max().item(),
             "ctas": -(-out_f // cols)}
        if timed:
            from . import timing

            t["cold_ms"] = timing.cold_ms(
                lambda *a, c=cols, k=ksplit: fs_call_tiles(*a, c, k), (x8, xs, bs, q, d),
                nbytes["body"])
        row["tiles"].append(t)
    row["max_abs_err"] = max(t["max_abs_err"] for t in row["tiles"])
    if timed:
        from . import timing

        row["a_cold_ms"] = next(t["cold_ms"] for t in row["tiles"]
                                if (t["cols"], t["ksplit"]) == FIRST_K1_TILE)
        row["a_hot_ms"] = timing.hot_ms(lambda *a: fs_call_tiles(*a, *FIRST_K1_TILE),
                                        (x8, xs, bs, q, d), nbytes["body"])
        row["b_cold_ms"], row["b_hot_ms"] = timing.cold_hot_ms(cuda_q40.q40_gemv_q80, (x, q, d),
                                                               nbytes["call"])
        prologue_ms = {} if prologue_ms is None else prologue_ms
        if in_f not in prologue_ms:
            prologue_ms[in_f] = timing.cold_hot_ms(q80_prologue, (x,), nbytes["prologue"])
        row["c_cold_ms"], row["c_hot_ms"] = prologue_ms[in_f]
        for kind in ("cold", "hot"):
            row[f"comp_{kind}_ms"] = (row[f"b_{kind}_ms"] - row[f"a_{kind}_ms"]
                                      - row[f"c_{kind}_ms"])
        row["plain_ms"] = timing.graph_ms(
            [lambda: fs_call_tiles_plain(x8, xs, bs, q, d, *FIRST_K1_TILE)], replays=5)
        row["prologue_plain_ms"] = timing.graph_ms([lambda: q80_prologue_plain(x)], replays=5)
        w_bf16 = dequantized_bf16(unpack_q(q), d)
        row["library_cold_ms"], row["library_hot_ms"] = timing.cold_hot_ms(
            torch.matmul, (x, w_bf16), w_bf16.numel() * 2)
        best = min(row["tiles"], key=lambda t: t["cold_ms"])
        row["best_tile"] = (best["cols"], best["ksplit"])
        del w_bf16
    return row


def main(argv=None) -> list:
    """Run the probe over its shapes (or the `--shape`s given); print each
    shape's (a), (b), (c), comp and tile sweep, and return the rows."""
    ap = argparse.ArgumentParser(prog="python -m distributed_llama_tpu_torch.probes.int4_prod")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--shape", action="append", type=parse_shape, help="IN,OUT (repeatable)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random operands")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    timed = device.type == "cuda"
    if timed:
        from . import timing

        print(f"card: {timing.card_line()}", flush=True)
    else:
        print("(CPU: the plain versions, correctness only; times not measured)", flush=True)
    rows = []
    prologue_ms = {}
    for label, in_f, out_f in args.shape or SHAPES:
        r = run_shape(label, in_f, out_f, device, seed=args.seed, timed=timed,
                      prologue_ms=prologue_ms)
        print(f"== {label} (body bytes {r['body'] / 1e6:.2f} MB): max err over "
              f"{len(r['tiles'])} tiles {r['max_abs_err']:.3e}, K1 against its blocked order: "
              f"{r['k1_vs_blocked']:.3e}", flush=True)
        if timed:
            for kind in ("cold", "hot"):
                print(f"  {kind}: (a) body {r[f'a_{kind}_ms'] * 1e3:.2f} us | (b) K1 call "
                      f"{r[f'b_{kind}_ms'] * 1e3:.2f} us | (c) prologue "
                      f"{r[f'c_{kind}_ms'] * 1e3:.2f} us | comp "
                      f"{r[f'comp_{kind}_ms'] * 1e3:+.2f} us", flush=True)
            print("  body cold us by tile (cols x ksplit): " + ", ".join(
                f"{t['cols']}x{t['ksplit']} {t['cold_ms'] * 1e3:.2f}" for t in r["tiles"]),
                flush=True)
            print(f"  library torch.matmul bf16: cold {r['library_cold_ms'] * 1e3:.2f} us, "
                  f"hot {r['library_hot_ms'] * 1e3:.2f} us", flush=True)
        rows.append(r)
    print(json.dumps({"probe": "int4_prod", "device": str(device), "rows": len(rows)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
