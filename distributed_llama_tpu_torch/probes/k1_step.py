"""K1-stacked over one decode token, timed: the 64 per-layer matmuls of
Llama-3.2-1B (16 layers x wqkv, wo, w13, w2) at one row, each a
`cuda_q40.q40_gemv_q80_stacked` call, timed as chip_smoke.py's
q40_gemv_q80_stacked row times them: one CUDA graph of the 64 calls
(probes/timing.graph_ms). The 16 layers' planes take 540 MB, so each call
reads its plane from device memory, not from the 50 MB L2.

It uses nothing but K1's wrapper, `timing.graph_ms`, `timing.card_line`
and `device.resolve_device`, so the same file times an older tree of the
port: copy it into that tree's probes/ and run the two trees in turn on one
card (A, B, B, A) to compare K1 before and after a change.

    python -m distributed_llama_tpu_torch.probes.k1_step [--device cpu] [--layers N] [--repeat N] [--seed N]

prints one JSON line a repeat, {"k1_stacked_ms": per-token ms, ...}. With
`--device cpu` it holds the calls against K1's plain version and times
nothing; without it it needs a CUDA device and raises otherwise.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..device import resolve_device
from ..ops import cuda_q40

LAYERS = 16
# (name, in, out) of Llama-3.2-1B's per-layer matmuls
SHAPES = (("wqkv", 2048, 3072), ("wo", 2048, 2048), ("w13", 2048, 16384), ("w2", 8192, 2048))


def make_step(device, seed: int = 0, layers: int = LAYERS, shapes=SHAPES):
    """Random packed stacks q [layers, in/8, out] int32 (every word a valid
    nibble pattern) and d [layers, in/32, out] f16 in [0.004, 0.02), one
    f32 row x [1, 1, in] a matmul, made on `device` from `seed`. Returns
    {name: (x, q, d)}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    step = {}
    for name, in_f, out_f in shapes:
        q = torch.randint(-2**31, 2**31 - 1, (layers, in_f // 8, out_f), generator=gen,
                          device=device, dtype=torch.int32)
        d = (torch.rand((layers, in_f // 32, out_f), generator=gen, device=device) * 0.016
             + 0.004).to(torch.float16)
        x = torch.randn((1, 1, in_f), generator=gen, device=device)
        step[name] = (x, q, d)
    return step


def step_calls(step) -> list:
    """The token's K1 calls, layer by layer, as zero-argument callables."""
    layers = next(iter(step.values()))[1].shape[0]
    return [lambda x=x, q=q, d=d, li=li: cuda_q40.q40_gemv_q80_stacked(x, q, d, li)
            for li in range(layers) for x, q, d in step.values()]


def main(argv=None) -> list:
    """Time the token's K1 calls `--repeat` times (or check them against
    the plain version on the CPU); print and return one dict a repeat."""
    ap = argparse.ArgumentParser(prog="python -m distributed_llama_tpu_torch.probes.k1_step")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=LAYERS, help="layers (16 in the model)")
    ap.add_argument("--repeat", type=int, default=3, help="timed repeats")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random operands")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    step = make_step(device, args.seed, args.layers)
    calls = step_calls(step)
    if device.type != "cuda":
        err = max((cuda_q40.q40_gemv_q80_stacked(x, q, d, li)
                   - cuda_q40.q40_gemv_q80_plain(x, q[li], d[li])).abs().max().item()
                  for li in range(args.layers) for x, q, d in step.values())
        row = {"calls": len(calls), "max_abs_err": err, "k1_stacked_ms": "not measured"}
        print(json.dumps(row), flush=True)
        return [row]
    from . import timing

    card = timing.card_line()
    rows = []
    for i in range(args.repeat):
        ms = timing.graph_ms(calls) * len(calls)
        rows.append({"repeat": i, "calls": len(calls), "k1_stacked_ms": ms, "card": card})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
