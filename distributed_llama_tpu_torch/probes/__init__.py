"""The kernel probes of the JAX package's `scripts/` on the card.

`int4` (scripts/probe_int4.py) A/Bs the int8 decode matmul over unpacked
weights (B9, ops/cuda_q40.py) against the same function from 4-bit storage
(P3) and from int32 nibble words (P4) as one-row GEMVs; `dma` (scripts/probe_dma.py, P14)
measures how fast the card streams a packed weight plane; `attention`
(scripts/probe_att_floor.py, probe_grouped_decode_att.py and
probe_flash_headmajor.py: P11, P12, P8) measures the decode-attention floor
on a head-major cache; `int4_prod` (scripts/probe_int4_prod.py, P7) splits
K1's call into its prologue and its body; `scales` (scripts/probe_f16_scales.py
and sweep_i8_tiles.py: P1, P2, P13) measures what B9's scale plane costs as
f16, f32 or raw f16 bits and sweeps its CTA tile, and `i4_tiles`
(scripts/sweep_i4_tiles.py, P6) sweeps P4's tile; `int4b`
(scripts/probe_int4b.py, P5) and `int4c` (scripts/probe_int4c.py, P9, P10)
feed the same matmul from the two unsigned-nibble codecs, split-half bytes
and the T layout's feature-split words, beside B9 and K1; `gemv` holds the
one-row GEMV's plans and launches (P3, P4, P5, P6, P9/P10). `timing` times a
kernel cold (operands out of L2) and hot; `operands` carries the JAX
probes' operands across, for the tests. The `*_ab` modules time a
redesigned kernel against an earlier build in one process and sweep its
plans (`p5_p9_ab` for P5 and P9/P10, `p4_p11_ab` for P4 and P11). Run a probe with

    python -m distributed_llama_tpu_torch.probes.int4 [--device cpu] [--shape IN,OUT]
    python -m distributed_llama_tpu_torch.probes.dma [--device cpu] [--shape IN,OUT]
    python -m distributed_llama_tpu_torch.probes.attention [--device cpu] [--seq S ...]
    python -m distributed_llama_tpu_torch.probes.int4_prod [--device cpu] [--shape IN,OUT]
    python -m distributed_llama_tpu_torch.probes.scales [--device cpu] [--1b | --8b] [--quick]
    python -m distributed_llama_tpu_torch.probes.i4_tiles [--device cpu] [--shape IN,OUT]
    python -m distributed_llama_tpu_torch.probes.int4b [--device cpu] [--shape IN,OUT]
    python -m distributed_llama_tpu_torch.probes.int4c [--device cpu] [--shape IN,OUT]

Without `--device cpu` a probe needs a CUDA device and raises otherwise.
"""


def parse_shape(text: str) -> tuple[str, int, int]:
    """A `--shape IN,OUT` argument -> (label, in_features, out_features)."""
    i, o = (int(v) for v in text.split(","))
    return (f"{i}->{o}", i, o)
