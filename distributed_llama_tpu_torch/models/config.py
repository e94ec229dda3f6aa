"""Static model configuration.

Derived from the `.m` header (formats/mfile.py, reference: src/llm.hpp:45-77).
The JAX package's `ModelConfig` is a frozen jit argument; here it is a frozen
dataclass that carries torch dtypes. The JAX fields that select Pallas modes
(`use_pallas`, `pallas_interpret`) have no counterpart: a kernel wrapper
launches its CUDA kernel for a tensor on the card and takes its plain
version for a tensor on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..formats.mfile import ArchType, ModelHeader

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_KV_DTYPES = {**_DTYPES, "int8": torch.int8}


@dataclass(frozen=True)
class ModelConfig:
    arch_type: int
    dim: int
    hidden_dim: int  # dense FFN width, or per-expert width for MoE
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int
    seq_len: int
    n_experts: int
    n_active_experts: int
    hidden_act: int
    rope_type: int
    norm_epsilon: float
    # compute_dtype: operand dtype of the matmuls and of flash attention.
    # "bfloat16" runs the CUDA kernels; "float32" is the parity path.
    compute_dtype: str = "bfloat16"
    # cache_dtype: KV cache storage dtype; "int8" stores the payload in int8
    # with an f32 scale per (token, kv head) (ops/kv_quant.py).
    cache_dtype: str = "bfloat16"
    # q80_activations: the parity mode emulating the reference's
    # `--buffer-float-type q80` numerics (the JAX package's field): every
    # Q40 matmul's input is round-tripped through Q80 (ops/quant.py
    # `quantize_q80_activations`; the reference casts activations into q80
    # buffers before each Q40 matmul, src/llm.cpp:221-255). Off in
    # production; the engine's `q80_activations=` sets it.
    q80_activations: bool = False

    @property
    def q_dim(self) -> int:
        return self.head_dim * self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.head_dim * self.n_kv_heads

    @property
    def is_qwen3(self) -> bool:
        return self.arch_type in (ArchType.QWEN3, ArchType.QWEN3_MOE)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def kv_dtype(self) -> torch.dtype:
        return _KV_DTYPES[self.cache_dtype]

    @property
    def kv_quantized(self) -> bool:
        """The cache stores int8 with f32 scale sidecars."""
        return self.cache_dtype == "int8"


def config_from_header(
    h: ModelHeader, compute_dtype: str = "bfloat16", cache_dtype: str | None = None
) -> ModelConfig:
    if compute_dtype not in _DTYPES:
        raise ValueError(f"unknown compute dtype {compute_dtype!r}")
    if cache_dtype is None:
        cache_dtype = "float32" if compute_dtype == "float32" else "bfloat16"
    if cache_dtype not in _KV_DTYPES:
        raise ValueError(f"unknown cache dtype {cache_dtype!r}")
    return ModelConfig(
        arch_type=h.arch_type,
        dim=h.dim,
        hidden_dim=h.ff_dim,
        n_layers=h.n_layers,
        n_heads=h.n_heads,
        n_kv_heads=h.n_kv_heads,
        head_dim=h.head_dim,
        vocab_size=h.vocab_size,
        seq_len=h.seq_len,
        n_experts=h.n_experts,
        n_active_experts=h.n_active_experts,
        hidden_act=h.hidden_act,
        rope_type=h.rope_type,
        norm_epsilon=h.norm_epsilon,
        compute_dtype=compute_dtype,
        cache_dtype=cache_dtype,
    )
