"""The chunked decode loop.

The counterpart of the JAX package's `runtime/decode.py:decode_chunk`, which
runs n_steps of forward + on-device sampling as one `lax.scan` program and
ships the chunk's tokens back in one transfer. Here it is a Python loop over
`forward` plus `sample_logits_traced`: each step's token stays on the
device and feeds the next step, and the engine fetches the whole chunk to
the host once (runtime/engine.py), so there is no device-to-host sync
inside the loop.
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.params import KVCache, ModelParams
from ..models.transformer import forward
from ..ops.rope import RopeTables
from ..ops.sampling import sample_logits_traced


def decode_chunk(
    cfg: ModelConfig,
    params: ModelParams,
    rope: RopeTables,
    cache: KVCache,
    token: torch.Tensor,  # [b] — the token to feed first, on the device
    pos_start: int,
    n_steps: int,
    temperature: float = 0.0,
    topp: float = 0.9,
    generator: torch.Generator | None = None,
    kv_len: int | None = None,  # KV read bound covering pos_start + n_steps
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run n_steps forward+sample iterations; the cache is updated in
    place. Returns (tokens [b, n_steps], last_token [b]), both on the
    device."""
    out = []
    for i in range(n_steps):
        logits = forward(
            cfg, params, rope, cache, token[:, None], pos_start + i,
            logits_mode="last", kv_len=kv_len,
        )
        token = sample_logits_traced(logits, temperature, topp, generator=generator)
        out.append(token)
    return torch.stack(out, dim=1), token
