"""The chunked decode loop.

The counterpart of the JAX package's `runtime/decode.py:decode_chunk`, which
runs n_steps of forward + on-device sampling as one `lax.scan` program and
ships the chunk's tokens back in one transfer. Here it is a Python loop over
`forward` plus `sample_logits_traced`: each step's token stays on the
device and feeds the next step, and the engine fetches the whole chunk to
the host once (runtime/engine.py), so there is no device-to-host sync
inside the loop. `decode_loop` is that loop for any one-step forward; the
sequence-parallel decode (parallel/pipeline.py) runs it too.
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.params import KVCache, ModelParams
from ..models.transformer import forward
from ..ops.rope import RopeTables
from ..ops.sampling import sample_logits_traced


def decode_loop(step, token: torch.Tensor, pos_start, n_steps: int, temperature: float,
                topp: float, generator: torch.Generator | None):
    """n_steps iterations of logits = step(token[:, None], pos) and a
    sampled token that feeds the next one. Returns (tokens [b, n_steps],
    last_token [b]), both on the device."""
    out = []
    for i in range(n_steps):
        logits = step(token[:, None], pos_start + i)  # a device add for per-row positions
        token = sample_logits_traced(logits, temperature, topp, generator=generator)
        out.append(token)
    return torch.stack(out, dim=1), token


def decode_chunk(
    cfg: ModelConfig,
    params: ModelParams,
    rope: RopeTables,
    cache: KVCache,
    token: torch.Tensor,  # [b] — the token to feed first, on the device
    pos_start,  # int (rows aligned) or a [b] tensor of per-row positions
    n_steps: int,
    temperature: float = 0.0,
    topp: float = 0.9,
    generator: torch.Generator | None = None,
    kv_len: int | None = None,  # KV read bound covering pos_start + n_steps
    page_table: torch.Tensor | None = None,  # the paged layout's tables
    page_size: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run n_steps forward+sample iterations; the cache is updated in
    place. Returns (tokens [b, n_steps], last_token [b]), both on the
    device."""

    def step(tok, pos):
        return forward(
            cfg, params, rope, cache, tok, pos,
            logits_mode="last", kv_len=kv_len, page_table=page_table, page_size=page_size,
        )

    return decode_loop(step, token, pos_start, n_steps, temperature, topp, generator)
