"""The chunked decode loop.

The counterpart of the JAX package's `runtime/decode.py:decode_chunk`, which
runs n_steps of forward + on-device sampling as one `lax.scan` program and
ships the chunk's tokens back in one transfer. Here it is a Python loop over
`forward` plus `sample_logits_traced`: each step's token stays on the
device and feeds the next step, and the engine fetches the whole chunk to
the host once (runtime/engine.py), so there is no device-to-host sync
inside the loop. `decode_loop` is that loop for any one-step forward; the
sequence-parallel decode (parallel/pipeline.py) runs it too.

`decode_step` is one step of the same loop on static buffers
(runtime/graphs.py `StepBuffers`): position, token and step counter live
on the device and the step advances them itself, so its shapes and
launches depend only on (batch, kv bucket, layout, kv dtype, sampling
arm) and a CUDA graph of it replays a chunk. The rows are aligned, as
in `decode_chunk` at an int position; the forward pass takes that
position as a 0-d device tensor and computes what it computes at the int:
the same logits, bit for bit, with as many launches.

`verify_step` is the speculative verify round on the same buffers
(runtime/speculative.py), for both verify kinds: the feed at `bufs.pos[0]`
(rows aligned) or at `bufs.pos` (per row), logits at every position and
their argmax into the ids buffer, with no host sync, so a CUDA graph of
it is one verify round.
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.params import KVCache, ModelParams
from ..models.transformer import forward
from ..ops.rope import RopeTables
from ..ops.sampling import sample_logits_device, sample_logits_traced
from .speculative import verify_chunk


def decode_loop(step, token: torch.Tensor, pos_start, n_steps: int, temperature: float,
                topp: float, generator: torch.Generator | None):
    """n_steps iterations of logits = step(token[:, None], pos) and a
    sampled token that feeds the next one. Returns (tokens [b, n_steps],
    last_token [b], the last step's logits [b, vocab]), all on the
    device."""
    out = []
    logits = None
    for i in range(n_steps):
        logits = step(token[:, None], pos_start + i)  # a device add for per-row positions
        token = sample_logits_traced(logits, temperature, topp, generator=generator)
        out.append(token)
    return torch.stack(out, dim=1), token, logits


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
    place. Returns (tokens [b, n_steps], last_token [b], the last step's
    logits), all on the device."""

    def step(tok, pos):
        return forward(
            cfg, params, rope, cache, tok, pos,
            logits_mode="last", kv_len=kv_len, page_table=page_table, page_size=page_size,
        )

    return decode_loop(step, token, pos_start, n_steps, temperature, topp, generator)


def decode_step(
    cfg: ModelConfig,
    params: ModelParams,
    rope: RopeTables,
    cache: KVCache,
    bufs,  # runtime/graphs.py StepBuffers: token, pos (every row the same), step, out,
    # temperature, topp, table
    kv_len: int,
    page_size: int | None = None,  # the paged layout's page length (bufs.table set)
    sampler: str = "greedy",  # ops/sampling.py SAMPLERS
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """One capture-safe decode step: logits at `bufs.pos[0]` for `bufs.token`,
    the next token (greedy argmax, or `sample_logits_device` with the
    buffers' settings and `generator`), written into the chunk's output at
    the step counter; then token, positions and counter advance
    (`StepBuffers.advance`). Nothing syncs with the host and no host value
    enters but the key's. Returns the step's logits [b, vocab] f32."""
    logits = forward(
        cfg, params, rope, cache, bufs.token[:, None], bufs.pos[0],
        logits_mode="last", kv_len=kv_len, page_table=bufs.table if page_size else None,
        page_size=page_size,
    )
    if sampler != "greedy":
        token = sample_logits_device(logits, bufs.temperature, bufs.topp, generator,
                                     topp_arm=sampler == "topp")
    else:
        token = torch.argmax(logits, dim=-1)
    bufs.advance(token)
    return logits


def verify_step(cfg: ModelConfig, params: ModelParams, rope: RopeTables, cache: KVCache, bufs,
                t: int, kv_len: int, page_size: int | None = None,
                per_row: bool = False) -> torch.Tensor:
    """One capture-safe verify round: `verify_chunk` over `bufs.feed[t]`,
    its greedy ids written into `bufs.ids[t]`. The position operand is
    the kind's: the 0-d `bufs.pos[0]` with the rows aligned ("verify"), or
    with `per_row` the [b] `bufs.pos`, a row at seq_len parked, its writes
    landing nowhere ("verify_row"). Nothing advances and nothing syncs
    with the host. Returns the logits [b, t, vocab] f32."""
    ids, logits = verify_chunk(
        cfg, params, rope, cache, bufs.feed[t], bufs.pos if per_row else bufs.pos[0],
        kv_len=kv_len, page_table=bufs.table if page_size else None, page_size=page_size,
    )
    bufs.ids[t].copy_(ids)
    return logits
