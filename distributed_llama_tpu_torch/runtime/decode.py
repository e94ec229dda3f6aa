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

`prefill_step` is one prefill chunk on the same buffers: the chunk's
tokens and its position on the device, so a CUDA graph of (kind, batch,
chunk size, kv bucket, layout, kv dtype) replays every chunk of that shape
at any position of its bucket, as the JAX engine's jitted prefill takes
its position as a device operand.

`verify_step` is the speculative verify round on the same buffers
(runtime/speculative.py), for both verify kinds: the feed at `bufs.pos[0]`
(rows aligned) or at `bufs.pos` (per row), logits at every position and
their argmax into the ids buffer, with no host sync, so a CUDA graph of
it is one verify round.

On an engine with a grammar arena (runtime/grammar.py) every step threads
the arena's device table and the per-row grammar states, as the JAX
engine threads them into every decode program (engine.py:1424-1460,
:1472-1532): the logits are masked before the sampling arm
(`ops/sampling.py:apply_grammar_mask`), and the decode steps advance the
states by the sampled token in the step itself (`advance_grammar`, JAX
`runtime/decode.py:86-89`), so a chunk's later steps are masked with no
host round trip. A verify round masks its [b, t] logits with [b, t]
states. Free rows ride the FREE state 0, the all-legal self-loop, so no
graph key is added and the graphs of such an engine always carry the
mask. The eager loops and the static steps call the same two functions.
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.params import KVCache, ModelParams
from ..models.transformer import forward
from ..ops.rope import RopeTables
from ..ops.sampling import (
    advance_grammar, apply_grammar_mask, sample_logits_device, sample_logits_traced,
)
from .speculative import verify_chunk


def decode_loop(step, token: torch.Tensor, pos_start, n_steps: int, temperature: float,
                topp: float, generator: torch.Generator | None, grammar_table=None,
                grammar_state=None):
    """n_steps iterations of logits = step(token[:, None], pos) and a
    sampled token that feeds the next one; with grammar operands the
    logits are masked at the row's state and the state advances by the
    token. Returns (tokens [b, n_steps], last_token [b], the last step's
    logits [b, vocab]), all on the device, and with `grammar_state` the
    final states [b] as a 4th output."""
    out = []
    logits = None
    for i in range(n_steps):
        logits = step(token[:, None], pos_start + i)  # a device add for per-row positions
        token = sample_logits_traced(logits, temperature, topp, generator=generator,
                                     grammar_table=grammar_table, grammar_state=grammar_state)
        if grammar_state is not None:
            grammar_state = advance_grammar(grammar_table, grammar_state, token)
        out.append(token)
    if grammar_state is not None:
        return torch.stack(out, dim=1), token, logits, grammar_state
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
    grammar_table: torch.Tensor | None = None,  # [S, vocab] int32 grammar arena
    grammar_state: torch.Tensor | None = None,  # [b] int64 global DFA states
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run n_steps forward+sample iterations; the cache is updated in
    place. Returns (tokens [b, n_steps], last_token [b], the last step's
    logits), all on the device; with grammar operands the masked sampling
    and the state advance of `decode_loop`, and the final states as a 4th
    output."""

    def step(tok, pos):
        return forward(
            cfg, params, rope, cache, tok, pos,
            logits_mode="last", kv_len=kv_len, page_table=page_table, page_size=page_size,
        )

    return decode_loop(step, token, pos_start, n_steps, temperature, topp, generator,
                       grammar_table, grammar_state)


def decode_step(
    cfg: ModelConfig,
    params: ModelParams,
    rope: RopeTables,
    cache: KVCache,
    bufs,  # runtime/graphs.py StepBuffers: token, pos (every row the same), step, out,
    # temperature, topp, table, grammar and gstate
    kv_len: int,
    page_size: int | None = None,  # the paged layout's page length (bufs.table set)
    sampler: str = "greedy",  # ops/sampling.py SAMPLERS
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """One capture-safe decode step: logits at `bufs.pos[0]` for `bufs.token`,
    the next token (greedy argmax, or `sample_logits_device` with the
    buffers' settings and `generator`), written into the chunk's output at
    the step counter; then token, positions and counter advance
    (`StepBuffers.advance`). With the engine's grammar table in
    `bufs.grammar` the logits are masked at `bufs.gstate` and the states
    advance by the token (`sample_step`). Nothing syncs with the host and
    no host value enters but the key's. Returns the step's logits [b,
    vocab] f32."""
    logits = forward(
        cfg, params, rope, cache, bufs.token[:, None], bufs.pos[0],
        logits_mode="last", kv_len=kv_len, page_table=bufs.table if page_size else None,
        page_size=page_size,
    )
    token = sample_step(logits, bufs, sampler, lambda: sample_logits_device(
        logits, bufs.temperature, bufs.topp, generator, topp_arm=sampler == "topp",
        grammar_table=bufs.grammar, grammar_state=bufs.gstate))
    bufs.advance(token)
    return logits


def prefill_step(cfg: ModelConfig, params: ModelParams, rope: RopeTables, cache: KVCache, bufs,
                 size: int, kv_len: int, page_size: int | None = None,
                 row: bool = False) -> torch.Tensor:
    """One capture-safe prefill chunk (the JAX engine's jitted prefill
    program, engine.py:1302-1320): `forward` over the chunk operand
    `bufs.prefill(size, row)` (tokens, then the 0-d device position, then
    the row), the KV writes landing in the cache in place; nothing syncs
    with the host. "prefill" (`row` False): every row, through the
    engine's page table `bufs.table` where paged. "prefill_row" (`row`):
    one batch row alone at b = 1: paged through the one-row table
    `bufs.row_table`, contiguous into the row the operand names on the
    device, so one graph serves every row. Returns the last row's logits
    [rows, vocab] f32 (JAX's prefill fetches none of it)."""
    tokens, pos, at = bufs.prefill_views(bufs.prefill(size, row), size)
    if not row:
        return forward(cfg, params, rope, cache, tokens, pos, logits_mode="last", kv_len=kv_len,
                       page_table=bufs.table if page_size else None, page_size=page_size)
    if page_size:
        return forward(cfg, params, rope, cache, tokens, pos, logits_mode="last", kv_len=kv_len,
                       page_table=bufs.row_table, page_size=page_size)
    return forward(cfg, params, rope, cache, tokens, pos, logits_mode="last", kv_len=kv_len,
                   row=at)


def sample_step(logits: torch.Tensor, bufs, sampler: str, sampled) -> torch.Tensor:
    """A static step's next token: `sampled()` (its arm over the masked
    logits), or the greedy argmax over the logits masked at `bufs.gstate`;
    then the grammar states advance by it, where the engine has an arena."""
    if sampler != "greedy":
        token = sampled()
    else:
        token = torch.argmax(apply_grammar_mask(logits, bufs.grammar, bufs.gstate), dim=-1)
    if bufs.grammar is not None:
        bufs.gstate.copy_(advance_grammar(bufs.grammar, bufs.gstate, token))
    return token


def verify_step(cfg: ModelConfig, params: ModelParams, rope: RopeTables, cache: KVCache, bufs,
                t: int, kv_len: int, page_size: int | None = None,
                per_row: bool = False) -> torch.Tensor:
    """One capture-safe verify round: `verify_chunk` over `bufs.feed[t]`,
    its greedy ids written into `bufs.ids[t]`. The position operand is
    the kind's: the 0-d `bufs.pos[0]` with the rows aligned ("verify"), or
    with `per_row` the [b] `bufs.pos`, a row at seq_len parked, its writes
    landing nowhere ("verify_row"). With the engine's grammar table the
    logits are masked at `bufs.gstates[t]` before the argmax. Nothing
    advances and nothing syncs with the host. Returns the (masked) logits
    [b, t, vocab] f32."""
    ids, logits = verify_chunk(
        cfg, params, rope, cache, bufs.feed[t], bufs.pos if per_row else bufs.pos[0],
        kv_len=kv_len, page_table=bufs.table if page_size else None, page_size=page_size,
        grammar_table=bufs.grammar, grammar_state=bufs.gstates.get(t),
    )
    bufs.ids[t].copy_(ids)
    return logits
