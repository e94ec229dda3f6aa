"""On-device sampling (argmax / temperature / top-p).

The counterpart of the JAX package's `ops/sampling.py:sample_logits_traced`
and `_sample_topp`. The math is the same (temperature scaling -> softmax ->
top-p truncation at the first cumulative probability > topp, a pick within
the kept mass); the random numbers come from an explicit `torch.Generator`,
so a seeded stream differs from jax.random's. Tests hand `_sample_topp`
the uniform draw (`coin`) to compare the math.

Temperature and top-p reach the sampled math as device vectors, as the JAX
package's decode program takes them as traced operands: one captured CUDA
graph (runtime/graphs.py) then serves every temperature and top-p, and the
eager and the graphed decode sample with the same operations, so with the
same draws they give the same tokens bit for bit. The host picks the arm
(`sampler_arm`: greedy, the full distribution, or top-p), and the arm keys
a graph: only the top-p arm pays for the sort over the vocabulary.

The batched path's per-row sampling (`sample_logits_per_row`, the JAX
package's :158) takes per-row settings as device vectors and one uniform
draw per row from `row_coins`, a counter-based hash of the row's seed and
draw count (the counterpart of `split_row_keys` :143).

Grammar-constrained decoding (runtime/grammar.py) masks the logits before
every arm (`apply_grammar_mask`, the JAX package's :27): one gather of the
arena table's rows at the per-row states and a `where`. A free row rides
the arena's all-legal FREE state, where the mask selects every logit as
it is, so its tokens are the grammar-less engine's bit for bit.
`advance_grammar` moves the states by the sampled tokens, as the JAX
decode scan does (`runtime/decode.py:86-89`).
"""

from __future__ import annotations

import numpy as np
import torch

#: the arms a decode step samples with (`sampler_arm`), each a graph key
SAMPLERS = ("greedy", "full", "topp")

#: the value of a grammar-illegal logit: exp() of it underflows to exactly 0
#: in every compute dtype, and it stays finite in bfloat16 (JAX's `_MASKED`)
MASKED = -1e30


def apply_grammar_mask(
    logits: torch.Tensor,  # [..., vocab]
    grammar_table: torch.Tensor | None,  # [S, vocab] int32; -1 = illegal
    grammar_state: torch.Tensor | None,  # [...] int64 global DFA states
) -> torch.Tensor:
    """Mask grammar-illegal tokens to MASKED before any sampling arm: the
    legality rows ``table[state] >= 0`` gathered at the states, then a
    `where`. The states are int64 on the device (torch's index dtype; the
    table keeps JAX's int32 values), so the gather needs no cast inside a
    graph. The identity when either operand is None (an engine without a
    grammar arena)."""
    if grammar_table is None or grammar_state is None:
        return logits
    legal = grammar_table[grammar_state] >= 0  # [..., vocab] bool
    return torch.where(legal, logits, MASKED)


def advance_grammar(grammar_table: torch.Tensor, grammar_state: torch.Tensor,
                    token: torch.Tensor) -> torch.Tensor:
    """The states after `token` [b]: ``table[state, token]`` where legal,
    else the state unchanged (the JAX decode step's advance). Returns [b]
    int64."""
    adv = grammar_table[grammar_state, token].to(grammar_state.dtype)
    return torch.where(adv < 0, grammar_state, adv)


def sampler_arm(temperature, topp) -> str:
    """The arm a chunk samples with, from its host settings (scalars, or
    one per row): "greedy" where no row samples, "topp" where a sampled
    row's topp lies in (0, 1), else "full". Compared in f32, as the device
    compares them."""
    t = np.asarray(temperature, dtype=np.float32)
    p = np.asarray(topp, dtype=np.float32)
    sampled = t > 0.0
    if not sampled.any():
        return "greedy"
    return "topp" if (sampled & (p > 0.0) & (p < 1.0)).any() else "full"


def _sample_topp(probs: torch.Tensor, topp, coin: torch.Tensor) -> torch.Tensor:
    """Top-p pick over [b, vocab] probs with a [b, 1] uniform `coin`: keep
    everything up to and including the first element whose cumulative
    probability exceeds topp, a float or a [b, 1] tensor (reference:
    sample_topp, tokenizer.cpp:426-447)."""
    b, n = probs.shape
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    csum = torch.cumsum(sorted_probs, dim=-1)
    over = csum > topp
    keep = torch.logical_not(
        torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=probs.device), over[:, :-1]], dim=-1)
    )
    kept = torch.where(keep, sorted_probs, 0.0)
    kept_sum = kept.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(kept, dim=-1)
    pick = (cdf < coin * kept_sum).sum(dim=-1).clamp(0, n - 1)
    return torch.gather(order, 1, pick[:, None])[:, 0]


def sample_logits_traced(
    logits: torch.Tensor,  # [b, vocab] f32
    temperature: float,  # <= 0 = greedy
    topp: float,  # outside (0, 1) = full distribution
    generator: torch.Generator | None = None,
    grammar_table: torch.Tensor | None = None,  # [S, vocab] int32 arena
    grammar_state: torch.Tensor | None = None,  # [b] int64 global DFA states
) -> torch.Tensor:
    """Returns [b] int64 sampled tokens, on the logits' device: the greedy
    argmax, or `sample_logits_device` with the settings as device vectors.
    Grammar operands mask the logits before either arm."""
    logits = apply_grammar_mask(logits, grammar_table, grammar_state)
    arm = sampler_arm(temperature, topp)
    if arm == "greedy":
        # argmax returns the first maximal index on ties, as jnp.argmax does
        return torch.argmax(logits, dim=-1)
    b = logits.shape[0]
    temp = torch.full((b,), float(temperature), dtype=torch.float32, device=logits.device)
    topp_v = torch.full((b,), float(topp), dtype=torch.float32, device=logits.device)
    return sample_logits_device(logits, temp, topp_v, generator, topp_arm=arm == "topp")


def sample_logits_device(
    logits: torch.Tensor,  # [b, vocab] f32
    temperature: torch.Tensor,  # [b] f32 (> 0: the sampled step)
    topp: torch.Tensor,  # [b] f32; outside (0, 1) = full distribution
    generator: torch.Generator | None = None,
    topp_arm: bool = True,  # False: no row's topp lies in (0, 1)
    grammar_table: torch.Tensor | None = None,
    grammar_state: torch.Tensor | None = None,
) -> torch.Tensor:
    """The sampled decode step with its settings on the device: one uniform
    draw a row from `generator`, then `sample_logits_per_row`'s math (the
    vocab-order CDF or the top-p sorted CDF, selected per row), over the
    grammar-masked logits. No host value enters but the arm, so a CUDA
    graph captures it once an arm for every temperature and top-p; with
    the generator registered in the graph, each replay draws fresh
    numbers. Returns [b] int64."""
    coin = torch.rand((logits.shape[0], 1), generator=generator, device=logits.device)
    return sample_logits_per_row(logits, coin, temperature, topp, topp_arm,
                                 grammar_table, grammar_state)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant, in
    16-bit halves so that no intermediate leaves the int64 range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 tensors holding uint32s."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def row_coins(seeds: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """One uniform draw in [0, 1) per row, [b, 1] f32, from a counter-based
    stream: a pure function of the row's own seed (int64, two 32-bit
    words) and its draw counter, so a row's stream never depends on its
    co-tenants or on the chunk it lands in. The counterpart of the JAX
    package's per-row threefry key chains (`split_row_keys` :143); the bits
    differ, so greedy is the parity path."""
    lo = seeds & _M32
    hi = (seeds >> 32) & _M32
    h = _fmix32(lo ^ _fmix32(_mul32(counters & _M32, 0x9E3779B9) ^ hi))
    return ((h >> 8).to(torch.float32) * (1.0 / (1 << 24)))[:, None]


def sample_logits_per_row(
    logits: torch.Tensor,  # [b, vocab] f32
    coin: torch.Tensor,  # [b, 1] uniform draws (row_coins)
    temperature: torch.Tensor,  # [b] f32; <= 0 = greedy for that row
    topp: torch.Tensor,  # [b] f32; outside (0, 1) = full distribution
    topp_arm: bool = True,  # False: no sampled row's topp lies in (0, 1)
    grammar_table: torch.Tensor | None = None,  # [S, vocab] int32 arena
    grammar_state: torch.Tensor | None = None,  # [b] int64 global DFA states
) -> torch.Tensor:
    """Per-row sampling settings as device vectors, so one chunk serves any
    mix of greedy, temperature and top-p rows: the JAX package's
    `sample_logits_per_row` (:158). Each row takes the greedy argmax, the
    vocab-order CDF (topp outside (0, 1)) or the top-p sorted CDF, all
    computed and then selected per row. Without `topp_arm` (`sampler_arm`
    says "full") the sorted CDF, which no row would select, is skipped:
    the same tokens. Grammar operands mask the logits before every arm
    (JAX :176). Returns [b] int64."""
    logits = apply_grammar_mask(logits, grammar_table, grammar_state)
    b, n = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature.clamp(min=1e-6)[:, None], dim=-1)
    full_pick = (torch.cumsum(probs, dim=-1) < coin).sum(dim=-1).clamp(0, n - 1)
    sampled = full_pick
    if topp_arm:
        in_topp = (topp > 0.0) & (topp < 1.0)
        topp_pick = _sample_topp(probs, torch.where(in_topp, topp, 1.0)[:, None], coin)
        sampled = torch.where(in_topp, topp_pick, full_pick)
    return torch.where(temperature <= 0.0, greedy, sampled)
