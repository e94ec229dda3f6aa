"""The router's prefix chain keys, as the server needs them.

The part of the JAX package's `server/router.py` that a replica calls,
copied: `prefix_chain` over `messages_prefix_text` (the chained FNV-1a
block hashes the gateway's cache-aware router keys its locality map by),
`fnv1a`, and the prefetch-chain header's codec. A replica records its
requests' chain keys (`/debug/hot_prefixes`, server/scheduler.py
`HotPrefixTracker`) so the gateway can re-home affinity before a drain,
so these keys must equal the JAX router's byte for byte. The rest of the
router is the gateway's, which stays the JAX package's (stdlib only).
"""

from __future__ import annotations

#: characters per hash block — the prefix cache publishes at 16-token pages
#: and text runs ~4 chars/token, so one block approximates one page
PAGE_CHARS = 64
#: chain depth cap: prefixes deeper than this share their fate with the
#: 32-block (≈2k-char) chain head — long-tail depth adds nothing to routing
MAX_BLOCKS = 32

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3

#: router prefetch hint (runtime/kv_tiering.py): the gateway forwards the
#: plan's chain keys on every proxied chat request as comma-joined
#: zero-padded hex, so the backend's tiered KV store can lift the matching
#: prefix disk/peer -> host BEFORE (or while) the prompt is tokenized.
#: Purely advisory — stripping the header costs warmth, never correctness.
PREFETCH_CHAIN_HEADER = "X-DLT-Prefetch-Chain"


def chain_header_value(chain) -> str:
    """Wire-encode router chain keys for :data:`PREFETCH_CHAIN_HEADER` —
    the same zero-padded hex ``/debug/hot_prefixes`` speaks."""
    return ",".join(f"{ck:016x}" for ck in chain)


def parse_chain_header(value) -> list:
    """Decode a :data:`PREFETCH_CHAIN_HEADER` value back to chain keys.
    Garbage (missing, empty, non-hex fragments) degrades to ``[]`` — a
    prefetch hint must never be able to fail a request."""
    if not value:
        return []
    try:
        return [int(p, 16) for p in str(value).split(",") if p.strip()]
    except ValueError:
        return []


def fnv1a(data: bytes, h: int = _FNV64_OFFSET) -> int:
    """64-bit FNV-1a over ``data`` seeded with ``h`` — deterministic across
    processes and runs (Python's builtin hash is salted per process, which
    would break cross-gateway agreement on prefix ownership)."""
    for b in data:
        h ^= b
        h = (h * _FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def prefix_chain(text: str, block_chars: int = PAGE_CHARS,
                 max_blocks: int = MAX_BLOCKS) -> list:
    """Chained block hashes of the leading text: ``chain[i]`` covers the
    first ``i+1`` blocks, and each hash seeds the next — so texts sharing a
    leading span share exactly the chain entries that span covers. Only
    COMPLETE blocks hash (a half-filled tail block would make the chain key
    depend on where the request happens to end, splitting identical
    prefixes across keys)."""
    out: list = []
    h = _FNV64_OFFSET
    n_full = min(len(text) // block_chars, max_blocks)
    for i in range(n_full):
        h = fnv1a(
            text[i * block_chars : (i + 1) * block_chars].encode(
                "utf-8", errors="replace"
            ),
            h,
        )
        out.append(h)
    return out


def messages_prefix_text(messages) -> str | None:
    """The routable prefix text of a parsed ``messages`` list: roles +
    contents concatenated in order (the same order the chat template feeds
    the tokenizer, so equal text here means equal leading tokens there).
    Shared by the gateway's router (via :func:`chat_prefix_text`) and the
    replica-side hot-prefix tracker (server/api.py) — BOTH sides must hash
    the identical text or warm-handoff chain keys would never match the
    locality map's. None on garbage shapes (non-list, non-dict entries)."""
    try:
        parts = []
        for m in messages:
            parts.append(str(m.get("role", "")))
            parts.append("\x00")
            parts.append(str(m.get("content", "")))
            parts.append("\x1e")
        return "".join(parts)
    except (TypeError, AttributeError):
        # AttributeError included: a JSON-valid body whose messages entries
        # are not dicts ({"messages": ["hi"]}) must abstain, not crash the
        # gateway's connection thread — the backend owns the 400
        return None
