"""The KV movement layer: every cross-boundary KV transfer in one place.

The counterpart of the JAX package's `runtime/kv_transport.py`, with the
same names, error classes, counters, environment variables and wire
format, byte for byte:

* **content-addressed page naming** — :func:`page_keys` names each
  :data:`KEY_PAGE_TOKENS`-token span of a token chain by a chained FNV-1a
  hash (key ``i`` covers tokens ``[0, (i+1)*16)``), so a page's identity
  is its content, never a pool-local page id: a decode worker tells a
  prefill worker which leading pages it holds and receives only the rest
  (``disagg_pages_skipped``);
* **transport selection** — :func:`resolve_transport`
  (``DLT_KV_TRANSPORT`` = ``auto`` | ``device`` | ``http``):
  :class:`DeviceKvTransport` hands torch tensors on the card between
  same-process peers (the registry below; nothing crosses a process),
  :class:`HttpKvTransport` speaks the length-prefixed binary codec;
* **the wire codec** — :func:`kv_payload` / :func:`parse_kv_payload`:
  4-byte big-endian header length, the JSON header, raw k bytes, raw v
  bytes. NumPy has no bfloat16 and the port does not use ``ml_dtypes``:
  a bf16 slice travels as its raw 16-bit words, a ``uint16`` array on
  the host side whose header still says ``"bfloat16"`` (:func:`wire_name`,
  :func:`to_wire`, :func:`from_wire`), so header and bytes equal the JAX
  codec's;
* **data-plane integrity** — wire version :data:`WIRE_VERSION` carries
  per-doubling-segment crc32 sums and the ``page_keys`` echo, and
  :func:`verify_transfer` checks both before anything can touch the
  receiver's prefix cache (:class:`KvIntegrityError`); an unknown version
  is :class:`KvVersionError` (skip the peer, never strike it).

Every transfer is accounted per path: the ``kv_transfer_us[{path}]``
StepStats series and the ``kv_transfer_bytes_{path}`` counters.

stdlib + numpy at import time; torch only inside the tensor helpers.
"""

from __future__ import annotations

import json
import math
import os
import struct
import threading
import zlib

import numpy as np

#: tokens per content-addressed page name. Matches the paged pool's default
#: page size AND the prefix cache's publish floor (PREFIX_MIN_TOKENS), so
#: every bucket boundary both caches speak is a whole number of named pages.
KEY_PAGE_TOKENS = 16

KV_TRANSPORTS = ("auto", "device", "http")

#: wire codec version. v1 shipped bytes untagged and unchecked;
#: v2 adds the version field itself plus per-segment checksums and the
#: page_keys echo that verify_transfer checks before any cache insert.
WIRE_VERSION = 2

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3


class KvCodecError(ValueError):
    """A wire payload this build cannot use: truncation, garbage header,
    shape/dtype nonsense. A ValueError subclass so every pre-existing
    ``except ValueError`` degrade path keeps catching it — but the
    DisaggClient can now tell a complete-but-wrong response (this family:
    strike the peer) from a transport death (OSError: back off the peer)."""


class KvIntegrityError(KvCodecError):
    """The payload parsed but its content is wrong: checksum mismatch,
    page_keys echo disagreeing with the token chain, tokens that are not
    the ones asked for, shapes that do not cover the slice. The one
    corruption signal — the receiver rejects BEFORE the cache is touched
    and strikes the peer (corrupt-peer quarantine)."""


class KvVersionError(KvCodecError):
    """The peer speaks a different wire version. Rejected cleanly at the
    header — never mid-body as a generic parse error — and NEVER a strike:
    a mixed-version fleet mid-rolling-deploy is healthy, just incompatible;
    the client skips the peer (``disagg_peer_version_mismatch``)."""


def resolve_transport(explicit: str | None = None) -> str:
    """THE one resolver of the KV transport mode: an explicit value wins;
    otherwise ``DLT_KV_TRANSPORT``; unset/unrecognized means ``auto``
    (device for registered same-process peers, http for everyone else)."""
    mode = explicit
    if mode is None:
        raw = (os.environ.get("DLT_KV_TRANSPORT") or "").strip().lower()
        mode = raw if raw in KV_TRANSPORTS else "auto"
    mode = mode.strip().lower()
    if mode not in KV_TRANSPORTS:
        raise ValueError(
            f"unknown kv transport {mode!r} (choose from {KV_TRANSPORTS})"
        )
    return mode


def _fnv1a_bytes(data: bytes, h: int = _FNV64_OFFSET) -> int:
    for b in data:
        h ^= b
        h = (h * _FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def page_keys(tokens, page_tokens: int = KEY_PAGE_TOKENS) -> tuple:
    """Chained content names of a token chain's FULL pages: key ``i`` is
    the FNV-1a hash of page ``i``'s token ids (4-byte little-endian each)
    seeded with key ``i-1`` — so chains sharing a leading span share
    exactly the keys that span covers, and a one-token divergence renames
    every later page (the radix property, hashed). Only complete pages are
    named: a partial tail has no stable identity to ship."""
    out = []
    h = _FNV64_OFFSET
    n_full = len(tokens) // page_tokens
    for i in range(n_full):
        page = tokens[i * page_tokens : (i + 1) * page_tokens]
        h = _fnv1a_bytes(
            b"".join(struct.pack("<i", int(t)) for t in page), h
        )
        out.append(h)
    return tuple(out)


def doubling_segments(start: int, end: int) -> list:
    """Split ``[start, end)`` into segments along the binary doubling
    ladder: ``[s, 2s), [2s, 4s), ...`` — when `start` and `end` are prefix
    buckets (powers of two on the cache ladder), every segment length is
    itself a bucket, so paged scatter/gather dispatches stay on the warmed
    program ladder with no padding. ``start == 0`` is one full segment."""
    if start <= 0:
        return [(0, end)]
    out = []
    s = start
    while s < end:
        e = min(2 * s, end)
        out.append((s, e))
        s = e
    return out


def matching_pages(expected_keys, have_keys) -> int:
    """Longest leading run of ``have_keys`` matching ``expected_keys`` —
    the pages a transfer can skip. A mid-run mismatch stops the match
    (chained keys make any later agreement impossible anyway)."""
    n = 0
    for e, h in zip(expected_keys, have_keys):
        if int(e) != int(h):
            break
        n += 1
    return n


# -- the wire format ----------------------------------------------------------
#
# 4-byte big-endian header length | JSON header | raw k bytes | raw v bytes
# Header: v (wire version), tokens (ALL P token ids the boundary covers),
# p, start (token offset of the shipped slice — 0 for a full send, a page
# multiple when the requester already held the leading pages), page_keys
# (content names of the full span, hex strings), k_shape/v_shape (of the
# SHIPPED slice), dtype, k_sums/v_sums (per-doubling-segment byte
# checksums, hex strings), prefill_us (the worker's wall — the decode
# side's ledger field). Raw bytes rather than base64-in-JSON: a 512-token
# 8B-class slice is tens of MB and the transfer wall is the metric under
# test — which is also why the checksum is crc32 (C speed, stdlib,
# xxhash-style cost) and not the pure-python FNV loop that names pages:
# page_keys hash a few hundred token ids, the sums hash the multi-MB body.


def segment_checksum(data: bytes) -> int:
    """Byte checksum of ONE doubling segment's raw k (or v) bytes."""
    return zlib.crc32(data) & 0xFFFFFFFF


def kv_payload(header: dict, k_np: np.ndarray, v_np: np.ndarray) -> bytes:
    # the codec owns the version field: every payload this build emits is
    # stamped, so a v3 receiver can reject it at the header
    if "v" not in header:
        header = dict(header, v=WIRE_VERSION)
    hjson = json.dumps(header).encode()
    return struct.pack(">I", len(hjson)) + hjson + k_np.tobytes() + v_np.tobytes()


#: the wire's name of a bf16 slice, whose host arrays are uint16 words
BF16 = "bfloat16"


def _np_dtype(name: str):
    """The host dtype of a wire dtype name: ``bfloat16`` travels as its
    raw 16-bit words (``uint16``); every other name is NumPy's own."""
    if name == BF16:
        return np.dtype(np.uint16)
    return np.dtype(name)


def wire_name(arr) -> str:
    """The header's ``dtype`` of a host array: ``bfloat16`` for the
    ``uint16`` words a bf16 slice travels as (the port ships no other
    16-bit integer KV), else NumPy's name."""
    return BF16 if arr.dtype == np.uint16 else str(arr.dtype)


def to_wire(t) -> np.ndarray:
    """A tensor (or a host array) as its host array on the wire: a copy on
    the host, bf16 as uint16 words."""
    if isinstance(t, np.ndarray):
        return t
    import torch

    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def from_wire(arr, device=None):
    """A host array off the wire (or a tensor, passed through) as a torch
    tensor on `device` (None: where it is): ``uint16`` words become bf16."""
    import torch

    if not isinstance(arr, np.ndarray):
        return arr if device is None else arr.to(device)
    a = np.ascontiguousarray(arr)
    if not a.flags.writeable:  # a view of a received body: torch wants its own
        a = a.copy()
    if a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def parse_kv_payload(body: bytes):
    """``(header, k_np, v_np)`` from one payload.

    Raises :class:`KvVersionError` on a wire-version mismatch (decided at
    the header, before any body work) and :class:`KvCodecError` — both
    ValueError subclasses — on EVERYTHING else a hostile or truncated body
    can be: fuzz-hardened, so a handler thread never sees a KeyError /
    TypeError / AttributeError escape from a garbage payload."""
    if not isinstance(body, (bytes, bytearray, memoryview)):
        raise KvCodecError(f"kv payload is {type(body).__name__}, not bytes")
    body = bytes(body)
    if len(body) < 4:
        raise KvCodecError("kv payload truncated before header length")
    (hlen,) = struct.unpack(">I", body[:4])
    if hlen > len(body) - 4:
        raise KvCodecError("kv payload truncated inside header")
    try:
        header = json.loads(body[4 : 4 + hlen])
    except ValueError as e:  # JSONDecodeError and bad-encoding both
        raise KvCodecError(f"kv header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise KvCodecError("kv header is not a JSON object")
    try:
        ver = int(header.get("v", 1))
    except (TypeError, ValueError):
        raise KvCodecError(f"unreadable kv wire version {header.get('v')!r}") from None
    if ver != WIRE_VERSION:
        raise KvVersionError(
            f"kv wire version {ver}; this build speaks {WIRE_VERSION}"
        )
    try:
        dt = _np_dtype(header["dtype"])
        k_shape = tuple(int(d) for d in header["k_shape"])
        v_shape = tuple(int(d) for d in header["v_shape"])
    except Exception as e:
        # KeyError (field missing), TypeError (np.dtype on garbage),
        # ValueError (non-int dims) — all the same clean rejection
        raise KvCodecError(f"kv header unusable: {type(e).__name__}: {e}") from None
    if any(d < 0 for d in k_shape + v_shape):
        raise KvCodecError("negative dimension in kv header shapes")
    # math.prod, not np.prod: exact python ints — a garbage header naming
    # absurd dims must mismatch the body length, never wrap an int64
    k_bytes = math.prod(k_shape) * dt.itemsize
    v_bytes = math.prod(v_shape) * dt.itemsize
    blob = body[4 + hlen :]
    if len(blob) != k_bytes + v_bytes:
        raise KvCodecError(
            f"kv payload truncated: body {len(blob)} B, "
            f"header names {k_bytes + v_bytes} B"
        )
    try:
        k = np.frombuffer(blob[:k_bytes], dtype=dt).reshape(k_shape)
        v = np.frombuffer(blob[k_bytes:], dtype=dt).reshape(v_shape)
    except (ValueError, TypeError) as e:  # e.g. object dtype in the header
        raise KvCodecError(f"kv body unusable: {e}") from None
    return header, k, v


# -- receipt verification -----------------------------------------------------
#
# THE data-plane integrity gate: every fetched transfer passes through
# verify_transfer BEFORE insert_external/scatter_pages can touch the
# receiver's cache. Deliberately emit-free: this loop walks a multi-MB
# body (TRACE_EMIT_SCOPE's trace-hot-emit lint guards it) — the caller
# lands ONE kv_integrity event per rejection, outside any loop.


def verify_transfer(result, ids, P: int, page_tokens: int = KEY_PAGE_TOKENS):
    """Verify one fetched transfer against the tokens the CLIENT asked for.

    Checks, in cost order: wire version (:class:`KvVersionError` on
    mismatch), the token echo (the returned chain must be ``ids[:P]``
    exactly), slice bounds (``start`` aligned and inside ``[0, P)``), the
    ``page_keys`` echo against a local recomputation of the chained token
    hashes, and then the path-specific half: the HTTP path recomputes the
    per-doubling-segment byte checksums over the received k/v bytes; the
    device path — whose bytes never left the process — checks segment
    count, per-segment shapes, and k/v dtype agreement. Any content
    mismatch raises :class:`KvIntegrityError`; returns None on success."""
    header = result.header
    if not isinstance(header, dict):
        raise KvIntegrityError(f"kv header is {type(header).__name__}, not a dict")
    try:
        ver = int(header.get("v", 1))
    except (TypeError, ValueError):
        raise KvVersionError(f"unreadable kv wire version {header.get('v')!r}") from None
    if ver != WIRE_VERSION:
        raise KvVersionError(
            f"kv wire version {ver}; this build speaks {WIRE_VERSION}"
        )
    try:
        tokens = [int(t) for t in header["tokens"]]
        start = int(header.get("start", 0))
        p = int(header.get("p", len(tokens)))
        pt = int(header.get("page_tokens", page_tokens))
        echoed = tuple(int(h, 16) for h in header["page_keys"])
    except Exception as e:
        raise KvIntegrityError(
            f"kv header unusable: {type(e).__name__}: {e}"
        ) from None
    if tokens != [int(t) for t in ids[:P]]:
        raise KvIntegrityError("peer returned KV for different tokens")
    if p != P:
        raise KvIntegrityError(f"peer names boundary p={p}, asked {P}")
    if pt != page_tokens:
        raise KvIntegrityError(f"peer names page granularity {pt}, not {page_tokens}")
    if start < 0 or start >= P or start % page_tokens:
        raise KvIntegrityError(f"kv slice start {start} out of bounds for p={P}")
    if echoed != page_keys(tokens, page_tokens):
        raise KvIntegrityError("page_keys echo does not match the token chain")
    if result.path == "http":
        k, v = result.k, result.v
        spans = doubling_segments(start, P)
        try:
            k_sums = [int(s, 16) for s in header["k_sums"]]
            v_sums = [int(s, 16) for s in header["v_sums"]]
        except Exception as e:
            raise KvIntegrityError(
                f"v{ver} payload carries no usable checksums: "
                f"{type(e).__name__}: {e}"
            ) from None
        if len(k_sums) != len(spans) or len(v_sums) != len(spans):
            raise KvIntegrityError(
                f"{len(k_sums)}/{len(v_sums)} checksums do not cover "
                f"{len(spans)} doubling segments"
            )
        if k.ndim != 4 or k.shape[1] != P - start or v.shape != k.shape:
            raise KvIntegrityError(
                f"kv shapes {tuple(k.shape)}/{tuple(v.shape)} do not cover "
                f"tokens [{start}, {P})"
            )
        for i, (a, b) in enumerate(spans):
            ks = segment_checksum(k[:, a - start : b - start].tobytes())
            vs = segment_checksum(v[:, a - start : b - start].tobytes())
            if ks != k_sums[i] or vs != v_sums[i]:
                raise KvIntegrityError(
                    f"segment [{a}, {b}) checksum mismatch "
                    f"(k {ks:#x} vs {k_sums[i]:#x}, v {vs:#x} vs {v_sums[i]:#x})"
                )
    else:
        # device path: the arrays are the sender's own device buffers —
        # byte-hashing them would force a device->host sync for data that
        # never crossed a wire. Verify the metadata half instead.
        if isinstance(result.k, (list, tuple)):
            ks_list = list(result.k)
            vs_list = list(result.v) if isinstance(result.v, (list, tuple)) else []
            spans = doubling_segments(start, P)
            if len(ks_list) != len(spans) or len(vs_list) != len(spans):
                raise KvIntegrityError(
                    f"{len(ks_list)}/{len(vs_list)} device segments do not "
                    f"cover {len(spans)} doubling segments"
                )
        else:
            # contiguous extract ships tokens [start, P) as one segment
            ks_list, vs_list = [result.k], [result.v]
            spans = [(start, P)]
        for (a, b), ka, va in zip(spans, ks_list, vs_list):
            ksh = tuple(getattr(ka, "shape", ()))
            vsh = tuple(getattr(va, "shape", ()))
            if len(ksh) != 4 or ksh[1] != b - a or vsh != ksh:
                raise KvIntegrityError(
                    f"device segment [{a}, {b}) shapes {ksh}/{vsh} do not "
                    f"cover its {b - a} tokens"
                )
            if getattr(ka, "dtype", None) != getattr(va, "dtype", None):
                raise KvIntegrityError(
                    f"device segment [{a}, {b}) k/v dtype mismatch"
                )
    return None


# -- the same-process peer registry -------------------------------------------
#
# serve() registers each API server's state under its port; a decode
# worker whose --prefill-peer names a registered port reaches the prefill
# engine without touching a socket (colocated roles in one process, on
# one card). The provider contract is duck-typed — an object with `.role`
# and `.prefill_extract(ids, have_keys, trace_id=None) -> (header, k, v)`
# — so this module never imports the server.

_registry_lock = threading.Lock()
_device_peers: dict = {}  # port -> weakref.ref(provider)

#: test hook: one-shot device-path faults — ("raise", exc) makes the next
#: fetch die like a dead HTTP peer; ("corrupt", mode) lets the fetch
#: complete and then corrupts its result the way a buggy/stale provider
#: would, so the chaos twin proves the metadata verifier rejects it
#: (see tests/test_kv_transport.py and tests/test_kv_integrity.py)
_device_chaos: list = []

#: corrupt modes: the three metadata surfaces the device verifier covers
DEVICE_CORRUPT_MODES = ("page_keys", "tokens", "shape")


def register_device_peer(port: int, provider) -> None:
    """Register a provider under its port. WEAK reference on purpose: the
    registry must never keep a torn-down server's engine (weights + KV
    pool) alive, and a dead ref heals `auto` back to the HTTP path for
    embedders that cycle servers on reused ports."""
    import weakref

    with _registry_lock:
        _device_peers[int(port)] = weakref.ref(provider)


def unregister_device_peer(port: int) -> None:
    with _registry_lock:
        _device_peers.pop(int(port), None)


def device_peer(port: int):
    with _registry_lock:
        ref = _device_peers.get(int(port))
        if ref is None:
            return None
        provider = ref()
        if provider is None:  # collected: prune the dead entry
            _device_peers.pop(int(port), None)
        return provider


def set_device_chaos(exc: BaseException | None = None,
                     corrupt: str | None = None) -> None:
    """Arm a one-shot device-path fault: ``exc`` raises it mid-fetch
    (fail-stop twin), ``corrupt`` completes the fetch and then mangles one
    metadata surface of the result (:data:`DEVICE_CORRUPT_MODES` — the
    wrong-data twin). ``set_device_chaos(None)`` / no args clears."""
    if exc is not None:
        _device_chaos[:] = [("raise", exc)]
    elif corrupt is not None:
        if corrupt not in DEVICE_CORRUPT_MODES:
            raise ValueError(
                f"unknown corrupt mode {corrupt!r} (one of {DEVICE_CORRUPT_MODES})"
            )
        _device_chaos[:] = [("corrupt", corrupt)]
    else:
        _device_chaos[:] = []


def _corrupt_device_result(result: "TransferResult", mode: str) -> None:
    """Mutate a completed device fetch the way a wrong-data provider
    would: a stale page_keys chain, a token echo for someone else's
    prompt, or a slice that does not cover its claimed span."""
    header = result.header
    if mode == "page_keys" and header.get("page_keys"):
        keys = list(header["page_keys"])
        keys[-1] = format(int(keys[-1], 16) ^ 0x1, "x")
        header["page_keys"] = keys
    elif mode == "tokens" and header.get("tokens"):
        toks = list(header["tokens"])
        toks[-1] = int(toks[-1]) ^ 0x1
        header["tokens"] = toks
    elif mode == "shape":
        if isinstance(result.k, (list, tuple)):
            result.k = list(result.k)[:-1]  # one segment short
        else:
            result.k = result.k[:, :-1]  # one token short


# -- transports ---------------------------------------------------------------


class TransferResult:
    """One completed fetch: the worker's header, the KV arrays (numpy on
    the http path; torch tensors on the card — possibly per-doubling-
    segment LISTS — on the device path; the prefix cache's insert handles
    all three), the path taken, and the bytes that moved."""

    __slots__ = ("header", "k", "v", "path", "nbytes")

    def __init__(self, header, k, v, path, nbytes):
        self.header = header
        self.k = k
        self.v = v
        self.path = path
        self.nbytes = int(nbytes)


def _arrays_nbytes(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(int(getattr(a, "nbytes", 0)) for a in x)
    return int(getattr(x, "nbytes", 0))


class KvTransport:
    """One way of moving a prefix-KV slice from a prefill peer. `fetch`
    raises OSError/ValueError on any failure — the DisaggClient's
    degradation machinery (backoff, failover, local prefill) is
    transport-agnostic by construction."""

    path = "?"

    def fetch(self, peer, ids, have_keys=(), trace_id=None) -> TransferResult:
        raise NotImplementedError


class DeviceKvTransport(KvTransport):
    """Same-process peer: call the registered provider directly and hand
    its tensors on the card straight to the local prefix cache — no
    socket, no host serialization. The bytes accounted are the slice's
    device bytes."""

    path = "device"

    def fetch(self, peer, ids, have_keys=(), trace_id=None) -> TransferResult:
        chaos = _device_chaos.pop() if _device_chaos else None
        if chaos is not None and chaos[0] == "raise":
            raise chaos[1]
        host, port = peer
        provider = device_peer(port)
        if provider is None:
            raise OSError(f"no same-process device peer at {host}:{port}")
        if getattr(provider, "role", None) != "prefill":
            # mirrors the HTTP path's 404 from a non-prefill replica
            raise OSError(f"device peer {host}:{port} does not serve prefill")
        header, k, v = provider.prefill_extract(
            list(ids), have_keys=tuple(have_keys), trace_id=trace_id
        )
        nbytes = _arrays_nbytes(k) + _arrays_nbytes(v)
        result = TransferResult(header, k, v, self.path, nbytes)
        if chaos is not None and chaos[0] == "corrupt":
            _corrupt_device_result(result, chaos[1])
        return result


class HttpKvTransport(KvTransport):
    """The portable fallback: POST /v1/prefill, length-prefixed binary
    payload back (the wire codec). Works across any network boundary; a
    mid-body peer death surfaces as the same OSError/ValueError family
    the device path raises."""

    path = "http"

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s

    def fetch(self, peer, ids, have_keys=(), trace_id=None) -> TransferResult:
        import http.client

        from .tracing import TRACE_HEADER

        host, port = peer
        conn = http.client.HTTPConnection(host, port, timeout=self.timeout_s)
        try:
            headers = {"Content-Type": "application/json", "Connection": "close"}
            if trace_id:
                headers[TRACE_HEADER] = trace_id
            body = {"ids": list(ids)}
            if have_keys:
                # content names of the pages this side already holds — the
                # worker ships only what the names don't cover
                body["have"] = [format(int(h), "x") for h in have_keys]
            conn.request(
                "POST", "/v1/prefill", body=json.dumps(body), headers=headers
            )
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status != 200:
                raise OSError(f"/v1/prefill returned {resp.status}")
        finally:
            conn.close()
        header, k, v = parse_kv_payload(raw)
        return TransferResult(header, k, v, self.path, len(raw))


def build_transports(timeout_s: float) -> dict:
    """The per-process transport instances a DisaggClient selects from."""
    return {
        "device": DeviceKvTransport(),
        "http": HttpKvTransport(timeout_s),
    }


def transport_for(mode: str, peer, transports: dict) -> KvTransport:
    """Pick the transport for ONE peer under `mode`: explicit modes are
    absolute; ``auto`` takes the device path exactly when the peer is
    registered in this process."""
    if mode == "device":
        return transports["device"]
    if mode == "http":
        return transports["http"]
    _, port = peer
    return transports["device"] if device_peer(port) is not None else transports["http"]
