"""Tokenizer, sampler, and stop-sequence detection.

Re-implements the reference's capability surface (reference:
src/tokenizer.{hpp,cpp}) in Python:

* score-based BPE encode with first-match-in-vocab-order special-token
  matching (same lookup order as the reference's findSpecialTokenStartWith)
  and best-pair merging (reference: tokenizer.cpp:311-390);
* UTF-8-safe streaming decoder that holds back incomplete multi-byte
  sequences between tokens (reference: tokenizer.cpp:225-289);
* chat templates (llama2, llama3, deepSeek3, chatml; reference:
  tokenizer.cpp:549-637);
* multi-token stop-sequence ("EOS") detector (reference: tokenizer.cpp:639-725);
* sampler: argmax / multinomial / top-p with the same xorshift* RNG so seeded
  runs are reproducible against the reference (reference: tokenizer.cpp:25-36,
  426-512).

The host `Sampler` is the reference's bit-parity sampled path; the engine's
chunked decode samples on the device (ops/sampling.py). This is a copy of the
JAX package's tokenizer with the Python BPE merge loop only (no native
merge engine), so the port imports nothing from that package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .formats.tfile import TokenizerData, read_tfile


class Tokenizer:
    def __init__(self, data: TokenizerData | str):
        if isinstance(data, str):
            data = read_tfile(data)
        self.data = data
        self.vocab: list[bytes] = data.vocab
        self.scores = data.scores
        self.bos_id = data.bos_id
        self.add_bos = data.add_bos
        self.eos_token_ids = list(data.eos_token_ids)
        self.chat_template = data.chat_template
        self.vocab_size = data.vocab_size
        # bos_id splits regular from special vocab — same (admittedly fragile)
        # assumption the reference makes (tokenizer.cpp:141-143)
        self.regular_vocab_size = data.regular_vocab_size
        self._regular_index = {
            self.vocab[i]: i for i in range(self.regular_vocab_size - 1, -1, -1)
        }
        # the special pieces by length, each piece to its first vocab index:
        # a position takes the first special in vocab order whose piece
        # starts there (the reference's findSpecialTokenStartWith), which is
        # the least index found over the lengths. One dict probe a length,
        # where a scan of every special a position cost ~1.5 s an encode on
        # a vocab padded with 128k specials (the JAX tokenizer's scan)
        by_len: dict[int, dict[bytes, int]] = {}
        for i in range(self.vocab_size - 1, self.regular_vocab_size - 1, -1):
            piece = self.vocab[i]
            if piece:
                by_len.setdefault(len(piece), {})[piece] = i
        self._special_by_len = sorted(by_len.items())
        self._decode_buf = b""

    # -- encode ------------------------------------------------------------

    def encode(
        self, text: str | bytes, is_start: bool = True, add_special_tokens: bool = True
    ) -> list[int]:
        if isinstance(text, str):
            text = text.encode("utf-8")
        tokens: list[int] = []
        if is_start and self.add_bos and self.bos_id >= 0:
            tokens.append(self.bos_id)

        # greedy pass: match special tokens at each position, otherwise
        # accumulate bytes until they hit a regular vocab entry
        i = 0
        pending = b""
        while i < len(text):
            if add_special_tokens and not pending:
                matched = -1
                for n, pieces in self._special_by_len:
                    tid = pieces.get(text[i : i + n])
                    if tid is not None and (matched < 0 or tid < matched):
                        matched = tid
                if matched >= 0:
                    tokens.append(matched)
                    i += len(self.vocab[matched])
                    continue
            pending += text[i : i + 1]
            i += 1
            tid = self._regular_index.get(pending)
            if tid is not None:
                tokens.append(tid)
                pending = b""
        if pending:
            raise ValueError(f"cannot tokenize bytes {pending!r} (not in vocab)")

        return self._merge_py(tokens)

    def _merge_py(self, tokens: list[int]) -> list[int]:
        # Merge the best-scoring adjacent pair until no pair merges. Same
        # leftmost-max policy as the reference, but with cached per-pair merge
        # candidates so each iteration only re-evaluates the two pairs touched
        # by the previous merge (the reference rescans + re-concats every pair
        # every iteration).
        def pair_candidate(a: int, b: int):
            tid = self._regular_index.get(self.vocab[a] + self.vocab[b])
            return (self.scores[tid], tid) if tid is not None else None

        cand = [pair_candidate(tokens[j], tokens[j + 1]) for j in range(len(tokens) - 1)]
        while True:
            best_score, best_idx = -1e10, -1
            for j, c in enumerate(cand):
                if c is not None and c[0] > best_score:
                    best_score, best_idx = c[0], j
            if best_idx == -1:
                break
            tokens[best_idx : best_idx + 2] = [cand[best_idx][1]]
            del cand[best_idx]
            if best_idx < len(cand):
                cand[best_idx] = pair_candidate(tokens[best_idx], tokens[best_idx + 1])
            if best_idx > 0:
                cand[best_idx - 1] = pair_candidate(tokens[best_idx - 1], tokens[best_idx])
        return tokens

    # -- streaming decode --------------------------------------------------

    def reset_decoder(self):
        self._decode_buf = b""

    def stream_decoder(self) -> "StreamDecoder":
        """An INDEPENDENT streaming-decode state over this tokenizer's vocab
        — batch serving gives each concurrent row its own UTF-8 carry
        buffer instead of sharing the tokenizer's."""
        return StreamDecoder(self)

    def decode(self, token: int) -> str | None:
        """Streaming decode: returns printable text or None if the token only
        extended an incomplete UTF-8 sequence (or was bos/eos). Uses the
        tokenizer's own carry buffer (single-sequence use); see
        `stream_decoder` for independent per-row state."""
        out, self._decode_buf = _decode_step(self, self._decode_buf, token)
        return out

    def is_eos(self, token: int) -> bool:
        return token in self.eos_token_ids

    def piece(self, token: int) -> bytes:
        return self.vocab[token]


def _decode_step(tok: "Tokenizer", buf: bytes, token: int):
    """One streaming-decode step: (text|None, new_buf)."""
    if token == tok.bos_id:
        return None, buf
    if token in tok.eos_token_ids:
        if buf:
            return buf.decode("utf-8", errors="replace"), b""
        return None, buf
    buf = buf + tok.vocab[token]
    # find the longest prefix that is complete UTF-8
    cut = len(buf)
    # walk back over at most 3 trailing continuation-or-lead bytes
    for back in range(1, min(4, len(buf)) + 1):
        b = buf[-back]
        if b < 0x80:
            break  # ascii: everything is complete
        if b >= 0xC0:  # lead byte: is the sequence complete?
            need = 2 if b < 0xE0 else 3 if b < 0xF0 else 4
            if back < need:
                cut = len(buf) - back  # incomplete, hold back
            break
    if cut == 0:
        return None, buf
    out, buf = buf[:cut], buf[cut:]
    return (out.decode("utf-8", errors="replace") or None), buf


class StreamDecoder:
    """Per-row streaming decoder sharing a Tokenizer's vocab."""

    def __init__(self, tok: Tokenizer):
        self._tok = tok
        self._buf = b""

    def decode(self, token: int) -> str | None:
        out, self._buf = _decode_step(self._tok, self._buf, token)
        return out


# ---------------------------------------------------------------------------
# Sampler
# ---------------------------------------------------------------------------

def _random_u32(state: np.uint64) -> tuple[int, np.uint64]:
    # xorshift* identical to the reference (tokenizer.cpp:25-31)
    s = int(state)
    s ^= (s >> 12) & 0xFFFFFFFFFFFFFFFF
    s = (s ^ (s << 25)) & 0xFFFFFFFFFFFFFFFF
    s ^= s >> 27
    r = ((s * 0x2545F4914F6CDD1D) & 0xFFFFFFFFFFFFFFFF) >> 32
    return r, np.uint64(s)


class Sampler:
    """Temperature + softmax + top-p / argmax sampling on a host logits vector
    (reference: tokenizer.cpp:449-512)."""

    def __init__(self, vocab_size: int, temperature: float, topp: float, seed: int):
        self.vocab_size = vocab_size
        self.temperature = temperature
        self.topp = topp
        self._state = np.uint64(seed if seed != 0 else 0x9E3779B97F4A7C15)

    def set_temp(self, temperature: float):
        self.temperature = temperature

    def set_seed(self, seed: int):
        self._state = np.uint64(seed if seed != 0 else 0x9E3779B97F4A7C15)

    def _coin(self) -> float:
        r, self._state = _random_u32(self._state)
        return (r >> 8) / 16777216.0

    def sample(self, logits: np.ndarray) -> int:
        logits = np.asarray(logits, dtype=np.float32).reshape(-1)[: self.vocab_size]
        if self.temperature == 0.0:
            return int(np.argmax(logits))
        x = logits / self.temperature
        x = x - x.max()
        probs = np.exp(x)
        probs /= probs.sum()
        coin = self._coin()
        if self.topp <= 0 or self.topp >= 1:
            cdf = np.cumsum(probs)
            return int(np.searchsorted(cdf, coin, side="right").clip(0, self.vocab_size - 1))
        return self._sample_topp(probs, coin)

    def _sample_topp(self, probs: np.ndarray, coin: float) -> int:
        n = probs.size
        cutoff = (1.0 - self.topp) / max(n - 1, 1)
        idx = np.nonzero(probs >= cutoff)[0]
        order = idx[np.argsort(-probs[idx], kind="stable")]
        p = probs[order]
        csum = np.cumsum(p)
        over = np.nonzero(csum > self.topp)[0]
        last = over[0] if over.size else p.size - 1
        r = coin * csum[last]
        pick = np.searchsorted(csum[: last + 1], r, side="right")
        return int(order[min(pick, last)])


# ---------------------------------------------------------------------------
# Chat templates
# ---------------------------------------------------------------------------

TEMPLATE_UNKNOWN = 0
TEMPLATE_LLAMA2 = 1
TEMPLATE_LLAMA3 = 2
TEMPLATE_DEEP_SEEK3 = 3
TEMPLATE_CHATML = 4

_TEMPLATE_NAMES = {
    "llama2": TEMPLATE_LLAMA2,
    "llama3": TEMPLATE_LLAMA3,
    "deepSeek3": TEMPLATE_DEEP_SEEK3,
    "chatml": TEMPLATE_CHATML,
}


@dataclass
class ChatItem:
    role: str
    message: str


@dataclass
class GeneratedChat:
    content: str
    public_prompt: str | None = None


class ChatTemplateGenerator:
    """Renders chat turns into the model's prompt format, auto-detecting the
    dialect from the HF template string when not forced
    (reference: tokenizer.cpp:549-637)."""

    def __init__(self, type_: int = TEMPLATE_UNKNOWN, chat_template: str | None = None, eos: str = ""):
        if type_ == TEMPLATE_UNKNOWN:
            if not chat_template:
                raise ValueError("the tokenizer does not include chat template")
            if "[INST]" in chat_template:
                type_ = TEMPLATE_LLAMA2
            elif "<|start_header_id|>" in chat_template:
                type_ = TEMPLATE_LLAMA3
            elif "<｜Assistant｜>" in chat_template:
                type_ = TEMPLATE_DEEP_SEEK3
            elif "<|im_start|>" in chat_template:
                type_ = TEMPLATE_CHATML
            else:
                raise ValueError("not supported chat template")
        self.type = type_
        self.eos = eos

    @staticmethod
    def parse_type(name: str) -> int:
        if name in _TEMPLATE_NAMES:
            return _TEMPLATE_NAMES[name]
        raise ValueError(f"unknown chat template {name!r}")

    def generate(self, items: list[ChatItem], append_generation_prompt: bool = True) -> GeneratedChat:
        buf = []
        public_prompt = None
        eos = self.eos
        if self.type == TEMPLATE_LLAMA2:
            i = 0
            if len(items) >= 2 and items[0].role == "system" and items[1].role == "user":
                buf.append(
                    "[INST] <<SYS>>\n" + items[0].message + "\n<</SYS>>\n\n" + items[1].message + " [/INST]" + eos
                )
                i = 2
            for it in items[i:]:
                if it.role == "assistant":
                    buf.append(it.message + eos)
                elif it.role == "user":
                    buf.append("[INST] " + it.message + " [/INST]" + eos)
        elif self.type == TEMPLATE_LLAMA3:
            for it in items:
                buf.append("<|start_header_id|>" + it.role + "<|end_header_id|>\n\n" + it.message + eos)
            if append_generation_prompt:
                buf.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        elif self.type == TEMPLATE_DEEP_SEEK3:
            i = 0
            if items and items[0].role == "system":
                buf.append(items[0].message)
                i = 1
            for it in items[i:]:
                if it.role == "user":
                    buf.append("<｜User｜>" + it.message)
                elif it.role == "assistant":
                    buf.append("<｜Assistant｜>" + it.message)
            if append_generation_prompt:
                buf.append("<｜Assistant｜><think>\n")
                public_prompt = "<think>\n"
        elif self.type == TEMPLATE_CHATML:
            # the reference appends the generation prompt inside its per-item
            # loop (tokenizer.cpp:624-634), a malformed ChatML prompt; the
            # JAX package emits it once, at the end, and so does this copy
            for it in items:
                if it.role in ("system", "user", "assistant"):
                    buf.append("<|im_start|>" + it.role + "\n" + it.message + "<|im_end|>\n")
            if append_generation_prompt:
                buf.append("<|im_start|>assistant\n")
        return GeneratedChat("".join(buf), public_prompt)


# ---------------------------------------------------------------------------
# EOS / stop-sequence detector
# ---------------------------------------------------------------------------

EOS_NOT = 0
EOS_MAYBE = 1
EOS_FOUND = 2


class EosDetector:
    """Detects multi-token stop sequences in streamed text, buffering output
    that might be the beginning of a stop string
    (reference: tokenizer.cpp:639-725).

    ``padding_left``/``padding_right`` allow the stop string to appear with up
    to that many stray characters before/after it in the buffered window.
    """

    def __init__(self, stop_token_ids: list[int], stop_pieces: list[str], padding_left: int = 0, padding_right: int = 0):
        self.stop_token_ids = list(stop_token_ids)
        self.pieces = [p for p in stop_pieces if p]
        self.padding_left = padding_left
        self.padding_right = padding_right
        self._buf = ""
        self._eos_pos = -1

    def is_eos_token(self, token_id: int) -> bool:
        return token_id in self.stop_token_ids

    def append(self, token_id: int, piece: str | None) -> int:
        if piece:
            self._buf += piece
        if self.is_eos_token(token_id):
            self._eos_pos = len(self._buf)
            return EOS_FOUND
        self._eos_pos = -1
        for p in self.pieces:
            if len(self._buf) > len(p) + self.padding_left + self.padding_right:
                continue
            for lo in range(self.padding_left + 1):
                n = len(self._buf) - lo
                if n <= 0 or n > len(p) + self.padding_right:
                    continue
                n = min(n, len(p))
                if self._buf[lo : lo + n] == p[:n]:
                    if n == len(p):
                        self._eos_pos = lo
                        self._buf = self._buf[:lo]
                        return EOS_FOUND
                    return EOS_MAYBE
        return EOS_NOT

    def get_delta(self) -> str | None:
        """Text that is now safe to emit (call after append returns NOT_EOS or
        FOUND); None if nothing to emit."""
        if not self._buf:
            return None
        if self._eos_pos == 0:
            return None
        return self._buf

    def reset(self):
        self._buf = ""
        self._eos_pos = -1
