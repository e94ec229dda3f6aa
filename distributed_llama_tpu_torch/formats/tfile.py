"""`.t` tokenizer-file codec.

Binary-compatible with the reference tokenizer format (reference:
src/tokenizer.cpp:42-166): magic ``0x567124``, int32 headerSize, (key, value)
int32 pairs, then optional chat-template bytes, optional EOS-token-id list,
then ``vocab_size`` records of ``(f32 score, int32 length, utf8 bytes)``.

The legacy magic ``0x567123`` (fixed struct header) is also accepted.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

# header keys (reference: src/tokenizer.hpp:21-33)
TOK_VERSION = 0
TOK_VOCAB_SIZE = 1
MAX_TOKEN_LENGTH = 2
BOS_ID = 3
EOS_ID = 4  # legacy: single EOS id
PAD_ID = 5  # ignored
CHAT_EOS_ID = 6  # legacy
CHAT_TEMPLATE = 7
CHAT_STOP = 8  # ignored payload
N_EOS_TOKENS = 9
ADD_BOS = 10

OLD_MAGIC = 0x567123
MAGIC = 0x567124


@dataclass
class TokenizerData:
    vocab: list  # list[bytes]
    scores: list  # list[float]
    bos_id: int = -1
    eos_token_ids: list = field(default_factory=list)
    add_bos: bool = True
    chat_template: str | None = None
    max_token_length: int = 0

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def regular_vocab_size(self) -> int:
        # The reference assumes bos_id splits regular and special vocab
        # (reference: src/tokenizer.cpp:141-143).
        return self.bos_id if self.bos_id >= 0 else self.vocab_size


def read_tfile(path: str) -> TokenizerData:
    with open(path, "rb") as f:
        data = f.read()
    (magic,) = struct.unpack_from("<i", data, 0)
    pos = 4
    t = TokenizerData(vocab=[], scores=[])
    n_eos = 0
    template_len = -1

    if magic == OLD_MAGIC:
        vocab_size, max_len, bos, eos, _pad = struct.unpack_from("<IIiii", data, pos)
        pos += 20
        t.max_token_length = max_len
        t.bos_id = bos
        t.eos_token_ids.append(eos)
        n_vocab = vocab_size
    elif magic == MAGIC:
        (header_size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        n_kv = (header_size - 8) // 4
        vals = struct.unpack_from(f"<{n_kv}i", data, pos)
        pos += n_kv * 4
        version = -1
        n_vocab = 0
        skip = 0  # CHAT_STOP payload bytes to hop over, in key order
        for i in range(0, n_kv, 2):
            key, value = vals[i], vals[i + 1]
            if key == TOK_VERSION:
                version = value
            elif key == TOK_VOCAB_SIZE:
                n_vocab = value
            elif key == MAX_TOKEN_LENGTH:
                t.max_token_length = value
            elif key == BOS_ID:
                t.bos_id = value
            elif key in (EOS_ID, CHAT_EOS_ID):
                t.eos_token_ids.append(value)
            elif key == CHAT_TEMPLATE:
                template_len = value
            elif key == CHAT_STOP:
                skip += value
            elif key == PAD_ID:
                pass
            elif key == N_EOS_TOKENS:
                n_eos = value
            elif key == ADD_BOS:
                t.add_bos = value == 1
            else:
                raise ValueError(f"invalid tokenizer header key: {key}")
        if version != 1:
            raise ValueError("old tokenizer version, please regenerate your tokenizer")
        pos += skip
        if template_len > 0:
            t.chat_template = data[pos : pos + template_len].decode("utf-8")
            pos += template_len
        for _ in range(n_eos):
            (eid,) = struct.unpack_from("<i", data, pos)
            pos += 4
            t.eos_token_ids.append(eid)
    else:
        raise ValueError("invalid tokenizer file")

    if t.max_token_length < 1:
        raise ValueError("invalid tokenizer max token length")

    for _ in range(n_vocab):
        score, length = struct.unpack_from("<fi", data, pos)
        pos += 8
        t.scores.append(score)
        t.vocab.append(data[pos : pos + length])
        pos += length
    return t


def write_tfile(path: str, t: TokenizerData) -> None:
    kv: list[tuple[int, int]] = [
        (TOK_VERSION, 1),
        (TOK_VOCAB_SIZE, t.vocab_size),
        (MAX_TOKEN_LENGTH, max(1, t.max_token_length or max((len(v) for v in t.vocab), default=1))),
        (BOS_ID, t.bos_id),
        (ADD_BOS, 1 if t.add_bos else 0),
    ]
    template_bytes = t.chat_template.encode("utf-8") if t.chat_template else b""
    if template_bytes:
        kv.append((CHAT_TEMPLATE, len(template_bytes)))
    if t.eos_token_ids:
        kv.append((N_EOS_TOKENS, len(t.eos_token_ids)))

    with open(path, "wb") as f:
        body = b"".join(struct.pack("<ii", k, v) for k, v in kv)
        f.write(struct.pack("<ii", MAGIC, 8 + len(body)))
        f.write(body)
        f.write(template_bytes)
        for eid in t.eos_token_ids:
            f.write(struct.pack("<i", eid))
        for score, word in zip(t.scores, t.vocab):
            f.write(struct.pack("<fi", score, len(word)))
            f.write(word)
