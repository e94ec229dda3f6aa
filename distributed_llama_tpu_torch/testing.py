"""Synthetic tiny-model generators for tests, demos, and benchmarks.

No real checkpoints ship with the repo, so tests build miniature but fully
structurally-faithful `.m` / `.t` files (same header keys, walk order, quant
formats as the reference converter emits) and run the whole stack on them.
"""

from __future__ import annotations

import numpy as np

from .formats import mfile
from .formats.mfile import ArchType, HiddenAct, MFileWriter, ModelHeader, RopeType, tensor_walk
from .formats.quants import FloatType
from .formats.tfile import TokenizerData, write_tfile


def tiny_header(
    arch: int = ArchType.LLAMA,
    dim: int = 64,
    hidden_dim: int = 160,
    n_layers: int = 3,
    n_heads: int = 4,
    n_kv_heads: int = 2,
    vocab_size: int = 256,
    seq_len: int = 128,
    head_dim: int = 0,
    n_experts: int = 0,
    n_active_experts: int = 0,
    moe_hidden_dim: int = 0,
    rope_type: int = RopeType.LLAMA,
    rope_theta: float = 10000.0,
    weight_type: int = FloatType.Q40,
    rope_scaling_factor: float = 1.0,
    # llama-3.1 wavelength-dependent scaling knobs (only written to the
    # header when rope_scaling_factor != 1.0, matching the converter; the
    # .m header stores them as int32, so integral values only). Defaults
    # are the llama-3.1 release values (factor 8 / low 1 / high 4 / 8192).
    rope_scaling_low_freq_factor: float = 1.0,
    rope_scaling_high_freq_factor: float = 4.0,
    rope_scaling_orig_max_seq_len: int = 8192,
) -> ModelHeader:
    h = ModelHeader(
        version=1,
        arch_type=arch,
        dim=dim,
        hidden_dim=hidden_dim,
        moe_hidden_dim=moe_hidden_dim,
        n_layers=n_layers,
        n_heads=n_heads,
        n_kv_heads=n_kv_heads,
        n_experts=n_experts,
        n_active_experts=n_active_experts,
        vocab_size=vocab_size,
        seq_len=seq_len,
        hidden_act=HiddenAct.SILU,
        rope_theta=rope_theta,
        rope_type=rope_type,
        rope_scaling_factor=rope_scaling_factor,
        rope_scaling_low_freq_factor=rope_scaling_low_freq_factor,
        rope_scaling_high_freq_factor=rope_scaling_high_freq_factor,
        rope_scaling_orig_max_seq_len=rope_scaling_orig_max_seq_len,
        norm_epsilon=1e-5,
        weight_type=weight_type,
        head_dim=head_dim,
    )
    return h.finalize()


def header_kv(h: ModelHeader) -> dict[int, int]:
    """Header key/value pairs as the converter would emit them (all int32)."""
    kv = {
        mfile.K_VERSION: 1,
        mfile.K_ARCH_TYPE: h.arch_type,
        mfile.K_DIM: h.dim,
        mfile.K_HIDDEN_DIM: h.hidden_dim,
        mfile.K_N_LAYERS: h.n_layers,
        mfile.K_N_HEADS: h.n_heads,
        mfile.K_N_KV_HEADS: h.n_kv_heads,
        mfile.K_N_EXPERTS: h.n_experts,
        mfile.K_N_ACTIVE_EXPERTS: h.n_active_experts,
        mfile.K_VOCAB_SIZE: h.vocab_size,
        mfile.K_SEQ_LEN: h.orig_seq_len or h.seq_len,
        mfile.K_HIDDEN_ACT: h.hidden_act,
        mfile.K_ROPE_THETA: int(h.rope_theta),
        mfile.K_WEIGHT_FLOAT_TYPE: h.weight_type,
        mfile.K_ROPE_TYPE: h.rope_type,
        mfile.K_HEAD_DIM: h.head_dim,
        mfile.K_NORM_EPSILON: 5 if abs(h.norm_epsilon - 1e-5) < 1e-9 else 6,
    }
    if h.rope_scaling_factor != 1.0:
        kv[mfile.K_ROPE_SCALING_FACTOR] = int(h.rope_scaling_factor)
        kv[mfile.K_ROPE_SCALING_LOW_FREQ_FACTOR] = int(h.rope_scaling_low_freq_factor)
        kv[mfile.K_ROPE_SCALING_HIGH_FREQ_FACTORY] = int(h.rope_scaling_high_freq_factor)
        kv[mfile.K_ROPE_SCALING_ORIG_MAX_SEQ_LEN] = h.rope_scaling_orig_max_seq_len
    if h.moe_hidden_dim:
        kv[mfile.K_MOE_HIDDEN_DIM] = h.moe_hidden_dim
    return kv


_NORM_ROLES = ("norm0", "norm1", "final_norm", "q_norm", "k_norm")


def write_tiny_model(path: str, h: ModelHeader, seed: int = 0, scale: float = 0.05) -> ModelHeader:
    """Write a random-weight .m file for ``h``; returns the header re-read back."""
    rng = np.random.default_rng(seed)
    # Recompute the walk against a header whose header_bytes matches what the
    # writer will emit, so offsets line up.
    kv = header_kv(h)
    h.header_bytes = 8 + len(kv) * 8
    with MFileWriter(path, kv) as w:
        for spec in tensor_walk(h):
            if spec.role in _NORM_ROLES:
                x = 1.0 + rng.standard_normal(spec.shape).astype(np.float32) * 0.01
            else:
                x = rng.standard_normal(spec.shape).astype(np.float32) * scale
            w.write_tensor(x, spec.float_type)
    return h


def write_random_q40_model(path: str, h: ModelHeader, seed: int = 0, scale: float = 0.05) -> ModelHeader:
    """Write a random-weight .m file for a Q40 header ``h`` fast, for
    full-width models: every Q40 tensor is random block bytes in the file's
    layout (an f16 scale uniform in [0.004, 0.02), then 16 bytes of random
    nibbles), streamed tensor by tensor from numpy's Generator without ever
    making f32 weights. f32 tensors are drawn as `write_tiny_model` draws
    them (norms 1 + 0.01 N(0, 1), the rest `scale` N(0, 1)), in f32."""
    if h.weight_type != FloatType.Q40:
        raise ValueError("write_random_q40_model writes Q40 models only")
    rng = np.random.default_rng(seed)
    kv = header_kv(h)
    h.header_bytes = 8 + len(kv) * 8
    with MFileWriter(path, kv) as w:
        for spec in tensor_walk(h):
            if spec.float_type == FloatType.Q40:
                n_blocks = spec.n_elements // 32
                scales = (rng.random(n_blocks, dtype=np.float32) * 0.016 + 0.004).astype(np.float16)
                blocks = np.empty((n_blocks, 18), dtype=np.uint8)
                blocks[:, :2] = scales.view(np.uint8).reshape(n_blocks, 2)
                blocks[:, 2:] = np.frombuffer(rng.bytes(n_blocks * 16), dtype=np.uint8).reshape(n_blocks, 16)
                w.write_raw(blocks)
            elif spec.role in _NORM_ROLES:
                w.write_tensor(1.0 + rng.standard_normal(spec.shape, dtype=np.float32) * 0.01, spec.float_type)
            else:
                w.write_tensor(rng.standard_normal(spec.shape, dtype=np.float32) * scale, spec.float_type)
    return h


def _vocab_tokenizer(
    base_vocab: list[bytes],
    n_special: int = 3,
    chat_template: str | None = None,
    pad_to: int = 0,
    filler: str = "<pad{}>",
) -> TokenizerData:
    """Shared BPE fixture scaffolding: `base_vocab` single-unit tokens, a few
    merged words (so BPE has something to do), bos + specials after the
    regular vocab (mirroring the reference's layout assumption that ``bos_id``
    splits regular from special vocab), then filler tokens up to ``pad_to`` so
    any sampled id stays decodable."""
    vocab = list(base_vocab)
    scores = [0.0] * len(vocab)
    for word, sc in ((b"he", 1.0), (b"ll", 1.1), (b"hell", 2.0), (b"hello", 3.0), (b" wo", 1.2), (b"world", 3.0)):
        vocab.append(word)
        scores.append(sc)
    bos_id = len(vocab)
    specials = [b"<s>", b"</s>", b"<|eot|>"] + [f"<sp{i}>".encode() for i in range(max(0, n_special - 3))]
    vocab += specials
    scores += [0.0] * len(specials)
    while pad_to > len(vocab):
        vocab.append(filler.format(len(vocab)).encode())
        scores.append(0.0)
    return TokenizerData(
        vocab=vocab,
        scores=scores,
        bos_id=bos_id,
        eos_token_ids=[bos_id + 1, bos_id + 2],
        add_bos=True,
        chat_template=chat_template,
        max_token_length=max(len(v) for v in vocab),
    )


def byte_vocab_tokenizer(
    n_special: int = 8, chat_template: str | None = None, pad_to: int = 0
) -> TokenizerData:
    """A 256-byte-vocabulary tokenizer plus a few special tokens — any byte
    string encodes; decoding may produce raw/invalid UTF-8."""
    return _vocab_tokenizer(
        [bytes([i]) for i in range(256)], n_special, chat_template, pad_to
    )


def ascii_vocab_tokenizer(pad_to: int = 0, chat_template: str | None = None) -> TokenizerData:
    """A printable-ASCII vocabulary: every token decodes to a unique printable
    piece with no raw bytes, so a decoded stream maps back to token ids
    unambiguously."""
    return _vocab_tokenizer(
        [bytes([i]) for i in range(32, 127)], 3, chat_template, pad_to,
        filler="<f{:04d}>",
    )


def write_tiny_tokenizer(path: str, **kw) -> TokenizerData:
    t = byte_vocab_tokenizer(**kw)
    write_tfile(path, t)
    return t
