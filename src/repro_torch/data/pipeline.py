"""Deterministic synthetic LM data pipeline.

Tokens are a counter-mode hash of (stream_id, step, position) — fully
deterministic, so checkpoint/restore resumes the exact stream (bitwise
training-resume tests rely on this), and each data-parallel host slices its
own rows without coordination.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.config import ModelConfig, ShapeConfig


class ByteTokenizer:
    """UTF-8 bytes + specials; vocab 259."""

    PAD, BOS, EOS = 256, 257, 258
    vocab_size = 259

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32)

    def decode(self, tokens) -> str:
        b = bytes(int(t) for t in tokens if int(t) < 256)
        return b.decode("utf-8", errors="replace")


def _hash_tokens(stream: int, step: int, rows: int, cols: int, vocab: int,
                 row_offset: int = 0) -> np.ndarray:
    """splitmix64 counter hash -> (rows, cols) int32 tokens in [0, vocab)."""
    with np.errstate(over="ignore"):  # wrapping uint64 hash, intentional
        r = np.arange(row_offset, row_offset + rows, dtype=np.uint64)[:, None]
        c = np.arange(cols, dtype=np.uint64)[None, :]
        x = (
            np.uint64(stream) * np.uint64(0x9E3779B97F4A7C15)
            + np.uint64(step) * np.uint64(0xBF58476D1CE4E5B9)
            + r * np.uint64(0x94D049BB133111EB)
            + c
        )
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
        return (x % np.uint64(vocab)).astype(np.int32)


@dataclass
class SyntheticLMData:
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    host_index: int = 0
    num_hosts: int = 1

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Global batch for `step` (host-sliced rows)."""
        assert self.global_batch % self.num_hosts == 0
        rows = self.global_batch // self.num_hosts
        off = self.host_index * rows
        cfg = self.cfg
        out: Dict[str, np.ndarray] = {}
        if cfg.input_mode == "embeddings":
            tok = _hash_tokens(self.seed, step, rows, self.seq_len + 1, 1 << 16, off)
            emb = (tok[:, :-1, None] % 997).astype(np.float32) / 997.0
            out["embeddings"] = np.broadcast_to(
                emb, (rows, self.seq_len, cfg.d_model)
            ).astype(np.float32)
            out["labels"] = tok[:, 1:] % cfg.vocab_size
        elif cfg.input_mode == "tokens+image":
            n_img = cfg.num_image_tokens
            tok = _hash_tokens(self.seed, step, rows, self.seq_len + 1, cfg.vocab_size, off)
            out["tokens"] = tok[:, : self.seq_len - n_img]
            img = _hash_tokens(self.seed + 1, step, rows, n_img, 1 << 16, off)
            out["image_embeds"] = np.repeat(
                (img[..., None] % 499).astype(np.float32) / 499.0, cfg.d_model, -1
            )
            labels = tok[:, 1:]
            labels = np.concatenate(
                [np.full((rows, n_img), -1, np.int32),
                 labels[:, : self.seq_len - n_img]], axis=1,
            )
            out["labels"] = labels
        else:
            tok = _hash_tokens(self.seed, step, rows, self.seq_len + 1,
                               cfg.vocab_size, off)
            out["tokens"] = tok[:, :-1]
            out["labels"] = tok[:, 1:]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
