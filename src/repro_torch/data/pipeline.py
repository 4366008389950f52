"""Data pipeline: synthetic LM corpora and byte-tokenised file corpora,
batched into fixed-length rows.

A numpy copy of the reference's pipeline (the same generators drawn in the
same order, so one config and seed give the same tokens as
`repro.data.pipeline`); batches come out as {"tokens": int32 tensor} on
`device` (default cuda).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    kind: str = "synthetic"     # synthetic | bytes
    path: Optional[str] = None  # for kind="bytes"


class SyntheticCorpus:
    """Order-1 Markov chain over a Zipf vocabulary — learnable structure."""

    def __init__(self, vocab_size: int, seed: int = 0, branching: int = 8):
        rng = np.random.default_rng(seed)
        self.vocab = vocab_size
        # each token has `branching` likely successors
        self.successors = rng.integers(0, vocab_size, (vocab_size, branching))
        zipf = 1.0 / np.arange(1, vocab_size + 1) ** 1.1
        self.unigram = zipf / zipf.sum()
        self.branching = branching

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.int32)
        tok = int(rng.choice(self.vocab, p=self.unigram))
        for i in range(n):
            out[i] = tok
            if rng.random() < 0.8:      # follow the chain
                tok = int(self.successors[tok, rng.integers(self.branching)])
            else:                        # jump via unigram
                tok = int(rng.choice(self.vocab, p=self.unigram))
        return out


def _batch(toks: np.ndarray, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {"tokens": torch.from_numpy(toks.astype(np.int32)).to(dev)}


def synthetic_batches(cfg: DataConfig, device: DeviceLike = None
                      ) -> Iterator[Dict[str, torch.Tensor]]:
    dev = resolve_device(device)     # raises now, not at the first batch
    corpus = SyntheticCorpus(cfg.vocab_size, cfg.seed)
    rng = np.random.default_rng(cfg.seed + 1)

    def rows():
        while True:
            toks = np.stack([corpus.sample(rng, cfg.seq_len)
                             for _ in range(cfg.batch_size)])
            yield _batch(toks, dev)
    return rows()


def byte_batches(cfg: DataConfig, device: DeviceLike = None
                 ) -> Iterator[Dict[str, torch.Tensor]]:
    """Byte-level tokens from a text file, packed into fixed-length rows."""
    assert cfg.path, "byte corpus needs a path"
    dev = resolve_device(device)
    with open(cfg.path, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
    if cfg.vocab_size < 256:
        data = data % cfg.vocab_size
    rng = np.random.default_rng(cfg.seed)
    n = len(data) - cfg.seq_len - 1
    if n <= 0:
        raise ValueError("corpus shorter than seq_len")

    def rows():
        while True:
            starts = rng.integers(0, n, cfg.batch_size)
            toks = np.stack([data[s: s + cfg.seq_len] for s in starts])
            yield _batch(toks, dev)
    return rows()


def make_data_iter(cfg: DataConfig, device: DeviceLike = None
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    if cfg.kind == "synthetic":
        return synthetic_batches(cfg, device)
    if cfg.kind == "bytes":
        return byte_batches(cfg, device)
    raise ValueError(cfg.kind)
