"""Deterministic, restartable data pipeline: a copy of the reference
``data/pipeline.py`` (numpy only), so a batch equals the reference's for the
same ``(seed, step, host_id)``.  Batches are numpy arrays; the trainer moves
them to the device.

Two sources:
  * ``SyntheticLM`` — a seeded synthetic token stream with learnable structure
    (Zipf unigrams + a deterministic bigram rule on half the positions) so
    training-loss curves are meaningful offline.
  * ``TokenFileSource`` — memory-mapped .bin of uint16/uint32 token ids.

Restart semantics: the stream is a pure function of (seed, step) — the
checkpoint stores ``step`` and the pipeline resumes exactly-once with no
state files.  Sharding: every host materializes only its slice of the
global batch (``host_slice``), which is how a 1000-node input pipeline
avoids redundant IO.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_codebooks: int = 0          # musicgen-style (B, K, S) batches
    vlm_patches: int = 0          # qwen2-vl stub: prepended patch embeddings
    d_model: int = 0

    def batch_at(self, step: int, *, host_id: int = 0, n_hosts: int = 1) -> Dict:
        """Deterministic batch for ``step`` (host-sliced)."""
        assert self.global_batch % n_hosts == 0
        b_local = self.global_batch // n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host_id]))
        shape = ((b_local, self.n_codebooks, self.seq_len)
                 if self.n_codebooks else (b_local, self.seq_len))
        # Zipf-ish unigram distribution
        ranks = np.arange(1, self.vocab_size + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(self.vocab_size, size=shape, p=probs)
        # deterministic bigram structure: even positions predict odd ones
        if self.n_codebooks:
            toks[..., 1::2] = (toks[..., 0::2] * 7 + 3) % self.vocab_size
        else:
            toks[:, 1::2] = (toks[:, 0::2] * 7 + 3) % self.vocab_size
        batch = {"tokens": toks.astype(np.int32)}
        if self.vlm_patches:
            batch["extra_embeds"] = rng.normal(
                0, 1, (b_local, self.vlm_patches, self.d_model)
            ).astype(np.float32)
            s_total = self.seq_len + self.vlm_patches
            pos3 = np.broadcast_to(
                np.arange(s_total, dtype=np.int32)[None, :, None],
                (b_local, s_total, 3)).copy()
            batch["pos3"] = pos3
        return batch

    def stream(self, start_step: int = 0, **kw) -> Iterator[Dict]:
        step = start_step
        while True:
            yield self.batch_at(step, **kw)
            step += 1


@dataclasses.dataclass
class TokenFileSource:
    """Memory-mapped flat token file; deterministic strided sampling."""

    path: str
    vocab_size: int
    seq_len: int
    global_batch: int
    dtype: str = "uint16"
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")

    def batch_at(self, step: int, *, host_id: int = 0, n_hosts: int = 1) -> Dict:
        b_local = self.global_batch // n_hosts
        n_tok = len(self._data) - self.seq_len - 1
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host_id]))
        starts = rng.integers(0, n_tok, size=(b_local,))
        toks = np.stack([self._data[s:s + self.seq_len] for s in starts])
        return {"tokens": toks.astype(np.int32) % self.vocab_size}


def make_source(cfg, shape, seed: int = 0, path: Optional[str] = None):
    if path:
        return TokenFileSource(path, cfg.vocab_size, shape.seq_len,
                               shape.global_batch, seed=seed)
    return SyntheticLM(
        cfg.vocab_size, shape.seq_len, shape.global_batch, seed=seed,
        n_codebooks=cfg.n_codebooks if cfg.frontend == "audio_codebooks" else 0,
        vlm_patches=256 if cfg.frontend == "vision_stub" else 0,
        d_model=cfg.d_model)
