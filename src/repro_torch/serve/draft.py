"""Draft sources for speculative decoding (draft-then-verify).

A copy of the reference package's draft sources (numpy only; the port keeps
its own so it never imports the JAX package).  A :class:`DraftSource`
proposes up to ``k`` candidate next tokens per decode slot per tick; the
engine runs ONE multi-row verify forward over ``[last_token, d_1, ...,
d_n]`` per slot and greedily accepts the longest prefix whose proposals
match the argmax chain.  Because acceptance is exact argmax matching,
speculative decoding gives the tokens of plain greedy decode.

* :class:`PromptLookupDraft` — model-free prompt-lookup decoding (n-gram
  continuation): find the longest suffix of the context that reoccurs
  earlier in the context, propose the tokens that followed the earlier
  occurrence.
* :class:`SequenceDraft` — replay proposals from known full sequences
  (prompt + continuation): a controllable oracle for tests and for timing
  the verifier at a pinned acceptance rate.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


class DraftSource:
    """Interface: propose up to ``k`` next tokens for one slot's context.

    ``context`` is the slot's full token history (prompt + emitted so far)
    as a 1-D int array; the return value is a list of 0..k proposed next
    tokens.  Returning fewer than ``k`` (including none) is always legal —
    the engine verifies whatever is proposed and falls back to plain decode
    for slots with no proposals.  ``propose`` must be a pure function of
    ``context``: the engine may discard the result (a slot preempted before
    its verify forward runs)."""

    def propose(self, context: np.ndarray, k: int) -> List[int]:
        raise NotImplementedError


class PromptLookupDraft(DraftSource):
    """Prompt-lookup decoding: the longest suffix n-gram of the context
    (lengths ``max_ngram`` down to ``min_ngram``) that also occurs earlier
    in it; proposes up to ``k`` tokens following its most recent earlier
    occurrence."""

    def __init__(self, min_ngram: int = 1, max_ngram: int = 3):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got {min_ngram}..{max_ngram}")
        self.min_ngram = min_ngram
        self.max_ngram = max_ngram

    def propose(self, context: np.ndarray, k: int) -> List[int]:
        ctx = np.asarray(context).ravel()
        n = len(ctx)
        if k <= 0 or n < self.min_ngram + 1:
            return []
        for ng in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            suffix = ctx[n - ng:]
            # earlier occurrences (windows strictly before the suffix), most recent first
            starts = np.flatnonzero(ctx[:n - ng] == suffix[0])
            for s in starts[::-1]:
                if np.array_equal(ctx[s:s + ng], suffix):
                    cont = ctx[s + ng:s + ng + k]
                    if len(cont):
                        return [int(t) for t in cont]
        return []


class SequenceDraft(DraftSource):
    """Oracle/replay draft: propose the continuation of a known sequence
    whose prefix equals the context.  Built from a plain-decode run's
    sequences it is accepted 100 %."""

    def __init__(self, sequences: Sequence[Sequence[int]] = ()):
        self._seqs = [np.asarray(s, dtype=np.int64).ravel() for s in sequences]

    def add(self, sequence: Sequence[int]):
        self._seqs.append(np.asarray(sequence, dtype=np.int64).ravel())

    def propose(self, context: np.ndarray, k: int) -> List[int]:
        ctx = np.asarray(context, dtype=np.int64).ravel()
        n = len(ctx)
        if k <= 0:
            return []
        for seq in self._seqs:
            if len(seq) > n and np.array_equal(seq[:n], ctx):
                return [int(t) for t in seq[n:n + k]]
        return []


_NAMED = {"prompt_lookup": PromptLookupDraft}


def make_draft_source(spec) -> DraftSource:
    """Resolve an ``EngineConfig.draft`` value: a :class:`DraftSource`
    instance passes through; a registered name ("prompt_lookup") constructs
    the default instance."""
    if isinstance(spec, DraftSource):
        return spec
    if isinstance(spec, str):
        try:
            return _NAMED[spec]()
        except KeyError:
            raise ValueError(f"unknown draft source {spec!r}; known: {sorted(_NAMED)} or a "
                             "DraftSource instance") from None
    raise TypeError(f"draft must be a DraftSource or one of {sorted(_NAMED)}, "
                    f"got {type(spec).__name__}")
