"""First-class prefix-registry subsystem: the ``PrefixStore`` protocol.

A copy of the reference package's prefix registry (pure Python; the
port keeps its own so it never imports the JAX package).  A private
registry inside ``BlockAllocator`` would leave the router no way to ask
"who already holds this prompt's pages?" and a replica no way to export
a chain it had paid to prefill.  This module makes the registry an API:

* :func:`chain_keys` — the content-addressed chained hash walk, the ONE
  definition shared by the in-allocator registry, the shared tier, and
  the router's affinity probe (``key_i = hash((key_{i-1}, page_i
  tokens))``; a page's identity is its *cumulative* prefix because K/V
  rows depend on every earlier token).
* :class:`PrefixChain` / :class:`SealedChain` — frozen value types: a
  chain of per-page keys + token segments, either bound to local pool
  page ids (``PrefixChain``) or carrying host-memory page payloads
  (``SealedChain`` — the publishable form).
* :class:`PrefixStore` — the typed protocol (``match / register / seal /
  publish / adopt``) both implementations speak.
* :class:`RegistryPrefixStore` — the default implementation: the
  allocator-owned registry, extracted.  ``BlockAllocator`` keeps the
  refcount/free-list machinery and composes one of these; the scheduler's
  ``refresh_prefix`` and spill-time registration reach the registry only
  through the allocator's thin ref-counting wrappers over this store.
* :class:`SharedPrefixTier` — a host-memory, read-only-to-consumers tier
  replicas publish sealed chains into and adopt pages from.  Adoption
  installs byte-identical page payloads into the adopter's pool and
  registers the chain locally, so downstream it is an ordinary prefix
  hit — greedy outputs stay bit-identical to a cold-registry replica
  because the adopted int8/int4 rows (and per-page scales) are exact
  copies of what the adopter would have computed itself.

Store ``match`` is READ-ONLY in both implementations: no references are
taken and no LRU state moves.  Reference counting stays where refcounts
live — ``BlockAllocator.match_prefix`` wraps ``RegistryPrefixStore
.match`` and takes the refs.  That split is what lets the router probe
every replica's registry for affinity without perturbing pool state.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterator, Mapping, Optional, Protocol, Sequence, \
    Tuple

import numpy as np


def chain_keys(tokens: Sequence[int], page_size: int, n_pages: int
               ) -> Iterator[Tuple[int, Tuple[int, ...]]]:
    """Yield ``(key, segment)`` for the first ``n_pages`` full pages of
    ``tokens``: ``key_i = hash((key_{i-1}, page_i tokens))``.  The chained
    hash gives cumulative-prefix identity in O(page_size) per page instead
    of re-hashing the whole prefix (O(L^2) over a prompt).  Lookups verify
    the page's own segment against the stored one, and the parent key is
    verified inductively by the walk, so a false hit needs a 64-bit hash
    collision AND an identical current segment."""
    key = 0
    for i in range(n_pages):
        seg = tuple(tokens[i * page_size:(i + 1) * page_size])
        key = hash((key, seg))
        yield key, seg


@dataclasses.dataclass(frozen=True)
class PrefixChain:
    """A matched/registered run of prefix pages: per-page chained keys,
    per-page token segments, and (when bound to a pool) the local page
    ids.  Frozen — stores hand these out as values, never as views into
    their internal state."""
    page_size: int
    keys: Tuple[int, ...]
    segs: Tuple[Tuple[int, ...], ...]
    pages: Tuple[int, ...] = ()           # local pool page ids; () if unbound

    @property
    def n_pages(self) -> int:
        return len(self.keys)

    @property
    def rows(self) -> int:
        return self.n_pages * self.page_size

    def tokens(self) -> list:
        """The chain's full token prefix (concatenated segments)."""
        return [t for seg in self.segs for t in seg]


@dataclasses.dataclass(frozen=True)
class SealedChain:
    """A publishable chain: keys + segments + one host array per cache
    leaf holding the chain's page payloads stacked along the pool's page
    axis (axis 1 — every paged-pool leaf, int8/int4 payload and per-page
    scale alike, is ``(n_reps, n_pages, ...)``).  ``payload[leaf][:, j]``
    is page ``j``'s slice; a page id names payload AND scales together,
    so kv4 scales travel with their pages by construction."""
    page_size: int
    keys: Tuple[int, ...]
    segs: Tuple[Tuple[int, ...], ...]
    payload: Mapping[str, np.ndarray]

    @property
    def n_pages(self) -> int:
        return len(self.keys)

    def slice(self, lo: int, hi: int) -> "SealedChain":
        """Pages ``[lo, hi)`` as a new SealedChain (payloads sliced along
        the page axis).  Used by adopters that already hold a head of the
        chain locally and only install the tail."""
        return SealedChain(
            page_size=self.page_size, keys=self.keys[lo:hi],
            segs=self.segs[lo:hi],
            payload={k: v[:, lo:hi] for k, v in self.payload.items()})


class PrefixStore(Protocol):
    """What every prefix store speaks.  ``match``/``seal`` are read-only;
    ``register`` binds a key chain to local pool pages; ``publish`` /
    ``adopt`` move payload-backed (sealed) chains.  An implementation
    without one capability returns the lawful empty result (0 pages
    stored / None) rather than raising — callers probe capabilities by
    outcome, not by type."""

    page_size: int
    version: int        # bumped on every successful register/publish

    def match(self, tokens: Sequence[int],
              max_pages: Optional[int] = None) -> PrefixChain:
        """Longest held chain covering full-page prefixes of ``tokens``
        (at most ``max_pages``).  Read-only: takes no references, moves
        no LRU state."""
        ...

    def register(self, tokens: Sequence[int],
                 pages: Sequence[int]) -> int:
        """Bind the key chain of ``tokens`` to local pool ``pages``;
        returns the number of pages newly recorded (already-known keys
        and already-bound pages are skipped)."""
        ...

    def seal(self, tokens: Sequence[int],
             max_pages: Optional[int] = None) -> PrefixChain:
        """Snapshot the longest held chain for publication (same shape as
        ``match``; named separately because sealing is the publish-side
        contract: the returned chain's pages must stay byte-stable until
        the caller has extracted their payloads)."""
        ...

    def publish(self, sealed: SealedChain) -> int:
        """Store a payload-backed chain; returns pages newly stored."""
        ...

    def adopt(self, tokens: Sequence[int],
              max_pages: Optional[int] = None) -> Optional[SealedChain]:
        """Longest payload-backed chain covering ``tokens``, ready to
        install into a pool — or None when nothing (or no payloads) are
        held."""
        ...


class RegistryPrefixStore:
    """The default ``PrefixStore``: the in-allocator chained-prefix
    registry, extracted.  Holds key->(page, segment), its page->key
    inverse, and the LRU of refcount-0 registered pages.  Reference
    counting and reclaim POLICY stay in ``BlockAllocator`` — the
    allocator drives this store through the narrow park/revive/reclaim
    surface below, and the invariant sweep runs on both sides of that
    boundary."""

    def __init__(self, page_size: int):
        assert page_size >= 1
        self.page_size = page_size
        self.version = 0
        self._cached: Dict[int, Tuple[int, tuple]] = {}
        self._key_of: Dict[int, int] = {}
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()

    # --- PrefixStore protocol -------------------------------------------

    def match(self, tokens: Sequence[int],
              max_pages: Optional[int] = None) -> PrefixChain:
        n = len(tokens) // self.page_size
        if max_pages is not None:
            n = min(n, max_pages)
        keys, segs, pages = [], [], []
        for key, seg in chain_keys(tokens, self.page_size, n):
            hit = self._cached.get(key)
            if hit is None or hit[1] != seg:
                break
            keys.append(key)
            segs.append(seg)
            pages.append(hit[0])
        return PrefixChain(self.page_size, tuple(keys), tuple(segs),
                           tuple(pages))

    def register(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        n = min(len(tokens) // self.page_size, len(pages))
        new = 0
        for (key, seg), p in zip(chain_keys(tokens, self.page_size, n),
                                 pages, strict=False):
            if key in self._cached or p in self._key_of:
                continue       # identical content already published
            self._cached[key] = (p, seg)
            self._key_of[p] = key
            self.version += 1
            new += 1
        return new

    def seal(self, tokens: Sequence[int],
             max_pages: Optional[int] = None) -> PrefixChain:
        return self.match(tokens, max_pages)

    def publish(self, sealed: SealedChain) -> int:  # noqa: ARG002 - protocol law
        return 0    # local pool pages ARE this store's storage

    def adopt(self, tokens: Sequence[int],  # noqa: ARG002 - protocol law
              max_pages: Optional[int] = None) -> Optional[SealedChain]:
        return None  # no host payloads behind a pool-bound registry

    # --- allocator-side surface (refcount integration) ------------------

    def is_registered(self, page: int) -> bool:
        return page in self._key_of

    def park(self, page: int):
        """A registered page's refcount hit 0: park it on the LRU (its
        pool content stays intact and matchable until reclaimed)."""
        self._lru[page] = None

    def revive(self, page: int):
        """A parked page was matched again: lift it off the LRU."""
        self._lru.pop(page, None)

    def pop_reclaim(self) -> Optional[int]:
        """Reclaim the oldest parked page for reuse: forget its registry
        entry and return the page id (None when nothing is parked)."""
        if not self._lru:
            return None
        p, _ = self._lru.popitem(last=False)
        del self._cached[self._key_of.pop(p)]
        return p

    @property
    def cached_count(self) -> int:
        return len(self._cached)

    @property
    def lru_count(self) -> int:
        return len(self._lru)

    @property
    def lru_pages(self) -> frozenset:
        return frozenset(self._lru)

    def check_invariants(self):
        """Registry-internal invariants (the allocator's sweep extends
        these across the refcount boundary): the key map and its
        page->key inverse are a bijection, and every LRU page is
        registered."""
        assert len(self._cached) == len(self._key_of)
        for key, (p, _seg) in self._cached.items():
            assert self._key_of.get(p) == key, \
                f"registry desync on page {p}"
        for p in self._lru:
            assert p in self._key_of, f"LRU page {p} not registered"


class SharedPrefixTier:
    """Cross-replica host-memory prefix tier (a ``PrefixStore`` whose
    pages are numpy payloads instead of pool page ids).

    Replicas publish sealed chains after a prefill completes; any replica
    can then ``adopt`` the longest matching chain and install the payload
    bytes into its own pool.  The tier is read-only to consumers — pages
    are immutable once published (a chain key names immutable content, so
    there is nothing to update) — and single-writer-at-a-time by the
    engines' synchronous tick discipline.

    Capacity is bounded: at most ``max_pages`` page payloads, evicted in
    LRU order (publish and adopt both refresh recency of the keys they
    touch).  Evicting a chain's head key strands its tail entries until
    they age out themselves — bounded waste, never a correctness issue,
    because adoption walks from key 0 and stops at the first miss."""

    def __init__(self, page_size: int, max_pages: int = 256):
        assert page_size >= 1 and max_pages >= 1
        self.page_size = page_size
        self.max_pages = max_pages
        self.version = 0
        # key -> (segment, {leaf: (n_reps, 1, ...) payload slice})
        self._entries: "collections.OrderedDict[int, Tuple[tuple, dict]]" \
            = collections.OrderedDict()

    # --- PrefixStore protocol -------------------------------------------

    def match(self, tokens: Sequence[int],
              max_pages: Optional[int] = None) -> PrefixChain:
        n = len(tokens) // self.page_size
        if max_pages is not None:
            n = min(n, max_pages)
        keys, segs = [], []
        for key, seg in chain_keys(tokens, self.page_size, n):
            hit = self._entries.get(key)
            if hit is None or hit[0] != seg:
                break
            keys.append(key)
            segs.append(seg)
        return PrefixChain(self.page_size, tuple(keys), tuple(segs))

    def register(self, tokens: Sequence[int],  # noqa: ARG002 - protocol law
                 pages: Sequence[int]) -> int:
        return 0    # no pool behind the tier; chains arrive via publish

    def seal(self, tokens: Sequence[int],
             max_pages: Optional[int] = None) -> PrefixChain:
        return self.match(tokens, max_pages)

    def publish(self, sealed: SealedChain) -> int:
        """Insert the sealed chain's pages (skipping keys already held),
        newest-recency, evicting LRU pages past ``max_pages``."""
        if sealed.page_size != self.page_size:
            raise ValueError(
                f"sealed chain page_size={sealed.page_size} does not match "
                f"tier page_size={self.page_size}")
        new = 0
        for j, (key, seg) in enumerate(zip(sealed.keys, sealed.segs,
                                           strict=True)):
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            page_payload = {leaf: np.ascontiguousarray(arr[:, j:j + 1])
                            for leaf, arr in sealed.payload.items()}
            self._entries[key] = (seg, page_payload)
            self.version += 1
            new += 1
        while len(self._entries) > self.max_pages:
            self._entries.popitem(last=False)
        return new

    def adopt(self, tokens: Sequence[int],
              max_pages: Optional[int] = None) -> Optional[SealedChain]:
        n = len(tokens) // self.page_size
        if max_pages is not None:
            n = min(n, max_pages)
        keys, segs, pages = [], [], []
        for key, seg in chain_keys(tokens, self.page_size, n):
            hit = self._entries.get(key)
            if hit is None or hit[0] != seg:
                break
            keys.append(key)
            segs.append(seg)
            pages.append(hit[1])
        if not keys:
            return None
        for key in keys:
            self._entries.move_to_end(key)     # adopt refreshes recency
        payload = {leaf: np.concatenate([pp[leaf] for pp in pages], axis=1)
                   for leaf in pages[0]}
        return SealedChain(self.page_size, tuple(keys), tuple(segs),
                           payload)

    # --- observability ---------------------------------------------------

    @property
    def n_pages(self) -> int:
        """Page payloads currently held (the ``shared_tier_pages`` router
        gauge)."""
        return len(self._entries)

    def check_invariants(self):
        assert len(self._entries) <= self.max_pages
        leaf_sets = {frozenset(pp) for _seg, pp in self._entries.values()}
        assert len(leaf_sets) <= 1, \
            "tier entries disagree on cache leaf structure"
        for _seg, pp in self._entries.values():
            for leaf, arr in pp.items():
                assert arr.ndim >= 2 and arr.shape[1] == 1, \
                    f"tier payload leaf {leaf} not a single page slice"
