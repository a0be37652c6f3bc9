"""Slot-table scheduler + paged KV-cache block allocator.

The decode graph is compiled once for a fixed number of slots; this module
owns the bookkeeping that lets requests stream through that fixed shape:
a FIFO waiting queue, a slot table, admission of waiting requests into free
slots, and eviction on completion.  It is deliberately model-agnostic — the
engine owns prefill/decode; the scheduler only decides *who sits where* and,
since the token-budget step loop, *how much prefill runs per tick*: a seated
request no longer prefills whole at admission but carries a ``prefill_pos``
cursor that ``next_chunk`` advances in page-aligned chunks, co-scheduled with
the tick's decoding slots under ``max_batched_tokens``.

``BlockAllocator`` extends "where" from slots to cache memory: instead of an
exclusive ``Smax`` stripe per slot, the paged engine draws fixed-size KV
pages from one global pool.  The allocator keeps a free list, per-page
refcounts, and a prefix registry keyed by the page's *cumulative* token
prefix (K/V rows depend on every earlier token, so content identity is the
whole prefix, not the page's own tokens).  Pages whose refcount drops to
zero but that are still registered stay cached (their pool content is
intact) on an LRU list and are reclaimed only under allocation pressure —
so a repeated system prompt keeps hitting even after its first request
finished.  Shared pages are mapped copy-on-write: sharers only ever read
them; a writer must own the page exclusively (``ensure_exclusive``), which
the engine guarantees structurally by sharing only whole pages strictly
before the first position it will write.

With ``reserve="ondemand"`` the scheduler stops reserving a request's full
decode budget at admission: only the prompt's pages are taken up front and
decode slots request their next page when the write cursor crosses a page
boundary (``grow``).  The pool can therefore run dry mid-request; the
engine resolves that by preempting a victim (``pick_victim`` +
``preempt``) instead of stalling.  Spill registers the victim's fully
written pages in the prefix registry before dropping its references, so a
restore that re-admits before allocation pressure reclaims them turns the
lost work back into a prefix-cache hit and replays only the tail.

Tensor parallelism does not appear in this module by design: the engine
shards the pool over KV heads, never over pages, so a page id names the
same logical page on every rank and ONE allocator/scheduler instance on
the host is the single authority for all of them.  Every decision here —
admission reservations, ``grow`` grants, victim choice, spill
registration, LRU reclaim — is a pure function of tokens, page ids, and
refcounts (all rank-agnostic), which is the invariant that makes a
sharded engine's scheduling trace, counters, and greedy tokens
bit-identical to the unsharded engine's.  Spill/restore consequently
never moves cache data across ranks: registration records page ids +
tokens, and replay recomputes each rank's own head slice locally.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Deque, List, Optional, Sequence, Tuple

from repro_torch.serve.prefix import RegistryPrefixStore

TRASH_PAGE = 0   # inactive slots' block tables point here; never allocated


def pages_needed(rows: int, page_size: int) -> int:
    return -(-rows // page_size)


class BlockAllocator:
    """Fixed-size KV page pool: free list, refcounts, prefix reuse.

    Page 0 is reserved as the trash page — zeroed block-table entries of
    inactive slots alias it, so a full-table decode step can harmlessly
    scatter its garbage rows somewhere that no live request reads.
    """

    def __init__(self, n_pages: int, page_size: int,
                 bytes_per_page: Optional[int] = None):
        assert n_pages >= 2 and page_size >= 1
        self.n_pages = n_pages
        self.page_size = page_size
        # HBM bytes one pool page occupies across every rep/slot leaf —
        # payload AND per-page scales for the packed (kv_bits=4) layout,
        # where a page holds ~half the bytes of the int8 layout.  Purely
        # observational (pool sizing / benchmarks); allocation stays
        # page-granular, so refcounts, CoW, and spill/restore move packed
        # payloads and their scales together by construction (a page id
        # names both).
        self.bytes_per_page = bytes_per_page
        self.free: Deque[int] = collections.deque(range(1, n_pages))
        self.ref: List[int] = [0] * n_pages
        # the chained-prefix registry, as a first-class PrefixStore (see
        # repro.serve.prefix): the allocator owns refcounts and reclaim
        # POLICY; the store owns key->page bindings and the LRU of
        # refcount-0 registered pages.  Everything outside the allocator
        # (scheduler refresh, router affinity probes, the shared tier's
        # adoption path) programs against ``self.prefix``; the ref-taking
        # wrappers below are the only way references move.
        self.prefix = RegistryPrefixStore(page_size)
        self.live = 0                         # pages with refcount > 0
        self.peak_live = 0

    # --- capacity -------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable pages (excludes the trash page)."""
        return self.n_pages - 1

    @property
    def pool_bytes(self) -> Optional[int]:
        """Total allocatable-pool HBM bytes (None when the engine never
        told the allocator its page byte size)."""
        if self.bytes_per_page is None:
            return None
        return self.capacity * self.bytes_per_page

    def available(self) -> int:
        return len(self.free) + self.prefix.lru_count

    def can_alloc(self, n: int) -> bool:
        return n <= self.available()

    # --- allocation -----------------------------------------------------

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` exclusive pages (refcount 1), reclaiming LRU cached
        pages if the free list runs short.  None if the pool can't cover
        the request — the caller waits, it never partially allocates."""
        if not self.can_alloc(n):
            return None
        pages = []
        for _ in range(n):
            if self.free:
                p = self.free.popleft()
            else:
                p = self.prefix.pop_reclaim()  # oldest cached page
                assert p is not None, "can_alloc said yes but pool is dry"
            self.ref[p] = 1
            pages.append(p)
        self._bump_live(n)
        return pages

    def free_pages(self, pages: Sequence[int]):
        """Drop one reference per page; refcount-0 pages return to the free
        list, unless registered — those stay cached for prefix reuse."""
        for p in pages:
            assert self.ref[p] > 0, f"double free of page {p}"
            self.ref[p] -= 1
            if self.ref[p] == 0:
                self.live -= 1
                if self.prefix.is_registered(p):
                    self.prefix.park(p)
                else:
                    self.free.append(p)

    def _bump_live(self, n: int):
        self.live += n
        self.peak_live = max(self.peak_live, self.live)

    # --- prefix sharing -------------------------------------------------
    # The chained-key content addressing and the registry itself live in
    # ``self.prefix`` (repro.serve.prefix.RegistryPrefixStore).  The two
    # wrappers below are the ref-counting boundary: ``match_prefix`` takes
    # a reference per matched page, ``register_prefix`` applies the
    # strictly-before-last-token trim.  Read-only probes (router affinity,
    # the engine's adoption path) call ``self.prefix.match`` directly.

    @property
    def registry_version(self) -> int:
        """Bumped on every registration (the refresh_prefix memo key)."""
        return self.prefix.version

    def match_prefix(self, tokens: Sequence[int], max_pages: int) -> List[int]:
        """Longest chain of registered pages covering full-page prefixes of
        ``tokens`` (at most ``max_pages``).  Matched pages get a reference;
        release with ``free_pages`` if the reservation is abandoned."""
        pages = list(self.prefix.match(tokens, max_pages).pages)
        for p in pages:
            if self.ref[p] == 0:           # revive a cached (LRU) page
                self.prefix.revive(p)
                self._bump_live(1)
            self.ref[p] += 1
        return pages

    def register_prefix(self, tokens: Sequence[int], pages: Sequence[int]):
        """Publish a prompt's full pages for reuse.  Only pages strictly
        before the last prompt token are registered — at least one token
        must run through the model so admission has next-token logits, and
        the page the first write lands in must stay exclusive (COW
        discipline without ever copying)."""
        n = min((len(tokens) - 1) // self.page_size, len(pages))
        self.prefix.register(tokens[:n * self.page_size], pages[:n])

    def ensure_exclusive(self, pages: List[int], idx: int
                         ) -> Tuple[int, Optional[int]]:
        """Copy-on-write: make ``pages[idx]`` safe to overwrite.  Returns
        ``(page, copy_src)`` — ``copy_src`` is the old page whose rows must
        be copied into the fresh page when the original was shared (or
        registered, i.e. passively shareable), else None.

        The caller KEEPS its reference on ``copy_src`` until the row copy
        is done and must then drop it with ``free_pages([copy_src])``.
        Releasing it here instead (as this method once did) is a
        use-after-free: a refcount-1 registered source parks on the LRU the
        moment it is freed, and any allocation before the copy — including
        the very ``alloc`` that serves a concurrent slot — may reclaim and
        overwrite it.  The paged engine only ever writes pages it allocated
        exclusively, so today this is a no-op assert; the hook carries the
        semantics preemption/swap code inherits."""
        p = pages[idx]
        if self.ref[p] == 1 and not self.prefix.is_registered(p):
            return p, None
        fresh = self.alloc(1)
        if fresh is None:
            raise RuntimeError("pool exhausted during copy-on-write")
        pages[idx] = fresh[0]
        return fresh[0], p

    @property
    def cached_pages(self) -> int:
        return self.prefix.cached_count

    @property
    def free_list_pages(self) -> int:
        """Pages on the free list proper (excludes LRU-cached pages)."""
        return len(self.free)

    @property
    def lru_pages(self) -> int:
        """Refcount-0 registered pages parked on the LRU (reclaimable)."""
        return self.prefix.lru_count

    # --- debug ----------------------------------------------------------

    def check_invariants(self):
        """Assert the pool's structural invariants (O(n_pages); called from
        ``Engine.stats()`` so every per-tick stats assertion sweeps the
        allocator too, and hammered by the property tests):

        * the trash page is never referenced, freed, cached, or registered,
        * no page sits on the free list and the LRU at once,
        * refcounts are nonnegative and ``live`` counts exactly the pages
          with refcount > 0,
        * live + LRU + free partitions the allocatable pool,
        * the PrefixStore boundary holds: the registry and its page->key
          inverse agree (the store's own sweep), every registered page is
          a valid pool page, every LRU page is a refcount-0 registered
          page, and no free-list page is registered.
        """
        self.prefix.check_invariants()     # registry-internal bijection
        free = set(self.free)
        lru = set(self.prefix.lru_pages)
        assert len(free) == len(self.free), "free list holds duplicates"
        assert TRASH_PAGE not in free and TRASH_PAGE not in lru and \
            not self.prefix.is_registered(TRASH_PAGE) and \
            self.ref[TRASH_PAGE] == 0, "trash page leaked into the pool"
        assert not free & lru, f"pages on free AND lru: {free & lru}"
        assert all(r >= 0 for r in self.ref), f"negative refcount: {self.ref}"
        held = {p for p in range(self.n_pages) if self.ref[p] > 0}
        assert self.live == len(held), (self.live, held)
        assert not held & free and not held & lru, \
            "referenced page on free list or LRU"
        assert self.live + len(lru) + len(free) == self.n_pages - 1, \
            (self.live, len(lru), len(free), self.n_pages)
        registered = {p for p in range(self.n_pages)
                      if self.prefix.is_registered(p)}
        assert all(0 < p < self.n_pages for p in registered), \
            f"registered page outside the pool: {registered}"
        for p in lru:
            assert self.ref[p] == 0, \
                f"LRU page {p} not a refcount-0 registered page"
        assert not free & registered, \
            f"registered page on free list: {free & registered}"


@dataclasses.dataclass
class SlotState:
    """One occupied slot of the decode batch."""
    rid: int
    request: object                 # the engine's Request
    pos: int = 0                    # next cache write position for this slot
    last_token: int = 0             # token to feed at the next decode step
    emitted: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    shared_rows: int = 0            # prompt rows mapped from cached pages
    prefill_pos: int = 0            # prompt rows already in the cache
    chunks_done: int = 0            # prefill chunk forwards run so far
    refresh_seen: int = -1          # registry version last re-matched against
    starved_ticks: int = 0          # consecutive ticks prefilling w/o a chunk
    tokens: Optional[List[int]] = None   # replay sequence after a decode
    #                                      preemption (prompt + emitted);
    #                                      set by preempt, cleared at the
    #                                      replay's handoff — only valid
    #                                      while the slot prefills
    spilled_rows: int = 0           # cache rows held when last preempted
    hwm_rows: int = 0               # furthest row ever computed (across
    #                                 spills): replay below it = recompute
    preemptions: int = 0            # times this request was spilled

    def prompt_tokens(self):
        """The token sequence prefill must cover.  Normally the request
        prompt; after a DECODE preemption it is prompt + every token
        emitted so far — the spilled KV rows are regenerated by replaying
        them (greedy decode is deterministic, so the replay is
        bit-identical and the final chunk's logits emit the next new
        token, never a repeat)."""
        return self.request.prompt if self.tokens is None else self.tokens

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens())

    @property
    def prefilling(self) -> bool:
        """True until the whole prompt is in the cache; the slot joins the
        decode batch only after its final prefill chunk hands off."""
        return self.prefill_pos < self.prompt_len


class Scheduler:
    def __init__(self, n_slots: int,
                 allocator: Optional[BlockAllocator] = None,
                 rows_fn: Optional[Callable[[object, int], int]] = None,
                 max_batched_tokens: Optional[int] = None,
                 max_prefill_chunk: Optional[int] = None,
                 reserve: str = "full"):
        assert n_slots >= 1
        assert reserve in ("full", "ondemand"), reserve
        assert reserve == "full" or allocator is not None, \
            "on-demand page growth needs the paged allocator"
        self.n_slots = n_slots
        self.allocator = allocator
        # "full": admission reserves prompt + decode budget, decode can
        # never OOM.  "ondemand": admission reserves only the prompt's
        # pages; decode pages are granted by ``grow`` at page-boundary
        # crossings and exhaustion is resolved by preemption, not refusal.
        self.reserve = reserve
        # rows_fn(request, shared_rows) -> cache rows to reserve (the engine
        # knows about prefill bucketing; the scheduler stays model-agnostic)
        self.rows_fn = rows_fn or (
            lambda req, shared: len(req.prompt) + req.max_new_tokens - 1)
        # per-tick budget policy: max_batched_tokens caps prefill-chunk
        # tokens + decode tokens per tick; max_prefill_chunk caps one slot's
        # chunk.  Both None -> a seated request prefills whole in one chunk
        # (the pre-chunking one-shot behavior through the unified loop).
        ps = allocator.page_size if allocator is not None else 1
        if max_prefill_chunk is not None:
            assert allocator is not None, \
                "chunked prefill needs the paged allocator (page-aligned " \
                "chunks); the contiguous layout prefills in one chunk"
            assert max_prefill_chunk >= ps and max_prefill_chunk % ps == 0, \
                (max_prefill_chunk, ps)
        if max_batched_tokens is not None:
            assert max_batched_tokens >= 1
        self.max_batched_tokens = max_batched_tokens
        self.max_prefill_chunk = max_prefill_chunk
        self.slots: List[Optional[SlotState]] = [None] * n_slots
        self.waiting: Deque[Tuple[int, object]] = collections.deque()
        self._next_rid = 0

    # --- queue side -----------------------------------------------------

    def submit(self, request) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append((rid, request))
        return rid

    def remove_waiting(self, rid: int):
        """Drop ``rid`` from the waiting queue (cancellation / deadline
        shed).  Returns the queued item — the plain request, or the
        preempted SlotState if it was requeued by ``preempt`` (its pages
        were already freed at spill time) — or None if not queued."""
        for i, (r, item) in enumerate(self.waiting):
            if r == rid:
                del self.waiting[i]
                return item
        return None

    # --- slot side ------------------------------------------------------

    def _reserve(self, st: SlotState) -> bool:
        """Map shared prefix pages and allocate the exclusive tail.  False
        when the pool can't cover the request — admission stalls (FIFO is
        preserved: later, smaller requests do NOT jump the queue).  Under
        ``reserve="full"`` the tail covers the whole decode budget
        (``rows_fn``); under ``"ondemand"`` only the prompt rows — the
        prefill scatter writes whole pages, so ``pages_needed(len)`` is
        exactly what the chunk forwards touch."""
        al = self.allocator
        ps = al.page_size
        prompt = [int(t) for t in st.prompt_tokens()]
        shared = al.match_prefix(prompt, (len(prompt) - 1) // ps)
        shared_rows = len(shared) * ps
        rows = (len(prompt) if self.reserve == "ondemand" else
                self.rows_fn(st.request, shared_rows))
        need = max(0, pages_needed(rows, ps) - len(shared))
        excl = al.alloc(need)
        if excl is None:
            al.free_pages(shared)          # abandon the speculative mapping
            return False
        st.pages = shared + excl
        st.shared_rows = shared_rows
        st.prefill_pos = shared_rows       # the cursor skips mapped rows
        return True

    def admit(self, limit: Optional[int] = None
              ) -> List[Tuple[int, SlotState]]:
        """Seat waiting requests in free slots (FIFO).  Returns the new
        (slot index, state) pairs; the engine prefills them and fills in
        ``pos`` / ``last_token``.  With a BlockAllocator, admission also
        reserves the request's KV pages (shared prefix + an exclusive tail
        covering the whole decode budget under ``reserve="full"``, or just
        the prompt under ``"ondemand"``) — a head-of-line request that
        doesn't fit stalls the queue.  A preempted SlotState requeued by
        ``preempt`` sits at the queue front and is re-seated as-is: its
        replay sequence re-matches the prefix registry, so spilled pages
        that survived on the LRU come back as cache hits."""
        placed = []
        for b in range(self.n_slots):
            if limit is not None and len(placed) >= limit:
                break
            if self.slots[b] is not None or not self.waiting:
                continue
            rid, item = self.waiting[0]
            st = item if isinstance(item, SlotState) else \
                SlotState(rid=rid, request=item)
            if self.allocator is not None and not self._reserve(st):
                break                       # out of pages: wait, keep FIFO
            self.waiting.popleft()
            self.slots[b] = st
            placed.append((b, st))
        return placed

    def evict(self, b: int) -> SlotState:
        st = self.slots[b]
        assert st is not None, f"evicting empty slot {b}"
        self.slots[b] = None
        if self.allocator is not None and st.pages:
            # tail first: registered refcount-0 pages enter the LRU in free
            # order and reclaim pops oldest, so freeing the chain HEAD
            # first would make the next allocation break the registry chain
            # at page 0 and strand the rest unmatchable — reversed, reclaim
            # consumes the tail and a usable prefix survives longest
            self.allocator.free_pages(st.pages[::-1])
        return st

    # --- on-demand growth + preemption ----------------------------------

    def grow(self, st: SlotState, rows: int) -> Optional[int]:
        """Extend ``st``'s page chain to cover ``rows`` cache rows (the
        on-demand decode path calls this just before the write cursor
        enters a page it doesn't own; the speculative verify path calls
        it with a multi-row budget — cursor + 1 + k proposals — so one
        tick's accepted tokens all land in owned pages).  Returns the
        number of pages newly allocated (0 when the chain already covers
        ``rows``), or None when the pool came up empty — the engine then
        preempts a victim and retries; the chain is never partially
        grown.  A speculative over-reservation (proposals rejected) is
        harmless: the extra pages sit past the cursor inside the slot's
        max_len ceiling and the next real token reuses them."""
        al = self.allocator
        need = pages_needed(rows, al.page_size) - len(st.pages)
        if need <= 0:
            return 0
        got = al.alloc(need)
        if got is None:
            return None
        st.pages.extend(got)
        return need

    def pick_victim(self, exclude: frozenset = frozenset()
                    ) -> Optional[int]:
        """The slot to spill under pool pressure, or None if no candidate.

        Policy: the LAST-admitted prefilling slot first (least sunk cost —
        its unfinished pages are pure loss anyway and its restore is the
        cheap chunk-replay path), then the decoding slot with the most
        decode budget remaining (it would hold pages hostage longest;
        ties break youngest).  When more than one candidate exists the
        oldest (lowest-rid) seated request is never chosen — combined with
        requeue-at-front restores this keeps the head of line progressing,
        so every request eventually finishes under sustained overload."""
        cands = [(b, st) for b, st in enumerate(self.slots)
                 if st is not None and b not in exclude]
        if not cands:
            return None
        if len(cands) > 1:
            head = min(st.rid for _, st in cands)
            cands = [(b, st) for b, st in cands if st.rid != head]
        pre = [(st.rid, b) for b, st in cands if st.prefilling]
        if pre:
            return max(pre)[1]
        dec = [(st.request.max_new_tokens - len(st.emitted), st.rid, b)
               for b, st in cands]
        return max(dec)[2]

    def preempt(self, b: int) -> SlotState:
        """Spill slot ``b``'s pages and requeue it at the FRONT of the
        waiting queue (it outranks everything submitted after it).

        The victim's fully written pages — up to the last page boundary
        under its write cursor — are registered in the prefix registry
        BEFORE its references drop, so they park on the LRU instead of the
        free list; if allocation pressure hasn't reclaimed them by
        re-admission, ``_reserve``/``refresh_prefix`` revive them as a
        prefix hit and the replay prefills only the lost tail.  A decoding
        victim folds its emitted tokens into the replay sequence
        (``SlotState.prompt_tokens``): greedy replay regenerates the
        identical KV rows and the handoff logits continue exactly where
        the victim stopped.  The partial page past the boundary is
        unregistered and returns to the free list — those rows are the
        recompute cost the engine accounts."""
        st = self.slots[b]
        assert st is not None, f"preempting empty slot {b}"
        al = self.allocator
        ps = al.page_size
        if st.prefilling:
            cached = st.prefill_pos        # page-aligned mid-prefill
        else:
            cached = st.pos                # decode wrote rows [0, pos)
            st.tokens = [int(t) for t in st.request.prompt] + \
                [int(t) for t in st.emitted]
        boundary = (cached // ps) * ps
        if boundary:
            al.register_prefix([int(t) for t in st.prompt_tokens()],
                               st.pages[:boundary // ps])
        al.free_pages(st.pages[::-1])  # tail first — see evict()
        self.slots[b] = None
        st.pages = []
        st.shared_rows = 0
        st.prefill_pos = 0
        st.chunks_done = 0
        st.refresh_seen = -1
        st.starved_ticks = 0
        st.pos = 0
        st.spilled_rows = cached
        st.hwm_rows = max(st.hwm_rows, cached)
        st.preemptions += 1
        self.waiting.appendleft((st.rid, st))
        return st

    # --- chunked prefill planning ---------------------------------------

    def refresh_prefix(self, st: SlotState) -> int:
        """Re-match ``st``'s prompt against the prefix registry just before
        its FIRST chunk runs.  Registration happens at prefill completion,
        so a request admitted in the same tick as (or mid-prefill of) an
        identical prompt misses at admission but hits here — the hit can
        land mid-chunk, skipping rows the chunk grid would otherwise cover.
        Adopted pages replace the exclusive pages reserved for the same
        rows (those go back to the pool); returns rows newly shared.
        Memoized on the registry version: a budget-starved slot polled
        every chunk of every tick only re-hashes its prompt after a
        registration actually changed what it could match."""
        al = self.allocator
        if al is None or st.chunks_done or not st.prefilling:
            return 0
        if st.refresh_seen == al.registry_version:
            return 0
        st.refresh_seen = al.registry_version
        ps = al.page_size
        prompt = [int(t) for t in st.prompt_tokens()]
        matched = al.match_prefix(prompt, (len(prompt) - 1) // ps)
        new_rows = len(matched) * ps
        if new_rows <= st.shared_rows:
            al.free_pages(matched)         # nothing longer than we hold
            return 0
        # the registry chain is stable while we hold refs, so matched[:k]
        # are the pages already mapped at admission: dropping one ref per
        # replaced entry nets out for those and frees the exclusives
        replaced = st.pages[:len(matched)]
        st.pages = matched + st.pages[len(matched):]
        al.free_pages(replaced)
        gained = new_rows - st.shared_rows
        st.shared_rows = new_rows
        st.prefill_pos = new_rows
        return gained

    def next_chunk(self, n_decode_active: int, used_tokens: int,
                   exclude: frozenset = frozenset()
                   ) -> Optional[Tuple[int, SlotState, int, int]]:
        """The next prefill chunk to run this tick: ``(slot, state, pos0,
        n_tokens)`` — or None when the budget is spent or nothing prefills.

        Policy: with a chunk policy active (either knob set), prefilling
        slots are served shortest-remaining-first (rid breaks ties), so a
        short prompt arriving while a long one is mid-prefill reaches its
        first token after ONE chunk instead of queueing behind the whole
        long prefill — the TTFT tail chunking exists to bound.  Two
        anti-starvation guards protect the head-of-line (lowest-rid)
        prefilling slot from a steady stream of short arrivals: while the
        tick's starting budget covers at least two pages, every other slot
        leaves one page of the REMAINING budget for the unserved head (so
        later short picks cannot eat the reserved page); and a head that
        got no chunk for two consecutive ticks preempts the SJF order
        outright — under any budget the head advances at least one page
        every third tick.  With no policy (one-shot mode) slots prefill
        whole in FIFO order — the pre-chunking admission behavior,
        preserved as the A/B baseline.  A chunk is ``min(remaining,
        max_prefill_chunk, budget left)`` rounded DOWN to whole pages
        unless it finishes the prompt (the ragged last chunk).
        ``max_batched_tokens`` is shared with the tick's decode tokens
        (``n_decode_active`` + chunk tokens already ``used_tokens`` this
        tick).  When the budget leaves no whole page but nothing else runs
        this tick, one page is forced so prefill always makes progress."""
        pre = [(b, st) for b, st in enumerate(self.slots)
               if st is not None and st.prefilling and b not in exclude]
        if not pre:
            return None
        ps = self.allocator.page_size if self.allocator is not None else 1
        budget = (None if self.max_batched_tokens is None else
                  self.max_batched_tokens - n_decode_active - used_tokens)
        # refresh before ordering: an adopted prefix shrinks `remaining`
        for _, st in pre:
            if st.chunks_done == 0:
                self.refresh_prefix(st)
        chunked_mode = self.max_batched_tokens is not None or \
            self.max_prefill_chunk is not None
        if chunked_mode:
            pre.sort(key=lambda e: (e[1].prompt_len - e[1].prefill_pos,
                                    e[1].rid))
        else:
            pre.sort(key=lambda e: e[1].rid)
        # the head-of-line slot is the oldest PREFILLING slot, whether or
        # not it already chunked this tick (exclude) — its reservation only
        # lifts once it has actually been served
        all_pre = [st for st in self.slots
                   if st is not None and st.prefilling]
        head_rid = min(st.rid for st in all_pre)
        head_waiting = any(st.rid == head_rid for _, st in pre)
        tick_budget = (None if self.max_batched_tokens is None else
                       self.max_batched_tokens - n_decode_active)
        if chunked_mode and head_waiting:
            head = next(st for _, st in pre if st.rid == head_rid)
            if head.starved_ticks >= 2:
                # bounded starvation: a head that got nothing for two ticks
                # (the tight-budget regime where the reservation is off)
                # preempts the SJF order for this pick
                pre.sort(key=lambda e: e[1].rid != head_rid)
        for b, st in pre:
            remaining = st.prompt_len - st.prefill_pos
            take = remaining
            if self.max_prefill_chunk is not None:
                take = min(take, self.max_prefill_chunk)
            if budget is not None:
                # reserve one page of the REMAINING budget for the unserved
                # head — gated on the tick-START budget covering head +
                # someone else, so a one-page budget doesn't invert into
                # the head starving every shorter prompt instead
                reserve = ps if (st.rid != head_rid and head_waiting
                                 and tick_budget >= 2 * ps) else 0
                take = min(take, max(budget - reserve, 0))
            if take < remaining:
                take = (take // ps) * ps   # mid-prompt chunks: whole pages
            if take <= 0 and st.rid == head_rid and st.starved_ticks >= 2:
                # the override must FORCE a chunk, not just reorder: when
                # the budget net of decode stays under a page for many
                # ticks (slots decoding long budgets), reordering alone
                # would stall the head for the decode's whole lifetime.
                # Overshoots the budget by at most one page, like the
                # final-chunk handoff token.
                take = min(remaining, ps)
            if take > 0:
                return b, st, st.prefill_pos, take
        if used_tokens or n_decode_active:
            return None                    # budget went to real work
        b, st = pre[0]                     # forced progress: empty tick
        return b, st, st.prefill_pos, min(st.prompt_len - st.prefill_pos, ps)

    # --- queries --------------------------------------------------------

    @property
    def active(self) -> List[int]:
        return [b for b, st in enumerate(self.slots) if st is not None]

    @property
    def decoding(self) -> List[int]:
        """Slots whose whole prompt is cached — the tick's decode batch."""
        return [b for b, st in enumerate(self.slots)
                if st is not None and not st.prefilling]

    @property
    def prefilling(self) -> List[int]:
        return [b for b, st in enumerate(self.slots)
                if st is not None and st.prefilling]

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(st is not None for st in self.slots)

    @property
    def n_free(self) -> int:
        return sum(st is None for st in self.slots)
