"""SLO-aware data-parallel router over N engine replicas.

The port of the reference ``serve/router.py`` (host-side Python; it speaks
to the port's ``Engine``).  The router speaks the same event protocol as one
:class:`~repro_torch.serve.engine.Engine` (``submit`` / ``cancel`` /
``poll`` / ``has_work`` / ``stats``), so the asyncio server drives either.
It holds a bounded FIFO queue in front of the replicas and makes one
admission decision per queued request per tick:

* **dispatch** when some replica is *admissible*: its ``stats()`` show at
  most ``max_replica_waiting`` waiting requests, at most
  ``max_replica_chunks`` pending prefill chunks and (paged) at least
  ``min_free_pages`` free pages.  With ``affinity`` on, the admissible set
  is first narrowed to the replicas whose prefix registry holds the longest
  chain of the request's leading whole pages (read-only, through each
  replica's ``prefix_store``).  Among the candidates the least loaded wins,
  compared on ``(waiting, prefill_chunks_pending, -pages_free, index)``:
  the index tiebreak keeps placement deterministic, which is what makes a
  routed run token-identical to a single-engine run on the same trace.
* **queue** when no replica is admissible: the head waits (FIFO is never
  reordered).
* **shed** queued requests whose ``deadline_tick`` passes before dispatch,
  through the engine's CANCELLED/"deadline" exit.
* **reject** at ``submit`` when the bounded queue is full:
  :class:`RouterBusy`.

``poll()`` polls every replica exactly once, so the ticks of replicas built
for this router advance with the router's own.  Token identity holds for
greedy requests; sampled ones draw from per-replica generators.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve import stats as stats_schema
from repro_torch.serve.engine import Request, RequestStatus, TokenEvent
from repro_torch.serve.prefix import SharedPrefixTier


class RouterBusy(RuntimeError):
    """Submission refused: the router's bounded queue is full."""


class RouterConfigError(ValueError):
    """A RouterConfig is invalid or incompatible with the replicas."""


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Typed, frozen router options, validated at construction like
    ``EngineConfig``.  The admissibility defaults dispatch eagerly (a
    replica with an empty queue and any free page is admissible) and bound
    only the router queue.  ``affinity`` steers requests to the replica
    whose registry already holds their prefix chain (placement only: greedy
    outputs are unchanged); ``shared_tier`` builds a ``SharedPrefixTier``
    that every paged replica publishes sealed chains to and adopts pages
    from."""
    max_queue: int = 64            # router queue bound (submit -> RouterBusy)
    max_replica_waiting: int = 0   # dispatch only if replica waiting <= this
    max_replica_chunks: int = 8    # ... and prefill_chunks_pending <= this
    min_free_pages: int = 1        # ... and pages_free >= this (paged only)
    affinity: bool = True          # prefix-affinity steering
    max_affinity_pages: int = 8    # probe at most this many leading pages
    shared_tier: bool = False      # cross-replica publish/adopt tier
    shared_tier_pages: int = 256   # tier LRU capacity (page payloads)
    shed_policy: str = "deadline"  # "deadline" sheds queued requests at their
    #                                deadline_tick; "none" never sheds at the router

    def validate(self) -> "RouterConfig":
        def bad(msg):
            raise RouterConfigError(f"invalid RouterConfig: {msg}")
        if self.max_queue < 1:
            bad(f"max_queue must be >= 1 (got {self.max_queue})")
        if self.max_replica_waiting < 0 or self.max_replica_chunks < 0 \
                or self.min_free_pages < 0:
            bad(f"admissibility thresholds must be >= 0 (got max_replica_waiting="
                f"{self.max_replica_waiting}, max_replica_chunks={self.max_replica_chunks}, "
                f"min_free_pages={self.min_free_pages})")
        if self.max_affinity_pages < 1:
            bad(f"max_affinity_pages must be >= 1 (got {self.max_affinity_pages})")
        if self.shared_tier_pages < 1:
            bad(f"shared_tier_pages must be >= 1 (got {self.shared_tier_pages})")
        if self.shed_policy not in ("deadline", "none"):
            bad(f"shed_policy must be deadline|none (got {self.shed_policy!r})")
        return self


class ReplicaRouter:
    """Dispatch requests across engine replicas (see the module docstring).
    Request ids handed out by the router are global; per-replica engine rids
    stay internal."""

    def __init__(self, replicas: List, config: Optional[RouterConfig] = None, **kw):
        if kw:
            raise TypeError(
                f"ReplicaRouter(replicas, {next(iter(kw))}=..., ...) keyword options were "
                "removed; pass ReplicaRouter(replicas, RouterConfig(...)) — valid fields: "
                f"{', '.join(f.name for f in dataclasses.fields(RouterConfig))}")
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.replicas = list(replicas)
        self.config = (config or RouterConfig()).validate()
        self.prefix_tier = self._build_tier() if self.config.shared_tier else None
        self.queue: List[tuple] = []             # [(global rid, Request)] FIFO
        self.requests: Dict[int, Request] = {}   # live (queued + in flight)
        self._rev: List[Dict[int, int]] = [dict() for _ in self.replicas]  # engine -> global
        self._next_rid = 0
        self._events: List[TokenEvent] = []
        self.counters = {k: 0 for k in stats_schema.ROUTER_COUNTERS}

    def _build_tier(self) -> SharedPrefixTier:
        """The shared tier, attached to every paged single-rank replica (a
        tensor-parallel one holds only its heads of a page per rank); at
        least one must be eligible."""
        eligible = [eng for eng in self.replicas if getattr(eng, "layout", None) == "paged"
                    and getattr(eng, "mesh", None) is None]
        if not eligible:
            raise RouterConfigError("RouterConfig(shared_tier=True) needs at least one paged "
                                    "tp=1 replica to publish/adopt prefix chains")
        sizes = {eng.page_size for eng in eligible}
        if len(sizes) > 1:
            raise RouterConfigError(f"shared_tier needs one page_size across replicas, got "
                                    f"{sorted(sizes)}")
        tier = SharedPrefixTier(page_size=sizes.pop(), max_pages=self.config.shared_tier_pages)
        for eng in eligible:
            eng.attach_prefix_tier(tier)
        return tier

    # --- protocol: submit / cancel ---------------------------------------

    def submit(self, request: Request) -> int:
        if len(self.queue) >= self.config.max_queue:
            self.counters["rejected"] += 1
            raise RouterBusy(f"router queue full ({self.config.max_queue}); retry later")
        grid = self._next_rid
        self._next_rid += 1
        request.rid = grid
        request.status = RequestStatus.WAITING
        request.finish_reason = None
        request.out = None
        self.queue.append((grid, request))
        self.requests[grid] = request
        self.counters["submitted"] += 1
        return grid

    def cancel(self, grid: int) -> bool:
        """Cancel wherever the request lives.  Queued: terminal here, its
        event on the next poll.  Dispatched: forwarded to the owning
        replica, whose terminal event flows back translated."""
        req = self.requests.get(grid)
        if req is None:
            return False
        for i, (g, _r) in enumerate(self.queue):
            if g == grid:
                del self.queue[i]
                self.requests.pop(grid)
                self._terminate(req, RequestStatus.CANCELLED, "cancelled")
                self.counters["cancelled"] += 1
                return True
        for i, rev in enumerate(self._rev):
            for erid, g in rev.items():
                if g == grid:
                    ok = self.replicas[i].cancel(erid)
                    if ok:
                        self.counters["cancelled"] += 1
                    return ok
        raise AssertionError(f"rid {grid} tracked but neither queued nor dispatched")

    def _terminate(self, req: Request, status: RequestStatus, reason: str):
        req.out = np.asarray([], np.int32)
        req.status = status
        req.finish_reason = reason
        self._events.append(TokenEvent(req.rid, None, 0, True, reason))

    # --- admission --------------------------------------------------------

    def _admissible(self, stats: Dict) -> bool:
        c = self.config
        if stats["waiting"] > c.max_replica_waiting:
            return False
        if stats["prefill_chunks_pending"] > c.max_replica_chunks:
            return False
        return "pages_free" not in stats or stats["pages_free"] >= c.min_free_pages

    def _shed_expired(self):
        if self.config.shed_policy == "none":
            return
        t = self.counters["ticks"]
        for grid, req in list(self.queue):
            if req.deadline_tick is None or t < req.deadline_tick:
                continue
            self.queue.remove((grid, req))
            self.requests.pop(grid)
            self._terminate(req, RequestStatus.CANCELLED, "deadline")
            self.counters["shed_deadline"] += 1

    def _affinity_pages(self, eng, prompt: List[int]) -> int:
        """Leading full pages of ``prompt`` the replica's registry holds (0
        on the contiguous layout), read-only, capped at
        ``max_affinity_pages``."""
        store = getattr(eng, "prefix_store", None)
        if store is None:
            return 0
        cap = min((len(prompt) - 1) // store.page_size, self.config.max_affinity_pages)
        if cap <= 0:
            return 0
        return store.match(prompt, cap).n_pages

    @staticmethod
    def _least_loaded(snaps: List[Dict], cands: List[int]) -> int:
        """The least-loaded replica of ``cands`` on ``(waiting,
        prefill_chunks_pending, -pages_free, index)``; the index makes
        placement reproducible run to run."""
        return min(cands, key=lambda i: (snaps[i]["waiting"], snaps[i]["prefill_chunks_pending"],
                                         -snaps[i].get("pages_free", 0), i))

    def _dispatch(self):
        """Place queued requests head first onto the least-loaded admissible
        replica (with ``affinity``, among those holding the longest chain of
        the head's prompt); stop at the first head that does not fit."""
        while self.queue:
            snaps = [eng.stats() for eng in self.replicas]
            cands = [i for i, s in enumerate(snaps) if self._admissible(s)]
            if not cands:
                return
            grid, req = self.queue[0]
            if self.config.affinity:
                prompt = [int(t) for t in np.asarray(req.prompt).reshape(-1)]
                aff = {i: self._affinity_pages(self.replicas[i], prompt) for i in cands}
                best = max(aff.values())
                if best > 0:
                    cands = [i for i in cands if aff[i] == best]
                    self.counters["affinity_hits"] += 1
                else:
                    self.counters["affinity_misses"] += 1
            i = self._least_loaded(snaps, cands)
            self.queue.pop(0)
            try:
                erid = self.replicas[i].submit(req)
            except ValueError as e:
                # the request can never run on a replica built like this one:
                # FAILED, not retried elsewhere
                self.requests.pop(grid)
                req.rid = grid
                req.out = np.asarray([], np.int32)
                req.status = RequestStatus.FAILED
                req.finish_reason = f"error: {e}"
                self._events.append(TokenEvent(grid, None, 0, True, req.finish_reason))
                continue
            req.rid = grid                 # the engine stamped its local rid
            self._rev[i][erid] = grid
            self.counters["dispatched"] += 1

    # --- the tick ---------------------------------------------------------

    def poll(self) -> List[TokenEvent]:
        """One router tick: shed expired queued requests, dispatch while
        replicas are admissible, then poll every replica once and return
        the merged, rid-translated event stream."""
        self.counters["ticks"] += 1
        self._shed_expired()
        self._dispatch()
        events = self._events
        self._events = []
        for i, eng in enumerate(self.replicas):
            rev = self._rev[i]
            for e in eng.poll():
                grid = rev.get(e.rid)
                if grid is None:           # replica-local traffic, not ours
                    continue
                if e.final:
                    del rev[e.rid]
                    self.requests.pop(grid, None)
                    if e.finish_reason in ("length", "eos"):
                        self.counters["completed"] += 1
                events.append(dataclasses.replace(e, rid=grid))
        return events

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self._events) or any(self._rev) \
            or any(eng.has_work for eng in self.replicas)

    def stats(self) -> Dict:
        """Router gauges and counters wrapping each replica's payload, in
        the frozen schema (``serve/stats.py``)."""
        s = {
            "schema_version": stats_schema.STATS_SCHEMA_VERSION,
            "queued": len(self.queue),
            "inflight": sum(len(rev) for rev in self._rev),
            "n_replicas": len(self.replicas),
            "replicas": [eng.stats() for eng in self.replicas],
            "shared_tier_pages": 0 if self.prefix_tier is None else self.prefix_tier.n_pages,
            "counters": dict(self.counters),
        }
        return stats_schema.validate_router_stats(s)
