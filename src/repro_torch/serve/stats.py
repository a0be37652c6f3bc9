"""Frozen, versioned schema for the serving-stack observability payloads.

This module is the single source of truth for the key sets of

* ``Engine.stats()``        — instantaneous gauges + cumulative counters,
* ``Engine.counters``       — the cumulative counter dict itself,
* ``ReplicaRouter.stats()`` — router gauges wrapping per-replica payloads.

Before this schema existed the key names were asserted ad-hoc in three
places (engine tests, ``serve_bench.py``'s per-tick trace, and
``check_regression.py``'s artifact walk); adding a counter meant silently
desynchronizing whichever one you forgot.  Now the engine *builds* its
counter dict from :data:`COUNTERS`, validates every ``stats()`` payload
against the gauge sets on the way out, and the bench + regression gate
import the same sets — a key can no longer exist in one consumer's world
and not another's.

Versioning contract: :data:`STATS_SCHEMA_VERSION` bumps whenever a key is
added, removed, or its meaning changes.  Payloads carry the version under
``schema_version``; consumers that persist or compare payloads (the bench
artifacts, the regression gate) must check it rather than guessing from
key shape.  Version 1 is the first frozen schema (the paged-pool payload
plus the request-lifecycle counters ``cancelled`` / ``shed_deadline``).
Version 2 adds the speculative-decoding keys: the ``spec_k`` gauge and
the ``drafted`` / ``accepted`` / ``rejected`` / ``accept_len_hist``
counters (the histogram is the one non-scalar counter — a dict mapping
per-tick accepted-proposal length to tick count).
Version 3 adds the cross-replica prefix-sharing keys: the engine
counters ``published_pages`` / ``adopted_pages`` (sealed prefix pages
exported to / installed from the shared tier), the router counters
``affinity_hits`` / ``affinity_misses`` (dispatches steered by the
prefix-affinity probe vs fallen back to least-loaded), and the router
gauge ``shared_tier_pages``.
"""
from __future__ import annotations

from typing import Dict, Mapping

STATS_SCHEMA_VERSION = 3

# --- Engine.stats() gauges (every layout) --------------------------------
GAUGES: Dict[str, str] = {
    "schema_version": "stats schema version (this module)",
    "waiting": "requests queued, not yet seated in a slot",
    "decode_slots_active": "slots whose whole prompt is cached (decoding)",
    "prefill_slots": "slots mid-prefill (chunk cursor short of the prompt)",
    "free_slots": "unoccupied slots",
    "prefill_tokens_pending": "prompt rows still to prefill across slots",
    "prefill_chunks_pending": "prefill chunk forwards still to run",
    "spec_k": "configured max draft proposals per slot per tick (0 = off)",
}

# --- extra gauges present iff cache_layout == "paged" --------------------
PAGED_GAUGES: Dict[str, str] = {
    "pages_in_use": "pool pages with refcount > 0",
    "pages_free": "pages on the free list proper",
    "pages_cached_lru": "refcount-0 registered pages (reclaimable prefix cache)",
    "pages_capacity": "allocatable pages (pool minus the trash page)",
    "tp": "tensor-parallel degree the pool is sharded over",
}

# --- Engine.counters (cumulative; Engine builds its dict from this) ------
COUNTERS: Dict[str, str] = {
    "ticks": "scheduler ticks (poll() calls)",
    "prefill_tokens": "prompt rows run through chunk forwards",
    "prefill_chunks": "prefill chunk forwards run",
    "oneshot_prefills": "prompts prefilled in a single chunk",
    "chunked_prefills": "prompts that took more than one chunk",
    "loop_prefill_steps": "batch-1 decode-loop prefill steps (SSM/SWA path)",
    "decode_steps": "batched decode forwards",
    "decode_tokens": "tokens produced by decode forwards",
    "completed": "requests finished (length or EOS)",
    "prefix_hits": "prompts that mapped registered prefix pages",
    "shared_rows": "prompt rows served from the prefix registry",
    "suffix_prefills": "prefix hits whose remainder ran in one chunk",
    "cache_pages_peak": "high-water mark of live pool pages",
    "grown_pages": "decode pages granted on demand",
    "preemptions": "victims spilled because the pool ran dry",
    "preempted_prefill": "victims spilled mid-prefill",
    "preempted_decode": "victims spilled mid-decode",
    "restores": "preempted requests re-seated",
    "spilled_rows": "cache rows held by victims at spill time",
    "recomputed_tokens": "replayed rows the prefix registry had lost",
    "pool_wait_ticks": "ticks a request waited on pages with a slot free",
    "cancelled": "requests cancelled via Engine.cancel()",
    "shed_deadline": "waiting requests shed at their deadline_tick",
    "drafted": "draft tokens proposed across all verify forwards",
    "accepted": "draft tokens accepted (argmax-matched) and committed",
    "rejected": "draft tokens rejected (cursor rolled back over them)",
    "accept_len_hist": "dict: accepted-prefix length -> slot-tick count",
    "published_pages": "sealed prefix pages exported to the shared tier",
    "adopted_pages": "prefix pages installed from the shared tier",
}

# --- ReplicaRouter.stats() gauges + counters -----------------------------
ROUTER_GAUGES: Dict[str, str] = {
    "schema_version": "stats schema version (this module)",
    "queued": "requests held in the router queue (not yet dispatched)",
    "inflight": "requests dispatched to a replica and not yet terminal",
    "n_replicas": "engine replicas behind the router",
    "replicas": "list of per-replica Engine.stats() payloads",
    "shared_tier_pages": "page payloads held by the shared prefix tier "
                         "(0 when the tier is off)",
}

ROUTER_COUNTERS: Dict[str, str] = {
    "ticks": "router polls (each ticks every replica once)",
    "submitted": "requests accepted into the router",
    "dispatched": "requests handed to a replica engine",
    "completed": "requests finished (length or EOS)",
    "rejected": "submissions refused because the queue was full",
    "shed_deadline": "queued requests shed at their deadline_tick",
    "cancelled": "requests cancelled through the router",
    "affinity_hits": "dispatches steered to a replica whose registry "
                     "already held the request's prefix chain",
    "affinity_misses": "affinity-enabled dispatches that fell back to "
                       "least-loaded (no replica held the chain)",
}

_GAUGE_KEYS = frozenset(GAUGES)
_PAGED_KEYS = frozenset(PAGED_GAUGES)
_COUNTER_KEYS = frozenset(COUNTERS)
_ROUTER_GAUGE_KEYS = frozenset(ROUTER_GAUGES)
_ROUTER_COUNTER_KEYS = frozenset(ROUTER_COUNTERS)


class StatsSchemaError(ValueError):
    """A stats/counters payload does not match the frozen schema."""


def _check_keys(got, expected, what: str):
    missing = sorted(expected - got)
    unknown = sorted(got - expected)
    if missing or unknown:
        raise StatsSchemaError(
            f"{what} does not match stats schema v{STATS_SCHEMA_VERSION}: "
            f"missing={missing} unknown={unknown}")


def _check_version(payload: Mapping, what: str):
    v = payload.get("schema_version")
    if v != STATS_SCHEMA_VERSION:
        raise StatsSchemaError(
            f"{what} carries schema_version={v!r}, this build understands "
            f"{STATS_SCHEMA_VERSION}")


def validate_counters(counters: Mapping, what: str = "Engine.counters"):
    """Exact-match the counter dict against :data:`COUNTERS`."""
    _check_keys(set(counters), _COUNTER_KEYS, what)
    return counters


def validate_router_counters(counters: Mapping,
                             what: str = "ReplicaRouter.counters"):
    """Exact-match the router counter dict against :data:`ROUTER_COUNTERS`."""
    _check_keys(set(counters), _ROUTER_COUNTER_KEYS, what)
    return counters


def validate_stats(stats: Mapping, *, paged: bool,
                   what: str = "Engine.stats()"):
    """Exact-match an ``Engine.stats()`` payload (gauges + counters)."""
    expected = _GAUGE_KEYS | {"counters"}
    if paged:
        expected = expected | _PAGED_KEYS
    _check_keys(set(stats), expected, what)
    _check_version(stats, what)
    validate_counters(stats["counters"], what=f"{what}['counters']")
    return stats


def validate_router_stats(stats: Mapping,
                          what: str = "ReplicaRouter.stats()"):
    """Exact-match a ``ReplicaRouter.stats()`` payload, including every
    embedded per-replica engine payload."""
    _check_keys(set(stats), _ROUTER_GAUGE_KEYS | {"counters"}, what)
    _check_version(stats, what)
    _check_keys(set(stats["counters"]), _ROUTER_COUNTER_KEYS,
                f"{what}['counters']")
    for i, rep in enumerate(stats["replicas"]):
        validate_stats(rep, paged="pages_capacity" in rep,
                       what=f"{what}['replicas'][{i}]")
    return stats
