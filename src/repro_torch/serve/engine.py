"""Continuous-batching serving engine over the folded integer model.

The port of the reference ``serve/engine.py``: the
paged KV pool, int8 or int4-packed (``kv_bits=4``), with on-demand page
growth and preemption (or ``reserve_policy="full"``), prefix sharing through
the allocator's registry and, across replicas, a shared prefix tier
(``attach_prefix_tier``), chunked prefill under a token budget and greedy
speculative decoding (``spec_k > 0``, int8 pool); or the contiguous
per-slot stripe (``cache_layout="contiguous"``, and what ``"auto"`` resolves
to for a sliding-window arch, whose stripe is a window-sized ring, and for
the recurrent archs, jamba's Mamba hybrid and xLSTM, whose slots hold a
recurrent state) with a one-shot prefill per request, or the batch-1
decode loop for a prompt longer than the stripe and for every prompt of a
recurrent arch; greedy or sampled decode.  ``LockstepEngine`` is the
reference's lockstep baseline over the contiguous stripe, and
``make_engine`` hands it the archs the continuous engine does not take (a
frontend or several LM heads: qwen2-vl-2b, musicgen-medium), as the
reference does.

``poll()`` runs ONE scheduler tick — shed expired → adopt tier pages →
admit → prefill chunks under the budget → grow decode pages (preempting
when the pool runs dry) → one decode forward for every slot whose prompt is
cached, or one verify forward when a draft source proposed tokens — and
returns the tick's ``TokenEvent`` stream; ``step()``, ``run()`` and
``generate()`` wrap it.  The host-side bookkeeping (``serve/scheduler.py``,
``serve/prefix.py``, ``serve/stats.py``, ``serve/draft.py``) is the
reference's, so on the ``ref`` kernel backend the engine's greedy tokens and
counters equal the reference engine's.

Tensor parallelism (``tp=N`` or an explicit ``mesh``, ``launch/mesh.py``'s
``TPMesh``; the paged layout only), as in the reference: the pool is split
over its KV-head axis, one shard per rank on the rank's device, every rank
holding its heads' slice of EVERY page.  Page ids stay global and the block
tables are one host-side copy, so the allocator and the scheduler stay a
single authority whose admission, growth, preemption and spill decisions
bind every rank at once (preemption recomputes and moves no pool data).
Each forward runs the projections, ``wo``, the MLP and the lm_head once and
each rank's attention on its heads (``serve_int._over_ranks``), so tokens
and counters equal the unsharded engine's.  A one-rank mesh runs the same
path degenerately; a mesh that names one device several times runs several
ranks there (on the CPU, the tests' stand-in for several devices).

The engine runs where the folded weights live: CUDA weights take the
``gpu`` kernel backend, CPU weights the ``ref`` one (``kernels/ops.py``).
The options a recurrent arch's layout cannot take (the paged pool,
speculative decoding, chunked prefill, tensor parallelism) raise the
reference's ``EngineConfigError``s, and ``kv_bits=4`` falls back to 8 with a
warning, as in the reference.
"""
from __future__ import annotations

import dataclasses
import enum
import math
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.launch.mesh import TPMesh, make_tp_mesh
from repro_torch.models import serve_int as S
from repro_torch.models.transformer import slot_kinds
from repro_torch.serve import stats as stats_schema
from repro_torch.serve.draft import make_draft_source
from repro_torch.serve.prefix import SealedChain
from repro_torch.serve.scheduler import BlockAllocator, Scheduler, SlotState, pages_needed


class RequestStatus(enum.Enum):
    """WAITING → PREFILL → DECODE → FINISHED, with CANCELLED and FAILED
    exits; preemption moves a seated request back to WAITING."""
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    FAILED = "failed"

    @property
    def terminal(self) -> bool:
        return self in (RequestStatus.FINISHED, RequestStatus.CANCELLED,
                        RequestStatus.FAILED)


class RequestCancelled(RuntimeError):
    """Raised by ``Request.result()`` for a cancelled / shed request."""


class RequestFailed(RuntimeError):
    """Raised by ``Request.result()`` for a failed request."""


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One element of the ``poll()`` event stream (see the reference)."""
    rid: int
    token: Optional[int]
    index: int
    final: bool
    finish_reason: Optional[str] = None


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    eos_token: Optional[int] = None
    deadline_tick: Optional[int] = None  # shed if still WAITING at this tick
    out: Optional[np.ndarray] = None
    rid: Optional[int] = None
    status: RequestStatus = RequestStatus.WAITING
    finish_reason: Optional[str] = None

    def result(self) -> np.ndarray:
        if self.status is RequestStatus.FINISHED:
            return self.out
        if self.status is RequestStatus.CANCELLED:
            raise RequestCancelled(
                f"request rid={self.rid} cancelled ({self.finish_reason}); "
                f"{0 if self.out is None else len(self.out)} partial token(s) in .out")
        if self.status is RequestStatus.FAILED:
            raise RequestFailed(f"request rid={self.rid} failed ({self.finish_reason})")
        raise RuntimeError(f"request rid={self.rid} still in flight "
                           f"(status={self.status.value})")


class EngineConfigError(ValueError):
    """An EngineConfig is invalid or incompatible with the model config."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Typed, validated engine options — the reference's fields and
    field-level validation."""
    batch_slots: int = 8
    max_len: int = 512
    seed: int = 0
    prefill_bucket: int = 16
    cache_layout: str = "auto"           # auto | paged | contiguous
    page_size: int = 16
    n_pages: Optional[int] = None
    max_batched_tokens: Optional[int] = None
    max_prefill_chunk: Optional[int] = None
    reserve_policy: Optional[str] = None  # None | "full" | "ondemand"
    kv_bits: int = 8
    tp: int = 1
    mesh: object = None
    spec_k: int = 0
    draft: object = "prompt_lookup"

    def validate(self) -> "EngineConfig":
        def bad(msg):
            raise EngineConfigError(f"invalid EngineConfig: {msg}")
        if self.batch_slots < 1:
            bad(f"batch_slots must be >= 1 (got {self.batch_slots})")
        if self.max_len < 1:
            bad(f"max_len must be >= 1 (got {self.max_len})")
        if self.prefill_bucket < 1:
            bad(f"prefill_bucket must be >= 1 (got {self.prefill_bucket})")
        if self.cache_layout not in ("auto", "paged", "contiguous"):
            bad(f"cache_layout must be auto|paged|contiguous (got {self.cache_layout!r})")
        if self.page_size < 1:
            bad(f"page_size must be >= 1 (got {self.page_size})")
        if self.n_pages is not None and self.n_pages < 2:
            bad(f"n_pages must be >= 2 — page 0 is the reserved trash page "
                f"(got {self.n_pages})")
        if self.reserve_policy not in (None, "full", "ondemand"):
            bad(f"reserve_policy must be full|ondemand (got {self.reserve_policy!r})")
        chunky = self.max_batched_tokens is not None or self.max_prefill_chunk is not None
        if chunky and self.cache_layout == "contiguous":
            bad("chunked prefill (max_batched_tokens / max_prefill_chunk) "
                "requires cache_layout='paged' — chunks are pages")
        if self.max_batched_tokens is not None and self.max_batched_tokens < 1:
            bad(f"max_batched_tokens must be >= 1 (got {self.max_batched_tokens})")
        if self.max_prefill_chunk is not None and (
                self.max_prefill_chunk < self.page_size
                or self.max_prefill_chunk % self.page_size):
            bad(f"max_prefill_chunk must be a positive multiple of "
                f"page_size={self.page_size} (got {self.max_prefill_chunk})")
        if self.reserve_policy == "ondemand" and self.cache_layout == "contiguous":
            bad("reserve_policy='ondemand' (on-demand page growth) requires "
                "cache_layout='paged'")
        if self.kv_bits not in (8, 4):
            bad(f"kv_bits must be one of 8, 4 (got {self.kv_bits})")
        if self.kv_bits != 8 and self.cache_layout == "contiguous":
            bad("kv_bits=4 packs the paged KV pool; "
                "cache_layout='contiguous' stores int8 rows only")
        if self.tp < 1:
            bad(f"tp must be >= 1 (got {self.tp})")
        if (self.tp != 1 or self.mesh is not None) and self.cache_layout == "contiguous":
            bad("tensor parallelism shards the paged KV pool; "
                "cache_layout='contiguous' has no TP path")
        if self.spec_k < 0:
            bad(f"spec_k must be >= 0 (got {self.spec_k})")
        if self.spec_k > 0 and self.cache_layout == "contiguous":
            bad("speculative decoding (spec_k > 0) verifies through the paged "
                "prefill path; cache_layout='contiguous' has no verify forward")
        if self.spec_k > 0 and self.kv_bits != 8:
            bad("spec_k > 0 with kv_bits=4 is not supported")
        return self


_DEFAULT_CONFIG = EngineConfig()
# fields the LockstepEngine has no use for; make_engine warns when they
# deviate from their defaults and resets them before construction
_CONTINUOUS_ONLY_FIELDS = ("prefill_bucket", "cache_layout", "page_size", "n_pages",
                           "max_batched_tokens", "max_prefill_chunk", "reserve_policy",
                           "kv_bits", "tp", "mesh", "spec_k", "draft")


def _config_only(config: Optional[EngineConfig], kw: dict, caller: str) -> EngineConfig:
    """The validated ``config`` (keyword options raise a TypeError naming
    ``EngineConfig``)."""
    if kw:
        raise TypeError(
            f"{caller}(cfg, folded, {next(iter(kw))}=..., ...) keyword options were "
            f"removed; pass {caller}(cfg, folded, EngineConfig(...)) — valid fields: "
            f"{', '.join(f.name for f in dataclasses.fields(EngineConfig))}")
    return (config if config is not None else EngineConfig()).validate()


def supports_continuous(cfg: ModelConfig) -> bool:
    """Continuous batching serves single-head token-LM archs; the archs with
    a frontend or several LM heads go through ``LockstepEngine``."""
    return cfg.frontend == "none" and cfg.n_lm_heads == 1


def make_engine(cfg: ModelConfig, folded, config: Optional[EngineConfig] = None, **kw):
    """The continuous engine when the arch supports it, else the lockstep
    baseline (same ``generate()`` surface), as in the reference: for a
    lockstep arch each continuous-only field set away from its default
    (``tp`` and ``mesh`` among them) is reset, with a warning naming it."""
    config = _config_only(config, kw, "make_engine")
    if supports_continuous(cfg):
        return Engine(cfg, folded, config)
    dropped = sorted(f for f in _CONTINUOUS_ONLY_FIELDS
                     if getattr(config, f) != getattr(_DEFAULT_CONFIG, f))
    if dropped:
        warnings.warn(f"make_engine: arch {cfg.name!r} takes the LockstepEngine, which "
                      f"ignores {', '.join(dropped)}", stacklevel=2)
        config = dataclasses.replace(
            config, **{f: getattr(_DEFAULT_CONFIG, f) for f in dropped})
    return LockstepEngine(cfg, folded, config)


class LockstepEngine:
    """The reference's lockstep baseline: one shared position for every
    slot, prompts left-padded to the longest and replayed through the
    decode forward over the contiguous stripe.  Greedy tokens equal the
    reference's, and so do sampled ones: the key is ``jax.random``'s
    threefry key of ``config.seed``, split once per sampled step, and the
    draw is its ``categorical`` (``core/prng.py``, numpy on the host).
    It serves qwen2-vl-2b's text (its decode rotates each position on all
    three M-RoPE streams); musicgen-medium's ``generate`` raises (below)."""

    def __init__(self, cfg: ModelConfig, folded, config: Optional[EngineConfig] = None,
                 **kw):
        config = _config_only(config, kw, "LockstepEngine")
        if config.tp != 1 or config.mesh is not None:
            raise EngineConfigError("LockstepEngine has no tensor-parallel path (tp / mesh): "
                                    "serve tp > 1 through Engine on the paged layout, or "
                                    "through make_engine, which resets them for a lockstep arch")
        self.cfg = cfg
        self.config = config
        self.device = folded["embed"]["tokens_i8"].device
        self.folded = S.prepare_folded(cfg, folded)
        self.batch = config.batch_slots
        self.max_len = config.max_len
        self.reset(config.seed)

    def reset(self, seed: int = 0):
        self.cache = S.init_cache(self.cfg, self.batch, self.max_len, device=self.device)
        self.pos = np.zeros(self.batch, np.int32)
        self.key = prng.key(seed)

    def _step(self, tokens_col: np.ndarray, pos: int) -> np.ndarray:
        tok = torch.as_tensor(np.asarray(tokens_col, np.int32).reshape(self.batch, 1),
                              device=self.device)
        logits, self.cache = S.serve_forward(self.cfg, self.folded, tok, cache=self.cache,
                                             pos_offset=pos, mode="decode")
        return (logits[:, -1] if logits.dim() == 3 else logits[:, :, -1]).cpu().numpy()

    def generate(self, requests: List[Request]) -> List[Request]:
        """Lockstep decode for a batch of same-length-padded prompts.

        An audio-codebook arch raises a ``ValueError``: the reference's
        ``generate`` feeds its (B, 1) token column to a forward that wants
        (B, K, S) codes and fails (an ``AssertionError`` in its
        ``_attn_decode``); such an arch decodes through ``serve_forward``
        with (B, K, 1) codes a step (a deliberate deviation, ROADMAP §3)."""
        if self.cfg.frontend == "audio_codebooks":
            raise ValueError(
                f"arch {self.cfg.name!r} takes (B, {self.cfg.n_codebooks}, S) codebook codes: "
                "LockstepEngine.generate feeds one token a slot, which the reference's forward "
                "rejects (an AssertionError in its _attn_decode); decode it through "
                f"serve_forward(mode='decode') with (B, {self.cfg.n_codebooks}, 1) codes a step")
        assert len(requests) <= self.batch
        max_prompt = max(len(r.prompt) for r in requests)
        max_new = max(r.max_new_tokens for r in requests)
        toks = np.zeros((self.batch, max_prompt), np.int32)
        for i, r in enumerate(requests):
            toks[i, max_prompt - len(r.prompt):] = r.prompt          # left-pad
        outs: List[List[int]] = [[] for _ in requests]
        last = None
        for t in range(max_prompt):
            last = self._step(toks[:, t], t)
        cur = np.argmax(last, -1).astype(np.int32)
        for i in range(len(requests)):
            outs[i].append(int(cur[i]))
        for t in range(max_prompt, max_prompt + max_new - 1):
            logits = self._step(cur, t)
            if any(r.temperature > 0 for r in requests):
                self.key, sub = prng.split(self.key)
                z = logits / np.float32(max(requests[0].temperature, 1e-4))
                cur = prng.categorical(sub, z, -1).astype(np.int32)
            else:
                cur = np.argmax(logits, -1).astype(np.int32)
            for i in range(len(requests)):
                if len(outs[i]) < requests[i].max_new_tokens:
                    outs[i].append(int(cur[i]))
        for r, o in zip(requests, outs, strict=True):
            r.out = np.asarray(o, np.int32)
            r.status = RequestStatus.FINISHED
            r.finish_reason = "length"
        return requests


class Engine:
    """Continuous-batching integer serving engine (token-budget step loop)."""

    def __init__(self, cfg: ModelConfig, folded, config: Optional[EngineConfig] = None,
                 **kw):
        config = _config_only(config, kw, "Engine")
        if not supports_continuous(cfg):
            raise EngineConfigError(f"continuous engine serves token-LM archs; arch "
                                    f"{cfg.name!r} needs LockstepEngine")
        # one-shot prefill needs every mixer to be cache-writing causal
        # attention; otherwise, and for a prompt longer than a sliding
        # window's ring, the batch-1 decode loop prefills
        self._attn_only = cfg.causal and all(m == "attn" for m, _ in slot_kinds(cfg))
        self.cfg = cfg
        self.config = config
        self.device = folded["embed"]["tokens_i8"].device
        self.folded = S.prepare_folded(cfg, folded)
        self.batch = config.batch_slots
        self.max_len = config.max_len
        self.smax = S.cache_rows(cfg, config.max_len)
        self.prefill_bucket = config.prefill_bucket
        pageable = self._attn_only and not cfg.sliding_window
        layout = config.cache_layout
        if layout == "auto":
            layout = "paged" if pageable else "contiguous"
        if layout == "paged" and not pageable:
            raise EngineConfigError(
                "cache_layout='paged' requires an all-attention, non-SWA arch; use "
                "cache_layout='auto' to fall back to contiguous")
        self.layout = layout
        self.page_size = config.page_size
        if layout != "paged" and (config.max_batched_tokens is not None
                                  or config.max_prefill_chunk is not None):
            raise EngineConfigError(
                "chunked prefill (max_batched_tokens / max_prefill_chunk) requires the "
                f"paged cache layout, but cache_layout resolved to {layout!r} for arch "
                f"{cfg.name!r}")
        self.max_batched_tokens = config.max_batched_tokens
        self.max_prefill_chunk = config.max_prefill_chunk
        if layout == "paged":
            self.reserve_policy = config.reserve_policy or "ondemand"
        elif config.reserve_policy == "ondemand":
            raise EngineConfigError(
                "reserve_policy='ondemand' requires the paged cache layout, but "
                f"cache_layout resolved to {layout!r} for arch {cfg.name!r}")
        else:
            self.reserve_policy = "full"
        # kv_bits=4 packs the paged pool; validate() refuses it on an explicit
        # contiguous layout, and 'auto' resolving to contiguous falls back to 8
        self.kv_bits = config.kv_bits
        if self.kv_bits != 8 and layout != "paged":
            warnings.warn(f"kv_bits={self.kv_bits} requires the paged cache layout, but "
                          f"cache_layout resolved to {layout!r} for arch {cfg.name!r}; "
                          "falling back to kv_bits=8", stacklevel=2)
            self.kv_bits = 8
        # speculative decoding: validate() refuses it on an explicit stripe
        # and on kv4; this guards 'auto' resolving to the stripe
        self.spec_k = config.spec_k
        if self.spec_k and layout != "paged":
            raise EngineConfigError(
                f"speculative decoding (spec_k={self.spec_k}) requires the int8 paged cache "
                f"layout, but arch {cfg.name!r} resolved to layout={layout!r}")
        self.draft = make_draft_source(config.draft) if self.spec_k else None
        self.mesh = self._tp_mesh(config)
        self.tp = 1 if self.mesh is None else self.mesh.size
        if layout == "paged":
            self.max_blocks = pages_needed(self.smax, self.page_size)
            # +1: page 0 is the reserved trash page (inactive-slot writes)
            self.n_pages = config.n_pages if config.n_pages is not None \
                else self.batch * self.max_blocks + 1
        # the cross-replica shared prefix tier (attach_prefix_tier)
        self.prefix_tier = None
        self._init_state(config.seed)

    def _tp_mesh(self, config: EngineConfig) -> Optional[TPMesh]:
        """The tensor-parallel mesh (``make_tp_mesh(tp)`` over the weights'
        device type unless one is given), checked as the reference checks
        it, or None."""
        mesh = config.mesh
        if mesh is None and config.tp != 1:
            mesh = make_tp_mesh(config.tp, self.device.type)
        if mesh is None:
            return None
        if not isinstance(mesh, TPMesh):
            raise EngineConfigError(f"mesh must be a launch.mesh.TPMesh (got "
                                    f"{type(mesh).__name__})")
        if self.layout != "paged":
            raise EngineConfigError("tensor parallelism shards the paged KV pool; the contiguous "
                                    "layout has no TP path")
        if config.tp not in (1, mesh.size):
            raise EngineConfigError(f"tp={config.tp} disagrees with the mesh's {mesh.size} ranks")
        if self.cfg.n_kv_heads % mesh.size:
            raise EngineConfigError(f"TP={mesh.size} must divide n_kv_heads={self.cfg.n_kv_heads} "
                                    "(each rank owns a whole slice of KV heads)")
        if mesh.devices[0] != self.device or any(d.type != self.device.type
                                                  for d in mesh.devices):
            raise EngineConfigError(f"the mesh's ranks {[str(d) for d in mesh.devices]} must be "
                                    f"{self.device.type} devices, rank 0 the weights' "
                                    f"{self.device}")
        return mesh

    @staticmethod
    def _zero_counters() -> Dict[str, int]:
        c: Dict = {k: 0 for k in stats_schema.COUNTERS}
        c["accept_len_hist"] = {}
        return c

    def _init_state(self, seed: int):
        self.requests: Dict[int, Request] = {}
        self._events: List[TokenEvent] = []
        self.pos = np.zeros(self.batch, np.int32)
        self.rng = np.random.default_rng(seed)
        self.counters = self._zero_counters()
        if self.layout == "paged":
            self.alloc = BlockAllocator(
                self.n_pages, self.page_size,
                bytes_per_page=S.paged_page_nbytes(self.cfg, self.page_size, self.kv_bits))
            self.sched = Scheduler(self.batch, allocator=self.alloc,
                                   max_batched_tokens=self.max_batched_tokens,
                                   max_prefill_chunk=self.max_prefill_chunk,
                                   reserve=self.reserve_policy)
            self.cache = S.init_paged_cache(self.cfg, self.n_pages, self.page_size,
                                            self.kv_bits, device=self.device, mesh=self.mesh)
            self.block_tables = np.zeros((self.batch, self.max_blocks), np.int32)
        else:
            self.alloc = None
            self.sched = Scheduler(self.batch)
            self.cache = S.init_cache(self.cfg, self.batch, self.max_len, device=self.device)

    # --- forwards --------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _decode(self, toks: np.ndarray) -> np.ndarray:
        btab = self._tensor(self.block_tables) if self.layout == "paged" else None
        logits, self.cache = S.serve_forward(
            self.cfg, self.folded, self._tensor(toks), cache=self.cache,
            pos_offset=self._tensor(self.pos), mode="decode", block_tables=btab, mesh=self.mesh)
        return logits[:, -1].cpu().numpy()

    def _verify(self, toks: np.ndarray, nrows: np.ndarray) -> np.ndarray:
        """The speculative verify forward: (B, spec_k+1) tokens at each
        slot's decode cursor, ``nrows`` real rows per slot; every row's
        logits (B, spec_k+1, V)."""
        logits, self.cache = S.serve_forward(
            self.cfg, self.folded, self._tensor(toks), cache=self.cache,
            pos_offset=self._tensor(self.pos), mode="verify",
            block_tables=self._tensor(self.block_tables), verify_rows=self._tensor(nrows),
            mesh=self.mesh)
        return logits.cpu().numpy()

    def _prefill(self, toks: np.ndarray, btab: np.ndarray, pos0: int, row: int):
        logits, self.cache = S.serve_forward(
            self.cfg, self.folded, self._tensor(toks), cache=self.cache,
            pos_offset=pos0, mode="prefill", block_tables=self._tensor(btab), mesh=self.mesh)
        return logits[0, row].cpu().numpy()

    def _bucket_len(self, ln: int) -> int:
        """Padded one-shot prefill length for the contiguous layout: a
        multiple of prefill_bucket (paged chunks pad to whole pages)."""
        return min(max(self.prefill_bucket,
                       math.ceil(ln / self.prefill_bucket) * self.prefill_bucket), self.smax)

    def _oneshot(self, ln: int) -> bool:
        """Whether a prompt of ``ln`` rows takes the one-shot prefill (else
        the batch-1 decode loop)."""
        return self._attn_only and ln <= self.smax

    def _prefill_slot(self, b: int, prompt: np.ndarray) -> np.ndarray:
        """Contiguous layout: the prefill of a prompt into slot b's stripe
        (cleared first, as the reference writes a fresh batch-1 cache over
        it).  One-shot, padded to ``_bucket_len``, where ``_oneshot``
        allows (a pad row at index r is overwritten by the decode step at
        pos == r, the step whose mask first admits it); else one batch-1
        decode step per prompt token, each counted in
        ``loop_prefill_steps``.  Returns the last prompt row's logits."""
        ln = len(prompt)
        stripe = {name: {leaf: t[:, b:b + 1] for leaf, t in c.items()}
                  for name, c in self.cache.items()}
        for c in stripe.values():
            for t in c.values():
                t.zero_()
        if self._oneshot(ln):
            toks = np.zeros((1, self._bucket_len(ln)), np.int32)
            toks[0, :ln] = prompt
            logits, _ = S.serve_forward(self.cfg, self.folded, self._tensor(toks),
                                        cache=stripe, pos_offset=0, mode="prefill")
            return logits[0, ln - 1].cpu().numpy()
        toks = self._tensor(np.asarray(prompt, np.int32).reshape(ln, 1, 1))
        for t in range(ln):
            logits, _ = S.serve_forward(self.cfg, self.folded, toks[t], cache=stripe,
                                        pos_offset=t, mode="decode")
            self.counters["loop_prefill_steps"] += 1
        return logits[0, -1].cpu().numpy()

    # --- prefix sharing ---------------------------------------------------

    @property
    def prefix_store(self):
        """The allocator-owned prefix registry (``serve/prefix.py``'s
        ``PrefixStore``), or None on the contiguous layout: what the
        router's affinity probe and the tier adoption read."""
        return self.alloc.prefix if self.layout == "paged" else None

    def attach_prefix_tier(self, tier):
        """Wire a ``SharedPrefixTier`` into this engine: prefill handoffs
        publish their sealed chains, and waiting prompts adopt matching
        chains before admission (the payload lands in freshly allocated
        pages that are registered and parked, so admission sees an ordinary
        prefix hit).  Needs the paged pool at the tier's page size, on one
        rank: under TP each rank holds only its heads of a page, so publish and
        adopt would need per-rank payload slices (refused, as the reference
        refuses it)."""
        if self.layout != "paged":
            raise EngineConfigError("a shared prefix tier needs the paged cache layout; this "
                                    f"engine resolved to {self.layout!r}")
        if self.mesh is not None:
            raise EngineConfigError("shared prefix tier under TP needs per-rank publish slices "
                                    "(ROADMAP follow-up); detach TP or the tier")
        if tier.page_size != self.page_size:
            raise EngineConfigError(f"tier page_size={tier.page_size} != engine "
                                    f"page_size={self.page_size}")
        self.prefix_tier = tier

    def _pool_leaves(self) -> List[Tuple[str, torch.Tensor]]:
        """The paged pool as ``[("<layer>.<leaf>", tensor)]``, the key space
        of a ``SealedChain``'s payload.  Every leaf (int8 or packed rows,
        kv4's page scales) has the page axis at axis 1."""
        return [(f"{name}.{leaf}", t) for name, c in self.cache.items()
                for leaf, t in c.items()]

    def _publish_prefix(self, prompt: List[int]):
        """Export the just-registered chain's pages the tier does not hold
        yet, as host copies of every pool leaf."""
        tier = self.prefix_tier
        chain = self.alloc.prefix.seal(prompt, (len(prompt) - 1) // self.page_size)
        if chain.n_pages == 0:
            return
        held = tier.match(chain.tokens(), chain.n_pages).n_pages
        if held >= chain.n_pages:
            return
        idx = torch.as_tensor(chain.pages[held:], dtype=torch.long, device=self.device)
        payload = {name: t[:, idx].cpu().numpy() for name, t in self._pool_leaves()}
        self.counters["published_pages"] += tier.publish(
            SealedChain(self.page_size, chain.keys[held:], chain.segs[held:], payload))

    def _install_pages(self, sealed: SealedChain, pages: List[int]):
        """Copy a sealed chain's payload into this pool at ``pages``: exact
        copies of the pages an identical engine computed for the same
        prefix, so what reads them later is as if they were prefilled here."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for name, t in self._pool_leaves():
            pay = sealed.payload[name]
            if pay.shape[1] != len(pages) or pay.shape[2:] != tuple(t.shape[2:]):
                raise ValueError(f"sealed payload {name} {pay.shape} does not fit the pool "
                                 f"leaf {tuple(t.shape)} at {len(pages)} pages")
            t[:, idx] = torch.as_tensor(pay, device=self.device)

    def _adopt_from_tier(self):
        """Before admission: for each waiting prompt whose local registry
        match is shorter than what the tier holds, install the missing pages
        and register the chain.  Never preempts: with the pool dry the prompt
        recomputes as if the tier did not exist."""
        al = self.alloc
        ps = self.page_size
        for _rid, item in list(self.sched.waiting):
            tokens = item.prompt_tokens() if isinstance(item, SlotState) else item.prompt
            prompt = [int(t) for t in np.asarray(tokens).reshape(-1)]
            want = (len(prompt) - 1) // ps
            if want <= 0 or al.prefix.match(prompt, want).n_pages >= want:
                continue
            sealed = self.prefix_tier.adopt(prompt, want)
            if sealed is None:
                continue
            held = al.match_prefix(prompt, want)     # refs pin the head
            if sealed.n_pages <= len(held):
                al.free_pages(held[::-1])
                continue
            fresh = al.alloc(sealed.n_pages - len(held))
            if fresh is None:                        # pool dry: recompute
                al.free_pages(held[::-1])
                continue
            self._install_pages(sealed.slice(len(held), sealed.n_pages), fresh)
            al.prefix.register(prompt[:sealed.n_pages * ps], held + fresh)
            al.free_pages((held + fresh)[::-1])      # park on the LRU
            self.counters["adopted_pages"] += len(fresh)

    # --- observability ---------------------------------------------------

    def stats(self, check: bool = False) -> Dict:
        """Instantaneous serving gauges + the cumulative ``counters``, in the
        reference's frozen schema (``serve/stats.py``)."""
        pre = [self.sched.slots[b] for b in self.sched.prefilling]
        chunk = self.max_prefill_chunk
        pending = [st.prompt_len - st.prefill_pos for st in pre]
        g = dict(
            schema_version=stats_schema.STATS_SCHEMA_VERSION,
            waiting=len(self.sched.waiting),
            decode_slots_active=len(self.sched.decoding),
            prefill_slots=len(pre),
            free_slots=self.sched.n_free,
            prefill_tokens_pending=sum(pending),
            prefill_chunks_pending=sum(-(-p // chunk) if chunk else 1 for p in pending),
            spec_k=self.spec_k,
        )
        if self.layout == "paged":
            al = self.alloc
            if check:
                al.check_invariants()
            g.update(pages_in_use=al.live, pages_free=al.free_list_pages,
                     pages_cached_lru=al.lru_pages, pages_capacity=al.capacity, tp=self.tp)
        g["counters"] = dict(self.counters)
        return stats_schema.validate_stats(g, paged=self.layout == "paged")

    def _set_table_row(self, b: int, pages: List[int]):
        self.block_tables[b, :] = 0
        self.block_tables[b, :len(pages)] = pages

    # --- request lifecycle ----------------------------------------------

    def submit(self, request: Request) -> int:
        ln = len(request.prompt)
        if ln < 1 or request.max_new_tokens < 1:
            raise ValueError(
                f"request needs a non-empty prompt and max_new_tokens >= 1 "
                f"(got prompt len {ln}, max_new_tokens {request.max_new_tokens})")
        # a sliding window's ring holds any length
        if not self.cfg.sliding_window and ln + request.max_new_tokens > self.max_len:
            raise ValueError(f"request needs {ln + request.max_new_tokens} cache rows, "
                             f"engine max_len={self.max_len}")
        if self.layout == "paged":
            worst = pages_needed(ln + request.max_new_tokens - 1, self.page_size)
            if worst > self.alloc.capacity:
                raise ValueError(f"request needs up to {worst} cache pages, pool has "
                                 f"{self.alloc.capacity} (n_pages={self.n_pages})")
        rid = self.sched.submit(request)
        request.rid = rid
        request.status = RequestStatus.WAITING
        request.finish_reason = None
        request.out = None
        self.requests[rid] = request
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a request anywhere in its lifecycle; a seated request's
        pages are freed through the ordinary eviction path.  Returns False
        when ``rid`` is unknown or already terminal."""
        req = self.requests.get(rid)
        if req is None:
            return False
        for b, st in enumerate(self.sched.slots):
            if st is not None and st.rid == rid:
                st = self.sched.evict(b)
                self.pos[b] = 0
                if self.layout == "paged":
                    self.block_tables[b, :] = 0
                emitted = st.emitted
                break
        else:
            item = self.sched.remove_waiting(rid)
            assert item is not None, f"rid {rid} tracked but not found"
            emitted = item.emitted if isinstance(item, SlotState) else []
        self._terminate(rid, req, emitted, RequestStatus.CANCELLED, "cancelled")
        self.counters["cancelled"] += 1
        return True

    def _terminate(self, rid: int, req: Request, emitted: List[int],
                   status: RequestStatus, reason: str):
        self.requests.pop(rid, None)
        req.out = np.asarray(emitted, np.int32)
        req.status = status
        req.finish_reason = reason
        self._events.append(TokenEvent(rid, None, len(emitted), True, reason))

    def _shed_expired(self):
        if not self.sched.waiting:
            return
        t = self.counters["ticks"]
        for rid, item in list(self.sched.waiting):
            req = item.request if isinstance(item, SlotState) else item
            if req.deadline_tick is None or t < req.deadline_tick:
                continue
            self.sched.remove_waiting(rid)
            emitted = item.emitted if isinstance(item, SlotState) else []
            self._terminate(rid, req, emitted, RequestStatus.CANCELLED, "deadline")
            self.counters["shed_deadline"] += 1

    def _pick_token(self, logits_row: np.ndarray, req: Request) -> int:
        if req.temperature > 0:
            z = logits_row / max(req.temperature, 1e-4)
            z = z + self.rng.gumbel(size=z.shape)
            return int(np.argmax(z))
        return int(np.argmax(logits_row))

    def _run_chunk(self, b: int, st: SlotState, pos0: int, ntok: int) -> List[TokenEvent]:
        """One prefill chunk for slot ``b``: prompt rows [pos0, pos0+ntok).
        Paged: padded to whole pages, written and read through a local
        block-table row (the shared row stays zero until handoff, so decode
        ticks cannot scribble on the slot's pages).  Contiguous: the whole
        prompt at once into the slot's stripe.  The final chunk's last real
        row hands the request into decode with no extra forward."""
        req = st.request
        prompt = np.asarray(st.prompt_tokens(), np.int32).reshape(-1)
        ln = len(prompt)
        if pos0 < st.hwm_rows:
            self.counters["recomputed_tokens"] += min(pos0 + ntok, st.hwm_rows) - pos0
        final = pos0 + ntok >= ln
        loop_prefill = False
        if self.layout == "paged":
            pad = pages_needed(ntok, self.page_size) * self.page_size
            toks = np.zeros((1, pad), np.int32)
            toks[0, :ntok] = prompt[pos0:pos0 + ntok]
            btab = np.zeros((1, self.max_blocks), np.int32)
            btab[0, :len(st.pages)] = st.pages
            last = self._prefill(toks, btab, pos0, ntok - 1)
        else:
            assert pos0 == 0 and final, "contiguous layout prefills in one whole-prompt chunk"
            loop_prefill = not self._oneshot(ln)
            last = self._prefill_slot(b, prompt)
        st.prefill_pos = pos0 + ntok
        st.chunks_done += 1
        self.counters["prefill_tokens"] += ntok
        self.counters["prefill_chunks"] += 1
        if not final:
            return []
        if self.layout == "paged":
            ptoks = [int(t) for t in prompt]
            self.alloc.register_prefix(ptoks, st.pages)
            if self.prefix_tier is not None:
                self._publish_prefix(ptoks)
            self._set_table_row(b, st.pages)
        st.tokens = None
        if st.shared_rows:
            self.counters["prefix_hits"] += 1
            self.counters["shared_rows"] += st.shared_rows
            if st.chunks_done == 1:
                self.counters["suffix_prefills"] += 1
        elif st.chunks_done == 1 and not loop_prefill:
            self.counters["oneshot_prefills"] += 1
        if st.chunks_done > 1:
            self.counters["chunked_prefills"] += 1
        self.pos[b] = ln
        st.pos = ln
        tok = self._pick_token(last, req)
        st.last_token = tok
        st.emitted.append(tok)
        req.status = RequestStatus.DECODE
        if self._done(st):
            self._finish(b)
        return [TokenEvent(st.rid, tok, len(st.emitted) - 1, req.status.terminal,
                           req.finish_reason)]

    def _finish(self, b: int):
        st = self.sched.evict(b)
        req = self.requests.pop(st.rid)
        req.out = np.asarray(st.emitted, np.int32)
        req.status = RequestStatus.FINISHED
        req.finish_reason = "eos" if (req.eos_token is not None and st.emitted
                                      and st.emitted[-1] == req.eos_token) else "length"
        self.pos[b] = 0
        if self.layout == "paged":
            self.block_tables[b, :] = 0
        self.counters["completed"] += 1

    # --- on-demand growth + preemption -----------------------------------

    def _preempt(self, b: int):
        st = self.sched.slots[b]
        was_prefilling = st.prefilling
        self.sched.preempt(b)
        st.request.status = RequestStatus.WAITING
        self.pos[b] = 0
        self.block_tables[b, :] = 0
        self.counters["preemptions"] += 1
        self.counters["preempted_prefill" if was_prefilling else "preempted_decode"] += 1
        self.counters["spilled_rows"] += st.spilled_rows

    def _grow_rows(self, b: int, st: SlotState, rows: int):
        while True:
            got = self.sched.grow(st, rows)
            if got is not None:
                self.counters["grown_pages"] += got
                break
            v = self.sched.pick_victim(exclude=frozenset({b}))
            if v is None:
                raise RuntimeError("page pool exhausted with no preemption victim; "
                                   "submit() sizing makes this unreachable")
            self._preempt(v)
        if got:
            self._set_table_row(b, st.pages)

    def _grow_decode_pages(self):
        for b in sorted(self.sched.decoding, key=lambda i: self.sched.slots[i].rid):
            st = self.sched.slots[b]
            if st is None:              # preempted by an earlier grower
                continue
            self._grow_rows(b, st, st.pos + 1)

    def _done(self, st: SlotState) -> bool:
        req = st.request
        if len(st.emitted) >= req.max_new_tokens:
            return True
        return req.eos_token is not None and bool(st.emitted) and \
            st.emitted[-1] == req.eos_token

    # --- speculative decode (draft-then-verify) --------------------------

    def _spec_tick(self) -> Optional[List[TokenEvent]]:
        """One speculative decode tick (the reference's): propose, grow,
        verify, greedily accept.  Returns None when no slot has proposals
        (the plain decode forward runs instead).

        1. propose: up to ``k_b = min(spec_k, max_new - emitted - 1)``
           tokens per greedy decoding slot (the bonus token fills the
           budget, so the furthest verify row stays at plain decode's worst
           case); sampled slots are never drafted for.
        2. grow (on-demand): each proposing slot's chain to cover its verify
           rows, in rid order, preempting like ``_grow_decode_pages``; a slot
           preempted by an earlier grower drops its proposals.
        3. verify: one (B, spec_k+1) forward; slots without proposals ride
           along with one real row (their plain decode step).
        4. accept: per slot, walk the rows while the proposals match the
           argmax chain; emit the accepted tokens and the first divergent
           (or bonus) one, cut by ``max_new_tokens``/EOS as plain decode
           would.  The write cursor advances over committed tokens only;
           rejected rows above it are rewritten before they are read.  The
           forward counts one ``decode_steps``."""
        active = self.sched.decoding
        props: Dict[int, List[int]] = {}
        for b in active:
            st = self.sched.slots[b]
            req = st.request
            if req.temperature > 0:
                continue                    # greedy acceptance only
            k_b = min(self.spec_k, req.max_new_tokens - len(st.emitted) - 1)
            if k_b <= 0:
                continue
            ctx = np.concatenate([np.asarray(req.prompt, np.int64).reshape(-1),
                                  np.asarray(st.emitted, np.int64)])
            p = [int(t) for t in self.draft.propose(ctx, k_b)[:k_b]]
            if p:
                props[b] = p
        if not props:
            return None
        if self.reserve_policy == "ondemand":
            for b in sorted(props, key=lambda i: self.sched.slots[i].rid
                            if self.sched.slots[i] is not None else -1):
                st = self.sched.slots[b]
                if st is None:              # preempted by an earlier grower
                    continue
                self._grow_rows(b, st, st.pos + 1 + len(props[b]))
        active = self.sched.decoding        # growth may have preempted
        live = set(active)
        props = {b: p for b, p in props.items() if b in live}
        if not props:
            return None
        toks = np.zeros((self.batch, self.spec_k + 1), np.int32)
        nrows = np.ones((self.batch,), np.int32)
        for b in active:
            toks[b, 0] = self.sched.slots[b].last_token
        for b, p in props.items():
            toks[b, 1:1 + len(p)] = p
            nrows[b] = 1 + len(p)
        rows = self._verify(toks, nrows)    # (B, spec_k+1, V)
        events: List[TokenEvent] = []
        n_emitted = 0
        for b in active:
            st = self.sched.slots[b]
            req = st.request
            p = props.get(b, [])
            emit: List[int] = []
            j = 0
            while True:
                tok = self._pick_token(rows[b, j], req)
                emit.append(tok)
                if len(st.emitted) + len(emit) >= req.max_new_tokens or (
                        req.eos_token is not None and tok == req.eos_token):
                    break                   # the request finishes on this token
                if j < len(p) and p[j] == tok:
                    j += 1                  # proposal matched: next row
                    continue
                break                       # divergence: tok is the repair
            if p:
                n_acc = sum(1 for i in range(min(len(emit), len(p))) if p[i] == emit[i])
                self.counters["drafted"] += len(p)
                self.counters["accepted"] += n_acc
                self.counters["rejected"] += len(p) - n_acc
                h = self.counters["accept_len_hist"]
                h[n_acc] = h.get(n_acc, 0) + 1
            for tok in emit:
                st.last_token = tok
                st.emitted.append(tok)
                self.pos[b] += 1
                st.pos += 1
                done = self._done(st)
                if done:
                    self._finish(b)
                events.append(TokenEvent(st.rid, tok, len(st.emitted) - 1,
                                         req.status.terminal, req.finish_reason))
                if done:
                    break
            n_emitted += len(emit)
        self.counters["decode_steps"] += 1
        self.counters["decode_tokens"] += n_emitted
        return events

    # --- the engine loop ------------------------------------------------

    def poll(self) -> List[TokenEvent]:
        """One scheduler tick (see the module docstring)."""
        self.counters["ticks"] += 1
        self._shed_expired()
        events = self._events
        self._events = []
        if self.prefix_tier is not None and self.sched.waiting:
            self._adopt_from_tier()     # adopted pages surface as ordinary prefix hits
        for _b, st in self.sched.admit():
            st.request.status = RequestStatus.PREFILL
            if st.preemptions:
                self.counters["restores"] += 1
        if self.layout == "paged" and self.sched.waiting and self.sched.n_free > 0:
            self.counters["pool_wait_ticks"] += 1
        n_decode = len(self.sched.decoding)
        used = 0
        chunked: set = set()
        while True:
            plan = self.sched.next_chunk(n_decode, used, exclude=frozenset(chunked))
            if plan is None:
                break
            b, st, pos0, ntok = plan
            chunked.add(b)
            used += ntok + (pos0 + ntok >= st.prompt_len)
            events.extend(self._run_chunk(b, st, pos0, ntok))
        for b in self.sched.prefilling:
            st = self.sched.slots[b]
            st.starved_ticks = 0 if b in chunked else st.starved_ticks + 1
        if self.layout == "paged" and self.reserve_policy == "ondemand":
            self._grow_decode_pages()
        active = self.sched.decoding
        if self.layout == "paged":
            self.counters["cache_pages_peak"] = self.alloc.peak_live
        if not active:
            return events
        if self.draft is not None:
            spec = self._spec_tick()
            if spec is not None:            # the verify forward ran this tick
                events.extend(spec)
                self.counters["cache_pages_peak"] = self.alloc.peak_live
                return events
        toks = np.zeros((self.batch, 1), np.int32)
        for b in active:
            toks[b, 0] = self.sched.slots[b].last_token
        rows = self._decode(toks)
        for b in active:
            st = self.sched.slots[b]
            req = st.request
            self.pos[b] += 1
            st.pos += 1
            tok = self._pick_token(rows[b], req)
            st.last_token = tok
            st.emitted.append(tok)
            if self._done(st):
                self._finish(b)
            events.append(TokenEvent(st.rid, tok, len(st.emitted) - 1,
                                     req.status.terminal, req.finish_reason))
        self.counters["decode_steps"] += 1
        self.counters["decode_tokens"] += len(active)
        return events

    @property
    def has_work(self) -> bool:
        return bool(self._events) or self.sched.has_work

    def step(self) -> List[Tuple[int, int]]:
        """One tick, as (rid, token) pairs (token-less terminal events dropped)."""
        return [(e.rid, e.token) for e in self.poll() if e.token is not None]

    def run(self) -> List[Tuple[int, int]]:
        out = []
        while self.has_work:
            out.extend(self.step())
        return out

    def generate(self, requests: List[Request]) -> List[Request]:
        """Submit everything, drain, return the requests with ``.out`` filled."""
        for r in requests:
            self.submit(r)
        self.run()
        return requests
