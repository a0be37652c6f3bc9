"""Training loop: data -> train step over a device mesh -> metrics ->
periodic checkpoints, with crash-resume (exactly-once data) and elastic-mesh
restore, as the reference ``train/trainer.py``.

Node failure handling is restart-from-checkpoint (``checkpoint.py`` is
atomic and its checkpoints hold whole leaves, so a run resumes on a mesh of
any shape); ``watchdog_s`` aborts the run after a step that took longer, so
a job supervisor can reschedule it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import make_source
from repro_torch.launch.mesh import Mesh, ProcessMesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import partition as Pt
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import steps as St


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    accum_steps: int = 1
    seed: int = 0
    watchdog_s: float = 0.0     # 0 = off; else abort after a step that exceeds this
    keep_ckpts: int = 3


def train(cfg: ModelConfig, shape: ShapeConfig, opt_cfg: AdamWConfig, tcfg: TrainerConfig,
          *, mesh: Optional[Mesh] = None, fsdp: bool = True, device="cuda",
          log_fn: Callable[[int, Dict], None] | None = None, model_compute: str = "gather"):
    """Train ``cfg`` from ``tcfg.seed`` (or from the newest checkpoint in
    ``tcfg.ckpt_dir``, whatever mesh wrote it, resuming at its data step) to
    ``tcfg.steps``.  With ``mesh`` the state lives split over its ranks per
    ``jit_train_step``'s shardings (``fsdp`` as there) and the call returns
    (the ranks' states in rank order, the metrics of each step this call
    ran); on a ``ProcessMesh`` every rank calls ``train`` and gets (its own
    state, the metrics); without a mesh it trains on ``device`` alone, a
    (1, 1) mesh, and returns (the state, the metrics).  ``model_compute`` as
    ``jit_train_step``'s: a checkpoint holds the same whole leaves under
    either."""
    run_mesh = mesh if mesh is not None else Mesh(np.array([[torch.device(device)]],
                                                           dtype=object), ("data", "model"))
    if any(d.type == "cuda" for d in run_mesh.devices) and not torch.cuda.is_available():
        raise RuntimeError("a cuda device was asked for but torch.cuda.is_available() is False; "
                           "pass device='cpu' (or a CPU mesh) to train on the CPU")
    proc = isinstance(run_mesh, ProcessMesh)
    dev0 = run_mesh.device if proc else run_mesh.devices[0]
    source = make_source(cfg, shape, seed=tcfg.seed)
    example = {k: torch.empty(v.shape, dtype=torch.as_tensor(v[:0]).dtype, device="meta")
               for k, v in source.batch_at(0).items()}
    Pt.set_mesh_ctx(run_mesh)
    try:
        step_fn, state_sh, _ = St.jit_train_step(cfg, run_mesh, opt_cfg, example, fsdp=fsdp,
                                                 accum_steps=tcfg.accum_steps,
                                                 model_compute=model_compute)
        start_step, shards = 0, None
        last = ckpt.latest_step(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
        if last is not None:
            shards, meta = ckpt.restore(tcfg.ckpt_dir, last, St.state_shape(cfg, opt_cfg),
                                        shardings=state_sh)
            start_step = int(meta.get("data_step", last))
        if shards is None and proc:
            shards = St.init_rank_state(cfg, opt_cfg, state_sh, run_mesh, tcfg.seed)
        elif shards is None:
            gen = torch.Generator(device=dev0)
            gen.manual_seed(tcfg.seed)
            state = St.init_train_state(cfg, gen, opt_cfg)
            # one rank holds every leaf whole on its device: the state itself
            shards = [state] if run_mesh.size == 1 else Pt.split_tree(state, state_sh)
            del state

        history = []
        for step in range(start_step, tcfg.steps):
            batch = {k: torch.as_tensor(v, device=dev0) for k, v in source.batch_at(step).items()}
            t0 = time.perf_counter()
            shards, metrics = step_fn(shards, batch)
            metrics = {k: float(v) for k, v in metrics.items()}   # waits for the device
            dt = time.perf_counter() - t0
            if tcfg.watchdog_s and dt > tcfg.watchdog_s:
                raise TimeoutError(f"step {step} took {dt:.1f}s > watchdog {tcfg.watchdog_s}s")
            metrics["step_s"] = dt
            history.append(metrics)
            if log_fn and (step % tcfg.log_every == 0 or step == tcfg.steps - 1):
                log_fn(step, metrics)
            if tcfg.ckpt_dir and ((step + 1) % tcfg.ckpt_every == 0 or step == tcfg.steps - 1):
                ckpt.save(tcfg.ckpt_dir, step + 1, shards,
                          meta={"data_step": step + 1, "arch": cfg.name}, shardings=state_sh)
                if not proc or run_mesh.rank == 0:
                    ckpt.gc_old(tcfg.ckpt_dir, tcfg.keep_ckpts)
        return (shards[0] if mesh is None else shards), history
    finally:
        Pt.set_mesh_ctx(None)
