"""Training loop: data -> train step -> metrics -> periodic checkpoints,
with crash-resume (exactly-once data), as the reference ``train/
trainer.py`` without its mesh (ROADMAP Open items §1, item 8): one device.

Node failure handling is restart-from-checkpoint (``checkpoint.py`` is
atomic); ``watchdog_s`` aborts the run after a step that took longer, so a
job supervisor can reschedule it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import make_source
from repro_torch.optim.adamw import AdamWConfig
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
          *, device="cuda", log_fn: Callable[[int, Dict], None] | None = None):
    """Train ``cfg`` from ``tcfg.seed`` (or from the newest checkpoint in
    ``tcfg.ckpt_dir``, resuming at its data step) to ``tcfg.steps``.
    Returns (state, the metrics of each step this call ran)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is False; pass "
                           "device='cpu' to train on the CPU")
    source = make_source(cfg, shape, seed=tcfg.seed)
    step_fn = St.make_train_step(cfg, opt_cfg, accum_steps=tcfg.accum_steps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(tcfg.seed)
    state = St.init_train_state(cfg, gen, opt_cfg)
    start_step = 0
    last = ckpt.latest_step(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
    if last is not None:
        state, meta = ckpt.restore(tcfg.ckpt_dir, last, state)
        start_step = int(meta.get("data_step", last))

    history = []
    for step in range(start_step, tcfg.steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in source.batch_at(step).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}   # waits for the device
        dt = time.perf_counter() - t0
        if tcfg.watchdog_s and dt > tcfg.watchdog_s:
            raise TimeoutError(f"step {step} took {dt:.1f}s > watchdog {tcfg.watchdog_s}s")
        metrics["step_s"] = dt
        history.append(metrics)
        if log_fn and (step % tcfg.log_every == 0 or step == tcfg.steps - 1):
            log_fn(step, metrics)
        if tcfg.ckpt_dir and ((step + 1) % tcfg.ckpt_every == 0 or step == tcfg.steps - 1):
            ckpt.save(tcfg.ckpt_dir, step + 1, state,
                      meta={"data_step": step + 1, "arch": cfg.name})
            ckpt.gc_old(tcfg.ckpt_dir, tcfg.keep_ckpts)
    return state, history
