"""Fault-tolerance / elasticity example: train, "crash", resume on a mesh of
another shape (elastic resize) with the state restored bit for bit.

    PYTHONPATH=src python -m repro_torch.launch.elastic_resume [--ranks 4] [--device cpu]

The counterpart of ``examples/elastic_resume.py``: the same smoke yi-6b (2
layers, d_model 64, vocab 128), (4, 32) batches and AdamW, no FSDP.  Phase
1 trains 6 steps on a (1, 1) mesh with a checkpoint every 3; phase 2
resumes from the newest checkpoint on a (``--ranks``, 1) mesh over the one
device named ``--ranks`` times and trains to step 10, running only steps 6
to 9 (exactly-once data).  The checkpoints live in a temporary directory.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainerConfig, train


def data_mesh(device, ranks: int) -> Mesh:
    """A (ranks, 1) mesh over ``device`` named ``ranks`` times."""
    return Mesh(np.array([torch.device(device)] * ranks, dtype=object).reshape(ranks, 1),
                ("data", "model"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = smoke_config("yi-6b", n_layers=2, d_model=64, vocab_size=128)
    shape = ShapeConfig("demo", 32, 4, "train")
    opt = AdamWConfig(lr=1e-3)

    def log(s, m):
        print(f"  step {s} loss {m['loss']:.4f}")

    with tempfile.TemporaryDirectory(prefix="elastic_") as ckdir:
        print("phase 1 (mesh 1x1):")
        train(cfg, shape, opt, TrainerConfig(steps=6, ckpt_every=3, ckpt_dir=ckdir, log_every=2),
              mesh=data_mesh(args.device, 1), fsdp=False, log_fn=log)
        print(f"checkpoints: {sorted(p.name for p in Path(ckdir).iterdir())}")
        print(f"phase 2 (elastic resume on mesh {args.ranks}x1):")
        shards, hist = train(cfg, shape, opt,
                             TrainerConfig(steps=10, ckpt_every=5, ckpt_dir=ckdir, log_every=2),
                             mesh=data_mesh(args.device, args.ranks), fsdp=False, log_fn=log)
    print(f"resumed and finished at step {int(shards[0].step)} "
          f"(ran {len(hist)} new steps — exactly-once data)")
    return shards, hist


if __name__ == "__main__":
    main()
