"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
        --steps 50 --ckpt-dir /tmp/ck --device cpu

``--smoke`` uses the reduced same-family config (CPU-runnable); without it
the full published config trains on the card (``--device cuda``, the
default).  Every arch of ``configs/`` trains, the recurrent ones included
(``--arch xlstm-1.3b``, ``--arch jamba-1.5-large-398b``).  The mesh is
``make_host_mesh`` over the visible ``--device`` devices (FSDP unless
``--smoke``), or the production mesh with ``--production-mesh`` (16 x 16;
2 x 16 x 16 with ``--multi-pod``), which raises on fewer than 256 or 512
devices.  One process drives every rank of it.

``--nproc N`` instead trains on an (N / M, M) mesh of N processes
(``--model M``, default 1), one a rank (``launch/ranks.py``), joined over
``--backend``: gloo on the CPU or with the ranks sharing one card where
there are fewer cards than ranks, NCCL with a card for each rank (it raises
otherwise)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
        --steps 4 --nproc 2 --device cpu

``--model-compute split`` splits the compute over the model axis
(Megatron's tensor parallelism, ``jit_train_step``'s ``model_compute``);
the default ``gather`` gathers each leaf whole::

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
        --steps 2 --nproc 2 --model 2 --model-compute split --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import functools

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import ranks
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainerConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="any config of configs/, e.g. yi-6b, xlstm-1.3b, jamba-1.5-large-398b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--global-batch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--quant-moments", action="store_true")
    ap.add_argument("--grad-compress", type=int, default=0)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nproc", type=int, default=0,
                    help="ranks, one process each, on an (N, 1) mesh; 0: one process drives "
                         "every rank")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--model", type=int, default=1,
                    help="the model axis of the --nproc mesh: (N / M, M)")
    ap.add_argument("--model-compute", choices=("gather", "split"), default="gather",
                    help="gather each leaf whole, or split the compute over the model axis")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.grad_compress:
        cfg = dataclasses.replace(cfg, quant=dataclasses.replace(
            cfg.quant, grad_compress_bits=args.grad_compress))
    shape = SHAPES[args.shape]
    if args.seq_len or args.global_batch:
        shape = ShapeConfig("custom", args.seq_len or shape.seq_len,
                            args.global_batch or shape.global_batch, "train")
    kind = torch.device(args.device).type
    if args.nproc and args.production_mesh:
        raise ValueError("--nproc runs an (N / M, M) mesh; the production mesh is one process's")
    if args.nproc % args.model or (args.model > 1 and not args.nproc):
        raise ValueError(f"--model {args.model} needs --nproc, a multiple of it")
    n = args.nproc
    if not n:
        mesh = (make_production_mesh(multi_pod=args.multi_pod, device_type=kind)
                if args.production_mesh else make_host_mesh(device_type=kind))
        n = mesh.size
    if args.smoke and args.shape == "train_4k" and not args.seq_len:
        shape = ShapeConfig("smoke", 128, min(8, n // args.model * 4), "train")
    opt_cfg = AdamWConfig(lr=args.lr, quantize_moments=args.quant_moments)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, accum_steps=args.accum)
    if args.nproc:
        ranks.run(functools.partial(ranks.train_on_ranks, cfg, shape, opt_cfg, tcfg,
                                    mesh_shape=(n // args.model, args.model), device_type=kind,
                                    fsdp=not args.smoke, log=True,
                                    model_compute=args.model_compute),
                  n, backend=args.backend, device_type=kind)
        return

    def log(step, m):
        print(f"step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
              f"gnorm {m['grad_norm']:.3f} {m['step_s'] * 1e3:.0f} ms", flush=True)

    train(cfg, shape, opt_cfg, tcfg, mesh=mesh, fsdp=not args.smoke, log_fn=log,
          model_compute=args.model_compute)


if __name__ == "__main__":
    main()
