"""Serving launcher: calibrate (one QAT forward), fold to integers, run
batched generation through the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --prompts 4 --max-new 16             # full width, on the card

``--device cpu`` runs the plain PyTorch path (use ``--smoke`` there).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import fold as F
from repro_torch.models import transformer as T
from repro_torch.serve.engine import EngineConfig, Request, make_engine


def calibrated_folded(cfg, seed: int = 0, calib_tokens=None, device="cuda"):
    """Random float weights from ``seed``, one calibration forward over
    ``calib_tokens`` (default: (2, 32) seeded tokens), folded to the integer
    serving form.  The float weights are freed before returning."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is False; pass "
                           "device='cpu' to run the plain PyTorch path")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = T.init_params(cfg, gen)
    if calib_tokens is None:
        calib_tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen, device=dev)
    _, obs, _ = T.forward(cfg, params, T.init_amax(cfg, dev), calib_tokens.to(dev))
    folded = F.fold_params(cfg, params, obs)
    del params
    return folded


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    folded = calibrated_folded(cfg, 0, device=args.device)
    eng = make_engine(cfg, folded, EngineConfig(batch_slots=args.prompts,
                                                max_len=args.max_len))
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, (args.prompt_len,)
                                        ).astype(np.int32),
                    max_new_tokens=args.max_new, temperature=args.temperature)
            for _ in range(args.prompts)]
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in out)
    print(f"generated {n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s "
          f"batch={args.prompts}, device={eng.device})")
    for i, r in enumerate(out[:2]):
        print(f"req{i}: {r.out[:12].tolist()}...")


if __name__ == "__main__":
    main()
