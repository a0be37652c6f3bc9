"""Serving launcher: calibrate (one QAT forward), fold to integers, run
batched generation through the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --prompts 4 --max-new 16             # full width, on the card

``--device cpu`` runs the plain PyTorch path (use ``--smoke`` there).
``--kv-bits 4`` packs the paged KV pool to int4; ``--layout contiguous``
serves from per-slot contiguous stripes instead of the paged pool.  The
recurrent archs (``--arch xlstm-1.3b``, ``--arch jamba-1.5-large-398b``)
resolve to the contiguous layout and prefill through the batch-1 decode
loop; at full depth jamba does not fit one card (its calibration holds
every float weight).
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


@torch.no_grad()
def calibrated_folded(cfg, seed: int = 0, calib_tokens=None, device="cuda"):
    """Random float weights from ``seed``, one calibration forward over
    ``calib_tokens``, folded to the integer serving form.  The default
    tokens are seeded, (2, 32) for a causal LM ((2, K, 32) codebook codes
    for an audio arch) and (2, 128) for an encoder (BERT's operating point,
    seq 128).  The float weights are freed before returning."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is False; pass "
                           "device='cpu' to run the plain PyTorch path")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = T.init_params(cfg, gen)
    if calib_tokens is None:
        rows = (cfg.n_codebooks,) if cfg.frontend == "audio_codebooks" else ()
        calib_tokens = torch.randint(0, cfg.vocab_size, (2, *rows, 32 if cfg.causal else 128),
                                     generator=gen, device=dev)
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
    ap.add_argument("--kv-bits", type=int, choices=(8, 4), default=8)
    ap.add_argument("--layout", choices=("auto", "paged", "contiguous"), default="auto")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    folded = calibrated_folded(cfg, 0, device=args.device)
    eng = make_engine(cfg, folded, EngineConfig(batch_slots=args.prompts,
                                                max_len=args.max_len, kv_bits=args.kv_bits,
                                                cache_layout=args.layout))
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
          f"batch={args.prompts}, device={eng.device}, layout={eng.layout}, "
          f"kv_bits={eng.kv_bits})")
    for i, r in enumerate(out[:2]):
        print(f"req{i}: {r.out[:12].tolist()}...")


if __name__ == "__main__":
    main()
