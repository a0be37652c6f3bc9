"""Continuous-batching serving example: calibrate, fold to integers, then
stream mixed-length requests through the slot-table engine (quantized KV
cache, integer prefill, per-slot positions, greedy decode).

    PYTHONPATH=src python -m repro_torch.launch.serve_quantized --arch yi-6b
    PYTHONPATH=src python -m repro_torch.launch.serve_quantized --arch mixtral-8x22b
    PYTHONPATH=src python -m repro_torch.launch.serve_quantized --device cpu

The counterpart of ``examples/serve_quantized.py``: a smoke-sized model of
``--arch``, the same flags, engine (``make_engine`` at ``max_len`` 128) and
request stream (``np.random.default_rng(0)``: prompts of 4-23 tokens), plus
``--device`` (the card by default).  The weights come from
``calibrated_folded`` at seed 0, so they are not the reference's.  Prints
each request's output and the engine's stats.
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.launch.serve import calibrated_folded
from repro_torch.serve.engine import EngineConfig, Request, make_engine


def requests(cfg, n: int, max_new: int) -> List[Request]:
    """``n`` requests of 4-23 random prompt tokens: more than the slots, so
    the scheduler streams them through mid-flight."""
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        (int(rng.integers(4, 24)),)).astype(np.int32),
                    max_new_tokens=max_new)
            for _ in range(n)]


def serve(cfg, folded, slots: int, n_requests: int, max_new: int):
    """The example's requests through ``make_engine``; returns the engine
    and the finished requests."""
    eng = make_engine(cfg, folded, EngineConfig(batch_slots=slots, max_len=128))
    return eng, eng.generate(requests(cfg, n_requests, max_new))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch)
    folded = calibrated_folded(cfg, 0, device=args.device)
    eng, reqs = serve(cfg, folded, args.slots, args.requests, args.max_new)
    for i, r in enumerate(reqs):
        print(f"req{i}: prompt[{len(r.prompt)}]={r.prompt[:6].tolist()}.. "
              f"-> {r.out.tolist()}")
    if hasattr(eng, "stats"):
        print(f"engine stats: {eng.stats()}")
    return reqs


if __name__ == "__main__":
    main()
