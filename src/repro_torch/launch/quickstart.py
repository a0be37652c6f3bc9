"""Quickstart: quantize a model with the FQ pipeline and compare float vs
fully-integer inference.

    PYTHONPATH=src python -m repro_torch.launch.quickstart                # on the card
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu   # plain PyTorch

A smoke-sized model (``--arch``, yi-6b by default) with random float
weights from seed 0: the float QAT forward observes the activation
maxima (paper Eq. 3), the fold turns the weights into the integer serving
form (paper Eq. 1-5: packed int4 weights, int32 biases, fixed-point
multipliers, LUT tables), and the cache-less integer forward runs the same
tokens — on the card through the CUDA kernels, its causal attention
through ``flash_qattention``.  Prints the float-vs-integer KL and argmax
agreement.
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch

from repro_torch.configs import smoke_config
from repro_torch.models import fold as F
from repro_torch.models import serve_int as S
from repro_torch.models import transformer as T


@torch.no_grad()
def quickstart(cfg, params: Dict, amax: Dict, tokens: torch.Tensor) -> Dict:
    """Calibrate on ``tokens``, fold, and run the integer forward on them.
    Returns the float and integer logits, their KL (the float model's
    distribution against the integer one's, averaged over positions) and
    the share of positions where their argmax agrees."""
    logits_f, obs, _ = T.forward(cfg, params, amax, tokens)
    folded = F.fold_params(cfg, params, obs)
    logits_i, _ = S.serve_forward(cfg, folded, tokens)
    log_pf = torch.log_softmax(logits_f, -1)
    kl = torch.mean(torch.sum(log_pf.exp() * (log_pf - torch.log_softmax(logits_i, -1)), -1))
    agree = (logits_f.argmax(-1) == logits_i.argmax(-1)).float().mean()
    return dict(logits_f=logits_f, logits_i=logits_i, kl=float(kl), agree=float(agree))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False; pass "
                         "--device cpu to run the plain PyTorch path")
    cfg = smoke_config(args.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = T.init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen, device=dev)
    r = quickstart(cfg, params, T.init_amax(cfg, dev), tokens)
    print(f"{cfg.name} on {dev}: fp-vs-integer KL: {r['kl']:.5f}")
    print(f"argmax agreement: {r['agree']:.3f}")


if __name__ == "__main__":
    main()
