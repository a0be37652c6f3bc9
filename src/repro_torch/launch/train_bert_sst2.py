"""The paper's own experiment (Table I) on the port: QAT fine-tune a small
BERT on an SST-2-style binary classification task, then measure the held-out
accuracy under fully-quantized (FQ) execution against fp32 execution.
Synthetic data stands in for GLUE offline.

    PYTHONPATH=src python -m repro_torch.launch.train_bert_sst2 [--steps 150]
    PYTHONPATH=src python -m repro_torch.launch.train_bert_sst2 --device cpu

The counterpart of ``examples/train_bert_sst2.py``: the same task, flags,
defaults (d_model 128, 2 layers, 150 steps at (16, 32), AdamW at lr 1e-3)
and printed lines, plus ``--device`` (the card by default).  The weights
come from a ``torch.Generator`` seeded with 0, so they are not the
reference's; the train step and ``bert_classify`` are the float fake-quant
of ``train/steps.py`` and ``models/bert.py`` and launch no kernel.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.policy import POLICY_FP32
from repro_torch.models import bert as B
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import steps as St

HELD_OUT = range(1000, 1010)      # the held-out batches' seeds


def make_batch(vocab: int, step: int, b: int = 16, s: int = 32) -> Dict[str, np.ndarray]:
    """The synthetic sentiment task, seeded by ``step``: random tokens with
    4-11 "sentiment" tokens after [CLS] (< 16 positive, 16..31 negative);
    the label says whether the positive ones outnumber the negative ones."""
    rng = np.random.default_rng(step)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    n_sent = rng.integers(4, 12, (b,))
    for i in range(b):
        sent = rng.integers(0, 32, (n_sent[i],))
        toks[i, 1:1 + n_sent[i]] = sent
    labels = ((toks < 16).sum(1) > ((toks >= 16) & (toks < 32)).sum(1))
    return {"tokens": toks, "mask": np.ones((b, s), bool), "labels": labels.astype(np.int32)}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def sst2_config(d_model: int = 128):
    return smoke_config("bert-base", d_model=d_model, n_layers=2)


def train(cfg, state: St.TrainState, opt: AdamWConfig, steps: int, device,
          log=print) -> tuple:
    """``steps`` QAT steps of ``make_bert_train_step`` on the task's
    batches 0..steps-1, logging every 25th step's and the last's loss and
    accuracy.  Returns the new state and every step's (loss, acc)."""
    step_fn = St.make_bert_train_step(cfg, opt)
    history: List[tuple] = []
    for step in range(steps):
        state, m = step_fn(state, to_device(make_batch(cfg.vocab_size, step), device))
        history.append((float(m["loss"]), float(m["acc"])))
        if step % 25 == 0 or step == steps - 1:
            log(f"step {step:4d} loss {history[-1][0]:.4f} acc {history[-1][1]:.3f}")
    return state, history


@torch.no_grad()
def held_out(cfg, params, amax, device) -> Dict[str, float]:
    """Mean accuracy over the held-out batches of the QAT forward under the
    config's policy (``fq``) and under ``POLICY_FP32`` (``fp32``)."""
    accs = {"fq": [], "fp32": []}
    cfg_fp = dataclasses.replace(cfg, quant=POLICY_FP32)
    for step in HELD_OUT:
        b = to_device(make_batch(cfg.vocab_size, step), device)
        for name, c in (("fq", cfg), ("fp32", cfg_fp)):
            lg, _, _ = B.bert_classify(c, params, amax, b["tokens"], b["mask"])
            accs[name].append(float((lg.argmax(-1) == b["labels"]).float().mean()))
    return {k: float(np.mean(v)) for k, v in accs.items()}


def report(accs: Dict[str, float]) -> str:
    return (f"held-out acc  FQ(QAT)={accs['fq']:.3f}  fp32-exec={accs['fp32']:.3f}  "
            f"drop={accs['fp32'] - accs['fq']:.3f} (paper: 0.8% on SST-2)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False; pass "
                         "--device cpu to run on the CPU")
    cfg = sst2_config(args.d_model)
    opt = AdamWConfig(lr=1e-3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state, history = train(cfg, St.init_bert_train_state(cfg, gen, opt), opt, args.steps, dev)
    accs = held_out(cfg, state.params, state.amax, dev)
    print(report(accs))
    return state, history, accs


if __name__ == "__main__":
    main()
