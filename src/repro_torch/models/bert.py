"""BERT-base (the paper's own model): the bidirectional encoder of
``transformer.py`` with an SST-2-style classification head.

The float QAT forward of the reference ``models/bert.py``: [CLS] hidden
state -> pooler (quantization-aware linear) -> tanh -> classifier.  It runs
as plain PyTorch on any device; ``bert_classify`` records autograd for the
fine-tuning step (``train.steps.make_bert_train_step``, each layer
recomputed in the backward under ``cfg.remat``), ``bert_forward`` is a
calibration entry (no autograd).  The integer serving path has no
classifier head (``serve_int.serve_forward`` serves the encoder and its
LM head).  The paper's operating point is seq 128, batch 1 (config
``bert-base``, shape ``paper_128``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def init_bert_params(cfg: ModelConfig, gen: torch.Generator, n_classes: int = 2) -> Dict:
    """Random float weights from ``gen`` (on ``gen.device``): the backbone,
    the pooler and the classifier."""
    d = cfg.d_model
    dev = gen.device

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(cfg.dtype)

    return {
        "backbone": T.init_params(cfg, gen),
        "pooler": {"w": normal(d, d), "b": torch.zeros((d,), dtype=cfg.dtype, device=dev)},
        "classifier": {"w": normal(d, n_classes),
                       "b": torch.zeros((n_classes,), dtype=cfg.dtype, device=dev)},
    }


def init_bert_amax(cfg: ModelConfig, device="cuda") -> Dict:
    a = T.init_amax(cfg, device)
    a["pool_in"] = torch.zeros((), dtype=torch.float32, device=device)
    a["cls_in"] = torch.zeros((), dtype=torch.float32, device=device)
    return a


def _mask4(tokens: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, S) padding mask (True = token) -> (B, 1, S, S) attention mask."""
    b, s = tokens.shape
    if attn_mask is None:
        attn_mask = torch.ones((b, s), dtype=torch.bool, device=tokens.device)
    return attn_mask[:, None, None, :].expand(b, 1, s, s)


def _backbone_amax(amax: Dict) -> Dict:
    return {k: amax[k] for k in ("blocks", "embed_out", "head_in")}


@torch.no_grad()
def bert_forward(cfg: ModelConfig, params: Dict, amax: Dict, tokens: torch.Tensor,
                 attn_mask: Optional[torch.Tensor] = None):
    """Masked-LM forward.  Returns (mlm_logits, obs, aux)."""
    return T.forward(cfg, params["backbone"], _backbone_amax(amax), tokens,
                     mask=_mask4(tokens, attn_mask))


def bert_classify(cfg: ModelConfig, params: Dict, amax: Dict, tokens: torch.Tensor,
                  attn_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """Classification forward: pooled [CLS] -> tanh -> classifier.  Returns
    (logits (B, n_classes) float32, obs, aux)."""
    hidden, obs, aux = forward_hidden(cfg, params["backbone"], _backbone_amax(amax), tokens,
                                      _mask4(tokens, attn_mask))
    policy = cfg.quant
    pooled, ob_p = L.qdense(hidden[:, 0], params["pooler"]["w"], params["pooler"]["b"],
                            amax["pool_in"], policy)
    logits, ob_c = L.qdense(torch.tanh(pooled), params["classifier"]["w"],
                            params["classifier"]["b"], amax["cls_in"], policy)
    obs = dict(obs, pool_in=ob_p, cls_in=ob_c)
    return logits.to(torch.float32), obs, aux


def forward_hidden(cfg: ModelConfig, params: Dict, amax: Dict, tokens: torch.Tensor,
                   mask: torch.Tensor):
    """Backbone forward that returns the final hidden states (pre-LM-head),
    the observations and the aux loss."""
    return T.hidden(cfg, params, amax, tokens, mask=mask)
