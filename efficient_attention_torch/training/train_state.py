"""Evaluation step of the ViT (``efficient_attention_tpu/training/
train_state.py:187-200``, reference ``vit/engine.py:76-107``).  The train
step, optimizer and EMA are ROADMAP.md Queue 1, item 3."""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


@torch.no_grad()
def vit_eval_step(model: Callable[[torch.Tensor], torch.Tensor],
                  images: torch.Tensor,
                  labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Top-1, top-5 and cross-entropy of ``model(images)``, as scalars on
    the model's device (metrics in float32)."""
    logits = model(images).float()
    top1 = (logits.argmax(-1) == labels).float().mean()
    top5_pred = logits.topk(min(5, logits.shape[-1]), dim=-1).indices
    top5 = (top5_pred == labels[:, None]).any(-1).float().mean()
    loss = F.cross_entropy(logits, labels)
    return {"acc1": top1, "acc5": top5, "loss": loss}
