"""Loss primitives of the LM trainer: the port of the LM part of the JAX
package's ops/nn.py (``IGNORE_INDEX``, ``masked_ce``, ``step_metrics``).
The VGG layers of that module come with the VGG-training slice
(ROADMAP.md queue 1)."""

from __future__ import annotations

import torch

IGNORE_INDEX = -1  # target id excluded from LM losses (padding)


def masked_ce(logits: torch.Tensor,
              targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of next-token CE over non-ignored tokens, count), float32 sum
    and an integer count; the caller divides."""
    logits = logits.float()
    mask = targets != IGNORE_INDEX
    safe = torch.where(mask, targets, torch.zeros_like(targets)).long()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = torch.where(mask, logz - true_logit, torch.zeros_like(logz))
    return ce.sum(), mask.sum()


def step_metrics(grad_sq_sum: torch.Tensor, params) -> torch.Tensor:
    """(2,) float32 [grad global-norm, param global-norm]: the per-step
    telemetry scalars, from the gradient sum of squares the health flag
    already needs plus one reduction over the (updated) params."""
    with torch.no_grad():
        psq = torch.stack(torch._foreach_norm(list(params))).float() \
            .square().sum()
        return torch.stack([grad_sq_sum.float().sqrt(), psq.sqrt()])
