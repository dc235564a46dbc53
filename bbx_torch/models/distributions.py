"""Masked categorical distribution utilities.

Counterpart of `bbx/models/distributions.py`.  Random draws take an explicit
`torch.Generator`.
"""
from __future__ import annotations

import torch

# Large-negative instead of -inf: exp() flushes to exactly 0 in softmax but
# avoids NaN propagation through log_softmax/grad on fully-masked rows.
MASKED_LOGIT = -1e9


def mask_logits(logits: torch.Tensor, action_mask: torch.Tensor) -> torch.Tensor:
    """Invalid actions get a -1e9 logit."""
    return torch.where(action_mask > 0, logits, MASKED_LOGIT)


def sample(rng: torch.Generator, masked: torch.Tensor, shard=None) -> torch.Tensor:
    """Sample from the masked categorical ([B, A] logits -> [B] int32), by
    the Gumbel-max trick.  With `shard` (a `bbx_torch.parallel.BatchShard`:
    these B rows of a global batch) the noise is drawn for the global batch
    and this rank's rows kept, so every rank's generator stays in step."""
    shape = masked.shape if shard is None else (shard.total, *masked.shape[1:])
    u = torch.rand(shape, generator=rng, device=masked.device, dtype=torch.float32)
    if shard is not None:
        u = shard.take(u)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(masked.float() + gumbel, dim=-1).to(torch.int32)


def mode(masked: torch.Tensor) -> torch.Tensor:
    """Deterministic action: the first maximal masked logit ([B] int32)."""
    return torch.argmax(masked, dim=-1).to(torch.int32)


def log_prob(masked: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Log-probability of `action` under the masked categorical."""
    logp = torch.log_softmax(masked, dim=-1)
    return torch.gather(logp, -1, action[:, None].long())[:, 0]


def masked_entropy(masked: torch.Tensor, action_mask: torch.Tensor) -> torch.Tensor:
    """Entropy over *valid* actions only, renormalised over the valid set."""
    probs = torch.softmax(masked, dim=-1)
    maskf = (action_mask > 0).to(probs.dtype)
    masked_probs = probs * maskf
    denom = masked_probs.sum(dim=-1, keepdim=True).clamp(min=1e-10)
    p = masked_probs / denom
    logp = torch.log(p.clamp(min=1e-10))
    return -(p * logp * maskf).sum(dim=-1)
