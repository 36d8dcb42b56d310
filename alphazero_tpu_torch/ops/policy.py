"""Policy post-processing shared by search and self-play.

Counterpart of ``alphazero_tpu/ops/policy.py``. JAX threefry streams cannot
be reproduced in torch, so every random draw is an INPUT here: the
tie-break uniforms of ``action_probs``, the Dirichlet sample of
``root_prior`` and the Gumbel noise of the actor's move choice. Tests feed
both packages the same draws; real runs make them with ``sample_draws``
from one ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

_NEG_INF = -1e30


def masked_policy(logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked softmax with a uniform-over-valids fallback (uniform over all
    actions when nothing is valid), f32[B, A]."""
    masked = torch.where(valid, logits, _NEG_INF)
    z = masked - masked.amax(dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(z), 0.0)
    total = e.sum(dim=-1, keepdim=True)
    nvalid = valid.sum(dim=-1, keepdim=True)
    uniform_valid = valid.float() / nvalid.clamp(min=1)
    uniform_all = torch.full_like(e, 1.0 / e.shape[-1])
    fallback = torch.where(nvalid > 0, uniform_valid, uniform_all)
    return torch.where(total > 0, e / total.clamp(min=1e-30), fallback)


def action_probs(
    counts: torch.Tensor, temp, tie_uniform: torch.Tensor
) -> torch.Tensor:
    """Root visit counts -> play distribution.

    temp == 0: one-hot on the max count, ties broken by the largest of the
    injected uniforms ``tie_uniform`` f32[B, A] among the tied actions.
    temp > 0: counts^(1/temp) normalized (counts pre-scaled by their max).
    ``temp`` is a float or f32[B]."""
    b, a = counts.shape
    temp = torch.as_tensor(temp, dtype=torch.float32, device=counts.device).expand(b)
    mx = counts.amax(dim=-1, keepdim=True)
    is_max = (counts >= mx) & (mx > 0)
    pick = torch.where(is_max, tie_uniform, -1.0).argmax(dim=-1)
    onehot = F.one_hot(pick, a).float()

    t = temp.clamp(min=1e-6)[:, None]
    scaled = counts / mx.clamp(min=1.0)
    powed = torch.where(counts > 0, scaled ** (1.0 / t), 0.0)
    total = powed.sum(dim=-1, keepdim=True)
    dist = torch.where(total > 0, powed / total.clamp(min=1e-30), onehot)
    return torch.where(temp[:, None] <= 0, onehot, dist)


def root_prior(game, apply_fn, cfg, root_state, dirichlet: Optional[torch.Tensor] = None):
    """Masked root prior, mixed with the injected Dirichlet sample
    ``dirichlet`` f32[B, A] when ``cfg.dirichlet_alpha`` is set.

    Returns ``(prior f32[B, A], valid bool[B, A])``."""
    valid = game.valid_moves(root_state)
    if getattr(apply_fn, "needs_features", True):
        feats = game.to_features(root_state)
    else:
        feats = torch.zeros((valid.shape[0], 1), device=valid.device)
    logits, _ = apply_fn(feats)
    prior = masked_policy(logits, valid)
    if cfg.dirichlet_alpha is not None:
        if dirichlet is None:
            raise ValueError("dirichlet noise requires an injected sample")
        noise = masked_policy(torch.log(dirichlet + 1e-12), valid)
        prior = (1.0 - cfg.dirichlet_frac) * prior + cfg.dirichlet_frac * noise
    return prior, valid


class Draws(NamedTuple):
    """The random inputs of one self-play step, f32[B, A] each but ``perm``.

    With Gumbel search (``MCTSConfig.gumbel``) ``gumbel`` is the search's
    root sample, and the move needs no other draw. With playout-cap
    randomization (``SelfPlayConfig.full_search_prob``) ``perm`` i64[B] is
    the step's game permutation; its first ``round(p * B)`` games search the
    full budget. The search noise (``dirichlet``, or ``gumbel`` for Gumbel
    search) is then in permuted order: rows ``[:round(p * B)]`` are the
    full sub-batch's, the rest the cheap one's."""

    dirichlet: Optional[torch.Tensor]  # root noise sample (None: noise off)
    tie: torch.Tensor                  # tie-break uniforms for action_probs
    gumbel: torch.Tensor               # the move's Gumbel noise, or Gumbel search's root sample
    perm: Optional[torch.Tensor] = None  # i64[B] playout-cap randomization's permutation


def _standard_gamma(
    alpha: float, shape, generator: torch.Generator, device
) -> torch.Tensor:
    """Gamma(alpha, 1) by Marsaglia-Tsang rejection (alpha < 1 through the
    U^(1/alpha) boost), drawing only from ``generator`` — torch's own gamma
    sampler takes no generator."""
    a = alpha if alpha >= 1.0 else alpha + 1.0
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(shape, device=device)
    pending = torch.ones(shape, dtype=torch.bool, device=device)
    while bool(pending.any()):
        x = torch.randn(shape, generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        u = torch.rand(shape, generator=generator, device=device)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v))
        out = torch.where(pending & ok, d * v, out)
        pending &= ~ok
    if alpha < 1.0:
        u = torch.rand(shape, generator=generator, device=device)
        out = out * u ** (1.0 / alpha)
    return out


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel samples ``-log(-log(u))`` of uniforms ``u`` in [0, 1)."""
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def sample_draws(
    generator: torch.Generator,
    batch: int,
    num_actions: int,
    dirichlet_alpha: Optional[float],
    device,
    permute: bool = False,
) -> Draws:
    """All draws of one self-play step from one generator (on ``device``);
    ``permute`` adds playout-cap randomization's permutation."""
    shape = (batch, num_actions)
    dirichlet = None
    if dirichlet_alpha is not None:
        g = _standard_gamma(float(dirichlet_alpha), shape, generator, device)
        dirichlet = g / g.sum(dim=-1, keepdim=True)
    tie = torch.rand(shape, generator=generator, device=device)
    gumbel = gumbel_from_uniform(torch.rand(shape, generator=generator, device=device))
    perm = torch.randperm(batch, generator=generator, device=device) if permute else None
    return Draws(dirichlet, tie, gumbel, perm)
