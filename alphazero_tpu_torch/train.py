"""The learner: loss, optimizer step and the training phase.

Counterpart of ``alphazero_tpu/train.py`` and of ``make_train_phase``
(``alphazero_tpu/coach.py``). The loss is the JAX package's: softmax
cross-entropy of the policy, normalised over the rows whose target sums
past 0.5 (value-only rows carry an all-zero target), plus the value's
mean squared error, plus ``l2_scale`` times the squared sum of every conv
and dense kernel (the parameters with more than one dimension). The
optimizer is optax's ``adam`` (``adamw`` with a weight decay) as
``torch.optim``. The forward is the model's training forward
(``model(feats, train=True)``: an AZResNet normalises by the batch's
statistics and moves its running ones, as flax's mutable
``batch_stats``). A model with dropout (``AZConvNet``) also takes its
``dropout``: the training phase passes its generator, from which the
masks are drawn after each minibatch's sample (the JAX step draws them
from ``rngs={"dropout": rng}``, a stream torch cannot reproduce; a parity
test passes the JAX masks themselves). A model without dropout draws
nothing more, so its steps are as before. The model is updated in place;
the actor picks the new weights up on its next call (``selfplay``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from alphazero_tpu_torch.config import TrainConfig
from alphazero_tpu_torch.replay import replay_sample


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module             # f32 parameters and statistics
    optimizer: torch.optim.Optimizer   # over model.parameters()
    step: int = 0


class TrainMetrics(NamedTuple):
    loss: torch.Tensor
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    l2_loss: torch.Tensor


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.Optimizer:
    """optax ``adam(lr)``, or ``adamw(lr, weight_decay)`` when the decay
    is positive (passed explicitly: torch's AdamW default differs)."""
    kw = dict(lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    if cfg.weight_decay > 0:
        return torch.optim.AdamW(params, weight_decay=cfg.weight_decay, **kw)
    return torch.optim.Adam(params, **kw)


def init_train_state(model: torch.nn.Module, cfg: TrainConfig) -> TrainState:
    """The learner's state around ``model`` (its parameters must be f32)."""
    bad = [n for n, p in model.named_parameters() if p.dtype != torch.float32]
    if bad:
        raise ValueError(f"the learner takes f32 parameters; not f32: {bad}")
    return TrainState(model, make_optimizer(model.parameters(), cfg))


def prime_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """Give every parameter the Adam state its first step would make
    (step 0, zero moments, each where torch keeps it), so the optimizer's
    state dict has one structure from the start: a checkpoint's template
    (``coach``). The steps that follow are the same as without it."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if state:
                continue
            on_param = group.get("capturable") or group.get("fused")
            state["step"] = (torch.zeros((), device=p.device) if on_param
                             else torch.tensor(0.0, device="cpu"))
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            if group.get("amsgrad"):
                state["max_exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def has_dropout(model) -> bool:
    return getattr(model, "dropout", 0.0) > 0


def loss_terms(model, cfg: TrainConfig, feats, pi_t, v_t, dropout=None) -> TrainMetrics:
    """The loss of one minibatch through the training forward; ``dropout``
    (a generator or the masks) goes to a model that has dropout."""
    if dropout is None:
        logits, v = model(feats, train=True)
    else:
        logits, v = model(feats, train=True, dropout=dropout)
    p_each = -(pi_t * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    has_pi = (pi_t.sum(dim=-1) > 0.5).float()
    p_loss = (p_each * has_pi).sum() / has_pi.sum().clamp(min=1.0)
    v_loss = ((v - v_t) ** 2).mean()
    l2 = torch.zeros((), device=feats.device)
    if cfg.l2_scale > 0:
        l2 = cfg.l2_scale * sum((w * w).sum() for w in model.parameters() if w.ndim > 1)
    return TrainMetrics(p_loss + v_loss + l2, p_loss, v_loss, l2)


def make_train_step(cfg: TrainConfig):
    """Build ``train_step(state, feats, pi_t, v_t, dropout=None) ->
    (state, metrics)``: one optimizer step on the minibatch, in place.
    ``dropout`` is the model's (``loss_terms``). The metrics stay on the
    device."""

    def train_step(state: TrainState, feats, pi_t, v_t, dropout=None):
        metrics = loss_terms(state.model, cfg, feats, pi_t, v_t, dropout)
        state.optimizer.zero_grad(set_to_none=True)
        metrics.loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, TrainMetrics(*(m.detach() for m in metrics))

    return train_step


def make_train_phase(cfg: TrainConfig, steps: int, game):
    """Build ``phase(state, replay, generator) -> (state, losses
    f32[steps])``: ``steps`` minibatches of ``cfg.batch_size`` rows, each
    sampled from the ring by ``generator``, which also draws a dropout
    model's masks. The losses stay on the device until the caller reads
    them, once a phase."""
    train_step = make_train_step(cfg)

    def phase(state: TrainState, replay, generator: torch.Generator):
        dropout = generator if has_dropout(state.model) else None
        losses = []
        for _ in range(steps):
            feats, pi_t, v_t = replay_sample(replay, cfg.batch_size, game, generator)
            state, metrics = train_step(state, feats, pi_t, v_t, dropout)
            losses.append(metrics.loss)
        return state, torch.stack(losses)

    return phase
