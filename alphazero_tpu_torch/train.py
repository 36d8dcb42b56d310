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

Under a ``mesh`` (``parallel/``) every rank holds the whole model and
takes its rows of each global minibatch. The loss is the global batch's:
the policy term normalised by the global count of rows with a target,
the value term a mean over the global rows, the L2 term counted once (on
rank 0), BatchNorm's statistics the global batch's (the training
forward's ``bn_mesh``); each rank's share of it is differentiated
locally and the gradients are summed over the ranks before the
optimizer step, so Adam moves every rank's parameters alike. A layer
computed in bf16 gives its weight gradient out of a bf16 product, rounded
on each rank's rows before the ranks' sum: the one process rounds the
whole batch's once, so a bf16 learner's steps drift from the one-process
steps (an f32 one's stay within 1e-5 over 64 steps: chip_smoke.py's
phase 22, tests/test_torch_parallel.py).
The reported loss is the global one. The global minibatch's indices (and
a dropout model's uniforms) are drawn whole on every rank from one
generator seeded alike, and each rank keeps its rows.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from alphazero_tpu_torch.config import TrainConfig
from alphazero_tpu_torch.parallel.distributed import all_reduce, all_reduce_grads
from alphazero_tpu_torch.parallel.mesh import batch_sharding
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


def loss_terms(model, cfg: TrainConfig, feats, pi_t, v_t, dropout=None,
               mesh=None) -> TrainMetrics:
    """The loss of one minibatch through the training forward; ``dropout``
    (a generator, a callable or the masks) goes to a model that has
    dropout. Under ``mesh`` the rows are this rank's share of the global
    minibatch, and the terms are this rank's shares of the global loss
    (their sum over the ranks is the global loss)."""
    kwargs = {} if dropout is None else {"dropout": dropout}
    if mesh is not None:
        kwargs["bn_mesh"] = mesh
    logits, v = model(feats, train=True, **kwargs)
    p_each = -(pi_t * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    has_pi = (pi_t.sum(dim=-1) > 0.5).float()
    n_pi = has_pi.sum()
    v_loss = ((v - v_t) ** 2).mean()
    if mesh is not None:
        # equal shards: the global mean is the sum of each rank's mean
        # over the rank count (a world of one: the local terms bit for bit)
        n_pi = all_reduce(n_pi, mesh)
        v_loss = v_loss / mesh.data
    p_loss = (p_each * has_pi).sum() / n_pi.clamp(min=1.0)
    l2 = torch.zeros((), device=feats.device)
    if cfg.l2_scale > 0 and (mesh is None or mesh.rank == 0):
        l2 = cfg.l2_scale * sum((w * w).sum() for w in model.parameters() if w.ndim > 1)
    return TrainMetrics(p_loss + v_loss + l2, p_loss, v_loss, l2)


def make_train_step(cfg: TrainConfig, mesh=None):
    """Build ``train_step(state, feats, pi_t, v_t, dropout=None) ->
    (state, metrics)``: one optimizer step on the minibatch, in place.
    ``dropout`` is the model's (``loss_terms``). The metrics stay on the
    device. Under ``mesh`` the minibatch is this rank's rows, the
    gradients are summed over the ranks before the step, and the metrics
    are the global loss's."""

    def train_step(state: TrainState, feats, pi_t, v_t, dropout=None):
        metrics = loss_terms(state.model, cfg, feats, pi_t, v_t, dropout, mesh)
        state.optimizer.zero_grad(set_to_none=True)
        metrics.loss.backward()
        metrics = torch.stack([m.detach() for m in metrics])
        if mesh is not None:
            all_reduce_grads(list(state.model.parameters()), mesh)
            metrics = all_reduce(metrics, mesh)
        state.optimizer.step()
        state.step += 1
        return state, TrainMetrics(*metrics)

    return train_step


def make_train_phase(cfg: TrainConfig, steps: int, game, mesh=None):
    """Build ``phase(state, replay, generator) -> (state, losses
    f32[steps])``: ``steps`` minibatches of ``cfg.batch_size`` rows, each
    sampled from the ring by ``generator``, which also draws a dropout
    model's masks. The losses stay on the device until the caller reads
    them, once a phase. Under ``mesh`` the ring is the same on every rank
    and each rank trains on its rows of every minibatch."""
    train_step = make_train_step(cfg, mesh)
    rows = slice(None) if mesh is None else batch_sharding(mesh, cfg.batch_size,
                                                           "train batch")

    def phase(state: TrainState, replay, generator: torch.Generator):
        dropout = generator if has_dropout(state.model) else None
        if dropout is not None and mesh is not None:
            def dropout(x):
                return torch.rand((cfg.batch_size, *x.shape[1:]), generator=generator,
                                  device=x.device)[rows]
        losses = []
        for _ in range(steps):
            idx = torch.randint(0, max(replay.size, 1), (cfg.batch_size,), generator=generator,
                                device=replay.data.device)
            feats, pi_t, v_t = replay_sample(replay, cfg.batch_size, game, idx=idx[rows])
            state, metrics = train_step(state, feats, pi_t, v_t, dropout)
            losses.append(metrics.loss)
        return state, torch.stack(losses)

    return phase
