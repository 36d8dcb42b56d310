"""Steady-state self-play actor.

Counterpart of ``alphazero_tpu/selfplay.py``'s ``_make_root_counts_fn`` and
``make_actor_step_fn``: one search + move for every board per call, with
finished games recycled to the initial position, so every call advances
exactly ``batch_size`` real env steps. The random draws of a step (root
Dirichlet noise, tie-break uniforms, Gumbel noise for the move choice) are
an input, ``ops.Draws``; ``ops.sample_draws`` makes them from one
``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.mcts.fused import make_fused_root_fn
from alphazero_tpu_torch.mcts.hybrid import make_hybrid_root_fn
from alphazero_tpu_torch.ops import Draws, action_probs


def _make_root_counts_fn(game, apply_fn, mcts_cfg: MCTSConfig) -> Callable[..., torch.Tensor]:
    """``(state, dirichlet) -> root visit counts f32[B, A]``.

    The port's engine ladder, as in the JAX package: the fused kernel for
    a model it can evaluate inside the kernel (the uniform prior, or an
    ``MLPNet`` of the widths its evaluator takes, through its
    ``kernel_eval_factory``) on Connect-Four, on any device; then the
    hybrid engine for any model on a flat-ops game, which also takes what
    the fused kernel declines. The engines the port lacks raise — no
    engine stands in silently for another."""
    if getattr(mcts_cfg, "transposition", False):
        raise NotImplementedError(
            "transposition search (mcts/tt.py) is not yet ported "
            "(ROADMAP queue 1, \"The opt-in engines\")"
        )
    if getattr(mcts_cfg, "gumbel", False):
        raise NotImplementedError(
            "Gumbel search (mcts/gumbel.py) is not yet ported "
            "(ROADMAP queue 1, \"The opt-in engines\")"
        )
    if getattr(mcts_cfg, "forced_playouts", None) is not None:
        raise NotImplementedError(
            "forced playouts live in the dense engine, not yet ported "
            "(ROADMAP queue 1, \"The dense engine: mcts/tree.py + mcts/search.py\")"
        )
    if getattr(game, "flat_ops", None) is None:
        raise NotImplementedError(
            f"{game.name} has no flat ops: it needs the dense engine, not yet "
            "ported (ROADMAP queue 1, \"The dense engine: mcts/tree.py + mcts/search.py\")"
        )
    fused = make_fused_root_fn(game, apply_fn, mcts_cfg)
    if fused is not None:
        return fused
    return make_hybrid_root_fn(game, apply_fn, mcts_cfg)


def make_actor_step_fn(
    game,
    apply_fn,
    mcts_cfg: MCTSConfig,
    batch_size: int,
    temp_threshold: int,
    device="cuda",
):
    """Returns ``(init_carry, actor_step)``.

    ``init_carry() -> (state, move_count int32[B])`` on ``device``;
    ``actor_step(carry, draws) -> (carry, pi f32[B, A])`` where ``pi`` is
    the temperature-applied play distribution (temp 1 before move
    ``temp_threshold``, 0 after) and the move is
    ``argmax(log(pi + 1e-12) + draws.gumbel)`` — a categorical sample."""
    root_counts = _make_root_counts_fn(game, apply_fn, mcts_cfg)
    B = batch_size

    def reset_where(mask: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        fresh = game.init(B, state.device)
        return torch.where(mask.reshape((-1,) + (1,) * (state.ndim - 1)), fresh, state)

    def init_carry() -> Tuple[torch.Tensor, torch.Tensor]:
        return game.init(B, device), torch.zeros(B, dtype=torch.int32, device=device)

    def actor_step(carry, draws: Draws):
        state, move_count = carry
        counts = root_counts(state, draws.dirichlet)
        temp = (move_count < temp_threshold).float()
        pi = action_probs(counts, temp, draws.tie)
        action = (torch.log(pi + 1e-12) + draws.gumbel).argmax(dim=-1)
        state = game.step(state, action)
        done, _ = game.terminal(state)
        move_count = torch.where(done, 0, move_count + 1).to(torch.int32)
        state = reset_where(done, state)
        return (state, move_count), pi

    return init_carry, actor_step
