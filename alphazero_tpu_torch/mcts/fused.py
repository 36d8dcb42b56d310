"""Fused search — every simulation of a search in one kernel launch.

Counterpart of ``alphazero_tpu/mcts/fused.py`` on its K=1 path with the
constant (uniform) evaluator: the model's prior is uniform over the legal
moves and its value the constant ``apply_fn.uniform_value``, so the search
needs no model call between simulations and the whole of it — descent,
expansion, backup, PUCT argmax — runs in the CUDA kernel ``az_fused``
(``csrc/fused.cu``, launched by ``alphazero_tpu_torch.kernels.fused``).
The masked root prior (with optional injected Dirichlet noise) is computed
outside the kernel, as the JAX package does.

The plain PyTorch version of the kernel is ``fused_search`` below: the
hybrid engine's plain loop (``mcts.hybrid.run_search`` on the plain
descend/merge/refresh) with the uniform evaluator. The kernel wrapper runs
it for CPU tensors; root counts and root W are bit-identical either way.

Not ported (ROADMAP): the in-kernel MLP evaluator (K3, models with a
``kernel_eval_factory`` take the hybrid engine until then), the K>1
rounds (K2), depth-sorted blocking (``run_kernel_sorted``, whose
8192-game threshold was measured on another device), ``mesh`` sharding,
and games other than Connect-Four.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games.connect_four import FlatOps
from alphazero_tpu_torch.mcts import hybrid
from alphazero_tpu_torch.mcts.tree import INVALID_P
from alphazero_tpu_torch.ops import root_prior


def fused_search(
    boards: torch.Tensor, p_masked: torch.Tensor, cfg: MCTSConfig, uval: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused kernel: the search of Connect-Four boards
    f32[B, 42] from masked root priors f32[B, 7] with the uniform prior
    ``vm / max(n_valid, 1)`` and the value ``uval`` at every expansion.
    Returns ``(counts, rootw) f32[B, 7]``, the root's N and W."""
    n, w = hybrid.run_search(
        FlatOps(), boards, p_masked, cfg, uniform_evaluator(boards.shape[0], uval, boards.device),
        hybrid.PLAIN,
    )
    return n[:, :, 0], w[:, :, 0]


def uniform_evaluator(batch: int, uval: float, device) -> Callable:
    """``evaluate(bd, vm)`` of ``hybrid.run_search`` for the uniform model:
    the prior ``vm / max(n_valid, 1)`` (INVALID_P on illegal edges) and the
    value ``uval`` (JAX fused.py:380-383)."""
    value = torch.full((batch,), float(uval), device=device)

    def evaluate(bd, vm):
        n_valid = vm.sum(dim=1, keepdim=True)
        prior = vm.float() / n_valid.clamp(min=1)
        return torch.where(vm, prior, INVALID_P), value

    return evaluate


def make_fused_root_fn(
    game, apply_fn, cfg: MCTSConfig, kernel: Optional[Callable] = None
) -> Optional[Callable[..., torch.Tensor]]:
    """Build ``root_counts(root_state, dirichlet=None) -> f32[B, A]`` on the
    fused kernel, or return None when the configuration needs the hybrid
    engine: a model without ``uniform_value``, or with an in-kernel
    evaluator still to be ported (K3), a nonzero cutoff heuristic, A > 16
    or no flat ops (the JAX package's grounds).

    ``kernel`` defaults to ``alphazero_tpu_torch.kernels.fused`` (the CUDA
    kernel for CUDA tensors, ``fused_search`` for CPU tensors)."""
    uval = getattr(apply_fn, "uniform_value", None)
    if uval is None:
        return None
    if getattr(apply_fn, "kernel_eval_factory", None) is not None:
        return None  # the in-kernel MLP evaluator (K3) is not yet ported
    if not getattr(game, "heuristic_is_zero", False):
        return None
    if game.num_actions > 16:
        return None
    flat_ops_factory = getattr(game, "flat_ops", None)
    if flat_ops_factory is None:
        return None
    if int(getattr(cfg, "parallel_sims", 1) or 1) > 1:
        raise NotImplementedError(
            "parallel_sims > 1 needs the fused K>1 rounds "
            "(ROADMAP queue 2, K2), not yet ported"
        )
    if game.name != "connect_four":
        raise NotImplementedError(
            f"the fused kernel's game helpers are Connect-Four's; {game.name} "
            "needs its own (ROADMAP queue 2, K4 per game)"
        )
    if kernel is None:
        from alphazero_tpu_torch.kernels import fused as kernel
    ops = flat_ops_factory()
    uval = float(uval)

    def root_counts(root_state, dirichlet: Optional[torch.Tensor] = None) -> torch.Tensor:
        boards = ops.from_state(root_state)
        prior, root_valid = root_prior(game, apply_fn, cfg, root_state, dirichlet)
        p_masked = torch.where(root_valid, prior, INVALID_P)
        counts, _ = kernel(
            boards, p_masked, cfg.num_sims, cfg.nodes, cfg.max_depth, float(cfg.cpuct), uval
        )
        return counts

    return root_counts
