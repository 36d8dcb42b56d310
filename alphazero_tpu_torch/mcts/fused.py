"""Fused search — every simulation of a search in one kernel launch.

Counterpart of ``alphazero_tpu/mcts/fused.py``. A model the kernel can
evaluate itself needs no model call between simulations, so the whole
search — descent, expansion, evaluation, backup, PUCT argmax — runs in one
CUDA kernel (``csrc/fused.cu``):

* the uniform model (``apply_fn.uniform_value``): the prior is uniform over
  the legal moves and the value a constant — ``az_fused``, launched by
  ``alphazero_tpu_torch.kernels.fused``;
* ``MLPNet`` (``apply_fn.kernel_eval_factory``, the packed weights of
  ``models.nets.pack_mlp_weights``): the network runs inside the kernel
  (K3, ``csrc/mlp.cuh``) — ``az_fused_mlp``, launched by
  ``kernels.fused_mlp``.

With ``parallel_sims = K > 1`` the search runs ``num_sims // K`` rounds of
K leaf-parallel descents (K2, the JAX kernel's ``round_body``):
``az_fused_rounds`` and ``az_fused_mlp_rounds``, launched by
``kernels.fused_rounds`` and ``kernels.fused_mlp_rounds``. The JAX
package's limits hold: ``num_sims`` divisible by K, and ``(K+1)**A <
2**24`` (K <= 9 at Connect-Four's 7 actions).

The masked root prior (with optional injected Dirichlet noise) is computed
outside the kernel with the model's ``apply_fn``, as the JAX package does.

The plain PyTorch versions of the kernels are ``fused_search``,
``fused_mlp_search``, ``fused_rounds_search`` and
``fused_mlp_rounds_search`` below: the hybrid engine's plain loops
(``mcts.hybrid.run_search`` and ``run_rounds`` on the plain kernels) with
the uniform evaluator or with ``mlp_eval``, whose arithmetic is the
reference's at the reference's rounding points. The kernel wrappers run
them for CPU tensors. For the uniform model root counts and root W are
bit-identical either way. The MLP kernels sum each hidden layer's dot
products on the tensor cores, in another order than ``mlp_forward``'s k
loop: with weights whose partial sums are exact
(``models.order_free_mlp_variables``) they are bit-identical too, up to
the last bit of ``exp`` and ``tanh`` where two libraries compute them;
with other weights a hidden unit can round to the other bf16 neighbour,
and the searches agree within the JAX package's own bound between its
Mosaic and XLA engines.

Not ported (ROADMAP): depth-sorted blocking (``run_kernel_sorted``, whose
8192-game threshold was measured on another device), ``mesh`` sharding,
MLPs beyond the kernel's widths, and games other than Connect-Four; for
the last two ``make_fused_root_fn`` returns None and the self-play ladder
runs the hybrid engine, as the JAX ladder does where its fused kernel
declines.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games.connect_four import FlatOps
from alphazero_tpu_torch.mcts import hybrid
from alphazero_tpu_torch.mcts.tree import INVALID_P
from alphazero_tpu_torch.ops import root_prior

MLP_MAX_HIDDEN = 4    # hidden layers the MLP kernel takes (csrc/mlp.cuh kMaxHidden)
MLP_MAX_WIDTH = 256   # units per hidden layer it takes (kMaxWidth)


def fused_search(
    boards: torch.Tensor, p_masked: torch.Tensor, cfg: MCTSConfig, uval: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``az_fused``: the search of Connect-Four boards
    f32[B, 42] from masked root priors f32[B, 7] with the uniform prior
    ``vm / max(n_valid, 1)`` and the value ``uval`` at every expansion.
    Returns ``(counts, rootw) f32[B, 7]``, the root's N and W."""
    n, w = hybrid.run_search(
        FlatOps(), boards, p_masked, cfg, uniform_evaluator(boards.shape[0], uval, boards.device),
        hybrid.PLAIN,
    )
    return n[:, :, 0], w[:, :, 0]


def fused_rounds_search(
    boards: torch.Tensor, p_masked: torch.Tensor, cfg: MCTSConfig, uval: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``az_fused_rounds``: ``fused_search`` in
    ``cfg.parallel_sims = K`` leaf-parallel rounds (``hybrid.run_rounds``,
    which evaluates the K leaf boards of every game at once)."""
    batch = cfg.parallel_sims * boards.shape[0]
    n, w = hybrid.run_rounds(
        FlatOps(), boards, p_masked, cfg, uniform_evaluator(batch, uval, boards.device), hybrid.PLAIN
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


def _ordered_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x f32[B, K] . w f32[K, H]`` summed over k in order 0..K-1, each
    product and each add rounded to f32: a fixed order, the same on every
    device (a matmul adds in the library's order; the kernel's tensor
    cores in theirs, see ``mlp_forward``)."""
    acc = torch.zeros((x.shape[0], w.shape[1]), device=x.device)
    for k in range(w.shape[0]):
        acc = acc + x[:, k: k + 1] * w[k]
    return acc


def mlp_forward(boards: torch.Tensor, weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel's network (K3, the JAX ``eval_fn`` of
    ``attach_mlp_kernel_eval``): ``(logits f32[B, 7], value f32[B])`` of
    Connect-Four boards f32[B, 42] from the ``MLPKernelWeights``.

    The input is the ``[+plane | -plane]`` 0/1 vector. Each hidden layer
    sums ``x_k * W[k, j]`` over k in order (bf16 x bf16 products are exact
    in f32, so only the order of the adds matters: the kernel's tensor
    cores add in their own), rounds the sum to bf16, adds the bias in bf16
    and applies ReLU; the f32 head sums in order, then adds its bias; the
    value goes through tanh."""
    x = torch.cat([boards == 1, boards == -1], dim=1).float()
    for w, b in zip(weights.w, weights.b):
        h = _ordered_dot(x, w.float()).to(torch.bfloat16).float()
        y = (h + b.float()).to(torch.bfloat16)
        x = torch.where(y > 0, y, 0).float()
    out = _ordered_dot(x, weights.wh) + weights.bh
    A = weights.wh.shape[1] - 1
    return out[:, :A], torch.tanh(out[:, A])


def mlp_prior(logits: torch.Tensor, vm: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's prior: ``ops.masked_policy`` with its
    sum over the actions taken in action order, and INVALID_P on illegal
    edges (where ``masked_policy``'s uniform-over-all fallback for a board
    with no legal move would land, so it is not computed)."""
    masked = torch.where(vm, logits, -1e30)
    z = masked - masked.amax(dim=1, keepdim=True)
    e = torch.where(vm, torch.exp(z), 0.0)
    total = torch.zeros_like(e[:, :1])
    for a in range(e.shape[1]):
        total = total + e[:, a: a + 1]
    uniform_valid = vm.float() / vm.sum(dim=1, keepdim=True).clamp(min=1)
    prior = torch.where(total > 0, e / total.clamp(min=1e-30), uniform_valid)
    return torch.where(vm, prior, INVALID_P)


def mlp_eval(boards: torch.Tensor, vm: torch.Tensor, weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """``evaluate`` of ``hybrid.run_search`` for the MLP: the masked prior
    f32[B, 7] (INVALID_P on illegal edges) and the value f32[B] of the
    leaf boards, as the kernel computes them."""
    logits, value = mlp_forward(boards, weights)
    return mlp_prior(logits, vm), value


def fused_mlp_search(
    boards: torch.Tensor, p_masked: torch.Tensor, cfg: MCTSConfig, weights
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``az_fused_mlp``: the search of Connect-Four boards
    f32[B, 42] from masked root priors f32[B, 7] with ``mlp_eval`` at every
    expansion. Returns ``(counts, rootw) f32[B, 7]``, the root's N and W."""
    n, w = hybrid.run_search(
        FlatOps(), boards, p_masked, cfg, lambda bd, vm: mlp_eval(bd, vm, weights), hybrid.PLAIN
    )
    return n[:, :, 0], w[:, :, 0]


def fused_mlp_rounds_search(
    boards: torch.Tensor, p_masked: torch.Tensor, cfg: MCTSConfig, weights
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``az_fused_mlp_rounds``: ``fused_mlp_search`` in
    ``cfg.parallel_sims`` leaf-parallel rounds (``hybrid.run_rounds``)."""
    n, w = hybrid.run_rounds(
        FlatOps(), boards, p_masked, cfg, lambda bd, vm: mlp_eval(bd, vm, weights), hybrid.PLAIN
    )
    return n[:, :, 0], w[:, :, 0]


def mlp_widths_fit(hidden: Sequence[int]) -> bool:
    """Whether the in-kernel MLP evaluator takes these hidden widths."""
    return 1 <= len(hidden) <= MLP_MAX_HIDDEN and all(1 <= h <= MLP_MAX_WIDTH for h in hidden)


def check_mlp_widths(hidden: Sequence[int]) -> None:
    """Raise for an MLP the kernel does not take."""
    if not mlp_widths_fit(hidden):
        raise NotImplementedError(
            f"the in-kernel MLP evaluator takes 1 to {MLP_MAX_HIDDEN} hidden layers of "
            f"1 to {MLP_MAX_WIDTH} units, got {tuple(hidden)}: wider or deeper MLPs need "
            "tiled activations (ROADMAP queue 2, \"K3 for MLPs wider than 256 units\"); "
            "the self-play ladder runs them on the hybrid engine"
        )


def make_fused_root_fn(
    game, apply_fn, cfg: MCTSConfig, kernel: Optional[Callable] = None
) -> Optional[Callable[..., torch.Tensor]]:
    """Build ``root_counts(root_state, dirichlet=None) -> f32[B, A]`` on the
    fused kernel, or return None when the configuration needs the hybrid
    engine: a model with neither ``uniform_value`` nor a
    ``kernel_eval_factory``, a nonzero cutoff heuristic, A > 16 or no flat
    ops (the JAX package's grounds); and where the port's kernels lack
    what the JAX one has: a game other than Connect-Four (the kernels step
    only its boards) or an MLP wider than ``MLP_MAX_WIDTH`` or deeper than
    ``MLP_MAX_HIDDEN`` (``mlp_widths_fit``). A model with both takes its
    in-kernel evaluator, as in the JAX package. ``parallel_sims = K > 1`` raises
    ``ValueError`` where the JAX package does: ``num_sims`` not divisible
    by K, or ``(K+1)**A >= 2**24``.

    ``kernel`` defaults to ``alphazero_tpu_torch.kernels.fused_mlp`` for a
    model with a ``kernel_eval_factory`` and to ``kernels.fused`` for the
    uniform model, and at K > 1 to ``kernels.fused_mlp_rounds`` and
    ``kernels.fused_rounds``, which take K as their last argument (the
    CUDA kernels for CUDA tensors, the plain versions for CPU tensors)."""
    uval = getattr(apply_fn, "uniform_value", None)
    eval_factory = getattr(apply_fn, "kernel_eval_factory", None)
    if uval is None and eval_factory is None:
        return None
    if not getattr(game, "heuristic_is_zero", False):
        return None
    if game.num_actions > 16:
        return None
    flat_ops_factory = getattr(game, "flat_ops", None)
    if flat_ops_factory is None:
        return None
    K = int(getattr(cfg, "parallel_sims", 1) or 1)
    if K > 1:
        if cfg.num_sims % K != 0:
            raise ValueError(f"num_sims={cfg.num_sims} must be divisible by parallel_sims={K}")
        if (K + 1) ** game.num_actions >= 1 << 24:
            raise ValueError(
                f"parallel_sims={K} too large for {game.num_actions} actions "
                "(needs (K+1)^A < 2^24)"
            )
    if game.name != "connect_four":
        return None   # the kernels step Connect-Four boards only
    ops = flat_ops_factory()
    sims, nodes, depth, cpuct = cfg.num_sims, cfg.nodes, cfg.max_depth, float(cfg.cpuct)
    rounds = (K,) if K > 1 else ()
    if eval_factory is not None:
        weights = eval_factory(ops)
        if not mlp_widths_fit(weights.hidden):
            return None
        if kernel is None:
            from alphazero_tpu_torch import kernels

            kernel = kernels.fused_mlp_rounds if rounds else kernels.fused_mlp

        def search(boards, p_masked):
            return kernel(boards, p_masked, weights, sims, nodes, depth, cpuct, *rounds)
    else:
        if kernel is None:
            from alphazero_tpu_torch import kernels

            kernel = kernels.fused_rounds if rounds else kernels.fused
        uval = float(uval)

        def search(boards, p_masked):
            return kernel(boards, p_masked, sims, nodes, depth, cpuct, uval, *rounds)

    def root_counts(root_state, dirichlet: Optional[torch.Tensor] = None) -> torch.Tensor:
        boards = ops.from_state(root_state)
        prior, root_valid = root_prior(game, apply_fn, cfg, root_state, dirichlet)
        counts, _ = search(boards, torch.where(root_valid, prior, INVALID_P))
        return counts

    return root_counts
