"""The ``Game`` protocol on batched torch tensors.

Counterpart of ``alphazero_tpu/games/base.py``. The JAX protocol defines
pure functions of ONE state that callers ``jax.vmap``; PyTorch has no vmap
on the hot path, so here every method takes and returns a BATCH: a state is
a tensor (or tuple of tensors) with a leading game axis ``B``. The rest of
the contract is unchanged:

* states are canonical — the player to move owns the ``+1`` pieces, and
  ``step`` returns the next state already sign-flipped;
* ``terminal(state) -> (done, value)`` with ``value`` exact (-1/0/+1) from
  the player-to-move's perspective, draws exactly 0;
* ``step`` is total: an invalid action returns *some* state, callers mask.
"""

from __future__ import annotations

from typing import Any, Protocol, Tuple, runtime_checkable

import torch

State = Any  # a batched tensor (or tuple of tensors) with leading axis B


@runtime_checkable
class Game(Protocol):
    """Environment contract on batched tensors."""

    name: str
    num_actions: int                 # action-space size A
    feature_shape: Tuple[int, ...]   # per-game to_features shape (NHWC)
    max_moves: int                   # upper bound on game length
    num_symmetries: int              # S of symmetries()

    def init(self, batch: int, device: torch.device | str = "cuda") -> State:
        """``batch`` initial canonical states."""
        ...

    def step(self, state: State, action: torch.Tensor) -> State:
        """Apply ``action`` (int64[B]) for the player to move; return the
        next canonical states."""
        ...

    def valid_moves(self, state: State) -> torch.Tensor:
        """bool[B, A] legal-action masks."""
        ...

    def terminal(self, state: State) -> Tuple[torch.Tensor, torch.Tensor]:
        """(done bool[B], value f32[B]), player-to-move perspective."""
        ...

    def to_features(self, state: State) -> torch.Tensor:
        """f32[B, *feature_shape] NN input planes."""
        ...

    def symmetries(
        self, features: torch.Tensor, pi: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(feats[B, S, *feature_shape], pis[B, S, A]); index 0 is the
        identity."""
        ...

    def eval_heuristic(self, state: State) -> torch.Tensor:
        """f32[B] depth-cutoff value estimate, player-to-move perspective."""
        ...
