"""The batched search tree of the dense engine (``mcts/search.py``).

Counterpart of ``alphazero_tpu/mcts/tree.py``, with its semantics and not
its layout. The JAX tree is lane-major, ``stats f32[B, 4, A, C]`` with the
capacity axis C on the TPU's 128-lane dimension, and reads a node's row by
a one-hot multiply, both TPU needs. Here the tree is node-major: a node's
record ``stats[b, c] f32[4, A]`` (planes N | W | P | child code) is
contiguous, so the search installs a node with one row write, reads rows
by ``gather`` and advanced indexing, and backs up with one scatter. What is
kept:

* **lockstep slot allocation**: every simulation takes slot ``cursor``
  (per game; identical across games in a fresh search) whether or not the
  game expanded; a game that did not leaves the slot unlinked. With the
  default capacity ``num_sims + 1`` nothing is lost; a smaller capacity
  degrades (the simulation still backs up its value, the node is not
  installed). ``count[b]`` is the number of nodes installed;
* **child codes**: -1 for an unexpanded edge, the child's slot for a live
  child, ``-2 - slot`` for a terminal child, so the descent needs no
  terminality lookup;
* **masked priors**: illegal edges carry ``P = INVALID_P``, so PUCT needs
  no legality plane.

Edge statistics live on the parent: N/W of edge ``(c, a)`` are its visit
count and total value from node ``c``'s player-to-move perspective.
Counts and slots are exact integers in f32 up to 2^24.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

UNVISITED = -1.0    # child-code sentinel: edge not expanded
INVALID_P = -1e30   # masked-prior sentinel for illegal actions

# stat planes of a node record stats[b, c, plane, a]
PLANE_N, PLANE_W, PLANE_P, PLANE_CHILD = 0, 1, 2, 3
# node planes node[b, c, plane]
NODE_TERM, NODE_TVAL = 0, 1


def np_prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


class Tree(NamedTuple):
    """Batched search trees: B games, C node slots each, A actions."""

    stats: torch.Tensor   # f32[B, C, 4, A] node records (N | W | P | child code)
    node: torch.Tensor    # f32[B, C, 2] (is terminal | terminal value, to-move view)
    state: torch.Tensor   # [B, C, L] each node's game state, flattened
    count: torch.Tensor   # i32[B] nodes installed (the root included)
    cursor: torch.Tensor  # i64[B] the next simulation's slot

    @property
    def batch_size(self) -> int:
        return self.stats.shape[0]

    @property
    def capacity(self) -> int:
        return self.stats.shape[1]

    @property
    def num_actions(self) -> int:
        return self.stats.shape[3]

    # --- decoded views [B, C, A] and [B, C] (the JAX Tree's; what tests compare)
    @property
    def N(self) -> torch.Tensor:
        return self.stats[:, :, PLANE_N].to(torch.int32)

    @property
    def W(self) -> torch.Tensor:
        return self.stats[:, :, PLANE_W]

    @property
    def P(self) -> torch.Tensor:
        p = self.stats[:, :, PLANE_P]
        return torch.where(p <= INVALID_P * 0.5, 0.0, p)

    @property
    def child(self) -> torch.Tensor:
        """Decoded child slots; -1 = unexpanded (a terminal child's raw
        code ``-2 - slot`` decodes to ``slot``)."""
        code = self.stats[:, :, PLANE_CHILD]
        return torch.where(code < -1.5, -2.0 - code, code).to(torch.int32)

    @property
    def valid(self) -> torch.Tensor:
        return self.stats[:, :, PLANE_P] > INVALID_P * 0.5

    @property
    def term(self) -> torch.Tensor:
        return self.node[:, :, NODE_TERM] > 0.5

    @property
    def tval(self) -> torch.Tensor:
        return self.node[:, :, NODE_TVAL]

    def root_counts(self) -> torch.Tensor:
        """f32[B, A] root visit counts, the search's output."""
        return self.stats[:, 0, PLANE_N]

    def root_q(self) -> torch.Tensor:
        """f32[B, A] root edge Q values (diagnostics)."""
        return self.stats[:, 0, PLANE_W] / self.stats[:, 0, PLANE_N].clamp(min=1.0)


def init_tree(game, root_state: torch.Tensor, capacity: int) -> Tree:
    """Trees with the batched root states installed in slot 0: their legal
    edges at prior 0 (the search installs the masked NN prior), illegal
    ones at INVALID_P, their terminal flag and value. The trees live on
    the root states' device."""
    B = root_state.shape[0]
    dev = root_state.device
    stats = torch.zeros((B, capacity, 4, game.num_actions), device=dev)
    stats[:, :, PLANE_CHILD] = UNVISITED
    stats[:, 0, PLANE_P] = torch.where(game.valid_moves(root_state), 0.0, INVALID_P)
    done, tval = game.terminal(root_state)
    node = torch.zeros((B, capacity, 2), device=dev)
    node[:, 0, NODE_TERM] = done.float()
    node[:, 0, NODE_TVAL] = tval
    state = torch.zeros((B, capacity, np_prod(root_state.shape[1:])), dtype=root_state.dtype,
                        device=dev)
    state[:, 0] = root_state.reshape(B, -1)
    return Tree(
        stats=stats,
        node=node,
        state=state,
        count=torch.ones(B, dtype=torch.int32, device=dev),
        cursor=torch.ones(B, dtype=torch.long, device=dev),
    )
