"""Hex 7x7 on batched torch tensors.

Counterpart of ``alphazero_tpu/games/hex.py``, with the same rules: the
N x N rhombus with hex adjacency (cell (r, c) neighbours (r±1, c),
(r, c±1), (r-1, c+1), (r+1, c-1)); the player to move owns the +1 stones
and joins row 0 to row N-1, the opponent's -1 stones join column 0 to
column N-1; no draw exists. Because the two goals differ, ``step`` places,
negates AND TRANSPOSES, so that in every canonical position the player to
move joins top to bottom.

``Hex`` works on batched ``int8[B, 7, 7]`` boards (the JAX class works on
one board under ``vmap``). ``HexFlatOps`` works on flat row-major
canonical ``f32[B, 49]`` boards, the form the hybrid search carries
through its descend kernel; its ``step`` is the plain version of the
kernel's helper ``hex_step`` (``csrc/hex.cuh``). The JAX flat ops keep a
50th "parity" lane so that their Pallas kernel never transposes (a TPU
layout need); the port stores the canonical board itself and transposes
in the step.

The connection test is exact reachability without a data-dependent loop:
the own-stone adjacency matrix (self-loops included) squared six times
reaches along every path of up to 2^6 = 64 edges, more than the 48 any
chain of 49 cells has. Its entries are clamped to 0/1 after each product
(sums <= 49: exact in f32), so it is a fixed number of batched matmuls per
leaf batch and no host synchronisation.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

SIZE = 7
CELLS = SIZE * SIZE

# the six hex-grid neighbour offsets of the rhombus representation
_NEIGHBORS = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, 1), (1, -1))
_SQUARINGS = 6   # 2^6 = 64 >= 48 edges, the longest chain of 49 cells


def _reach_matrix() -> np.ndarray:
    """f32[49, 49]: 1 on the diagonal and between hex neighbours."""
    m = np.eye(CELLS, dtype=np.float32)
    for r in range(SIZE):
        for c in range(SIZE):
            for dr, dc in _NEIGHBORS:
                if 0 <= r + dr < SIZE and 0 <= c + dc < SIZE:
                    m[r * SIZE + c, (r + dr) * SIZE + c + dc] = 1.0
    return m


@lru_cache(maxsize=None)
def _reach(device: torch.device) -> torch.Tensor:
    """``_reach_matrix`` on ``device``, built once per device (read only)."""
    return torch.from_numpy(_reach_matrix()).to(device)


def connections(board: torch.Tensor, reach: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(win bool[B], lose bool[B]) on canonical boards (any shape [B, ...]
    of 49 cells): the +1 stones join row 0 to row 6; the -1 stones join
    column 0 to column 6 (the JAX ``_connects_rows`` of the board and of
    the transposed -1 stones: transposition maps the hex adjacency onto
    itself). ``reach`` is ``HexFlatOps.aux``."""
    B = board.shape[0]
    flat = board.reshape(B, CELLS)
    own = torch.cat([flat == 1, flat == -1]).float()             # [2B, 49]
    r = reach * own[:, :, None] * own[:, None, :]                # [2B, 49, 49]
    for _ in range(_SQUARINGS):
        r = torch.bmm(r, r).clamp_(max=1.0)
    win = r[:B, :SIZE, CELLS - SIZE:].flatten(1).any(1)             # row 0 -> row 6
    lose = r[B:, ::SIZE, SIZE - 1 :: SIZE].flatten(1).any(1)        # column 0 -> column 6
    return win, lose


def _outcome(win: torch.Tensor, lose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(done, value): no draw branch (a full Hex board is always won)."""
    return win | lose, torch.where(win, 1.0, torch.where(lose, -1.0, 0.0))


def flat_step(board: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Place +1 at the cell ``action`` (exact-int f32[B, 1]; an occupied
    cell is overwritten), negate and transpose, on canonical f32[B, 49]
    boards — ``Hex.step`` in the JAX flat ops' dense arithmetic."""
    lane = torch.arange(CELLS, device=board.device).float()
    hit = (lane == action).float()
    placed = board + hit * (1.0 - board)
    return (-placed).reshape(-1, SIZE, SIZE).transpose(1, 2).reshape(-1, CELLS)


class Hex:
    """``Game`` protocol implementation on ``int8[B, 7, 7]`` boards."""

    name = "hex"
    num_actions = CELLS
    feature_shape = (SIZE, SIZE, 2)
    max_moves = CELLS                # the board fills in 49 moves, always decided
    num_symmetries = 2               # identity + the 180-degree rotation
    heuristic_is_zero = True

    def init(self, batch: int, device: torch.device | str = "cuda") -> torch.Tensor:
        return torch.zeros((batch, SIZE, SIZE), dtype=torch.int8, device=device)

    def step(self, board: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """Place a +1 stone at ``action`` (int64[B], row-major cell), then
        negate and transpose. An occupied cell is overwritten (callers
        mask illegal actions)."""
        out = board.clone()
        out.view(board.shape[0], -1)[torch.arange(board.shape[0], device=board.device), action.long()] = 1
        return (-out).transpose(1, 2).contiguous()

    def valid_moves(self, board: torch.Tensor) -> torch.Tensor:
        return (board == 0).reshape(board.shape[0], -1)

    def terminal(self, board: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(done bool[B], value f32[B]), player-to-move perspective: a -1
        left-right chain (the previous mover's) is a loss; a +1 top-bottom
        chain (only in hand-built states) a win."""
        return _outcome(*connections(board, _reach(board.device)))

    def to_features(self, board: torch.Tensor) -> torch.Tensor:
        """NHWC f32[B, 7, 7, 2]: (my stones, opponent stones)."""
        return torch.stack([(board == 1).float(), (board == -1).float()], dim=-1)

    def symmetries(
        self, features: torch.Tensor, pi: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Identity and the 180-degree rotation, the only board symmetry
        that keeps both players' goals: (feats[B, 2, 7, 7, 2], pis[B, 2, 49])."""
        rot = pi.reshape(-1, SIZE, SIZE).flip(1, 2).reshape(-1, CELLS)
        return (torch.stack([features, features.flip(1, 2)], dim=1),
                torch.stack([pi, rot], dim=1))

    def eval_heuristic(self, board: torch.Tensor) -> torch.Tensor:
        return torch.zeros(board.shape[0], device=board.device)

    def flat_ops(self) -> "HexFlatOps":
        return HexFlatOps()


class HexFlatOps:
    """Hex dynamics on flat canonical ``f32[B, 49]`` boards, the same
    values as the ``Hex`` methods. Per-game scalars are ``[B, 1]``
    columns, as in the JAX ``HexFlatOps``."""

    size = CELLS
    num_actions = CELLS

    def aux(self, device: torch.device | str = "cuda") -> torch.Tensor:
        """The game constant ``terminal`` takes: the adjacency matrix with
        self-loops, f32[49, 49]."""
        return _reach(torch.device(device))

    def from_state(self, board: torch.Tensor) -> torch.Tensor:
        """int8[B, 7, 7] boards -> f32[B, 49]."""
        return board.reshape(board.shape[0], -1).float()

    def step(self, board: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return flat_step(board, action)

    def valid(self, board: torch.Tensor) -> torch.Tensor:
        """bool[B, 49]: the empty cells."""
        return board == 0

    def to_features(self, board: torch.Tensor) -> torch.Tensor:
        """f32[B, 49] -> NHWC f32[B, 7, 7, 2]."""
        b = board.reshape(board.shape[0], SIZE, SIZE)
        return torch.stack([(b == 1).float(), (b == -1).float()], dim=-1)

    def terminal(self, board: torch.Tensor, aux: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(done bool[B, 1], value f32[B, 1])."""
        done, value = _outcome(*connections(board, aux))
        return done[:, None], value[:, None]

    def valid_terminal(self, board: torch.Tensor, aux: torch.Tensor):
        """``(valid bool[B, 49], done bool[B, 1], value f32[B, 1])``, what
        the search needs of each leaf batch."""
        return (self.valid(board), *self.terminal(board, aux))
