"""Gomoku (free-style five in a row) on batched torch tensors.

Counterpart of ``alphazero_tpu/games/gomoku.py``, with the same rules:
players place stones on empty cells, five or more in a row (horizontally,
vertically or diagonally) wins, a full board without one is an exact-0
draw; canonical boards (+1 = player to move; ``step`` places a +1 stone and
sign-flips). The board edge is a constructor parameter: ``Gomoku()`` is the
9x9 edition, ``Gomoku(15)`` the production 15x15 board (A = 225).

``Gomoku`` works on batched ``int8[B, S, S]`` boards (the JAX class works
on one board under ``vmap``). ``GomokuFlatOps`` works on flat row-major
``f32[B, S*S]`` boards (cell ``r*S + c``), the form the hybrid search
carries through its descend kernel; its ``step`` is the plain version of
the kernel's helper ``gomoku_step`` (``csrc/gomoku.cuh``), and its
``terminal`` is the JAX flat ops' win-line matmul.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

SIZE = 9  # default edition
WIN = 5


def _has_win(board: torch.Tensor, player: int, win: int) -> torch.Tensor:
    """bool[B]: ``player`` (+1/-1) has ``win`` in a row on int8[B, S, S]
    boards (static shifted ANDs over the four directions, inclusive window
    bounds, the JAX ``_has_win``)."""
    p = board == player
    S = board.shape[-1]
    M = S - win + 1
    horiz, vert, diag, anti = p[:, :, :M], p[:, :M, :], p[:, :M, :M], p[:, win - 1:, :M]
    for i in range(1, win):
        horiz = horiz & p[:, :, i : M + i]
        vert = vert & p[:, i : M + i, :]
        diag = diag & p[:, i : M + i, i : M + i]
        anti = anti & p[:, win - 1 - i : S - i, i : M + i]
    return (horiz.flatten(1).any(1) | vert.flatten(1).any(1)
            | diag.flatten(1).any(1) | anti.flatten(1).any(1))


def _outcome(win: torch.Tensor, lose: torch.Tensor, full: torch.Tensor):
    """(done, value) from the player to move's side: a +1 line wins, a -1
    line (the previous mover's) loses, a full board draws at exactly 0."""
    done = win | lose | full
    value = torch.where(win, 1.0, torch.where(lose, -1.0, 0.0))
    return done, value


class Gomoku:
    """``Game`` protocol implementation on ``int8[B, S, S]`` boards.

    ``size`` picks the board edition (9 by default; any edge >= ``win``);
    ``win`` stays 5 (free-style gomoku)."""

    def __init__(self, size: int = SIZE, win: int = WIN):
        if size < win:
            raise ValueError(f"size={size} smaller than win={win}")
        self.size = size
        self.win = win
        self.name = "gomoku" if size == SIZE else f"gomoku{size}"
        self.num_actions = size * size
        self.feature_shape = (size, size, 2)
        self.max_moves = size * size
        self.num_symmetries = 8   # dihedral group of the square board
        self.heuristic_is_zero = True

    def init(self, batch: int, device: torch.device | str = "cuda") -> torch.Tensor:
        return torch.zeros((batch, self.size, self.size), dtype=torch.int8, device=device)

    def step(self, board: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """Place a +1 stone at ``action`` (int64[B], row-major cell); return
        the sign-flipped boards. An occupied cell is overwritten with +1, as
        in the JAX ``Gomoku.step`` (callers mask illegal actions)."""
        out = board.clone()
        out.view(board.shape[0], -1)[torch.arange(board.shape[0], device=board.device), action.long()] = 1
        return -out

    def valid_moves(self, board: torch.Tensor) -> torch.Tensor:
        return (board == 0).reshape(board.shape[0], -1)

    def terminal(self, board: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(done bool[B], value f32[B]), player-to-move perspective."""
        full = (board != 0).flatten(1).all(1)
        return _outcome(_has_win(board, 1, self.win), _has_win(board, -1, self.win), full)

    def to_features(self, board: torch.Tensor) -> torch.Tensor:
        """NHWC f32[B, S, S, 2]: (my stones, opponent stones)."""
        return torch.stack([(board == 1).float(), (board == -1).float()], dim=-1)

    def symmetries(
        self, features: torch.Tensor, pi: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The 8 board symmetries (rotations by k quarter turns, each
        unmirrored then mirrored left-right, the JAX order), pi remapped as
        an S x S grid: (feats[B, 8, S, S, 2], pis[B, 8, S*S])."""
        S = self.size
        grid = pi.reshape(-1, S, S)
        feats, pis = [], []
        for k in range(4):
            f = torch.rot90(features, k, dims=(1, 2))
            g = torch.rot90(grid, k, dims=(1, 2))
            for flip in (False, True):
                feats.append(f.flip(2) if flip else f)
                pis.append((g.flip(2) if flip else g).reshape(-1, S * S))
        return torch.stack(feats, dim=1), torch.stack(pis, dim=1)

    def eval_heuristic(self, board: torch.Tensor) -> torch.Tensor:
        return torch.zeros(board.shape[0], device=board.device)

    def flat_ops(self) -> "GomokuFlatOps":
        return GomokuFlatOps(self.size, self.win)


@functools.lru_cache(maxsize=None)
def _win_line_matrix(size: int, win: int) -> np.ndarray:
    """f32[size^2, n_lines] incidence matrix of every win-in-a-row window
    (9x9: rows 45 + columns 45 + diagonals 25 + anti-diagonals 25 = 140;
    15x15: 572), in the JAX ``_win_line_matrix``'s window order. Built once
    per board (every search asks for it) and read-only."""
    M = size - win + 1
    lines = []
    for r in range(size):
        for c in range(M):
            lines.append([(r, c + i) for i in range(win)])
    for c in range(size):
        for r in range(M):
            lines.append([(r + i, c) for i in range(win)])
    for r in range(M):
        for c in range(M):
            lines.append([(r + i, c + i) for i in range(win)])
    for r in range(win - 1, size):
        for c in range(M):
            lines.append([(r - i, c + i) for i in range(win)])
    m = np.zeros((size * size, len(lines)), np.float32)
    for j, cells in enumerate(lines):
        for r, c in cells:
            m[r * size + c, j] = 1.0
    m.flags.writeable = False
    return m


class GomokuFlatOps:
    """Gomoku dynamics on flat ``f32[B, S*S]`` boards, the same values as
    the ``Gomoku`` methods. Per-game scalars are ``[B, 1]`` columns, as in
    the JAX ``GomokuFlatOps``; ``size`` is the cell count (the board width
    the search carries)."""

    def __init__(self, size: int = SIZE, win: int = WIN):
        self.board_size = size
        self.win = win
        self.size = size * size
        self.num_actions = size * size
        n_lines = 2 * size * (size - win + 1) + 2 * (size - win + 1) ** 2
        # zero-padded to a multiple of 128 columns, as the JAX aux (padding
        # columns sum to 0 < win)
        self.aux_lanes = -(-n_lines // 128) * 128

    def aux(self, device: torch.device | str = "cuda") -> torch.Tensor:
        """The win-line matrix zero-padded to ``aux_lanes`` columns,
        f32[S*S, aux_lanes]."""
        m = _win_line_matrix(self.board_size, self.win)
        m = np.pad(m, ((0, 0), (0, self.aux_lanes - m.shape[1])))
        return torch.from_numpy(m).to(device)

    def from_state(self, board: torch.Tensor) -> torch.Tensor:
        """int8[B, S, S] boards -> f32[B, S*S]."""
        return board.reshape(board.shape[0], -1).float()

    def step(self, board: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """Place +1 at the cell ``action`` (exact-int f32[B, 1]; an occupied
        cell is overwritten), then sign-flip — the JAX
        ``GomokuFlatOps.step`` arithmetic, op for op."""
        lane = torch.arange(self.size, device=board.device).float()
        hit = (lane == action).float()
        placed = board + hit * (1.0 - board)
        return -placed

    def valid(self, board: torch.Tensor) -> torch.Tensor:
        """bool[B, S*S]: the empty cells."""
        return board == 0

    def to_features(self, board: torch.Tensor) -> torch.Tensor:
        """f32[B, S*S] -> NHWC f32[B, S, S, 2]."""
        b = board.reshape(board.shape[0], self.board_size, self.board_size)
        return torch.stack([(b == 1).float(), (b == -1).float()], dim=-1)

    def terminal(self, board: torch.Tensor, aux: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(done bool[B, 1], value f32[B, 1]) via one win-line matmul per
        sign (0/1 operands and sums <= win: exact in any precision mode)."""
        pos = (board == 1).float() @ aux
        neg = (board == -1).float() @ aux
        win = (pos >= self.win - 0.5).any(dim=1, keepdim=True)
        lose = (neg >= self.win - 0.5).any(dim=1, keepdim=True)
        full = (board != 0).all(dim=1, keepdim=True)
        return _outcome(win, lose, full)

    def valid_terminal(self, board: torch.Tensor, aux: torch.Tensor):
        """``(valid bool[B, S*S], done bool[B, 1], value f32[B, 1])``, what
        the search needs of each leaf batch."""
        return (self.valid(board), *self.terminal(board, aux))
