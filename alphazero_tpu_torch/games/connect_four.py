"""Connect-Four on batched torch tensors.

Counterpart of ``alphazero_tpu/games/connect_four.py``, with the same
semantics: a 6x7 board, win length 4, canonical boards (+1 = player to
move; ``step`` drops a +1 piece and sign-flips), inclusive win-window
bounds, exact-0 draws, NHWC ``[6, 7, 2]`` features.

``ConnectFour`` works on batched ``int8[B, 6, 7]`` boards (the JAX class
works on one board under ``vmap``). ``FlatOps`` works on flat row-major
``f32[B, 42]`` boards (cell ``r*7 + c``, row 5 the top), the form the
hybrid search carries through its descend kernel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

ROWS = 6
COLS = 7
WIN = 4


def _has_win(board: torch.Tensor, player: int) -> torch.Tensor:
    """bool[B]: ``player`` (+1/-1) has 4 in a row on int8[B, 6, 7] boards
    (static shifted ANDs over the four directions, inclusive bounds)."""
    p = board == player
    horiz = p[:, :, : COLS - 3] & p[:, :, 1 : COLS - 2] & p[:, :, 2 : COLS - 1] & p[:, :, 3:]
    vert = p[:, : ROWS - 3, :] & p[:, 1 : ROWS - 2, :] & p[:, 2 : ROWS - 1, :] & p[:, 3:, :]
    diag = (
        p[:, : ROWS - 3, : COLS - 3]
        & p[:, 1 : ROWS - 2, 1 : COLS - 2]
        & p[:, 2 : ROWS - 1, 2 : COLS - 1]
        & p[:, 3:, 3:]
    )
    anti = (
        p[:, 3:, : COLS - 3]
        & p[:, 2 : ROWS - 1, 1 : COLS - 2]
        & p[:, 1 : ROWS - 2, 2 : COLS - 1]
        & p[:, : ROWS - 3, 3:]
    )
    return (
        horiz.flatten(1).any(1)
        | vert.flatten(1).any(1)
        | diag.flatten(1).any(1)
        | anti.flatten(1).any(1)
    )


class ConnectFour:
    """``Game`` protocol implementation on ``int8[B, 6, 7]`` boards."""

    name = "connect_four"
    num_actions = COLS
    feature_shape = (ROWS, COLS, 2)
    max_moves = ROWS * COLS
    num_symmetries = 2
    heuristic_is_zero = True

    def init(self, batch: int, device: torch.device | str = "cuda") -> torch.Tensor:
        return torch.zeros((batch, ROWS, COLS), dtype=torch.int8, device=device)

    def step(self, board: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """Drop a +1 piece in column ``action`` (int64[B]); return the
        flipped boards. A full column clamps to the top row and overwrites
        that cell, exactly like the JAX ``ConnectFour.step`` (callers
        done-mask such states)."""
        b = board.shape[0]
        action = action.long()
        heights = (board != 0).sum(dim=1)                              # [B, 7]
        row = heights.gather(1, action[:, None])[:, 0].clamp(max=ROWS - 1)
        out = board.clone()
        out[torch.arange(b, device=board.device), row, action] = 1
        return -out

    def valid_moves(self, board: torch.Tensor) -> torch.Tensor:
        return board[:, ROWS - 1, :] == 0

    def terminal(self, board: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(done bool[B], value f32[B]): a -1 win means the previous mover
        won (value -1); draws are exact 0."""
        lose = _has_win(board, -1)
        win = _has_win(board, 1)
        full = (board[:, ROWS - 1, :] != 0).all(dim=1)
        done = lose | win | full
        value = win.float() - (lose & ~win).float()
        return done, value

    def to_features(self, board: torch.Tensor) -> torch.Tensor:
        """NHWC f32[B, 6, 7, 2]: (my pieces, opponent pieces)."""
        return torch.stack(
            [(board == 1).float(), (board == -1).float()], dim=-1
        )

    def symmetries(
        self, features: torch.Tensor, pi: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Identity + horizontal mirror with reversed pi:
        (feats[B, 2, 6, 7, 2], pis[B, 2, 7])."""
        feats = torch.stack([features, features.flip(2)], dim=1)
        pis = torch.stack([pi, pi.flip(1)], dim=1)
        return feats, pis

    def eval_heuristic(self, board: torch.Tensor) -> torch.Tensor:
        return torch.zeros(board.shape[0], device=board.device)

    def flat_ops(self) -> "FlatOps":
        return FlatOps()


def _win_line_matrix() -> np.ndarray:
    """f32[42, 69] incidence matrix of the 69 four-in-a-row windows
    (row-major cells; the same construction and window order as the JAX
    ``_win_line_matrix``)."""
    lines = []
    for r in range(ROWS):
        for c in range(COLS - WIN + 1):
            lines.append([(r, c + i) for i in range(WIN)])
    for c in range(COLS):
        for r in range(ROWS - WIN + 1):
            lines.append([(r + i, c) for i in range(WIN)])
    for r in range(ROWS - WIN + 1):
        for c in range(COLS - WIN + 1):
            lines.append([(r + i, c + i) for i in range(WIN)])
    for r in range(WIN - 1, ROWS):
        for c in range(COLS - WIN + 1):
            lines.append([(r - i, c + i) for i in range(WIN)])
    m = np.zeros((ROWS * COLS, len(lines)), np.float32)
    for j, cells in enumerate(lines):
        for r, c in cells:
            m[r * COLS + c, j] = 1.0
    return m


class FlatOps:
    """Connect-Four dynamics on flat ``f32[B, 42]`` boards (row-major,
    row 5 = lanes 35..41), the same values as the ``ConnectFour`` methods.
    Per-game scalars are ``[B, 1]`` columns, as in the JAX ``FlatOps``."""

    size = ROWS * COLS
    num_actions = COLS
    aux_lanes = 128

    def aux(self, device: torch.device | str = "cuda") -> torch.Tensor:
        """The win-line matrix zero-padded to 128 columns, f32[42, 128]
        (padding columns sum to 0 < 4)."""
        m = _win_line_matrix()
        m = np.pad(m, ((0, 0), (0, self.aux_lanes - m.shape[1])))
        return torch.from_numpy(m).to(device)

    def from_state(self, board: torch.Tensor) -> torch.Tensor:
        """int8[B, 6, 7] boards -> f32[B, 42]."""
        return board.reshape(board.shape[0], -1).float()

    def step(self, board: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """Drop +1 in column ``action`` (exact-int f32[B, 1]), clamped to
        the top cell when full, then sign-flip — the JAX ``FlatOps.step``
        arithmetic, op for op."""
        lane = torch.arange(self.size, device=board.device)
        lane_f = lane.float()
        col_f = (lane % COLS).float()
        in_col = (col_f == action).float()                           # [B, 42]
        h = (in_col * (board != 0).float()).sum(dim=1, keepdim=True)
        target = torch.clamp(h, max=ROWS - 1) * COLS + action
        hit = (lane_f == target).float()
        dropped = board + hit * (1.0 - board)
        return -dropped

    def valid(self, board: torch.Tensor) -> torch.Tensor:
        """bool[B, 7]: top cell of each column empty."""
        return board[:, (ROWS - 1) * COLS :] == 0

    def to_features(self, board: torch.Tensor) -> torch.Tensor:
        """f32[B, 42] -> NHWC f32[B, 6, 7, 2]."""
        b = board.reshape(board.shape[0], ROWS, COLS)
        return torch.stack([(b == 1).float(), (b == -1).float()], dim=-1)

    def terminal(
        self, board: torch.Tensor, aux: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(done bool[B, 1], value f32[B, 1]) via one win-line matmul per
        sign (0/1 operands and sums <= 4: exact in any precision mode)."""
        pos = (board == 1).float() @ aux
        neg = (board == -1).float() @ aux
        win = (pos >= WIN - 0.5).any(dim=1, keepdim=True)
        lose = (neg >= WIN - 0.5).any(dim=1, keepdim=True)
        full = (board[:, (ROWS - 1) * COLS :] != 0).all(dim=1, keepdim=True)
        done = win | lose | full
        value = win.float() - (lose & ~win).float()
        return done, value

    def valid_terminal(self, board: torch.Tensor, aux: torch.Tensor):
        """``(valid bool[B, 7], done bool[B, 1], value f32[B, 1])``, what
        the search needs of each leaf batch."""
        return (self.valid(board), *self.terminal(board, aux))
