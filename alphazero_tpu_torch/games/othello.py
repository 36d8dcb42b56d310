"""Othello/Reversi 8x8 on batched torch tensors.

Counterpart of ``alphazero_tpu/games/othello.py``, with the same rules:
65 actions (64 squares + the pass, action 64), the pass legal only when no
placement is, game over when neither side can place, value = sign of the
disc differential from the player to move's side, canonical boards (+1 =
player to move; ``step`` places a +1 disc, flips, and sign-flips).

``Othello`` works on batched ``int8[B, 8, 8]`` boards (the JAX class works
on one board under ``vmap``). ``OthelloFlatOps`` works on flat row-major
``f32[B, 64]`` boards (cell ``r*8 + c``), the form the hybrid search
carries through its descend kernel; its ``step`` is the plain version of
the kernel's helper ``othello_step`` (``csrc/othello.cuh``).

Legality and flips read every cell along the 8 rays of every square at
once: ``_RAYS[i, d, k-1]`` is the cell at distance k from cell i in
direction d, or 64 (a padding cell that holds no disc) off the board. The
7 cells of a ray (+1/-1/0) are one base-3 number, and a table of all
3^7 = 2187 rays gives the length of the run of -1 discs that a +1 disc
closes at its start (0: none). A square is legal for the player to move
when one of its rays has such a run; for the opponent, the same table read
at the colour-swapped number; ``step`` flips the runs of the move cell's
rays. So the legality of both players is one gather, one weighted sum and
two table reads, computed once per leaf batch by ``valid_terminal``: the
glue runs once per simulation on a host-paced path, so it is kept to few,
plain elementwise launches (no scans).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

SIZE = 8
CELLS = SIZE * SIZE
PASS = CELLS  # action 64

_DIRS = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1),           (0, 1),
    (1, -1), (1, 0), (1, 1),
)


def _ray_table() -> np.ndarray:
    """int64[64, 8, 7]: the cell at distance k (1..7) from each cell along
    each direction, 64 where the ray has left the board."""
    rays = np.full((CELLS, len(_DIRS), SIZE - 1), CELLS, np.int64)
    for i in range(CELLS):
        r0, c0 = divmod(i, SIZE)
        for d, (dr, dc) in enumerate(_DIRS):
            for k in range(1, SIZE):
                r, c = r0 + k * dr, c0 + k * dc
                if 0 <= r < SIZE and 0 <= c < SIZE:
                    rays[i, d, k - 1] = r * SIZE + c
    return rays


def _run_table() -> np.ndarray:
    """int64[3^7]: for the ray whose cells k = 0..6 (distance k+1) hold
    digit_k - 1 of its base-3 number, the length of the run of -1 discs
    from distance 1 that a +1 disc closes; 0 when no +1 disc closes one."""
    runs = np.zeros(3 ** (SIZE - 1), np.int64)
    for code in range(len(runs)):
        cells = [(code // 3 ** k) % 3 - 1 for k in range(SIZE - 1)]
        k = 0
        while k < len(cells) and cells[k] == -1:
            k += 1
        runs[code] = k if 0 < k < len(cells) and cells[k] == 1 else 0
    return runs


_RAYS = _ray_table()
_RUNS = _run_table()
_POW3 = 3.0 ** np.arange(SIZE - 1)
_ZERO_CODE = int(_POW3.sum())   # the number of an empty ray; 2 * it: all +1


@lru_cache(maxsize=None)
def _tables(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The ray table, the run table, and the run table's ``> 0`` read as
    the player to move (+1 closes) and as the opponent (-1 closes: the
    colour-swapped number, 2 * _ZERO_CODE - code), on ``device``."""
    runs = torch.as_tensor(_RUNS, device=device)
    closes = runs > 0
    return (torch.as_tensor(_RAYS, device=device), runs, closes, closes.flip(0),
            torch.as_tensor(_POW3, dtype=torch.float32, device=device))


def _padded(board: torch.Tensor) -> torch.Tensor:
    """Flat boards [B, 64] -> f32[B, 65], the off-board cell 64 empty."""
    return torch.cat([board.float(), torch.zeros_like(board[:, :1], dtype=torch.float32)], dim=1)


def _ray_codes(cells: torch.Tensor, pow3: torch.Tensor) -> torch.Tensor:
    """The base-3 number (int64[...]) of each ray's cells f32[..., 7]
    (exact small integers)."""
    return (cells * pow3).sum(dim=-1).long() + _ZERO_CODE


def legal_both(board: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bool[B, 64], bool[B, 64]): the squares where +1 (the player to
    move) and where -1 could place, on flat boards (any dtype, values
    +1/-1/0)."""
    rays, _, closes_mine, closes_theirs, pow3 = _tables(board.device)
    codes = _ray_codes(_padded(board)[:, rays], pow3)        # [B, 64, 8]
    empty = board == 0
    mine = empty & closes_mine[codes].any(dim=-1)
    theirs = empty & closes_theirs[codes].any(dim=-1)
    return mine, theirs


def _valid_from(legal: torch.Tensor) -> torch.Tensor:
    """bool[B, 65]: the placements, then the pass (legal iff none is)."""
    return torch.cat([legal, ~legal.any(dim=1, keepdim=True)], dim=1)


def _terminal_from(board, mine, theirs) -> Tuple[torch.Tensor, torch.Tensor]:
    """(done bool[B], value f32[B]): nobody can place; the sign of the disc
    sum (integers: exact in any order)."""
    done = ~mine.any(dim=1) & ~theirs.any(dim=1)
    diff = board.reshape(board.shape[0], -1).to(torch.int32).sum(dim=1)
    return done, torch.where(done, torch.sign(diff).float(), 0.0)


def flat_step(board: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Place a +1 disc at ``action`` (exact-int f32[B, 1]; >= 64 passes),
    flip every run of -1 discs that a +1 disc closes along the 8 rays from
    the move cell, then sign-flip — ``OthelloFlatOps.step`` of the JAX
    package on f32[B, 64]. The move cell becomes +1 even when occupied, and
    a placement that closes no run drops a lone disc (callers mask such
    states)."""
    B = board.shape[0]
    place = action[:, 0] < PASS - 0.5
    a = action[:, 0].clamp(max=PASS - 1).long()
    rays_all, runs, _, _, pow3 = _tables(board.device)
    rays = rays_all[a].reshape(B, -1)                        # [B, 56]
    cells = _padded(board).gather(1, rays).reshape(B, len(_DIRS), SIZE - 1)
    run = runs[_ray_codes(cells, pow3)]                      # [B, 8]
    k = torch.arange(SIZE - 1, device=board.device)
    flip = (k < run[..., None]) & place[:, None, None]       # the first `run` cells
    # each board cell lies on at most one ray from the move; the off-board
    # cell 64 only ever receives False (a run ends before the board's edge)
    flips = torch.zeros((B, CELLS + 1), dtype=torch.bool, device=board.device)
    flips.scatter_(1, rays, flip.reshape(B, -1))
    move = torch.zeros_like(flips[:, :CELLS])
    move[torch.arange(B, device=board.device), a] = place
    return -torch.where(flips[:, :CELLS] | move, 1.0, board)


class Othello:
    """``Game`` protocol implementation on ``int8[B, 8, 8]`` boards."""

    name = "othello"
    num_actions = PASS + 1           # 64 squares + pass
    feature_shape = (SIZE, SIZE, 2)
    max_moves = 96                   # 60 placements + pass slack
    num_symmetries = 8               # dihedral group of the board
    heuristic_is_zero = False        # the cutoff backs up the disc differential

    def init(self, batch: int, device: torch.device | str = "cuda") -> torch.Tensor:
        board = torch.zeros((batch, SIZE, SIZE), dtype=torch.int8, device=device)
        board[:, 3, 3] = 1
        board[:, 4, 4] = 1
        board[:, 3, 4] = -1
        board[:, 4, 3] = -1
        return board

    def step(self, board: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """Place (or pass, action 64) for the player to move, with
        ``action`` int64[B]; return the sign-flipped boards."""
        flat = flat_step(board.reshape(board.shape[0], CELLS).float(), action.float()[:, None])
        return flat.reshape(board.shape).to(torch.int8)

    def valid_moves(self, board: torch.Tensor) -> torch.Tensor:
        mine, _ = legal_both(board.reshape(board.shape[0], CELLS))
        return _valid_from(mine)

    def terminal(self, board: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(done bool[B], value f32[B]): neither side can place; value =
        sign of the disc differential, player-to-move perspective."""
        mine, theirs = legal_both(board.reshape(board.shape[0], CELLS))
        return _terminal_from(board, mine, theirs)

    def to_features(self, board: torch.Tensor) -> torch.Tensor:
        """NHWC f32[B, 8, 8, 2]: (my discs, opponent discs)."""
        return torch.stack([(board == 1).float(), (board == -1).float()], dim=-1)

    def symmetries(
        self, features: torch.Tensor, pi: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The 8 board symmetries (rotations by k quarter turns, each
        unmirrored then mirrored left-right, the JAX order); the pass entry
        is invariant: (feats[B, 8, 8, 8, 2], pis[B, 8, 65])."""
        grid = pi[:, :PASS].reshape(-1, SIZE, SIZE)
        feats, pis = [], []
        for k in range(4):
            f = torch.rot90(features, k, dims=(1, 2))
            g = torch.rot90(grid, k, dims=(1, 2))
            for flip in (False, True):
                ff = f.flip(2) if flip else f
                gg = g.flip(2) if flip else g
                feats.append(ff)
                pis.append(torch.cat([gg.reshape(-1, CELLS), pi[:, PASS:]], dim=1))
        return torch.stack(feats, dim=1), torch.stack(pis, dim=1)

    def eval_heuristic(self, board: torch.Tensor) -> torch.Tensor:
        """f32[B] depth-cutoff estimate: the normalized disc differential."""
        return board.reshape(board.shape[0], -1).float().sum(dim=1) / CELLS

    def flat_ops(self) -> "OthelloFlatOps":
        return OthelloFlatOps()


class OthelloFlatOps:
    """Othello dynamics on flat ``f32[B, 64]`` boards, the same values as
    the ``Othello`` methods. Per-game scalars are ``[B, 1]`` columns, as in
    the JAX ``OthelloFlatOps``; ``heuristic`` is the nonzero depth-cutoff
    value the hybrid engine backs up."""

    size = CELLS
    num_actions = PASS + 1

    def aux(self, device: torch.device | str = "cuda") -> torch.Tensor:
        """The game constant the search hands to ``terminal``: none is
        needed (the ray tables are cached per device), so an empty
        placeholder, as the JAX ``OthelloFlatOps.aux`` ships one."""
        return torch.zeros(0, device=device)

    def from_state(self, board: torch.Tensor) -> torch.Tensor:
        """int8[B, 8, 8] boards -> f32[B, 64]."""
        return board.reshape(board.shape[0], -1).float()

    def step(self, board: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return flat_step(board, action)

    def valid(self, board: torch.Tensor) -> torch.Tensor:
        """bool[B, 65]: legality, the pass included."""
        return _valid_from(legal_both(board)[0])

    def terminal(self, board: torch.Tensor, aux: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(done bool[B, 1], value f32[B, 1])."""
        done, value = _terminal_from(board, *legal_both(board))
        return done[:, None], value[:, None]

    def valid_terminal(self, board: torch.Tensor, aux: torch.Tensor):
        """``valid`` and ``terminal`` from one legality pass:
        ``(valid bool[B, 65], done bool[B, 1], value f32[B, 1])``."""
        mine, theirs = legal_both(board)
        done, value = _terminal_from(board, mine, theirs)
        return _valid_from(mine), done[:, None], value[:, None]

    def to_features(self, board: torch.Tensor) -> torch.Tensor:
        """f32[B, 64] -> NHWC f32[B, 8, 8, 2]."""
        b = board.reshape(board.shape[0], SIZE, SIZE)
        return torch.stack([(b == 1).float(), (b == -1).float()], dim=-1)

    def heuristic(self, board: torch.Tensor) -> torch.Tensor:
        """f32[B, 1] disc differential / 64 (``Othello.eval_heuristic``)."""
        return board.sum(dim=1, keepdim=True) / CELLS
