"""Shared inputs for the JAX <-> PyTorch parity tests (tests/test_torch_*.py).

Inputs are made from a seed with numpy and handed to both packages as
numpy arrays: random-play Connect-Four and Othello boards, and the
conversions of a batch of boards into each package's state.
"""

import jax.numpy as jnp
import numpy as np
import torch

from alphazero_tpu.games.connect_four import ConnectFourState
from alphazero_tpu.games.othello import OthelloState
from alphazero_tpu_torch.games import ConnectFour as TorchConnectFour
from alphazero_tpu_torch.games import Othello as TorchOthello

# Tier-1 runs several pytest workers side by side; keep each one's
# intra-op pool small.
torch.set_num_threads(2)

_GAME = TorchConnectFour()
_OTHELLO = TorchOthello()

# a full board with no four-in-a-row (an exact-0 draw)
DRAW_BOARD = np.array(
    [
        [-1, 1, -1, -1, -1, 1, -1],
        [-1, -1, 1, -1, 1, 1, -1],
        [1, 1, 1, -1, 1, 1, 1],
        [-1, -1, 1, 1, 1, -1, -1],
        [1, 1, -1, -1, -1, 1, -1],
        [-1, 1, -1, 1, -1, 1, 1],
    ],
    np.int8,
)


def random_boards(batch: int, moves: int, seed: int, freeze_done: bool = True) -> np.ndarray:
    """int8[B, 6, 7] canonical boards after ``moves`` uniformly random
    legal moves (games that finish freeze unless ``freeze_done`` is
    False, which keeps playing past wins while moves are legal)."""
    rng = np.random.default_rng(seed)
    state = _GAME.init(batch, "cpu")
    for _ in range(moves):
        valid = _GAME.valid_moves(state).numpy()
        acts = np.array([rng.choice(np.flatnonzero(v)) if v.any() else 0 for v in valid])
        nxt = _GAME.step(state, torch.as_tensor(acts))
        done, _ = _GAME.terminal(nxt)
        stop = ~torch.as_tensor(valid.any(axis=1))
        if freeze_done:
            stop |= done
        state = torch.where(stop[:, None, None], state, nxt)
    return state.numpy()


def jax_state(boards: np.ndarray) -> ConnectFourState:
    return ConnectFourState(board=jnp.asarray(boards, jnp.int8))


def torch_state(boards: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(boards, np.int8))


def boards_from_seqs(seqs) -> np.ndarray:
    """int8[N, 6, 7] boards reached by the given move sequences."""
    out = []
    for seq in seqs:
        s = _GAME.init(1, "cpu")
        for a in seq:
            s = _GAME.step(s, torch.tensor([a]))
        out.append(s)
    return torch.cat(out).numpy()


def random_othello_boards(batch: int, moves: int, seed: int, freeze_done: bool = True) -> np.ndarray:
    """int8[B, 8, 8] canonical Othello boards after ``moves`` uniformly
    random legal moves (the pass when it is the only one); finished games
    freeze unless ``freeze_done`` is False, which keeps passing."""
    rng = np.random.default_rng(seed)
    state = _OTHELLO.init(batch, "cpu")
    for _ in range(moves):
        valid = _OTHELLO.valid_moves(state).numpy()
        acts = np.array([rng.choice(np.flatnonzero(v)) for v in valid])
        nxt = _OTHELLO.step(state, torch.as_tensor(acts))
        if freeze_done:
            done, _ = _OTHELLO.terminal(state)
            nxt = torch.where(done[:, None, None], state, nxt)
        state = nxt
    return state.numpy()


def othello_jax_state(boards: np.ndarray) -> OthelloState:
    return OthelloState(board=jnp.asarray(boards, jnp.int8))
