"""The port's K>1 leaf-parallel rounds on Othello, Gomoku and Hex (the
plain versions of the round kernels on the CPU) against the JAX hybrid
engine's rounds (its round kernels in the Pallas interpreter, which any
``block_size`` selects off the TPU): equal root counts, with Othello's
depth cutoffs backing up its disc-differential heuristic. The JAX Othello
reference compiles for ~25 s, Gomoku's and Hex's for ~10 s."""

import dataclasses

import numpy as np

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import Gomoku as JaxGomoku
from alphazero_tpu.games import Hex as JaxHex
from alphazero_tpu.games import Othello as JaxOthello
from alphazero_tpu.mcts.hybrid import make_hybrid_root_fn as jax_hybrid_root_fn
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import Gomoku, Hex, Othello
from alphazero_tpu_torch.mcts import PLAIN, hybrid, make_hybrid_root_fn
from alphazero_tpu_torch.models import make_uniform_model
from tests.torch_parity import (
    gomoku_jax_state,
    hex_jax_state,
    othello_jax_state,
    random_othello_boards,
    random_play_boards,
    torch_state,
)

OTH = Othello()


def _compare(jax_game, game, jax_state, cfg, boards, kernels=PLAIN):
    """(JAX hybrid rounds, port rounds) uniform-model root counts."""
    jax_fn = jax_hybrid_root_fn(jax_game, jax_uniform(jax_game).apply_fn, cfg, block_size=len(boards))
    c_jax = np.asarray(jax_fn({}, jax_state(boards)))
    port_fn = make_hybrid_root_fn(game, make_uniform_model(game).apply_fn,
                                  MCTSConfig(**dataclasses.asdict(cfg)), kernels=kernels)
    return c_jax, port_fn(torch_state(boards)).numpy()


def test_othello_rounds_conserve_sims_on_fresh_boards():
    """Every round backs up K values: on fresh boards the root counts sum
    to num_sims (tests/test_hybrid.py's check of the JAX rounds)."""
    cfg = MCTSConfig(num_sims=12, max_depth=64, parallel_sims=3)
    counts = make_hybrid_root_fn(OTH, make_uniform_model(OTH).apply_fn, cfg)(OTH.init(4, "cpu"))
    np.testing.assert_array_equal(counts.sum(1).numpy(), 12)


def test_othello_cutoff_rounds_match_jax_hybrid():
    """K=3 at max_depth 4 on endgame positions, with enough simulations
    to reach the cutoff: cut leaves back up the heuristic of the leaf
    board, and the root counts equal the JAX hybrid engine's."""
    cuts = []

    def counting_descend_round(*args):
        out = hybrid.descend_round(*args)
        cuts.append(float(out[3][..., hybrid.M_CUT].sum()))
        return out

    kernels = PLAIN._replace(descend_round=counting_descend_round)
    cfg = JaxMCTSConfig(num_sims=48, max_depth=4, parallel_sims=3)
    boards = random_othello_boards(8, 56, seed=4)
    c_jax, c_port = _compare(JaxOthello(), OTH, othello_jax_state, cfg, boards, kernels)
    np.testing.assert_array_equal(c_port, c_jax)
    assert sum(cuts) > 0


def test_gomoku7_rounds_match_jax_hybrid():
    cfg = JaxMCTSConfig(num_sims=16, max_depth=48, parallel_sims=4)
    boards = random_play_boards(Gomoku(7), 8, 12, seed=5)
    c_jax, c_port = _compare(JaxGomoku(7), Gomoku(7), gomoku_jax_state, cfg, boards)
    np.testing.assert_array_equal(c_port, c_jax)


def test_hex_rounds_match_jax_hybrid():
    cfg = JaxMCTSConfig(num_sims=16, max_depth=56, parallel_sims=4)
    boards = random_play_boards(Hex(), 8, 10, seed=6)
    c_jax, c_port = _compare(JaxHex(), Hex(), hex_jax_state, cfg, boards)
    np.testing.assert_array_equal(c_port, c_jax)
