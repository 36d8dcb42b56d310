"""``tests/torch_round_goldens.json``: root counts of K=4 leaf-parallel
rounds with the uniform model, frozen from the JAX hybrid engine (its
round kernels in the Pallas interpreter) for Connect-Four and Othello.
Each test re-derives its game's counts from the JAX package, so the file
cannot drift from the reference, and the port reproduces them.
``chip_smoke.py`` reproduces them through the CUDA round kernels."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.games import Othello as JaxOthello
from alphazero_tpu.mcts.hybrid import make_hybrid_root_fn as jax_hybrid_root_fn
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour, Othello
from alphazero_tpu_torch.mcts import make_hybrid_root_fn
from alphazero_tpu_torch.models import make_uniform_model
from tests.torch_parity import jax_state, othello_jax_state, torch_state

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_round_goldens.json")) as f:
    GOLDENS = json.load(f)
GAMES = {
    "connect_four": (JaxConnectFour(), ConnectFour(), jax_state),
    "othello": (JaxOthello(), Othello(), othello_jax_state),
}


@pytest.mark.parametrize("name", sorted(GAMES))
def test_round_goldens_frozen_from_jax(name):
    jax_game, game, to_jax = GAMES[name]
    spec = GOLDENS[name]
    states = []
    for seq in spec["seqs"]:
        s = game.init(1, "cpu")
        for a in seq:
            s = game.step(s, torch.tensor([a]))
        states.append(s)
    boards = torch.cat(states).numpy()
    cfg = JaxMCTSConfig(num_sims=spec["num_sims"], max_depth=spec["max_depth"],
                        parallel_sims=spec["parallel_sims"])
    jax_fn = jax_hybrid_root_fn(jax_game, jax_uniform(jax_game).apply_fn, cfg, block_size=len(boards))
    want = np.asarray(spec["counts"])
    np.testing.assert_array_equal(np.asarray(jax_fn({}, to_jax(boards))), want)
    port_fn = make_hybrid_root_fn(game, make_uniform_model(game).apply_fn,
                                  MCTSConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_array_equal(port_fn(torch_state(boards)).numpy(), want)
    assert (want.sum(1) == spec["num_sims"]).all()
