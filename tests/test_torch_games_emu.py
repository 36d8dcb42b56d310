"""Whole Othello, Gomoku and Hex searches of the hybrid engine through the
CUDA kernels (alphazero_tpu_torch/csrc/hybrid.cu: each game's descend
instance, the dense merge and the dense refresh), compiled with g++
against the CPU stand-in for the CUDA built-ins (tests/cuda_emu/; the
``emulated`` fixture of tests/torch_parity.py) and run on host memory:
every kernel call bit-equal to the plain PyTorch version on the same
planes (``torch_parity.checked_kernels``), one launch of each per
simulation and one refresh, and the Othello goldens reproduced. These
searches launch a warp a game in every descend, so they run in a file of
their own (``--dist loadfile`` gives it a worker); the Connect-Four
searches, the round kernels' searches and the synthetic cases are
tests/test_torch_kernels.py's, the descends' synthetic cases
tests/test_torch_descend_emu.py's.

This checks the kernels' LOGIC on the CPU; whether the source builds with
nvcc and runs on the card is chip_smoke.py's job.
"""

import json
import os

import numpy as np
import pytest
import torch

from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import Gomoku, Hex, Othello
from alphazero_tpu_torch.mcts import make_hybrid_root_fn
from alphazero_tpu_torch.models import (
    convert_az_resnet,
    make_apply_fn,
    make_uniform_model,
    random_az_resnet_variables,
)
from alphazero_tpu_torch.ops import sample_draws
from tests.torch_parity import (  # noqa: F401  (emulated: a fixture)
    checked_kernels,
    emulated,
    random_othello_boards,
    random_play_boards,
    torch_state,
)

HERE = os.path.dirname(os.path.abspath(__file__))
OTH = Othello()


def test_emulated_othello_kernels_reproduce_goldens(emulated):
    with open(os.path.join(HERE, "golden_counts.json")) as f:
        spec = json.load(f)["othello"]
    states = []
    for seq in spec["seqs"]:
        s = OTH.init(1, "cpu")
        for a in seq:
            s = OTH.step(s, torch.tensor([a]))
        states.append(s)
    calls = {}
    counts = make_hybrid_root_fn(
        OTH, make_uniform_model(OTH).apply_fn, MCTSConfig(num_sims=50, max_depth=64),
        kernels=checked_kernels(emulated, calls),
    )(torch.cat(states))
    np.testing.assert_array_equal(counts.numpy().astype(int), np.asarray(spec["counts"]))
    assert calls == {"az_descend_othello": 50, "az_merge_dense": 50, "az_refresh_dense": 1}


@pytest.mark.parametrize(
    "cfg,moves,dirichlet",
    [
        (MCTSConfig(num_sims=24, max_depth=80), 20, None),
        (MCTSConfig(num_sims=24, max_depth=80), 56, None),                  # passes, endgames
        (MCTSConfig(num_sims=20, max_depth=3, cpuct=2.5), 10, None),        # depth cutoffs
        (MCTSConfig(num_sims=20, max_depth=80, max_nodes=8), 30, None),     # slots run out
        (MCTSConfig(num_sims=16, max_depth=80, dirichlet_alpha=0.3), 6, 0.3),
    ],
    ids=["midgame", "endgames", "max_depth3", "max_nodes8", "dirichlet"],
)
def test_emulated_othello_kernels_bit_equal_plain(emulated, cfg, moves, dirichlet):
    """Whole Othello searches (40 games: ten descend blocks of four warps,
    a game each) with an f32 AZResNet-8x1 prior and value, so W backs up
    values of both signs and the cutoff backs up the heuristic: every
    Othello descend, dense merge and dense refresh call bit-equal to the
    plain versions."""
    apply_fn = make_apply_fn(convert_az_resnet(random_az_resnet_variables(65, 8, 1, cells=64, seed=moves),
                                               dtype=torch.float32))
    boards = torch_state(random_othello_boards(40, moves, seed=moves))
    noise = None
    if dirichlet is not None:
        noise = sample_draws(torch.Generator().manual_seed(3), 40, 65, dirichlet, "cpu").dirichlet
    calls = {}
    counts = make_hybrid_root_fn(OTH, apply_fn, cfg, kernels=checked_kernels(emulated, calls))(boards, noise)
    assert calls == {"az_descend_othello": cfg.num_sims, "az_merge_dense": cfg.num_sims,
                     "az_refresh_dense": 1}
    live = ~OTH.terminal(boards)[0]
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()


@pytest.mark.parametrize(
    "game,moves,cfg,model",
    [
        (Gomoku(7), 10, MCTSConfig(num_sims=16, max_depth=48), "uniform"),
        (Gomoku(7), 40, MCTSConfig(num_sims=16, max_depth=48), "uniform"),      # terminal children
        (Gomoku(8), 12, MCTSConfig(num_sims=16, max_depth=48, max_nodes=8), "uniform"),
        (Gomoku(9), 20, MCTSConfig(num_sims=16, max_depth=3, cpuct=2.5), "resnet"),   # cutoffs
        (Gomoku(15), 9, MCTSConfig(num_sims=12, max_depth=64), "uniform"),
        (Gomoku(4, 4), 5, MCTSConfig(num_sims=16, max_depth=48), "uniform"),   # A=16: lanes 16-31 idle
        (Gomoku(19), 40, MCTSConfig(num_sims=12, max_depth=64), "uniform"),    # 8-word boards, A=361
        (Gomoku(23), 40, MCTSConfig(num_sims=12, max_depth=64), "uniform"),    # 12 words, J=24: A=529
        (Gomoku(27), 60, MCTSConfig(num_sims=12, max_depth=64), "uniform"),    # A=729
        (Hex(), 0, MCTSConfig(num_sims=16, max_depth=56), "uniform"),
        (Hex(), 30, MCTSConfig(num_sims=16, max_depth=56), "resnet"),          # terminal children
        (Hex(), 12, MCTSConfig(num_sims=16, max_depth=3, max_nodes=8), "uniform"),
    ],
    ids=["gomoku7", "gomoku7_endgames", "gomoku8_max_nodes8", "gomoku9_resnet_max_depth3",
         "gomoku15", "gomoku4", "gomoku19", "gomoku23", "gomoku27", "hex_opening",
         "hex_resnet_endgames",
         "hex_max_depth3_max_nodes8"],
)
def test_emulated_gomoku_and_hex_kernels_bit_equal_plain(emulated, game, moves, cfg, model):
    """Whole Gomoku and Hex searches (40 games: ten descend blocks of four
    warps, a game each; random positions played past the end, so some are
    finished and some children terminal) with the uniform model or an f32
    AZResNet-4x1 (W of both signs): every call of the game's descend
    instance, the dense merge and the dense refresh bit-equal to the plain
    versions, with exactly one launch of each per simulation and one
    refresh."""
    A = game.num_actions
    apply_fn = make_uniform_model(game).apply_fn
    if model == "resnet":
        apply_fn = make_apply_fn(convert_az_resnet(
            random_az_resnet_variables(A, 4, 1, cells=A, seed=moves), dtype=torch.float32))
    boards = torch_state(random_play_boards(game, 40, moves, seed=moves, freeze_done=False))
    calls = {}
    counts = make_hybrid_root_fn(game, apply_fn, cfg, kernels=checked_kernels(emulated, calls))(boards)
    entry = kernels.descend_entry(game.flat_ops())
    if isinstance(game, Hex):
        assert entry == "az_descend_hex"
    else:
        assert entry == "az_descend_gomoku"
    assert calls == {entry: cfg.num_sims, "az_merge_dense": cfg.num_sims, "az_refresh_dense": 1}
    live = ~game.terminal(boards)[0]
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()
