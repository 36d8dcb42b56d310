"""The port's coach on Othello against the JAX coach, on the CPU, on
``torch_parity.outer_cfg`` (the Othello ``full`` preset's kind of
anchored pass at a tiny size: continuous mode, a warmup pass of two
anchor arenas) for two iterations in each package, the pass at the first
only, the JAX run in a module fixture (~110 s alone: its Othello
self-play scan, gate arena and anchor arena each compile for ~30 s on the
CPU, and every later anchored pass recompiles its arenas, so the pool's
matches are held on Gomoku and Hex): the records' keys, the ring holding
every move once per symmetry (8), the adoptions, and the anchored match
graph. The two packages draw different random numbers, so wins differ;
the structure may not. The Othello resume is in
``tests/test_torch_coach_resume.py``."""

import pytest
import torch

from alphazero_tpu.games import Othello as JaxOthello
from alphazero_tpu_torch.games import Othello
from tests.torch_parity import (
    check_continuous,
    check_match_graph,
    check_record_keys,
    check_replay_holds_the_symmetries,
    coach_runs,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    return coach_runs(JaxOthello(), Othello(), 2, anchor_interval=3)


def test_record_keys_equal_jax(runs):
    check_record_keys(*runs)


def test_replay_holds_every_move_eight_times(runs):
    for run in runs:
        check_replay_holds_the_symmetries(run, 8)


def test_continuous_mode_always_adopts(runs):
    check_continuous(*runs)


def test_anchored_match_graph_structure_equals_jax(runs):
    check_match_graph(*runs)
    assert [(m["a"], m["b"], m["wins_a"] + m["wins_b"] + m["draws"])
            for m in runs[1].pool_matches] == [(1, "anchor", 4)]   # two arenas of two games
    assert ["anchored_elo" in r for r in runs[1].records] == [True, False]
