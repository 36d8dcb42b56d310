"""The uniform fused search kernels, ``az_fused`` and ``az_fused_rounds``
(alphazero_tpu_torch/csrc/fused.cu: eight lanes a game, four games a
warp, 16 games a block), compiled with g++ against the CPU stand-in for
the CUDA built-ins (tests/cuda_emu/; the ``emulated`` fixture of
tests/torch_parity.py) and run on host memory. Whole searches
must be bit-equal to the plain versions ``fused_search`` and
``fused_rounds_search`` in counts and root W, and reproduce the goldens:
on late positions, endgames, depth cutoffs, slots running out, finished
and Dirichlet roots, at K = 1, 2, 4 and 9 and values 0, 0.3 and 0.5; and
on the cases the lane layout makes: exact ties across the eight lanes, a
root with one legal edge (no runner-up), warps whose games end at other
depths beside a done root and padding games, a tree of one slot, K = 9
(more leaves than lanes) and a non-integer W.

This checks the kernels' LOGIC on the CPU; whether the source builds with
nvcc and runs on the card is chip_smoke.py's job.
"""

import json
import os

import numpy as np
import pytest
import torch

from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.games.connect_four import FlatOps
from alphazero_tpu_torch.mcts import fused_rounds_search, fused_search, make_fused_root_fn
from alphazero_tpu_torch.mcts.tree import INVALID_P
from alphazero_tpu_torch.models import make_uniform_model
from alphazero_tpu_torch.ops import sample_draws
from tests.torch_parity import (  # noqa: F401  (emulated: a fixture)
    DRAW_BOARD,
    bits,
    boards_from_seqs,
    emulated,
    random_boards,
    torch_state,
)

HERE = os.path.dirname(os.path.abspath(__file__))
TG = ConnectFour()


def _checked_fused(lib, calls):
    """A ``kernels.fused`` stand-in running the emulated ``az_fused`` AND
    the plain ``fused_search`` on every call, asserting bit-equal counts
    and root W."""

    def fused(boards, priors, num_sims, nodes, max_depth, cpuct, uval, ops=None):
        B = boards.shape[0]
        tree = torch.empty(B, nodes, 32)
        counts, rootw = torch.empty(B, 7), torch.empty(B, 7)
        rc = lib.lib.az_fused(
            *(t.data_ptr() for t in (boards, priors, tree, counts, rootw)),
            B, nodes, num_sims, max_depth, cpuct, uval, None,
        )
        assert rc == 0
        cfg = MCTSConfig(num_sims=num_sims, max_nodes=nodes, max_depth=max_depth, cpuct=cpuct)
        ref_counts, ref_w = fused_search(boards, priors, cfg, uval)
        assert torch.equal(bits(counts), bits(ref_counts)), "fused counts"
        assert torch.equal(bits(rootw), bits(ref_w)), "fused root W"
        calls["fused"] += 1
        return counts, rootw

    return fused


def test_emulated_reproduces_goldens(emulated):
    with open(os.path.join(HERE, "golden_counts.json")) as f:
        spec = json.load(f)["connect_four"]
    calls = {"fused": 0}
    root_counts = make_fused_root_fn(
        TG, make_uniform_model(TG).apply_fn, MCTSConfig(num_sims=50, max_depth=64),
        kernel=_checked_fused(emulated, calls),
    )
    counts = root_counts(torch_state(boards_from_seqs(spec["seqs"])))
    np.testing.assert_array_equal(counts.numpy().astype(int), np.asarray(spec["counts"]))
    assert calls == {"fused": 1}


@pytest.mark.parametrize(
    "cfg,moves,value,freeze",
    [
        (MCTSConfig(num_sims=24, max_depth=48), 12, 0.0, True),
        (MCTSConfig(num_sims=24, max_depth=48), 30, 0.5, True),         # W signs, endgames
        (MCTSConfig(num_sims=16, max_depth=3, cpuct=2.5), 6, 0.0, True),  # depth cutoffs
        (MCTSConfig(num_sims=20, max_depth=48, max_nodes=8), 28, 0.0, True),  # slots run out
        (MCTSConfig(num_sims=12, max_depth=48), 36, -0.25, False),      # played past wins
    ],
    ids=["late_positions", "uval0.5_endgames", "max_depth3", "max_nodes8", "past_wins"],
)
def test_emulated_bit_equal_plain(emulated, cfg, moves, value, freeze):
    calls = {"fused": 0}
    boards = torch_state(random_boards(40, moves, seed=moves, freeze_done=freeze))
    counts = make_fused_root_fn(
        TG, make_uniform_model(TG, value).apply_fn, cfg, kernel=_checked_fused(emulated, calls)
    )(boards)
    assert calls == {"fused": 1}
    live = ~TG.terminal(boards)[0]
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()


def test_emulated_bit_equal_plain_dirichlet(emulated):
    cfg = MCTSConfig(num_sims=20, max_depth=48, dirichlet_alpha=0.7)
    noise = sample_draws(torch.Generator().manual_seed(1), 32, 7, 0.7, "cpu").dirichlet
    calls = {"fused": 0}
    make_fused_root_fn(
        TG, make_uniform_model(TG, 0.5).apply_fn, cfg, kernel=_checked_fused(emulated, calls)
    )(torch_state(random_boards(32, 8, seed=4)), noise)
    assert calls == {"fused": 1}


def _checked_fused_rounds(lib, calls):
    """A ``kernels.fused_rounds`` stand-in running the emulated
    ``az_fused_rounds`` AND the plain ``fused_rounds_search`` on every call,
    asserting bit-equal counts and root W."""

    def fused_rounds(boards, priors, num_sims, nodes, max_depth, cpuct, uval, K, ops=None):
        B = boards.shape[0]
        tree, rnd = torch.empty(B, nodes, 32), torch.empty(B, nodes, 16)
        counts, rootw = torch.empty(B, 7), torch.empty(B, 7)
        rc = lib.lib.az_fused_rounds(
            *(t.data_ptr() for t in (boards, priors, tree, rnd, counts, rootw)),
            B, nodes, K, num_sims, max_depth, cpuct, uval, None,
        )
        assert rc == 0
        cfg = MCTSConfig(num_sims=num_sims, max_nodes=nodes, max_depth=max_depth, cpuct=cpuct,
                         parallel_sims=K)
        ref_counts, ref_w = fused_rounds_search(boards, priors, cfg, uval)
        assert torch.equal(bits(counts), bits(ref_counts)), "fused_rounds counts"
        assert torch.equal(bits(rootw), bits(ref_w)), "fused_rounds root W"
        calls["fused_rounds"] += 1
        return counts, rootw

    return fused_rounds


@pytest.mark.parametrize(
    "cfg,moves,value,freeze,dirichlet",
    [
        (MCTSConfig(num_sims=24, max_depth=48, parallel_sims=2), 10, 0.0, True, None),
        (MCTSConfig(num_sims=24, max_depth=48, parallel_sims=2), 14, 0.3, True, None),
        (MCTSConfig(num_sims=24, max_depth=48, parallel_sims=4), 8, 0.0, True, None),
        (MCTSConfig(num_sims=24, max_depth=48, parallel_sims=4), 12, 0.3, True, None),
        (MCTSConfig(num_sims=27, max_depth=48, parallel_sims=9), 6, 0.0, True, None),
        (MCTSConfig(num_sims=27, max_depth=48, parallel_sims=9), 16, 0.3, True, None),
        (MCTSConfig(num_sims=16, max_depth=3, cpuct=2.5, parallel_sims=4), 6, 0.3, True, None),
        (MCTSConfig(num_sims=24, max_depth=48, max_nodes=10, parallel_sims=4), 20, 0.3, True, None),
        (MCTSConfig(num_sims=18, max_depth=48, parallel_sims=9), 36, 0.3, False, None),
        (MCTSConfig(num_sims=16, max_depth=48, dirichlet_alpha=0.7, parallel_sims=4), 4, 0.3, True, 0.7),
    ],
    ids=["K2", "K2_uval0.3", "K4", "K4_uval0.3", "K9", "K9_uval0.3", "K4_max_depth3",
         "K4_max_nodes10", "K9_terminal_roots", "K4_dirichlet"],
)
def test_emulated_fused_rounds_bit_equal_plain(emulated, cfg, moves, value, freeze, dirichlet):
    """Whole K>1 uniform fused searches (40 games) through the emulated
    ``az_fused_rounds``: counts and root W bit-equal to
    ``fused_rounds_search`` in one launch, at K = 2, 4 and 9, with the value
    0 (integer W) and 0.3 (where the order of the round's W additions shows
    in the bits), a depth cutoff, slots running out inside a round, finished
    roots and Dirichlet roots; the simulations are conserved."""
    boards = torch_state(random_boards(40, moves, seed=moves, freeze_done=freeze))
    noise = None
    if dirichlet is not None:
        noise = sample_draws(torch.Generator().manual_seed(5), 40, 7, dirichlet, "cpu").dirichlet
    calls = {"fused_rounds": 0}
    counts = make_fused_root_fn(
        TG, make_uniform_model(TG, value).apply_fn, cfg, kernel=_checked_fused_rounds(emulated, calls)
    )(boards, noise)
    assert calls == {"fused_rounds": 1}
    live = ~TG.terminal(boards)[0]
    assert live.any() and (freeze or (~live).any())
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()


def _search_both(lib, boards, priors, cfg, uval):
    """The emulated kernel (``az_fused`` at K=1, else ``az_fused_rounds``)
    and its plain version on flat boards f32[B, 42] and masked root priors
    f32[B, 7], on scratch filled with NaN (a read of a cell the search
    never wrote shows): counts and root W bit-equal. Returns the counts."""
    B, K, C = boards.shape[0], cfg.parallel_sims, cfg.nodes
    tree = torch.full((B, C, 32), float("nan"))
    counts, rootw = torch.empty(B, 7), torch.empty(B, 7)
    if K == 1:
        rc = lib.lib.az_fused(
            *(t.data_ptr() for t in (boards, priors, tree, counts, rootw)),
            B, C, cfg.num_sims, cfg.max_depth, cfg.cpuct, uval, None,
        )
        ref_counts, ref_w = fused_search(boards, priors, cfg, uval)
    else:
        rnd = torch.full((B, C, 16), float("nan"))
        rc = lib.lib.az_fused_rounds(
            *(t.data_ptr() for t in (boards, priors, tree, rnd, counts, rootw)),
            B, C, K, cfg.num_sims, cfg.max_depth, cfg.cpuct, uval, None,
        )
        ref_counts, ref_w = fused_rounds_search(boards, priors, cfg, uval)
    assert rc == 0
    assert torch.equal(bits(counts), bits(ref_counts)), "counts"
    assert torch.equal(bits(rootw), bits(ref_w)), "root W"
    return counts


def _uniform_prior(valid: torch.Tensor) -> torch.Tensor:
    return valid.float() / valid.sum(dim=1, keepdim=True).clamp(min=1)


def _lane_case(case: str, K: int):
    """``(state, masked root priors f32[B, 7], cfg, uval)`` of a named case."""
    rng = np.random.default_rng(K)
    sims = 27 if K == 9 else 24
    cfg = MCTSConfig(num_sims=sims, max_depth=48, parallel_sims=K)
    uval = 0.0
    state = torch_state(random_boards(40, 10, seed=K))
    valid = TG.valid_moves(state)
    prior = _uniform_prior(valid)
    if case == "ties":
        # dyadic priors from three values: equal scores on several lanes, the
        # first maximum often not lane 0
        prior = torch.as_tensor(rng.choice([0.0625, 0.125, 0.25], (40, 7)), dtype=torch.float32)
        best = torch.where(valid, prior, -1.0)
        top = best == best.amax(dim=1, keepdim=True)
        assert ((top.sum(dim=1) > 1) & ~top[:, 0]).any()
    elif case == "one_legal_edge":
        # one legal root edge: the root's top-2 has no runner-up
        pick = torch.as_tensor([rng.choice(np.flatnonzero(v)) for v in valid.numpy()])
        valid = torch.nn.functional.one_hot(pick, 7).bool() & valid
        prior = valid.float()
    elif case == "ragged_warps":
        # 37 games (not a multiple of a block's 16): positions 0-30 moves
        # deep, a drawn full board and played-on wins (done roots)
        parts = [random_boards(8, m, seed=m, freeze_done=False) for m in (0, 6, 14, 22)]
        boards = np.concatenate([*parts, DRAW_BOARD[None], random_boards(4, 36, seed=3,
                                                                          freeze_done=False)])
        state = torch_state(boards)
        valid = TG.valid_moves(state)
        prior = _uniform_prior(valid)
        assert TG.terminal(state)[0].sum() >= 2 and state.shape[0] == 37
    elif case == "max_nodes":
        # the tree has 1 slot at K=1 (the root: no install ever), 3 at K=9
        # (the slots run out inside the first round)
        cfg = MCTSConfig(num_sims=sims, max_depth=48, max_nodes=1 if K == 1 else 3,
                         parallel_sims=K)
    elif case == "uval0.3":
        uval = 0.3   # W not an integer: the order of the backup's adds shows
    return state, torch.where(valid, prior, INVALID_P), cfg, uval


LANE_CASES = [("ties", 1), ("ties", 4), ("one_legal_edge", 1), ("one_legal_edge", 4),
              ("ragged_warps", 1), ("ragged_warps", 9), ("max_nodes", 1), ("max_nodes", 9),
              ("uval0.3", 1), ("uval0.3", 9)]


@pytest.mark.parametrize("case,K", LANE_CASES, ids=[f"{c}_K{k}" for c, k in LANE_CASES])
def test_emulated_lane_cases(emulated, case, K):
    """The group layout's own cases through the emulated kernel, bit-equal
    to the plain version; the simulations are conserved, done roots get
    none, and a one-edge root gives them all to its edge."""
    state, priors, cfg, uval = _lane_case(case, K)
    boards = FlatOps().from_state(state).contiguous()
    counts = _search_both(emulated, boards, priors, cfg, uval)
    live = ~TG.terminal(state)[0]
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()
    if case == "one_legal_edge":
        assert (counts[live] == (priors[live] > 0).float() * cfg.num_sims).all()
