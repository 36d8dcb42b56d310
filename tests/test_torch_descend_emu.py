"""The hybrid descends, ``az_descend[_othello|_gomoku|_hex]`` and their
round forms ``az_descend_round*`` (alphazero_tpu_torch/csrc/hybrid.cu:
one warp walks one game; the board row comes in by ballots over coalesced
loads and goes out lane-strided), compiled with g++ against the CPU
stand-in for the CUDA built-ins (tests/cuda_emu/; the ``emulated`` fixture
of tests/torch_parity.py) and run on host memory. On synthetic trees the
leaf boards, path records and leaf meta (``dup`` included) must be
bit-equal to the plain ``hybrid.descend`` and ``hybrid.descend_round``:
batches that leave a block's last warps without a game, terminal roots,
paths cut at ``max_depth`` and terminal children, stones on the board's
32-cell ballot chunks and 64-bit word boundaries, rounds of K = 2, 4 and
16 descents with duplicates and nodes without a runner-up, trees of 3 and
101 nodes. Whole searches through these kernels are
tests/test_torch_kernels.py's.

This checks the kernels' LOGIC on the CPU; whether the source builds with
nvcc and runs on the card is chip_smoke.py's job.
"""

import numpy as np
import pytest
import torch

from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.games import ConnectFour, Gomoku, Hex, Othello
from alphazero_tpu_torch.mcts import hybrid
from tests.torch_parity import (  # noqa: F401  (emulated: a fixture)
    descend_round_through_kernel,
    descend_through_kernel,
    emulated,
    random_play_boards,
    torch_state,
)

GAMES = [ConnectFour(), Othello(), Gomoku(9), Hex()]
GAME_IDS = ["c4", "othello", "gomoku9", "hex"]


def _checked_descend(lib, calls):
    """A ``hybrid.descend`` stand-in running the game's emulated descend
    instance, held bit-equal to the plain version on every call;
    ``calls`` counts the launches by entry."""

    def descend(besta, bestc, done, tval, boards, max_depth, ops):
        outs, entry = descend_through_kernel(lib, besta, bestc, done, tval, boards, max_depth, ops)
        calls[entry] = calls.get(entry, 0) + 1
        return outs

    return descend


def _tree(game, B: int, C: int, seed: int, live: float = 0.6, done_every: int = 0):
    """Synthetic planes of B games with C nodes, as f32 tensors ``(besta,
    bestc, seca, secc, done, tval, boards)``: a node's best edge leads to
    a child slot further down with probability ``live`` (so every path
    ends), else to an unexpanded edge or a terminal child at any slot; a
    runner-up (another action, its own code) at 70% of the nodes, -1 at
    the rest; the root of every ``done_every``-th game terminal; tval in
    {-1, -0.5, 0, 0.5, 1}; random-play root boards."""
    rng = np.random.default_rng(seed)
    A = game.num_actions

    def codes():
        c = np.arange(C)[None, :]
        child = c + 1 + np.floor(rng.random((B, C)) * (C - 1 - c)).astype(np.int64)
        r = rng.random((B, C))
        out = np.where(r < 0.5 * (1 + live), -2.0 - rng.integers(0, C, (B, C)), -1.0)
        return np.where((r < live) & (c < C - 1), child, out)

    besta = rng.integers(0, A, (B, C))
    seca = np.where(rng.random((B, C)) < 0.7, (besta + rng.integers(1, A, (B, C))) % A, -1)
    done = np.zeros((B, C))
    if done_every:
        done[::done_every, 0] = 1.0
    tval = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], (B, C))
    ops = game.flat_ops()
    boards = ops.from_state(torch_state(random_play_boards(game, B, ops.size // 4, seed=seed,
                                                           freeze_done=False)))
    planes = [torch.tensor(x, dtype=torch.float32) for x in
              (besta, codes(), seca, codes(), done, tval)]
    return (*planes, boards.contiguous())


def _both(lib, planes, max_depth: int, ops, K: int):
    """The K=1 descend and the round descend at K on ``planes``, each held
    bit-equal to its plain version: ``(K=1 outputs, round outputs)``."""
    besta, bestc, seca, secc, done, tval, boards = planes
    one, _ = descend_through_kernel(lib, besta, bestc, done, tval, boards, max_depth, ops)
    rounds, _ = descend_round_through_kernel(lib, *planes, max_depth, ops, K)
    return one, rounds


@pytest.mark.parametrize("game", [Gomoku(5), Gomoku(7), Gomoku(8), Gomoku(9), Gomoku(15), Gomoku(16),
                                  Gomoku(17), Gomoku(19), Gomoku(22), Gomoku(23), Gomoku(27), Hex()],
                         ids=["gomoku5", "gomoku7", "gomoku8", "gomoku9", "gomoku15", "gomoku16",
                              "gomoku17", "gomoku19", "gomoku22", "gomoku23", "gomoku27", "hex"])
def test_emulated_descend_steps_every_action(emulated, game):
    """The game's descend instance on synthetic best planes whose path takes
    EVERY action from each of two positions (occupied cells of both colours
    included, which a search never picks), then a second edge to another
    action: leaf boards and path records bit-equal to the plain descend,
    whose step is the flat ops'."""
    ops = game.flat_ops()
    A = L = ops.size
    boards = ops.from_state(torch_state(random_play_boards(game, 2, A // 3, seed=A, freeze_done=False)))
    B, C = 2 * A, 3
    roots = boards.repeat_interleave(A, dim=0)
    acts = torch.arange(A, dtype=torch.float32).repeat(2)
    besta = torch.stack([acts, (acts * 7 + 3) % A, torch.zeros(B)], dim=1)
    calls = {}
    descend = _checked_descend(emulated, calls)
    for second_edge in (False, True):          # one step; two steps (then unexpanded)
        bestc = torch.full((B, C), -1.0)
        if second_edge:
            bestc[:, 0] = 1.0
        bd, *_ = descend(besta, bestc, torch.zeros(B, C), torch.zeros(B, C), roots, 48, ops)
        want = ops.step(roots, acts[:, None])
        if second_edge:
            want = ops.step(want, besta[:, 1:2])
        assert torch.equal(bd, want + 0.0)
    assert calls == {kernels.descend_entry(ops): 2}
    occupied = roots[torch.arange(B), acts.long()]
    assert (occupied == 1).any() and (occupied == -1).any()


@pytest.mark.parametrize("B", [1, 3, 37])
@pytest.mark.parametrize("game", GAMES, ids=GAME_IDS)
def test_emulated_descend_ragged_batches_and_terminal_roots(emulated, game, B):
    """Batches that fill no block (1 and 3 games of a block's 4) or leave
    its last warps idle (37), C=101, every third root terminal: the K=1
    and K=4 descends bit-equal to plain, and a terminal root takes no step
    (its patha/psgn rows 0, its board as given, meta (0, 0, 1, 0, 0, 0, 0,
    0))."""
    ops = game.flat_ops()
    planes = _tree(game, B, 101, seed=B, done_every=3)
    one, rounds = _both(emulated, planes, 48, ops, 4)
    dead = planes[4][:, 0] > 0.5
    assert dead.any() and (B == 1 or not dead.all())
    idle = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    for bd, patha, psgn, meta in (one, *zip(*rounds)):
        assert (patha[~dead] > 0).any(dim=1).all()
        assert not patha[dead].any() and not psgn[dead].any()
        assert torch.equal(bd[dead], planes[6][dead] + 0.0)
        assert torch.equal(meta[dead], idle.expand(int(dead.sum()), 8))


@pytest.mark.parametrize("max_depth", [1, 2, 3])
@pytest.mark.parametrize("game", GAMES, ids=GAME_IDS)
def test_emulated_descend_cutoffs_and_terminal_children(emulated, game, max_depth):
    """Paths cut at ``max_depth`` (cut leaves take the child's tval) and
    terminal children, at depth 1 among them (the first edge's child is
    terminal in every second game: meta's v_term is tval at its slot):
    the K=1 and K=4 descends bit-equal to plain."""
    ops = game.flat_ops()
    B, C = 24, 101
    planes = _tree(game, B, C, seed=10 * max_depth, live=0.9)
    bestc = planes[1]
    slot = torch.arange(B) % (C - 1) + 1
    bestc[::2, 0] = -2.0 - slot[::2]
    one, rounds = _both(emulated, planes, max_depth, ops, 4)
    meta = one[3]
    assert torch.equal(meta[::2, hybrid.M_TERM], torch.ones(B // 2))
    assert torch.equal(meta[::2, 3], planes[5][torch.arange(0, B, 2), slot[::2]])
    assert (meta[1::2, hybrid.M_CUT] > 0).any()
    assert (one[1] > 0).sum(dim=1).max() <= max_depth
    assert (rounds[3][..., hybrid.M_CUT] > 0).any()


# stones on both sides of ballot chunks and 64-bit words, and in the last cell
_GOMOKU_MARKS = {
    484: [31, 32, 63, 64, 255, 256, 447, 448],
    512: [31, 32, 63, 64, 255, 256, 447, 448],
    529: [31, 32, 63, 64, 447, 448, 511, 512],
    768: [31, 32, 511, 512, 575, 576, 703, 704],
}


@pytest.mark.parametrize("cells", [484, 512, 529, 768],
                         ids=["gomoku22", "cells512", "gomoku23", "cells768"])
def test_emulated_gomoku_descend_chunk_and_word_boundaries(emulated, cells):
    """The Gomoku instances' boards (8 words up to 512 cells, 12 above)
    with stones on both sides of the 32-cell ballot chunks and 64-bit words
    (cells 31/32, 63/64, 255/256, and 511/512, 575/576, 703/704 across the
    two instances) and in the last cells (483 of Gomoku 22's 484; 511, the
    8-word instance's last, and 767, the 12-word one's, through flat ops
    whose cell count is set to 512 and 768, the limits; 528 of Gomoku 23's
    529), and paths whose edges land on those cells: K=1 and K=4 bit-equal
    to plain, every marked cell reaching the leaf boards."""
    ops = Gomoku(22 if cells <= 512 else 23).flat_ops()
    if cells != ops.size:
        ops.size = ops.num_actions = cells    # the Gomoku step needs no geometry
    marks = _GOMOKU_MARKS[cells] + [cells - 1]
    B, C = 2 * len(marks), 5
    boards = torch.zeros(B, cells)
    for i, m in enumerate(marks):
        boards[i, marks] = torch.tensor([1.0, -1.0] * (len(marks) // 2) + [1.0])
        boards[i, m] = 0.0
        boards[len(marks) + i, m] = -1.0        # an occupied cell, overwritten by the step
    acts = torch.tensor(marks * 2, dtype=torch.float32)
    besta = torch.stack([acts, acts.roll(1), acts.roll(2), torch.zeros(B), torch.zeros(B)], dim=1)
    bestc = torch.tensor([1.0, 2.0, -1.0, -1.0, -1.0]).expand(B, C).contiguous()
    seca = torch.stack([acts.roll(3), acts.roll(4), acts.roll(5), torch.zeros(B), torch.zeros(B)], dim=1)
    secc = torch.tensor([3.0, -1.0, -1.0, -1.0, -1.0]).expand(B, C).contiguous()
    planes = (besta, bestc, seca, secc, torch.zeros(B, C), torch.zeros(B, C), boards)
    one, rounds = _both(emulated, planes, 48, ops, 4)
    for bd in (one[0], rounds[0][0]):       # descent 0 of the round walks the K=1 path
        assert (bd[:len(marks), marks] != 0).all()


@pytest.mark.parametrize("C", [3, 101])
@pytest.mark.parametrize("K", [2, 4, 16])
def test_emulated_round_descend_duplicates_and_lone_nodes(emulated, K, C):
    """Rounds of K descents on trees whose roots have unexpanded edges (a
    descent that expands through an option this round already took there
    is a duplicate, dup = 1) and nodes with no runner-up (seca = -1), C = 3
    and 101: bit-equal to plain (the in-round take counters of every
    node), with runner-up takes and duplicates occurring."""
    for game in (ConnectFour(), Gomoku(9)):
        ops = game.flat_ops()
        besta, bestc, seca, secc, *_ = planes = _tree(game, 9, C, seed=K * C, live=0.5)
        bestc[:6, 0] = -1.0                              # unexpanded best edges at the root
        seca[::3, 0] = (besta[::3, 0] + 1) % game.num_actions
        secc[::3, 0] = -1.0                              # ... and runner-ups
        seca[1::3, 0] = -1.0                             # roots without a runner-up
        _, (bd, patha, psgn, meta) = _both(emulated, planes, 48, ops, K)
        assert meta[..., hybrid.M_DUP].sum() > 0
        assert ((patha[:, 1::3, 0] - 1) == planes[0][1::3, 0]).all()
        assert ((patha - 1 == planes[2]) & (patha > 0)).any()
