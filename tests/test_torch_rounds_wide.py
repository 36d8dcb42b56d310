"""K>1 rounds past the limits the round kernels once had: the round merges at
K above the 16 records they stage at once (``az_merge_round``'s wide
instance, A <= 8, which reads the records where they lie, past what a
32-bit mask by descent could hold at K = 33 and 64;
``az_merge_round_dense``'s streamed one), and the round descend's 32-bit
counters in the global scratch the wrapper allocates (K above 255, where
byte counters would wrap, or more nodes than 4 games' byte counters fit in
shared memory), on every game. Compiled with g++ against tests/cuda_emu/
(``emulated``) and held bit-equal to the plain ``hybrid.merge_round`` and
``hybrid.descend_round``; a search at K = 32 is
tests/test_torch_gomoku28.py's.
"""

import pytest

from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.games import ConnectFour, Gomoku, Hex, Othello
from alphazero_tpu_torch.mcts import hybrid
from tests.test_torch_descend_emu import _tree
from tests.torch_parity import (  # noqa: F401  (emulated: a fixture)
    checked_round_kernels,
    descend_round_through_kernel,
    emulated,
    merge_case,
)


@pytest.mark.parametrize("case", ["duplicate", "ties_illegal"])
@pytest.mark.parametrize("A", [7, 65, 784])
@pytest.mark.parametrize("K", [17, 32, 33, 64])
def test_emulated_round_merges_past_16_records(emulated, K, A, case):
    """Both round merges at K = 17, 32, 33 and 64 (A = 7: the A <= 8 merge;
    65 and 784: the dense one's streamed instance) on synthetic planes and
    records (``merge_case``, C = K + 30: 17 installs, paths through 12
    nodes, so that many descents share an edge): planes, done/tval and the
    four top-2 planes bit-equal to the plain round merge's full refresh2."""
    args = merge_case(A, K, case, seed=K + A, C=K + 30)
    calls = {"past_capacity": 0}
    checked_round_kernels(emulated, calls).merge_round(*args)
    entry = "az_merge_round_dense" if A > hybrid.UNROLLED_MAX_A else "az_merge_round"
    assert calls[entry] == 1
    patha = args[7]
    on = patha > 0
    pairs = (patha[:, None] == patha[None]) & on[:, None] & on[None]   # [K, K, B, C]
    assert pairs.sum() > on.sum()   # edges that several descents back up
    assert args[9][..., hybrid.M2_EXPOK].sum() > 0


def _wide_counters(lib, game, K: int, C: int, seed: int) -> None:
    """A round of K descents of ``game`` on a synthetic tree (``_tree``) of 2
    games with C nodes, bit-equal to the plain version. Game 0's root has no
    runner-up, so all K descents take its best edge, unexpanded: every one
    after the first is a duplicate (at K = 300 the take count passes 256,
    where a byte would wrap to "not taken"); game 1's root alternates
    between its best edge and its runner-up."""
    B = 2
    besta, bestc, seca, secc, *_ = planes = _tree(game, B, C, seed=seed, live=0.5)
    bestc[:, 0] = -1.0                  # unexpanded best edges at the roots ...
    seca[:, 0] = (besta[:, 0] + 1) % game.num_actions
    secc[:, 0] = -1.0                   # ... and game 1's runner-up
    seca[0, 0] = -1.0
    scratch = lib.lib.az_descend_round_scratch(B, C, K)
    wide = K > 255 or C > kernels.ROUND_MAX_NODES
    assert scratch == (2 * B * C if wide else 0)
    (bd, patha, psgn, meta), _ = descend_round_through_kernel(lib, *planes, 48, game.flat_ops(),
                                                              K)
    assert (meta[1:, 0, hybrid.M_DUP] == 1).all() and meta[0, 0, hybrid.M_DUP] == 0
    assert ((patha[:, 1, 0] - 1 == planes[2][1, 0]).sum() == K // 2)   # the runner-up, every second
    assert ((patha[:, :, 0] > 0).sum(dim=0) == K).all()   # every descent takes a root edge


@pytest.mark.parametrize("K,C", [(256, 3), (300, 101), (300, 7264), (4, 29057)])
def test_emulated_round_descend_wide_counters(emulated, K, C):
    """The round descend's 32-bit counters in the global scratch the
    wrapper allocates, on Connect-Four: K = 256 and 300 descents (past the
    byte counters' 255) at C = 3 to 7264 nodes, and C = 29057 (one node
    past the byte counters' shared memory) at K = 4 (``_wide_counters``)."""
    _wide_counters(emulated, ConnectFour(), K, C, seed=K + C)


@pytest.mark.parametrize("K,C", [(300, 101), (4, 29057)], ids=["K300", "C29057"])
@pytest.mark.parametrize("game", [Othello(), Hex(), Gomoku(9), Gomoku(27), Gomoku(28), Gomoku(65)],
                         ids=["othello", "hex", "gomoku9", "gomoku27", "gomoku28", "gomoku65"])
def test_emulated_round_descend_wide_counters_every_game(emulated, game, K, C):
    """The 32-bit-counter round descend of every other game's instance
    (Othello, Hex, Gomoku's 8-word, 12-word and leaf-row boards) at K = 300
    and at C = 29057, as ``test_emulated_round_descend_wide_counters``."""
    _wide_counters(emulated, game, K, C, seed=K + C + game.num_actions)
