"""The seeds of a fresh search, ``az_refresh``/``az_refresh2`` (A <= 8) and
``az_refresh_dense``/``az_refresh2_dense`` (alphazero_tpu_torch/csrc/hybrid.cu
``seed_dense_kernel``), compiled with g++ against the CPU stand-in of
tests/cuda_emu/ (tests/torch_parity.py ``emulated``) and held bit for bit
against the plain ``refresh`` / ``refresh2`` on fresh planes
(``hybrid._init_planes``: the roots' priors at node 0, the empty node
everywhere else), the planes a search seeds them with and their
precondition. One warp a game reads only the roots' priors, lane l the
actions l, l + 32, ... (J = 1 at A <= 8, 4, 8, 16 or 24 of them above),
and writes every other node's rows as the empty node's constant: so the
cases cover each J (A = 1 to 729: Connect-Four's 7 and synthetic fresh planes at
A = 1, 2 and 8, the unrolled refresh's ends), one node (C = 1: no empty
node), two and a search's 101, a partial block (B = 5 and 9 games at four a
block), and the roots' own scenarios: Dirichlet-noised priors, the uniform
prior's exact ties, priors that differ but whose scores round equal (the
first-max must take the smaller action), illegal and all-illegal roots,
and terminal roots. Also, without the emulator, the fact the design rests
on: the plain refreshes of any fresh planes give every node but the root
the constant rows, (0, -1, -1, -1) at A = 1, which has no runner-up.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from alphazero_tpu_torch.config import PUCT_EPS, MCTSConfig
from alphazero_tpu_torch.games import ConnectFour, Gomoku, Hex, Othello
from alphazero_tpu_torch.mcts import hybrid
from alphazero_tpu_torch.mcts.tree import INVALID_P
from alphazero_tpu_torch.models import make_uniform_model
from alphazero_tpu_torch.ops import root_prior
from tests.torch_parity import (  # noqa: F401  (emulated: a fixture)
    bits,
    emulated,
    emulated_refresh,
    emulated_refresh2,
    fresh_planes,
    random_play_boards,
    seed_priors,
    torch_state,
)

# a game of each A: every J of the kernel (A <= 8, 128, 256, 512, 768)
GAMES = {7: ConnectFour(), 9: Gomoku(3, 3), 49: Hex(), 65: Othello(), 81: Gomoku(9),
         225: Gomoku(15), 361: Gomoku(19), 484: Gomoku(22), 529: Gomoku(23), 729: Gomoku(27)}
SHAPES = ((5, 1), (9, 2), (5, 101), (9, 101))   # (B, C): partial blocks, no / one / 100 empty nodes
CPUCT = 1.25
KINDS = ("dirichlet", "ties", "round_equal", "terminal")


def _scores(p: torch.Tensor, cpuct: float) -> torch.Tensor:
    """The plain refresh's PUCT scores of priors f32[..., A] at a fresh
    root (n = w = 0), in its arithmetic (``hybrid._score_plane``)."""
    flat = p.reshape(1, -1, 1)
    zeros = torch.zeros_like(flat)
    sq = torch.sqrt(zeros.sum(dim=1) + PUCT_EPS)
    return hybrid._score_plane(zeros, zeros, flat, cpuct, sq).reshape(p.shape)


@lru_cache(maxsize=None)
def _round_equal_pairs(cpuct: float) -> torch.Tensor:
    """Pairs of adjacent f32 priors ``(lo, hi)``, lo < hi, whose scores at
    a fresh root round to the same f32, as f32[N, 2]."""
    lo = torch.linspace(0.2, 0.25, 4001)
    hi = torch.nextafter(lo, torch.tensor(1.0))
    same = _scores(lo, cpuct) == _scores(hi, cpuct)
    assert same.sum() > 100
    return torch.stack([lo[same], hi[same]], dim=1)


@lru_cache(maxsize=None)
def _case(A: int, kind: str) -> tuple:
    """``(roots, p_masked f32[9, A])`` of ``kind``: the uniform model's
    root prior of random-play roots (with an injected Dirichlet(0.3)
    sample for "dirichlet"; played to the end and past it for
    "terminal"), or for "round_equal" legal edges a1 < a2 of different
    lanes where A allows whose priors differ by one ulp but score alike,
    the other legal edges below them."""
    game = GAMES[A]
    B = 9
    full = 40 if A == 7 else A - 2   # all but two cells: Connect-Four has 42
    moves = full if kind == "terminal" else A // 3
    state = torch_state(random_play_boards(game, B, moves, seed=A, freeze_done=kind != "terminal"))
    rng = np.random.default_rng(A + len(kind))
    alpha = 0.3 if kind == "dirichlet" else None
    noise = None if alpha is None else torch.as_tensor(
        rng.dirichlet(np.full(A, alpha), B).astype(np.float32))
    cfg = MCTSConfig(num_sims=2, dirichlet_alpha=alpha)
    prior, valid = root_prior(game, make_uniform_model(game).apply_fn, cfg, state, noise)
    p_masked = torch.where(valid, prior, INVALID_P)
    if kind == "round_equal":
        pairs = _round_equal_pairs(CPUCT)
        for b in range(B):
            legal = valid[b].nonzero()[:, 0]
            a1 = int(legal[0])
            later = legal[legal >= a1 + 33] if A > a1 + 33 else legal[1:]
            a2 = int(later[0]) if len(later) else int(legal[-1])
            lo, hi = pairs[(b * 37) % len(pairs)]
            p_masked[b, legal] = lo / 2
            p_masked[b, a1], p_masked[b, a2] = lo, hi
    return state, p_masked


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("A", sorted(GAMES))
def test_emulated_seeds_bit_equal_plain_on_fresh_planes(emulated, A, kind):
    """Both dense seeds bit-equal to the plain full refreshes (outputs
    filled with NaN first) at every (B, C) of SHAPES, and what each case
    is for happens: ties among legal edges, equal scores of different
    priors taken by the smaller action, terminal roots."""
    state, p_all = _case(A, kind)
    game = GAMES[A]
    if kind == "terminal":
        assert bool(game.terminal(state)[0].any())
    for B, C in SHAPES:
        p_masked = p_all[:B]
        planes = fresh_planes(game, p_masked, C, state[:B])
        (best_a, best_c), entry = emulated_refresh(emulated, *planes, CPUCT)
        best4, entry2 = emulated_refresh2(emulated, *planes, CPUCT)
        dense = "_dense" if A > hybrid.UNROLLED_MAX_A else ""
        assert (entry, entry2) == (f"az_refresh{dense}", f"az_refresh2{dense}")
        assert torch.equal(bits(best4[0]), bits(best_a)) and (best_c == -1).all()
        score = _scores(p_masked, CPUCT)
        top = score == score.amax(dim=1, keepdim=True)
        if kind in ("ties", "round_equal"):
            assert (top.sum(dim=1) >= 2).all()
        if kind == "round_equal":
            a1 = top.float().argmax(dim=1)
            a2 = A - 1 - top.flip(1).float().argmax(dim=1)
            rows = torch.arange(B)
            assert (p_masked[rows, a1] < p_masked[rows, a2]).all()
            assert torch.equal(best_a[:, 0], a1.float()) and torch.equal(best4[2][:, 0], a2.float())


def _synthetic_fresh_planes(p_masked: torch.Tensor, C: int) -> tuple:
    """Fresh planes of ``_init_planes``' form for an action count no game
    has: ``n = w = 0``, the priors f32[B, A] at node 0, ``p = 0`` elsewhere,
    ``code = -1``."""
    B, A = p_masked.shape
    p = torch.zeros(B, A, C)
    p[:, :, 0] = p_masked
    return torch.zeros(B, A, C), torch.zeros(B, A, C), p, torch.full((B, A, C), -1.0)


def _small_priors(A: int) -> torch.Tensor:
    """Masked root priors f32[9, A]: ``seed_priors``' scenarios (uniform
    ties with edge 0 illegal, all illegal, one legal edge, Dirichlet
    mixes), or at A = 1 a legal prior, an illegal one, a legal prior of 0
    and random ones."""
    if A > 1:
        return seed_priors(A, 9, seed=A)
    p = torch.as_tensor(np.random.default_rng(1).random((9, 1)).astype(np.float32))
    p[:3, 0] = torch.tensor([1.0, INVALID_P, 0.0])
    return p


@pytest.mark.parametrize("A", [1, 2, 8])
def test_emulated_small_seeds_bit_equal_plain_on_synthetic_fresh_planes(emulated, A):
    """The A <= 8 seeds at the unrolled refresh's ends (A = 1, where
    neither the root nor the empty node has a runner-up; A = 2; A = 8, a
    lane for each of 8 actions) on synthetic fresh planes at every (B, C)
    of SHAPES: bit-equal to the plain full refreshes (outputs filled with
    NaN first), the all-illegal root's best action 0 and the empty node's
    rows (0, -1, 1, -1), (0, -1, -1, -1) at A = 1."""
    p_all = _small_priors(A)
    for B, C in SHAPES:
        planes = _synthetic_fresh_planes(p_all[:B], C)
        (best_a, best_c), entry = emulated_refresh(emulated, *planes, CPUCT)
        best4, entry2 = emulated_refresh2(emulated, *planes, CPUCT)
        assert (entry, entry2) == ("az_refresh", "az_refresh2")
        assert torch.equal(bits(best4[0]), bits(best_a)) and (best_c == -1).all()
        assert best_a[1, 0] == 0 and best4[2][1, 0] == -1          # all illegal
        assert (best4[2][:, 1:] == (1.0 if A > 1 else -1.0)).all()
        assert (best4[3] == -1).all()
        if A == 1:
            assert (best_a == 0).all() and (best4[2] == -1).all()
        else:
            assert best_a[2, 0] == A - 1 and best4[2][2, 0] == -1    # one legal edge, the last


@pytest.mark.parametrize("A", [784, 1024, 2025])
def test_emulated_streamed_seeds_keep_the_first_of_ties_across_chunks(emulated, A):
    """The seeds' streamed instance (A > 768: the root's priors in chunks
    of 256 actions, 8 a lane) at Gomoku 28's, 32's and 45's A, on fresh
    planes whose roots tie across the chunks: game 0 at actions 40, 552,
    1064 and 1576 (one lane, two chunks apart; the first best, the second
    runner-up), game 1 at 511 and 512 (chunk 1's last lane, chunk 2's
    first), game 2 with its first two chunks illegal and a tie at 520 and 1032
    (at A = 784 its best, 520, alone: the runner-up 512), game 3 the last
    action alone legal; the others ``seed_priors``' mix. Both seeds
    bit-equal to the plain refresh and refresh2."""
    B, C = 6, 9
    game = {784: Gomoku(28), 1024: Gomoku(32), 2025: Gomoku(45)}[A]
    p_masked = seed_priors(A, B, seed=A)
    p_masked[:4] = 1.0 / A
    ties = {0: [40, 552, 1064, 1576], 1: [511, 512], 2: [520, 1032]}
    for b, tied in ties.items():
        p_masked[b, [a for a in tied if a < A]] = 2.0 / A
    p_masked[2, :512] = INVALID_P
    p_masked[3, :A - 1] = INVALID_P
    planes = fresh_planes(game, p_masked, C)
    (best_a, _), entry = emulated_refresh(emulated, *planes, CPUCT)
    (best_a2, _, sec_a, _), entry2 = emulated_refresh2(emulated, *planes, CPUCT)
    assert (entry, entry2) == ("az_refresh_dense", "az_refresh2_dense")
    assert torch.equal(best_a, best_a2)
    assert best_a[:4, 0].tolist() == [40, 511, 520, A - 1]
    assert sec_a[:4, 0].tolist() == [552, 512, 1032 if A > 1032 else 512, -1]


def _seed_at(lib, entry: str, A: int, B: int = 4, C: int = 5):
    """``entry`` on fresh planes of A actions (``seed_priors`` at the root,
    the empty node elsewhere), its outputs filled with 7 first: ``(rc,
    outputs, the plain refresh's)``."""
    p = torch.zeros(B, max(A, 1), C)
    if A >= 2:
        p[:, :, 0] = seed_priors(A, B, seed=A)
    planes = [torch.zeros_like(p), torch.zeros_like(p), p, torch.full_like(p, -1.0)]
    top2 = entry.startswith("az_refresh2")
    best = [torch.full((B, C), 7.0) for _ in range(4 if top2 else 2)]
    rc = getattr(lib.lib, entry)(*(t.data_ptr() for t in (*planes, *best)), B, A, C, CPUCT, None)
    return rc, best, (hybrid.refresh2 if top2 else hybrid.refresh)(*planes, CPUCT) if A >= 2 else None


@pytest.mark.parametrize("entry", ["az_refresh_dense", "az_refresh2_dense"])
@pytest.mark.parametrize("A", [1, 769])
def test_emulated_seeds_refuse_outside_2_to_512_actions(emulated, entry, A):
    """The dense path takes A >= 2: at A = 1 the dense entries return an
    error and write nothing. Above the 24-actions-a-lane instance's 768,
    where they once refused, they stream the root's actions: at A = 769
    bit-equal to the plain refresh."""
    rc, best, want = _seed_at(emulated, entry, A)
    if A == 1:
        assert rc != 0
        assert all((t == 7.0).all() for t in best)
        return
    assert rc == 0
    assert all(torch.equal(bits(t), bits(u)) for t, u in zip(best, want))


@pytest.mark.parametrize("entry", ["az_refresh", "az_refresh2"])
@pytest.mark.parametrize("A", [0, 769])
def test_emulated_small_seeds_refuse_outside_1_to_512_actions(emulated, entry, A):
    """The A <= 8 entries take what they took before, A = 1 included: at
    A = 0 they return an error and write nothing. Above 768, where they once
    refused, they take the streamed instance: at A = 769 bit-equal to the
    plain refresh."""
    rc, best, want = _seed_at(emulated, entry, A)
    if A == 0:
        assert rc != 0
        assert all((t == 7.0).all() for t in best)
        return
    assert rc == 0
    assert all(torch.equal(bits(t), bits(u)) for t, u in zip(best, want))


@pytest.mark.parametrize("edge", range(3, 28))
def test_plain_refreshes_of_fresh_planes_are_constant_off_the_root(edge):
    """What the seeds rest on, for every A the games use (Gomoku 3-27,
    Hex, Othello, Connect-Four): on ``_init_planes``' planes every node
    but the root refreshes to (0, -1) and (0, -1, 1, -1), whatever the
    roots' priors, and the root's codes are -1."""
    games = [Gomoku(edge, min(edge, 5))]
    if edge == 7:
        games += [Hex(), ConnectFour()]   # Connect-Four: 7 columns, the unrolled A
    if edge == 8:
        games.append(Othello())
    for game in games:
        A = game.num_actions
        B, C = 4, 6
        rng = np.random.default_rng(edge)
        p_masked = torch.as_tensor(np.where(rng.random((B, A)) < 0.3, INVALID_P,
                                            rng.random((B, A))).astype(np.float32))
        p_masked[1] = INVALID_P
        planes = fresh_planes(game, p_masked, C)
        best_a, best_c = hybrid.refresh(*planes, CPUCT)
        top2 = hybrid.refresh2(*planes, CPUCT)
        assert torch.equal(top2[0], best_a) and torch.equal(top2[1], best_c)
        for got, want in zip(top2, (0.0, -1.0, 1.0, -1.0)):
            assert (got[:, 1:] == want).all()
        assert not torch.signbit(best_a[:, 1:]).any()   # +0, as the kernels write it
        assert (best_c[:, 0] == -1).all() and (top2[3][:, 0] == -1).all()
        assert best_a[1, 0] == 0 and top2[2][1, 0] == -1


def test_plain_refreshes_of_fresh_planes_at_one_action():
    """At A = 1, which no game has and the A <= 8 seeds take, the plain
    refreshes give every node the row (0, -1) and (0, -1, -1, -1): one edge
    has no runner-up, so the unrolled scan's sec_a and sec_code stay -1."""
    p_masked = _small_priors(1)[:4]
    planes = _synthetic_fresh_planes(p_masked, 6)
    best_a, best_c = hybrid.refresh(*planes, CPUCT)
    top2 = hybrid.refresh2(*planes, CPUCT)
    assert torch.equal(top2[0], best_a) and torch.equal(top2[1], best_c)
    for got, want in zip(top2, (0.0, -1.0, -1.0, -1.0)):
        assert (got == want).all()
    assert not torch.signbit(best_a).any()
