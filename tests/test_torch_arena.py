"""The port's arena (``alphazero_tpu_torch.arena``) against the JAX
``make_arena_fn`` on the CPU.

The JAX arena draws each move's tie uniforms from its key chain
(``rng, k_tie = split(rng)``, then ``uniform(k_tie, [B, A])`` inside
``action_probs``); the tests replay those uniforms into the port's
``play``. The JAX arena runs its XLA engine on the CPU (the K=2 case runs
its Pallas engines in the interpreter), the port its kernels' plain
versions; the engines' root counts agree exactly (docs/ENGINES.md), so the
results must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.arena import make_arena_fn as jax_make_arena_fn
from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu.models.nets import MLPNet as JaxMLPNet
from alphazero_tpu_torch.arena import (
    ArenaResult,
    combined_apply,
    gate,
    make_arena_fn,
    tie_draws_from,
)
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.games.connect_four import ROWS, _has_win
from alphazero_tpu_torch.models import convert_mlp, make_uniform_model, order_free_mlp_variables
from test_arena import oracle_apply as jax_oracle_apply

G = ConnectFour()
JG = JaxConnectFour()
A = G.num_actions


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU searches gain nothing from torch's intra-op threads,
    which would only spin beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Oracle:
    """The rule-based prior of ``tests/test_arena.py``'s ``oracle_apply``
    in torch: win now > block the opponent's win > centre columns."""

    def __init__(self):
        def apply_fn(feats):
            board = (feats[..., 0] - feats[..., 1]).to(torch.int8)
            heights = board.abs().sum(dim=1)
            rows = torch.arange(board.shape[0])
            logits = []
            for col in range(A):
                row = heights[:, col].clamp(max=ROWS - 1)
                open_col = heights[:, col] < ROWS
                score = []
                for player in (1, -1):
                    nb = board.clone()
                    nb[rows, row, col] = player
                    score.append(_has_win(nb, player) & open_col)
                logits.append(score[0].float() * 100.0 + score[1].float() * 50.0
                              - float(abs(col - 3)))
            return torch.stack(logits, dim=1) * 10.0, torch.zeros(feats.shape[0])

        apply_fn.needs_features = True
        self.apply_fn = apply_fn


def jax_ties(seed: int, batch: int, moves: int = G.max_moves) -> list:
    """The JAX arena's tie uniforms of each move, as torch tensors."""
    key = jax.random.key(seed)
    out = []
    for _ in range(moves):
        key, k_tie = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.uniform(k_tie, (batch, A)))))
    return out


def both(jax_cand, jax_inc, port_cand, port_inc, num_games, seed, block_size=None,
         jax_params=({}, {}), **cfg):
    """``(JAX ArenaResult as ints, port ArenaResult)`` of one arena."""
    inc_cfg = cfg.pop("inc", None)
    jcfg = JaxMCTSConfig(**cfg)
    jinc = None if inc_cfg is None else JaxMCTSConfig(**{**cfg, **inc_cfg})
    play = jax.jit(jax_make_arena_fn(JG, jax_cand, jax_inc, jcfg, num_games,
                                     block_size=block_size, mcts_cfg_inc=jinc))
    jr = play(*jax_params, jax.random.key(seed))
    want = ArenaResult(*(int(x) for x in jr))
    pcfg = MCTSConfig(**cfg)
    pinc = None if inc_cfg is None else MCTSConfig(**{**cfg, **inc_cfg})
    ties = jax_ties(seed, num_games)
    got = make_arena_fn(G, pcfg, num_games, mcts_cfg_inc=pinc, device="cpu")(
        port_cand, port_inc, lambda t: ties[t])
    return want, got


@pytest.mark.parametrize(
    "result, threshold, accept",
    [
        (ArenaResult(3, 1, 0, 0), 0.6, True),
        (ArenaResult(3, 2, 5, 0), 0.6, True),     # 3/5 meets the threshold exactly
        (ArenaResult(2, 2, 0, 0), 0.6, False),
        (ArenaResult(0, 0, 8, 0), 0.6, False),    # no decisive game keeps the incumbent
        (ArenaResult(0, 4, 0, 0), None, True),    # continuous mode always adopts
        (ArenaResult(0, 0, 0, 4), None, True),
    ],
)
def test_gate_truth_table(result, threshold, accept):
    assert gate(result, threshold) is accept


def test_uniform_vs_uniform_equals_jax():
    ju = jax_uniform(JG).apply_fn
    uni = make_uniform_model(G)
    want, got = both(ju, ju, uni, uni, 16, seed=3, num_sims=4, max_depth=16)
    assert got == want
    assert sum(got) == 16 and got.unfinished == 0


def test_oracle_vs_uniform_combined_forward_equals_jax():
    """One sim: play is prior-driven; the oracle's seats go through the
    hybrid engine on the combined forward, and it sweeps both seatings."""
    want, got = both(jax_oracle_apply, jax_uniform(JG).apply_fn, Oracle(), make_uniform_model(G),
                     16, seed=0, num_sims=1, max_depth=16)
    assert got == want
    assert got.cand_wins == 16


def test_order_free_mlp_vs_uniform_fused_both_sides_equals_jax():
    """An MLPNet with dyadic weights (exact partial sums) against uniform:
    each side a fused call in the port, the XLA engine in JAX."""
    hidden = (32,)
    variables = order_free_mlp_variables(A, hidden, seed=1)
    jnet = JaxMLPNet(num_actions=A, hidden=hidden)
    jparams = jax.tree_util.tree_map(jnp.asarray, variables)
    want, got = both(lambda p, f: jnet.apply(p, f), jax_uniform(JG).apply_fn,
                     convert_mlp(variables), make_uniform_model(G), 8, seed=5,
                     jax_params=(jparams, {}), num_sims=8, max_depth=16)
    assert got == want
    assert sum(got) == 8


def test_asymmetric_budgets_equal_jax():
    """Uniform at 8 sims against uniform at 64 (the ladder's rung arena):
    each side searches the whole batch at its own budget."""
    ju = jax_uniform(JG).apply_fn
    uni = make_uniform_model(G)
    want, got = both(ju, ju, uni, uni, 8, seed=2, num_sims=8, max_depth=16,
                     inc={"num_sims": 64})
    assert got == want


def test_combined_forward_at_k2_equals_jax():
    """parallel_sims=2: the combined forward's selector is tiled over the
    K-major leaf batch. The JAX arena runs its Pallas engines in the
    interpreter (its XLA engine has no rounds)."""
    want, got = both(jax_oracle_apply, jax_uniform(JG).apply_fn, Oracle(), make_uniform_model(G),
                     8, seed=3, block_size=8, num_sims=4, max_depth=16, parallel_sims=2)
    assert got == want


def test_combined_apply_selects_rows_per_game():
    ctm = torch.tensor([True, False, True])
    ones = lambda f: (torch.ones(f.shape[0], A), torch.ones(f.shape[0]))   # noqa: E731
    zeros = lambda f: (torch.zeros(f.shape[0], A), torch.zeros(f.shape[0]))   # noqa: E731
    logits, value = combined_apply(ones, zeros, ctm)(torch.zeros(6, 6, 7, 2))
    assert value.tolist() == [1, 0, 1, 1, 0, 1]   # K=2 rounds stack K-major
    assert logits[:, 0].tolist() == value.tolist()


@pytest.mark.parametrize("flag, item", [("gumbel", "asymmetric per-side budgets"),
                                        ("transposition", "asymmetric per-side budgets")])
def test_unported_engines_raise(flag, item):
    """Gumbel arenas (tests/test_torch_gumbel_selfplay.py) and transposition
    arenas (tests/test_torch_tt_routes.py holds them against JAX) are
    ported; what they refuse is the JAX arena's asymmetric budgets, in its
    words. A symmetric transposition arena plays every game."""
    with pytest.raises(ValueError, match=item):
        make_arena_fn(G, MCTSConfig(**{flag: True}), 4, device="cpu",
                      mcts_cfg_inc=MCTSConfig(**{flag: True}, num_sims=8))
    if flag == "transposition":
        play = make_arena_fn(G, MCTSConfig(num_sims=6, max_depth=16, transposition=True), 4,
                             device="cpu")
        uni = make_uniform_model(G)
        r = play(uni, uni, tie_draws_from(torch.Generator().manual_seed(0), 4, A, "cpu"))
        assert r.cand_wins + r.inc_wins + r.draws + r.unfinished == 4


def test_mesh_raises():
    """The arena takes a ``parallel.Mesh`` (tests/test_torch_parallel.py
    plays one over two ranks); anything else, and a game count that does
    not divide over the ranks, raise when the arena is built."""
    from alphazero_tpu_torch.parallel import Mesh

    with pytest.raises(TypeError, match="parallel.Mesh"):
        make_arena_fn(G, MCTSConfig(), 4, device="cpu", mesh=object())
    two = Mesh(None, 0, 2, {"data": 2, "model": 1}, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="arena's games of 7 does not divide over the mesh's 2"):
        make_arena_fn(G, MCTSConfig(), 7, device="cpu", mesh=two)
