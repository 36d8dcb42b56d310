"""The port's dense engine (``alphazero_tpu_torch/mcts/search.py`` and
``tree.py``) against the JAX package's ``make_search_fn``: the same roots
and the same draws give identical decoded trees (N, W, P, child codes,
legality, terminal flags and values, counts and cursors) on Connect-Four
(uniform, order-free MLP, Dirichlet, capacity degradation, depth cutoffs,
terminal roots; Othello's trees, with the depth cutoffs backing up its
heuristic, are held against the same engine in tests/test_torch_othello.py,
whose compiled JAX programs they share); the frozen goldens and the C++
oracle; and root counts equal to the port's hybrid engine, the ladder's
rung above it."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu import native
from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.mcts.search import make_search_fn as jax_search_fn
from alphazero_tpu.mcts.tree import init_tree as jax_init_tree
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour, Othello
from alphazero_tpu_torch.mcts import Tree, hybrid, make_hybrid_root_fn, make_search_fn
from alphazero_tpu_torch.mcts.tree import init_tree
from alphazero_tpu_torch.models import convert_mlp, make_apply_fn, make_uniform_model
from alphazero_tpu_torch.models import order_free_mlp_variables
from alphazero_tpu_torch.ops import sample_draws
from tests.torch_parity import (
    DRAW_BOARD,
    boards_from_seqs,
    jax_state,
    random_boards,
    random_othello_boards,
    torch_state,
)

JG, TG = JaxConnectFour(), ConnectFour()
TO = Othello()
VIEWS = ("N", "W", "P", "child", "valid", "term", "tval", "count", "cursor")
MLP_HIDDEN = (32,)


def _roots():
    """Connect-Four roots at two depths, a drawn and a won board (terminal
    roots, which never search)."""
    return np.concatenate([random_boards(3, 4, seed=4), random_boards(3, 17, seed=5),
                           DRAW_BOARD[None], boards_from_seqs([[3, 0, 3, 0, 3, 0, 3]])])


def _assert_same_tree(jt, pt: Tree, what: str = "", ulps: bool = False):
    """Every decoded view bit-equal; with ``ulps`` (a prior or value that
    goes through exp, log or tanh, whose last bit XLA and torch may round
    apart on the same input) P and W within 1e-5 and the rest bit-equal."""
    for view in VIEWS:
        j = np.asarray(getattr(jt, view))
        p = getattr(pt, view).numpy()
        assert j.shape == p.shape, f"{what} {view}: {j.shape} != {p.shape}"
        if ulps and view in ("P", "W"):
            np.testing.assert_allclose(p, j, rtol=0, atol=1e-5, err_msg=f"{what} {view}")
        else:
            np.testing.assert_array_equal(j, p, err_msg=f"{what} {view}")


def _order_free():
    variables = order_free_mlp_variables(7, MLP_HIDDEN, seed=4)
    jnet = JaxMLPNet(num_actions=7, hidden=MLP_HIDDEN)
    jparams = jax.tree_util.tree_map(jnp.asarray, variables)
    return (lambda p, f: jnet.apply(p, f)), jparams, make_apply_fn(convert_mlp(variables))


@pytest.fixture(scope="module")
def c4_cases():
    """Each case's JAX search run once: ``name -> (cfg, boards, dirichlet,
    port apply_fn, JAX tree)``."""
    jax_mlp, jparams, port_mlp = _order_free()
    j_uni, p_uni = jax_uniform(JG).apply_fn, make_uniform_model(TG).apply_fn
    boards = _roots()
    cases = {
        "uniform": (dict(num_sims=50, max_depth=48), j_uni, {}, p_uni, None),
        "order_free_mlp": (dict(num_sims=50, max_depth=48), jax_mlp, jparams, port_mlp, None),
        "dirichlet": (dict(num_sims=50, max_depth=48, dirichlet_alpha=1.0), jax_mlp, jparams,
                      port_mlp, jax.random.key(3)),
        "capacity": (dict(num_sims=40, max_depth=48, max_nodes=17), j_uni, {}, p_uni, None),
        "max_depth3": (dict(num_sims=30, max_depth=3), jax_mlp, jparams, port_mlp, None),
    }
    out = {}
    for name, (kw, j_apply, params, p_apply, key) in cases.items():
        jcfg = JaxMCTSConfig(**kw)
        jt = jax.jit(jax_search_fn(JG, j_apply, jcfg))(params, jax_state(boards), key)
        dirichlet = None
        if key is not None:
            dirichlet = torch.as_tensor(np.array(
                jax.random.dirichlet(key, jnp.full((7,), kw["dirichlet_alpha"]), (len(boards),))))
        out[name] = (MCTSConfig(**kw), boards, dirichlet, p_apply, jt)
    return out


def test_init_tree_matches_jax():
    boards = _roots()
    jt = jax_init_tree(JG, jax_state(boards), 9)
    pt = init_tree(TG, torch_state(boards), 9)
    _assert_same_tree(jt, pt, "init")
    assert pt.term[:, 0].sum() >= 2 and pt.capacity == 9 and pt.num_actions == 7
    np.testing.assert_array_equal(
        pt.state[:, 0].reshape(-1, 6, 7).numpy(), boards)


@pytest.mark.parametrize("case", ["uniform", "order_free_mlp", "dirichlet", "capacity",
                                  "max_depth3"])
def test_search_matches_jax_connect_four(c4_cases, case):
    cfg, boards, dirichlet, apply_fn, jt = c4_cases[case]
    pt = make_search_fn(TG, apply_fn, cfg)(torch_state(boards), dirichlet)
    _assert_same_tree(jt, pt, case, ulps=case not in ("uniform", "capacity"))
    counts = pt.root_counts()
    live = ~TG.terminal(torch_state(boards))[0]
    assert (~live).sum() >= 2 and (counts[~live] == 0).all()     # terminal roots never search
    assert (counts.sum(1)[live] == cfg.num_sims).all()
    assert (pt.cursor == cfg.num_sims + 1).all()                 # every game, every simulation
    if case == "capacity":
        assert (pt.count <= cfg.nodes).all() and (pt.count == cfg.nodes).any()


@pytest.mark.parametrize("name,game", [("connect_four", TG), ("othello", TO)])
def test_frozen_goldens(name, game):
    with open(os.path.join(os.path.dirname(__file__), "golden_counts.json")) as f:
        spec = json.load(f)[name]
    states = []
    for seq in spec["seqs"]:
        s = game.init(1, "cpu")
        for a in seq:
            s = game.step(s, torch.tensor([a]))
        states.append(s)
    search = make_search_fn(game, make_uniform_model(game).apply_fn,
                            MCTSConfig(num_sims=50, max_depth=64))
    counts = search(torch.cat(states)).root_counts()
    np.testing.assert_array_equal(counts.numpy().astype(int), np.asarray(spec["counts"]))


@pytest.mark.parametrize("sims", [10, 100])
def test_matches_cpp_oracle(sims):
    seqs = [[], [3], [0, 1, 0, 1, 0, 1], [0, 1, 0, 1, 0], [3, 3, 2, 4, 1, 5],
            [2, 2, 2, 2, 2, 2, 0, 1]]
    boards = boards_from_seqs(seqs)
    search = make_search_fn(TG, make_uniform_model(TG).apply_fn,
                            MCTSConfig(num_sims=sims, max_depth=48))
    got = search(torch_state(boards)).root_counts().numpy()
    for i, b in enumerate(boards):
        oracle = native.oracle_search(b, (b != 0).sum(axis=0), sims, 1.0, 48)
        if oracle is None:
            pytest.skip("no C++ toolchain for the oracle")
        np.testing.assert_array_equal(got[i], oracle, err_msg=f"position {seqs[i]}")


@pytest.mark.parametrize("case", ["uniform_dirichlet", "order_free_mlp", "othello_cutoffs"])
def test_counts_equal_the_hybrid_engine(case):
    """The ladder's two last rungs agree: the dense engine's root counts
    equal the hybrid engine's (its plain versions here) on the same roots
    and draws."""
    if case == "othello_cutoffs":
        game, cfg = TO, MCTSConfig(num_sims=24, max_depth=4, dirichlet_alpha=0.3)
        boards, apply_fn = random_othello_boards(6, 12, seed=8), make_uniform_model(TO).apply_fn
    else:
        game, cfg = TG, MCTSConfig(num_sims=40, max_depth=48, dirichlet_alpha=1.0)
        boards = _roots()
        apply_fn = (make_uniform_model(TG).apply_fn if case == "uniform_dirichlet"
                    else _order_free()[2])
    noise = sample_draws(torch.Generator().manual_seed(7), len(boards), game.num_actions,
                         cfg.dirichlet_alpha, "cpu").dirichlet
    state = torch_state(boards)
    dense = make_search_fn(game, apply_fn, cfg)(state, noise).root_counts()
    hyb = make_hybrid_root_fn(game, apply_fn, cfg, kernels=hybrid.PLAIN)(state, noise)
    assert torch.equal(dense, hyb)
    assert (dense.sum(1) > 0).any()


def test_never_takes_the_hybrid_seeds(monkeypatch):
    """The dense engine keeps its own planes: it calls neither the hybrid
    seeds (``kernels.refresh``/``refresh2``, right only on a fresh search's
    planes) nor the plain refreshes."""
    def refuse(*_):
        raise AssertionError("the dense engine took a hybrid refresh")

    for name in ("refresh", "refresh2", "refresh_dense", "refresh2_dense"):
        if hasattr(kernels, name):
            monkeypatch.setattr(kernels, name, refuse)
    monkeypatch.setattr(hybrid, "refresh", refuse)
    monkeypatch.setattr(hybrid, "refresh2", refuse)
    cfg = MCTSConfig(num_sims=12, max_depth=48)
    counts = make_search_fn(TG, make_uniform_model(TG).apply_fn, cfg)(
        torch_state(random_boards(3, 5, seed=2))).root_counts()
    assert (counts.sum(1) == 12).all()
    with pytest.raises(AssertionError, match="hybrid refresh"):
        make_hybrid_root_fn(TG, make_uniform_model(TG).apply_fn, cfg)(
            torch_state(random_boards(3, 5, seed=2)))


def test_num_sims_override_and_views():
    cfg = MCTSConfig(num_sims=30, max_depth=48)
    search = make_search_fn(TG, make_uniform_model(TG).apply_fn, cfg)
    tree = search(torch_state(random_boards(2, 3, seed=1)), num_sims=5)
    assert (tree.root_counts().sum(1) == 5).all() and tree.capacity == 31
    assert tree.N.dtype == torch.int32 and tree.child.dtype == torch.int32
    assert ((tree.child[:, 0] >= 1) | (tree.child[:, 0] == -1)).all()
