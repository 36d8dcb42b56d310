"""The port's transposition engine (``alphazero_tpu_torch/mcts/tt.py``) on
the CPU: root counts and transposition links equal to the C++ DAG oracle
(``csrc/tt_oracle.cpp``, ``use_tt=1``) on Connect-Four and Othello; the
whole decoded DAG (node and edge statistics, child codes, node flags, state
rows, counts, cursors, links) equal to the JAX engine's under the same
injected Dirichlet draws, and on the cyclic ``ToggleGame``; the JAX
engine's frozen TPU goldens; and its semantics at the edges (no
transposition in range, capacity, a terminal root, the K=1 guard).

The JAX engine compiles a ``while_loop`` (~5 s a configuration on the CPU),
so the oracle decides every question it can and JAX is compiled only for
the decoded DAGs, at small sizes; no Othello JAX engine is compiled."""

import dataclasses
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
from alphazero_tpu.mcts.tt import make_tt_search_fn as jax_tt_search_fn
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour, Othello
from alphazero_tpu_torch.mcts import make_search_fn, make_tt_search_fn
from alphazero_tpu_torch.mcts.tt import STAT_N, STAT_W, TTTree
from alphazero_tpu_torch.models import convert_mlp, make_apply_fn, make_uniform_model
from alphazero_tpu_torch.models import order_free_mlp_variables
from tests.torch_parity import (
    fused_test_positions,
    jax_state,
    random_boards,
    random_othello_boards,
    torch_state,
)

pytestmark = pytest.mark.skipif(not native.available(), reason="native toolchain unavailable")

JG, G, O = JaxConnectFour(), ConnectFour(), Othello()
UNI = make_uniform_model(G).apply_fn
C4_POSITIONS = np.concatenate([random_boards(1, k, seed=k) for k in (0, 3, 6, 9)])


class ToggleGame:
    """The port's copy of ``tests/dummy_game.py::ToggleGame``: two canonical
    states (parity 0 and 1) that toggle on every move, never terminating —
    a cyclic state graph, where a descent walks the same unexpanded edge
    again before the links are written."""

    name = "toggle"
    num_actions = 2
    feature_shape = (2,)
    max_moves = 8
    num_symmetries = 1
    heuristic_is_zero = True

    def init(self, batch: int, device="cpu") -> torch.Tensor:
        return torch.zeros(batch, dtype=torch.int32, device=device)

    def step(self, state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return 1 - state

    def valid_moves(self, state: torch.Tensor) -> torch.Tensor:
        return torch.ones((state.shape[0], 2), dtype=torch.bool, device=state.device)

    def terminal(self, state: torch.Tensor):
        return (torch.zeros(state.shape[0], dtype=torch.bool, device=state.device),
                torch.zeros(state.shape[0], device=state.device))

    def to_features(self, state: torch.Tensor) -> torch.Tensor:
        p = state.float()
        return torch.stack([p, 1.0 - p], dim=-1)

    def eval_heuristic(self, state: torch.Tensor) -> torch.Tensor:
        return torch.zeros(state.shape[0], device=state.device)


def _decoded(tree: TTTree) -> dict:
    """The port's DAG in the JAX ``TTTree`` layout (planes before slots)."""
    return {
        "nstats": tree.nstats.permute(0, 2, 1),
        "pstats": tree.pstats.permute(0, 2, 3, 1),
        "node": tree.node.permute(0, 2, 1),
        "state": tree.state.permute(0, 2, 1),
        "count": tree.count,
        "cursor": tree.cursor,
        "dedup": tree.dedup,
    }


def _assert_same_dag(jt, pt: TTTree, what: str, ulps: bool = False) -> None:
    """Every plane bit-equal; with ``ulps`` (priors and values through exp,
    log and tanh, which XLA and torch may round apart in the last bit) the
    prior and W planes within 1e-5."""
    got = _decoded(pt)
    for name, p in got.items():
        j = np.asarray(jax.tree_util.tree_leaves(getattr(jt, name))[0])
        p = p.numpy()
        if name == "state":
            j = j.reshape(p.shape)
        assert j.shape == p.shape, f"{what} {name}: {j.shape} != {p.shape}"
        if ulps and name in ("nstats", "pstats"):
            plane = (STAT_W,) if name == "nstats" else (0,)
            np.testing.assert_allclose(p[:, plane], j[:, plane], rtol=0, atol=1e-5,
                                       err_msg=f"{what} {name}")
            rest = [k for k in range(p.shape[1]) if k not in plane]
            np.testing.assert_array_equal(j[:, rest], p[:, rest], err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(j, p, err_msg=f"{what} {name}")


def _w_zero_where_n_zero(tree: TTTree) -> None:
    """The shared score plane's precondition: a node's W is exactly 0 where
    its N is (``q = w / max(n, 1)`` then equals the JAX
    ``where(n > 0, w / max(n, 1), 0)``)."""
    n, w = tree.nstats[..., STAT_N], tree.nstats[..., STAT_W]
    assert (w[n == 0] == 0).all()


@pytest.mark.parametrize("cpuct", [0.7, 1.0, 2.5])
@pytest.mark.parametrize("sims", [50, 400])
def test_connect_four_matches_the_oracle(cpuct, sims):
    cfg = MCTSConfig(num_sims=sims, max_depth=48, cpuct=cpuct, transposition=True)
    tree = make_tt_search_fn(G, UNI, cfg)(torch_state(C4_POSITIONS))
    counts = tree.root_counts().numpy()
    for b, board in enumerate(C4_POSITIONS):
        want, hits = native.tt_oracle_search("connect_four", board, sims, cpuct, 48, use_tt=True)
        np.testing.assert_array_equal(counts[b], want, err_msg=f"b={b}")
        assert int(tree.dedup[b]) == hits
    if sims == 400:
        assert int(tree.dedup.sum()) > 0        # transpositions fire at depth
    _w_zero_where_n_zero(tree)


def test_othello_matches_the_oracle():
    boards = np.concatenate([random_othello_boards(1, k, seed=k) for k in (0, 4, 10)])
    cfg = MCTSConfig(num_sims=200, max_depth=64, transposition=True)
    tree = make_tt_search_fn(O, make_uniform_model(O).apply_fn, cfg)(torch.as_tensor(boards))
    counts = tree.root_counts().numpy()
    for b, board in enumerate(boards):
        want, hits = native.tt_oracle_search("othello", board, 200, 1.0, 64, use_tt=True)
        np.testing.assert_array_equal(counts[b], want, err_msg=f"b={b}")
        assert int(tree.dedup[b]) == hits
    assert int(tree.dedup.sum()) > 0


def test_decoded_dag_matches_jax_with_injected_dirichlet():
    """Connect-Four B=3 at 60 sims, an order-free MLPNet (32,) and the JAX
    Dirichlet sample: at cpuct 0.1 the lines run deep, links fire and one
    game reaches terminal children."""
    variables = order_free_mlp_variables(7, (32,), seed=4)
    jnet = JaxMLPNet(num_actions=7, hidden=(32,))
    jparams = jax.tree_util.tree_map(jnp.asarray, variables)
    kw = dict(num_sims=60, max_depth=48, cpuct=0.1, dirichlet_alpha=1.0, transposition=True)
    boards = random_boards(3, 10, seed=1)
    key = jax.random.key(3)
    jt = jax.jit(jax_tt_search_fn(JG, lambda p, f: jnet.apply(p, f), JaxMCTSConfig(**kw)))(
        jparams, jax_state(boards), key)
    dirichlet = torch.as_tensor(np.array(jax.random.dirichlet(key, jnp.full((7,), 1.0), (3,))))
    pt = make_tt_search_fn(G, make_apply_fn(convert_mlp(variables)), MCTSConfig(**kw))(
        torch_state(boards), dirichlet)
    _assert_same_dag(jt, pt, "mlp dirichlet", ulps=True)
    assert int(pt.dedup.sum()) > 0 and (pt.node[..., 0] > 0.5).any()
    _w_zero_where_n_zero(pt)


def test_toggle_game_links_each_edge_once():
    """The cyclic fixture: the DAG equals the JAX engine's on
    ``tests/dummy_game.py::ToggleGame``, links fire, only the two states
    are materialised, and every live child code points at the other
    parity."""
    from dummy_game import ToggleGame as JaxToggleGame

    jg, tg = JaxToggleGame(), ToggleGame()
    kw = dict(num_sims=6, max_depth=8, transposition=True)
    jroot = jax.vmap(lambda _: jg.init())(jnp.arange(1))
    jt = jax.jit(jax_tt_search_fn(jg, jax_uniform(jg).apply_fn, JaxMCTSConfig(**kw)))({}, jroot)
    pt = make_tt_search_fn(tg, make_uniform_model(tg).apply_fn, MCTSConfig(**kw))(tg.init(1))
    _assert_same_dag(jt, pt, "toggle")
    assert int(pt.dedup[0]) > 0 and int(pt.count[0]) == 2
    parity = pt.state[0, :, 0]
    code = pt.pstats[0, :2, 1]                                         # [2, A]
    for slot in range(2):
        for a in range(2):
            cd = float(code[slot, a])
            if cd > -0.5:
                assert cd == int(cd) and int(cd) < 2
                assert int(parity[int(cd)]) == 1 - int(parity[slot])


def test_no_transpositions_matches_the_dense_engine():
    """Below the range of transpositions node statistics are edge
    statistics: the counts equal the port's dense engine's."""
    boards = np.concatenate([random_boards(1, k, seed=11 + k) for k in (2, 5, 8)])
    cfg = MCTSConfig(num_sims=60, max_depth=48)
    dag = make_tt_search_fn(G, UNI, dataclasses.replace(cfg, transposition=True))(
        torch_state(boards))
    assert int(dag.dedup.sum()) == 0
    tree = make_search_fn(G, UNI, cfg)(torch_state(boards))
    assert torch.equal(dag.root_counts(), tree.root_counts())
    assert torch.equal(dag.root_q(), tree.root_q() * (tree.root_counts() > 0))


def test_capacity_degrades_gracefully():
    cfg = MCTSConfig(num_sims=100, max_depth=48, max_nodes=20, transposition=True)
    tree = make_tt_search_fn(G, UNI, cfg)(G.init(2, "cpu"))
    counts = tree.root_counts()
    assert (counts >= 0).all() and tree.nstats.shape[1] == 20
    assert (tree.count == 20).all() and (tree.cursor == 101).all()
    assert (tree.node[:, :, 2] == 1).all()
    _w_zero_where_n_zero(tree)


def test_terminal_root_searches_nothing():
    board = np.zeros((6, 7), np.int8)
    board[0:4, 0] = 1
    board[0:3, 1] = -1
    cfg = MCTSConfig(num_sims=30, max_depth=48, transposition=True)
    tree = make_tt_search_fn(G, UNI, cfg)(torch_state(board[None]))
    assert float(tree.root_counts().sum()) == 0.0
    assert int(tree.count[0]) == 1 and int(tree.cursor[0]) == 31 and int(tree.dedup[0]) == 0
    assert float(tree.nstats.abs().sum()) == 0.0


def test_parallel_sims_raises_the_jax_error():
    jcfg = JaxMCTSConfig(num_sims=8, parallel_sims=4, transposition=True)
    with pytest.raises(ValueError) as want:
        jax_tt_search_fn(JG, jax_uniform(JG).apply_fn, jcfg)
    with pytest.raises(ValueError, match="K=1") as got:
        make_tt_search_fn(G, UNI, MCTSConfig(**dataclasses.asdict(jcfg)))
    assert str(got.value) == str(want.value)


def test_tpu_goldens():
    """``tests/tpu_goldens.json``'s ``tt_c4_uniform_*`` heads, frozen by
    ``tests/test_tpu_gate.py::test_tt_move_matches_golden`` (B=64 positions
    of its generator, 25 sims, max_depth 48)."""
    with open(os.path.join(os.path.dirname(__file__), "tpu_goldens.json")) as f:
        goldens = json.load(f)
    boards = fused_test_positions(G, 64, 6, 17)
    cfg = MCTSConfig(num_sims=25, max_depth=48, transposition=True)
    tree = make_tt_search_fn(G, UNI, cfg)(torch_state(boards))
    counts = tree.root_counts()
    assert float(counts.sum(-1).max()) == 25
    np.testing.assert_array_equal(counts[:8].numpy(), goldens["tt_c4_uniform_counts_head"])
    np.testing.assert_array_equal(tree.dedup[:16].numpy(), goldens["tt_c4_uniform_dedup_head"])
