"""The port's Gumbel search (``alphazero_tpu_torch/mcts/gumbel.py``) against
the JAX package's ``make_gumbel_search_fn`` on the CPU: the sequential-
halving schedule and table, ``completed_scores`` on the trees both engines
build, whole Connect-Four searches (the uniform model and order-free MLP
weights, in evaluation mode and with an injected ``jax.random.gumbel``
sample: root counts, decoded trees and actions identical, ``improved_pi``
and the MLP's ``vraw`` within 1e-6, since exp, log and tanh may round an ulp
apart), the two TPU goldens that JAX reproduces on the CPU, and the
``ValueError``s word for word.

``gumbel_c4_mlp_eval_action_head`` is left out: JAX on the CPU picks
another action than the frozen golden at game 12 (5 against 6, both with
12 visits, ``logits + sigma`` 3.294 against 3.175), so that golden holds
the TPU's matmul rounding, not the algorithm."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.mcts import gumbel as jax_gumbel
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu.models import init_flax_model, make_flax_apply_fn
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.mcts import gumbel
from alphazero_tpu_torch.mcts import make_gumbel_search_fn
from alphazero_tpu_torch.models import convert_mlp, make_apply_fn, make_uniform_model
from alphazero_tpu_torch.models import order_free_mlp_variables
from tests.torch_parity import (
    DRAW_BOARD,
    boards_from_seqs,
    fused_test_positions,
    jax_state,
    random_boards,
    torch_state,
)

JG, TG = JaxConnectFour(), ConnectFour()
SIMS = 32
KW = dict(num_sims=SIMS, max_depth=48, gumbel=True)
VIEWS = ("N", "child", "valid", "term", "tval", "count", "cursor")
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tpu_goldens.json")


def _roots():
    """Roots at two depths, a drawn board and a won one (terminal roots,
    which never search)."""
    return np.concatenate([random_boards(6, 4, seed=4), random_boards(6, 17, seed=5),
                           DRAW_BOARD[None], boards_from_seqs([[3, 0, 3, 0, 3, 0, 3]])])


def _models():
    variables = order_free_mlp_variables(7, (32,), seed=4)
    jnet = JaxMLPNet(num_actions=7, hidden=(32,))
    return {
        "uniform": (jax_uniform(JG).apply_fn, {}, make_uniform_model(TG).apply_fn),
        "order_free_mlp": ((lambda p, f: jnet.apply(p, f)),
                           jax.tree_util.tree_map(jnp.asarray, variables),
                           make_apply_fn(convert_mlp(variables))),
    }


@pytest.fixture(scope="module")
def searches():
    """``(model, mode) -> (JAX result, port result, JAX search, port
    search)``: each case's JAX search jitted and run once."""
    boards = _roots()
    B = len(boards)
    out = {}
    for name, (j_apply, params, p_apply) in _models().items():
        jsearch = jax_gumbel.make_gumbel_search_fn(JG, j_apply, JaxMCTSConfig(**KW))
        psearch = make_gumbel_search_fn(TG, p_apply, MCTSConfig(**KW))
        for mode, key in (("eval", None), ("sampled", jax.random.key(7))):
            jr = jax.jit(jsearch)(params, jax_state(boards), key)
            g = None if key is None else torch.as_tensor(np.array(jax.random.gumbel(key, (B, 7))))
            out[name, mode] = (jr, psearch(torch_state(boards), g), jsearch, psearch, params)
    return out


@pytest.mark.parametrize("m,n", [(0, 5), (1, 4), (2, 16), (3, 7), (4, 16), (7, 100), (16, 32),
                                 (16, 7), (9, 1)])
def test_schedule_matches_jax(m, n):
    assert gumbel.considered_visit_sequence(m, n) == jax_gumbel.considered_visit_sequence(m, n)


@pytest.mark.parametrize("top_m,n", [(1, 8), (7, 32), (16, 50)])
def test_table_matches_jax(top_m, n):
    got = gumbel.considered_visit_table(top_m, n)
    want = jax_gumbel.considered_visit_table(top_m, n)
    assert got.dtype == want.dtype and got.shape == (top_m + 1, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("model", ["uniform", "order_free_mlp"])
@pytest.mark.parametrize("mode", ["eval", "sampled"])
def test_search_matches_jax(searches, model, mode):
    jr, pr, _, _, _ = searches[model, mode]
    np.testing.assert_array_equal(pr.tree.root_counts().numpy(), np.asarray(jr.tree.root_counts()))
    np.testing.assert_array_equal(pr.action.numpy(), np.asarray(jr.action))
    for view in VIEWS:
        np.testing.assert_array_equal(getattr(pr.tree, view).numpy(),
                                      np.asarray(getattr(jr.tree, view)), err_msg=view)
    np.testing.assert_allclose(pr.improved_pi.numpy(), np.asarray(jr.improved_pi), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(pr.vraw.numpy(), np.asarray(jr.vraw), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pr.gumbel.numpy(), np.asarray(jr.gumbel))
    if model == "uniform":
        np.testing.assert_array_equal(pr.vraw.numpy(), np.asarray(jr.vraw))


@pytest.mark.parametrize("mode", ["eval", "sampled"])
def test_completed_scores_match_jax(searches, mode):
    """On identical trees (the JAX search's, its statistics moved into the
    port's node-major layout) and node values, every plane of
    ``completed_scores`` agrees within 1e-6."""
    jr, pr, jsearch, psearch, params = searches["order_free_mlp", mode]
    want = jsearch._completed_scores(jr.tree, jr.vraw)
    tree = pr.tree._replace(stats=torch.as_tensor(np.array(jr.tree.stats)).permute(0, 3, 1, 2))
    got = psearch._completed_scores(tree, torch.as_tensor(np.array(jr.vraw)))
    for name, j, p in zip(("score", "logits", "sigma", "legal", "n", "pi_imp"), want, got):
        assert tuple(p.shape) == tuple(j.shape) == (pr.tree.batch_size, 7, SIMS + 1), name
        if p.dtype == torch.bool:
            np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=name)
        else:
            np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=0, atol=1e-6, err_msg=name)


def test_search_invariants(searches):
    """Live roots: 32 root visits, pi' a distribution over the legal
    actions, the action legal and among the most visited; terminal roots
    never search (the full drawn board has no legal action and a zero
    pi')."""
    _, pr, _, _, _ = searches["order_free_mlp", "sampled"]
    boards = torch_state(_roots())
    live = ~TG.terminal(boards)[0]
    counts = pr.tree.root_counts()
    valid = TG.valid_moves(boards)
    movable = valid.any(dim=1)
    assert (counts.sum(dim=1)[live] == SIMS).all() and (counts[~live] == 0).all()
    assert (~movable).sum() == 1 and (pr.improved_pi[~movable] == 0).all()
    torch.testing.assert_close(pr.improved_pi.sum(dim=1)[movable], torch.ones(int(movable.sum())))
    assert (pr.improved_pi[~valid] == 0).all()
    act = pr.action
    assert valid.gather(1, act[:, None])[movable].all()
    assert (counts.gather(1, act[:, None])[:, 0][live] == counts.amax(dim=1)[live]).all()


def test_goldens_reproduced_through_the_port():
    """``test_tpu_gate.py::test_gumbel_move_matches_golden``'s setup through
    the converter: the port equals JAX on the CPU in both modes, and meets
    the two goldens JAX reproduces there."""
    goldens = json.load(open(GOLDENS))
    model = JaxMLPNet(num_actions=7, hidden=(32, 32))
    params = init_flax_model(model, jax.random.key(5), JG.feature_shape)
    boards = fused_test_positions(TG, 256, 4, 16)
    cfg = dict(num_sims=32, max_depth=48, gumbel=True, dirichlet_alpha=None)
    jsearch = jax.jit(jax_gumbel.make_gumbel_search_fn(JG, make_flax_apply_fn(model),
                                                       JaxMCTSConfig(**cfg)))
    psearch = make_gumbel_search_fn(TG, make_apply_fn(convert_mlp(params)), MCTSConfig(**cfg))
    sample = torch.as_tensor(np.array(jax.random.gumbel(jax.random.key(7), (256, 7))))
    for key, g in ((None, None), (jax.random.key(7), sample)):
        jr = jsearch(params, jax_state(boards), key)
        pr = psearch(torch_state(boards), g)
        np.testing.assert_array_equal(pr.tree.root_counts().numpy(),
                                      np.asarray(jr.tree.root_counts()))
        np.testing.assert_array_equal(pr.action.numpy(), np.asarray(jr.action))
        if key is None:
            np.testing.assert_array_equal(pr.tree.root_counts()[:8].numpy(),
                                          goldens["gumbel_c4_mlp_eval_counts_head"])
        else:
            np.testing.assert_array_equal(pr.action[:16].numpy(),
                                          goldens["gumbel_c4_mlp_rng_action_head"])


@pytest.mark.parametrize("kw", [dict(dirichlet_alpha=1.0), dict(parallel_sims=2)],
                         ids=["dirichlet", "parallel_sims"])
def test_value_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jax_gumbel.make_gumbel_search_fn(JG, jax_uniform(JG).apply_fn, JaxMCTSConfig(**KW, **kw))
    with pytest.raises(ValueError) as got:
        make_gumbel_search_fn(TG, make_uniform_model(TG).apply_fn, MCTSConfig(**KW, **kw))
    assert str(got.value) == str(want.value)


def test_top_m_and_num_sims_override():
    """``gumbel_top_m = 1`` funnels every visit into one root action, and
    ``num_sims`` overrides the budget, as in the JAX engine."""
    boards = _roots()[:6]
    cfg = dict(num_sims=12, max_depth=48, gumbel=True, gumbel_top_m=1)
    jr = jax.jit(jax_gumbel.make_gumbel_search_fn(JG, jax_uniform(JG).apply_fn,
                                                  JaxMCTSConfig(**cfg)),
                 static_argnames="num_sims")({}, jax_state(boards), None, num_sims=5)
    pr = make_gumbel_search_fn(TG, make_uniform_model(TG).apply_fn, MCTSConfig(**cfg))(
        torch_state(boards), num_sims=5)
    counts = pr.tree.root_counts()
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jr.tree.root_counts()))
    assert ((counts > 0).sum(dim=1) == 1).all() and (counts.sum(dim=1) == 5).all()
