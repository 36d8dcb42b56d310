"""Forced playouts and policy-target pruning (Wu 2020 §3.2) in the port's
dense engine and fixed scan, against the JAX package: the forced-child
mask and the pruned counts on seeded root statistics, the forced bonus's
tie (the lowest-index forced child, as the JAX engine's f32 add gives),
a forced search's tree, a forced fixed-scan call under JAX's own draws,
the JAX ``ValueError``s word for word; then a coach iteration with forced
playouts on the port alone."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.config import SelfPlayConfig as JaxSelfPlayConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.mcts import search as jax_search
from alphazero_tpu.mcts.tree import PLANE_N, PLANE_P, PLANE_W
from alphazero_tpu.mcts.tree import init_tree as jax_init_tree
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu.selfplay import make_selfplay_fn as jax_selfplay_fn
from alphazero_tpu_torch.config import (
    ArenaConfig,
    AZConfig,
    MCTSConfig,
    ReplayConfig,
    SelfPlayConfig,
    TrainConfig,
)
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.mcts import search
from alphazero_tpu_torch.mcts import tree as port_tree
from alphazero_tpu_torch.mcts.tree import init_tree
from alphazero_tpu_torch.models import MLPNet, convert_mlp, make_apply_fn, make_uniform_model
from alphazero_tpu_torch.models import order_free_mlp_variables
from alphazero_tpu_torch.selfplay import make_selfplay_fn
from tests.torch_parity import jax_scan_draws, jax_state, random_boards, torch_state

JG, TG = JaxConnectFour(), ConnectFour()
A = 7
INVALID_P = -1e30


def _root_trees(n, w, p, capacity=4):
    """A JAX tree and a port tree whose roots carry the planes n, w, p
    f32[B, A] (on the initial position's legality; the rest empty)."""
    B = n.shape[0]
    root = np.zeros((B, 6, 7), np.int8)
    jt = jax_init_tree(JG, jax_state(root), capacity)
    stats = jt.stats
    for plane, x in ((PLANE_N, n), (PLANE_W, w), (PLANE_P, p)):
        stats = stats.at[:, plane, :, 0].set(jnp.asarray(x))
    pt = init_tree(TG, torch_state(root), capacity)
    for plane, x in ((port_tree.PLANE_N, n), (port_tree.PLANE_W, w), (port_tree.PLANE_P, p)):
        pt.stats[:, 0, plane] = torch.as_tensor(x)
    return jt._replace(stats=stats), pt


def _seeded_root(seed, batch=64):
    """Root statistics of searches: integer visit counts, values within
    them, priors with some illegal edges (INVALID_P)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 40, (batch, A)).astype(np.float32)
    n[rng.random((batch, A)) < 0.2] = 0.0
    w = (rng.uniform(-1, 1, (batch, A)) * n).astype(np.float32)
    p = rng.dirichlet(np.full(A, 0.5), batch).astype(np.float32)
    illegal = rng.random((batch, A)) < 0.15
    n[illegal], w[illegal], p[illegal] = 0.0, 0.0, INVALID_P
    return n, w, p


@pytest.mark.parametrize("case,k,cpuct", [
    ("properties", 2.0, 1.0), ("unforced", 0.0, 1.0), ("seed0", 2.0, 1.0), ("seed1", 2.0, 1.5),
    ("seed2", 0.5, 1.0),
])
def test_mask_and_pruning_match_jax(case, k, cpuct):
    if case == "properties":
        n = np.array([[60.0, 6.0, 1.0, 20.0, 0.0, 0.0, 0.0]], np.float32)
        w = np.array([[30.0, -3.0, 0.0, 19.0, 0.0, 0.0, 0.0]], np.float32)
        p = np.array([[0.5, 0.2, 0.1, 0.05, 0.0, 0.0, 0.0]], np.float32)
    elif case == "unforced":
        n = np.array([[40.0, 30.0, 20.0, 10.0, 0.0, 0.0, 0.0]], np.float32)
        w = np.array([[20.0, 10.0, 5.0, 2.0, 0.0, 0.0, 0.0]], np.float32)
        p = np.array([[0.4, 0.3, 0.2, 0.1, 0.0, 0.0, 0.0]], np.float32)
    else:
        n, w, p = _seeded_root(int(case[-1]))
    jt, pt = _root_trees(n, w, p)
    want_mask = np.asarray(jax_search._forced_root_mask(jt.stats, k))
    got_mask = search._forced_root_mask(pt.stats, k).numpy()
    np.testing.assert_array_equal(got_mask, want_mask)
    want = np.asarray(jax_search.pruned_root_counts(jt, k, cpuct))
    got = search.pruned_root_counts(pt, k, cpuct).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got <= n).all() and (got >= 0).all()
    if case == "properties":
        assert got[0].tolist()[:4] == [60.0, got[0, 1], 0.0, 20.0] and got[0, 1] < 6.0
    if case == "unforced":
        np.testing.assert_array_equal(got, n)
    if case.startswith("seed"):
        assert 0 < got_mask.sum() < got_mask.size and (got != n).any()


def test_forced_tie_takes_the_lowest_index():
    """Two forced root children, the higher-PUCT one at the higher index:
    ``score + 1e9`` rounds both to exactly 1e9 in f32, so both packages'
    first-max picks the lower index, and the simulation expands it."""
    n = np.array([[10.0, 0.0, 10.0, 10.0, 10.0, 0.0, 10.0]], np.float32)
    w = np.zeros_like(n)
    p = np.array([[0.13, 0.05, 0.13, 0.13, 0.13, 0.3, 0.13]], np.float32)
    jt, pt = _root_trees(n, w, p, capacity=8)
    plain = search.dense_puct_scores(pt.stats, 1.0)[0, :, 0]
    assert plain[5] > plain[1]                           # the comment's rule would pick 5
    np.testing.assert_array_equal(search._forced_root_mask(pt.stats, 2.0)[0].numpy(),
                                  [0, 1, 0, 0, 0, 1, 0])
    jcfg = JaxMCTSConfig(num_sims=1, max_depth=8, max_nodes=8, forced_playouts=2.0)
    j_parts = jax_search.make_engine_parts(JG, jax_uniform(JG).apply_fn, jcfg)
    lane0 = (jnp.arange(8) == 0).astype(jnp.float32)
    j_score = (jax_search.dense_puct_scores(jt.stats, 1.0)
               + 1e9 * jax_search._forced_root_mask(jt.stats, 2.0)[:, :, None] * lane0)
    j_best, j_code = j_parts["best_planes"](jt, j_score)
    jt, _ = j_parts["expand_backup"]({}, jt, j_parts["select"](jt, j_best, j_code))

    parts = search.make_engine_parts(TG, make_uniform_model(TG).apply_fn,
                                     MCTSConfig(**dataclasses.asdict(jcfg)))
    best_a, best_code = parts["best_planes"](pt, search.forced_puct_scores(pt.stats, 1.0, 2.0))
    assert int(best_a[0, 0]) == int(j_best[0, 0]) == 1
    pt, _ = parts["expand_backup"](pt, parts["select"](pt, best_a, best_code))
    assert pt.N[0, 0].tolist() == [10, 1, 10, 10, 10, 0, 10] and int(pt.child[0, 0, 1]) == 1
    for view in ("N", "W", "P", "child", "term", "tval", "count", "cursor"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, view)), getattr(pt, view).numpy(),
                                      err_msg=view)


def test_forced_search_matches_jax():
    kw = dict(num_sims=32, max_depth=48, dirichlet_alpha=1.0, forced_playouts=2.0)
    boards = random_boards(8, 5, seed=6)
    key = jax.random.key(9)
    jt = jax.jit(jax_search.make_search_fn(JG, jax_uniform(JG).apply_fn, JaxMCTSConfig(**kw)))(
        {}, jax_state(boards), key)
    noise = torch.as_tensor(np.array(jax.random.dirichlet(key, jnp.full((A,), 1.0), (8,))))
    pt = search.make_search_fn(TG, make_uniform_model(TG).apply_fn, MCTSConfig(**kw))(
        torch_state(boards), noise)
    for view in ("N", "child", "valid", "term", "tval", "count", "cursor"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, view)), getattr(pt, view).numpy(),
                                      err_msg=view)
    # the noised prior goes through log and exp, whose last bit XLA and
    # torch may round apart
    np.testing.assert_allclose(pt.P.numpy(), np.asarray(jt.P), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pt.W.numpy(), np.asarray(jt.W))   # values are exact (+-1, 0)
    # forcing spread the visits: every legal child of every root searched
    assert (pt.N[:, 0][pt.valid[:, 0]] > 0).all()


def _order_free(hidden=(32,)):
    variables = order_free_mlp_variables(A, hidden, seed=2)
    jnet = JaxMLPNet(num_actions=A, hidden=hidden)
    jparams = jax.tree_util.tree_map(jnp.asarray, variables)
    return (lambda p, f: jnet.apply(p, f)), jparams, convert_mlp(variables)


@pytest.mark.parametrize("model", ["uniform", "order_free_mlp"])
def test_forced_fixed_scan_matches_jax(model):
    """tests/test_forced.py's scan (B=4, 16 sims, max_depth 16): the moves,
    features, valid rows, values and stats bit-equal under JAX's draws; the
    pruned targets equal up to the last bits of the exp, log and tanh that
    feed the pruning's Q and prior."""
    kw = dict(num_sims=16, max_depth=16, forced_playouts=2.0, dirichlet_alpha=1.0)
    jm, js = JaxMCTSConfig(**kw), JaxSelfPlayConfig(batch_size=4, temp_threshold=4)
    if model == "uniform":
        j_apply, jparams, port_model = jax_uniform(JG).apply_fn, {}, make_uniform_model(TG)
    else:
        j_apply, jparams, port_model = _order_free()
    key = jax.random.key(5)
    j_traj, j_stats = jax.jit(jax_selfplay_fn(JG, j_apply, jm, js))(jparams, key)
    draws = jax_scan_draws(key, TG.max_moves, 4, A, 1.0)
    play = make_selfplay_fn(TG, MCTSConfig(**kw), SelfPlayConfig(**dataclasses.asdict(js)),
                            device="cpu")
    t_traj, t_stats = play(port_model, lambda t: draws[t])
    for name in ("features", "value", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(j_traj, name)),
                                      getattr(t_traj, name).numpy(), err_msg=name)
    for name in j_stats._fields:
        np.testing.assert_array_equal(np.asarray(getattr(j_stats, name)),
                                      getattr(t_stats, name).numpy(), err_msg=name)
    np.testing.assert_allclose(t_traj.pi.numpy(), np.asarray(j_traj.pi), rtol=0, atol=1e-6)
    pi, valid = t_traj.pi.numpy(), t_traj.valid.numpy()
    np.testing.assert_allclose(pi[valid].sum(-1), 1.0, atol=1e-5)
    assert (pi >= 0).all() and valid.any()
    # pruning changed some targets: they are not the play distribution
    assert (pi[valid].max(-1) < 1.0).any()


@pytest.mark.parametrize("mcts,sp", [
    (dict(gumbel=True), {}),
    (dict(tree_reuse=True), {}),
    (dict(transposition=True), {}),
    ({}, dict(full_search_prob=0.5, cheap_sims=2)),
    (dict(parallel_sims=4), {}),
], ids=["gumbel", "tree_reuse", "transposition", "pcr", "parallel_sims"])
def test_forced_refusals_match_jax(mcts, sp):
    base = dict(num_sims=8, max_depth=8, forced_playouts=2.0)
    jm, js = JaxMCTSConfig(**base, **mcts), JaxSelfPlayConfig(batch_size=2, **sp)
    with pytest.raises(ValueError) as want:
        jax_selfplay_fn(JG, jax_uniform(JG).apply_fn, jm, js)
    with pytest.raises(ValueError) as got:
        make_selfplay_fn(TG, MCTSConfig(**dataclasses.asdict(jm)),
                         SelfPlayConfig(**dataclasses.asdict(js)), device="cpu")
    assert str(got.value) == str(want.value)


def test_forcing_meets_the_quota():
    """tests/test_forced.py's guarantee on the port: on a win-in-1 root the
    forced search gives every legal child n >= sqrt(k * P * sum n) - 2,
    where plain PUCT starves some of them."""
    k, sims = 2.0, 128
    root = TG.init(2, "cpu")
    for a in (0, 1, 0, 2, 0, 3):
        root = TG.step(root, torch.tensor([a, a]))
    apply_fn = make_apply_fn(_order_free((16,))[2])
    cfg = MCTSConfig(num_sims=sims, max_depth=24)
    plain = search.make_search_fn(TG, apply_fn, cfg)(root)
    forced = search.make_search_fn(TG, apply_fn, dataclasses.replace(cfg, forced_playouts=k))(root)
    cf, cp = forced.root_counts(), plain.root_counts()
    quota = torch.sqrt(k * forced.P[:, 0] * cf.sum(-1, keepdim=True))
    assert (cf >= quota - 2.0).all() and (cp < quota - 2.0).any()
    assert torch.equal(cf.sum(-1), cp.sum(-1))


def test_coach_iteration_with_forced(tmp_path):
    from alphazero_tpu_torch.coach import Coach

    cfg = AZConfig(
        mcts=MCTSConfig(num_sims=8, max_depth=16, forced_playouts=2.0, dirichlet_alpha=1.0),
        selfplay=SelfPlayConfig(batch_size=4, temp_threshold=6),
        replay=ReplayConfig(capacity=2048),
        train=TrainConfig(batch_size=32, steps_per_iteration=4),
        arena=ArenaConfig(num_games=4, update_threshold=0.6, num_sims=4),
        seed=2,
        checkpoint_dir=str(tmp_path),
    )
    coach = Coach(TG, MLPNet(A, hidden=(32,)), cfg, device="cpu")
    rec = coach.run_iteration()
    assert rec["replay_size"] > 0
