"""Othello in the port: the game ops and flat ops equal the JAX package's
exactly (every action, the pass and illegal placements included), and the
port's hybrid engine (the plain versions of its kernels on the CPU) gives
root visit counts EQUAL to the JAX XLA engine and the frozen goldens, for
uniform and dyadic models, depth-cutoff leaves with their nonzero
heuristic included, and so do the port's dense engine's whole trees
(tests/test_torch_othello_models.py holds the real networks and the JAX
hybrid engine).

The JAX side is jitted once per configuration (an Othello search compiles
in ~20 s on the CPU), so each configuration serves several inputs."""

import dataclasses
import json
import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import Othello as JaxOthello
from alphazero_tpu.mcts.search import make_search_fn
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import Game, Othello
from alphazero_tpu_torch.mcts import PLAIN, SearchKernels, hybrid, make_hybrid_root_fn
from alphazero_tpu_torch.mcts import make_search_fn as make_search_fn_port
from alphazero_tpu_torch.models import make_uniform_model
from tests.torch_parity import othello_jax_state, random_othello_boards, torch_state

JG = JaxOthello()
TG = Othello()
JOPS = JG.flat_ops()
TOPS = TG.flat_ops()


def _forced_pass_board() -> np.ndarray:
    """The player to move has no placement, the opponent has: the pass is
    the only legal move (and the game is not over)."""
    b = np.zeros((8, 8), np.int8)
    b[0, 0], b[0, 1] = -1, 1    # +1 to move cannot capture; -1 can play (0, 2)
    return b


@lru_cache(maxsize=None)
def _positions() -> np.ndarray:
    """Openings, midgames, endgames, finished games, boards played past
    the end, and a forced pass."""
    parts = [
        random_othello_boards(4, 0, seed=0),
        random_othello_boards(12, 11, seed=1),
        random_othello_boards(12, 30, seed=2),
        random_othello_boards(12, 57, seed=3),
        random_othello_boards(8, 70, seed=4, freeze_done=False),
        _forced_pass_board()[None],
    ]
    return np.concatenate(parts)


@lru_cache(maxsize=None)
def _jax_vmapped(name: str):
    return jax.jit(jax.vmap(getattr(JG, name)))


def test_protocol_and_static_fields():
    assert isinstance(TG, Game)
    for name in ("name", "num_actions", "feature_shape", "max_moves", "num_symmetries"):
        assert getattr(TG, name) == getattr(JG, name)
    assert TG.heuristic_is_zero is False
    assert (TOPS.size, TOPS.num_actions) == (JOPS.size, JOPS.num_actions) == (64, 65)
    np.testing.assert_array_equal(np.asarray(JG.init().board)[None].repeat(3, 0), TG.init(3, "cpu").numpy())
    assert TG.init(3, "cpu").dtype == torch.int8


def test_step_matches_every_action_including_pass_and_illegal():
    """Othello.step and OthelloFlatOps.step (the kernel helper's plain
    version) against both JAX steps, for all 65 actions on every
    position: placements that capture, illegal drops on empty and on
    occupied cells, and the pass."""
    boards = _positions()
    n = len(boards)
    tiled = np.repeat(boards, 65, axis=0)
    acts = np.tile(np.arange(65), n)
    ref = np.asarray(_jax_vmapped("step")(othello_jax_state(tiled), jnp.asarray(acts)).board)
    got = TG.step(torch_state(tiled), torch.as_tensor(acts))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(ref, got.numpy())

    flat = TOPS.from_state(torch_state(tiled))
    a_col = torch.as_tensor(acts, dtype=torch.float32)[:, None]
    ref_flat = np.asarray(jax.jit(JOPS.step)(jnp.asarray(flat.numpy()), jnp.asarray(a_col.numpy())))
    got_flat = TOPS.step(flat, a_col)
    np.testing.assert_array_equal(ref_flat, got_flat.numpy())          # -0.0 == 0.0
    np.testing.assert_array_equal(ref.reshape(-1, 64), got_flat.numpy())
    # captures and passes both occur
    legal = TG.valid_moves(torch_state(tiled)).numpy()[np.arange(len(acts)), acts]
    flipped = ((got.numpy() != -tiled).sum(axis=(1, 2)))
    assert (flipped[legal & (acts < 64)] >= 2).all() and legal[acts == 64].any()


def test_valid_terminal_features_heuristic_match():
    boards = _positions()
    js, ts = othello_jax_state(boards), torch_state(boards)
    vm = TG.valid_moves(ts)
    np.testing.assert_array_equal(np.asarray(_jax_vmapped("valid_moves")(js)), vm.numpy())
    jd, jv = _jax_vmapped("terminal")(js)
    td, tv = TG.terminal(ts)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert td.any() and (~td).any() and (tv == 1).any() and (tv == -1).any()
    assert vm[-1, 64] and not vm[-1, :64].any() and not td[-1]        # the forced pass
    np.testing.assert_array_equal(np.asarray(_jax_vmapped("to_features")(js)), TG.to_features(ts).numpy())
    np.testing.assert_array_equal(np.asarray(_jax_vmapped("eval_heuristic")(js)), TG.eval_heuristic(ts).numpy())


def test_flat_ops_match():
    boards = _positions()
    js = othello_jax_state(boards)
    jflat = JOPS.from_state(js)
    tflat = TOPS.from_state(torch_state(boards))
    np.testing.assert_array_equal(np.asarray(jflat), tflat.numpy())
    aux = TOPS.aux("cpu")
    np.testing.assert_array_equal(np.asarray(jax.jit(JOPS.valid)(jflat)), TOPS.valid(tflat).numpy())
    jd, jv = jax.jit(JOPS.terminal)(jflat, JOPS.aux())
    td, tv = TOPS.terminal(tflat, aux)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    vm2, td2, tv2 = TOPS.valid_terminal(tflat, aux)
    assert torch.equal(vm2, TOPS.valid(tflat)) and torch.equal(td2, td) and torch.equal(tv2, tv)
    np.testing.assert_array_equal(np.asarray(JOPS.to_features(jflat)), TOPS.to_features(tflat).numpy())
    np.testing.assert_array_equal(np.asarray(JOPS.heuristic(jflat)), TOPS.heuristic(tflat).numpy())


def test_symmetries_match():
    boards = _positions()[:16]
    rng = np.random.default_rng(0)
    pi = rng.dirichlet(np.ones(65), len(boards)).astype(np.float32)
    feats = np.array(_jax_vmapped("to_features")(othello_jax_state(boards)))
    jf, jp = jax.vmap(JG.symmetries)(jnp.asarray(feats), jnp.asarray(pi))
    tf, tp = TG.symmetries(torch.as_tensor(feats), torch.as_tensor(pi))
    assert tf.shape == (16, 8, 8, 8, 2) and tp.shape == (16, 8, 65)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


def _dyadic_models(seed=0):
    """A linear model on the 128 features with dyadic weights: logits and
    value are exact in both frameworks (0/1 features, sums of multiples of
    1/64), so search counts must agree exactly."""
    rng = np.random.default_rng(seed)
    wp = (rng.integers(-4, 5, (128, 65)) / 8).astype(np.float32)
    bp = (rng.integers(-4, 5, 65) / 8).astype(np.float32)
    wv = (rng.integers(-2, 3, 128) / 64).astype(np.float32)

    def jax_apply(params, feats):
        x = feats.reshape(feats.shape[0], -1)
        return x @ wp + bp, jnp.clip(x @ wv + 1 / 16, -1.0, 1.0)

    twp, tbp, twv = map(torch.as_tensor, (wp, bp, wv))

    def torch_apply(feats):
        x = feats.reshape(feats.shape[0], -1)
        return x @ twp + tbp, torch.clamp(x @ twv + 1 / 16, -1.0, 1.0)

    torch_apply.needs_features = True
    return jax_apply, torch_apply


UNIFORM_CFG = JaxMCTSConfig(num_sims=10, max_depth=64)
CUTOFF_CFG = JaxMCTSConfig(num_sims=32, max_depth=3)


@lru_cache(maxsize=None)
def _jax_xla_tree_fn(model: str):
    """The JAX XLA engine's search, jitted once: the uniform model at
    UNIFORM_CFG or the dyadic model at CUTOFF_CFG."""
    if model == "uniform":
        search = make_search_fn(JG, jax_uniform(JG).apply_fn, UNIFORM_CFG)
    else:
        search = make_search_fn(JG, _dyadic_models()[0], CUTOFF_CFG)
    return jax.jit(lambda state: search({}, state))


def _port_counts(apply_fn, cfg, boards, kernels=None):
    root_counts = make_hybrid_root_fn(TG, apply_fn, MCTSConfig(**dataclasses.asdict(cfg)), kernels=kernels)
    return root_counts(torch_state(boards)).numpy()


@pytest.mark.parametrize("moves", [0, 8])
def test_uniform_matches_xla_engine(moves):
    boards = random_othello_boards(4, moves, seed=moves)
    ref = np.asarray(_jax_xla_tree_fn("uniform")(othello_jax_state(boards)).root_counts())
    got = _port_counts(make_uniform_model(TG).apply_fn, UNIFORM_CFG, boards)
    np.testing.assert_array_equal(ref, got)
    assert (got.sum(1) == UNIFORM_CFG.num_sims).all()


def _cut_counting_kernels(cuts):
    """PLAIN kernels that count the depth-cutoff leaves of every descent."""

    def descend(*args):
        out = hybrid.descend(*args)
        cuts.append(int(out[3][:, hybrid.M_CUT].sum()))
        return out

    return SearchKernels(descend, hybrid.merge, hybrid.refresh)


def test_dyadic_cutoff_matches_xla_engine():
    """max_depth 3: depth-cutoff leaves back up the disc-differential
    heuristic of the leaf board; counts equal the XLA engine's."""
    jax_apply, torch_apply = _dyadic_models()
    boards = random_othello_boards(4, 6, seed=9)
    ref = np.asarray(_jax_xla_tree_fn("dyadic")(othello_jax_state(boards)).root_counts())
    cuts = []
    got = _port_counts(torch_apply, CUTOFF_CFG, boards, kernels=_cut_counting_kernels(cuts))
    np.testing.assert_array_equal(ref, got)
    assert sum(cuts) > 0                                  # the cutoff path ran
    assert (got.max(1) > got.min(1) + 2).any()            # a non-uniform search


@pytest.mark.parametrize("model", ["uniform", "dyadic"])
def test_dense_engine_trees_match_xla_engine(model):
    """The port's dense engine (mcts/search.py) against the same jitted
    XLA engine: every decoded view of the trees (N, W, P, child codes,
    legality, terminal flags and values, counts, cursors) equal. The
    dyadic model at max_depth 3 backs the disc-differential heuristic up
    at its cutoffs; its prior goes through exp, whose last bit XLA and
    torch may round apart, so P and W are held within 1e-5 there."""
    cfg = UNIFORM_CFG if model == "uniform" else CUTOFF_CFG
    apply_fn = make_uniform_model(TG).apply_fn if model == "uniform" else _dyadic_models()[1]
    boards = random_othello_boards(4, 8 if model == "uniform" else 6, seed=9)
    jt = _jax_xla_tree_fn(model)(othello_jax_state(boards))
    pt = make_search_fn_port(TG, apply_fn, MCTSConfig(**dataclasses.asdict(cfg)))(
        torch_state(boards))
    for view in ("N", "W", "P", "child", "valid", "term", "tval", "count", "cursor"):
        j, p = np.asarray(getattr(jt, view)), getattr(pt, view).numpy()
        if model == "dyadic" and view in ("P", "W"):
            np.testing.assert_allclose(p, j, rtol=0, atol=1e-5, err_msg=view)
        else:
            np.testing.assert_array_equal(p, j, err_msg=view)
    if model == "dyadic":
        class ZeroHeuristic(Othello):
            heuristic_is_zero = True

        zero = make_search_fn_port(ZeroHeuristic(), apply_fn, MCTSConfig(**dataclasses.asdict(cfg)))(
            torch_state(boards))
        assert not torch.equal(zero.W, pt.W)   # the cutoffs fired and backed the heuristic up


def test_frozen_goldens():
    with open(os.path.join(os.path.dirname(__file__), "golden_counts.json")) as f:
        spec = json.load(f)["othello"]
    states = []
    for seq in spec["seqs"]:
        s = TG.init(1, "cpu")
        for a in seq:
            s = TG.step(s, torch.tensor([a]))
        states.append(s)
    got = _port_counts(make_uniform_model(TG).apply_fn, JaxMCTSConfig(num_sims=50, max_depth=64),
                       torch.cat(states).numpy())
    np.testing.assert_array_equal(got.astype(int), np.asarray(spec["counts"]))


def test_dense_refresh_is_the_first_max_puct_argmax():
    """The dense branch (A > 8) on planes with exact ties and an
    all-illegal node: the PUCT score's first maximum over the actions
    (numpy's argmax), and that action's child code; action 0 where every
    edge is illegal, as in JAX."""
    rng = np.random.default_rng(0)
    B, A, C = 3, 65, 6
    n = torch.as_tensor(rng.integers(0, 3, (B, A, C)).astype(np.float32))
    w = torch.as_tensor((rng.integers(-4, 5, (B, A, C)) / 4).astype(np.float32))
    p = torch.full((B, A, C), 1.0 / 64)                  # equal priors: exact ties
    p[:, 5::7] = -1e30                                   # illegal edges
    p[0, :, 2] = -1e30                                   # an all-illegal node
    code = torch.as_tensor(rng.integers(-3, 6, (B, A, C)).astype(np.float32))
    best_a, best_c = hybrid.refresh(n, w, p, code, 1.25)
    assert torch.equal(best_a[0, 2], torch.tensor(0.0)) and best_c[0, 2] == code[0, 0, 2]
    sq = torch.sqrt(n.sum(dim=1) + 1e-6)
    score = torch.where(p <= -5e29, -1e30, w / n.clamp(min=1) + 1.25 * p * sq[:, None] / (1 + n))
    first = torch.stack([torch.tensor([int(np.argmax(score[b, :, c].numpy())) for c in range(C)])
                         for b in range(B)]).float()
    assert torch.equal(best_a, first)
    assert torch.equal(best_c, code.gather(1, first.long()[:, None])[:, 0])
    assert (score == score.amax(dim=1, keepdim=True)).sum(dim=1).max() > 1   # ties occurred


def test_plain_kernels_route_to_the_plain_versions_on_cpu():
    """``PLAIN`` and the default wrappers agree on the CPU (both run the
    plain versions), and the search conserves simulations."""
    boards = random_othello_boards(6, 20, seed=11)
    uni = make_uniform_model(TG).apply_fn
    cfg = JaxMCTSConfig(num_sims=12, max_depth=64)
    a = _port_counts(uni, cfg, boards)
    b = _port_counts(uni, cfg, boards, kernels=PLAIN)
    np.testing.assert_array_equal(a, b)
    live = ~TG.terminal(torch_state(boards))[0].numpy()
    assert (a.sum(1)[live] == 12).all() and (a.sum(1)[~live] == 0).all()

