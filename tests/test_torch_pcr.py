"""Playout-cap randomization (``SelfPlayConfig.full_search_prob``) in the
port's fixed scan against the JAX package's, mirroring tests/test_pcr.py:
each step exactly ``round(p * B)`` games of the step's permutation search
the full budget and store a policy target, the rest search
``cheap_sims`` without root noise and store an all-zero ``pi`` (a
value-only sample). JAX's draws are replayed (the five-way split a step,
``permutation(k_coin, B)``, the sub-batches' noise from ``split(k_noise)``
in permuted order), and trajectories and stats must be equal (``pi``
within 1e-6: XLA fuses ``action_probs``' division by the max count
differently in this program and can round it an ulp apart; with Gumbel
search exp and log can too): p = 0, 1, 0.375 (sub-batches of 3 and 5, the
fused route), 0.5 with Dirichlet noise on the full sub-batch, the hybrid
route, and with Gumbel search. Value-only rows go through the replay ring as the JAX ring takes
them, and the policy loss is normalised over policy rows; the validation
errors are the JAX package's."""

import jax
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.config import ReplayConfig as JaxReplayConfig
from alphazero_tpu.config import SelfPlayConfig as JaxSelfPlayConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu.replay import replay_init as jax_replay_init
from alphazero_tpu.replay import replay_insert as jax_replay_insert
from alphazero_tpu.selfplay import make_selfplay_fn as jax_selfplay
from alphazero_tpu_torch.config import MCTSConfig, ReplayConfig, SelfPlayConfig, TrainConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.models import MLPNet, make_uniform_model
from alphazero_tpu_torch.replay import replay_init, replay_insert
from alphazero_tpu_torch.selfplay import make_recycling_selfplay_fn, make_selfplay_fn
from alphazero_tpu_torch.train import init_train_state, loss_terms
from tests.torch_parity import jax_pcr_scan_draws

JG, TG = JaxConnectFour(), ConnectFour()
A = TG.num_actions


class _HybridUniform:
    """The uniform model without the uniform value that routes it to the
    fused engine: the ladder searches it on the hybrid engine."""

    def __init__(self):
        uniform = make_uniform_model(TG).apply_fn

        def apply_fn(feats):
            return uniform(feats)

        apply_fn.needs_features = False
        self.apply_fn = apply_fn


def play_both(p_full, cheap=4, sims=12, B=8, gumbel=False, seed=0, alpha=None, model=None):
    """``(JAX (traj, stats), port (traj, stats, draws))`` of one PCR scan."""
    kw = dict(num_sims=sims, gumbel=gumbel, dirichlet_alpha=alpha)
    sp = dict(batch_size=B, temp_threshold=5, full_search_prob=p_full, cheap_sims=cheap)
    key = jax.random.PRNGKey(seed)
    want = jax.jit(jax_selfplay(JG, jax_uniform(JG).apply_fn, JaxMCTSConfig(**kw),
                                JaxSelfPlayConfig(**sp)))({}, key)
    n_full = max(0, min(B, int(round(p_full * B))))
    draws = jax_pcr_scan_draws(key, TG.max_moves, B, A, n_full, alpha, gumbel)
    got = make_selfplay_fn(TG, MCTSConfig(**kw), SelfPlayConfig(**sp), device="cpu")(
        model or make_uniform_model(TG), lambda t: draws[t])
    return want, (*got, draws)


def check_equal(want, got):
    (j_traj, j_stats), (t_traj, t_stats, _) = want, got
    for name in ("features", "value", "valid"):
        np.testing.assert_array_equal(getattr(t_traj, name).numpy(),
                                      np.asarray(getattr(j_traj, name)), err_msg=name)
    np.testing.assert_allclose(t_traj.pi.numpy(), np.asarray(j_traj.pi), rtol=0, atol=1e-6)
    for name in t_stats._fields:
        np.testing.assert_array_equal(getattr(t_stats, name).numpy(),
                                      np.asarray(getattr(j_stats, name)), err_msg=name)


def pi_row_kind(traj):
    """Per valid sample: True = policy-bearing (sums to 1), False =
    value-only (all zeros); nothing in between."""
    sums = traj.pi[traj.valid].sum(-1)
    full = sums > 0.5
    torch.testing.assert_close(sums[full], torch.ones(int(full.sum())))
    assert (sums[~full] == 0).all()
    return full


@pytest.mark.parametrize("p_full", [0.0, 1.0, 0.375], ids=["p0", "p1", "p0.375"])
def test_scan_matches_jax(p_full):
    want, got = play_both(p_full, seed=1)
    check_equal(want, got)
    traj, stats, _ = got
    assert stats.done.all()
    full = pi_row_kind(traj)
    if p_full == 0.0:
        assert not full.any() and (traj.value[traj.valid] != 0).any()
    elif p_full == 1.0:
        assert full.all()
    else:
        assert full.any() and (~full).any()


def test_dirichlet_noise_reaches_the_full_sub_batch():
    want, got = play_both(0.5, seed=2, alpha=1.0)
    check_equal(want, got)


def test_hybrid_route_matches_jax():
    want, got = play_both(0.375, seed=4, model=_HybridUniform())
    check_equal(want, got)


@pytest.mark.parametrize("p_full", [0.0, 0.375, 1.0], ids=["p0", "p0.375", "p1"])
def test_gumbel_scan_matches_jax(p_full):
    want, got = play_both(p_full, gumbel=True, seed=3)
    check_equal(want, got)
    full = pi_row_kind(got[0])
    assert full.all() if p_full == 1.0 else (~full).any()


@pytest.mark.parametrize("gumbel", [False, True])
def test_coin_is_per_game_and_stratified(gumbel):
    """Each step exactly round(p * B) games store a policy target (every
    game of a step is counted: a finished game's frozen root still
    searches), the assignment varies across games and steps, and is the
    first round(p * B) games of the step's permutation."""
    B, p = 8, 0.5
    want, got = play_both(p, gumbel=gumbel, seed=5, B=B)
    check_equal(want, got)
    traj, _, draws = got
    patterns = set()
    for t in range(traj.pi.shape[0]):
        kinds = traj.pi[t].sum(-1) > 0.5
        assert int(kinds.sum()) == round(p * B)
        assert kinds[draws[t].perm[: round(p * B)]].all()
        patterns.add(tuple(kinds.tolist()))
    assert len(patterns) > 1


def test_value_only_rows_flow_through_the_replay_ring():
    """The JAX ring and the port's take the same rows, value-only ones
    included (twice each: Connect-Four's two symmetries)."""
    (j_traj, _), (traj, _, _) = play_both(0.5, seed=3)
    n_valid = int(traj.valid.sum())
    ring = replay_insert(replay_init(TG, ReplayConfig(capacity=4096), device="cpu"), TG, traj)
    j_ring = jax_replay_insert(jax_replay_init(JG, JaxReplayConfig(capacity=4096)), JG, j_traj)
    assert ring.size == int(j_ring.size) == 2 * n_valid
    np.testing.assert_array_equal(ring.data.numpy(), np.asarray(j_ring.data))
    sums = ring.data[: ring.size, 6 * 7 * 2: 6 * 7 * 2 + A].sum(-1)
    assert ((sums == 0) | ((sums - 1.0).abs() < 1e-5)).all() and (sums == 0).any()


def test_policy_loss_normalizes_over_policy_rows():
    """Adding value-only rows to a batch leaves the policy loss as it was."""
    torch.manual_seed(0)
    state = init_train_state(MLPNet(A, hidden=(16,), dtype=torch.float32), TrainConfig())
    cfg = TrainConfig(l2_scale=0.0)
    g = torch.Generator().manual_seed(1)
    feats = torch.randn((8, 6, 7, 2), generator=g)
    pi_t = torch.softmax(torch.randn((8, A), generator=g), dim=-1)
    v_t = torch.zeros(8)
    m_all = loss_terms(state.model, cfg, feats, pi_t, v_t)
    m_mix = loss_terms(state.model, cfg, torch.cat([feats, feats]),
                       torch.cat([pi_t, torch.zeros_like(pi_t)]), torch.cat([v_t, v_t]))
    torch.testing.assert_close(m_mix.policy_loss, m_all.policy_loss, rtol=1e-5, atol=0)


@pytest.mark.parametrize("mcts,sp", [
    (dict(num_sims=8), dict(batch_size=2, full_search_prob=0.25)),
    (dict(num_sims=8, tree_reuse=True), dict(batch_size=2, full_search_prob=0.25, cheap_sims=2)),
    (dict(num_sims=8, forced_playouts=2.0, dirichlet_alpha=1.0),
     dict(batch_size=2, full_search_prob=0.25, cheap_sims=2)),
], ids=["no_cheap_sims", "tree_reuse", "forced_playouts"])
def test_validation_errors_match_jax(mcts, sp):
    with pytest.raises(ValueError) as want:
        jax_selfplay(JG, jax_uniform(JG).apply_fn, JaxMCTSConfig(**mcts), JaxSelfPlayConfig(**sp))
    with pytest.raises(ValueError) as got:
        make_selfplay_fn(TG, MCTSConfig(**mcts), SelfPlayConfig(**sp), device="cpu")
    assert str(got.value) == str(want.value)


def test_recycling_refuses_pcr():
    sp = SelfPlayConfig(batch_size=2, full_search_prob=0.25, cheap_sims=2, recycle=True)
    with pytest.raises(ValueError, match="playout-cap randomization"):
        make_recycling_selfplay_fn(TG, MCTSConfig(num_sims=8), sp, device="cpu")


def test_missing_permutation_raises():
    """A mixed split needs the step's permutation: no draw is made up."""
    play = make_selfplay_fn(TG, MCTSConfig(num_sims=4),
                            SelfPlayConfig(batch_size=4, full_search_prob=0.5, cheap_sims=2),
                            device="cpu")
    draws = jax_pcr_scan_draws(jax.random.PRNGKey(0), 1, 4, A, 2, None, False)
    with pytest.raises(ValueError, match="permutation"):
        play(make_uniform_model(TG), lambda t: draws[0]._replace(perm=None))
