"""The port's steady-state actor against JAX ``make_actor_step_fn``: the
same carry and JAX's own draws (split exactly as the JAX actor splits its
key) give the same play distributions, moves, recycled boards and move
counts, step after step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.games import Othello as JaxOthello
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu.selfplay import make_actor_step_fn as jax_actor_step_fn
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour, Othello
from alphazero_tpu_torch.mcts import make_tt_search_fn
from alphazero_tpu_torch.models import make_uniform_model
from alphazero_tpu_torch.ops import action_probs, sample_draws
from alphazero_tpu_torch.selfplay import _make_root_counts_fn, make_actor_step_fn
from tests.torch_parity import (
    jax_state,
    jax_step_draws,
    othello_jax_state,
    random_boards,
    random_othello_boards,
    torch_state,
)

JG = JaxConnectFour()
TG = ConnectFour()
B = 8
TEMP_THRESHOLD = 15


def _jax_draws(key, alpha, actions=7):
    """The draws the JAX actor makes from ``key`` (selfplay.py actor_step:
    split 3 ways; Dirichlet in root_prior, uniforms in action_probs,
    Gumbel inside jax.random.categorical)."""
    return jax_step_draws(*jax.random.split(key, 3), B, actions, alpha)


def test_actor_steps_match_jax_with_injected_draws():
    jcfg = JaxMCTSConfig(num_sims=8, max_depth=48, dirichlet_alpha=1.0)
    cfg = MCTSConfig(**dataclasses.asdict(jcfg))
    _, j_step = jax_actor_step_fn(JG, jax_uniform(JG).apply_fn, jcfg, B, TEMP_THRESHOLD)
    j_step = jax.jit(j_step)
    _, t_step = make_actor_step_fn(TG, make_uniform_model(TG).apply_fn, cfg, B, TEMP_THRESHOLD, device="cpu")

    # late positions (episodes end and recycle within the run), move
    # counts on both sides of the temperature threshold
    boards = random_boards(B, 30, seed=1)
    counts0 = np.array([0, 5, 14, 15, 20, 30, 33, 35], np.int32)
    j_carry = (jax_state(boards), jnp.asarray(counts0))
    t_carry = (torch_state(boards), torch.as_tensor(counts0))
    resets = 0
    for t in range(10):
        key = jax.random.key(1000 + t)
        j_carry, j_pi = j_step({}, j_carry, key)
        t_carry, t_pi = t_step(t_carry, _jax_draws(key, 1.0))
        np.testing.assert_allclose(np.asarray(j_pi), t_pi.numpy(), rtol=1e-6, atol=0, err_msg=f"step {t}")
        np.testing.assert_array_equal(np.asarray(j_carry[0].board), t_carry[0].numpy(), err_msg=f"step {t}")
        np.testing.assert_array_equal(np.asarray(j_carry[1]), t_carry[1].numpy(), err_msg=f"step {t}")
        resets += int((t_carry[1] == 0).sum())
    assert resets > 0   # recycling was exercised


def test_othello_actor_steps_match_jax_with_injected_draws():
    """Othello through the hybrid engine: late positions (passes, games
    that end by a double pass and recycle to the opening), move counts on
    both sides of the preset's temperature threshold 12, Dirichlet 0.3."""
    jg, tg = JaxOthello(), Othello()
    jcfg = JaxMCTSConfig(num_sims=6, max_depth=80, dirichlet_alpha=0.3)
    cfg = MCTSConfig(**dataclasses.asdict(jcfg))
    _, j_step = jax_actor_step_fn(jg, jax_uniform(jg).apply_fn, jcfg, B, 12)
    j_step = jax.jit(j_step)
    _, t_step = make_actor_step_fn(tg, make_uniform_model(tg).apply_fn, cfg, B, 12, device="cpu")

    boards = random_othello_boards(B, 54, seed=2)
    counts0 = np.array([0, 5, 11, 12, 20, 40, 54, 60], np.int32)
    j_carry = (othello_jax_state(boards), jnp.asarray(counts0))
    t_carry = (torch_state(boards), torch.as_tensor(counts0))
    resets = passes = 0
    for t in range(10):
        key = jax.random.key(2000 + t)
        live = ~tg.terminal(t_carry[0])[0]
        passes += int((tg.valid_moves(t_carry[0])[:, 64] & live).sum())
        j_carry, j_pi = j_step({}, j_carry, key)
        t_carry, t_pi = t_step(t_carry, _jax_draws(key, 0.3, actions=65))
        np.testing.assert_allclose(np.asarray(j_pi), t_pi.numpy(), rtol=1e-6, atol=0, err_msg=f"step {t}")
        np.testing.assert_array_equal(np.asarray(j_carry[0].board), t_carry[0].numpy(), err_msg=f"step {t}")
        np.testing.assert_array_equal(np.asarray(j_carry[1]), t_carry[1].numpy(), err_msg=f"step {t}")
        resets += int((t_carry[1] == 0).sum())
    assert resets > 0 and passes > 0   # recycling and passes were exercised


def test_actor_with_generator_draws():
    cfg = MCTSConfig(num_sims=6, max_depth=48, dirichlet_alpha=1.0)
    init, step = make_actor_step_fn(
        TG, make_uniform_model(TG).apply_fn, cfg, B, TEMP_THRESHOLD, device="cpu"
    )
    gen = torch.Generator().manual_seed(0)
    carry = init()
    assert carry[0].shape == (B, 6, 7) and carry[1].dtype == torch.int32
    for t in range(3):
        carry, pi = step(carry, sample_draws(gen, B, 7, cfg.dirichlet_alpha, "cpu"))
        torch.testing.assert_close(pi.sum(1), torch.ones(B))
        assert (carry[1] == t + 1).all()
        assert ((carry[0] != 0).sum(dim=(1, 2)) == t + 1).all()


@pytest.mark.parametrize(
    "cfg,err,match",
    [
        # the transposition engine is ported (tests/test_torch_tt.py): the
        # actor rides it, its move the ladder's counts of that engine
        (MCTSConfig(num_sims=12, max_depth=48, dirichlet_alpha=1.0, transposition=True),
         None, None),
        # Gumbel search is ported (tests/test_torch_gumbel_selfplay.py); the
        # actor refuses its Dirichlet noise with the JAX engine's ValueError
        (MCTSConfig(gumbel=True, dirichlet_alpha=1.0), ValueError,
         "gumbel search replaces Dirichlet root noise"),
        # a training-target device of the fixed scan: the actor refuses it
        # where the JAX actor searches unforced (ROADMAP queue 3)
        (MCTSConfig(forced_playouts=2.0, dirichlet_alpha=1.0), ValueError, "ROADMAP"),
    ],
    ids=["transposition", "gumbel", "forced_playouts"],
)
def test_unported_engines_raise(cfg, err, match):
    apply_fn = make_uniform_model(TG).apply_fn
    if err is None:
        init, step = make_actor_step_fn(TG, apply_fn, cfg, B, TEMP_THRESHOLD, device="cpu")
        search = make_tt_search_fn(TG, apply_fn, cfg)
        gen = torch.Generator().manual_seed(2)
        state = torch_state(random_boards(B, 12, seed=2))
        carry = (state, torch.arange(B, dtype=torch.int32) * 3)
        draws = sample_draws(gen, B, 7, cfg.dirichlet_alpha, "cpu")
        _, pi = step(carry, draws)
        counts = search(state, draws.dirichlet).root_counts()
        assert (counts.sum(1)[~TG.terminal(state)[0]] == cfg.num_sims).all()
        temp = (carry[1] < TEMP_THRESHOLD).float()
        assert torch.equal(pi, action_probs(counts, temp, draws.tie))
        return
    with pytest.raises(err, match=match):
        make_actor_step_fn(TG, apply_fn, cfg, B, TEMP_THRESHOLD, device="cpu")


def test_game_without_flat_ops_raises():
    """A game without flat ops no longer raises: the ladder's last rung,
    the dense engine, searches it, with the counts the hybrid engine gives
    the same game with its flat ops."""
    class NoFlatOps(ConnectFour):
        flat_ops = None

    cfg = MCTSConfig(num_sims=24, max_depth=48, dirichlet_alpha=1.0)
    state = torch_state(random_boards(B, 6, seed=4))
    noise = sample_draws(torch.Generator().manual_seed(1), B, 7, 1.0, "cpu").dirichlet

    def no_fused(feats):
        return make_uniform_model(TG).apply_fn(feats)

    no_fused.needs_features = False
    dense = _make_root_counts_fn(NoFlatOps(), no_fused, cfg)
    assert dense.__qualname__.startswith("dense_root_fn.")
    hybrid = _make_root_counts_fn(TG, no_fused, cfg)
    assert hybrid.__qualname__.startswith("make_hybrid_root_fn.")
    assert torch.equal(dense(state, noise), hybrid(state, noise))
