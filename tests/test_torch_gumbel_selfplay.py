"""Gumbel search in the port's three self-play generators against the JAX
package's, under JAX's own draws (each step's search sample
``gumbel(k_noise, [B, A])`` replayed as ``Draws.gumbel``): the fixed scan
(uniform model and order-free MLP weights), recycling over two calls (the
carried fragment emitted and resolved) and the steady-state actor; and
the Gumbel arena (each move's root sample ``gumbel(k_tie, [B, A])``, the
two models through the combined forward).
Features, values, valid rows, stats and carries are bit-equal; ``pi``, the
improved policy, within 1e-6 (exp and log may round an ulp apart); the
moves are equal, since every later board is."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.config import SelfPlayConfig as JaxSelfPlayConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu.selfplay import make_actor_step_fn as jax_actor
from alphazero_tpu.selfplay import make_recycling_selfplay_fn as jax_recycling
from alphazero_tpu.selfplay import make_selfplay_fn as jax_selfplay
from alphazero_tpu_torch.config import MCTSConfig, SelfPlayConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.models import convert_mlp, make_uniform_model, order_free_mlp_variables
from alphazero_tpu_torch.ops import Draws
from alphazero_tpu_torch.selfplay import (
    make_actor_step_fn,
    make_recycling_selfplay_fn,
    make_selfplay_fn,
)
from tests.torch_parity import (
    arena_both,
    jax_gumbel_scan_draws,
    jax_state,
    random_boards,
    torch_state,
)

B = 8
SIMS = 8
TEMP_THRESHOLD = 6
JG, TG = JaxConnectFour(), ConnectFour()
A = TG.num_actions


def _cfgs(**sp):
    jm = JaxMCTSConfig(num_sims=SIMS, max_depth=48, gumbel=True)
    js = JaxSelfPlayConfig(batch_size=B, temp_threshold=TEMP_THRESHOLD, **sp)
    return jm, js, MCTSConfig(**dataclasses.asdict(jm)), SelfPlayConfig(**dataclasses.asdict(js))


def _models(name):
    """``(JAX apply_fn, params, port model)``."""
    if name == "uniform":
        return jax_uniform(JG).apply_fn, {}, make_uniform_model(TG)
    variables = order_free_mlp_variables(A, (32,), seed=6)
    jnet = JaxMLPNet(num_actions=A, hidden=(32,))
    return ((lambda p, f: jnet.apply(p, f)), jax.tree_util.tree_map(jnp.asarray, variables),
            convert_mlp(variables))


def _equal(j_tuple, t_tuple, what, close=("pi", "frag_pi")):
    for name, j, t in zip(j_tuple._fields, j_tuple, t_tuple):
        j = np.asarray(getattr(j, "board", j))
        if name in close:
            np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6, err_msg=f"{what}.{name}")
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=f"{what}.{name}")


@pytest.mark.parametrize("model", ["uniform", "order_free_mlp"])
def test_fixed_scan_matches_jax(model):
    jm, js, cfg, sp = _cfgs()
    j_apply, params, p_model = _models(model)
    key = jax.random.key(31)
    j_traj, j_stats = jax.jit(jax_selfplay(JG, j_apply, jm, js))(params, key)
    draws = jax_gumbel_scan_draws(key, TG.max_moves, B, A)
    t_traj, t_stats = make_selfplay_fn(TG, cfg, sp, device="cpu")(p_model, lambda t: draws[t])
    _equal(j_traj, t_traj, "traj")
    _equal(j_stats, t_stats, "stats")
    assert t_stats.done.all() and (t_traj.value[t_traj.valid] != 0).any()
    # the stored target is the improved policy: a distribution on every row
    torch.testing.assert_close(t_traj.pi.sum(-1)[t_traj.valid],
                               torch.ones(int(t_traj.valid.sum())))


def test_recycling_matches_jax_over_two_calls():
    jm, js, cfg, sp = _cfgs(recycle=True)
    j_init, j_play = jax_recycling(JG, jax_uniform(JG).apply_fn, jm, js)
    t_init, t_play = make_recycling_selfplay_fn(TG, cfg, sp, device="cpu")
    j_play = jax.jit(j_play)
    j_carry, t_carry = j_init(), t_init()
    M = TG.max_moves
    for i, key in enumerate((jax.random.key(41), jax.random.key(42))):
        draws = jax_gumbel_scan_draws(key, M, B, A)
        j_out = j_play({}, j_carry, key)
        t_out = t_play(make_uniform_model(TG), t_carry, lambda t: draws[t])
        for what, j, t in zip(("carry", "traj", "stats"), j_out, t_out):
            _equal(j, t, f"call {i} {what}")
        j_carry, t_carry = j_out[0], t_out[0]
        if i == 1:
            assert t_out[1].valid[:M].any()   # the first call's fragment resolved


def test_actor_steps_match_jax():
    """Three actor steps from mid-game boards: the improved policy and the
    halving winner's boards, resets included."""
    jm, _, cfg, _ = _cfgs()
    j_init, j_step = jax_actor(JG, jax_uniform(JG).apply_fn, jm, B, TEMP_THRESHOLD)
    _, t_step = make_actor_step_fn(TG, make_uniform_model(TG).apply_fn, cfg, B, TEMP_THRESHOLD,
                                   device="cpu")
    j_step = jax.jit(j_step)
    boards = random_boards(B, 9, seed=8)
    moves = np.full((B,), 9, np.int32)
    j_carry = (jax_state(boards), jnp.asarray(moves))
    t_carry = (torch_state(boards), torch.as_tensor(moves))
    for i in range(3):
        key = jax.random.key(50 + i)
        k_noise, k_tie, _ = jax.random.split(key, 3)
        draws = Draws(None, torch.as_tensor(np.array(jax.random.uniform(k_tie, (B, A)))),
                      torch.as_tensor(np.array(jax.random.gumbel(k_noise, (B, A)))))
        j_carry, j_pi = j_step({}, j_carry, key)
        t_carry, t_pi = t_step(t_carry, draws)
        np.testing.assert_array_equal(t_carry[0].numpy(), np.asarray(j_carry[0].board))
        np.testing.assert_array_equal(t_carry[1].numpy(), np.asarray(j_carry[1]))
        np.testing.assert_allclose(t_pi.numpy(), np.asarray(j_pi), rtol=0, atol=1e-6)


def test_gumbel_arena_matches_jax():
    """An order-free MLP against the uniform model, each seat half the
    games: the same wins, losses and draws."""
    j_apply, params, p_model = _models("order_free_mlp")
    want, got = arena_both(JG, TG, j_apply, jax_uniform(JG).apply_fn, p_model,
                           make_uniform_model(TG), 6, seed=4, jax_params=(params, {}),
                           num_sims=8, max_depth=24, gumbel=True)
    assert got == want and sum(got) == 6
