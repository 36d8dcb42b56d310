"""The port's replay ring against the JAX package's: the same trajectory
inserted into rings of the same capacity gives the same packed rows,
write position, live size and lifetime total (a second insert wrapping
past the capacity), and the same row indices sample the same
(features, pi, value). Trajectories come from the JAX fixed scan and,
for every game's symmetries, from seeded numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu import games as jax_games
from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.config import ReplayConfig as JaxReplayConfig
from alphazero_tpu.config import SelfPlayConfig as JaxSelfPlayConfig
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu.replay import replay_init as jax_replay_init
from alphazero_tpu.replay import replay_insert as jax_replay_insert
from alphazero_tpu.replay import replay_sample as jax_replay_sample
from alphazero_tpu.replay import replay_total as jax_replay_total
from alphazero_tpu.selfplay import Trajectory as JaxTrajectory
from alphazero_tpu.selfplay import make_selfplay_fn as jax_selfplay
from alphazero_tpu_torch import games as port_games
from alphazero_tpu_torch.config import ReplayConfig
from alphazero_tpu_torch.replay import (
    replay_init,
    replay_insert,
    replay_sample,
    replay_total,
    replay_unpack,
)
from alphazero_tpu_torch.selfplay import Trajectory

GAMES = {
    "connect_four": lambda pkg: pkg.ConnectFour(),
    "othello": lambda pkg: pkg.Othello(),
    "gomoku7": lambda pkg: pkg.Gomoku(7, 4),
    "hex": lambda pkg: pkg.Hex(),
}


def _random_traj(game, T: int, B: int, seed: int) -> Trajectory:
    rng = np.random.default_rng(seed)
    feats = (rng.random((T, B, *game.feature_shape)) < 0.3).astype(np.float32)
    pi = rng.random((T, B, game.num_actions)).astype(np.float32)
    value = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (T, B))
    valid = rng.random((T, B)) < 0.6
    return Trajectory(*(torch.as_tensor(x) for x in (feats, pi, value * valid, valid)))


def _jax_traj(traj: Trajectory) -> JaxTrajectory:
    return JaxTrajectory(*(jnp.asarray(x.numpy()) for x in traj))


def _torch_traj(traj: JaxTrajectory) -> Trajectory:
    return Trajectory(*(torch.as_tensor(np.array(x)) for x in traj))


def _assert_rings_equal(jr, tr, what):
    np.testing.assert_array_equal(np.asarray(jr.data), tr.data.numpy(), err_msg=what)
    assert (int(jr.pos), int(jr.size), jax_replay_total(jr)) == (tr.pos, tr.size, replay_total(tr)), what


def _insert_both(jg, tg, trajs, cap):
    jr = jax_replay_init(jg, JaxReplayConfig(capacity=cap))
    tr = replay_init(tg, ReplayConfig(capacity=cap), device="cpu")
    for i, traj in enumerate(trajs):
        jr = jax_replay_insert(jr, jg, _jax_traj(traj))
        tr = replay_insert(tr, tg, traj)
        _assert_rings_equal(jr, tr, f"insert {i}")
    return jr, tr


def test_insert_and_sample_match_jax_on_a_selfplay_trajectory():
    """A JAX fixed-scan trajectory (Connect-Four, 8 games) inserted twice
    into a ring that the second insert wraps; then samples at the JAX
    sampler's own indices."""
    jg, tg = jax_games.ConnectFour(), port_games.ConnectFour()
    jm = JaxMCTSConfig(num_sims=4, max_depth=48)
    js = JaxSelfPlayConfig(batch_size=8, temp_threshold=6)
    j_traj, _ = jax.jit(jax_selfplay(jg, jax_uniform(jg).apply_fn, jm, js))({}, jax.random.key(5))
    traj = _torch_traj(j_traj)
    n_rows = 2 * int(traj.valid.sum())   # an insert's rows: 2 symmetries
    cap = n_rows * 3 // 2     # the second insert wraps, the first does not
    jr, tr = _insert_both(jg, tg, [traj, traj], cap)
    assert tr.size == cap and tr.pos == 2 * n_rows - cap and replay_total(tr) == 2 * n_rows

    key = jax.random.key(9)
    j_out = jax_replay_sample(jr, key, 64, jg)
    idx = jax.random.randint(key, (64,), 0, jnp.maximum(jr.size, 1))
    t_out = replay_sample(tr, 64, tg, idx=torch.as_tensor(np.array(idx)).long())
    for j, t in zip(j_out, t_out):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    f, p, v = replay_unpack(tr, tg)
    assert f.shape == (cap, 6, 7, 2) and p.shape == (cap, 7) and v.shape == (cap,)


@pytest.mark.parametrize("name", sorted(GAMES))
def test_insert_matches_jax_through_each_games_symmetries(name):
    jg, tg = GAMES[name](jax_games), GAMES[name](port_games)
    trajs = [_random_traj(tg, 5, 6, seed=s) for s in (1, 2, 3)]
    rows = sum(tg.num_symmetries * int(t.valid.sum()) for t in trajs)
    _insert_both(jg, tg, trajs, cap=rows - 7)


@pytest.mark.parametrize("name", sorted(GAMES))
def test_insert_of_no_valid_sample_matches_jax(name):
    """A call whose games were all cut by the scan's length has no valid
    sample: the insert leaves the ring as it was, as the JAX one does."""
    jg, tg = GAMES[name](jax_games), GAMES[name](port_games)
    first = _random_traj(tg, 3, 4, seed=7)
    empty = _random_traj(tg, 3, 4, seed=8)
    empty = empty._replace(valid=torch.zeros_like(empty.valid), value=torch.zeros_like(empty.value))
    _insert_both(jg, tg, [empty, first, empty], cap=64)


def test_sample_draws_uniformly_from_the_live_region():
    tg = port_games.ConnectFour()
    tr = replay_init(tg, ReplayConfig(capacity=64), device="cpu")
    gen = torch.Generator().manual_seed(0)
    f, p, v = replay_sample(tr, 8, tg, gen)   # empty ring: row 0
    assert f.shape == (8, 6, 7, 2) and not f.any()
    tr = replay_insert(tr, tg, _random_traj(tg, 3, 4, seed=4))
    idx = torch.randint(0, tr.size, (4096,), generator=torch.Generator().manual_seed(1))
    f, p, v = replay_sample(tr, 4096, tg, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(v.numpy(), tr.data[idx, -1].numpy())
    assert idx.max() == tr.size - 1 and idx.min() == 0


def test_insert_past_capacity_keeps_the_newest_rows():
    """More rows than the ring holds: the ring ends as if they had been
    written one by one (the last ``Cap`` rows, each at its slot)."""
    tg = port_games.ConnectFour()
    traj = _random_traj(tg, 6, 5, seed=6)
    big = replay_insert(replay_init(tg, ReplayConfig(capacity=1000), device="cpu"), tg, traj)
    n = big.size
    cap = n // 3
    ring = replay_init(tg, ReplayConfig(capacity=cap), device="cpu")
    ring = ring._replace(pos=5)
    out = replay_insert(ring, tg, traj)
    want = torch.zeros_like(out.data)
    for i in range(n):
        want[(5 + i) % cap] = big.data[i]
    torch.testing.assert_close(out.data, want, rtol=0, atol=0)
    assert (out.pos, out.size, out.total) == ((5 + n) % cap, cap, n)
