"""Reanalyze (``alphazero_tpu_torch/reanalyze.py``) and ``record_states``
against the JAX package, and reanalyze in the port's coach.

``position_insert`` writes the same ring as the JAX one (stride 1 and 2,
the iteration stamp, the wrap); a reanalyze pass over equal rings with
JAX's row indices (``randint(k_idx, [R], 0, max(size, 1))``) and Gumbel
sample (``gumbel(k_search, [R, A])``) injected gives JAX's trajectory,
count and age, with PUCT (normalised counts, the fused route) and with
Gumbel search (its improved policy, within 1e-6); an empty ring masks
every row. ``record_states`` returns the JAX scan's root states and leaves
the trajectory bit-equal. The coach on the Connect-Four ``smoke`` preset
with reanalyze records ``reanalyzed`` and ``reanalyze_age_mean`` in the
JAX coach's key order, saves the position ring in a whole checkpoint and
not in a light one, and resumes bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu import reanalyze as jax_rz
from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.config import ReanalyzeConfig as JaxReanalyzeConfig
from alphazero_tpu.config import SelfPlayConfig as JaxSelfPlayConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu.selfplay import make_selfplay_fn as jax_selfplay
from alphazero_tpu_torch.coach import Coach
from alphazero_tpu_torch.config import MCTSConfig, ReanalyzeConfig, SelfPlayConfig
from alphazero_tpu_torch.examples import train_connect_four
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.models import make_uniform_model
from alphazero_tpu_torch.reanalyze import make_reanalyze_fn, position_init, position_insert
from alphazero_tpu_torch.selfplay import make_selfplay_fn
from tests.test_torch_coach_resume import assert_bit_equal, without_times
from tests.torch_parity import jax_scan_draws, port_az_config, random_boards

JG, TG = JaxConnectFour(), ConnectFour()
A = TG.num_actions


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorded(T, B, seed):
    """``(boards int8[T, B, 6, 7], value f32[T, B])`` of random positions."""
    boards = random_boards(T * B, 3 + seed % 5, seed=seed).reshape(T, B, 6, 7)
    value = np.random.default_rng(seed).choice([-1.0, 0.0, 1.0], (T, B)).astype(np.float32)
    return boards, value


def _insert_both(j_store, t_store, boards, value, valid, iteration, stride):
    j_store = jax_rz.position_insert(j_store, _jax_states(boards), jnp.asarray(value),
                                     jnp.asarray(valid), iteration, stride=stride)
    t_store = position_insert(t_store, torch.as_tensor(boards), torch.as_tensor(value),
                              torch.as_tensor(valid), iteration, stride=stride)
    return j_store, t_store


def _jax_states(boards):
    from alphazero_tpu.games.connect_four import ConnectFourState

    return ConnectFourState(board=jnp.asarray(boards))


def _assert_same_store(j_store, t_store):
    np.testing.assert_array_equal(t_store.states.numpy(), np.asarray(j_store.states.board))
    np.testing.assert_array_equal(t_store.value.numpy(), np.asarray(j_store.value))
    np.testing.assert_array_equal(t_store.born.numpy(), np.asarray(j_store.born))
    assert (t_store.pos, t_store.size) == (int(j_store.pos), int(j_store.size))


@pytest.mark.parametrize("stride", [1, 2])
def test_position_insert_matches_jax(stride):
    """Two inserts into an 8-slot ring: the second wraps."""
    j_store, t_store = jax_rz.position_init(JG, 8), position_init(TG, 8, device="cpu")
    _assert_same_store(j_store, t_store)
    for i, seed in enumerate((1, 2)):
        boards, value = _recorded(2, 3, seed)
        valid = np.array([[1, 1, 1], [1, 0, 1]], bool) if i == 0 else np.ones((2, 3), bool)
        j_store, t_store = _insert_both(j_store, t_store, boards, value, valid, 3 + i, stride)
        _assert_same_store(j_store, t_store)
    assert t_store.size == (8 if stride == 1 else 6)


def _stores(n=20, cap=16):
    """Equal rings of ``cap`` slots holding ``n`` random positions
    (stamped at iteration 1), so the ring has wrapped."""
    boards, value = _recorded(2, n // 2, 7)
    valid = np.ones((2, n // 2), bool)
    return _insert_both(jax_rz.position_init(JG, cap), position_init(TG, cap, device="cpu"),
                        boards, value, valid, 1, 1)


@pytest.mark.parametrize("gumbel", [False, True], ids=["puct", "gumbel"])
def test_reanalyze_pass_matches_jax(gumbel):
    R = 12
    kw = dict(num_sims=16, max_depth=24, gumbel=gumbel, dirichlet_alpha=None if gumbel else 1.0)
    j_store, t_store = _stores()
    key = jax.random.key(9)
    j_fn = jax.jit(jax_rz.make_reanalyze_fn(JG, jax_uniform(JG).apply_fn, JaxMCTSConfig(**kw),
                                            JaxReanalyzeConfig(batch_size=R, capacity=16)))
    j_traj, j_num, j_age = j_fn({}, j_store, key, 4)
    k_idx, k_search = jax.random.split(key)
    idx = torch.as_tensor(np.array(jax.random.randint(k_idx, (R,), 0, max(t_store.size, 1)))).long()
    g = torch.as_tensor(np.array(jax.random.gumbel(k_search, (R, A)))) if gumbel else None
    fn = make_reanalyze_fn(TG, MCTSConfig(**kw), ReanalyzeConfig(batch_size=R, capacity=16))
    traj, num, age = fn(make_uniform_model(TG), t_store, idx, g, iteration=4)
    for name in ("features", "value", "valid"):
        np.testing.assert_array_equal(getattr(traj, name).numpy(),
                                      np.asarray(getattr(j_traj, name)), err_msg=name)
    np.testing.assert_allclose(traj.pi.numpy(), np.asarray(j_traj.pi), rtol=0, atol=1e-6)
    assert traj.pi.shape == (1, R, A) and (num, age) == (int(j_num), float(j_age)) == (R, 3.0)
    torch.testing.assert_close(traj.pi.sum(-1), torch.ones(1, R))


def test_empty_store_rows_masked():
    fn = make_reanalyze_fn(TG, MCTSConfig(num_sims=4, max_depth=8),
                           ReanalyzeConfig(batch_size=4, capacity=8))
    traj, num, age = fn(make_uniform_model(TG), position_init(TG, 8, device="cpu"),
                        torch.zeros(4, dtype=torch.long))
    assert num == 0 and age == 0.0 and not traj.valid.any() and (traj.value == 0).all()


def test_record_states_matches_jax_and_leaves_the_trajectory():
    jm = JaxMCTSConfig(num_sims=8, max_depth=12, dirichlet_alpha=1.0)
    js = JaxSelfPlayConfig(batch_size=4, temp_threshold=4)
    key = jax.random.key(7)
    _, _, j_states = jax.jit(jax_selfplay(JG, jax_uniform(JG).apply_fn, jm, js,
                                          record_states=True))({}, key)
    draws = jax_scan_draws(key, TG.max_moves, 4, A, 1.0)
    cfg, sp = MCTSConfig(**dataclasses.asdict(jm)), SelfPlayConfig(**dataclasses.asdict(js))
    base = make_selfplay_fn(TG, cfg, sp, device="cpu")(make_uniform_model(TG), lambda t: draws[t])
    traj, stats, states = make_selfplay_fn(TG, cfg, sp, device="cpu", record_states=True)(
        make_uniform_model(TG), lambda t: draws[t])
    assert_bit_equal(traj._asdict(), base[0]._asdict())
    assert_bit_equal(stats._asdict(), base[1]._asdict())
    np.testing.assert_array_equal(states.numpy(), np.asarray(j_states.board))
    assert torch.equal(TG.to_features(states.reshape(-1, 6, 7)).reshape(traj.features.shape),
                       traj.features)


def _smoke_cfg(tmp=None, gumbel=False, **kw):
    """The ``smoke`` preset at a test's size, with reanalyze."""
    model, cfg = train_connect_four.preset("smoke", seed=2,
                                           checkpoint_dir=str(tmp) if tmp else None)
    mcts = dataclasses.replace(cfg.mcts, num_sims=8, gumbel=gumbel)
    cfg = dataclasses.replace(
        cfg, mcts=mcts, selfplay=dataclasses.replace(cfg.selfplay, batch_size=6),
        arena=dataclasses.replace(cfg.arena, num_games=4, num_sims=4),
        train=dataclasses.replace(cfg.train, batch_size=16, steps_per_iteration=3),
        reanalyze=ReanalyzeConfig(batch_size=8, capacity=cfg.replay.capacity // 2), **kw)
    return model, cfg


def _coach(tmp=None, **kw):
    model, cfg = _smoke_cfg(tmp, **kw)
    return Coach(TG, model, cfg, device="cpu")


def _state(coach):
    return {"model": coach.incumbent.model.state_dict(),
            "optimizer": coach.incumbent.optimizer.state_dict(), "rng": coach.rng.get_state(),
            "replay": coach.replay._asdict(), "positions": coach.positions._asdict(),
            "counters": (coach.iteration, coach.model_id)}


def test_coach_records_and_whole_checkpoint_resume(tmp_path):
    unbroken = _coach(tmp_path / "a")
    want = without_times(unbroken.learn(2))
    first = _coach(tmp_path / "b")
    got = without_times(first.learn(1))
    ckpt = torch.load(tmp_path / "b" / "ckpt_000001", weights_only=True)
    assert ckpt["positions"]["size"] == first.positions.size > 0
    resumed = _coach(tmp_path / "b")
    assert_bit_equal(_state(resumed), _state(first))
    got += without_times(resumed.learn(1))
    assert got == want
    assert_bit_equal(_state(resumed), _state(unbroken))
    for i, r in enumerate(want):
        # positions stamped at iterations 0..i, refreshed at iteration i
        assert r["reanalyzed"] == 8 and 0.0 <= r["reanalyze_age_mean"] <= i
        # every game finishes; each sample and each refreshed row enters the
        # ring twice (two symmetries)
        assert r["selfplay_truncated"] == 0
        assert r["replay_total"] == 2 * sum(x["selfplay_moves"] + 8 for x in want[: i + 1])


def test_coach_light_checkpoint_takes_the_rings_from_the_ring_step(tmp_path):
    coach = _coach(tmp_path, replay_save_stride=2)
    coach.run_iteration()
    positions_1 = {k: (v.clone() if torch.is_tensor(v) else v)
                   for k, v in coach.positions._asdict().items()}
    coach.run_iteration()
    assert "positions" in torch.load(tmp_path / "ckpt_000001", weights_only=True)
    assert "positions" not in torch.load(tmp_path / "ckpt_000002", weights_only=True)
    resumed = _coach(tmp_path, replay_save_stride=2)
    assert resumed.iteration == 2
    assert_bit_equal(resumed.positions._asdict(), positions_1)
    assert resumed.run_iteration()["iteration"] == 3


def test_gumbel_coach_record_keys_match_jax():
    """One iteration of each package's coach with Gumbel search (the gate
    arena Gumbel too) and reanalyze: the same record keys in the same
    order, and every refreshed row counted."""
    from alphazero_tpu.coach import Coach as JaxCoach
    from alphazero_tpu.models import MLPNet as JaxMLPNet

    model, cfg = _smoke_cfg(gumbel=True)
    jcfg = _jax_cfg(cfg)
    j_rec = JaxCoach(JG, JaxMLPNet(num_actions=A, hidden=(64,)), jcfg).run_iteration()
    coach = Coach(TG, model, port_az_config(jcfg), device="cpu")
    rec = coach.run_iteration()
    assert list(rec) == list(j_rec)
    assert rec["reanalyzed"] == j_rec["reanalyzed"] == 8
    assert rec["selfplay_truncated"] == 0 and rec["replay_total"] == 2 * (
        rec["selfplay_moves"] + 8)


def _jax_cfg(cfg):
    from alphazero_tpu import config as C

    return C.AZConfig(**{
        f.name: (getattr(C, type(getattr(cfg, f.name)).__name__)(
            **dataclasses.asdict(getattr(cfg, f.name)))
                 if dataclasses.is_dataclass(getattr(cfg, f.name)) else getattr(cfg, f.name))
        for f in dataclasses.fields(cfg)})
