"""The port's coach (``alphazero_tpu_torch.coach``) against the JAX coach
on the CPU, on ``tests/test_coach.py``'s ``tiny_cfg`` with the anchored
pass on (continuous mode, a ladder rung, a warmup pass, pool cross
matches): the record's keys, and the anchored match graph's players in
order with their game totals. The two packages draw different random
numbers, so wins differ; the structure may not. The JAX coach runs once,
in a module fixture.

Also: ``_pool_insert``'s eviction against the JAX one over seeded
sequences, and the one intended difference, the ladder rung's retirement
(ROADMAP queue 3, "ADVICE low, coach.py:950")."""

import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu import config as jax_config
from alphazero_tpu.arena import ArenaResult as JaxArenaResult
from alphazero_tpu.coach import Coach as JaxCoach
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu_torch import config as port_config
from alphazero_tpu_torch.arena import ArenaResult
from alphazero_tpu_torch.coach import Coach
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.models import MLPNet
from test_coach import tiny_cfg

ITERATIONS = 3
ARENA = dict(num_games=4, update_threshold=None, num_sims=4, anchor_interval=1,
             anchor_ladder=(8,), pool_cross_matches=1, anchor_warmup=1,
             anchor_warmup_mult=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU searches gain nothing from torch's intra-op threads,
    which would only spin beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg) -> port_config.AZConfig:
    """The port's copy of a JAX ``AZConfig``."""
    sub = {f.name: getattr(port_config, type(getattr(jcfg, f.name)).__name__)(
        **dataclasses.asdict(getattr(jcfg, f.name)))
        for f in dataclasses.fields(jcfg) if dataclasses.is_dataclass(getattr(jcfg, f.name))}
    rest = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name not in sub}
    return port_config.AZConfig(**sub, **rest)


def anchored_cfg():
    return dataclasses.replace(tiny_cfg(seed=0), arena=jax_config.ArenaConfig(**ARENA))


@pytest.fixture(scope="module")
def jax_run():
    game = JaxConnectFour()
    coach = JaxCoach(game, JaxMLPNet(num_actions=game.num_actions, hidden=(32,)), anchored_cfg())
    records = [coach.run_iteration() for _ in range(ITERATIONS)]
    return types.SimpleNamespace(coach=coach, records=records,
                                 pool_matches=[dict(m) for m in coach.pool_matches])


@pytest.fixture(scope="module")
def port_run():
    game = ConnectFour()
    torch.manual_seed(0)
    coach = Coach(game, MLPNet(game.num_actions, hidden=(32,)), port_cfg(anchored_cfg()),
                  device="cpu")
    records = [coach.run_iteration() for _ in range(ITERATIONS)]
    return types.SimpleNamespace(coach=coach, records=records,
                                 pool_matches=[dict(m) for m in coach.pool_matches])


def test_record_keys_equal_jax(jax_run, port_run):
    assert [list(r) for r in port_run.records] == [list(r) for r in jax_run.records]
    for r in port_run.records:
        assert np.isfinite(r["loss_last"]) and np.isfinite(r["anchored_elo"])
        assert r["anchored_elo_se"] > 0
        assert r["eval_folded"] is False


def test_continuous_mode_always_adopts(jax_run, port_run):
    assert [r["accepted"] for r in port_run.records] == [True] * ITERATIONS
    assert [r["model_id"] for r in port_run.records] == list(range(1, ITERATIONS + 1))
    assert port_run.coach.elo.ratings.keys() == jax_run.coach.elo.ratings.keys()


def test_anchored_match_graph_structure_equals_jax(jax_run, port_run):
    """Players in order, and each match's game total: warmup reps, the
    one-time chain calibration, the rungs, the pool and the cross match."""
    def shape(ms):
        return [(m["a"], m["b"], m["wins_a"] + m["wins_b"] + m["draws"]) for m in ms]

    assert shape(port_run.pool_matches) == shape(jax_run.pool_matches)
    games = ARENA["num_games"]
    assert shape(port_run.pool_matches)[:3] == [
        (1, "anchor", 2 * games), ("anchor", "anchor@8", 2 * games), (1, "anchor@8", 2 * games)]
    assert (1, 2, games) in shape(port_run.pool_matches)   # the cross match of pass 3
    assert port_run.coach.anchored_ratings.keys() == jax_run.coach.anchored_ratings.keys()
    assert port_run.coach.anchored_ratings["anchor"] == 0.0
    assert [g for g, _ in port_run.coach.pool] == [g for g, _ in jax_run.coach.pool]


@pytest.mark.parametrize("pool_size", [1, 3, 5])
def test_pool_insert_keeps_the_jax_generations(pool_size):
    rng = np.random.default_rng(pool_size)
    for _ in range(4):
        cfg = types.SimpleNamespace(arena=types.SimpleNamespace(pool_size=pool_size))
        jc = types.SimpleNamespace(pool=[], cfg=cfg)
        pc = types.SimpleNamespace(pool=[], cfg=cfg)
        gen = 0
        for _ in range(30):
            gen = gen if rng.random() < 0.15 else gen + int(rng.integers(1, 4))
            JaxCoach._pool_insert(jc, gen, {})
            Coach._pool_insert(pc, gen, {})
            assert [g for g, _ in pc.pool] == [g for g, _ in jc.pool]


def _own_copy(coach):
    """A shallow copy of a module fixture's coach whose state that the
    anchored pass changes in place (its timer, the port's generator) is
    its own, so that the fixture stays as its run left it."""
    c = copy.copy(coach)
    c.timer = type(coach.timer)()
    if isinstance(getattr(coach, "rng", None), torch.Generator):
        c.rng = torch.Generator()
        c.rng.set_state(coach.rng.get_state())
    return c


@pytest.mark.parametrize("sweepers, jax_plays, port_plays", [
    ((3, 4), False, True),    # two other generations swept the rung
    ((5, 5), False, False),   # the incumbent itself swept it twice
    ((4, 5), False, True),
    ((5, 6), True, True),     # a control: 5 lost its match, 6 swept once; neither retires
])
def test_rung_retirement_counts_only_the_incumbents_matches(jax_run, port_run, sweepers,
                                                            jax_plays, port_plays):
    """The incumbent is generation 5. Each generation in ``sweepers``
    swept "anchor@8" (no loss, no draw) in one match against it, in that
    order. The JAX coach retires the rung once the last two matches
    against it, by any generations, are sweeps; the port once the
    incumbent's own last two are."""
    history = [{"a": "anchor", "b": "anchor@8", "wins_a": 1, "wins_b": 7, "draws": 0}]
    if sweepers == (5, 6):
        history.append({"a": 5, "b": "anchor@8", "wins_a": 1, "wins_b": 3, "draws": 0})
        sweepers = (6,)
    history += [{"a": g, "b": "anchor@8", "wins_a": 4, "wins_b": 0, "draws": 0} for g in sweepers]

    def jax_stub(*args):
        return JaxArenaResult(jnp.int32(3), jnp.int32(1), jnp.int32(0), jnp.int32(0))

    def port_stub(*args):
        return ArenaResult(3, 1, 0, 0)

    for coach, stub, plays in ((_own_copy(jax_run.coach), jax_stub, jax_plays),
                               (_own_copy(port_run.coach), port_stub, port_plays)):
        coach.model_id, coach.iteration = 5, 10
        coach.pool = []
        coach.pool_matches = [dict(m) for m in history]
        coach._anchor_arena = stub
        coach._rung_arenas = {k: stub for k in coach._rung_arenas}
        coach._anchored_rating_pass()
        added = [(m["a"], m["b"]) for m in coach.pool_matches[len(history):]]
        assert added == [(5, "anchor")] + ([(5, "anchor@8")] if plays else [])


def test_unported_options_raise():
    game = ConnectFour()
    cfg = port_cfg(tiny_cfg())
    # a mesh is ported (tests/test_torch_parallel.py): the coach takes a
    # parallel.Mesh and nothing else
    with pytest.raises(TypeError, match="parallel.make_mesh"):
        Coach(game, MLPNet(7, hidden=(8,)), cfg, mesh=object(), device="cpu")
    # reanalyze is ported (tests/test_torch_reanalyze.py): the coach records
    # root states into a position ring of the configured capacity
    rz = dataclasses.replace(cfg, reanalyze=port_config.ReanalyzeConfig(capacity=64))
    coach = Coach(game, MLPNet(7, hidden=(8,)), rz, device="cpu")
    assert coach.positions.states.shape == (64, 6, 7) and coach.positions.size == 0
    rz_rec = dataclasses.replace(rz, selfplay=dataclasses.replace(cfg.selfplay, recycle=True))
    with pytest.raises(ValueError, match="incompatible with reanalyze"):
        Coach(game, MLPNet(7, hidden=(8,)), rz_rec, device="cpu")
    assert jax.default_backend() == "cpu"
