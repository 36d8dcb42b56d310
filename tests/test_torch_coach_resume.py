"""The port's coach: incumbent and candidate, checkpoints and resume, on
the CPU at a small size. An unbroken run of N+M iterations equals N
iterations, a save, a resume in a new Coach and M more, bit for bit
(weights, BatchNorm statistics, Adam moments, the ring, the actor carry,
the generator, counters, records and the match graph); a rejected gate
leaves the incumbent bit-equal; the light resume of
``replay_save_stride``; SIGTERM."""

import copy
import dataclasses
import os
import signal
import subprocess
import sys
import threading

import pytest
import torch

from alphazero_tpu_torch.checkpoint import latest_step
from alphazero_tpu_torch.coach import Coach
from alphazero_tpu_torch.config import (
    ArenaConfig,
    AZConfig,
    MCTSConfig,
    ReplayConfig,
    SelfPlayConfig,
    TrainConfig,
)
from alphazero_tpu_torch.games import ConnectFour, Othello
from alphazero_tpu_torch.models import AZResNet, MLPNet
from alphazero_tpu_torch.replay import replay_total

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAME = ConnectFour()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU searches gain nothing from torch's intra-op threads,
    which would only spin beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(tmp=None, seed=0, **kw) -> AZConfig:
    arena = kw.pop("arena", {})
    return AZConfig(
        mcts=MCTSConfig(num_sims=4, max_depth=8),
        selfplay=SelfPlayConfig(batch_size=4, temp_threshold=6, **kw.pop("selfplay", {})),
        replay=ReplayConfig(capacity=1024),
        train=TrainConfig(batch_size=16, steps_per_iteration=3),
        arena=ArenaConfig(**{"num_games": 4, "update_threshold": 0.6, "num_sims": 2, **arena}),
        seed=seed,
        checkpoint_dir=str(tmp) if tmp else None,
        **kw,
    )


def make_coach(cfg, net="mlp") -> Coach:
    torch.manual_seed(cfg.seed + 1)
    if net == "resnet":
        model = AZResNet(GAME.num_actions, channels=4, blocks=1, value_hidden=8)
    else:
        model = MLPNet(GAME.num_actions, hidden=(16,))
    return Coach(GAME, model, cfg, device="cpu")


def live_state(coach: Coach) -> dict:
    inc = coach.incumbent
    state = {
        "model": inc.model.state_dict(),
        "optimizer": inc.optimizer.state_dict(),
        "step": inc.step,
        "rng": coach.rng.get_state(),
        "replay": coach.replay._asdict(),
        "counters": (coach.iteration, coach.model_id),
        "pool_matches": coach.pool_matches,
        "pool": coach.pool,
        "elo": (coach.elo.ratings, coach.elo.history),
    }
    if coach.actor_carry is not None:
        state["actor"] = coach.actor_carry._asdict()
    return state


def assert_bit_equal(a, b, where="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_bit_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bit_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.device == b.device, where
        bits = (lambda t: t.reshape(-1).view(torch.uint8)) if a.is_floating_point() else (lambda t: t)
        assert torch.equal(bits(a), bits(b)), where
    else:
        assert a == b, where


def without_times(records):
    return [{k: v for k, v in r.items() if not k.startswith("t_")} for r in records]


@pytest.mark.parametrize("kind", ["fixed_scan_resnet_anchored", "recycling_mid_episode"])
def test_resume_is_exact(tmp_path, kind):
    if kind == "recycling_mid_episode":
        kw = dict(selfplay={"recycle": True})
        net = "mlp"
    else:
        kw = dict(arena={"anchor_interval": 1, "anchor_ladder": (4,), "pool_size": 2,
                         "pool_in_checkpoint": True, "update_threshold": None})
        net = "resnet"
    unbroken = make_coach(small_cfg(tmp_path / "a", seed=3, **kw), net)
    want = without_times(unbroken.learn(2))

    first = make_coach(small_cfg(tmp_path / "b", seed=3, **kw), net)
    got = without_times(first.learn(1))
    resumed = make_coach(small_cfg(tmp_path / "b", seed=3, **kw), net)
    assert_bit_equal(live_state(resumed), live_state(first))
    if kind == "recycling_mid_episode":
        assert int(resumed.actor_carry.move_count.max()) > 0   # an episode is open
    got += without_times(resumed.learn(1))
    assert got == want
    assert_bit_equal(live_state(resumed), live_state(unbroken))
    if kind != "recycling_mid_episode":
        assert [g for g, _ in resumed.pool] == [1, 2] and len(resumed.pool_matches) > 2


def test_rejected_gate_leaves_the_incumbent_untouched(tmp_path):
    coach = make_coach(small_cfg(seed=4, arena={"update_threshold": None}), "resnet")
    coach.run_iteration()                       # adopted: the incumbent has Adam moments
    assert coach.model_id == 1 and coach.incumbent.step == 3
    before = {"model": coach.incumbent.model.state_dict(),
              "optimizer": coach.incumbent.optimizer.state_dict()}
    before = {k: {n: (t.clone() if isinstance(t, torch.Tensor) else t) for n, t in v.items()}
              for k, v in before.items()}
    before["optimizer"]["state"] = {i: {n: t.clone() for n, t in s.items()}
                                    for i, s in before["optimizer"]["state"].items()}
    coach.cfg = dataclasses.replace(coach.cfg, arena=dataclasses.replace(
        coach.cfg.arena, update_threshold=1.01))
    rec = coach.run_iteration()
    assert rec["accepted"] is False and coach.model_id == 1 and coach.incumbent.step == 3
    after = {"model": coach.incumbent.model.state_dict(),
             "optimizer": coach.incumbent.optimizer.state_dict()}
    assert_bit_equal(after, before)


def test_replay_stride_light_resume(tmp_path):
    cfg = small_cfg(tmp_path, seed=6, replay_save_stride=2)
    coach = make_coach(cfg)
    coach.run_iteration()                       # save 1: ring-bearing
    replay_after_1 = replay_total(coach.replay)
    coach.run_iteration()                       # save 2: light
    assert "replay" in torch.load(tmp_path / "ckpt_000001", weights_only=True)
    assert "replay" not in torch.load(tmp_path / "ckpt_000002", weights_only=True)
    resumed = make_coach(cfg)
    assert (resumed.iteration, resumed.model_id) == (2, coach.model_id)
    assert_bit_equal(resumed.incumbent.model.state_dict(), coach.incumbent.model.state_dict())
    assert replay_total(resumed.replay) == replay_after_1
    assert resumed.run_iteration()["iteration"] == 3


def test_light_resume_survives_a_missing_sidecar(tmp_path):
    cfg = small_cfg(tmp_path, seed=11, replay_save_stride=2)
    coach = make_coach(cfg)
    coach.run_iteration()
    replay_after_1 = replay_total(coach.replay)
    coach.run_iteration()
    os.remove(tmp_path / "ckpt_000002.json")
    resumed = make_coach(cfg)
    assert resumed.iteration == 2               # the step number stands in for the sidecar
    assert_bit_equal(resumed.incumbent.model.state_dict(), coach.incumbent.model.state_dict())
    assert replay_total(resumed.replay) == replay_after_1


def test_learn_saves_with_rings_at_its_end(tmp_path):
    cfg = small_cfg(tmp_path, seed=7, replay_save_stride=2, keep_checkpoints=1)
    coach = make_coach(cfg)
    coach.learn(2)   # save 1 rings, save 2 light (1 is protected), the final save of 2 rings
    assert "replay" in torch.load(tmp_path / "ckpt_000002", weights_only=True)
    assert sorted(n for n in os.listdir(tmp_path) if n.startswith("ckpt_")) == [
        "ckpt_000002", "ckpt_000002.json"]
    assert replay_total(make_coach(cfg).replay) == replay_total(coach.replay)


def test_sigterm_saves_and_stops(tmp_path):
    child = f"""
import logging, sys
sys.path.insert(0, {REPO!r})
sys.path.insert(0, {os.path.join(REPO, "tests")!r})
logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
import torch
torch.set_num_threads(1)
from test_torch_coach_resume import make_coach, small_cfg
coach = make_coach(small_cfg({str(tmp_path)!r}))
records = coach.learn(50)
print(f"FINISHED n={{len(records)}} iter={{coach.iteration}}")
"""
    p = subprocess.Popen([sys.executable, "-u", "-c", child], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    killer = threading.Timer(240, p.kill)
    killer.start()
    try:
        for line in p.stdout:
            if line.startswith("iter=1 "):
                p.send_signal(signal.SIGTERM)
                break
        out, _ = p.communicate(timeout=240)
    finally:
        killer.cancel()
    assert p.returncode == 0, out
    n_done = int(out.rsplit("FINISHED n=", 1)[1].split()[0])
    assert n_done < 50
    assert latest_step(str(tmp_path)) == n_done
    assert make_coach(small_cfg(tmp_path)).iteration == n_done


def test_primed_adam_steps_as_a_fresh_one():
    """The coach primes Adam's state at construction (so the checkpoint
    template has one shape); the steps that follow are bit-equal to an
    unprimed optimizer's, and so is its state."""
    from alphazero_tpu_torch.train import init_train_state, make_train_step, prime_optimizer_state

    torch.manual_seed(5)
    net = AZResNet(GAME.num_actions, channels=4, blocks=1, value_hidden=8)
    tcfg = TrainConfig(batch_size=8)
    states = [init_train_state(m, tcfg) for m in (net, copy.deepcopy(net))]
    prime_optimizer_state(states[1].optimizer)
    step = make_train_step(tcfg)
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        feats = (torch.rand((8, 6, 7, 2), generator=g) < 0.3).float()
        pi = torch.softmax(torch.randn((8, 7), generator=g), dim=-1)
        v = torch.rand(8, generator=g) * 2 - 1
        for s in states:
            step(s, feats, pi, v)
    assert_bit_equal(states[1].model.state_dict(), states[0].model.state_dict())
    assert_bit_equal(states[1].optimizer.state_dict(), states[0].optimizer.state_dict())


def test_othello_resume_is_exact(tmp_path):
    """The Othello ``full`` preset's plan at a tiny size (an AZResNet over
    64 cells, continuous mode, a warmup pass of two anchor arenas, pool
    cross matches, the pool in the checkpoint): three unbroken iterations
    equal two, a resume in a new Coach and one more, bit for bit."""
    game = Othello()

    def coach(directory):
        cfg = small_cfg(directory, seed=5, arena={
            "update_threshold": None, "anchor_interval": 1, "anchor_warmup": 1,
            "anchor_warmup_mult": 2, "pool_cross_matches": 1, "pool_in_checkpoint": True})
        cfg = dataclasses.replace(cfg, selfplay=dataclasses.replace(cfg.selfplay, batch_size=2),
                                  replay=ReplayConfig(capacity=4096),
                                  arena=dataclasses.replace(cfg.arena, num_games=2))
        torch.manual_seed(6)
        model = AZResNet(game.num_actions, channels=4, blocks=1, value_hidden=8, cells=64)
        return Coach(game, model, cfg, device="cpu")

    unbroken = coach(tmp_path / "a")
    want = without_times(unbroken.learn(3))
    first = coach(tmp_path / "b")
    got = without_times(first.learn(2))
    resumed = coach(tmp_path / "b")
    assert_bit_equal(live_state(resumed), live_state(first))
    got += without_times(resumed.learn(1))
    assert got == want
    assert_bit_equal(live_state(resumed), live_state(unbroken))
    assert [(m["a"], m["b"]) for m in resumed.pool_matches][-1] == (1, 2)   # the cross match
    assert all(r["replay_total"] % 8 == 0 for r in got)
