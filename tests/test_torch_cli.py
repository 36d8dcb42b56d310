"""The port's training CLI (``alphazero_tpu_torch.examples.train_connect_four``):
the presets hold the reference CLI's values (the ``convnet`` preset's
``AZConvNet`` too, and the ``economy`` preset's Gumbel search), the
``--gumbel`` and ``--reanalyze`` overrides set what the JAX CLI sets, and
a smoke run on the CPU trains, saves and resumes."""

import json

import pytest
import torch

from alphazero_tpu_torch.examples import train_connect_four as cli
from alphazero_tpu_torch.models import AZResNet, MLPNet


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU searches gain nothing from torch's intra-op threads,
    which would only spin beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_full_preset_is_the_reference_flagship():
    model, cfg = cli.preset("full", seed=3, checkpoint_dir="d")
    assert isinstance(model, AZResNet) and len(model.blocks) == 5
    assert model.stem.out_channels == 64 and str(model.dtype) == "torch.bfloat16"
    assert (cfg.mcts.num_sims, cfg.mcts.max_depth, cfg.mcts.dirichlet_alpha) == (100, 48, 1.0)
    assert (cfg.selfplay.batch_size, cfg.selfplay.temp_threshold, cfg.selfplay.recycle) == (4096, 15, True)
    assert cfg.replay.capacity == 1 << 21
    assert (cfg.train.batch_size, cfg.train.steps_per_iteration) == (1024, 512)
    a = cfg.arena
    assert (a.num_games, a.update_threshold, a.num_sims, a.anchor_interval) == (256, 0.55, 50, 5)
    assert (a.anchor_warmup, a.anchor_warmup_mult, a.pool_cross_matches) == (6, 4, 2)
    assert a.anchor_ladder == (400, 1600)
    assert (cfg.num_iterations, cfg.seed, cfg.checkpoint_dir) == (50, 3, "d")


def test_mlp_and_smoke_presets():
    model, cfg = cli.preset("mlp")
    assert isinstance(model, MLPNet) and model.hidden == (256, 256)
    assert (cfg.mcts.num_sims, cfg.selfplay.batch_size, cfg.replay.capacity) == (50, 512, 1 << 17)
    assert (cfg.train.batch_size, cfg.train.steps_per_iteration) == (512, 128)
    assert (cfg.arena.num_games, cfg.arena.num_sims, cfg.arena.anchor_interval) == (128, 25, 2)
    model, cfg = cli.preset("smoke")
    assert model.hidden == (64,) and (cfg.mcts.num_sims, cfg.selfplay.batch_size) == (16, 16)
    assert cfg.num_iterations == 3


def test_convnet_preset_is_the_reference_parity_net():
    """The ``convnet`` preset, refused until ``AZConvNet`` was ported: the
    reference CLI's values (``tests/test_torch_cli_games.py`` holds every
    preset against the JAX CLI's itself)."""
    from alphazero_tpu_torch.models import AZConvNet

    model, cfg = cli.preset("convnet", seed=2, checkpoint_dir="d")
    assert isinstance(model, AZConvNet) and model.board == (6, 7) and model.dropout == 0.3
    assert model.convs[0].out_channels == 512 and str(model.dtype) == "torch.bfloat16"
    assert (cfg.mcts.num_sims, cfg.mcts.max_depth, cfg.mcts.dirichlet_alpha) == (50, 48, 1.0)
    assert (cfg.selfplay.batch_size, cfg.selfplay.recycle) == (1024, False)
    assert cfg.replay.capacity == 1 << 18
    assert (cfg.train.batch_size, cfg.train.steps_per_iteration) == (512, 256)
    a = cfg.arena
    assert (a.num_games, a.update_threshold, a.num_sims, a.anchor_interval) == (128, 0.55, 25, 3)
    assert (cfg.num_iterations, cfg.seed, cfg.checkpoint_dir) == (10, 2, "d")


class _Stop(Exception):
    pass


@pytest.mark.parametrize("argv, item", [
    (["--preset", "economy"], "economy"),
    (["--gumbel", "8"], "gumbel"),
    (["--reanalyze", "64"], "reanalyze"),
])
def test_unported_options_raise(argv, item, monkeypatch):
    """Once refused, these run now: the config the CLI hands the coach
    holds the JAX CLI's values (tests/test_torch_cli_games.py holds them
    against its ``main()`` too)."""
    import alphazero_tpu_torch.coach

    got = {}

    def stub(game, model, cfg, *args, **kwargs):
        got.update(model=model, cfg=cfg)
        raise _Stop

    monkeypatch.setattr(alphazero_tpu_torch.coach, "Coach", stub)
    with pytest.raises(_Stop):
        cli.main(argv + ["--cpu"])
    cfg, model = got["cfg"], got["model"]
    if item == "economy":
        assert isinstance(model, AZResNet) and len(model.blocks) == 5
        assert model.stem.out_channels == 64 and str(model.dtype) == "torch.bfloat16"
        m = cfg.mcts
        assert (m.num_sims, m.max_depth, m.gumbel, m.dirichlet_alpha) == (32, 48, True, None)
        assert (cfg.selfplay.batch_size, cfg.selfplay.temp_threshold, cfg.selfplay.recycle) == (
            4096, 15, False)
        assert cfg.replay.capacity == 1 << 20 and cfg.reanalyze is None
        assert (cfg.train.batch_size, cfg.train.steps_per_iteration) == (1024, 512)
        a = cfg.arena
        assert (a.num_games, a.update_threshold, a.num_sims, a.anchor_interval) == (256, 0.55, 50, 5)
        assert (a.anchor_warmup, a.anchor_warmup_mult, a.pool_cross_matches) == (6, 4, 2)
        assert a.anchor_ladder == (400, 1600)
        assert (cfg.num_iterations, cfg.checkpoint_interval, cfg.keep_checkpoints) == (50, 5, 4)
    elif item == "gumbel":
        m = cfg.mcts
        assert (m.gumbel, m.num_sims, m.dirichlet_alpha, m.parallel_sims) == (True, 8, None, 1)
    else:
        rz = cfg.reanalyze
        assert (rz.batch_size, rz.capacity, rz.interval, rz.record_stride) == (
            64, cfg.replay.capacity // 2, 1, 1)


def test_smoke_run_trains_saves_and_resumes(tmp_path, capsys, monkeypatch):
    real = cli.preset

    def smaller(name, seed=0, checkpoint_dir=None):
        import dataclasses

        model, cfg = real(name, seed, checkpoint_dir)
        return model, dataclasses.replace(
            cfg, mcts=dataclasses.replace(cfg.mcts, num_sims=4, max_depth=8),
            selfplay=dataclasses.replace(cfg.selfplay, batch_size=4),
            arena=dataclasses.replace(cfg.arena, num_games=4, num_sims=2))

    monkeypatch.setattr(cli, "preset", smaller)
    args = ["--cpu", "--checkpoint-dir", str(tmp_path), "--replay-capacity", "512", "--recycle"]
    assert cli.main(args + ["--iterations", "1"]) == 0
    assert "done: iterations=1 " in capsys.readouterr().out
    assert cli.main(args + ["--iterations", "1"]) == 0
    assert "done: iterations=2 " in capsys.readouterr().out
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in lines] == [1, 2]
    assert lines[1]["replay_size"] <= 512 and lines[0]["selfplay_moves"] == 4 * 42
