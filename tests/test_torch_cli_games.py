"""The port's training CLIs of every game (``alphazero_tpu_torch.examples.
train_connect_four``, ``train_othello``, ``train_gomoku``, ``train_hex``)
and ``eval_checkpoints``, against the JAX CLIs of ``examples/``.

Each preset equals the JAX CLI's: both ``main()``s run on the same
arguments with their package's ``Coach`` replaced by a stub that captures
``(game, model, cfg)`` and stops, so the reference scripts run unedited;
the configs must be equal field for field and the models of one kind and
widths (the Connect-Four ``economy`` preset and the ``--gumbel`` and
``--reanalyze`` overrides of every CLI too). Smoke runs train, save and
resume on the CPU; Gomoku boards past the card's descend raise and cite
their ROADMAP item. ``eval_checkpoints`` prints the JAX
tool's JSON line (the same keys, score and Elo difference for the same
match result), and pits two port checkpoints, or one against pure MCTS."""

import dataclasses
import importlib.util
import json
import os
import sys

import pytest
import torch

import alphazero_tpu.arena
import alphazero_tpu.coach
import alphazero_tpu_torch.arena
import alphazero_tpu_torch.coach
from alphazero_tpu_torch.arena import ArenaResult
from alphazero_tpu_torch.config import (
    ArenaConfig,
    AZConfig,
    MCTSConfig,
    ReplayConfig,
    SelfPlayConfig,
    TrainConfig,
)
from alphazero_tpu_torch.examples import (
    eval_checkpoints,
    train_connect_four,
    train_gomoku,
    train_hex,
    train_othello,
)
from alphazero_tpu_torch.games import Othello
from alphazero_tpu_torch.models import AZResNet, MLPNet
from tests.torch_parity import port_az_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {"connect_four": train_connect_four, "othello": train_othello, "gomoku": train_gomoku,
        "hex": train_hex}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Stop(Exception):
    pass


def _capture(monkeypatch, module, name: str) -> dict:
    """Replace ``module.Coach`` by a stub that records its arguments."""
    got = {}

    def stub(game, model, cfg, *args, **kwargs):
        got.update(game=game, model=model, cfg=cfg)
        raise _Stop

    monkeypatch.setattr(module, name, stub)
    return got


def _load_jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_cli(monkeypatch, script: str, argv: list) -> dict:
    got = _capture(monkeypatch, alphazero_tpu.coach, "Coach")
    monkeypatch.setattr(sys, "argv", [script] + argv)
    with pytest.raises(_Stop):
        _load_jax_script(script).main()
    return got


def _port_cli(monkeypatch, game: str, argv: list) -> dict:
    got = _capture(monkeypatch, alphazero_tpu_torch.coach, "Coach")
    with pytest.raises(_Stop):
        PORT[game].main(argv + ["--cpu"])
    return got


def _jax_model(model) -> tuple:
    kind = type(model).__name__
    dt = str(model.dtype.dtype if hasattr(model.dtype, "dtype") else model.dtype)
    if kind == "MLPNet":
        return kind, model.num_actions, tuple(model.hidden), dt
    if kind == "AZResNet":
        return kind, model.num_actions, model.channels, model.blocks, model.value_hidden, dt
    return kind, model.num_actions, model.channels, model.dropout, dt


def _port_model(model, cells: int) -> tuple:
    kind = type(model).__name__
    dt = str(model.dtype).replace("torch.", "")
    if kind == "MLPNet":
        assert model.cells == cells
        return kind, model.num_actions, model.hidden, dt
    if kind == "AZResNet":
        assert model.value_hidden.in_features == cells
        return (kind, model.num_actions, model.stem.out_channels, len(model.blocks),
                model.value_hidden.out_features, dt)
    rows, cols = model.board
    assert rows * cols == cells
    return kind, model.num_actions, model.convs[0].out_channels, model.dropout, dt


CASES = [
    ("connect_four", p, []) for p in ("smoke", "mlp", "full", "convnet", "economy")
] + [
    ("connect_four", "full", ["--replay-capacity", "4096", "--gumbel", "16", "--reanalyze", "32"]),
] + [
    ("othello", p, []) for p in ("smoke", "mlp", "full")
] + [
    ("othello", "full", ["--channels", "64", "--blocks", "3"]),
    ("gomoku", "smoke", []), ("gomoku", "mlp", []), ("gomoku", "full", []),
    ("gomoku", "full", ["--size", "15"]), ("gomoku", "mlp", ["--size", "19"]),
] + [
    ("hex", p, []) for p in ("smoke", "mlp", "full")
]


@pytest.mark.parametrize("game, name, extra", CASES,
                         ids=[f"{g}-{p}{''.join(e)}" for g, p, e in CASES])
def test_preset_equals_the_jax_cli(monkeypatch, game, name, extra):
    argv = ["--preset", name, "--seed", "3", "--checkpoint-dir", "d"] + extra
    want = _jax_cli(monkeypatch, f"train_{game}", argv)
    got = _port_cli(monkeypatch, game, argv)
    assert got["game"].name == want["game"].name
    assert got["game"].num_actions == want["game"].num_actions
    assert got["game"].feature_shape == tuple(want["game"].feature_shape)
    assert got["cfg"] == port_az_config(want["cfg"])
    cells = got["game"].feature_shape[0] * got["game"].feature_shape[1]
    assert _port_model(got["model"], cells) == _jax_model(want["model"])


def _tiny(real):
    """A preset at a CPU test's size: 4 games of 4 sims, 4-game arenas."""
    def preset(name, seed=0, checkpoint_dir=None, *args):
        model, cfg = real(name, seed, checkpoint_dir, *args)
        return model, dataclasses.replace(
            cfg, mcts=dataclasses.replace(cfg.mcts, num_sims=4, max_depth=8),
            selfplay=dataclasses.replace(cfg.selfplay, batch_size=4),
            arena=dataclasses.replace(cfg.arena, num_games=4, num_sims=2))
    return preset


@pytest.mark.parametrize("game", ["othello", "gomoku", "hex"])
def test_smoke_run_trains_saves_and_resumes(tmp_path, capsys, monkeypatch, game):
    cli = PORT[game]
    monkeypatch.setattr(cli, "preset", _tiny(cli.preset))
    args = ["--cpu", "--checkpoint-dir", str(tmp_path), "--iterations", "1"]
    assert cli.main(args) == 0
    assert "done: iterations=1 " in capsys.readouterr().out
    assert cli.main(args) == 0
    assert "done: iterations=2 " in capsys.readouterr().out
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in lines] == [1, 2]
    assert sorted(n for n in os.listdir(tmp_path) if n.startswith("ckpt_")) == [
        "ckpt_000001", "ckpt_000001.json", "ckpt_000002", "ckpt_000002.json"]


@pytest.mark.parametrize("game, argv, item", [
    (g, a, "The opt-in engines") for g in ("othello", "gomoku", "hex")
    for a in (["--gumbel", "8"], ["--reanalyze", "64"])
] + [("gomoku", ["--size", "28"], "Gomoku boards above 768 cells")])
def test_unported_options_raise(monkeypatch, game, argv, item):
    """Options once refused with their ROADMAP item (``item``) are ported:
    ``--gumbel`` and ``--reanalyze`` (the opt-in engines), and Gomoku
    ``--size 28`` (784 cells, "Gomoku boards above 768 cells"), which the
    card's leaf-row descends and streamed merges take. The config they
    make equals the JAX CLI's, and the model's actions are the board's."""
    want = _jax_cli(monkeypatch, f"train_{game}", argv)
    got = _port_cli(monkeypatch, game, argv)
    assert got["cfg"] == port_az_config(want["cfg"])
    assert got["cfg"].mcts.gumbel == ("--gumbel" in argv)
    assert (got["cfg"].reanalyze is not None) == ("--reanalyze" in argv)
    assert got["model"].num_actions == want["model"].num_actions
    if "--size" in argv:
        assert got["game"].num_actions == 28 * 28


RESULTS = [(3, 1, 0), (0, 4, 0), (2, 2, 4), (8, 0, 0), (0, 0, 0), (5, 0, 3)]


@pytest.mark.parametrize("result", RESULTS, ids=["-".join(map(str, r)) for r in RESULTS])
def test_eval_json_equals_the_jax_tool(monkeypatch, capsys, result):
    """Both tools on pure MCTS against pure MCTS, their arenas stubbed to
    one match result: the same JSON line."""
    import jax.numpy as jnp

    monkeypatch.setattr(alphazero_tpu.arena, "make_arena_fn", lambda *a, **k: (
        lambda *p: alphazero_tpu.arena.ArenaResult(*(jnp.int32(x) for x in (*result, 0)))))
    monkeypatch.setattr(alphazero_tpu_torch.arena, "make_arena_fn", lambda *a, **k: (
        lambda *p: ArenaResult(*result, 0)))
    argv = ["--game", "hex", "--games", "8", "--sims", "3"]
    monkeypatch.setattr(sys, "argv", ["eval_checkpoints"] + argv)
    _load_jax_script("eval_checkpoints").main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert eval_checkpoints.main(argv + ["--cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want


def _checkpoint(directory, seed: int) -> None:
    """One iteration of an Othello coach with an MLPNet (16, 16), saved."""
    game = Othello()
    cfg = AZConfig(
        mcts=MCTSConfig(num_sims=2, max_depth=8),
        selfplay=SelfPlayConfig(batch_size=2, temp_threshold=6, max_moves=8),
        replay=ReplayConfig(capacity=1024),
        train=TrainConfig(batch_size=16, steps_per_iteration=2, learning_rate=0.05),
        arena=ArenaConfig(num_games=2, update_threshold=None, num_sims=2),
        seed=seed, checkpoint_dir=str(directory))
    torch.manual_seed(seed)
    alphazero_tpu_torch.coach.Coach(game, MLPNet(game.num_actions, hidden=(16, 16), cells=64),
                                    cfg, device="cpu").learn(1)


def test_eval_checkpoints_runs_port_checkpoints(tmp_path, capsys):
    _checkpoint(tmp_path / "a", 1)
    _checkpoint(tmp_path / "b", 2)
    base = ["--cpu", "--game", "othello", "--hidden", "16", "--games", "4", "--sims", "2",
            "--max-depth", "8"]
    for argv, b in ((["--a", str(tmp_path / "a"), "--b", str(tmp_path / "b")], f"{tmp_path}/b@1"),
                    (["--a", str(tmp_path / "a")], "pure-mcts")):
        assert eval_checkpoints.main(base + argv) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["a"] == f"{tmp_path}/a@1" and out["b"] == b
        assert out["games"] == out["a_wins"] + out["b_wins"] + out["draws"] == 4
        score, elo = eval_checkpoints.elo_diff(out["a_wins"], out["b_wins"], out["draws"])
        assert out["elo_diff_a_minus_b"] == round(elo, 1)


def test_eval_checkpoints_loads_a_resnet_checkpoint(tmp_path):
    """``--a-model resnet`` reads the incumbent's weights of a port
    checkpoint into an AZResNet of ``--channels`` x ``--blocks``."""
    from alphazero_tpu_torch.checkpoint import save_checkpoint

    game = Othello()
    torch.manual_seed(0)
    net = AZResNet(game.num_actions, channels=8, blocks=2, cells=64)
    save_checkpoint(str(tmp_path), 3, {"incumbent": {"model": net.state_dict()}})
    model, label = eval_checkpoints.load_side(game, str(tmp_path), "resnet", 0, 8, 2, device="cpu")
    assert label == f"{tmp_path}@3"
    for (k, v), w in zip(model.state_dict().items(), net.state_dict().values()):
        assert torch.equal(v, w), k
    with pytest.raises(SystemExit, match="no checkpoint"):
        eval_checkpoints.load_side(game, str(tmp_path / "none"), "mlp", 16, 0, 0, device="cpu")
    uni, label = eval_checkpoints.load_side(game, None, "mlp", 16, 0, 0, device="cpu")
    assert label == "pure-mcts" and uni.num_actions == game.num_actions
