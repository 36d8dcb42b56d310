"""The port's play and analyze CLIs (``alphazero_tpu_torch/examples/``) on
the CPU: ``analyze`` finds an immediate win, reads a checkpoint of the
port's, rejects an illegal or terminal move sequence, and prints the JAX
CLI's transposition and Gumbel analyses; a scripted ``play_connect_four`` runs as a user runs it
and ends at EOF; ``boardio.render`` draws what the JAX CLIs draw."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from alphazero_tpu_torch.checkpoint import save_checkpoint
from alphazero_tpu_torch.examples import analyze, boardio, play_gomoku, play_hex, play_othello
from alphazero_tpu_torch.models import AZResNet
from tests.torch_parity import random_boards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_boardio():
    spec = importlib.util.spec_from_file_location("jax_boardio",
                                                  os.path.join(REPO, "examples", "boardio.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _best(out: str) -> int:
    return int(out.rsplit("search best move: ", 1)[1].split()[0])


def test_render_equals_the_jax_clis():
    jax_render = _jax_boardio().render
    rng = np.random.default_rng(0)
    for board in [*random_boards(3, 20, seed=1), rng.integers(-1, 2, (9, 9)),
                  rng.integers(-1, 2, (11, 11))]:
        for flip in (False, True):
            assert boardio.render(board, flip_rows=flip) == jax_render(board, flip_rows=flip)


def test_analyze_finds_immediate_win(capsys):
    # X has 3-4-5 on the bottom row; columns 2 and 6 both win on the spot
    assert analyze.main(["--game", "connect_four", "--moves", "3 0 4 0 5 0", "--sims", "200",
                         "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "Q=+1.000" in out and "net [pure-mcts]: value +0.000" in out
    assert _best(out) in (2, 6)


def test_analyze_reads_a_port_checkpoint(tmp_path, capsys):
    """``--model resnet`` on a checkpoint written by ``save_checkpoint``:
    the net's raw value is printed, and the search takes the win."""
    torch.manual_seed(0)
    model = AZResNet(7, channels=8, blocks=1)
    save_checkpoint(str(tmp_path), 3, {"incumbent": {"model": model.state_dict()}})
    assert analyze.main(["--moves", "3 0 4 0 5 0", "--sims", "300", "--model", "resnet",
                         "--channels", "8", "--blocks", "1", "--checkpoint-dir", str(tmp_path),
                         "--cpu"]) == 0
    out = capsys.readouterr().out
    assert f"net [{tmp_path}@3]: value" in out and _best(out) in (2, 6)


@pytest.mark.parametrize("game,moves,sims", [("othello", "20", 16), ("gomoku", "40", 16),
                                             ("hex", "24", 16)])
def test_analyze_other_games(game, moves, sims, capsys):
    assert analyze.main(["--game", game, "--moves", moves, "--sims", str(sims), "--cpu"]) == 0
    out = capsys.readouterr().out
    assert f"{game} after [{moves}], O to move" in out and "search best move" in out


@pytest.mark.parametrize("moves,msg", [("3 3 3 3 3 3 3", "illegal move 3 at ply 6"),
                                       ("3 0 3 0 3 0 3 0", "position already terminal at ply 7")])
def test_analyze_rejects_bad_sequences(moves, msg):
    with pytest.raises(SystemExit, match=msg):
        analyze.main(["--moves", moves, "--sims", "8", "--cpu"])


def test_analyze_prints_a_terminal_position(capsys):
    assert analyze.main(["--moves", "3 0 3 0 3 0 3", "--cpu"]) == 0
    assert "terminal position: value -1.0 (side to move)" in capsys.readouterr().out


@pytest.mark.parametrize("engine", ["tt", "gumbel"])
def test_analyze_refuses_the_opt_in_engines(engine, capsys, monkeypatch):
    """``--engine tt`` and ``--engine gumbel`` are ported: run in the
    process, each prints what the JAX CLI prints for the same position and
    budget (the board, the net's value, the transposition links made or the
    eval-mode recommendation, the table with node-statistics Q or the
    improved policy, and the best move)."""
    argv = ["--engine", engine, "--moves", "3 3 2", "--sims", "300" if engine == "tt" else "24"]
    assert analyze.main(argv + ["--cpu"]) == 0
    got = capsys.readouterr().out
    monkeypatch.syspath_prepend(os.path.join(REPO, "examples"))
    monkeypatch.setattr(sys, "argv", ["analyze.py", *argv, "--cpu"])
    spec = importlib.util.spec_from_file_location("jax_analyze",
                                                  os.path.join(REPO, "examples", "analyze.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.main()
    want = capsys.readouterr().out
    if engine == "tt":
        assert int(got.split("transposition links made: ")[1].split()[0]) > 0
    else:
        assert "gumbel recommendation (eval mode): " in got and "pi_imp" in got
    assert got == want


def test_play_connect_four_scripted_ends_at_eof():
    """As a user runs it: the engine opens, the human answers in column 3,
    the engine replies, and stdin's end closes the game."""
    r = subprocess.run(
        [sys.executable, "-m", "alphazero_tpu_torch.examples.play_connect_four", "--cpu",
         "--sims", "50"],
        input="x\n9\n3\n", cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("engine plays") == 2 and r.stdout.rstrip().endswith("bye")
    assert "enter a column 0-6" in r.stdout and "illegal move" in r.stdout
    assert "model: pure-mcts" in r.stdout


@pytest.mark.parametrize("main,script", [
    (play_othello.main, ["2 4", "pass"]),
    (play_gomoku.main, ["4 4"]),
    (play_hex.main, ["3 3"]),
], ids=["othello", "gomoku", "hex"])
def test_play_other_games_until_eof(main, script, monkeypatch, capsys):
    lines = iter(script)

    def scripted(prompt=""):
        print(prompt, end="")
        try:
            return next(lines)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr("builtins.input", scripted)
    assert main(["--cpu", "--sims", "8", "--human-first"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("bye") and "engine plays" in out
