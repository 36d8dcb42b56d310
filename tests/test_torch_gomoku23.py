"""Gomoku boards above 512 cells, which the card's kernels take since the
12-word descend instance and the 24-actions-a-lane dense merges and
seeds: the plain Gomoku 23 search (529 cells) held to the JAX hybrid
engine in interpret mode, exactly, and the training CLI at ``--size 23``
on the CPU. (The kernels themselves are held to the plain versions in
tests/test_torch_descend_emu.py, test_torch_games_emu.py and
test_torch_kernels.py, emulated; ``--size 28`` is refused in
tests/test_torch_cli_games.py.)"""

import dataclasses

import numpy as np

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import Gomoku as JaxGomoku
from alphazero_tpu.mcts.hybrid import make_hybrid_root_fn as jax_hybrid_root_fn
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.examples import train_gomoku
from alphazero_tpu_torch.games import Gomoku
from alphazero_tpu_torch.models import make_uniform_model
from alphazero_tpu_torch.selfplay import _make_root_counts_fn
from tests.torch_parity import gomoku_jax_state, random_play_boards, torch_state


def test_gomoku23_matches_jax_hybrid_engine():
    """Gomoku 23 (529 cells: 9 of the 12-word instance's words), uniform,
    B=2, 6 sims: root counts exactly the JAX hybrid engine's."""
    jg, tg = JaxGomoku(23), Gomoku(23)
    jcfg = JaxMCTSConfig(num_sims=6, max_depth=24)
    boards = random_play_boards(tg, 2, 60, seed=23)
    ref = np.asarray(jax_hybrid_root_fn(jg, jax_uniform(jg).apply_fn, jcfg, block_size=2)(
        {}, gomoku_jax_state(boards)))
    assert kernels.descend_entry(tg.flat_ops()) == "az_descend_gomoku"
    got = _make_root_counts_fn(tg, make_uniform_model(tg).apply_fn,
                               MCTSConfig(**dataclasses.asdict(jcfg)))(torch_state(boards))
    np.testing.assert_array_equal(ref, got.numpy())
    assert (got.sum(1) == 6).all()


def test_train_gomoku_takes_edges_up_to_27(monkeypatch, tmp_path, capsys):
    """``--size 23`` trains an iteration on the CPU (the smoke preset cut to
    a few moves, sims and games here; the card runs it uncut:
    chip_smoke.py); edges 25 and 27 build the smoke preset."""
    preset = train_gomoku.preset

    def cut(*args, **kw):
        model, cfg = preset(*args, **kw)
        return model, dataclasses.replace(
            cfg, mcts=dataclasses.replace(cfg.mcts, num_sims=4),
            selfplay=dataclasses.replace(cfg.selfplay, batch_size=2, max_moves=12),
            train=dataclasses.replace(cfg.train, batch_size=8, steps_per_iteration=2),
            arena=dataclasses.replace(cfg.arena, num_games=2, num_sims=2))

    monkeypatch.setattr(train_gomoku, "preset", cut)
    argv = ["--size", "23", "--cpu", "--iterations", "1", "--checkpoint-dir", str(tmp_path)]
    assert train_gomoku.main(argv) == 0
    assert "done: iterations=1 " in capsys.readouterr().out
    assert (tmp_path / "0.examples").exists()
    monkeypatch.setattr(train_gomoku, "preset", preset)
    for size in (25, 27):
        model, _ = train_gomoku.preset("smoke", size=size)
        assert model.num_actions == size * size
