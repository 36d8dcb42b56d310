"""Gomoku boards above 768 cells and round searches above K = 16, which
the card's hybrid kernels take since the leaf-row Gomoku descends, the
streamed dense merges and seeds, and the round kernels' wide instances:
a Gomoku 28 search (784 cells) and a K = 32 round search held to the JAX
hybrid engine in interpret mode, exactly, through the emulated kernels and
through the plain versions; the training CLI at ``--size 28`` on the CPU.
(The new instances alone are held to the plain versions in
tests/test_torch_descend_emu.py, test_torch_kernels.py,
test_torch_seed_emu.py and test_torch_rounds_wide.py, emulated.)"""

import dataclasses

import numpy as np

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.games import Gomoku as JaxGomoku
from alphazero_tpu.games.gomoku import GomokuFlatOps as JaxGomokuFlatOps
from alphazero_tpu.mcts.hybrid import make_hybrid_root_fn as jax_hybrid_root_fn
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.examples import train_gomoku
from alphazero_tpu_torch.games import ConnectFour, Gomoku
from alphazero_tpu_torch.games import gomoku as gomoku_module
from alphazero_tpu_torch.mcts import make_hybrid_root_fn
from alphazero_tpu_torch.models import make_uniform_model
from alphazero_tpu_torch.selfplay import _make_root_counts_fn
from tests.torch_parity import (  # noqa: F401  (emulated: a fixture)
    checked_kernels,
    checked_round_kernels,
    emulated,
    gomoku_jax_state,
    jax_state,
    random_boards,
    random_play_boards,
    torch_state,
)


def test_gomoku28_matches_jax_hybrid_engine(emulated):
    """Gomoku 28 (784 cells: the leaf-row descend and the streamed merge
    and seed), uniform, B=2, 6 sims: root counts exactly
    the JAX hybrid engine's, through the emulated kernels (each call held
    bit-equal to its plain version) and through the plain versions."""
    jg, tg = JaxGomoku(28), Gomoku(28)
    jcfg = JaxMCTSConfig(num_sims=6, max_depth=24)
    boards = random_play_boards(tg, 2, 80, seed=28)
    ref = np.asarray(jax_hybrid_root_fn(jg, jax_uniform(jg).apply_fn, jcfg, block_size=2)(
        {}, gomoku_jax_state(boards)))
    cfg = MCTSConfig(**dataclasses.asdict(jcfg))
    calls = {}
    got = make_hybrid_root_fn(tg, make_uniform_model(tg).apply_fn, cfg,
                              kernels=checked_kernels(emulated, calls))(torch_state(boards))
    np.testing.assert_array_equal(ref, got.numpy())
    assert calls == {"az_descend_gomoku": 6, "az_merge_dense": 6, "az_refresh_dense": 1}
    plain = _make_root_counts_fn(tg, make_uniform_model(tg).apply_fn, cfg)(torch_state(boards))
    np.testing.assert_array_equal(ref, plain.numpy())
    assert (plain.sum(1) == 6).all()


def test_k32_round_search_matches_jax_run_rounds(emulated):
    """A Connect-Four round search at K = 32 (past the 16 records the
    round merges stage at once, and the 32 bits of the A <= 8 merge's path
    mask), uniform, B=4, 64 sims in 2 rounds: root counts exactly the JAX
    hybrid engine's ``run_rounds``, through the emulated round kernels
    (each call held bit-equal to its plain version)."""
    jg, tg = JaxConnectFour(), ConnectFour()
    jcfg = JaxMCTSConfig(num_sims=64, max_depth=48, parallel_sims=32)
    boards = random_boards(4, 8, seed=32)
    ref = np.asarray(jax_hybrid_root_fn(jg, jax_uniform(jg).apply_fn, jcfg, block_size=4)(
        {}, jax_state(boards)))
    calls = {"second": 0, "dup": 0, "shared": 0, "past_capacity": 0}
    got = make_hybrid_root_fn(tg, make_uniform_model(tg).apply_fn,
                              MCTSConfig(**dataclasses.asdict(jcfg)),
                              kernels=checked_round_kernels(emulated, calls))(torch_state(boards))
    np.testing.assert_array_equal(ref, got.numpy())
    assert (calls["az_descend_round"], calls["az_merge_round"], calls["az_refresh2"]) == (2, 2, 1)
    assert calls["dup"] > 0 and calls["shared"] > 0


def test_train_gomoku_takes_size_28(monkeypatch, tmp_path, capsys):
    """``--size 28`` trains an iteration on the CPU (the smoke preset cut to
    a few moves, sims and games here; the card runs ``--size 32`` uncut:
    chip_smoke.py), where the CLI once refused boards above 768 cells."""
    preset = train_gomoku.preset

    def cut(*args, **kw):
        model, cfg = preset(*args, **kw)
        return model, dataclasses.replace(
            cfg, mcts=dataclasses.replace(cfg.mcts, num_sims=4),
            selfplay=dataclasses.replace(cfg.selfplay, batch_size=2, max_moves=12),
            train=dataclasses.replace(cfg.train, batch_size=8, steps_per_iteration=2),
            arena=dataclasses.replace(cfg.arena, num_games=2, num_sims=2))

    monkeypatch.setattr(train_gomoku, "preset", cut)
    argv = ["--size", "28", "--cpu", "--iterations", "1", "--checkpoint-dir", str(tmp_path)]
    assert train_gomoku.main(argv) == 0
    assert "done: iterations=1 " in capsys.readouterr().out
    assert (tmp_path / "0.examples").exists()


def test_gomoku_aux_builds_the_win_lines_once():
    """Every search asks the flat ops for the win-line matrix (``aux``),
    which Python loops over every window build. The board's matrix is built
    once and kept read-only, and each call hands out a tensor of its own,
    equal to the JAX aux."""
    gomoku_module._win_line_matrix.cache_clear()
    ops = Gomoku(28).flat_ops()
    first = ops.aux("cpu")
    first.fill_(7.0)                       # a caller's edit stays its own
    second = ops.aux("cpu")
    info = gomoku_module._win_line_matrix.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    np.testing.assert_array_equal(np.asarray(JaxGomokuFlatOps(28).aux()), second.numpy())
