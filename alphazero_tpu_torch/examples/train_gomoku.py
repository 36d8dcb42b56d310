#!/usr/bin/env python
"""Train AlphaZero on Gomoku with the port: the training CLI.

Counterpart of ``examples/train_gomoku.py``: the same presets with the
same values, driving ``alphazero_tpu_torch.coach.Coach`` on the card
(``--cpu`` runs on the CPU). Gomoku places freely on a ``--size`` board
(9 by default, 15 the standard one; A = size^2), eight symmetries, a
zero depth-cutoff heuristic; every model searches on the hybrid engine.

Usage:
  python -m alphazero_tpu_torch.examples.train_gomoku                   # smoke run
  python -m alphazero_tpu_torch.examples.train_gomoku --preset full \\
      --checkpoint-dir runs/gomoku9_full                                # AZResNet-64x5

The card's hybrid kernels take any ``--size``, as the JAX CLI does.
``--gumbel SIMS`` and ``--reanalyze BATCH`` apply the JAX CLI's overrides
(``cli.with_economy``). The model's initial weights are torch's default
initialisation under ``torch.manual_seed(seed + 1)``.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from alphazero_tpu_torch.config import (
    ArenaConfig,
    AZConfig,
    MCTSConfig,
    ReplayConfig,
    SelfPlayConfig,
    TrainConfig,
)
from alphazero_tpu_torch.examples import cli
from alphazero_tpu_torch.games import Gomoku

PRESETS = ("smoke", "mlp", "full")


def preset(name: str, seed: int = 0, checkpoint_dir=None, size: int = 9):
    """``(model, AZConfig)`` of a preset on the ``size`` board, the model
    built under ``torch.manual_seed(seed + 1)``."""
    from alphazero_tpu_torch.models import AZResNet, MLPNet

    game = Gomoku(size)
    A, cells = game.num_actions, size * size
    torch.manual_seed(seed + 1)
    if name == "smoke":
        model = MLPNet(A, hidden=(64,), cells=cells)
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=12, max_depth=24),
            selfplay=SelfPlayConfig(batch_size=8, temp_threshold=8, max_moves=60),
            replay=ReplayConfig(capacity=1 << 14),
            train=TrainConfig(batch_size=64, steps_per_iteration=16),
            arena=ArenaConfig(num_games=8, update_threshold=0.55, num_sims=8),
            num_iterations=2,
        )
    elif name == "mlp":
        model = MLPNet(A, hidden=(512, 512), cells=cells)
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=50, max_depth=48, dirichlet_alpha=0.15),
            selfplay=SelfPlayConfig(batch_size=256, temp_threshold=8),
            replay=ReplayConfig(capacity=1 << 17),
            train=TrainConfig(batch_size=512, steps_per_iteration=128),
            arena=ArenaConfig(num_games=64, update_threshold=0.55, num_sims=25,
                              anchor_interval=3),
            num_iterations=12,
        )
    elif name == "full":
        model = AZResNet(A, channels=64, blocks=5, cells=cells)
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=100, max_depth=48, dirichlet_alpha=0.15),
            selfplay=SelfPlayConfig(batch_size=1024, temp_threshold=8),
            replay=ReplayConfig(capacity=1 << 19),
            train=TrainConfig(batch_size=1024, steps_per_iteration=512),
            arena=ArenaConfig(num_games=128, update_threshold=0.55, num_sims=50,
                              anchor_interval=5),
            num_iterations=30,
            checkpoint_interval=5,
        )
    else:
        raise ValueError(f"unknown preset {name!r}; choose from {PRESETS}")
    return model, dataclasses.replace(cfg, seed=seed, checkpoint_dir=checkpoint_dir)


def main(argv=None) -> int:
    ap = cli.parser(__doc__, PRESETS)
    ap.add_argument("--size", type=int, default=9,
                    help="board edge: 9 (the default), 15 (the standard board, A=225), or any "
                         "other")
    args = ap.parse_args(argv)
    model, cfg = preset(args.preset, args.seed, args.checkpoint_dir, args.size)
    game = Gomoku(args.size)
    cfg = cli.with_economy(cli.with_replay_stride(cfg, args), args, game)
    return cli.run(game, model, cfg, args, anchored=True)


if __name__ == "__main__":
    sys.exit(main())
