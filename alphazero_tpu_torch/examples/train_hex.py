#!/usr/bin/env python
"""Train AlphaZero on Hex 7x7 with the port: the training CLI.

Counterpart of ``examples/train_hex.py``: the same presets with the same
values, driving ``alphazero_tpu_torch.coach.Coach`` on the card (``--cpu``
runs on the CPU). Hex is a connection game of 49 actions and two
symmetries, its boards canonical (the player to move connects top to
bottom); every model searches on the hybrid engine.

Usage:
  python -m alphazero_tpu_torch.examples.train_hex                      # smoke run
  python -m alphazero_tpu_torch.examples.train_hex --preset full \\
      --checkpoint-dir runs/hex_full                                     # AZResNet-64x5

The model's initial weights are torch's default initialisation under
``torch.manual_seed(seed + 1)``. ``--gumbel SIMS`` and ``--reanalyze
BATCH`` apply the JAX CLI's overrides (``cli.with_economy``).
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
from alphazero_tpu_torch.games import Hex

PRESETS = ("smoke", "mlp", "full")


def preset(name: str, seed: int = 0, checkpoint_dir=None):
    """``(model, AZConfig)`` of a preset, the model built under
    ``torch.manual_seed(seed + 1)``."""
    from alphazero_tpu_torch.models import AZResNet, MLPNet

    game = Hex()
    A, cells = game.num_actions, game.feature_shape[0] * game.feature_shape[1]
    torch.manual_seed(seed + 1)
    if name == "smoke":
        model = MLPNet(A, hidden=(64,), cells=cells)
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=12, max_depth=24),
            selfplay=SelfPlayConfig(batch_size=8, temp_threshold=8),
            replay=ReplayConfig(capacity=1 << 14),
            train=TrainConfig(batch_size=64, steps_per_iteration=16),
            arena=ArenaConfig(num_games=8, update_threshold=0.55, num_sims=8),
            num_iterations=2,
        )
    elif name == "mlp":
        model = MLPNet(A, hidden=(256, 256), cells=cells)
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=50, max_depth=56, dirichlet_alpha=0.2),
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
            mcts=MCTSConfig(num_sims=100, max_depth=56, dirichlet_alpha=0.2),
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
    args = ap.parse_args(argv)
    model, cfg = preset(args.preset, args.seed, args.checkpoint_dir)
    game = Hex()
    cfg = cli.with_economy(cli.with_replay_stride(cfg, args), args, game)
    return cli.run(game, model, cfg, args, anchored=True)


if __name__ == "__main__":
    sys.exit(main())
