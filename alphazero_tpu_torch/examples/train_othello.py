#!/usr/bin/env python
"""Train AlphaZero on Othello 8x8 with the port: the training CLI.

Counterpart of ``examples/train_othello.py``: the same presets with the
same values, driving ``alphazero_tpu_torch.coach.Coach`` on the card
(``--cpu`` runs on the CPU). Othello has 65 actions (a pass move), eight
symmetries and a nonzero depth-cutoff heuristic; every model searches on
the hybrid engine.

Usage:
  python -m alphazero_tpu_torch.examples.train_othello                  # smoke run
  python -m alphazero_tpu_torch.examples.train_othello --preset full \\
      --checkpoint-dir runs/oth_full                                     # AZResNet-128x5

The ``full`` preset trains in continuous mode (every candidate adopted;
the gate arena still runs for the Elo curve) with warmup anchored passes
and pool cross matches and no anchor ladder, as the JAX preset does. The
model's initial weights are torch's default initialisation under
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
from alphazero_tpu_torch.games import Othello

PRESETS = ("smoke", "mlp", "full")


def preset(name: str, seed: int = 0, checkpoint_dir=None, channels: int = 128, blocks: int = 5):
    """``(model, AZConfig)`` of a preset, the model built under
    ``torch.manual_seed(seed + 1)``; ``channels`` and ``blocks`` size the
    ``full`` preset's AZResNet."""
    from alphazero_tpu_torch.models import AZResNet, MLPNet

    game = Othello()
    A, cells = game.num_actions, game.feature_shape[0] * game.feature_shape[1]
    torch.manual_seed(seed + 1)
    if name == "smoke":
        model = MLPNet(A, hidden=(64,), cells=cells)
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=12, max_depth=24),
            selfplay=SelfPlayConfig(batch_size=8, temp_threshold=12, max_moves=70),
            replay=ReplayConfig(capacity=1 << 14),
            train=TrainConfig(batch_size=64, steps_per_iteration=16),
            arena=ArenaConfig(num_games=8, update_threshold=0.55, num_sims=8),
            num_iterations=2,
        )
    elif name == "mlp":
        model = MLPNet(A, hidden=(512, 512), cells=cells)
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=50, max_depth=64, dirichlet_alpha=0.3),
            selfplay=SelfPlayConfig(batch_size=256, temp_threshold=12),
            replay=ReplayConfig(capacity=1 << 17),
            train=TrainConfig(batch_size=512, steps_per_iteration=128),
            arena=ArenaConfig(num_games=64, update_threshold=0.55, num_sims=25,
                              anchor_interval=3),
            num_iterations=12,
        )
    elif name == "full":
        model = AZResNet(A, channels=channels, blocks=blocks, cells=cells)
        # continuous mode: a gated run stalls at generation 0 (the JAX
        # preset's own finding), so every candidate is adopted
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=100, max_depth=80, dirichlet_alpha=0.3),
            selfplay=SelfPlayConfig(batch_size=1024, temp_threshold=12),
            replay=ReplayConfig(capacity=1 << 19),
            train=TrainConfig(batch_size=1024, steps_per_iteration=1024),
            arena=ArenaConfig(
                num_games=128,
                update_threshold=None,
                num_sims=50,
                anchor_interval=5,
                anchor_warmup=3,
                anchor_warmup_mult=2,
                pool_cross_matches=2,
            ),
            num_iterations=30,
            checkpoint_interval=5,
        )
    else:
        raise ValueError(f"unknown preset {name!r}; choose from {PRESETS}")
    return model, dataclasses.replace(cfg, seed=seed, checkpoint_dir=checkpoint_dir)


def main(argv=None) -> int:
    ap = cli.parser(__doc__, PRESETS)
    ap.add_argument("--channels", type=int, default=128,
                    help="AZResNet tower width of the full preset")
    ap.add_argument("--blocks", type=int, default=5, help="AZResNet depth of the full preset")
    args = ap.parse_args(argv)
    model, cfg = preset(args.preset, args.seed, args.checkpoint_dir, args.channels, args.blocks)
    game = Othello()
    cfg = cli.with_economy(cli.with_replay_stride(cfg, args), args, game)
    return cli.run(game, model, cfg, args)


if __name__ == "__main__":
    sys.exit(main())
