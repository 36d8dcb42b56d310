#!/usr/bin/env python
"""Train AlphaZero on Connect-Four with the port: the training CLI.

Counterpart of ``examples/train_connect_four.py``: the same presets with
the same values, driving ``alphazero_tpu_torch.coach.Coach`` on the card
(``--cpu`` runs on the CPU).

Usage:
  python -m alphazero_tpu_torch.examples.train_connect_four                 # smoke run
  python -m alphazero_tpu_torch.examples.train_connect_four --preset full \\
      --iterations 10 --checkpoint-dir runs/c4_full                         # AZResNet-64x5
  python -m alphazero_tpu_torch.examples.train_connect_four --preset convnet  # AZConvNet-512
  python -m alphazero_tpu_torch.examples.train_connect_four --preset economy  # Gumbel, 32 sims

The model's initial weights are torch's default initialisation under
``torch.manual_seed(seed + 1)`` (the JAX coach initialises from
``seed + 1`` too). ``--gumbel SIMS`` and ``--reanalyze BATCH`` apply the
JAX CLI's overrides (``cli.with_economy``), after ``--replay-capacity``.
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
from alphazero_tpu_torch.games import ConnectFour

PRESETS = ("smoke", "mlp", "full", "convnet", "economy")


def preset(name: str, seed: int = 0, checkpoint_dir=None):
    """``(model, AZConfig)`` of a preset, the model built under
    ``torch.manual_seed(seed + 1)``."""
    from alphazero_tpu_torch.models import AZConvNet, AZResNet, MLPNet

    game = ConnectFour()
    A = game.num_actions
    torch.manual_seed(seed + 1)
    if name == "smoke":
        model = MLPNet(A, hidden=(64,))
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=16, max_depth=24),
            selfplay=SelfPlayConfig(batch_size=16, temp_threshold=15),
            replay=ReplayConfig(capacity=1 << 14),
            train=TrainConfig(batch_size=64, steps_per_iteration=16),
            arena=ArenaConfig(num_games=16, update_threshold=0.55, num_sims=8),
            num_iterations=3,
        )
    elif name == "mlp":
        model = MLPNet(A, hidden=(256, 256))
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=50, max_depth=48),
            selfplay=SelfPlayConfig(batch_size=512, temp_threshold=15),
            replay=ReplayConfig(capacity=1 << 17),
            train=TrainConfig(batch_size=512, steps_per_iteration=128),
            arena=ArenaConfig(num_games=128, update_threshold=0.55, num_sims=25,
                              anchor_interval=2),
            num_iterations=20,
        )
    elif name == "convnet":
        # the reference-parity net (the TF1 architecture spec's conv stack)
        model = AZConvNet(A, channels=512, board=game.feature_shape[:2])
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=50, max_depth=48, dirichlet_alpha=1.0),
            selfplay=SelfPlayConfig(batch_size=1024, temp_threshold=15),
            replay=ReplayConfig(capacity=1 << 18),
            train=TrainConfig(batch_size=512, steps_per_iteration=256),
            arena=ArenaConfig(num_games=128, update_threshold=0.55, num_sims=25,
                              anchor_interval=3),
            num_iterations=10,
        )
    elif name == "full":
        model = AZResNet(A, channels=64, blocks=5)
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=100, max_depth=48, dirichlet_alpha=1.0),
            selfplay=SelfPlayConfig(batch_size=4096, temp_threshold=15, recycle=True),
            replay=ReplayConfig(capacity=1 << 21),
            train=TrainConfig(batch_size=1024, steps_per_iteration=512),
            arena=ArenaConfig(
                num_games=256,
                update_threshold=0.55,
                num_sims=50,
                anchor_interval=5,
                anchor_warmup=6,
                anchor_warmup_mult=4,
                pool_cross_matches=2,
                anchor_ladder=(400, 1600),
            ),
            num_iterations=50,
        )
    elif name == "economy":
        # the training-economy recipe: the flagship net searched by Gumbel
        # sequential halving at a small budget, on the fixed scan
        model = AZResNet(A, channels=64, blocks=5)
        cfg = AZConfig(
            mcts=MCTSConfig(num_sims=32, max_depth=48, gumbel=True, dirichlet_alpha=None),
            selfplay=SelfPlayConfig(batch_size=4096, temp_threshold=15),
            replay=ReplayConfig(capacity=1 << 20),
            train=TrainConfig(batch_size=1024, steps_per_iteration=512),
            arena=ArenaConfig(
                num_games=256,
                update_threshold=0.55,
                num_sims=50,
                anchor_interval=5,
                anchor_warmup=6,
                anchor_warmup_mult=4,
                pool_cross_matches=2,
                anchor_ladder=(400, 1600),
            ),
            num_iterations=50,
            # the replay-bearing checkpoint of a 2^20-row ring is large:
            # save every 5th iteration (the final state is always saved)
            checkpoint_interval=5,
            keep_checkpoints=4,
        )
    else:
        raise ValueError(f"unknown preset {name!r}; choose from {PRESETS}")
    return model, dataclasses.replace(cfg, seed=seed, checkpoint_dir=checkpoint_dir)


def main(argv=None) -> int:
    ap = cli.parser(__doc__, PRESETS)
    ap.add_argument("--recycle", action="store_true",
                    help="episode-recycling self-play (selfplay.recycle)")
    ap.add_argument("--recycle-steps", type=int, default=None, metavar="S",
                    help="searches per game per iteration with --recycle (game.max_moves)")
    ap.add_argument("--replay-capacity", type=int, default=None, metavar="N",
                    help="override the preset's replay ring capacity (rows)")
    args = ap.parse_args(argv)

    model, cfg = preset(args.preset, args.seed, args.checkpoint_dir)
    cfg = cli.with_replay_stride(cfg, args)
    if args.recycle:
        cfg = dataclasses.replace(cfg, selfplay=dataclasses.replace(
            cfg.selfplay, recycle=True, recycle_steps=args.recycle_steps))
    if args.replay_capacity is not None:
        cfg = dataclasses.replace(cfg, replay=dataclasses.replace(
            cfg.replay, capacity=args.replay_capacity))
    game = ConnectFour()
    return cli.run(game, model, cli.with_economy(cfg, args, game), args)


if __name__ == "__main__":
    sys.exit(main())
