#!/usr/bin/env python
"""Train AlphaZero on Connect-Four with the port: the training CLI.

Counterpart of ``examples/train_connect_four.py``: the same presets with
the same values, driving ``alphazero_tpu_torch.coach.Coach`` on the card
(``--cpu`` runs on the CPU).

Usage:
  python -m alphazero_tpu_torch.examples.train_connect_four                 # smoke run
  python -m alphazero_tpu_torch.examples.train_connect_four --preset full \\
      --iterations 10 --checkpoint-dir runs/c4_full                         # AZResNet-64x5

The model's initial weights are torch's default initialisation under
``torch.manual_seed(seed + 1)`` (the JAX coach initialises from
``seed + 1`` too). Not ported, and refused with the ROADMAP item that
holds them: the ``convnet`` preset (``AZConvNet``), the ``economy``
preset and ``--gumbel`` (Gumbel search), ``--reanalyze``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
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
from alphazero_tpu_torch.games import ConnectFour

PRESETS = ("smoke", "mlp", "full", "convnet", "economy")


def preset(name: str, seed: int = 0, checkpoint_dir=None):
    """``(model, AZConfig)`` of a preset, the model built under
    ``torch.manual_seed(seed + 1)``."""
    from alphazero_tpu_torch.models import AZResNet, MLPNet

    game = ConnectFour()
    A = game.num_actions
    if name == "convnet":
        raise NotImplementedError(
            "the convnet preset's AZConvNet is not yet ported "
            "(ROADMAP queue 1, \"`AZConvNet` and the CLIs\")"
        )
    if name == "economy":
        raise NotImplementedError(
            "the economy preset runs Gumbel search (mcts/gumbel.py), not yet ported "
            "(ROADMAP queue 1, \"The opt-in engines\")"
        )
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
    else:
        raise ValueError(f"unknown preset {name!r}; choose from {PRESETS}")
    return model, dataclasses.replace(cfg, seed=seed, checkpoint_dir=checkpoint_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=PRESETS, default="smoke")
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gumbel", type=int, default=None, metavar="SIMS",
                    help="Gumbel search (not yet ported)")
    ap.add_argument("--reanalyze", type=int, default=None, metavar="BATCH",
                    help="replay-target refresh by re-search (not yet ported)")
    ap.add_argument("--replay-stride", type=int, default=None, metavar="K",
                    help="carry the replay ring in only every K-th periodic checkpoint "
                         "(config.replay_save_stride)")
    ap.add_argument("--recycle", action="store_true",
                    help="episode-recycling self-play (selfplay.recycle)")
    ap.add_argument("--recycle-steps", type=int, default=None, metavar="S",
                    help="searches per game per iteration with --recycle (game.max_moves)")
    ap.add_argument("--replay-capacity", type=int, default=None, metavar="N",
                    help="override the preset's replay ring capacity (rows)")
    args = ap.parse_args(argv)
    if args.gumbel is not None:
        raise NotImplementedError(
            "--gumbel: Gumbel search (mcts/gumbel.py) is not yet ported "
            "(ROADMAP queue 1, \"The opt-in engines\")"
        )
    if args.reanalyze is not None:
        raise NotImplementedError(
            "--reanalyze: reanalyze.py is not yet ported (ROADMAP queue 1, \"The opt-in engines\")"
        )
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)

    from alphazero_tpu_torch.coach import Coach

    model, cfg = preset(args.preset, args.seed, args.checkpoint_dir)
    if args.replay_stride is not None:
        cfg = dataclasses.replace(cfg, replay_save_stride=args.replay_stride)
    if args.recycle:
        cfg = dataclasses.replace(cfg, selfplay=dataclasses.replace(
            cfg.selfplay, recycle=True, recycle_steps=args.recycle_steps))
    if args.replay_capacity is not None:
        cfg = dataclasses.replace(cfg, replay=dataclasses.replace(
            cfg.replay, capacity=args.replay_capacity))

    coach = Coach(ConnectFour(), model, cfg, device="cpu" if args.cpu else "cuda")
    n = args.iterations if args.iterations is not None else cfg.num_iterations
    records = coach.learn(n)
    last = records[-1]
    print(f"done: iterations={last['iteration']} model_id={last['model_id']} "
          f"elo={coach.elo.ratings.get(coach.model_id, 0.0):.1f} replay={last['replay_size']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
