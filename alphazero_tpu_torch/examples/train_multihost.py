#!/usr/bin/env python
"""Multi-process training launcher over ``torch.distributed``.

Counterpart of ``examples/train_multihost.py``: every rank runs the SAME
coach program on its share of each batch (``alphazero_tpu_torch.parallel``),
one process per device. The gradients, arena results and gathered
trajectories travel by NCCL between cards (``--backend nccl``, the
default on the card) or by gloo (``--backend gloo``: on the CPU, or for
ranks that share one card). The run equals the one-process run of the
same config in its integers (games, ring, arena results, acceptance);
the bf16 learner's losses drift from the one-process ones, as each rank
rounds its bf16 weight gradients before the ranks' sum.

One command per rank (rank 0's host is the coordinator):

  # host 0, one rank per card
  python -m alphazero_tpu_torch.examples.train_multihost --coordinator host0:9876 \\
      --num-processes 2 --process-id 0
  # host 1
  python -m alphazero_tpu_torch.examples.train_multihost --coordinator host0:9876 \\
      --num-processes 2 --process-id 1

A rank takes the card ``LOCAL_RANK`` (or its process id modulo the host's
card count). On one machine's CPU (what tests/test_torch_multihost.py runs,
through ``parallel.distributed.launch_local_multihost``):

  python -m alphazero_tpu_torch.examples.train_multihost --coordinator localhost:9876 \\
      --num-processes 2 --process-id {0,1} --platform cpu --backend gloo

Process 0 prints one JSON record per iteration; metrics and checkpoints
are written by rank 0 only, and every rank resumes from them. The model's
initial weights are torch's default initialisation under
``torch.manual_seed(seed + 1)``, the same on every rank.
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--coordinator", required=True, help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--platform", default=None, help="cpu runs the rank on the CPU")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the process group's backend (default: nccl on the card, gloo on "
                         "the CPU, where only gloo runs)")
    ap.add_argument(
        "--host-devices",
        type=int,
        default=None,
        help="devices per process: one process drives one device, so only 1 is taken",
    )
    ap.add_argument("--game", choices=("connect_four", "othello"), default="connect_four")
    ap.add_argument("--net", choices=("mlp", "resnet"), default="mlp")
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--sims", type=int, default=100)
    ap.add_argument("--max-depth", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1024, help="global self-play games")
    ap.add_argument("--temp-threshold", type=int, default=15)
    ap.add_argument("--capacity", type=int, default=1 << 17)
    ap.add_argument("--train-batch", type=int, default=256)
    ap.add_argument("--train-steps", type=int, default=64)
    ap.add_argument("--arena-games", type=int, default=64)
    ap.add_argument("--arena-sims", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--max-moves", type=int, default=None)
    args = ap.parse_args(argv)
    if args.host_devices not in (None, 1):
        ap.error(f"--host-devices {args.host_devices}: one process drives one device; "
                 "launch one process per device instead")
    return args


def build_cfg(args):
    """The run configuration, shared with tests/test_torch_multihost.py so
    that the multi-process run is compared with a one-process run of the
    IDENTICAL config."""
    from alphazero_tpu_torch.config import (
        ArenaConfig,
        AZConfig,
        MCTSConfig,
        ReplayConfig,
        SelfPlayConfig,
        TrainConfig,
    )

    return AZConfig(
        mcts=MCTSConfig(num_sims=args.sims, max_depth=args.max_depth),
        selfplay=SelfPlayConfig(
            batch_size=args.batch,
            temp_threshold=args.temp_threshold,
            max_moves=args.max_moves,
        ),
        replay=ReplayConfig(capacity=args.capacity),
        train=TrainConfig(
            batch_size=args.train_batch, steps_per_iteration=args.train_steps
        ),
        arena=ArenaConfig(
            num_games=args.arena_games,
            update_threshold=0.6,
            num_sims=args.arena_sims,
        ),
        num_iterations=args.iterations,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
    )


def build_game_and_model(args):
    """The game and the model, built under ``torch.manual_seed(seed + 1)``."""
    import torch

    from alphazero_tpu_torch.games import ConnectFour, Othello
    from alphazero_tpu_torch.models import AZResNet, MLPNet

    game = ConnectFour() if args.game == "connect_four" else Othello()
    cells = game.feature_shape[0] * game.feature_shape[1]
    torch.manual_seed(args.seed + 1)
    if args.net == "mlp":
        model = MLPNet(game.num_actions, hidden=(args.hidden, args.hidden), cells=cells)
    else:
        model = AZResNet(game.num_actions, channels=args.channels, blocks=args.blocks,
                         cells=cells)
    return game, model


def main(argv=None):
    args = parse_args(argv)

    from alphazero_tpu_torch.parallel import distributed

    distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        platform=args.platform,
        backend=args.backend,
    )
    try:
        from alphazero_tpu_torch.coach import Coach
        from alphazero_tpu_torch.parallel import is_primary, make_mesh

        mesh = make_mesh()  # every rank on the data axis
        if is_primary():
            print(f"multihost up: {mesh.size} processes over {mesh.backend}, "
                  f"rank 0 on {mesh.device}", flush=True)
        game, model = build_game_and_model(args)
        cfg = build_cfg(args)
        coach = Coach(game, model, cfg, mesh=mesh)
        for _ in range(cfg.num_iterations):
            record = coach.run_iteration()
            if is_primary():
                print(json.dumps(record), flush=True)
        if cfg.checkpoint_dir and coach.iteration % max(cfg.checkpoint_interval, 1) != 0:
            coach.save()
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
