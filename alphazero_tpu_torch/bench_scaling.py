#!/usr/bin/env python
"""Scaling benchmark: self-play actor throughput against the rank count.

Counterpart of ``bench_scaling.py``, over ``torch.distributed``: for each
count N of 1, 2, 4, ... up to the card count it launches N ranks (NCCL,
one card each, through ``parallel.distributed.launch_local_multihost``),
each running the uniform model's steady-state actor
(``selfplay.make_actor_step_fn`` with ``mesh``: the fused kernel on the
rank's games) on Connect-Four at 100 simulations. Default mode is WEAK
scaling: the per-rank batch ``AZ_BENCH_BATCH_PER_DEV`` (8192) is held
while N grows. ``AZ_BENCH_MODE=strong`` holds the GLOBAL batch
``AZ_BENCH_BATCH_GLOBAL`` (32768). ``AZ_BENCH_SIMS`` and
``AZ_BENCH_STEPS`` (10 timed steps after 2 to settle) set the rest.

  python -m alphazero_tpu_torch.bench_scaling

``AZ_BENCH_CPU=1`` runs the ranks on the CPU over gloo (1 and 2 ranks):
it proves the sharded program runs at every count; CPU ranks share the
host's cores, so its efficiency is not meaningful.

Prints one JSON line per count (the JAX script's keys) and a summary
line with the 1-to-N efficiency, ``meaningful`` only on the card with
more than one count run. A step's time is the slowest rank's.

Two limits on what it shows, kept as the JAX script has them: the 10
default steps last tens of milliseconds on the card, too short a window
to read scaling from (set ``AZ_BENCH_STEPS`` higher); and every rank
draws the whole global batch's draws and keeps its rows, so a rank's
draw work grows with N under weak scaling.
"""

from __future__ import annotations

import json
import os
import sys
import time


def _rank(argv) -> int:
    """One rank of one count: time the actor, print rank 0's line."""
    import argparse

    import torch

    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.games import ConnectFour
    from alphazero_tpu_torch.models import make_uniform_model
    from alphazero_tpu_torch.ops import sample_draws
    from alphazero_tpu_torch.parallel import distributed, make_mesh
    from alphazero_tpu_torch.selfplay import make_actor_step_fn
    from alphazero_tpu_torch.utils import synchronize

    ap = argparse.ArgumentParser()
    for flag in ("--coordinator", "--platform", "--backend"):
        ap.add_argument(flag)
    for flag in ("--num-processes", "--process-id", "--batch", "--sims", "--steps"):
        ap.add_argument(flag, type=int)
    args = ap.parse_args(argv)
    dev = distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                                 platform=args.platform, backend=args.backend)
    try:
        mesh = make_mesh()
        game = ConnectFour()
        A = game.num_actions
        cfg = MCTSConfig(num_sims=args.sims, max_depth=48)
        init_carry, actor_step = make_actor_step_fn(
            game, make_uniform_model(game).apply_fn, cfg, batch_size=args.batch,
            temp_threshold=15, device=dev, mesh=mesh)
        carry = init_carry()
        # every rank draws the global batch's draws and keeps its rows
        gen = torch.Generator(device=dev).manual_seed(0)
        for _ in range(2):   # settle
            carry, pi = actor_step(carry, sample_draws(gen, args.batch, A, None, dev))
        synchronize(pi)
        distributed.barrier(mesh)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            carry, pi = actor_step(carry, sample_draws(gen, args.batch, A, None, dev))
        synchronize(pi)
        dt = time.perf_counter() - t0
        dt = float(distributed.all_reduce(torch.tensor([dt], device=dev), mesh, op="max"))
        if mesh.rank == 0:
            print(json.dumps({"seconds": dt}), flush=True)
    finally:
        distributed.shutdown()
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--coordinator" in argv:
        return _rank(argv)
    import torch

    from alphazero_tpu_torch.parallel.distributed import launch_local_multihost

    cpu = bool(os.environ.get("AZ_BENCH_CPU"))
    if not cpu and not torch.cuda.is_available():
        print("bench_scaling: no CUDA card (AZ_BENCH_CPU=1 runs the ranks on the CPU)",
              file=sys.stderr)
        return 1
    mode = os.environ.get("AZ_BENCH_MODE", "weak")
    per_dev = int(os.environ.get("AZ_BENCH_BATCH_PER_DEV", 8192))
    global_b = int(os.environ.get("AZ_BENCH_BATCH_GLOBAL", 32768))
    sims = int(os.environ.get("AZ_BENCH_SIMS", 100))
    steps = int(os.environ.get("AZ_BENCH_STEPS", 10))

    devices = 2 if cpu else torch.cuda.device_count()
    counts = [n for n in (1, 2, 4, 8, 16, 32, 64, 128) if n <= devices]
    if mode == "strong":
        counts = [n for n in counts if global_b % n == 0]

    results = []
    for n in counts:
        batch = global_b if mode == "strong" else per_dev * n
        (rec,) = launch_local_multihost(
            ["--batch", batch, "--sims", sims, "--steps", steps], num_processes=n,
            timeout=1800, platform="cpu" if cpu else None, backend="gloo" if cpu else "nccl",
            entry=["-m", "alphazero_tpu_torch.bench_scaling"])
        dt = rec["seconds"]
        eps = steps * batch / dt
        results.append((n, eps))
        print(json.dumps({
            "devices": n,
            "batch_games": batch,
            "env_steps_per_sec": round(eps, 1),
            "env_steps_per_sec_per_device": round(eps / n, 1),
            "seconds": round(dt, 3),
        }), flush=True)

    base = results[0][1]
    n_max, eps_max = results[-1]
    # weak: ideal eps grows with N at a fixed per-rank batch; strong: a
    # fixed global batch finishes N times faster; the same ratio either way
    eff = eps_max / (base * n_max) if base > 0 else 0.0
    print(json.dumps({
        "metric": f"selfplay_{mode}_scaling_efficiency",
        "value": round(eff, 3),
        "unit": f"1_to_{n_max}_devices",
        "backend": "cpu" if cpu else "cuda",
        "meaningful": not cpu and len(results) > 1,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
