"""What the training CLIs share: their common options, the training-economy
overrides ``--gumbel`` and ``--reanalyze``, and the run itself
(``Coach.learn`` on the card, or on the CPU with ``--cpu``)."""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys


def parser(doc: str, presets) -> argparse.ArgumentParser:
    """The options every training CLI takes."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--preset", choices=presets, default="smoke")
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gumbel", type=int, default=None, metavar="SIMS",
                    help="search with Gumbel sequential halving (mcts/gumbel.py) at SIMS "
                         "simulations a move")
    ap.add_argument("--reanalyze", type=int, default=None, metavar="BATCH",
                    help="re-search BATCH stored positions each iteration for fresh policy "
                         "targets (reanalyze.py; value targets stay the game outcome)")
    ap.add_argument("--replay-stride", type=int, default=None, metavar="K",
                    help="carry the replay ring in only every K-th periodic checkpoint "
                         "(config.replay_save_stride)")
    return ap


def with_economy(cfg, args, game):
    """The JAX CLIs' overrides: ``--gumbel SIMS`` searches with Gumbel
    sequential halving at SIMS simulations (no Dirichlet noise: exploration
    is the Gumbel sample); ``--reanalyze BATCH`` re-searches BATCH stored
    positions a pass, from a position ring of the replay ring's capacity
    over the game's symmetries."""
    if args.gumbel is not None:
        cfg = dataclasses.replace(cfg, mcts=dataclasses.replace(
            cfg.mcts, gumbel=True, num_sims=args.gumbel, dirichlet_alpha=None, parallel_sims=1))
    if args.reanalyze is not None:
        from alphazero_tpu_torch.config import ReanalyzeConfig

        cfg = dataclasses.replace(cfg, reanalyze=ReanalyzeConfig(
            batch_size=args.reanalyze,
            capacity=cfg.replay.capacity // max(game.num_symmetries, 1)))
    return cfg


def with_replay_stride(cfg, args):
    if args.replay_stride is None:
        return cfg
    return dataclasses.replace(cfg, replay_save_stride=args.replay_stride)


def run(game, model, cfg, args, anchored: bool = False) -> int:
    """Train ``model`` on ``game`` for ``--iterations`` (the preset's own
    count by default) and print the JAX CLI's closing line: the gate's
    Elo of the incumbent, or with ``anchored`` its anchored Elo."""
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    from alphazero_tpu_torch.coach import Coach

    coach = Coach(game, model, cfg, device="cpu" if args.cpu else "cuda")
    n = args.iterations if args.iterations is not None else cfg.num_iterations
    records = coach.learn(n)
    last = records[-1]
    elo = (f"anchored_elo={coach.anchored_ratings.get(coach.model_id, float('nan'))}" if anchored
           else f"elo={coach.elo.ratings.get(coach.model_id, 0.0):.1f}")
    print(f"done: iterations={last['iteration']} model_id={last['model_id']} {elo} "
          f"replay={last['replay_size']}")
    return 0
