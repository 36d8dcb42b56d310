"""What the training CLIs share: their common options, the refusal of the
unported ones, and the run itself (``Coach.learn`` on the card, or on the
CPU with ``--cpu``)."""

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
                    help="Gumbel search (not yet ported)")
    ap.add_argument("--reanalyze", type=int, default=None, metavar="BATCH",
                    help="replay-target refresh by re-search (not yet ported)")
    ap.add_argument("--replay-stride", type=int, default=None, metavar="K",
                    help="carry the replay ring in only every K-th periodic checkpoint "
                         "(config.replay_save_stride)")
    return ap


def refuse_unported(args) -> None:
    """``--gumbel`` and ``--reanalyze`` raise, citing their ROADMAP item."""
    if args.gumbel is not None:
        raise NotImplementedError(
            "--gumbel: Gumbel search (mcts/gumbel.py) is not yet ported "
            "(ROADMAP queue 1, \"The opt-in engines\")"
        )
    if args.reanalyze is not None:
        raise NotImplementedError(
            "--reanalyze: reanalyze.py is not yet ported (ROADMAP queue 1, \"The opt-in engines\")"
        )


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
