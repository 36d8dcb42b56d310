#!/usr/bin/env python
"""Pit two trained checkpoints (or a checkpoint against pure MCTS) head to
head with the port.

Counterpart of ``examples/eval_checkpoints.py``, on the port's own
checkpoints (``checkpoint.py``) and its batched arena: seating-swapped
lockstep games, greedy argmax play, and an Elo difference from the match
score. It runs on the card unless ``--cpu`` is given.

Usage:
  # checkpoint against checkpoint (same game; the models may differ)
  python -m alphazero_tpu_torch.examples.eval_checkpoints --game connect_four \\
      --a runs/c4_a --a-model resnet --b runs/c4_b --b-model mlp --games 256 --sims 100

  # checkpoint against the pure-MCTS baseline
  python -m alphazero_tpu_torch.examples.eval_checkpoints --game othello --a runs/oth --a-model mlp

Prints one JSON line, the JAX tool's: wins, losses and draws from A's side
and ``elo_diff_a_minus_b``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

GAMES = ("connect_four", "othello", "gomoku", "hex")


def make_game(name: str):
    from alphazero_tpu_torch.games import ConnectFour, Gomoku, Hex, Othello

    return {"connect_four": ConnectFour, "othello": Othello, "gomoku": Gomoku, "hex": Hex}[name]()


def load_side(game, ckpt_dir, model_kind, hidden, channels, blocks, device="cuda",
              allow_missing=False):
    """``(model, label)``: the incumbent of the newest checkpoint in
    ``ckpt_dir`` as an ``AZResNet`` (``model_kind`` "resnet") or an
    ``MLPNet`` (hidden, hidden), on ``device``; the uniform model when
    ``ckpt_dir`` is None. A directory with no checkpoint raises, or with
    ``allow_missing`` (the play CLIs) falls back to the uniform model."""
    from alphazero_tpu_torch.checkpoint import latest_step, restore_checkpoint
    from alphazero_tpu_torch.models import AZResNet, MLPNet, make_uniform_model

    if ckpt_dir is None:
        return make_uniform_model(game), "pure-mcts"
    step = latest_step(ckpt_dir)
    if step is None:
        if allow_missing:
            return make_uniform_model(game), f"pure-mcts (no checkpoint in {ckpt_dir})"
        raise SystemExit(f"no checkpoint found in {ckpt_dir}")
    cells = game.feature_shape[0] * game.feature_shape[1]
    if model_kind == "resnet":
        model = AZResNet(game.num_actions, channels=channels, blocks=blocks, cells=cells)
    else:
        model = MLPNet(game.num_actions, hidden=(hidden, hidden), cells=cells)
    model = model.to(device)
    payload, _ = restore_checkpoint(ckpt_dir, step, {"incumbent": {"model": model.state_dict()}},
                                    partial=True)
    model.load_state_dict(payload["incumbent"]["model"])
    return model.eval(), f"{ckpt_dir}@{step}"


def elo_diff(a_wins: int, b_wins: int, draws: int) -> tuple:
    """``(A's score, Elo of A minus B)`` of a match, the score clipped half
    a game from 0 and 1."""
    n = a_wins + b_wins + draws
    score = (a_wins + 0.5 * draws) / max(n, 1)
    eps = 1.0 / (2.0 * max(n, 1))
    s = min(max(score, eps), 1.0 - eps)
    return score, 400.0 * math.log10(s / (1.0 - s))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--game", choices=GAMES, default="connect_four")
    ap.add_argument("--a", default=None, help="checkpoint dir for side A")
    ap.add_argument("--b", default=None, help="checkpoint dir for side B (default: pure MCTS)")
    ap.add_argument("--a-model", choices=("mlp", "resnet"), default="mlp")
    ap.add_argument("--b-model", choices=("mlp", "resnet"), default="mlp")
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--games", type=int, default=256)
    ap.add_argument("--sims", type=int, default=100)
    ap.add_argument("--max-depth", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from alphazero_tpu_torch.arena import make_arena_fn, tie_draws_from
    from alphazero_tpu_torch.config import MCTSConfig

    device = torch.device("cpu" if args.cpu else "cuda")
    game = make_game(args.game)
    model_a, label_a = load_side(game, args.a, args.a_model, args.hidden, args.channels,
                                 args.blocks, device=device)
    model_b, label_b = load_side(game, args.b, args.b_model, args.hidden, args.channels,
                                 args.blocks, device=device)
    cfg = MCTSConfig(num_sims=args.sims, max_depth=args.max_depth)
    play = make_arena_fn(game, cfg, args.games, device=device)
    ties = tie_draws_from(torch.Generator(device=device).manual_seed(args.seed), args.games,
                          game.num_actions, device)
    result = play(model_a, model_b, ties)
    aw, bw, dr = result.cand_wins, result.inc_wins, result.draws
    score, elo = elo_diff(aw, bw, dr)
    print(json.dumps({
        "game": args.game,
        "a": label_a,
        "b": label_b,
        "games": aw + bw + dr,
        "a_wins": aw,
        "b_wins": bw,
        "draws": dr,
        "score_a": round(score, 4),
        "elo_diff_a_minus_b": round(elo, 1),
        "sims": args.sims,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
