#!/usr/bin/env python
"""Analyze a position with the port's dense, transposition or Gumbel search.

Counterpart of ``examples/analyze.py``, with its flags. Give a game, an
optional move sequence from the initial position and a model (a port
checkpoint, or the pure-MCTS uniform prior); prints the board, the net's
raw value, a per-action table of prior / visits / Q and the search's best
move. ``--engine xla`` (the default, the JAX package's name for this
engine) runs the dense engine; ``--engine tt`` runs the transposition
engine, prints the links it made and reads Q from the root children's node
statistics; ``--engine gumbel`` runs Gumbel search in evaluation mode (no
Gumbel sample), prints its recommendation and adds the improved policy to
the table. It runs on the card unless ``--cpu`` is given.

Usage:
  python -m alphazero_tpu_torch.examples.analyze --game connect_four --moves "3 3 4" --sims 400
  python -m alphazero_tpu_torch.examples.analyze --game othello --sims 800 --cpu
  python -m alphazero_tpu_torch.examples.analyze --engine tt --sims 400
  python -m alphazero_tpu_torch.examples.analyze --engine gumbel --moves "3 3" --sims 64
  python -m alphazero_tpu_torch.examples.analyze --game gomoku \\
      --checkpoint-dir runs/gomoku --model resnet
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from alphazero_tpu_torch.examples.boardio import render
from alphazero_tpu_torch.examples.eval_checkpoints import GAMES, load_side, make_game


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--game", choices=GAMES, default="connect_four")
    ap.add_argument(
        "--moves", default="",
        help="space-separated action indices applied from the initial "
        "position (connect_four: column; othello/gomoku: r*W+c)",
    )
    ap.add_argument("--engine", choices=("xla", "tt", "gumbel"), default="xla")
    ap.add_argument("--sims", type=int, default=400)
    ap.add_argument("--max-depth", type=int, default=64)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--model", choices=("mlp", "resnet"), default="mlp")
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.mcts import make_gumbel_search_fn, make_search_fn, make_tt_search_fn
    from alphazero_tpu_torch.models import make_apply_fn
    from alphazero_tpu_torch.ops import masked_policy

    device = torch.device("cpu" if args.cpu else "cuda")
    game = make_game(args.game)
    model, label = load_side(game, args.checkpoint_dir, args.model, args.hidden, args.channels,
                             args.blocks, device=device)
    apply_fn = make_apply_fn(model)

    # walk the move sequence on canonical states (player to move = +1)
    state = game.init(1, device)
    ply = 0
    for tok in args.moves.split():
        a = int(tok)
        valid = game.valid_moves(state)[0]
        if not (0 <= a < game.num_actions and bool(valid[a])):
            raise SystemExit(f"illegal move {a} at ply {ply}")
        if bool(game.terminal(state)[0][0]):
            raise SystemExit(f"position already terminal at ply {ply}")
        state = game.step(state, torch.tensor([a], device=device))
        ply += 1

    side = "X" if ply % 2 == 0 else "O"
    print(f"{game.name} after [{args.moves.strip() or 'start'}], {side} to move")
    display = state[0].cpu().numpy()
    if ply % 2 == 1:
        # undo one canonical flip so X is always the first mover; hex's
        # canonical form also transposes (games/hex.py)
        display = -display
        if args.game == "hex":
            display = display.T
    print(render(display, flip_rows=args.game == "connect_four"))

    done, value = game.terminal(state)
    if bool(done[0]):
        print(f"\nterminal position: value {float(value[0]):+.1f} (side to move)")
        return 0

    # raw net read at the root
    valid = game.valid_moves(state)
    if getattr(apply_fn, "needs_features", True):
        feats = game.to_features(state)
    else:
        feats = torch.zeros((1, 1), device=device)
    logits, v_raw = apply_fn(feats)
    net_pi = masked_policy(logits.float(), valid)[0].cpu().numpy()
    valid = valid[0].cpu().numpy()
    print(f"\nnet [{label}]: value {float(v_raw[0]):+.3f} (side to move)")

    gumbel = args.engine == "gumbel"
    cfg = MCTSConfig(num_sims=args.sims, max_depth=args.max_depth,
                     transposition=args.engine == "tt", gumbel=gumbel, dirichlet_alpha=None)
    if args.engine == "tt":
        tree = make_tt_search_fn(game, apply_fn, cfg)(state)
        print(f"transposition links made: {int(tree.dedup[0])}")
    elif gumbel:
        res = make_gumbel_search_fn(game, apply_fn, cfg)(state)
        tree = res.tree
        improved = res.improved_pi[0].cpu().numpy()
        print(f"gumbel recommendation (eval mode): {int(res.action[0])}")
    else:
        tree = make_search_fn(game, apply_fn, cfg)(state)
    counts = tree.root_counts()[0].cpu().numpy()
    q = tree.root_q()[0].cpu().numpy()

    total = max(counts.sum(), 1.0)
    hdr = f"{'a':>4} {'prior':>7} {'N':>7} {'N%':>6} {'Q':>7}"
    print("\n" + hdr + (f" {'pi_imp':>7}" if gumbel else ""))
    order = np.argsort(-counts, kind="stable")
    for a in order:
        if not valid[a]:
            continue
        row = (f"{a:>4} {net_pi[a]:>7.3f} {int(counts[a]):>7} "
               f"{100.0 * counts[a] / total:>5.1f}% {q[a]:>+7.3f}")
        print(row + (f" {improved[a]:>7.3f}" if gumbel else ""))
    best = int(order[0])
    print(f"\nsearch best move: {best} (N={int(counts[best])}, Q={q[best]:+.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
