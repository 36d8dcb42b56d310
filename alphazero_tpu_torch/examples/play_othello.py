#!/usr/bin/env python
"""Play Othello 8x8 against the port — human vs MCTS(+net).

Counterpart of ``examples/play_othello.py``, with its flags: the engine
searches on the dense engine (``max_depth`` 96) with a port checkpoint's
model, or the pure-MCTS uniform prior when none is given, on the card
unless ``--cpu`` is given; moves are read from stdin.

Usage:
  python -m alphazero_tpu_torch.examples.play_othello [--sims 200] [--checkpoint-dir DIR]
  python -m alphazero_tpu_torch.examples.play_othello --cpu
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from alphazero_tpu_torch.examples.boardio import render
from alphazero_tpu_torch.examples.play import engine, parser


def main(argv=None) -> int:
    args = parser(__doc__, 200, 512, "architecture the checkpoint was trained with "
                  "(mlp preset = mlp, full preset = resnet)").parse_args(argv)
    from alphazero_tpu_torch.games import Othello
    from alphazero_tpu_torch.games.othello import PASS

    game = Othello()
    device, engine_move = engine(game, args, max_depth=96)
    state = game.init(1, device)
    human_to_move = args.human_first
    print("you are X; enter moves as `row col` (or `pass`)\n")
    while True:
        board = state[0].cpu().numpy()
        display = board if human_to_move else -board
        done, value = game.terminal(state)
        if bool(done[0]):
            print(render(display))
            v = float(value[0])
            diff = int(np.sum(display))
            if v == 0.0:
                print("draw!")
            elif (v < 0) == human_to_move:
                print(f"engine wins by {abs(diff)} discs!")
            else:
                print(f"you win by {abs(diff)} discs!")
            return 0
        print(render(display))
        valid = game.valid_moves(state)[0].cpu().numpy()
        if human_to_move:
            while True:
                try:
                    raw = input("your move (row col / pass): ").strip().lower()
                except EOFError:
                    print("\nbye")
                    return 0
                if raw in ("pass", "p"):
                    a = PASS
                else:
                    try:
                        r, c = map(int, raw.split())
                        a = r * 8 + c
                    except ValueError:
                        print("enter `row col` (0-7) or `pass`")
                        continue
                if 0 <= a <= PASS and valid[a]:
                    break
                print("illegal move")
        else:
            a, counts, q = engine_move(state)
            mv = "pass" if a == PASS else f"{a // 8} {a % 8}"
            print(f"engine plays {mv} (visits {int(counts[a])}, Q={q:+.2f})")
        state = game.step(state, torch.tensor([a], device=device))
        human_to_move = not human_to_move


if __name__ == "__main__":
    sys.exit(main())
