#!/usr/bin/env python
"""Play Gomoku (five in a row) against the port — human vs MCTS(+net).

Counterpart of ``examples/play_gomoku.py``, with its flags: the engine
searches on the dense engine (``max_depth`` 48) with a port checkpoint's
model, or the pure-MCTS uniform prior when none is given, on the card
unless ``--cpu`` is given; moves are read from stdin.

Usage:
  python -m alphazero_tpu_torch.examples.play_gomoku [--sims 400] [--checkpoint-dir DIR]
  python -m alphazero_tpu_torch.examples.play_gomoku --cpu
"""

from __future__ import annotations

import sys

import torch

from alphazero_tpu_torch.examples.boardio import render
from alphazero_tpu_torch.examples.play import engine, parser


def main(argv=None) -> int:
    ap = parser(__doc__, 400, 512, "architecture the checkpoint was trained with")
    ap.add_argument("--size", type=int, default=9, help="board edge (9 default, 15 standard)")
    args = ap.parse_args(argv)
    from alphazero_tpu_torch.games import Gomoku

    game = Gomoku(args.size)
    device, engine_move = engine(game, args, max_depth=48)
    state = game.init(1, device)
    human_to_move = args.human_first
    print("you are X; five in a row wins; enter moves as `row col`\n")
    while True:
        board = state[0].cpu().numpy()
        display = board if human_to_move else -board
        done, value = game.terminal(state)
        if bool(done[0]):
            print(render(display))
            v = float(value[0])
            if v == 0.0:
                print("draw!")
            elif (v < 0) == human_to_move:
                print("engine wins!")
            else:
                print("you win!")
            return 0
        print(render(display))
        valid = game.valid_moves(state)[0].cpu().numpy()
        if human_to_move:
            while True:
                try:
                    raw = input("your move (row col): ").strip()
                    r, c = map(int, raw.split())
                    a = r * game.size + c
                except EOFError:
                    print("\nbye")
                    return 0
                except ValueError:
                    print(f"enter `row col` (0-{game.size - 1})")
                    continue
                if 0 <= a < game.num_actions and valid[a]:
                    break
                print("illegal move")
        else:
            a, counts, q = engine_move(state)
            print(f"engine plays {a // game.size} {a % game.size} "
                  f"(visits {int(counts[a])}, Q={q:+.2f})")
        state = game.step(state, torch.tensor([a], device=device))
        human_to_move = not human_to_move


if __name__ == "__main__":
    sys.exit(main())
