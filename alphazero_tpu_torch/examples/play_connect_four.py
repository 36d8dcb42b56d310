#!/usr/bin/env python
"""Play Connect-Four against the port — human vs MCTS(+net).

Counterpart of ``examples/play_connect_four.py``, with its flags: the
engine searches on the dense engine (``max_depth`` 48) with a port
checkpoint's model, or the pure-MCTS uniform prior when none is given, on
the card unless ``--cpu`` is given; moves are read from stdin.

Usage:
  python -m alphazero_tpu_torch.examples.play_connect_four [--sims 200] [--checkpoint-dir DIR]
  python -m alphazero_tpu_torch.examples.play_connect_four --cpu
"""

from __future__ import annotations

import sys

import torch

from alphazero_tpu_torch.examples.boardio import render as _render
from alphazero_tpu_torch.examples.play import engine, parser


def render(board):
    return _render(board, flip_rows=True)


def main(argv=None) -> int:
    args = parser(__doc__, 200, 256, "architecture the checkpoint was trained with "
                  "(mlp preset = mlp, full preset = resnet)").parse_args(argv)
    from alphazero_tpu_torch.games import ConnectFour

    game = ConnectFour()
    device, engine_move = engine(game, args, max_depth=48)
    state = game.init(1, device)
    human_to_move = args.human_first
    print("you are X; columns 0-6\n")
    while True:
        # canonical board: +1 = player to move. Render with X = human.
        board = state[0].cpu().numpy()
        display = board if human_to_move else -board
        done, value = game.terminal(state)
        if bool(done[0]):
            print(render(display))
            v = float(value[0])
            if v == 0.0:
                print("draw!")
            elif (v < 0) == human_to_move:
                print("engine wins!")  # the player to move (human) lost
            else:
                print("you win!")
            return 0
        print(render(display))
        valid = game.valid_moves(state)[0].cpu().numpy()
        if human_to_move:
            while True:
                try:
                    a = int(input("your column: "))
                except EOFError:
                    print("\nbye")
                    return 0
                except ValueError:
                    print("enter a column 0-6")
                    continue
                if 0 <= a < 7 and valid[a]:
                    break
                print("illegal move")
        else:
            a, counts, q = engine_move(state)
            print(f"engine plays {a} (visits {counts.astype(int).tolist()}, Q={q:+.2f})")
        state = game.step(state, torch.tensor([a], device=device))
        human_to_move = not human_to_move


if __name__ == "__main__":
    sys.exit(main())
