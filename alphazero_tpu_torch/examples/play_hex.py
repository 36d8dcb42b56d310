#!/usr/bin/env python
"""Play Hex 7x7 against the port — human vs MCTS(+net).

Counterpart of ``examples/play_hex.py``, with its flags. You are X and
connect TOP to BOTTOM; the engine (O) connects LEFT to RIGHT. The engine
searches on the dense engine (``max_depth`` 56) with a port checkpoint's
model, or the pure-MCTS uniform prior when none is given, on the card
unless ``--cpu`` is given; moves are read from stdin.

Hex's canonical form negates AND TRANSPOSES each move (games/hex.py), so
this CLI maps the engine's frame back to your fixed view: at the engine's
turn the physical board is ``-board.T`` and its move (r, c) is your
(c, r).

Usage:
  python -m alphazero_tpu_torch.examples.play_hex [--sims 400] [--checkpoint-dir DIR]
  python -m alphazero_tpu_torch.examples.play_hex --cpu
"""

from __future__ import annotations

import sys

import torch

from alphazero_tpu_torch.examples.boardio import render
from alphazero_tpu_torch.examples.play import engine, parser


def main(argv=None) -> int:
    args = parser(__doc__, 400, 256, "architecture the checkpoint was trained with").parse_args(argv)
    from alphazero_tpu_torch.games import Hex
    from alphazero_tpu_torch.games.hex import SIZE

    game = Hex()
    device, engine_move = engine(game, args, max_depth=56)
    state = game.init(1, device)
    human_to_move = args.human_first
    print(
        "you are X and connect TOP row to BOTTOM row; the engine (O)\n"
        "connects LEFT to RIGHT; enter moves as `row col`\n"
    )
    while True:
        # your fixed view: at your turn the canonical board IS the
        # physical board; at the engine's turn undo one negate+transpose
        board = state[0].cpu().numpy()
        display = board if human_to_move else -board.T
        done, value = game.terminal(state)
        if bool(done[0]):
            print(render(display))
            v = float(value[0])
            if (v < 0) == human_to_move:
                print("engine wins!")  # the player to move lost
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
                    a = r * SIZE + c
                except EOFError:
                    print("\nbye")
                    return 0
                except ValueError:
                    print(f"enter `row col` (0-{SIZE - 1})")
                    continue
                if 0 <= r < SIZE and 0 <= c < SIZE and valid[a]:
                    break
                print("illegal move")
        else:
            a, counts, q = engine_move(state)
            # engine's canonical (r, c) is (c, r) in your view
            print(f"engine plays {a % SIZE} {a // SIZE} (visits {int(counts[a])}, Q={q:+.2f})")
        state = game.step(state, torch.tensor([a], device=device))
        human_to_move = not human_to_move


if __name__ == "__main__":
    sys.exit(main())
