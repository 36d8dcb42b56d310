"""Gumbel search against PUCT: strength and wall clock with the same net.

Counterpart of the repository's ``bench_gumbel.py``, with its flags and its
JSON keys. The claim behind ``MCTSConfig.gumbel`` (``mcts/gumbel.py``) is
equal or better play at small simulation budgets. This script plays the
two searches head to head with the same network and measures:

1. strength: seating-swapped lockstep games, Gumbel search playing its
   halving winner (a fresh root Gumbel sample each move), PUCT (the dense
   engine, ``mcts/search.py``) sampling in proportion to its counts for
   ``--temp-moves`` plies, then greedy; ``--puct-sims`` can give PUCT a
   larger budget to find the equal-strength point;
2. throughput: the fixed self-play scan with Gumbel search and without it
   (the engine ladder), best of three calls after one warm-up.

The net is the uniform model, or with ``--ckpt`` the incumbent of a port
checkpoint (``examples/eval_checkpoints.load_side``). Draws come from one
``torch.Generator`` a seed; each ply searches each live game once, with the
engine of the side to move (``bench_tt.play_match``). Runs on the card
unless ``--cpu`` is given; prints one JSON line.

Usage:

    python -m alphazero_tpu_torch.bench_gumbel [--game connect_four] \\
        [--ckpt runs/c4_mlp --model mlp] [--sims 16] [--puct-sims 16] [--games 512]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Tuple

import torch

from alphazero_tpu_torch.bench_tt import counts_mover, play_match, time_selfplay
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.examples.eval_checkpoints import elo_diff, load_side
from alphazero_tpu_torch.games import ConnectFour, Gomoku, Othello
from alphazero_tpu_torch.mcts import make_gumbel_search_fn, make_search_fn
from alphazero_tpu_torch.models import make_apply_fn


def head_to_head(game, model, g_sims: int, p_sims: int, num_games: int, max_depth: int,
                 temp_moves: int, top_m: int, seed: int, device="cuda") -> Tuple[int, int, int]:
    """G (Gumbel search) against P (PUCT), seating swapped: ``(g_wins,
    p_wins, draws)``."""
    apply_fn = make_apply_fn(model)
    search_g = make_gumbel_search_fn(game, apply_fn, MCTSConfig(
        num_sims=g_sims, max_depth=max_depth, gumbel=True, gumbel_top_m=top_m))
    search_p = make_search_fn(game, apply_fn, MCTSConfig(num_sims=p_sims, max_depth=max_depth))
    gen = torch.Generator(device=device).manual_seed(seed)
    return play_match(game, lambda state, t, tie, gumbel, root: search_g(state, root).action,
                      counts_mover(lambda s: search_p(s).root_counts(), temp_moves),
                      num_games, gen, device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--game", default="connect_four", choices=["connect_four", "othello", "gomoku"])
    ap.add_argument("--ckpt", default=None, help="checkpoint dir (default: uniform net)")
    ap.add_argument("--model", choices=("mlp", "resnet"), default="mlp")
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--games", type=int, default=512)
    ap.add_argument("--sims", type=int, default=16, help="gumbel budget")
    ap.add_argument("--puct-sims", type=int, default=None,
                    help="PUCT budget (default: same as --sims)")
    ap.add_argument("--top-m", type=int, default=16)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--temp-moves", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--skip-throughput", action="store_true")
    ap.add_argument("--skip-strength", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    game = {"connect_four": ConnectFour, "othello": Othello, "gomoku": Gomoku}[args.game]()
    max_depth = args.max_depth or (48 if args.game == "connect_four" else 64)
    p_sims = args.puct_sims or args.sims
    model, label = load_side(game, args.ckpt, args.model, args.hidden, args.channels,
                             args.blocks, device=device)
    if args.ckpt is None:
        label = "uniform"

    out = {"game": args.game, "net": label, "gumbel_sims": args.sims, "puct_sims": p_sims,
           "top_m": args.top_m}
    if not args.skip_strength:
        gw = pw = dr = 0
        for s in range(args.seeds):
            a, b, c = head_to_head(game, model, args.sims, p_sims, args.games, max_depth,
                                   args.temp_moves, args.top_m, seed=431 + s, device=device)
            gw, pw, dr = gw + a, pw + b, dr + c
            print(f"seed {431 + s}: gumbel {a}, puct {b}, draws {c}", file=sys.stderr, flush=True)
        score, elo = elo_diff(gw, pw, dr)
        out.update({"games": gw + pw + dr, "gumbel_wins": gw, "puct_wins": pw, "draws": dr,
                    "gumbel_score": round(score, 4), "gumbel_elo_delta": round(float(elo), 1)})

    if not args.skip_throughput:
        times = {}
        for gumbel in (False, True):
            cfg = MCTSConfig(num_sims=args.sims, max_depth=max_depth, gumbel=gumbel,
                             gumbel_top_m=args.top_m)
            times[gumbel] = time_selfplay(game, model, cfg, args.batch, seed=7, device=device)
        (t_p, mv_p), (t_g, mv_g) = times[False], times[True]
        out.update({"selfplay_batch": args.batch, "t_puct_s": round(t_p, 3),
                    "t_gumbel_s": round(t_g, 3), "env_steps_per_s_puct": int(mv_p / t_p),
                    "env_steps_per_s_gumbel": int(mv_g / t_g),
                    "gumbel_cost_x": round(t_g / t_p, 3)})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
