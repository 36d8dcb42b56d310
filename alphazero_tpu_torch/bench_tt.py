"""What the transposition DAG is worth and what it costs: the transposition
engine (``mcts/tt.py``) against the pure tree (the dense engine,
``mcts/search.py``) at equal simulations, and self-play's wall clock with
``MCTSConfig.transposition`` on and off.

Counterpart of the repository's ``bench_tt.py``, with its flags and its JSON
keys:

1. strength: seating-swapped lockstep games with fresh trees every move,
   the first ``--temp-moves`` plies sampled in proportion to the counts,
   then greedy play (the C++ oracle's match protocol); the transposition
   side's score and Elo difference;
2. throughput: the fixed self-play scan (``make_selfplay_fn``) with the
   transposition engine and without it (the engine ladder), best of three
   calls after one warm-up; moves a second and the cost ratio.

The draws (tie-break uniforms, the move's Gumbel noise) come from one
``torch.Generator`` a seed, since JAX's threefry stream cannot be
reproduced. Each ply searches each game once, with the engine of the side
to move, and skips finished games: the JAX script searches every board
with both engines and keeps the mover's counts, the same function at
twice the cost. Runs on the card unless ``--cpu`` is given; prints one
JSON line.

Usage:

    python -m alphazero_tpu_torch.bench_tt [--game connect_four|othello] \\
        [--games 512] [--sims 400] [--batch 512] [--seeds 3]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Tuple

import torch

from alphazero_tpu_torch.config import MCTSConfig, SelfPlayConfig
from alphazero_tpu_torch.examples.eval_checkpoints import elo_diff
from alphazero_tpu_torch.games import ConnectFour, Othello
from alphazero_tpu_torch.mcts import make_search_fn, make_tt_search_fn
from alphazero_tpu_torch.models import make_uniform_model
from alphazero_tpu_torch.ops import action_probs, sample_draws
from alphazero_tpu_torch.selfplay import make_selfplay_fn

# ``move(state [n, ...], t, tie, gumbel, root) -> action i64[n]`` of the n
# live games where one side moves at ply ``t``: ``tie`` and ``gumbel`` are
# their tie-break uniforms and move noise f32[n, A], ``root`` a second
# Gumbel sample (a Gumbel search's root sample)
Move = Callable[..., torch.Tensor]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def counts_mover(root_counts: Callable, temp_moves: int) -> Move:
    """A side that plays from root counts: sampled in proportion to them for
    the first ``temp_moves`` plies (``action_probs`` at temperature 1, then
    a categorical draw), greedy after (ties by the uniforms)."""
    def move(state, t, tie, gumbel, root):
        pi = action_probs(root_counts(state), 1.0 if t < temp_moves else 0.0, tie)
        return (torch.log(pi + 1e-12) + gumbel).argmax(dim=-1)

    return move


def play_match(game, move_x: Move, move_y: Move, num_games: int, generator: torch.Generator,
               device) -> Tuple[int, int, int]:
    """``(x_wins, y_wins, draws)`` of ``num_games`` lockstep games, X moving
    first in the first ``(B + 1) // 2``; a finished game stays frozen."""
    B, A = num_games, game.num_actions
    state = game.init(B, device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    x_to_move = torch.arange(B, device=device) < (B + 1) // 2
    winner_x = torch.zeros_like(done)
    is_draw = torch.zeros_like(done)
    for t in range(game.max_moves):
        if bool(done.all()):
            break
        d = sample_draws(generator, B, A, None, device)
        root = sample_draws(generator, B, A, None, device).gumbel
        action = torch.zeros(B, dtype=torch.long, device=device)
        for side, move in ((x_to_move, move_x), (~x_to_move, move_y)):
            rows = torch.nonzero(side & ~done)[:, 0]
            if rows.numel():
                action[rows] = move(state[rows], t, d.tie[rows], d.gumbel[rows], root[rows])
        nxt = game.step(state, action)
        state = torch.where(done.reshape((-1,) + (1,) * (nxt.ndim - 1)), state, nxt)
        now_done, tv = game.terminal(state)
        ended = ~done & now_done
        mover_won = tv < -0.5
        to_move_won = tv > 0.5
        won_x = torch.where(mover_won, x_to_move, ~x_to_move)
        winner_x = torch.where(ended & (mover_won | to_move_won), won_x, winner_x)
        is_draw = is_draw | (ended & ~mover_won & ~to_move_won)
        done = done | now_done
        x_to_move = torch.where(done, x_to_move, ~x_to_move)
    decisive = done & ~is_draw
    return (int((decisive & winner_x).sum()), int((decisive & ~winner_x).sum()),
            int((done & is_draw).sum()))


def head_to_head(game, sims: int, num_games: int, max_depth: int, temp_moves: int, seed: int,
                 device="cuda") -> Tuple[int, int, int]:
    """T (the transposition DAG) against P (the pure tree), equal sims, the
    uniform model, fresh trees every move: ``(t_wins, p_wins, draws)``."""
    apply_fn = make_uniform_model(game).apply_fn
    cfg = MCTSConfig(num_sims=sims, max_depth=max_depth)
    search_t = make_tt_search_fn(game, apply_fn, MCTSConfig(num_sims=sims, max_depth=max_depth,
                                                            transposition=True))
    search_p = make_search_fn(game, apply_fn, cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return play_match(game, counts_mover(lambda s: search_t(s).root_counts(), temp_moves),
                      counts_mover(lambda s: search_p(s).root_counts(), temp_moves),
                      num_games, gen, device)


def time_selfplay(game, model, cfg: MCTSConfig, batch: int, seed: int, reps: int = 3,
                  device="cuda") -> Tuple[float, int]:
    """``(best seconds, moves)`` of the fixed scan on ``batch`` games: one
    warm-up call, then the best of ``reps`` calls, each drawing from a
    generator of its own seed."""
    play = make_selfplay_fn(game, cfg, SelfPlayConfig(batch_size=batch), device=device)
    A = game.num_actions

    def call(s):
        gen = torch.Generator(device=device).manual_seed(s)
        out = play(model, lambda t: sample_draws(gen, batch, A, cfg.dirichlet_alpha, device))
        sync(device)
        return out

    call(seed)
    best = float("inf")
    for i in range(reps):
        t0 = time.perf_counter()
        _, stats = call(seed + 1 + i)
        best = min(best, time.perf_counter() - t0)
    return best, int(stats.num_moves.sum())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--game", default="connect_four", choices=["connect_four", "othello"])
    ap.add_argument("--games", type=int, default=512)
    ap.add_argument("--sims", type=int, default=400)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--temp-moves", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--skip-throughput", action="store_true")
    ap.add_argument("--skip-strength", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    game = ConnectFour() if args.game == "connect_four" else Othello()
    max_depth = args.max_depth or (48 if args.game == "connect_four" else 64)

    out = {"game": args.game, "sims": args.sims}
    if not args.skip_strength:
        tw = pw = dr = 0
        for s in range(args.seeds):
            a, b, c = head_to_head(game, args.sims, args.games, max_depth, args.temp_moves,
                                   seed=211 + s, device=device)
            tw, pw, dr = tw + a, pw + b, dr + c
            print(f"seed {211 + s}: tt {a}, pure {b}, draws {c}", file=sys.stderr, flush=True)
        score, elo = elo_diff(tw, pw, dr)
        out.update({"games": tw + pw + dr, "tt_wins": tw, "pure_wins": pw, "draws": dr,
                    "tt_score": round(score, 4), "tt_elo_delta": round(float(elo), 1)})

    if not args.skip_throughput:
        model = make_uniform_model(game)
        times = {}
        for tt in (False, True):
            cfg = MCTSConfig(num_sims=args.sims, max_depth=max_depth, transposition=tt)
            times[tt] = time_selfplay(game, model, cfg, args.batch, seed=7, device=device)
        (t_pure, mv), (t_tt, mv_t) = times[False], times[True]
        out.update({"selfplay_batch": args.batch, "t_pure_s": round(t_pure, 3),
                    "t_tt_s": round(t_tt, 3), "env_steps_per_s_pure": int(mv / t_pure),
                    "env_steps_per_s_tt": int(mv_t / t_tt), "tt_cost_x": round(t_tt / t_pure, 3)})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
