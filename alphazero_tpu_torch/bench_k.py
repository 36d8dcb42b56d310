"""What ``parallel_sims=K`` costs in playing strength: the fused K-round
search against the exact K=1 search at equal simulation budgets, head to
head on Connect-Four with the uniform model.

Counterpart of the repository's ``bench_k.py``: seating-swapped lockstep
games, temperature-1 openings for the first ``temp_moves`` plies, then
greedy play; the result is one JSON line with K's score and its Elo
difference with a 95% interval. The draws (tie-break uniforms and the
Gumbel noise of the move choice) come from one ``torch.Generator``, since
JAX's threefry stream cannot be reproduced.

Usage (on the card):

    python -m alphazero_tpu_torch.bench_k [--k 2] [--games 1024] [--sims 100] \\
        [--max-depth 48] [--seeds 2] [--temp-moves 8]
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Tuple

import torch

from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.mcts.fused import make_fused_root_fn
from alphazero_tpu_torch.models import make_uniform_model
from alphazero_tpu_torch.ops import action_probs, sample_draws


def head_to_head(game, k: int, sims: int, num_games: int, max_depth: int,
                 generator: torch.Generator, temp_moves: int = 0,
                 device="cuda") -> Tuple[int, int, int]:
    """Fused K-round player against the fused exact (K=1) player over
    ``num_games`` games played in lockstep, K moving first in the first
    half; returns ``(k_wins, exact_wins, draws)``. Both searches run on
    every board at every ply, the reference's lockstep."""
    net = make_uniform_model(game)
    root_k = make_fused_root_fn(
        game, net.apply_fn, MCTSConfig(num_sims=sims, max_depth=max_depth, parallel_sims=k))
    root_1 = make_fused_root_fn(game, net.apply_fn, MCTSConfig(num_sims=sims, max_depth=max_depth))
    if root_k is None or root_1 is None:
        raise ValueError(f"{game.name}'s uniform model does not take the fused engine")
    B, A = num_games, game.num_actions
    state = game.init(B, device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    k_to_move = torch.arange(B, device=device) < (B + 1) // 2
    winner_k = torch.zeros_like(done)
    is_draw = torch.zeros_like(done)
    for t in range(game.max_moves):
        counts = torch.where(k_to_move[:, None], root_k(state), root_1(state))
        draws = sample_draws(generator, B, A, None, device)
        # temperature-1 opening diversity for the first temp_moves plies, then greedy
        pi = action_probs(counts, 1.0 if t < temp_moves else 0.0, draws.tie)
        action = (torch.log(pi + 1e-12) + draws.gumbel).argmax(dim=-1)
        state = torch.where(done[:, None, None], state, game.step(state, action))
        now_done, tv = game.terminal(state)
        ended = ~done & now_done
        mover_won = tv < -0.5
        to_move_won = tv > 0.5
        won_k = torch.where(mover_won, k_to_move, ~k_to_move)
        winner_k = torch.where(ended & (mover_won | to_move_won), won_k, winner_k)
        is_draw = torch.where(ended & ~mover_won & ~to_move_won, True, is_draw)
        done = done | now_done
        k_to_move = torch.where(done, k_to_move, ~k_to_move)
    if not bool(done.all()):
        raise RuntimeError(f"{int((~done).sum())} of {B} games did not end in {game.max_moves} plies")
    decisive = done & ~is_draw
    return (int((decisive & winner_k).sum()), int((decisive & ~winner_k).sum()),
            int((done & is_draw).sum()))


def elo_summary(k_wins: int, exact_wins: int, draws: int) -> dict:
    """K's score, its Elo difference and the 95% interval, the reference's
    formula (``bench_k.py:134-142``)."""
    n = k_wins + exact_wins + draws
    score = (k_wins + 0.5 * draws) / max(n, 1)
    eps = 1.0 / (2.0 * max(n, 1))

    def elo(s: float) -> float:   # +-inf at a score of 1 or 0, as the reference's numpy gives
        return 400.0 * math.log10(s / (1 - s)) if 0 < s < 1 else math.copysign(math.inf, s - 0.5)

    se = math.sqrt(score * (1 - score) / max(n, 1))
    lo = max(score - 1.96 * se, eps)
    hi = min(score + 1.96 * se, 1 - eps)
    return {"games": n, "k_wins": k_wins, "exact_wins": exact_wins, "draws": draws,
            "k_score": round(score, 4), "k_elo_delta": round(elo(min(max(score, eps), 1 - eps)), 1),
            "elo_95ci": [round(elo(lo), 1), round(elo(hi), 1)]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--games", type=int, default=1024)
    ap.add_argument("--sims", type=int, default=100)
    ap.add_argument("--max-depth", type=int, default=48)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--temp-moves", type=int, default=8,
                    help="temp-1 sampled opening plies (diversity; 0 = pure greedy)")
    args = ap.parse_args(argv)
    game = ConnectFour()
    kw = ew = dr = 0
    for s in range(args.seeds):
        gen = torch.Generator(device="cuda").manual_seed(51 + s)
        a, b, c = head_to_head(game, args.k, args.sims, args.games, args.max_depth, gen,
                               args.temp_moves)
        kw, ew, dr = kw + a, ew + b, dr + c
    out = {"k": args.k, "sims": args.sims, "temp_moves": args.temp_moves,
           **elo_summary(kw, ew, dr)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
