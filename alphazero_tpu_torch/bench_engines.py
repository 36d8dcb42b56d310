"""The engine comparison: ms a search move of each engine on each case.

Counterpart of the repository's ``bench_engines.py``, with its cases: the
uniform model, MLPNet (256, 256) and AZResNet-64x5 on Connect-Four; the
uniform model on Othello (B=1024 and 4096, and at ``parallel_sims=4``),
Gomoku 9, 15 and 7 and Hex; MLPNet (256, 256) on Gomoku 15 and Hex; 100
simulations each. Every engine that takes a case runs it: the fused kernel
(``mcts/fused.py``), the hybrid engine (``mcts/hybrid.py``) and the dense
engine (``mcts/search.py``, the JAX package's "xla"; it has no
``parallel_sims`` rounds). A timing is one warm-up call, then the mean of
three calls, ending in ``torch.cuda.synchronize()``. Nets carry seeded
random weights (the ResNet and the MLPs in bf16). Prints one JSON line for
each case and engine; ``AZ_BENCH_ONLY=substring`` selects the cases whose
name holds it. Runs on the card unless ``--cpu`` is given.

Usage:

    AZ_BENCH_ONLY=hex python -m alphazero_tpu_torch.bench_engines
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from alphazero_tpu_torch.bench_tt import sync
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour, Gomoku, Hex, Othello
from alphazero_tpu_torch.mcts.fused import make_fused_root_fn
from alphazero_tpu_torch.mcts.hybrid import make_hybrid_root_fn
from alphazero_tpu_torch.mcts.search import dense_root_fn
from alphazero_tpu_torch.models import (
    convert_az_resnet,
    convert_mlp,
    make_apply_fn,
    make_uniform_model,
    random_az_resnet_variables,
    random_mlp_variables,
)


def timeit(fn, device, n: int = 3) -> float:
    """Seconds a call: one warm-up call, then the mean of ``n``."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / n


def emit(name: str, ms: float, **detail) -> None:
    print(json.dumps({"bench": name, "move_ms": round(ms, 1), **detail}), flush=True)


def engines_for(game, apply_fn, cfg: MCTSConfig) -> dict:
    """``name -> root_counts(state)`` of every engine that takes the case."""
    out = {}
    fused = make_fused_root_fn(game, apply_fn, cfg)
    if fused is not None:
        out["fused"] = fused
    hybrid = make_hybrid_root_fn(game, apply_fn, cfg)
    if hybrid is not None:
        out["hybrid"] = hybrid
    if cfg.parallel_sims == 1:
        out["dense"] = dense_root_fn(game, apply_fn, cfg)
    return out


def cases(device) -> list:
    """``(name, game, model thunk, batch, MCTSConfig overrides)`` of the JAX
    script's cases, in its order."""
    c4, oth, hx = ConnectFour(), Othello(), Hex()
    gmk, gmk15, gmk7 = Gomoku(), Gomoku(15), Gomoku(7)

    def mlp(game, seed):
        cells = game.feature_shape[0] * game.feature_shape[1]
        return lambda: convert_mlp(random_mlp_variables(game.num_actions, (256, 256), cells=cells,
                                                        seed=seed)).to(device)

    def uniform(game):
        return lambda: make_uniform_model(game)

    out = [
        ("c4_uniform_B4096_100sims", c4, uniform(c4), 4096, {}),
        ("c4_mlp_B4096_100sims", c4, mlp(c4, 0), 4096, {}),
        ("c4_resnet_B4096_100sims", c4, lambda: convert_az_resnet(
            random_az_resnet_variables(7, 64, 5, seed=1), dtype=torch.bfloat16).to(device),
         4096, {}),
    ]
    out += [(f"oth_uniform_B{b}_100sims", oth, uniform(oth), b, {"max_depth": 80})
            for b in (1024, 4096)]
    out += [("oth_uniform_B4096_100sims_K4", oth, uniform(oth), 4096,
             {"max_depth": 80, "parallel_sims": 4}),
            ("gomoku_uniform_B4096_100sims", gmk, uniform(gmk), 4096, {"max_depth": 48})]
    out += [(f"gomoku15_uniform_B{b}_100sims", gmk15, uniform(gmk15), b, {"max_depth": 64})
            for b in (1024, 4096)]
    out += [("gomoku15_mlp_B1024_100sims", gmk15, mlp(gmk15, 3), 1024, {"max_depth": 64}),
            ("gomoku7_uniform_B4096_100sims", gmk7, uniform(gmk7), 4096, {"max_depth": 48})]
    out += [(f"hex_uniform_B{b}_100sims", hx, uniform(hx), b, {"max_depth": 56})
            for b in (1024, 4096)]
    out += [("hex_mlp_B1024_100sims", hx, mlp(hx, 2), 1024, {"max_depth": 56})]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sims", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None,
                    help="games a search in place of each case's (a smoke run)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    only = os.environ.get("AZ_BENCH_ONLY", "")
    for name, game, model, B, over in cases(device):
        if only and only not in name:
            continue
        B = args.batch or B
        cfg = MCTSConfig(num_sims=args.sims, max_depth=over.get("max_depth", 48),
                         parallel_sims=over.get("parallel_sims", 1))
        apply_fn = make_apply_fn(model())
        state = game.init(B, device)
        for ename, fn in engines_for(game, apply_fn, cfg).items():
            ms = timeit(lambda: fn(state), device) * 1e3
            emit(name, ms, engine=ename, batch=B, backend=device.type)
        del apply_fn, state


if __name__ == "__main__":
    main()
