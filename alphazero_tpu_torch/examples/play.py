"""What the play CLIs share: their options, and the engine's move (the
dense engine's search of the position, greedy on its visit counts, as the
JAX CLIs play)."""

from __future__ import annotations

import argparse

import torch


def parser(doc: str, sims: int, hidden: int, model_help: str) -> argparse.ArgumentParser:
    """The options every play CLI takes (the JAX CLI's, with its defaults)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--sims", type=int, default=sims)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--model", choices=["mlp", "resnet"], default="mlp", help=model_help)
    ap.add_argument("--hidden", type=int, default=hidden)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--human-first", action="store_true")
    return ap


def engine(game, args, max_depth: int):
    """``(device, move)``: the device (the card unless ``--cpu``) and
    ``move(state) -> (action, counts np[A], Q of the action)`` for a
    one-game state, searching with the model of ``--checkpoint-dir`` (the
    uniform prior when it holds no checkpoint)."""
    from alphazero_tpu_torch.config import MCTSConfig
    from alphazero_tpu_torch.examples.eval_checkpoints import load_side
    from alphazero_tpu_torch.mcts import make_search_fn
    from alphazero_tpu_torch.models import make_apply_fn

    device = torch.device("cpu" if args.cpu else "cuda")
    model, label = load_side(game, args.checkpoint_dir, args.model, args.hidden, 64, 5,
                             device=device, allow_missing=True)
    print(f"model: {label}")
    search = make_search_fn(game, make_apply_fn(model),
                            MCTSConfig(num_sims=args.sims, max_depth=max_depth))

    def move(state):
        tree = search(state)
        counts = tree.root_counts()[0].cpu().numpy()
        a = int(counts.argmax())
        return a, counts, float(tree.root_q()[0, a])

    return device, move
