"""Batched model-vs-model arena and the gate.

Counterpart of ``alphazero_tpu/arena.py``. All arena games advance in
lockstep: the first ``(B + 1) // 2`` seat the candidate first, the rest
the incumbent; every move is the greedy argmax of the side to move's root
visit counts, ties broken by injected uniforms (``action_probs`` at
temperature 0); a finished game stays frozen. The result is counted from
the candidate's side.

The search routes are the JAX package's ladder:

* both models evaluate inside the fused kernel (the uniform model, or an
  ``MLPNet`` the kernel's evaluator takes): each side searches the whole
  batch with its own fused call, and the played counts are row-selected
  by whose turn it is in each game;
* otherwise the hybrid engine (the dense engine for a game it declines)
  searches with the *combined forward*: both models evaluate every leaf
  batch and the rows are selected per game by the root's mover
  (``combined_apply``; at ``parallel_sims = K`` the selector is tiled K
  times, as the rounds stack their leaves K-major);
* ``mcts_cfg_inc`` (asymmetric budgets, the anchor ladder's rungs): each
  side searches the whole batch with its own budget, on its fused call
  where it has one and on the combined forward where not, and the counts
  are row-selected;
* ``mcts_cfg.gumbel``: Gumbel search (``mcts/gumbel.py``) with the combined
  forward, and the move is its halving winner; each move's draw
  ``tie_draws(t)`` is then the search's root Gumbel sample, which keeps
  the games from collapsing onto one line (``tie_draws_from(...,
  gumbel=True)``);
* ``mcts_cfg.transposition``: both seats search with the transposition
  engine (``mcts/tt.py``) on the combined forward.

Under a ``mesh`` (``parallel/``) each rank plays its share of the games
(``batch_sharding``, in rank order: the seating is the global batch's),
takes its rows of every move's global tie draws, and the four totals are
summed over the ranks, so every rank returns the one-process result.

The JAX package demotes the second of two hybrid engines to its XLA
engine in an asymmetric arena, to avoid a TPU compiler fault; here both
sides run on the port's kernels. ``host_chunk`` and ``state_sharding``
served the TPU and are not ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.mcts.fused import make_fused_root_fn
from alphazero_tpu_torch.mcts.gumbel import check_gumbel_config, make_gumbel_search_fn
from alphazero_tpu_torch.mcts.hybrid import make_hybrid_root_fn
from alphazero_tpu_torch.mcts.search import dense_root_fn
from alphazero_tpu_torch.mcts.tt import tt_root_fn
from alphazero_tpu_torch.models import make_apply_fn
from alphazero_tpu_torch.ops import action_probs, gumbel_from_uniform
from alphazero_tpu_torch.parallel.distributed import all_reduce
from alphazero_tpu_torch.parallel.mesh import Mesh, batch_sharding

TieDraws = Callable[[int], torch.Tensor]


class ArenaResult(NamedTuple):
    """Aggregate outcome from the CANDIDATE's side."""

    cand_wins: int
    inc_wins: int
    draws: int
    unfinished: int   # games that reached max_moves unfinished


def gate(result: ArenaResult, update_threshold) -> bool:
    """Accept the candidate iff wins / (wins + losses) >= threshold; no
    decisive game keeps the incumbent; ``None`` (continuous mode) always
    accepts."""
    if update_threshold is None:
        return True
    cw = int(result.cand_wins)
    iw = int(result.inc_wins)
    if cw + iw == 0:
        return False
    return cw / (cw + iw) >= update_threshold


def combined_apply(apply_cand: Callable, apply_inc: Callable, cand_to_move: torch.Tensor) -> Callable:
    """The two-model forward of a mixed-seating batch: both models evaluate
    every row, and row ``i`` of game ``i % B`` takes the candidate's output
    where ``cand_to_move`` bool[B] says the candidate moves at that game's
    root (leaf batches of ``K * B`` rows are stacked K-major)."""

    def apply_fn(feats: torch.Tensor):
        lc, vc = apply_cand(feats)
        li, vi = apply_inc(feats)
        sel = cand_to_move.repeat(feats.shape[0] // cand_to_move.shape[0])
        return torch.where(sel[:, None], lc, li), torch.where(sel, vc, vi)

    apply_fn.needs_features = (getattr(apply_cand, "needs_features", True)
                               or getattr(apply_inc, "needs_features", True))
    return apply_fn


def tie_draws_from(generator: torch.Generator, batch: int, num_actions: int, device,
                   gumbel: bool = False) -> TieDraws:
    """``tie_draws(t)``: the tie uniforms f32[B, A] of each move, drawn in
    move order from ``generator`` (on ``device``); with ``gumbel``, a
    Gumbel arena's root samples ``-log(-log(u))`` of them."""
    def tie_draws(t):
        u = torch.rand((batch, num_actions), generator=generator, device=device)
        return gumbel_from_uniform(u) if gumbel else u

    return tie_draws


def make_arena_fn(
    game,
    mcts_cfg: MCTSConfig,
    num_games: int,
    mcts_cfg_inc: Optional[MCTSConfig] = None,
    device="cuda",
    mesh=None,
):
    """Build ``play(model_cand, model_inc, tie_draws) -> ArenaResult``.

    The models are any the search takes (``UniformModel``, ``AZResNet``, ``AZConvNet``,
    ``MLPNet``), and may differ in kind; each ``play`` builds their search
    ``apply_fn`` once (a conv net refolded, an MLPNet repacked), so a
    model trained between calls plays with its new weights.
    ``tie_draws(t)`` gives the tie uniforms f32[B, A] of move ``t``
    (``tie_draws_from``), or with ``mcts_cfg.gumbel`` the root Gumbel
    samples. ``mcts_cfg_inc`` gives the incumbent side its own search
    config. The move loop stops once every game is done: a move past that
    point changes nothing. ``mesh`` splits the games over its ranks (the
    module's docstring); ``num_games`` must divide over them."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh (parallel.make_mesh), not "
                        f"{type(mesh).__name__}")
    rows = slice(None) if mesh is None else batch_sharding(mesh, num_games, "arena's games")
    B = num_games
    T = game.max_moves
    if mcts_cfg_inc == mcts_cfg:
        mcts_cfg_inc = None
    gumbel = getattr(mcts_cfg, "gumbel", False)
    transposition = getattr(mcts_cfg, "transposition", False)
    if mcts_cfg_inc is not None and (gumbel or transposition):
        raise ValueError(
            "asymmetric per-side budgets (mcts_cfg_inc) are a PUCT-engine "
            "feature — not supported with gumbel/transposition arenas"
        )
    if gumbel:
        check_gumbel_config(mcts_cfg)
    cfg_inc = mcts_cfg_inc or mcts_cfg

    def hybrid(cfg, apply_c, apply_i):
        """The combined forward on the hybrid engine, or on the dense one
        for a game the hybrid engine declines."""
        def root_counts(state, ctm):
            apply_fn = combined_apply(apply_c, apply_i, ctm)
            return (make_hybrid_root_fn(game, apply_fn, cfg)
                    or dense_root_fn(game, apply_fn, cfg))(state)

        return root_counts

    def root_counts_fn(apply_c, apply_i) -> Callable:
        """``root_counts(state, cand_to_move) -> f32[B, A]``, the counts
        each game's side to move plays from."""
        fused_c = make_fused_root_fn(game, apply_c, mcts_cfg)
        fused_i = make_fused_root_fn(game, apply_i, cfg_inc)
        if mcts_cfg_inc is None and (fused_c is None or fused_i is None):
            return hybrid(mcts_cfg, apply_c, apply_i)
        rc_c = (lambda state, ctm: fused_c(state)) if fused_c is not None else hybrid(
            mcts_cfg, apply_c, apply_i)
        rc_i = (lambda state, ctm: fused_i(state)) if fused_i is not None else hybrid(
            cfg_inc, apply_c, apply_i)
        return lambda state, ctm: torch.where(ctm[:, None], rc_c(state, ctm), rc_i(state, ctm))

    def move_fn(apply_c, apply_i) -> Callable:
        """``move(state, cand_to_move, draw) -> action i64[B]``: the greedy
        argmax of the counts with ties broken by the uniforms ``draw``, or
        the Gumbel search's winner from the root sample ``draw``."""
        if gumbel:
            return lambda state, ctm, draw: make_gumbel_search_fn(
                game, combined_apply(apply_c, apply_i, ctm), mcts_cfg)(state, draw).action
        if transposition:
            root_counts = lambda state, ctm: tt_root_fn(
                game, combined_apply(apply_c, apply_i, ctm), mcts_cfg)(state)
        else:
            root_counts = root_counts_fn(apply_c, apply_i)
        return lambda state, ctm, draw: action_probs(root_counts(state, ctm), 0.0,
                                                     draw).argmax(dim=-1)

    def play(model_cand, model_inc, tie_draws: TieDraws) -> ArenaResult:
        move = move_fn(make_apply_fn(model_cand), make_apply_fn(model_inc))
        cand_to_move = (torch.arange(B, device=device) < (B + 1) // 2)[rows]
        b = cand_to_move.shape[0]
        state = game.init(b, device)
        done = torch.zeros(b, dtype=torch.bool, device=device)
        winner_cand = torch.zeros(b, dtype=torch.bool, device=device)
        is_draw = torch.zeros(b, dtype=torch.bool, device=device)
        for t in range(T):
            if bool(done.all()):
                break
            nxt = game.step(state, move(state, cand_to_move, tie_draws(t)[rows]))
            state = torch.where(done.reshape((-1,) + (1,) * (nxt.ndim - 1)), state, nxt)
            now_done, tv = game.terminal(state)
            ended = ~done & now_done
            # tv < 0: the player to move lost, so the mover won
            mover_won = tv < -0.5
            to_move_won = tv > 0.5
            won_cand = torch.where(mover_won, cand_to_move, ~cand_to_move)
            winner_cand = torch.where(ended & (mover_won | to_move_won), won_cand, winner_cand)
            is_draw = is_draw | (ended & ~mover_won & ~to_move_won)
            done = done | now_done
            cand_to_move = torch.where(done, cand_to_move, ~cand_to_move)
        decisive = done & ~is_draw
        totals = torch.stack([
            (decisive & winner_cand).sum(), (decisive & ~winner_cand).sum(),
            (done & is_draw).sum(), (~done).sum(),
        ])
        if mesh is not None:
            totals = all_reduce(totals, mesh)
        totals = totals.tolist()
        return ArenaResult(*(int(x) for x in totals))

    return play
