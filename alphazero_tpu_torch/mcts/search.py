"""The dense engine: lockstep PUCT search over whole trees in plain PyTorch.

Counterpart of ``alphazero_tpu/mcts/search.py`` (the JAX package's general
XLA engine). It takes any game and any model: the engine ladder's last
rung (``selfplay._make_root_counts_fn``, below the fused and hybrid
engines, for games without flat ops or with a cutoff heuristic their flat
ops cannot evaluate), the only engine for forced playouts
(``MCTSConfig.forced_playouts``), and the search of the play and analyze
CLIs. ``B`` trees advance one simulation per step, in lockstep:

* one pass scores every edge of every tree (``dense_puct_scores``: the
  hybrid engine's ``_score_plane``, so both engines round alike) and
  reduces it to each node's first-max PUCT action and its child code
  (``best_planes``): statistics are frozen during a descent, so the argmax
  is a function of the node;
* the descent (``select``) walks those planes from the root by ``gather``,
  one level at a time, with one host synchronisation a level to stop once
  no game is still descending (the JAX ``while_loop(any(active))``);
* expansion, evaluation and backup (``expand_backup``): every game steps
  ``(parent state, action)`` — a game that did not expand steps node 0's
  state with action 0, which is total — and every game's leaf goes through
  ONE model forward; an expanded game installs its child at the lockstep
  slot ``cursor`` (unless the slot is past the capacity: the value still
  backs up, nothing is installed or linked) and links it to its parent;
  the leaf value (the model's or the terminal one at an expansion, the
  stored terminal value at a terminal child, the game's cutoff heuristic of
  the cutoff node's stored state at the depth limit, 0 where the game's
  heuristic is zero) is backed up along the path with negamax signs by one
  scatter (a path holds each edge once, so the adds are exact).

Semantics kept bit for bit (tests hold the root counts and the decoded
trees against the JAX engine, the frozen goldens and the C++ oracle): PUCT
``q + cpuct * p * sqrt(sum N + EPS) / (1 + n)`` with ``q = w / max(n, 1)``
and illegal edges at -1e30, first-max ties, the depth cutoff ``depth + 1 >=
max_depth``, terminal roots that never search, the cursor that advances for
every game every simulation, and the forced-playouts bonus as the JAX
engine adds it (``make_search_fn``). The engine calls no kernel: it keeps
its own planes, so it never needs the hybrid engine's seeds
(``kernels.refresh``/``refresh2``, right only on a fresh search's planes).

Not ported (ROADMAP, "Do not port"): ``search.from_tree`` (``search_from``,
which serves only ``tree_reuse``) and the ``_ablate`` knobs, which measure
XLA fusion on a TPU and which no caller passes.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from alphazero_tpu_torch.config import MCTSConfig, PUCT_EPS
from alphazero_tpu_torch.mcts.hybrid import _first_max, _score_plane
from alphazero_tpu_torch.mcts.tree import (
    INVALID_P,
    NODE_TERM,
    NODE_TVAL,
    PLANE_CHILD,
    PLANE_N,
    PLANE_P,
    PLANE_W,
    Tree,
    init_tree,
)
from alphazero_tpu_torch.ops import masked_policy, root_prior

# the forced root children's score bonus (``forced_puct_scores``)
FORCED_BONUS = 1e9


def dense_puct_scores(stats: torch.Tensor, cpuct: float) -> torch.Tensor:
    """PUCT scores f32[B, A, C] of every edge of every tree (illegal edges
    -1e30), from the node records ``stats f32[B, C, 4, A]``."""
    n, w, p = (stats[:, :, plane].transpose(1, 2) for plane in (PLANE_N, PLANE_W, PLANE_P))
    return _score_plane(n, w, p, cpuct, torch.sqrt(n.sum(dim=1) + PUCT_EPS))


def _root_stats(stats: torch.Tensor):
    """The root's (n, w, p) f32[B, A], p with illegal edges at 0."""
    n, w, p = (stats[:, 0, plane] for plane in (PLANE_N, PLANE_W, PLANE_P))
    return n, w, torch.where(p <= INVALID_P * 0.5, 0.0, p)


def _forced_root_mask(stats: torch.Tensor, k: float) -> torch.Tensor:
    """KataGo forced playouts (Wu 2020 §3.2): f32[B, A] 0/1, the root
    children with ``n < sqrt(k * P * sum n)`` (P the noised root prior),
    which must be searched."""
    n, _, p = _root_stats(stats)
    n_forced = torch.sqrt(k * p * n.sum(dim=-1, keepdim=True))
    return ((n < n_forced) & (p > 0)).float()


def pruned_root_counts(tree: Tree, k: float, cpuct: float) -> torch.Tensor:
    """Policy-target pruning (Wu 2020 §3.2): f32[B, A] root counts with the
    forced playouts subtracted back out, the training target (the move
    plays from the raw counts). Each child but the most visited loses up to
    its forced quota, never below the count at which its PUCT would pass
    the most visited child's (those visits were earned), and is zeroed if
    left with at most one playout."""
    n, w, p = _root_stats(tree.stats)
    q = w / n.clamp(min=1.0)
    n_total = n.sum(dim=-1, keepdim=True)
    sqrt_total = torch.sqrt(n_total + PUCT_EPS)
    puct = torch.where(p > 0, q + cpuct * p * sqrt_total / (1.0 + n), -torch.inf)
    is_best = F.one_hot(n.argmax(dim=-1), n.shape[-1]).bool()
    puct_best = torch.where(is_best, puct, 0.0).sum(dim=-1, keepdim=True)
    n_forced = torch.sqrt(k * p * n_total)
    # the count floor where PUCT(child) == PUCT(best)
    gap = puct_best - q
    n_keep = torch.where(gap > 0, cpuct * p * sqrt_total / gap.clamp(min=1e-9) - 1.0, n)
    n_keep = torch.minimum(n_keep.clamp(min=0.0), n)
    pruned = n - torch.minimum(n_forced, n - n_keep)
    pruned = torch.where(pruned <= 1.0, 0.0, pruned)
    return torch.where(is_best, n, pruned.clamp(min=0.0))


def forced_puct_scores(stats: torch.Tensor, cpuct: float, k: float) -> torch.Tensor:
    """``dense_puct_scores`` with the root's forced children
    (``_forced_root_mask``) raised by ``FORCED_BONUS``, as the JAX engine's
    f32 add ``score + 1e9 * bonus``: near 1e9 an f32 step is 64, so every
    forced child scores exactly 1e9 and the first-max takes the
    lowest-index one, not the one of highest PUCT as the JAX comment says
    (kept for parity: ROADMAP queue 3)."""
    score = dense_puct_scores(stats, cpuct)
    score[:, :, 0] = score[:, :, 0] + FORCED_BONUS * _forced_root_mask(stats, k)
    return score


def make_engine_parts(game, apply_fn: Callable, cfg: MCTSConfig) -> dict:
    """The engine's machinery, for engines that share its tree mechanics
    but score differently: ``best_planes(tree, score) -> (best_a i64[B,
    C], best_code f32[B, C])``; ``select(tree, best_a, best_code) -> sel``
    (the descent, a dict of per-game tensors: ``depth``, ``path_n``,
    ``path_a`` [B, levels], ``exp_mask``, ``exp_parent``, ``exp_action``,
    ``term_mask``, ``cut_mask``, ``leaf_node``); ``expand_backup(tree, sel)
    -> (tree, (exp_ok, slot, v_nn))`` (expansion, one model forward, the
    backup; the tree's tensors are updated in place); ``select_state(state,
    nodes)``; ``simulate(tree) -> tree`` composes them with the PUCT
    scores. ``apply_fn(features) -> (logits f32[B, A], value f32[B])``."""
    A = game.num_actions
    C = cfg.nodes
    D = cfg.max_depth
    cpuct = float(cfg.cpuct)
    # a game whose cutoff heuristic is identically zero backs up 0 there
    zero_heuristic = bool(getattr(game, "heuristic_is_zero", False))
    needs_features = getattr(apply_fn, "needs_features", True)
    state_shape = tuple(game.init(1, "cpu").shape[1:])

    def select_state(state: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
        """Node ``nodes[b]``'s game state of every tree, ``[B, *state]``."""
        rows = torch.arange(state.shape[0], device=state.device)
        return state[rows, nodes].reshape(-1, *state_shape)

    def best_planes(tree: Tree, score: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each node's first-max action of ``score f32[B, A, C]`` and that
        edge's child code, [B, C] each: computed once a simulation, since
        the statistics are frozen during the descent."""
        iota = torch.arange(A, device=score.device, dtype=score.dtype)[None, :, None]
        best_a = _first_max(score, iota).long()
        return best_a, tree.stats[:, :, PLANE_CHILD].gather(2, best_a[:, :, None])[:, :, 0]

    def select(tree: Tree, best_a: torch.Tensor, best_code: torch.Tensor) -> dict:
        """Descend every tree from its root along the best planes until an
        unexpanded edge, a terminal child or the depth limit."""
        B = best_a.shape[0]
        dev = best_a.device
        node = torch.zeros(B, dtype=torch.long, device=dev)
        depth = torch.zeros(B, dtype=torch.long, device=dev)
        active = tree.node[:, 0, NODE_TERM] < 0.5   # a terminal root never searches
        path_n, path_a = [], []
        for level in range(D):
            if not bool(active.any()):
                break
            a = best_a.gather(1, node[:, None])[:, 0]
            code = best_code.gather(1, node[:, None])[:, 0]
            path_n.append(node)
            path_a.append(a)
            depth = depth + active
            # only a live child (code >= 0) is entered, above the cutoff
            go = active & (code > -0.5) & (level + 1 < D)
            node = torch.where(go, code.long(), node)
            active = go
        empty = torch.zeros((B, 0), dtype=torch.long, device=dev)
        path_n = torch.stack(path_n, dim=1) if path_n else empty
        path_a = torch.stack(path_a, dim=1) if path_a else empty
        # each game stopped at its last level: (last_node, last_a) is the
        # edge it stopped on and last_code that edge's child code
        did = depth > 0
        last = (depth - 1).clamp(min=0)[:, None]
        last_node = path_n.gather(1, last)[:, 0] if path_n.shape[1] else depth
        last_a = path_a.gather(1, last)[:, 0] if path_a.shape[1] else depth
        last_code = best_code.gather(1, last_node[:, None])[:, 0]
        cterm = last_code < -1.5                       # terminal child: code -2 - slot
        unexp = (last_code < -0.5) & ~cterm
        exp_mask = did & unexp
        stop_leaf = did & ~unexp                        # a terminal child or the cutoff
        child = torch.where(cterm, -2.0 - last_code, last_code).long()
        return {
            "depth": depth,
            "path_n": path_n,
            "path_a": path_a,
            "exp_mask": exp_mask,
            "exp_parent": torch.where(exp_mask, last_node, 0),
            "exp_action": torch.where(exp_mask, last_a, 0),
            "term_mask": did & cterm,
            "cut_mask": did & ~unexp & ~cterm,
            "leaf_node": torch.where(stop_leaf, child, 0),
        }

    def expand_backup(tree: Tree, sel: dict):
        """Expansion + one model forward + negamax backup for a finished
        descent ``sel``: the engine's write half, shared by every scoring
        rule. Updates the tree in place and returns ``(tree, (exp_ok, slot,
        v_nn))``."""
        stats, node, state = tree.stats, tree.node, tree.state
        B = stats.shape[0]
        rows = torch.arange(B, device=stats.device)
        # ---- expand: every game steps (a game that did not expand steps
        # node 0's state with action 0; the step is total)
        new_state = game.step(select_state(state, sel["exp_parent"]), sel["exp_action"])
        new_valid = game.valid_moves(new_state)
        new_done, new_tval = game.terminal(new_state)
        s = tree.cursor
        exp_ok = sel["exp_mask"] & (s < C)

        # ---- evaluate every game's leaf in one forward
        if needs_features:
            feats = game.to_features(new_state)
        else:
            feats = torch.zeros((B, 1), device=stats.device)
        logits, v_nn = apply_fn(feats)
        p_masked = torch.where(new_valid, masked_policy(logits, new_valid), INVALID_P)

        # ---- the leaf value, from the leaf's player-to-move perspective,
        # read before the install (the leaf is an installed node)
        v_expand = torch.where(new_done, new_tval, v_nn)
        v_term = node[rows, sel["leaf_node"], NODE_TVAL]
        if zero_heuristic:
            v_cut = torch.zeros_like(v_term)
        else:
            v_cut = game.eval_heuristic(select_state(state, sel["leaf_node"]))
        v_leaf = torch.where(sel["exp_mask"], v_expand,
                             torch.where(sel["term_mask"], v_term, v_cut))

        # ---- install the new node at its slot (a row write per game; a
        # game that installs nothing writes its slot's own values back)
        slot = s.clamp(max=C - 1)
        zeros = torch.zeros_like(p_masked)
        record = torch.stack([zeros, zeros, p_masked, zeros - 1.0], dim=1)       # [B, 4, A]
        stats[rows, slot] = torch.where(exp_ok[:, None, None], record, stats[rows, slot])
        info = torch.stack([new_done.float(), new_tval], dim=1)
        node[rows, slot] = torch.where(exp_ok[:, None], info, node[rows, slot])
        state[rows, slot] = torch.where(exp_ok[:, None], new_state.reshape(B, -1),
                                        state[rows, slot])
        # parent -> child link: code -2 - slot for a terminal child
        s_f = s.float()
        link = torch.where(new_done, -2.0 - s_f, s_f)
        at = (rows, sel["exp_parent"], PLANE_CHILD, sel["exp_action"])
        stats[at] = torch.where(exp_ok, link, stats[at])

        # ---- backup: edge d of the path gets N += 1, W += v_leaf signed
        # by the parity of its distance to the leaf (one scatter: a path
        # holds each edge at most once, and levels past a game's depth add 0)
        depth, path_n, path_a = sel["depth"], sel["path_n"], sel["path_a"]
        d = torch.arange(path_n.shape[1], device=stats.device)[None, :]
        on = (d < depth[:, None]).float()
        sign = torch.where((depth[:, None] - d) % 2 == 1, -1.0, 1.0)
        edge = ((rows[:, None] * C + path_n) * 4) * A + path_a
        stats.view(-1).scatter_add_(
            0, torch.cat([edge + PLANE_N * A, edge + PLANE_W * A], dim=1).reshape(-1),
            torch.cat([on, sign * v_leaf[:, None] * on], dim=1).reshape(-1))
        out = tree._replace(count=tree.count + exp_ok.int(), cursor=s + 1)
        return out, (exp_ok, s, v_nn)

    def simulate(tree: Tree) -> Tree:
        """One simulation of every game: select, expand, evaluate, back up."""
        best_a, best_code = best_planes(tree, dense_puct_scores(tree.stats, cpuct))
        tree, _ = expand_backup(tree, select(tree, best_a, best_code))
        return tree

    return {
        "select_state": select_state,
        "best_planes": best_planes,
        "select": select,
        "expand_backup": expand_backup,
        "simulate": simulate,
    }


def make_search_fn(game, apply_fn: Callable, cfg: MCTSConfig):
    """Build ``search(root_state, dirichlet=None, num_sims=None) -> Tree``.

    ``root_state`` is a batch of game states ``[B, ...]``; the trees live on
    its device. The root prior is the model's masked prior, mixed with the
    injected Dirichlet sample ``dirichlet f32[B, A]`` when
    ``cfg.dirichlet_alpha`` is set (``ops.root_prior``). With
    ``cfg.forced_playouts = k`` the root's forced children are searched
    first (``forced_puct_scores``)."""
    C = cfg.nodes
    cpuct = float(cfg.cpuct)
    parts = make_engine_parts(game, apply_fn, cfg)
    simulate = parts["simulate"]
    forced_k = getattr(cfg, "forced_playouts", None)
    if forced_k is not None:
        best_planes, select, expand_backup = (parts[k] for k in ("best_planes", "select",
                                                                 "expand_backup"))

        def simulate(tree: Tree) -> Tree:
            score = forced_puct_scores(tree.stats, cpuct, float(forced_k))
            tree, _ = expand_backup(tree, select(tree, *best_planes(tree, score)))
            return tree

    def search(root_state: torch.Tensor, dirichlet: Optional[torch.Tensor] = None,
               num_sims: Optional[int] = None) -> Tree:
        sims = cfg.num_sims if num_sims is None else num_sims
        tree = init_tree(game, root_state, C)
        prior, root_valid = root_prior(game, apply_fn, cfg, root_state, dirichlet)
        tree.stats[:, 0, PLANE_P] = torch.where(root_valid, prior, INVALID_P)
        for _ in range(sims):
            tree = simulate(tree)
        return tree

    return search


def dense_root_fn(game, apply_fn: Callable, cfg: MCTSConfig) -> Callable[..., torch.Tensor]:
    """``root_counts(root_state, dirichlet=None) -> f32[B, A]`` on the dense
    engine: the engine ladder's last rung."""
    search = make_search_fn(game, apply_fn, cfg)

    def root_counts(root_state: torch.Tensor, dirichlet: Optional[torch.Tensor] = None):
        return search(root_state, dirichlet).root_counts()

    return root_counts
