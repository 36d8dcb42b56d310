"""The transposition-DAG engine: PUCT over node statistics with exact-state dedup.

Counterpart of ``alphazero_tpu/mcts/tt.py``, the opt-in engine of
``MCTSConfig.transposition`` for deep searches. Plain PyTorch, no kernel
(the JAX engine is plain XLA). ``B`` DAGs advance one simulation per step,
in lockstep, as in the dense engine (``mcts/search.py``), with three
differences that make the tree a DAG:

* **node statistics**: N and W live per node (``nstats``), so every parent
  of a node reads the same Q; W is stored from the parent-to-move
  perspective, as the canonical board fixes whose turn it is. A child's
  N/W are read through the child-code plane by ``gather``, and a node's
  visit total is the sum of its children's N (not its own N: in a DAG the
  two differ);
* **the exact-state probe**: the DAG's own state rows are the table. A
  stepped state is compared with every materialised node's state, one
  ``[B, C, L]`` pass, and the lowest matching slot is its canonical node;
* **dedup-continue descents**: an unexpanded edge whose stepped state is
  already in the DAG is linked to that node and the descent goes on
  through it, using no slot, so one simulation may link several edges
  before it expands. Each ``(node, action)`` link is recorded once a
  descent (a cyclic state graph walks the same unexpanded edge again) and
  the links are written after the descent.

The layout is node-major like the dense engine's ``Tree``: ``nstats f32[B,
C, 2]`` (N, W), ``pstats f32[B, C, 2, A]`` (masked prior, child code: -1
unexpanded, the slot of a live child, ``-2 - slot`` of a terminal one),
``node f32[B, C, 3]`` (terminal, terminal value, materialised) and
``state [B, C, L]``; the JAX DAG's ``[B, planes, ..., C]`` planes are their
transposes. The descent walks the per-node best planes by ``gather`` with
one host synchronisation a level (the JAX ``while_loop(any(active))``).

Semantics kept bit for bit (tests hold the decoded DAGs against the JAX
engine and the root counts and links against the C++ oracle
``csrc/tt_oracle.cpp``): ``q = w / max(n, 1)`` (w is 0 wherever n is),
``u = cpuct * p * sqrt(sum n + EPS) / (1 + n)``, illegal edges at -1e30,
first-max ties; the lockstep cursor that advances for every game every
simulation, expansion only while ``cursor < C``, an out-of-capacity
expansion that still backs up its value; the depth cutoff ``depth + 1 >=
max_depth`` with the game's heuristic (0 where it is zero); the backup onto
the path's nodes (the expanded node joins it, the root does not) with the
sign flipped at odd distance, each node's terms summed before the one add
(a node can sit on a cyclic path twice); terminal roots search nothing.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from alphazero_tpu_torch.config import MCTSConfig, PUCT_EPS
from alphazero_tpu_torch.mcts.hybrid import _first_max, _score_plane
from alphazero_tpu_torch.mcts.tree import INVALID_P, UNVISITED, np_prod
from alphazero_tpu_torch.ops import masked_policy, root_prior

# nstats planes, pstats planes, node planes
STAT_N, STAT_W = 0, 1
EDGE_P, EDGE_CHILD = 0, 1
NODE_TERM, NODE_TVAL, NODE_LIVE = 0, 1, 2


def _decode(code: torch.Tensor) -> torch.Tensor:
    """Child slots of child codes (a terminal child's ``-2 - slot`` decodes
    to ``slot``, an unexpanded edge to -1)."""
    return torch.where(code < -1.5, -2.0 - code, code).long()


def _expanded(code: torch.Tensor) -> torch.Tensor:
    return (code > -0.5) | (code < -1.5)


class TTTree(NamedTuple):
    """Batched search DAGs: B games, C node slots, A actions."""

    nstats: torch.Tensor   # f32[B, C, 2] (N | W, W from the parent-to-move view)
    pstats: torch.Tensor   # f32[B, C, 2, A] (masked prior | child code)
    node: torch.Tensor     # f32[B, C, 3] (terminal | terminal value | materialised)
    state: torch.Tensor    # [B, C, L] each node's game state, flattened
    count: torch.Tensor    # i32[B] materialised nodes
    cursor: torch.Tensor   # i64[B] the next simulation's slot
    dedup: torch.Tensor    # i32[B] transposition links made

    @property
    def capacity(self) -> int:
        return self.nstats.shape[1]

    @property
    def num_actions(self) -> int:
        return self.pstats.shape[3]

    def _root_children(self):
        """(slot i64[B, A], expanded bool[B, A]) of the root's edges."""
        code = self.pstats[:, 0, EDGE_CHILD]
        return _decode(code).clamp(0, self.capacity - 1), _expanded(code)

    def root_counts(self) -> torch.Tensor:
        """f32[B, A] visit counts of the root's child nodes."""
        idx, expanded = self._root_children()
        return torch.where(expanded, self.nstats[:, :, STAT_N].gather(1, idx), 0.0)

    def root_q(self) -> torch.Tensor:
        """f32[B, A] the root children's Q from node statistics (W is stored
        from the parent-to-move view: the root's)."""
        idx, _ = self._root_children()
        n = self.nstats[:, :, STAT_N].gather(1, idx)
        w = self.nstats[:, :, STAT_W].gather(1, idx)
        return torch.where(self.root_counts() > 0, w / n.clamp(min=1.0), 0.0)


def init_dag(game, root_state: torch.Tensor, capacity: int) -> TTTree:
    """DAGs with the batched root states materialised in slot 0: their legal
    edges at prior 0 (the search installs the masked root prior), illegal
    ones at INVALID_P, every child code -1. They live on the roots' device."""
    B = root_state.shape[0]
    dev = root_state.device
    A = game.num_actions
    pstats = torch.zeros((B, capacity, 2, A), device=dev)
    pstats[:, :, EDGE_CHILD] = UNVISITED
    pstats[:, 0, EDGE_P] = torch.where(game.valid_moves(root_state), 0.0, INVALID_P)
    done, tval = game.terminal(root_state)
    node = torch.zeros((B, capacity, 3), device=dev)
    node[:, 0, NODE_TERM] = done.float()
    node[:, 0, NODE_TVAL] = tval
    node[:, 0, NODE_LIVE] = 1.0
    state = torch.zeros((B, capacity, np_prod(root_state.shape[1:])), dtype=root_state.dtype,
                        device=dev)
    state[:, 0] = root_state.reshape(B, -1)
    return TTTree(
        nstats=torch.zeros((B, capacity, 2), device=dev),
        pstats=pstats,
        node=node,
        state=state,
        count=torch.ones(B, dtype=torch.int32, device=dev),
        cursor=torch.ones(B, dtype=torch.long, device=dev),
        dedup=torch.zeros(B, dtype=torch.int32, device=dev),
    )


def tt_scores(tree: TTTree, cpuct: float) -> torch.Tensor:
    """PUCT scores f32[B, A, C] of every edge of every DAG (illegal edges
    -1e30): the children's node N and W read through the child codes, the
    parent's total the sum of its children's N."""
    B, C = tree.nstats.shape[:2]
    code = tree.pstats[:, :, EDGE_CHILD]                          # [B, C, A]
    expanded = _expanded(code)
    idx = _decode(code).clamp(0, C - 1).reshape(B, -1)
    n, w = (torch.where(expanded, tree.nstats[:, :, k].gather(1, idx).reshape(code.shape), 0.0)
            .transpose(1, 2) for k in (STAT_N, STAT_W))
    p = tree.pstats[:, :, EDGE_P].transpose(1, 2)
    return _score_plane(n, w, p, cpuct, torch.sqrt(n.sum(dim=1) + PUCT_EPS))


def make_tt_search_fn(game, apply_fn: Callable, cfg: MCTSConfig):
    """Build ``search(root_state, dirichlet=None, num_sims=None) -> TTTree``
    with the transposition-DAG semantics (see the module docstring); K=1
    lockstep only. ``root_state`` is a batch of game states ``[B, ...]``
    and the DAGs live on its device; ``dirichlet`` f32[B, A] is the root
    noise sample when ``cfg.dirichlet_alpha`` is set (``ops.root_prior``).
    ``apply_fn(features) -> (logits f32[B, A], value f32[B])``."""
    if getattr(cfg, "parallel_sims", 1) > 1:
        raise ValueError(
            "the transposition engine is exact-K=1 only — the DAG's "
            "dedup-continue descent has no leaf-parallel round semantics"
        )
    A = game.num_actions
    C = cfg.nodes
    D = cfg.max_depth
    cpuct = float(cfg.cpuct)
    zero_heuristic = bool(getattr(game, "heuristic_is_zero", False))
    needs_features = getattr(apply_fn, "needs_features", True)
    state_shape = tuple(game.init(1, "cpu").shape[1:])

    def best_planes(tree: TTTree):
        """Each node's first-max action i64[B, C] and that edge's child code
        f32[B, C], once a simulation (statistics are frozen in a descent)."""
        score = tt_scores(tree, cpuct)
        iota = torch.arange(A, device=score.device, dtype=score.dtype)[None, :, None]
        best_a = _first_max(score, iota).long()
        return best_a, tree.pstats[:, :, EDGE_CHILD].gather(2, best_a[:, :, None])[:, :, 0]

    def select(tree: TTTree) -> dict:
        """The dedup-continue descent of every DAG, one level a step until no
        game is still descending; returns the per-game record of it."""
        best_a, best_code = best_planes(tree)
        B = best_a.shape[0]
        dev = best_a.device
        rows = torch.arange(B, device=dev)
        iota_c = torch.arange(C, device=dev)
        live_plane = tree.node[:, :, NODE_LIVE] > 0.5
        term_plane, tval_plane = tree.node[:, :, NODE_TERM], tree.node[:, :, NODE_TVAL]
        zeros_b = torch.zeros(B, dtype=torch.long, device=dev)
        false_b = torch.zeros(B, dtype=torch.bool, device=dev)
        c = {
            "node": zeros_b,
            "cur": tree.state[:, 0],
            "depth": zeros_b,
            "active": tree.node[:, 0, NODE_TERM] < 0.5,   # a terminal root never searches
            "path": torch.zeros((B, D), dtype=torch.long, device=dev),
            "link_p": torch.full((B, D), -1, dtype=torch.long, device=dev),
            "link_a": torch.zeros((B, D), dtype=torch.long, device=dev),
            "link_c": torch.zeros((B, D), device=dev),
            "links": torch.zeros(B, dtype=torch.int32, device=dev),
            "exp_mask": false_b,
            "exp_parent": zeros_b,
            "exp_action": zeros_b,
            "term_mask": false_b,
            "cut_mask": false_b,
            "leaf_tval": torch.zeros(B, device=dev),
        }
        for level in range(D):
            active = c["active"]
            if not bool(active.any()):
                break
            nd = c["node"]
            a = best_a.gather(1, nd[:, None])[:, 0]
            code = best_code.gather(1, nd[:, None])[:, 0]
            live = code > -0.5
            ctermc = code < -1.5
            unexp = ~live & ~ctermc
            followed = live | ctermc
            child = _decode(code).clamp(0, C - 1)
            # a live or terminal child: follow the stored edge
            child_flat = tree.state[rows, child]
            child_tval = tval_plane[rows, child]
            # an unexpanded edge: step the carried state and probe the DAG
            new_flat = game.step(c["cur"].reshape(-1, *state_shape), a).reshape(B, -1)
            match = (tree.state == new_flat[:, None, :]).all(dim=-1) & live_plane   # [B, C]
            hit = match.any(dim=-1)
            # the lowest matching slot; a miss reads slot 0, terminal flag and
            # value 0 (the JAX one-hot row is all zero)
            canon = torch.where(hit, torch.where(match, iota_c, C).amin(dim=-1), 0)
            matchf = match.float()
            canon_term = (term_plane * matchf).sum(dim=-1) > 0.5
            canon_tval = (tval_plane * matchf).sum(dim=-1)

            nxt = torch.where(followed, child, canon)
            nxt_term = torch.where(ctermc, True, torch.where(live, False, canon_term))
            nxt_tval = torch.where(followed, child_tval, canon_tval)
            moved = active & (followed | (unexp & hit))
            expand = active & unexp & ~hit

            # an active game's depth is ``level``: it moved at every level before
            c["path"][:, level] = torch.where(moved, nxt, 0)
            # a cyclic state graph can walk the same unexpanded edge twice in
            # one descent: record each (node, action) link once
            dup = ((c["link_p"] == nd[:, None]) & (c["link_a"] == a[:, None])).any(dim=1)
            is_link = active & unexp & hit & ~dup
            c["link_p"][:, level] = torch.where(is_link, nd, -1)
            c["link_a"][:, level] = torch.where(is_link, a, 0)
            c["link_c"][:, level] = torch.where(
                is_link, torch.where(canon_term, -2.0 - canon.float(), canon.float()), 0.0)

            nxt_live = moved & ~nxt_term
            cut = nxt_live & (level + 1 >= D)
            go = nxt_live & ~cut
            c["cur"] = torch.where(active[:, None],
                                   torch.where(followed[:, None], child_flat, new_flat), c["cur"])
            c["node"] = torch.where(go, nxt, nd)
            c["depth"] = c["depth"] + moved
            c["active"] = go
            c["links"] = c["links"] + is_link
            c["exp_mask"] = c["exp_mask"] | expand
            c["exp_parent"] = torch.where(expand, nd, c["exp_parent"])
            c["exp_action"] = torch.where(expand, a, c["exp_action"])
            stop_term = moved & nxt_term
            c["term_mask"] = c["term_mask"] | stop_term
            c["cut_mask"] = c["cut_mask"] | cut
            c["leaf_tval"] = torch.where(stop_term, nxt_tval, c["leaf_tval"])
        return c

    def expand_backup(tree: TTTree, sel: dict) -> TTTree:
        """Install, evaluate and link the expansions, write the descent's
        links and back up along the path's nodes, in place."""
        nstats, pstats, node, state = tree.nstats, tree.pstats, tree.node, tree.state
        B = nstats.shape[0]
        dev = nstats.device
        rows = torch.arange(B, device=dev)
        # the carried state is the leaf's: the stepped board of an expansion,
        # the stopping node's board at a cutoff
        leaf = sel["cur"].reshape(-1, *state_shape)
        new_valid = game.valid_moves(leaf)
        new_done, new_tval = game.terminal(leaf)
        s = tree.cursor
        exp_ok = sel["exp_mask"] & (s < C)
        if needs_features:
            feats = game.to_features(leaf)
        else:
            feats = torch.zeros((B, 1), device=dev)
        logits, v_nn = apply_fn(feats)
        p_masked = torch.where(new_valid, masked_policy(logits, new_valid), INVALID_P)

        # ---- install the expanded node at its slot
        slot = s.clamp(max=C - 1)
        record = torch.stack([p_masked, torch.full_like(p_masked, UNVISITED)], dim=1)
        pstats[rows, slot] = torch.where(exp_ok[:, None, None], record, pstats[rows, slot])
        info = torch.stack([new_done.float(), new_tval, torch.ones_like(new_tval)], dim=1)
        node[rows, slot] = torch.where(exp_ok[:, None], info, node[rows, slot])
        state[rows, slot] = torch.where(exp_ok[:, None], sel["cur"], state[rows, slot])

        # ---- links: the descent's and the expansion's, each (node, action)
        # once, written as the JAX add -1 + (code + 1)
        s_f = s.float()
        link_p = torch.cat([sel["link_p"], torch.where(exp_ok, sel["exp_parent"], -1)[:, None]], 1)
        link_a = torch.cat([sel["link_a"], sel["exp_action"][:, None]], dim=1)
        link_c = torch.cat([sel["link_c"], torch.where(new_done, -2.0 - s_f, s_f)[:, None]], 1)
        on = link_p >= 0
        at = ((rows[:, None] * C + link_p.clamp(min=0)) * 2 + EDGE_CHILD) * A + link_a
        pstats.view(-1).scatter_add_(0, at.reshape(-1),
                                     torch.where(on, link_c + 1.0, 0.0).reshape(-1))

        # ---- backup onto the path's nodes: the expanded node joins the path
        depth = sel["depth"]
        path = torch.cat([sel["path"], torch.zeros_like(sel["path"][:, :1])], dim=1)
        path[rows, depth] = torch.where(exp_ok, s, path[rows, depth])
        depth = depth + exp_ok
        v_expand = torch.where(new_done, new_tval, v_nn)
        if zero_heuristic:
            v_cut = torch.zeros_like(v_nn)
        else:
            v_cut = game.eval_heuristic(leaf)
        v_leaf = torch.where(
            sel["exp_mask"], v_expand,
            torch.where(sel["term_mask"], sel["leaf_tval"],
                        torch.where(sel["cut_mask"], v_cut, 0.0)))
        did_sim = sel["exp_mask"] | sel["term_mask"] | sel["cut_mask"]
        d = torch.arange(path.shape[1], device=dev)[None, :]
        on_path = ((d < depth[:, None]) & did_sim[:, None]).float()
        sign = torch.where((depth[:, None] - d) % 2 == 1, -1.0, 1.0)
        # a node can sit on a cyclic path more than once: sum its terms, then
        # add once
        upd = torch.zeros_like(nstats)
        at = (rows[:, None] * C + path) * 2
        upd.view(-1).scatter_add_(
            0, torch.cat([at + STAT_N, at + STAT_W], dim=1).reshape(-1),
            torch.cat([on_path, sign * v_leaf[:, None] * on_path], dim=1).reshape(-1))
        nstats += upd
        return tree._replace(count=tree.count + exp_ok.int(), cursor=s + 1,
                             dedup=tree.dedup + sel["links"])

    def search(root_state: torch.Tensor, dirichlet: Optional[torch.Tensor] = None,
               num_sims: Optional[int] = None) -> TTTree:
        sims = cfg.num_sims if num_sims is None else num_sims
        tree = init_dag(game, root_state, C)
        prior, root_valid = root_prior(game, apply_fn, cfg, root_state, dirichlet)
        tree.pstats[:, 0, EDGE_P] = torch.where(root_valid, prior, INVALID_P)
        for _ in range(sims):
            tree = expand_backup(tree, select(tree))
        return tree

    return search


def tt_root_fn(game, apply_fn: Callable, cfg: MCTSConfig) -> Callable[..., torch.Tensor]:
    """``root_counts(root_state, dirichlet=None) -> f32[B, A]`` on the
    transposition engine: the engine ladder's rung for
    ``MCTSConfig.transposition``."""
    search = make_tt_search_fn(game, apply_fn, cfg)

    def root_counts(root_state: torch.Tensor, dirichlet: Optional[torch.Tensor] = None):
        return search(root_state, dirichlet).root_counts()

    return root_counts
