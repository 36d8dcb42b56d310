"""Hybrid descend/merge search on the GPU — any model, flat-ops games.

Counterpart of ``alphazero_tpu/mcts/hybrid.py`` on its exact paths, K=1
and K>1 leaf-parallel rounds. The tree's stat planes live in device
memory; each simulation is

1. **descend** (one instance of the CUDA kernel per game, routed by the
   flat ops: ``az_descend`` for Connect-Four, ``az_descend_othello``,
   ``az_descend_gomoku`` for every Gomoku edge up to 22x22,
   ``az_descend_hex``): the whole descent along the per-node PUCT argmax
   planes ``besta/bestc [B, C]``, carrying the board through the game's
   step, writing the path record and the leaf board;
2. **plain torch**: legality/terminality of the leaf boards, the model
   forward (any ``apply_fn``), the leaf value (with the game's depth-cutoff
   heuristic where it is not zero), the slot bookkeeping;
3. **merge** (CUDA kernel ``az_merge`` for A <= 8, ``az_merge_dense`` for
   larger action spaces): one in-place read-modify-write of the planes —
   install the new row at the lockstep slot, link parent -> child, back up
   along the path — followed by the PUCT refresh that keeps the argmax
   planes ``besta/bestc`` current for the next descent, in place. The
   search seeds them once with ``refresh`` on its fresh planes (for A > 8
   the kernel reads only the roots' priors: every other node is the empty
   node, whose refresh is a constant); both merge kernels then refresh only
   the columns the merge wrote, which is exact because every other node's
   argmax is a function of its own unchanged column (the plain ``merge``
   refreshes every node).

The plain PyTorch versions of the three kernels are ``descend``, ``merge``
and ``refresh`` below; ``alphazero_tpu_torch.kernels`` launches the CUDA
kernels for CUDA tensors and runs these for CPU tensors. Both follow the
reference semantics bit for bit: lockstep slot cursor ``s = i + 1`` with
no install when ``s >= C``; child codes -1 unexpanded, >= 0 a child slot,
-2-s a terminal child; the depth cutoff ``depth + 1 >= max_depth`` (backs
up the flat ops' ``heuristic`` of the leaf board when the game's
``heuristic_is_zero`` is False, else 0, as the JAX engine gates it);
``psign`` flipping once per edge with
``mval = v_leaf * psign``; the PUCT score ``q + cpuct*p*sqrt(sum N + EPS)
/ (1 + n)`` with ``q = w / max(n, 1)``, illegal edges at -1e30 and
first-max ties.

``parallel_sims = K > 1`` runs ``num_sims // K`` rounds (``run_rounds``),
the JAX ``_run_rounds``: each round's ``descend_round`` makes K descents
per game one after another, each from the root, along the best action of
a node or, when that action has been taken more often in this round than
the runner-up, the runner-up (``seca/secc``, -1 when there is none); a
descent that expands an edge another descent of the round already claimed
is a duplicate, which installs nothing but still backs up its value. The
K leaf boards go through ONE forward of K*B boards (stacked K-major), then
``merge_round`` merges the K path records in one read-modify-write at the
slots ``r*K + 1 + k`` and refreshes the top two PUCT actions of every node
(``refresh2``) into the top-2 planes, in place (the kernels: only the
columns it wrote). Its arithmetic is the JAX kernel's term by term: the K
records' additions are summed in k order first and then added to the
planes once, which rounds otherwise than adding them one at a time.

The path record is GPU-natural rather than the TPU kernel's one-hot
planes: ``patha [B, C]`` holds action+1 at each node on the path (0
elsewhere), ``psgn [B, C]`` its root-parity sign, and the expansion's
(parent node, action) ride in two lanes of ``meta [B, 8]`` =
(exp, term, psign, v_term, cut, exp_node, exp_action, dup); ``dup`` is
0 outside rounds. The merge takes ``meta2 [B, 8]`` = (mval, exp_ok,
link_code, cdone, ctval, exp_node, exp_action, 0). A round's records are
the same with a leading K axis.

A ``mesh`` needs no code here: under ``parallel/`` each rank is a process
that calls the engine on its own games, as JAX's ``shard_map`` calls the
kernels on each shard, and any per-batch choice is made on that batch.

Not ported (ROADMAP queue 1 / queue 2): depth-sorted blocking
(``run_search_sorted``, whose 8192-game threshold was measured on another
device), and Gomoku boards above 768 cells on the card (their plain
version runs; the CUDA descends raise).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from alphazero_tpu_torch.config import MCTSConfig, PUCT_EPS
from alphazero_tpu_torch.mcts.tree import INVALID_P
from alphazero_tpu_torch.ops import masked_policy, root_prior

# meta lanes out of descend and descend_round (M_DUP: rounds only)
M_EXP, M_TERM, M_PSIGN, M_VTERM, M_CUT, M_ENODE, M_EACT, M_DUP = range(8)
# meta2 lanes into merge
M2_MVAL, M2_EXPOK, M2_LINK, M2_CDONE, M2_CTVAL, M2_ENODE, M2_EACT = range(7)

UNROLLED_MAX_A = 8   # the JAX ``_refresh`` unrolls A <= 8, larger A goes dense


def _edge_score(n, w, p, a: int, cpuct: float, sqrt_npar):
    """The PUCT score f32[B, C] of action ``a`` at every node, as the JAX
    refreshes unroll it (illegal edges -1e30)."""
    na, pa = n[:, a], p[:, a]
    q = w[:, a] / na.clamp(min=1.0)
    u = cpuct * pa * sqrt_npar / (1.0 + na)
    return torch.where(pa <= INVALID_P * 0.5, -1e30, q + u)


def _score_plane(n, w, p, cpuct: float, sqrt_npar):
    """The PUCT scores f32[B, A, C] of every edge in the same arithmetic:
    the dense branches' score plane."""
    q = w / n.clamp(min=1.0)
    u = cpuct * p * sqrt_npar[:, None, :] / (1.0 + n)
    return torch.where(p <= INVALID_P * 0.5, -1e30, q + u)


def _first_max(score, iota):
    """The smallest action whose score is the maximum, f32[B, C]."""
    best = score.amax(dim=1, keepdim=True)
    return torch.where(score == best, iota, float(score.shape[1])).amin(dim=1)


def refresh(n, w, p, code, cpuct: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_a, best_code) f32[B, C]: the first-max PUCT argmax of every
    node, from the stat planes f32[B, A, C] — the JAX ``_refresh``: its
    per-action unroll for A <= 8, its dense score plane above."""
    A = n.shape[1]
    sqrt_npar = torch.sqrt(n.sum(dim=1) + PUCT_EPS)
    if A > UNROLLED_MAX_A:
        iota = torch.arange(A, device=n.device, dtype=n.dtype)[None, :, None]
        best_a = _first_max(_score_plane(n, w, p, cpuct, sqrt_npar), iota)
        return best_a, code.gather(1, best_a.long()[:, None, :])[:, 0]
    best = _edge_score(n, w, p, 0, cpuct, sqrt_npar)
    best_a, best_code = torch.zeros_like(best), code[:, 0]
    for a in range(1, A):
        score = _edge_score(n, w, p, a, cpuct, sqrt_npar)
        better = score > best
        best = torch.where(better, score, best)
        best_a = torch.where(better, float(a), best_a)
        best_code = torch.where(better, code[:, a], best_code)
    return best_a, best_code


def refresh2(n, w, p, code, cpuct: float) -> Tuple[torch.Tensor, ...]:
    """(best_a, best_code, sec_a, sec_code) f32[B, C]: the top two PUCT
    actions of every node and their child codes — the JAX ``_refresh2``,
    branch for branch. ``sec_a`` is -1 where no legal runner-up exists;
    there the dense branch (A > 8) also sets ``sec_code`` to -1, while the
    unrolled one (A <= 8) leaves it as its scan left it."""
    A = n.shape[1]
    sqrt_npar = torch.sqrt(n.sum(dim=1) + PUCT_EPS)
    if A > UNROLLED_MAX_A:
        # exclude the argmax lane, re-reduce
        iota = torch.arange(A, device=n.device, dtype=n.dtype)[None, :, None]
        score = _score_plane(n, w, p, cpuct, sqrt_npar)
        best_a = _first_max(score, iota)
        score2 = torch.where(iota == best_a[:, None, :], -1e30, score)
        sec_a = _first_max(score2, iota)
        has2 = score2.amax(dim=1) > -1e29
        best_code = code.gather(1, best_a.long()[:, None, :])[:, 0]
        sec_code = code.gather(1, sec_a.long()[:, None, :])[:, 0]
        return (best_a, best_code, torch.where(has2, sec_a, -1.0),
                torch.where(has2, sec_code, -1.0))
    best = _edge_score(n, w, p, 0, cpuct, sqrt_npar)
    best_a, best_code = torch.zeros_like(best), code[:, 0]
    second = torch.full_like(best, -1e30)
    sec_a = torch.full_like(best, -1.0)
    sec_code = torch.full_like(best, -1.0)
    for a in range(1, A):
        score, ca = _edge_score(n, w, p, a, cpuct, sqrt_npar), code[:, a]
        b1 = score > best
        b2 = ~b1 & (score > second)
        second = torch.where(b1, best, torch.where(b2, score, second))
        sec_a = torch.where(b1, best_a, torch.where(b2, float(a), sec_a))
        sec_code = torch.where(b1, best_code, torch.where(b2, ca, sec_code))
        best = torch.where(b1, score, best)
        best_a = torch.where(b1, float(a), best_a)
        best_code = torch.where(b1, ca, best_code)
    return best_a, best_code, torch.where(second > -1e29, sec_a, -1.0), sec_code


def descend(besta, bestc, done, tval, boards, max_depth: int, ops):
    """One simulation's descent for every game, stepping the flat boards
    f32[B, L] with ``ops.step``: ``descend_round``'s one descent, with no
    runner-up.

    Returns ``(bd f32[B, L], patha f32[B, C], psgn f32[B, C], meta
    f32[B, 8])``: the leaf board (empty cells +0), the path record and the
    leaf meta (lanes ``M_*``; M_DUP is 0)."""
    none = torch.full_like(besta, -1.0)
    out = descend_round(besta, bestc, none, none, done, tval, boards, max_depth, ops, 1)
    return tuple(t[0] for t in out)


def merge(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc, slot: int,
          cpuct: float):
    """Install the new row at ``slot``, link parent -> child, back up
    ``mval * psgn`` along the path — all IN PLACE on the planes ``n, w, p,
    code [B, A, C]`` and ``done, tval [B, C]`` — then refresh every node
    into the best planes ``besta, bestc f32[B, C]``, which it returns."""
    B, A, C = n.shape
    exp_ok = meta2[:, M2_EXPOK] > 0.5
    if 0 <= slot < C and bool(exp_ok.any()):
        g = exp_ok.nonzero()[:, 0]
        n[g, :, slot] = 0.0
        w[g, :, slot] = 0.0
        p[g, :, slot] = pm[g]
        code[g, :, slot] = -1.0
        done[g, slot] = meta2[g, M2_CDONE]
        tval[g, slot] = meta2[g, M2_CTVAL]
    on = patha[:, None, :] == torch.arange(1, A + 1, device=n.device, dtype=n.dtype)[None, :, None]
    n.copy_(torch.where(on, n + 1.0, n))
    backed = w + (meta2[:, M2_MVAL, None] * psgn)[:, None, :]
    w.copy_(torch.where(on, backed, w))
    if bool(exp_ok.any()):
        g = exp_ok.nonzero()[:, 0]
        code[g, meta2[g, M2_EACT].long(), meta2[g, M2_ENODE].long()] = meta2[g, M2_LINK]
    for plane, fresh in zip((besta, bestc), refresh(n, w, p, code, cpuct)):
        plane.copy_(fresh)
    return besta, bestc


def descend_round(besta, bestc, seca, secc, done, tval, boards, max_depth: int, ops, K: int):
    """One round's K descents for every game (the JAX
    ``descend_round_kernel``), one after another, each from the root board.

    At each node a descent takes the best action, or the runner-up
    ``seca/secc`` when one exists and this round has taken it less often
    than the best action there (two in-round counters per node, zeroed
    once per round; the chosen option's counter counts every node on the
    path). An expansion through an option this round already took at
    that node is a duplicate (``meta[..., M_DUP]``).

    Returns ``(bd f32[K, B, L], patha f32[K, B, C], psgn f32[K, B, C],
    meta f32[K, B, 8])``."""
    B, C = besta.shape
    dev = boards.device
    rows = torch.arange(B, device=dev)
    vlb = torch.zeros((B, C), device=dev)     # in-round takes of the best action
    vls = torch.zeros((B, C), device=dev)     # ... and of the runner-up
    root_live = done[:, 0] < 0.5
    out = []
    for _ in range(K):
        node = torch.zeros(B, dtype=torch.long, device=dev)
        depth = torch.zeros(B, device=dev)
        act = root_live.clone()
        psign = torch.ones(B, device=dev)
        exp = torch.zeros(B, dtype=torch.bool, device=dev)
        term, cut, dup = torch.zeros_like(exp), torch.zeros_like(exp), torch.zeros_like(exp)
        exp_node = torch.zeros(B, device=dev)
        exp_action = torch.zeros(B, device=dev)
        leaf = torch.full((B,), -1, dtype=torch.long, device=dev)
        patha = torch.zeros((B, C), device=dev)
        psgn = torch.zeros((B, C), device=dev)
        bd = boards.clone()
        while bool(act.any()):
            cnt1, cnt2 = vlb[rows, node], vls[rows, node]
            use2 = (seca[rows, node] > -0.5) & (cnt2 < cnt1)
            a = torch.where(use2, seca[rows, node], besta[rows, node])
            code = torch.where(use2, secc[rows, node], bestc[rows, node])
            taken = torch.where(use2, cnt2, cnt1)
            g, at = rows[act], node[act]
            patha[g, at] = a[act] + 1.0
            psgn[g, at] = psign[act]
            vlb[g, at] += (~use2[act]).float()
            vls[g, at] += use2[act].float()
            bd = torch.where(act[:, None], ops.step(bd, a[:, None]), bd)

            cterm = code < -1.5
            unexp = (code < -0.5) & ~cterm
            child = torch.where(cterm, -2.0 - code, code)
            live = ~unexp & ~cterm
            cutoff = live & (depth + 1.0 >= max_depth)
            go = act & live & ~cutoff
            new_exp = act & unexp
            exp_node = torch.where(new_exp, node.float(), exp_node)
            exp_action = torch.where(new_exp, a, exp_action)
            exp |= new_exp
            dup |= new_exp & (taken > 0.5)
            term |= act & cterm
            cut |= act & cutoff
            leaf = torch.where(act & (cterm | cutoff), child.long(), leaf)
            node = torch.where(go, child.long(), node)
            depth = depth + act.float()
            psign = torch.where(act, -psign, psign)
            act = go
        v_term = torch.where(leaf >= 0, tval[rows, leaf.clamp(min=0)], 0.0)
        meta = torch.stack([exp.float(), term.float(), psign, v_term, cut.float(),
                            exp_node, exp_action, dup.float()], dim=1)
        out.append((bd + 0.0, patha, psgn, meta))   # +0.0: the kernel writes +0 in empty cells
    return tuple(torch.stack(t) for t in zip(*out))


def merge_round(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc, seca, secc,
                slot0: int, cpuct: float):
    """Merge one round's K path records (``pm f32[K, B, A]``, ``patha,
    psgn f32[K, B, C]``, ``meta2 f32[K, B, 8]``) IN PLACE into the planes
    ``n, w, p, code [B, A, C]`` and ``done, tval [B, C]`` — descent k
    installs at slot ``slot0 + k`` where its ``meta2`` lane M2_EXPOK is 1
    — then refresh the top two actions of every node into ``besta, bestc,
    seca, secc f32[B, C]`` (``refresh2``'s planes), which it returns.

    The JAX ``merge_round_kernel`` term by term: the additions of the K
    records are summed per cell in k order from 0, then applied once
    (``w2 = w * keep + w_add``, ``keep`` 0 at an installed slot)."""
    B, A, C = n.shape
    dev = n.device
    cols = torch.arange(C, device=dev)
    acts = torch.arange(A, device=dev)
    keep = torch.ones((B, 1, C), device=dev)
    n_add, w_add, p_inst, code_delta = (torch.zeros((B, A, C), device=dev) for _ in range(4))
    dn_new, dt_new, nm_all = (torch.zeros((B, C), device=dev) for _ in range(3))
    for k in range(patha.shape[0]):
        m = meta2[k]
        inst = m[:, M2_EXPOK, None]
        nm = inst * (cols == slot0 + k).float()                        # [B, C]
        wm = nm[:, None, :]
        keep = keep * (1.0 - wm)
        on = ((acts[None, :, None] + 1.0) == patha[k][:, None, :]).float()
        n_add = n_add + on
        w_add = w_add + m[:, M2_MVAL, None, None] * (psgn[k][:, None, :] * on)
        p_inst = p_inst + wm * pm[k][:, :, None]
        linkp1 = (m[:, M2_LINK, None] + 1.0) * inst                   # [B, 1]
        ohpa = (acts[None, :] == m[:, M2_EACT, None]).float()         # [B, A]
        ohpp = (cols[None, :] == m[:, M2_ENODE, None]).float()        # [B, C]
        code_delta = code_delta - wm + (linkp1 * ohpa)[:, :, None] * ohpp[:, None, :]
        dn_new = dn_new + nm * m[:, M2_CDONE, None]
        dt_new = dt_new + nm * m[:, M2_CTVAL, None]
        nm_all = nm_all + nm
    n.copy_(n * keep + n_add)
    w.copy_(w * keep + w_add)
    p.copy_(p * keep + p_inst)
    code.copy_(code * keep + code_delta)
    done.copy_(done * (1.0 - nm_all) + dn_new)
    tval.copy_(tval * (1.0 - nm_all) + dt_new)
    best4 = (besta, bestc, seca, secc)
    for plane, fresh in zip(best4, refresh2(n, w, p, code, cpuct)):
        plane.copy_(fresh)
    return best4


class SearchKernels(NamedTuple):
    """The kernel entry points the search loops call (see ``kernels``):
    ``run_search``'s three, and ``run_rounds``' three (None where a caller
    gives only the first three; K > 1 then raises). ``refresh`` and
    ``refresh2`` are called once a search, on ``_init_planes``' fresh
    planes only; the merges keep the best planes current after that."""

    descend: Callable
    merge: Callable
    refresh: Callable
    descend_round: Optional[Callable] = None
    merge_round: Optional[Callable] = None
    refresh2: Optional[Callable] = None


PLAIN = SearchKernels(descend, merge, refresh, descend_round, merge_round, refresh2)


def _init_planes(ops, boards, p_masked, nodes: int, aux):
    """The stat planes ``n, w, p, code f32[B, A, C]`` and node planes
    ``done, tval f32[B, C]`` of fresh trees: the roots' priors and
    terminality at slot 0."""
    B, A = p_masked.shape
    dev = boards.device
    rdone, rtval = ops.terminal(boards, aux)
    n = torch.zeros((B, A, nodes), device=dev)
    w = torch.zeros((B, A, nodes), device=dev)
    p = torch.zeros((B, A, nodes), device=dev)
    p[:, :, 0] = p_masked
    code = torch.full((B, A, nodes), -1.0, device=dev)
    done = torch.zeros((B, nodes), device=dev)
    done[:, 0] = rdone[:, 0].float()
    tval = torch.zeros((B, nodes), device=dev)
    tval[:, 0] = rtval[:, 0]
    return n, w, p, code, done, tval


def _leaf_values(meta, cdone, ctval, v_nn, h):
    """``mval`` of each descent: the leaf's value (the model's at an
    expansion into a live child, the terminal value at an expansion into a
    finished one or at a terminal child, ``h`` — the heuristic of the leaf
    board, or None for 0 — at a depth cutoff) times its root-parity sign.
    ``meta [..., 8]``; the others ``[..., 1]``."""
    exp = meta[..., M_EXP : M_EXP + 1]
    term = meta[..., M_TERM : M_TERM + 1]
    vterm = meta[..., M_VTERM : M_VTERM + 1]
    v_expand = ctval + (1.0 - cdone) * (v_nn - ctval)
    v_leaf = exp * v_expand + (1.0 - exp) * term * vterm
    if h is not None:
        v_leaf = v_leaf + (1.0 - exp) * meta[..., M_CUT : M_CUT + 1] * h
    return v_leaf * meta[..., M_PSIGN : M_PSIGN + 1]


def run_search(
    ops, boards: torch.Tensor, p_masked: torch.Tensor, cfg: MCTSConfig,
    evaluate: Callable, kernels: SearchKernels, heuristic: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K=1 search loop over the flat boards f32[B, L] from the masked
    root priors f32[B, A]; ``evaluate(bd, vm) -> (pm f32[B, A], v f32[B])``
    gives the masked prior (INVALID_P on illegal edges) and the value of
    the leaf boards. ``heuristic(bd) -> f32[B, 1]``, when given, is backed
    up at depth cutoffs (None: they back up 0). Returns the final stat
    planes ``(n, w) f32[B, A, C]`` (the root's visit counts are
    ``n[:, :, 0]``).

    ``kernels.refresh`` seeds the best planes from the fresh planes of
    ``_init_planes``, and only from those: the seed kernels take that as
    their precondition at every A (they read only the roots' priors)."""
    B = boards.shape[0]
    C = cfg.nodes
    cpuct = float(cfg.cpuct)
    aux = ops.aux(boards.device)
    n, w, p, code, done, tval = _init_planes(ops, boards, p_masked, C, aux)
    besta, bestc = kernels.refresh(n, w, p, code, cpuct)
    zeros = torch.zeros((B, 1), device=boards.device)
    for i in range(cfg.num_sims):
        bd, patha, psgn, meta = kernels.descend(besta, bestc, done, tval, boards, cfg.max_depth, ops)
        vm, cdone_b, ctval = ops.valid_terminal(bd, aux)
        pm, v_nn = evaluate(bd, vm)
        cdone = cdone_b.float()
        mval = _leaf_values(meta, cdone, ctval, v_nn[:, None],
                            None if heuristic is None else heuristic(bd))
        s = i + 1
        exp_ok = meta[:, M_EXP : M_EXP + 1] * float(s < C)
        link_code = s + cdone * (-2.0 - 2.0 * s)     # -2-s if cdone
        meta2 = torch.cat(
            [mval, exp_ok, link_code, cdone, ctval,
             meta[:, M_ENODE : M_EACT + 1], zeros],
            dim=1,
        )
        kernels.merge(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc, s, cpuct)
    return n, w


def run_rounds(
    ops, boards: torch.Tensor, p_masked: torch.Tensor, cfg: MCTSConfig,
    evaluate: Callable, kernels: SearchKernels, heuristic: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``run_search`` with ``K = cfg.parallel_sims`` leaf-parallel descents
    per round (the JAX ``_run_rounds``), ``num_sims // K`` rounds. Each
    round's K leaf boards are stacked K-major, ``bd.reshape(K * B, L)``,
    for ``valid_terminal``, ``evaluate`` and ``heuristic``; descent k of
    round r installs at slot ``r*K + 1 + k`` unless that slot is past the
    capacity or the descent is a duplicate, which installs nothing but
    still backs up its value. ``kernels.refresh2`` seeds the top-2 planes
    from ``_init_planes``' fresh planes, the seed kernels' precondition at
    every A, as in ``run_search``."""
    K = int(cfg.parallel_sims)
    if kernels.descend_round is None or kernels.merge_round is None or kernels.refresh2 is None:
        raise ValueError("parallel_sims > 1 needs the kernels' round entry points")
    B, L = boards.shape
    C = cfg.nodes
    cpuct = float(cfg.cpuct)
    dev = boards.device
    aux = ops.aux(dev)
    n, w, p, code, done, tval = _init_planes(ops, boards, p_masked, C, aux)
    best4 = kernels.refresh2(n, w, p, code, cpuct)
    zeros = torch.zeros((K, B, 1), device=dev)
    ks = torch.arange(K, device=dev, dtype=torch.float32)[:, None, None]
    for r in range(cfg.num_sims // K):
        bd, patha, psgn, meta = kernels.descend_round(
            *best4, done, tval, boards, cfg.max_depth, ops, K)
        bdf = bd.reshape(K * B, L)
        vm, cdone_b, ctval = ops.valid_terminal(bdf, aux)
        pm, v_nn = evaluate(bdf, vm)
        cdone = cdone_b.float().reshape(K, B, 1)
        ctval = ctval.reshape(K, B, 1)
        mval = _leaf_values(meta, cdone, ctval, v_nn.reshape(K, B, 1),
                            None if heuristic is None else heuristic(bdf).reshape(K, B, 1))
        s_f = r * K + 1.0 + ks                             # [K, 1, 1]
        inst = meta[..., M_EXP : M_EXP + 1] * (1.0 - meta[..., M_DUP : M_DUP + 1]) * (s_f < C).float()
        link_code = s_f + cdone * (-2.0 - 2.0 * s_f)       # -2-s if cdone
        meta2 = torch.cat(
            [mval, inst, link_code, cdone, ctval, meta[..., M_ENODE : M_EACT + 1], zeros],
            dim=2,
        )
        kernels.merge_round(n, w, p, code, done, tval, pm.reshape(K, B, -1), patha, psgn, meta2,
                            *best4, r * K + 1, cpuct)
    return n, w


def make_hybrid_root_fn(
    game, apply_fn, cfg: MCTSConfig, kernels: Optional[SearchKernels] = None
) -> Optional[Callable[..., torch.Tensor]]:
    """Build ``root_counts(root_state, dirichlet=None) -> f32[B, A]``, or
    None where the JAX engine declines the configuration too: a game
    without flat ops (or flat ops without features), or a nonzero cutoff
    heuristic that the flat ops cannot evaluate. The ladder then runs the
    dense engine (``mcts/search.py``).

    ``dirichlet`` is the injected root-noise sample f32[B, A], required
    when ``cfg.dirichlet_alpha`` is set. ``kernels`` defaults to
    ``alphazero_tpu_torch.kernels.KERNELS`` (CUDA kernels for CUDA
    tensors, plain versions for CPU tensors); ``PLAIN`` forces the plain
    versions on any device, which is how the CUDA path is checked."""
    flat_ops_factory = getattr(game, "flat_ops", None)
    if flat_ops_factory is None:
        return None
    ops = flat_ops_factory()
    if not hasattr(ops, "to_features"):
        return None
    zero_heuristic = bool(getattr(game, "heuristic_is_zero", False))
    if not zero_heuristic and not hasattr(ops, "heuristic"):
        return None
    K = int(getattr(cfg, "parallel_sims", 1) or 1)
    if K > 1 and cfg.num_sims % K != 0:
        raise ValueError(f"num_sims={cfg.num_sims} must be divisible by parallel_sims={K}")
    if kernels is None:
        from alphazero_tpu_torch.kernels import KERNELS

        kernels = KERNELS
    # the JAX engine's gate: only a game whose heuristic is not zero backs
    # its flat ops' heuristic up at depth cutoffs
    heuristic = None if zero_heuristic else ops.heuristic
    needs_features = getattr(apply_fn, "needs_features", True)
    search = run_rounds if K > 1 else run_search

    def root_counts(root_state, dirichlet: Optional[torch.Tensor] = None) -> torch.Tensor:
        boards = ops.from_state(root_state)
        prior, root_valid = root_prior(game, apply_fn, cfg, root_state, dirichlet)
        p_masked = torch.where(root_valid, prior, INVALID_P)

        def evaluate(bd, vm):
            if needs_features:
                feats = ops.to_features(bd)
            else:
                feats = torch.zeros((bd.shape[0], 1), device=bd.device)
            logits, v_nn = apply_fn(feats)
            return torch.where(vm, masked_policy(logits, vm), INVALID_P), v_nn

        n, _ = search(ops, boards, p_masked, cfg, evaluate, kernels, heuristic)
        return n[:, :, 0]

    return root_counts
