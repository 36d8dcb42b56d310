"""Hybrid descend/merge search on the GPU — any model, flat-ops games.

Counterpart of ``alphazero_tpu/mcts/hybrid.py`` on its exact K=1 path. The
tree's stat planes live in device memory; each simulation is

1. **descend** (CUDA kernel ``az_descend`` for Connect-Four,
   ``az_descend_othello`` for Othello): the whole descent along the
   per-node PUCT argmax planes ``besta/bestc [B, C]``, carrying the board
   through the game's step, writing the path record and the leaf board;
2. **plain torch**: legality/terminality of the leaf boards, the model
   forward (any ``apply_fn``), the leaf value (with the game's depth-cutoff
   heuristic where it has one), the slot bookkeeping;
3. **merge** (CUDA kernel ``az_merge`` for A <= 8, ``az_merge_dense`` for
   larger action spaces): one in-place read-modify-write of the planes —
   install the new row at the lockstep slot, link parent -> child, back up
   along the path — followed by the PUCT refresh that leaves the next
   descent's argmax planes.

The plain PyTorch versions of the three kernels are ``descend``, ``merge``
and ``refresh`` below; ``alphazero_tpu_torch.kernels`` launches the CUDA
kernels for CUDA tensors and runs these for CPU tensors. Both follow the
reference semantics bit for bit: lockstep slot cursor ``s = i + 1`` with
no install when ``s >= C``; child codes -1 unexpanded, >= 0 a child slot,
-2-s a terminal child; the depth cutoff ``depth + 1 >= max_depth`` (backs
up the flat ops' ``heuristic`` of the leaf board, or 0 for a game
without one); ``psign`` flipping once per edge with
``mval = v_leaf * psign``; the PUCT score ``q + cpuct*p*sqrt(sum N + EPS)
/ (1 + n)`` with ``q = w / max(n, 1)``, illegal edges at -1e30 and
first-max ties.

The path record is GPU-natural rather than the TPU kernel's one-hot
planes: ``patha [B, C]`` holds action+1 at each node on the path (0
elsewhere), ``psgn [B, C]`` its root-parity sign, and the expansion's
(parent node, action) ride in two lanes of ``meta [B, 8]`` =
(exp, term, psign, v_term, cut, exp_node, exp_action, 0). The merge takes
``meta2 [B, 8]`` = (mval, exp_ok, link_code, cdone, ctval, exp_node,
exp_action, 0).

Not ported (ROADMAP queue 1 / queue 2): ``parallel_sims > 1`` (the K7
round kernels), depth-sorted blocking (``run_search_sorted``, whose
8192-game threshold was measured on another device), ``mesh`` sharding,
and the descend kernels of games other than Connect-Four and Othello
(their plain version runs; a CUDA board of another width raises).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from alphazero_tpu_torch.config import MCTSConfig, PUCT_EPS
from alphazero_tpu_torch.mcts.tree import INVALID_P
from alphazero_tpu_torch.ops import masked_policy, root_prior

# meta lanes out of descend
M_EXP, M_TERM, M_PSIGN, M_VTERM, M_CUT, M_ENODE, M_EACT = range(7)
# meta2 lanes into merge
M2_MVAL, M2_EXPOK, M2_LINK, M2_CDONE, M2_CTVAL, M2_ENODE, M2_EACT = range(7)

UNROLLED_MAX_A = 8   # the JAX ``_refresh`` unrolls A <= 8, larger A goes dense


def refresh(n, w, p, code, cpuct: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_a, best_code) f32[B, C]: the first-max PUCT argmax of every
    node, from the stat planes f32[B, A, C] — the JAX ``_refresh``: its
    per-action unroll for A <= 8, its dense score plane above."""
    sqrt_npar = torch.sqrt(n.sum(dim=1) + PUCT_EPS)
    if n.shape[1] > UNROLLED_MAX_A:
        return _refresh_dense(n, w, p, code, cpuct, sqrt_npar)
    best = best_a = best_code = None
    for a in range(n.shape[1]):
        na, pa = n[:, a], p[:, a]
        q = w[:, a] / na.clamp(min=1.0)
        u = cpuct * pa * sqrt_npar / (1.0 + na)
        score = torch.where(pa <= INVALID_P * 0.5, -1e30, q + u)
        if a == 0:
            best, best_a, best_code = score, torch.zeros_like(score), code[:, 0]
            continue
        better = score > best
        best = torch.where(better, score, best)
        best_a = torch.where(better, float(a), best_a)
        best_code = torch.where(better, code[:, a], best_code)
    return best_a, best_code


def _refresh_dense(n, w, p, code, cpuct: float, sqrt_npar):
    """The dense branch (JAX ``_refresh``, A > 8): the score plane [B, A, C]
    in the same arithmetic, its max over the actions, the smallest action
    that reaches it (first-max ties), and that action's child code."""
    q = w / n.clamp(min=1.0)
    u = cpuct * p * sqrt_npar[:, None, :] / (1.0 + n)
    score = torch.where(p <= INVALID_P * 0.5, -1e30, q + u)
    best = score.amax(dim=1, keepdim=True)
    iota = torch.arange(n.shape[1], device=n.device, dtype=n.dtype)[None, :, None]
    best_a = torch.where(score == best, iota, float(n.shape[1])).amin(dim=1)
    return best_a, code.gather(1, best_a.long()[:, None, :])[:, 0]


def descend(besta, bestc, done, tval, boards, max_depth: int, ops):
    """One simulation's descent for every game, stepping the flat boards
    f32[B, L] with ``ops.step``.

    Returns ``(bd f32[B, L], patha f32[B, C], psgn f32[B, C], meta
    f32[B, 8])``: the leaf board (empty cells +0), the path record and the
    leaf meta (lanes ``M_*``)."""
    B, C = besta.shape
    dev = boards.device
    rows = torch.arange(B, device=dev)
    node = torch.zeros(B, dtype=torch.long, device=dev)
    depth = torch.zeros(B, device=dev)
    act = done[:, 0] < 0.5                    # a terminal root is not descended
    psign = torch.ones(B, device=dev)
    exp = torch.zeros(B, dtype=torch.bool, device=dev)
    term = torch.zeros_like(exp)
    cut = torch.zeros_like(exp)
    exp_node = torch.zeros(B, device=dev)
    exp_action = torch.zeros(B, device=dev)
    leaf = torch.full((B,), -1, dtype=torch.long, device=dev)
    patha = torch.zeros((B, C), device=dev)
    psgn = torch.zeros((B, C), device=dev)
    bd = boards.clone()
    while bool(act.any()):
        a = besta[rows, node]
        code = bestc[rows, node]
        patha[rows[act], node[act]] = a[act] + 1.0
        psgn[rows[act], node[act]] = psign[act]
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
        term |= act & cterm
        cut |= act & cutoff
        leaf = torch.where(act & (cterm | cutoff), child.long(), leaf)
        node = torch.where(go, child.long(), node)
        depth = depth + act.float()
        psign = torch.where(act, -psign, psign)
        act = go

    v_term = torch.where(leaf >= 0, tval[rows, leaf.clamp(min=0)], 0.0)
    meta = torch.stack(
        [exp.float(), term.float(), psign, v_term, cut.float(),
         exp_node, exp_action, torch.zeros(B, device=dev)],
        dim=1,
    )
    # the flat ops' step leaves -0.0 in empty cells; the kernel writes +0.0
    return bd + 0.0, patha, psgn, meta


def merge(n, w, p, code, done, tval, pm, patha, psgn, meta2, slot: int, cpuct: float):
    """Install the new row at ``slot``, link parent -> child, back up
    ``mval * psgn`` along the path — all IN PLACE on the planes ``n, w, p,
    code [B, A, C]`` and ``done, tval [B, C]`` — then refresh. Returns
    ``(best_a, best_code) f32[B, C]``."""
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
    return refresh(n, w, p, code, cpuct)


class SearchKernels(NamedTuple):
    """The three kernel entry points the search loop calls (see ``kernels``)."""

    descend: Callable
    merge: Callable
    refresh: Callable


PLAIN = SearchKernels(descend, merge, refresh)


def run_search(
    ops, boards: torch.Tensor, p_masked: torch.Tensor, cfg: MCTSConfig,
    evaluate: Callable, kernels: SearchKernels,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K=1 search loop over the flat boards f32[B, L] from the masked
    root priors f32[B, A]; ``evaluate(bd, vm) -> (pm f32[B, A], v f32[B])``
    gives the masked prior (INVALID_P on illegal edges) and the value of
    the leaf boards. Flat ops with a ``heuristic`` back it up at depth
    cutoffs. Returns the final stat planes ``(n, w) f32[B, A, C]`` (the
    root's visit counts are ``n[:, :, 0]``)."""
    B, A = p_masked.shape
    C = cfg.nodes
    D = cfg.max_depth
    cpuct = float(cfg.cpuct)
    dev = boards.device
    aux = ops.aux(dev)
    heuristic = getattr(ops, "heuristic", None)
    rdone, rtval = ops.terminal(boards, aux)
    n = torch.zeros((B, A, C), device=dev)
    w = torch.zeros((B, A, C), device=dev)
    p = torch.zeros((B, A, C), device=dev)
    p[:, :, 0] = p_masked
    code = torch.full((B, A, C), -1.0, device=dev)
    done = torch.zeros((B, C), device=dev)
    done[:, 0] = rdone[:, 0].float()
    tval = torch.zeros((B, C), device=dev)
    tval[:, 0] = rtval[:, 0]
    besta, bestc = kernels.refresh(n, w, p, code, cpuct)
    zeros = torch.zeros((B, 1), device=dev)
    for i in range(cfg.num_sims):
        bd, patha, psgn, meta = kernels.descend(besta, bestc, done, tval, boards, D, ops)
        vm, cdone_b, ctval = ops.valid_terminal(bd, aux)
        pm, v_nn = evaluate(bd, vm)

        exp = meta[:, M_EXP : M_EXP + 1]
        term = meta[:, M_TERM : M_TERM + 1]
        psign = meta[:, M_PSIGN : M_PSIGN + 1]
        vterm = meta[:, M_VTERM : M_VTERM + 1]
        cdone = cdone_b.float()
        v_expand = ctval + (1.0 - cdone) * (v_nn[:, None] - ctval)
        v_leaf = exp * v_expand + (1.0 - exp) * term * vterm
        if heuristic is not None:
            # depth-cutoff leaves back up the heuristic of the leaf board
            cut = meta[:, M_CUT : M_CUT + 1]
            v_leaf = v_leaf + (1.0 - exp) * cut * heuristic(bd)
        mval = v_leaf * psign

        s = i + 1
        exp_ok = exp * float(s < C)
        link_code = s + cdone * (-2.0 - 2.0 * s)     # -2-s if cdone
        meta2 = torch.cat(
            [mval, exp_ok, link_code, cdone, ctval,
             meta[:, M_ENODE : M_EACT + 1], zeros],
            dim=1,
        )
        besta, bestc = kernels.merge(
            n, w, p, code, done, tval, pm, patha, psgn, meta2, s, cpuct
        )
    return n, w


def make_hybrid_root_fn(
    game, apply_fn, cfg: MCTSConfig, kernels: Optional[SearchKernels] = None
) -> Callable[..., torch.Tensor]:
    """Build ``root_counts(root_state, dirichlet=None) -> f32[B, A]``.

    ``dirichlet`` is the injected root-noise sample f32[B, A], required
    when ``cfg.dirichlet_alpha`` is set. ``kernels`` defaults to
    ``alphazero_tpu_torch.kernels.KERNELS`` (CUDA kernels for CUDA
    tensors, plain versions for CPU tensors); ``PLAIN`` forces the plain
    versions on any device, which is how the CUDA path is checked."""
    if int(getattr(cfg, "parallel_sims", 1) or 1) > 1:
        raise NotImplementedError(
            "parallel_sims > 1 needs the K>1 round kernels "
            "(ROADMAP queue 2, K7a/K7b), not yet ported"
        )
    flat_ops_factory = getattr(game, "flat_ops", None)
    if flat_ops_factory is None:
        raise NotImplementedError(
            f"{game.name} has no flat ops: it needs the dense engine "
            "(ROADMAP queue 1, mcts/search.py + tree.py), not yet ported"
        )
    ops = flat_ops_factory()
    if not getattr(game, "heuristic_is_zero", False) and not hasattr(ops, "heuristic"):
        raise NotImplementedError(
            f"{game.name} has a nonzero depth-cutoff heuristic but its flat ops "
            "cannot evaluate it: it needs the dense engine (ROADMAP queue 1, "
            "mcts/search.py + tree.py), not yet ported"
        )
    if kernels is None:
        from alphazero_tpu_torch.kernels import KERNELS

        kernels = KERNELS
    needs_features = getattr(apply_fn, "needs_features", True)

    def root_counts(root_state, dirichlet: Optional[torch.Tensor] = None) -> torch.Tensor:
        boards = ops.from_state(root_state)
        prior, root_valid = root_prior(game, apply_fn, cfg, root_state, dirichlet)
        p_masked = torch.where(root_valid, prior, INVALID_P)
        zeros = torch.zeros((boards.shape[0], 1), device=boards.device)

        def evaluate(bd, vm):
            logits, v_nn = apply_fn(ops.to_features(bd) if needs_features else zeros)
            return torch.where(vm, masked_policy(logits, vm), INVALID_P), v_nn

        n, _ = run_search(ops, boards, p_masked, cfg, evaluate, kernels)
        return n[:, :, 0]

    return root_counts
