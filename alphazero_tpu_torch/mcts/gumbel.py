"""Gumbel sequential-halving search on the dense engine.

Counterpart of ``alphazero_tpu/mcts/gumbel.py`` ("Policy improvement by
planning with Gumbel", Danihelka et al., ICLR 2022), the opt-in engine for
small simulation budgets. It shares the dense engine's descent, expansion,
evaluation and backup (``make_engine_parts``) and swaps only the scoring
rule:

* **root**: the Gumbel sample ``g f32[B, A]`` is an input (``None`` is
  evaluation mode, zeros). Simulation ``i`` searches, among the actions
  whose root visit count equals the sequential-halving schedule's entry
  (``considered_visit_table``, indexed by the game's number of legal
  actions capped at ``gumbel_top_m``), the one with the best ``g + logits +
  sigma(q)``;
* **interior nodes**: the first max of ``pi'(a) - N(a) / (1 + sum N)``
  with ``pi' = softmax(logits + sigma(completed Q))``, computed for every
  node of every tree once a simulation (statistics are frozen during a
  descent);
* **completed Q**: a visited edge's ``W / N``; an unvisited one takes the
  node's mixed value ``(v_node + sum N * weighted Q) / (sum N + 1)``, where
  ``v_node`` is the node's own network value, kept in the side plane
  ``vraw f32[B, C]`` written at expansion;
* ``sigma(q) = (c_visit + max N) * c_scale * q`` on each node's completed
  values rescaled to [0, 1].

The search returns the halving winner (``action``: among the most visited
root actions, the best ``g + logits + sigma``), played as is, and the root's
improved policy ``improved_pi``, the training target. The arithmetic is the
JAX engine's, in its order, in f32, with its constants (``1e-8``,
``1e-30``, ``_NEG``). No kernel: the engine is plain PyTorch, as the JAX
one is plain XLA.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.mcts.search import make_engine_parts
from alphazero_tpu_torch.mcts.tree import INVALID_P, PLANE_N, PLANE_P, PLANE_W, Tree, init_tree
from alphazero_tpu_torch.ops import masked_policy

_NEG = -1e30


def considered_visit_sequence(m: int, n: int) -> list:
    """The sequential-halving schedule for ``m`` considered actions and
    ``n`` simulations: each phase gives every surviving action ``max(1, n
    // (ceil(log2 m) * survivors))`` more visits, then halves the survivors
    (never below 2). Entry ``i`` is the visit count an action must have to
    be due at simulation ``i``."""
    if m <= 1:
        return list(range(n))
    log2m = max(1, math.ceil(math.log2(m)))
    seq: list = []
    visits = [0] * m
    considered = m
    while len(seq) < n:
        extra = max(1, n // (log2m * considered))
        for _ in range(extra):
            seq.extend(visits[:considered])
            for j in range(considered):
                visits[j] += 1
        considered = max(2, considered // 2)
    return seq[:n]


def considered_visit_table(top_m: int, n: int) -> np.ndarray:
    """i32[top_m + 1, n]: row ``m`` is the schedule for ``m`` considered
    actions (rows 0 and 1 revisit one action every simulation)."""
    return np.asarray([considered_visit_sequence(m, n) for m in range(top_m + 1)], np.int32)


class GumbelResult(NamedTuple):
    tree: Tree
    vraw: torch.Tensor         # f32[B, C] each node's network value (its to-move view)
    gumbel: torch.Tensor       # f32[B, A] the root Gumbel sample (zeros: evaluation mode)
    action: torch.Tensor       # i64[B] the sequential-halving winner, the move to play
    improved_pi: torch.Tensor  # f32[B, A] the root's pi' = softmax(logits + sigma), the target


def check_gumbel_config(cfg: MCTSConfig) -> None:
    """The JAX engine's two refusals: Gumbel search takes no Dirichlet
    noise and runs one descent a simulation."""
    if cfg.dirichlet_alpha is not None:
        raise ValueError(
            "gumbel search replaces Dirichlet root noise (exploration is "
            "the Gumbel sample) — set dirichlet_alpha=None"
        )
    if getattr(cfg, "parallel_sims", 1) > 1:
        raise ValueError(
            "gumbel runs on the XLA engine parts, which are sequential — "
            "set parallel_sims=1"
        )


def make_gumbel_search_fn(game, apply_fn: Callable, cfg: MCTSConfig):
    """Build ``search(root_state, gumbel=None, num_sims=None) ->
    GumbelResult``. ``gumbel`` is the injected root sample f32[B, A];
    ``None`` runs evaluation mode (zeros), where root selection and the
    recommendation are the deterministic argmax of ``logits + sigma``."""
    A = game.num_actions
    C = cfg.nodes
    top_m = max(1, min(int(getattr(cfg, "gumbel_top_m", 16)), A))
    c_visit = float(getattr(cfg, "gumbel_c_visit", 50.0))
    c_scale = float(getattr(cfg, "gumbel_value_scale", 0.1))
    check_gumbel_config(cfg)

    parts = make_engine_parts(game, apply_fn, cfg)
    best_planes, select, expand_backup = (parts[k] for k in ("best_planes", "select",
                                                             "expand_backup"))

    def completed_scores(tree: Tree, vraw: torch.Tensor):
        """Every node's improved policy and interior scores: ``(score,
        logits, sigma, legal, n, pi_imp)``, each [B, A, C] (the JAX
        engine's layout, which ``best_planes`` takes). Lane 0 of ``score``
        holds the interior rule; the caller puts the root rule there."""
        n, w, p_raw = (tree.stats[:, :, plane].transpose(1, 2)
                       for plane in (PLANE_N, PLANE_W, PLANE_P))
        legal = p_raw > INVALID_P * 0.5
        p = torch.where(legal, p_raw, 0.0)
        q = w / n.clamp(min=1.0)
        vis = (n > 0.5).float()

        sum_n = n.sum(dim=1)                 # [B, C]
        sum_pv = (p * vis).sum(dim=1)
        wq = (p * vis * q).sum(dim=1) / sum_pv.clamp(min=1e-8)
        v_mix = (vraw + sum_n * wq) / (sum_n + 1.0)
        cq = torch.where(n > 0.5, q, v_mix[:, None, :])

        # each node's completed values rescaled to [0, 1]; an all-unvisited
        # node rescales to 0, so sigma vanishes and pi' is the prior
        cq_min = cq.amin(dim=1, keepdim=True)
        cq_max = cq.amax(dim=1, keepdim=True)
        cq = (cq - cq_min) / (cq_max - cq_min).clamp(min=1e-8)

        maxn = n.amax(dim=1)
        sigma = (c_visit + maxn)[:, None, :] * c_scale * cq
        logits = torch.where(legal, torch.log(p.clamp(min=1e-30)), _NEG)

        z = torch.where(legal, logits + sigma, _NEG)
        z = z - z.amax(dim=1, keepdim=True)
        e = torch.where(legal, torch.exp(z), 0.0)
        pi_imp = e / e.sum(dim=1, keepdim=True).clamp(min=1e-30)

        score = pi_imp - n / (1.0 + sum_n[:, None, :])
        score = torch.where(legal, score, _NEG)
        return score, logits, sigma, legal, n, pi_imp

    def search(root_state: torch.Tensor, gumbel: Optional[torch.Tensor] = None,
               num_sims: Optional[int] = None) -> GumbelResult:
        sims = cfg.num_sims if num_sims is None else num_sims
        B = root_state.shape[0]
        dev = root_state.device
        tree = init_tree(game, root_state, C)

        valid = game.valid_moves(root_state)
        if getattr(apply_fn, "needs_features", True):
            feats = game.to_features(root_state)
        else:
            feats = torch.zeros((B, 1), device=dev)
        logits_nn, v0 = apply_fn(feats)
        prior = masked_policy(logits_nn, valid)
        tree.stats[:, 0, PLANE_P] = torch.where(valid, prior, INVALID_P)
        vraw = torch.zeros((B, C), device=dev)
        vraw[:, 0] = v0
        if gumbel is None:
            gumbel = torch.zeros((B, A), device=dev)

        # the schedule's entry of each game (by its legal-action count,
        # which the search never changes) at every simulation: [B, sims]
        table = torch.as_tensor(considered_visit_table(top_m, max(sims, 1)), device=dev)
        m_eff = valid.sum(dim=1).clamp(1, top_m)
        due_count = table[m_eff].float()
        lane_c = torch.arange(C, device=dev)

        for i in range(sims):
            score, logits, sigma, legal, n, _ = completed_scores(tree, vraw)
            # the root rule: among the actions the schedule has due, the
            # best g + logits + sigma
            due = (n[:, :, 0] - due_count[:, i: i + 1]).abs() < 0.5
            base = gumbel + logits[:, :, 0] + sigma[:, :, 0]
            score[:, :, 0] = torch.where(legal[:, :, 0] & due, base, _NEG)
            sel = select(tree, *best_planes(tree, score))
            tree, (exp_ok, slot, v_nn) = expand_backup(tree, sel)
            vraw = torch.where(exp_ok[:, None] & (lane_c[None, :] == slot[:, None]),
                               v_nn[:, None], vraw)

        # the recommendation: among the most visited root actions (the
        # halving's survivors), the best g + logits + sigma
        _, logits, sigma, legal, n, pi_imp = completed_scores(tree, vraw)
        legal0, n0 = legal[:, :, 0], n[:, :, 0]
        maxn0 = torch.where(legal0, n0, -1.0).amax(dim=1, keepdim=True)
        due = legal0 & (n0 >= maxn0 - 0.5)
        fin = torch.where(due, gumbel + logits[:, :, 0] + sigma[:, :, 0], _NEG)
        return GumbelResult(tree=tree, vraw=vraw, gumbel=gumbel, action=fin.argmax(dim=1),
                            improved_pi=pi_imp[:, :, 0])

    search._completed_scores = completed_scores  # reached by tests
    return search
