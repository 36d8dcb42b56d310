"""Elo ratings over model generations.

Counterpart of ``alphazero_tpu/utils/elo.py``, copied function for
function (pure Python and numpy; ``tests/test_torch_elo.py`` holds the
two equal): ``EloTracker``, the per-gate ladder chained off each accepted
gate (a diagnostic, not a strength claim), and ``fit_elo``, the anchored
maximum-likelihood Bradley-Terry fit of a whole match graph with one
player pinned, with ``elo_standard_errors`` from its Fisher information.
The coach's headline ratings come from the fit.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple


def elo_from_match(
    rating_inc: float, wins: int, losses: int, draws: int, clamp: float = 600.0
) -> float:
    """Estimate the candidate's rating from one head-to-head match against
    an incumbent of known rating, via the log-odds of the match score."""
    games = wins + losses + draws
    if games == 0:
        return rating_inc
    score = (wins + 0.5 * draws) / games
    eps = 1.0 / (2.0 * games)  # regularize 0%/100% sweeps
    score = min(max(score, eps), 1.0 - eps)
    diff = 400.0 * math.log10(score / (1.0 - score))
    return rating_inc + min(max(diff, -clamp), clamp)


class EloTracker:
    """Ratings per accepted model generation (model_id -> Elo)."""

    def __init__(self, base_rating: float = 0.0):
        self.ratings: Dict[int, float] = {0: base_rating}
        self.history: List[dict] = []

    def record_match(
        self, cand_id: int, inc_id: int, wins: int, losses: int, draws: int,
        accepted: bool,
    ) -> float:
        r_inc = self.ratings[inc_id]
        r_cand = elo_from_match(r_inc, wins, losses, draws)
        self.history.append(
            {
                "candidate": cand_id,
                "incumbent": inc_id,
                "wins": wins,
                "losses": losses,
                "draws": draws,
                "rating": r_cand,
                "accepted": accepted,
            }
        )
        if accepted:
            self.ratings[cand_id] = r_cand
        return r_cand

    def curve(self) -> List[tuple]:
        return sorted(self.ratings.items())


# ---------------------------------------------------------------------------
# Anchored maximum-likelihood ratings (Bradley-Terry MM with a pinned anchor)
# ---------------------------------------------------------------------------

_ELO_SCALE = 400.0 / math.log(10.0)  # rating = _ELO_SCALE * ln(strength)


def fit_elo(
    matches: Iterable[dict],
    anchor: object,
    anchor_rating: float = 0.0,
    iters: int = 500,
    tol: float = 1e-9,
) -> Dict[object, float]:
    """Anchored ML Elo over a match graph.

    ``matches``: records with keys ``a``, ``b``, ``wins_a``, ``wins_b``,
    ``draws`` (draws count as half a win each way). Fits the Bradley-Terry
    model P(a beats b) = s_a / (s_a + s_b) by minorization-maximization
    (Hunter 2004), then translates log-strengths to the Elo scale with
    ``anchor`` pinned at ``anchor_rating``. Players unreachable from any
    match get no rating. A half-game virtual draw against the anchor
    regularizes players with sweep-only records (otherwise their MLE
    strength diverges).
    """
    import numpy as np

    # aggregate the match list ONCE into per-unordered-pair totals (long
    # production runs persist every pool match forever — coach.py keeps
    # the sidecar append-only — so the fit must be O(aggregated edges)
    # per sweep, not O(players·raw matches))
    wins: Dict[Tuple[object, object], float] = {}
    players: List[object] = []
    index: Dict[object, int] = {}

    def intern(p):
        if p not in index:
            index[p] = len(players)
            players.append(p)
        return index[p]

    def add(i, j, w):
        if w <= 0:
            return
        wins[(i, j)] = wins.get((i, j), 0.0) + w

    for m in matches:
        a, b = intern(m["a"]), intern(m["b"])
        add(a, b, m["wins_a"] + 0.5 * m["draws"])
        add(b, a, m["wins_b"] + 0.5 * m["draws"])
    a_idx = intern(anchor)
    # virtual half-draw vs the anchor: keeps every player's MLE finite
    for p in range(len(players)):
        if p != a_idx:
            add(p, a_idx, 0.25)
            add(a_idx, p, 0.25)

    P = len(players)
    # directed win totals per player, undirected edge list with game counts
    w_total = np.zeros(P)
    for (i, _), w in wins.items():
        w_total[i] += w
    und: Dict[Tuple[int, int], float] = {}
    for (i, j), w in wins.items():
        key = (i, j) if i <= j else (j, i)
        und[key] = und.get(key, 0.0) + w
    ei = np.fromiter((k[0] for k in und), np.int64, len(und))
    ej = np.fromiter((k[1] for k in und), np.int64, len(und))
    en = np.fromiter(und.values(), np.float64, len(und))

    # MM sweeps (Hunter 2004), fully vectorized over the edge arrays
    s = np.ones(P)
    for _ in range(iters):
        contrib = en / (s[ei] + s[ej])
        denom = np.bincount(ei, weights=contrib, minlength=P)
        denom += np.bincount(ej, weights=contrib, minlength=P)
        new_s = np.where(denom > 0, w_total / np.maximum(denom, 1e-300), s)
        new_s = new_s / new_s[a_idx]  # re-pin the gauge each sweep
        delta = float(np.max(np.abs(new_s - s))) if P else 0.0
        s = new_s
        if delta < tol:
            break

    return {
        p: anchor_rating + _ELO_SCALE * math.log(s[index[p]]) for p in players
    }


def elo_standard_errors(
    matches: Iterable[dict], anchor: object, ratings: Dict[object, float]
) -> Dict[object, float]:
    """Per-player standard errors (Elo points) for a :func:`fit_elo` fit.

    Observed/expected Fisher information of the Bradley-Terry
    log-likelihood in log-strength space: each aggregated pairing (p, q)
    with n games at win probability π = s_p/(s_p+s_q) contributes
    n·π·(1−π) to I[p,p] and I[q,q] and −n·π·(1−π) to I[p,q]. The anchor
    is the pinned gauge, so its row/column are dropped before inversion;
    SE(Elo_p) = (400/ln 10)·sqrt([I⁻¹]_pp). The same virtual half-draw
    vs the anchor that :func:`fit_elo` adds is included, so the
    information matrix is nonsingular even for sweep-only records (such
    players report the correspondingly huge — honest — SE).
    """
    import numpy as np

    games: Dict[Tuple[object, object], float] = {}
    players: List[object] = []
    order: Dict[object, int] = {}

    def intern(p):
        if p not in order:
            order[p] = len(players)
            players.append(p)
        return order[p]

    def add_pair(i, j, n):
        if n <= 0:
            return
        key = (i, j) if order[i] <= order[j] else (j, i)
        games[key] = games.get(key, 0.0) + n

    for m in matches:
        a, b = m["a"], m["b"]
        intern(a), intern(b)
        add_pair(a, b, m["wins_a"] + m["wins_b"] + m["draws"])
    intern(anchor)
    for p in players:
        if p != anchor:
            add_pair(p, anchor, 0.5)  # fit_elo's virtual half-draw

    free = [p for p in players if p != anchor and p in ratings]
    if not free:
        return {}
    idx = {p: k for k, p in enumerate(free)}
    info = np.zeros((len(free), len(free)))
    for (p, q), n in games.items():
        # win prob from the FITTED ratings (gauge-invariant difference)
        d = (ratings.get(p, 0.0) - ratings.get(q, 0.0)) / _ELO_SCALE
        pi = 1.0 / (1.0 + math.exp(-d))
        w = n * pi * (1.0 - pi)
        if p in idx:
            info[idx[p], idx[p]] += w
        if q in idx:
            info[idx[q], idx[q]] += w
        if p in idx and q in idx:
            info[idx[p], idx[q]] -= w
            info[idx[q], idx[p]] -= w
    # the virtual half-draws make the free-player information matrix
    # positive definite in the common case — Cholesky-solve for the
    # covariance (pinv's SVD is ~10x slower at 1000 generations); fall
    # back to the pseudo-inverse for degenerate graphs
    try:
        cov = np.linalg.solve(info, np.eye(len(free)))
    except np.linalg.LinAlgError:
        cov = np.linalg.pinv(info)
    var = np.clip(np.diag(cov), 0.0, None)
    return {p: float(_ELO_SCALE * math.sqrt(var[idx[p]])) for p in free}
