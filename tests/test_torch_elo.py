"""The port's Elo functions (``alphazero_tpu_torch.utils.elo``) equal the
JAX package's exactly on seeded random match graphs: the ladder tracker,
the one-match estimate, the anchored fit and its standard errors. Pure
Python and numpy on both sides, so equal, not close; no wall-clock
asserts."""

import numpy as np
import pytest

from alphazero_tpu.utils import elo as jax_elo
from alphazero_tpu_torch.utils import elo as port_elo


def random_graph(seed: int, gens: int = 12, matches: int = 40) -> list:
    """Generations 1..gens against each other, the anchor and two ladder
    rungs; some sweeps, some draws, some empty matches."""
    rng = np.random.default_rng(seed)
    players = list(range(1, gens + 1)) + ["anchor", "anchor@400", "anchor@1600"]
    out = [{"a": "anchor", "b": "anchor@400", "wins_a": 3, "wins_b": 61, "draws": 0},
           {"a": "anchor@400", "b": "anchor@1600", "wins_a": 20, "wins_b": 40, "draws": 4}]
    for _ in range(matches):
        a, b = rng.choice(len(players), 2, replace=False)
        n = int(rng.integers(0, 64))
        wa = int(rng.integers(0, n + 1))
        d = int(rng.integers(0, n - wa + 1)) if rng.random() < 0.5 else 0
        if rng.random() < 0.2:
            wa, d = n, 0    # a sweep
        pa, pb = players[a], players[b]
        out.append({"a": int(pa) if not isinstance(pa, str) else pa,
                    "b": int(pb) if not isinstance(pb, str) else pb,
                    "wins_a": wa, "wins_b": n - wa - d, "draws": d})
    return out


@pytest.mark.parametrize("seed", range(6))
def test_fit_elo_and_standard_errors_equal_jax(seed):
    ms = random_graph(seed)
    want = jax_elo.fit_elo(ms, "anchor", 0.0)
    got = port_elo.fit_elo(ms, "anchor", 0.0)
    assert got == want
    assert got["anchor"] == 0.0
    assert port_elo.elo_standard_errors(ms, "anchor", got) == \
        jax_elo.elo_standard_errors(ms, "anchor", want)


@pytest.mark.parametrize("seed", range(3))
def test_fit_elo_pinned_elsewhere_equals_jax(seed):
    ms = random_graph(100 + seed, gens=5, matches=15)
    assert port_elo.fit_elo(ms, "anchor@400", 1234.5) == jax_elo.fit_elo(ms, "anchor@400", 1234.5)


def test_elo_from_match_equals_jax():
    rng = np.random.default_rng(7)
    for _ in range(200):
        w, l, d = (int(x) for x in rng.integers(0, 40, 3))
        r = float(rng.normal(0, 300))
        assert port_elo.elo_from_match(r, w, l, d) == jax_elo.elo_from_match(r, w, l, d)
    assert port_elo.elo_from_match(5.0, 0, 0, 0) == 5.0


def test_elo_tracker_equals_jax():
    rng = np.random.default_rng(3)
    jt, pt = jax_elo.EloTracker(), port_elo.EloTracker()
    inc = 0
    for cand in range(1, 30):
        w, l, d = (int(x) for x in rng.integers(0, 20, 3))
        accepted = bool(rng.random() < 0.5)
        assert pt.record_match(cand, inc, w, l, d, accepted) == \
            jt.record_match(cand, inc, w, l, d, accepted)
        if accepted:
            inc = cand
    assert pt.history == jt.history
    assert pt.ratings == jt.ratings
    assert pt.curve() == jt.curve()


def test_fit_elo_long_chain_equals_jax():
    """A 300-generation chain with sparse anchor spokes (the shape of a
    long run's graph), equal to the JAX fit; no timing asserted."""
    ms = []
    for g in range(1, 301):
        ms.append({"a": g, "b": g - 1 if g > 1 else "anchor", "wins_a": 20 + g % 7,
                   "wins_b": 12, "draws": g % 3})
        if g % 25 == 0:
            ms.append({"a": g, "b": "anchor", "wins_a": 30, "wins_b": 2, "draws": 0})
    r = port_elo.fit_elo(ms, "anchor")
    assert r == jax_elo.fit_elo(ms, "anchor")
    assert port_elo.elo_standard_errors(ms, "anchor", r) == jax_elo.elo_standard_errors(ms, "anchor", r)
