"""Properties of the port's episode generators on their own (the JAX
parity is tests/test_torch_selfplay_scan.py): recycling's first episode
is the fixed scan's under the same draws, every move of a run lands in
exactly one emitted sample, fragments alternate in sign, the search
refuses the learner's f32 MLPNet, what is not ported raises, and the fixed
scan's moves ride the transposition engine when the config opts in."""

import dataclasses

import pytest
import torch

from alphazero_tpu_torch.config import MCTSConfig, SelfPlayConfig
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.mcts.tt import tt_root_fn
from alphazero_tpu_torch.models import MLPNet, make_apply_fn, make_uniform_model
from alphazero_tpu_torch.ops import action_probs, sample_draws
from alphazero_tpu_torch.selfplay import (
    make_recycling_selfplay_fn,
    make_selfplay_fn,
)

G = ConnectFour()
B = 8
CFG = MCTSConfig(num_sims=8, max_depth=16, dirichlet_alpha=1.0)
SP = SelfPlayConfig(batch_size=B, temp_threshold=6, recycle=True)


def _draws(seed: int, steps: int) -> list:
    gen = torch.Generator().manual_seed(seed)
    return [sample_draws(gen, B, G.num_actions, CFG.dirichlet_alpha, "cpu") for _ in range(steps)]


def test_first_episode_is_the_fixed_scans():
    """Same draws: each game's first episode (features, pi targets and
    walk-back values) is the fixed scan's, bit for bit."""
    M = G.max_moves
    draws = _draws(7, M)
    model = make_uniform_model(G)
    traj_f, stats_f = make_selfplay_fn(G, CFG, SP, device="cpu")(model, lambda t: draws[t])
    init, play = make_recycling_selfplay_fn(G, CFG, SP, device="cpu")
    _, traj_r, stats_r = play(model, init(), lambda t: draws[t])
    assert stats_f.done.all() and stats_r.done.all()
    for b in range(B):
        n = int(stats_f.num_moves[b])
        for f, r in zip(traj_f, traj_r):
            assert torch.equal(f[:n, b], r[M: M + n, b])


def test_every_move_lands_in_one_emitted_sample():
    """Over k calls every closed episode's samples are emitted valid once
    (in its call, or as the next call's fragment); what is outstanding is
    the open episodes: sum(valid) == k * S * B - sum(final move_count).
    Connect-Four cannot truncate (move 42 fills the board)."""
    init, play = make_recycling_selfplay_fn(G, CFG, SP, device="cpu")
    carry, valid, k = init(), 0, 3
    model = make_uniform_model(G)
    for i in range(k):
        draws = _draws(100 + i, G.max_moves)
        carry, traj, stats = play(model, carry, lambda t: draws[t])
        valid += int(traj.valid.sum())
        assert traj.features.shape == (2 * G.max_moves, B, 6, 7, 2)
        assert (stats.num_moves == G.max_moves).all()
    assert valid == k * G.max_moves * B - int(carry.move_count.sum())


def test_fragment_values_alternate():
    init, play = make_recycling_selfplay_fn(G, CFG, SP, device="cpu")
    model = make_uniform_model(G)
    d1, d2 = _draws(1, G.max_moves), _draws(2, G.max_moves)
    carry, _, _ = play(model, init(), lambda t: d1[t])
    _, traj, _ = play(model, carry, lambda t: d2[t])
    M = G.max_moves
    val, ok = traj.value[:M], traj.valid[:M]
    assert ok.any()
    for b in range(B):
        rows = ok[:, b].nonzero()[:, 0].tolist()
        assert rows == list(range(len(rows)))        # a prefix of the episode
        for j in rows[1:]:
            assert val[j, b] == -val[j - 1, b]


def test_the_search_refuses_an_f32_mlp():
    """The fused kernel's evaluator is bf16: an f32 MLPNet (the learner's
    f32 forward) has no search apply_fn, and no other engine stands in."""
    assert hasattr(make_apply_fn(MLPNet(7, (16,))), "kernel_eval_factory")
    with pytest.raises(ValueError, match="bf16 MLPNet"):
        make_apply_fn(MLPNet(7, (16,), dtype=torch.float32))


@pytest.mark.parametrize(
    "mcts,sp,err,match",
    [
        (dict(tree_reuse=True), {}, ValueError, "tree_reuse"),
        (dict(forced_playouts=2.0), {}, ValueError, "forced_playouts"),
        (dict(transposition=True), {}, ValueError, "transposition"),
        ({}, dict(full_search_prob=0.25, cheap_sims=2), ValueError, "playout-cap"),
        # Gumbel recycling is ported (tests/test_torch_gumbel_selfplay.py):
        # CFG's Dirichlet noise is refused as the JAX engine refuses it
        (dict(gumbel=True), {}, ValueError, "gumbel search replaces Dirichlet root noise"),
        ({}, dict(recycle_steps=41), ValueError, "recycle_steps=41"),
    ],
    ids=["tree_reuse", "forced_playouts", "transposition", "pcr", "gumbel", "short_steps"],
)
def test_recycling_refuses(mcts, sp, err, match):
    with pytest.raises(err, match=match):
        make_recycling_selfplay_fn(G, dataclasses.replace(CFG, **mcts), dataclasses.replace(SP, **sp),
                                   device="cpu")


@pytest.mark.parametrize(
    "mcts,sp,kw,err,item",
    [
        # playout-cap randomization, Gumbel search and record_states are
        # ported (tests/test_torch_pcr.py, test_torch_gumbel_selfplay.py,
        # test_torch_reanalyze.py): their cases pin the JAX ValueErrors and
        # record_states' third output
        ({}, dict(full_search_prob=0.25), {}, ValueError, "full_search_prob requires cheap_sims"),
        (dict(gumbel=True, dirichlet_alpha=None, transposition=True), {}, {}, ValueError,
         "gumbel is its own root/interior scoring rule"),
        # the transposition engine is ported (tests/test_torch_tt_routes.py
        # holds its scan against JAX): every move is its search's
        (dict(transposition=True), dict(max_moves=4), {}, None, "transposition"),
        # the fixed scan runs forced playouts on the dense engine, which has
        # no parallel_sims rounds (the JAX ValueError)
        (dict(forced_playouts=2.0, parallel_sims=4), {}, {}, ValueError, "set parallel_sims=1"),
        (dict(tree_reuse=True), {}, {}, NotImplementedError, "Do not port"),
        ({}, dict(max_moves=3), dict(record_states=True), None, None),
    ],
    ids=["pcr", "gumbel", "transposition", "forced_playouts", "tree_reuse", "record_states"],
)
def test_fixed_scan_refuses_what_is_not_ported(mcts, sp, kw, err, item):
    build = lambda: make_selfplay_fn(G, dataclasses.replace(CFG, **mcts),   # noqa: E731
                                     dataclasses.replace(SP, **sp), device="cpu", **kw)
    if err is None and item == "transposition":
        draws = _draws(5, 4)
        model = make_uniform_model(G)
        traj, stats = build()(model, lambda t: draws[t])
        root_counts = tt_root_fn(G, model.apply_fn, dataclasses.replace(CFG, **mcts))
        state = G.init(B, "cpu")
        for t in range(4):
            assert torch.equal(traj.features[t], G.to_features(state))
            pi = action_probs(root_counts(state, draws[t].dirichlet), 1.0, draws[t].tie)
            assert torch.equal(traj.pi[t], pi)
            state = G.step(state, (torch.log(pi + 1e-12) + draws[t].gumbel).argmax(dim=-1))
        assert (stats.num_moves == 4).all() and not stats.done.any()
        return
    if err is None:
        draws = _draws(3, 3)
        traj, _, states = build()(make_uniform_model(G), lambda t: draws[t])
        assert states.shape == (3, B, 6, 7) and states.dtype == torch.int8
        assert torch.equal(G.to_features(states.reshape(-1, 6, 7)).reshape(traj.features.shape),
                           traj.features)
        return
    with pytest.raises(err, match=item):
        build()
