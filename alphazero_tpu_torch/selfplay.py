"""Self-play: the steady-state actor and the two episode generators.

Counterpart of ``alphazero_tpu/selfplay.py``:

* ``make_actor_step_fn`` — one search + move for every board per call,
  finished games recycled to the initial position (throughput only: its
  samples carry no value target);
* ``make_selfplay_fn`` — the fixed ``max_moves``-step scan from the
  initial position, finished boards frozen, value targets by the negamax
  walk-back from each game's outcome;
* ``make_recycling_selfplay_fn`` — every search a real move: closed and
  truncated games reset, values resolved by a reverse walk-back over the
  call's steps, and each game's open episode carried to the next call as
  a fragment (``ActorCarry``) that call resolves by parity.

The random draws of a step (root Dirichlet noise, tie-break uniforms,
Gumbel noise for the move choice) are an input, ``ops.Draws``; the episode
generators take a callable ``draws(t) -> Draws`` for step ``t`` of a call,
which real runs build on ``ops.sample_draws`` and one ``torch.Generator``.
They take the model (``UniformModel``, ``AZResNet``, ``AZConvNet`` or ``MLPNet``) on
every call and rebuild its search ``apply_fn`` there (a conv net refolded,
an MLPNet's kernel weights repacked), so trained weights reach the actor.

One semantic differs from the JAX package on purpose: recycling's
walk-back starts over at a truncation, so a truncated episode's samples
are invalid with value 0; the JAX scan marks them valid with the next
episode's values (ROADMAP queue 3, "ADVICE medium").
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from alphazero_tpu_torch.config import MCTSConfig, SelfPlayConfig
from alphazero_tpu_torch.mcts.fused import make_fused_root_fn
from alphazero_tpu_torch.mcts.hybrid import make_hybrid_root_fn
from alphazero_tpu_torch.mcts.search import dense_root_fn, make_search_fn, pruned_root_counts
from alphazero_tpu_torch.models import make_apply_fn
from alphazero_tpu_torch.ops import Draws, action_probs

DrawsFn = Callable[[int], Draws]


class Trajectory(NamedTuple):
    """Self-play samples, step-major."""

    features: torch.Tensor  # f32[T, B, *feature_shape]
    pi: torch.Tensor        # f32[T, B, A] policy targets (temperature applied)
    value: torch.Tensor     # f32[T, B] outcome from the sample's perspective
    valid: torch.Tensor     # bool[T, B] the sample is a real move with an outcome


class SelfPlayStats(NamedTuple):
    outcome: torch.Tensor    # f32[B] terminal value (final to-move perspective)
    num_moves: torch.Tensor  # i32[B] moves played
    done: torch.Tensor       # bool[B] a game (recycling: an episode) finished


class ActorCarry(NamedTuple):
    """What a recycling call hands the next: the live boards, each game's
    open-episode length, and that episode's samples so far (the fragment,
    ``M = game.max_moves`` rows; rows at or past ``move_count`` are stale)."""

    state: torch.Tensor          # [B, ...] game state
    move_count: torch.Tensor     # i32[B] open-episode length
    frag_features: torch.Tensor  # f32[M, B, *feature_shape]
    frag_pi: torch.Tensor        # f32[M, B, A]


def _check_ported(mcts_cfg: MCTSConfig) -> None:
    """Raise for an engine the port lacks: no engine stands in silently
    for another."""
    if getattr(mcts_cfg, "transposition", False):
        raise NotImplementedError(
            "transposition search (mcts/tt.py) is not yet ported "
            "(ROADMAP queue 1, \"The opt-in engines\")"
        )
    if getattr(mcts_cfg, "gumbel", False):
        raise NotImplementedError(
            "Gumbel search (mcts/gumbel.py) is not yet ported "
            "(ROADMAP queue 1, \"The opt-in engines\")"
        )


def _make_root_counts_fn(game, apply_fn, mcts_cfg: MCTSConfig) -> Callable[..., torch.Tensor]:
    """``(state, dirichlet) -> root visit counts f32[B, A]``.

    The port's engine ladder, as in the JAX package: the fused kernel for
    a model it can evaluate inside the kernel (the uniform prior, or an
    ``MLPNet`` of the widths its evaluator takes, through its
    ``kernel_eval_factory``) on Connect-Four, on any device; then the
    hybrid engine for any model on a flat-ops game, which also takes what
    the fused kernel declines; then the dense engine (``mcts/search.py``)
    for what both decline. The engines the port lacks raise."""
    _check_ported(mcts_cfg)
    return (make_fused_root_fn(game, apply_fn, mcts_cfg)
            or make_hybrid_root_fn(game, apply_fn, mcts_cfg)
            or dense_root_fn(game, apply_fn, mcts_cfg))


def _choose(counts: torch.Tensor, temp, draws: Draws) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pi f32[B, A], action i64[B])`` from root counts: the
    temperature-applied play distribution (``temp`` a float or f32[B]) and
    the categorical sample ``argmax(log(pi + 1e-12) + draws.gumbel)``."""
    pi = action_probs(counts, temp, draws.tie)
    return pi, (torch.log(pi + 1e-12) + draws.gumbel).argmax(dim=-1)


def _move(root_counts, state, temp, draws: Draws) -> Tuple[torch.Tensor, torch.Tensor]:
    """One search of every board and its move (``_choose``)."""
    return _choose(root_counts(state, draws.dirichlet), temp, draws)


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per game: ``a`` where ``mask`` bool[B], else ``b``."""
    return torch.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


def make_actor_step_fn(
    game,
    apply_fn,
    mcts_cfg: MCTSConfig,
    batch_size: int,
    temp_threshold: int,
    device="cuda",
):
    """Returns ``(init_carry, actor_step)``.

    ``init_carry() -> (state, move_count int32[B])`` on ``device``;
    ``actor_step(carry, draws) -> (carry, pi f32[B, A])`` where ``pi`` is
    the temperature-applied play distribution (temp 1 before move
    ``temp_threshold``, 0 after) and the move is
    ``argmax(log(pi + 1e-12) + draws.gumbel)`` — a categorical sample.

    Forced playouts raise: the JAX actor runs its fused/hybrid ladder,
    which never reads them, so it searches unforced without a word."""
    if getattr(mcts_cfg, "forced_playouts", None) is not None:
        raise ValueError(
            "forced_playouts is a training-target device of the fixed scan "
            "(make_selfplay_fn); the actor step would search unforced (ROADMAP queue 3)"
        )
    root_counts = _make_root_counts_fn(game, apply_fn, mcts_cfg)
    B = batch_size

    def init_carry() -> Tuple[torch.Tensor, torch.Tensor]:
        return game.init(B, device), torch.zeros(B, dtype=torch.int32, device=device)

    def actor_step(carry, draws: Draws):
        state, move_count = carry
        temp = (move_count < temp_threshold).float()
        pi, action = _move(root_counts, state, temp, draws)
        state = game.step(state, action)
        done, _ = game.terminal(state)
        move_count = torch.where(done, 0, move_count + 1).to(torch.int32)
        state = _where(done, game.init(B, state.device), state)
        return (state, move_count), pi

    return init_carry, actor_step


def make_selfplay_fn(
    game,
    mcts_cfg: MCTSConfig,
    sp_cfg: SelfPlayConfig,
    device="cuda",
    record_states: bool = False,
) -> Callable[..., Tuple[Trajectory, SelfPlayStats]]:
    """Build ``play_games(model, draws) -> (Trajectory, SelfPlayStats)``:
    ``sp_cfg.batch_size`` games from the initial position, ``T =
    sp_cfg.max_moves or game.max_moves`` steps, temperature 1 at steps
    ``t < temp_threshold``. A finished board stays frozen and is still
    searched (its terminal root is inert); its later samples are masked.
    Sample ``t`` of a game that finished after ``moves`` moves gets the
    outcome signed by the parity of ``moves - t``; a game that never
    finishes has all its samples masked.

    With ``mcts_cfg.forced_playouts = k`` every move searches on the dense
    engine with the root's forced children searched first; the move plays
    from the raw counts and the stored target is ``action_probs`` of the
    pruned counts (``pruned_root_counts``), with the same tie draws.

    Playout-cap randomization, Gumbel search and ``record_states``
    (reanalyze's feed) are not ported and raise; tree reuse is not ported
    by design (ROADMAP, "Do not port")."""
    forced = getattr(mcts_cfg, "forced_playouts", None)
    if forced is not None and (
        getattr(mcts_cfg, "gumbel", False)
        or getattr(mcts_cfg, "tree_reuse", False)
        or getattr(mcts_cfg, "transposition", False)
        or getattr(sp_cfg, "full_search_prob", None) is not None
    ):
        raise ValueError(
            "forced_playouts is a root-PUCT training-target device — "
            "mutually exclusive with gumbel/tree_reuse/transposition/"
            "playout-cap randomization"
        )
    if getattr(sp_cfg, "full_search_prob", None) is not None:
        raise NotImplementedError(
            "playout-cap randomization is not yet ported "
            "(ROADMAP queue 1, \"The opt-in engines\")"
        )
    if getattr(mcts_cfg, "tree_reuse", False):
        raise NotImplementedError(
            "tree reuse (mcts/reuse.py) was measured and rejected and is not ported "
            "(ROADMAP, \"Do not port\")"
        )
    if record_states:
        raise NotImplementedError(
            "record_states feeds reanalyze.py, not yet ported "
            "(ROADMAP queue 1, \"The opt-in engines\")"
        )
    _check_ported(mcts_cfg)
    if forced is not None and getattr(mcts_cfg, "parallel_sims", 1) > 1:
        raise ValueError(
            "forced_playouts runs on the XLA engine — set "
            "parallel_sims=1"
        )
    B = sp_cfg.batch_size
    T = sp_cfg.max_moves or game.max_moves
    cpuct = float(mcts_cfg.cpuct)

    def play_games(model, draws: DrawsFn) -> Tuple[Trajectory, SelfPlayStats]:
        apply_fn = make_apply_fn(model)
        if forced is None:
            root_counts = _make_root_counts_fn(game, apply_fn, mcts_cfg)
        else:
            search = make_search_fn(game, apply_fn, mcts_cfg)
        state = game.init(B, device)
        done = torch.zeros(B, dtype=torch.bool, device=device)
        outcome = torch.zeros(B, device=device)
        moves = torch.zeros(B, dtype=torch.int32, device=device)
        feats, pis, valid = [], [], []
        for t in range(T):
            temp = 1.0 if t < sp_cfg.temp_threshold else 0.0
            d = draws(t)
            if forced is None:
                pi, action = _move(root_counts, state, temp, d)
            else:
                # play from the raw counts (the forcing is the exploration),
                # train on the pruned ones
                tree = search(state, d.dirichlet)
                _, action = _choose(tree.root_counts(), temp, d)
                pi = action_probs(pruned_root_counts(tree, float(forced), cpuct), temp, d.tie)
            feats.append(game.to_features(state))
            pis.append(pi)
            state = _where(done, state, game.step(state, action))
            now_done, tv = game.terminal(state)
            outcome = torch.where(~done & now_done, tv, outcome)
            moves = moves + (~done).to(torch.int32)
            valid.append(~done)
            done = done | now_done

        # negamax walk-back: sample t's player sits moves - t plies before
        # the final to-move player
        dist = moves[None, :] - torch.arange(T, device=device, dtype=torch.int32)[:, None]
        sign = torch.where(dist % 2 == 1, -1.0, 1.0)
        valid = torch.stack(valid) & done[None, :]
        value = sign * outcome[None, :] * valid
        traj = Trajectory(torch.stack(feats), torch.stack(pis), value, valid)
        return traj, SelfPlayStats(outcome=outcome, num_moves=moves, done=done)

    return play_games


def make_recycling_selfplay_fn(
    game,
    mcts_cfg: MCTSConfig,
    sp_cfg: SelfPlayConfig,
    device="cuda",
):
    """Episode recycling with exact value targets. Returns ``(init_carry,
    play)``: ``init_carry() -> ActorCarry`` on ``device``;
    ``play(model, carry, draws) -> (carry, Trajectory, SelfPlayStats)``.

    A call runs ``S = recycle_steps or max_moves or game.max_moves``
    searches (``S >= M = game.max_moves``, so an episode spans at most two
    calls), every one a real move at temperature 1 while the game's own
    move clock is below ``temp_threshold``. Each sample goes into the
    game's fragment at row ``move_count``; a game that closes, or reaches
    ``M`` moves open (truncation), resets to the initial position. After
    the ``S`` steps a reverse walk-back values the call's samples: a
    closing move's sample gets ``-tv``, each earlier one the negation of
    the next, and a truncation starts the walk over with value 0 and the
    rows invalid. The carried fragment (the open episode of the last call)
    resolves by parity from step 0's value. The trajectory holds ``S + M``
    rows a game, the carried fragment's first; the fragment's rows at or
    past the carried length keep their stale contents, masked.

    Stats: ``outcome`` the terminal value of each game's last closure in
    the call (0 if none), ``num_moves`` = S, ``done`` whether any episode
    closed. tree_reuse, forced playouts, transposition and playout-cap
    randomization raise the JAX package's ``ValueError``; Gumbel search is
    not ported."""
    if getattr(mcts_cfg, "tree_reuse", False):
        raise ValueError("recycling self-play is incompatible with tree_reuse")
    if getattr(mcts_cfg, "forced_playouts", None) is not None:
        raise ValueError("recycling self-play is incompatible with forced_playouts")
    if getattr(mcts_cfg, "transposition", False):
        raise ValueError("recycling self-play is incompatible with transposition")
    if getattr(sp_cfg, "full_search_prob", None) is not None:
        raise ValueError("recycling self-play is incompatible with playout-cap randomization")
    _check_ported(mcts_cfg)
    B = sp_cfg.batch_size
    M = game.max_moves
    S = getattr(sp_cfg, "recycle_steps", None) or sp_cfg.max_moves or M
    if S < M:
        raise ValueError(
            f"recycle_steps={S} must be >= game.max_moves={M} so an episode "
            "spans at most two calls (the fragment carry holds exactly one "
            "open episode per game)"
        )
    A = game.num_actions

    def init_carry() -> ActorCarry:
        return ActorCarry(
            state=game.init(B, device),
            move_count=torch.zeros(B, dtype=torch.int32, device=device),
            frag_features=torch.zeros((M, B, *game.feature_shape), device=device),
            frag_pi=torch.zeros((M, B, A), device=device),
        )

    def play(model, carry: ActorCarry, draws: DrawsFn):
        root_counts = _make_root_counts_fn(game, make_apply_fn(model), mcts_cfg)
        dev = carry.move_count.device
        fresh = game.init(B, dev)
        games = torch.arange(B, device=dev)
        state, mc = carry.state, carry.move_count
        ff, fp = carry.frag_features.clone(), carry.frag_pi.clone()
        feats, pis, closed, tvs, truncs = [], [], [], [], []
        for t in range(S):
            pi, action = _move(root_counts, state, (mc < sp_cfg.temp_threshold).float(), draws(t))
            f = game.to_features(state)
            row = mc.long()
            ff[row, games] = f
            fp[row, games] = pi
            nxt = game.step(state, action)
            now_done, tv = game.terminal(nxt)
            trunc = ~now_done & (mc + 1 >= M)
            recycle = now_done | trunc
            mc = torch.where(recycle, 0, mc + 1).to(torch.int32)
            state = _where(recycle, fresh, nxt)
            feats.append(f)
            pis.append(pi)
            closed.append(now_done)
            tvs.append(tv)
            truncs.append(trunc)
        closed_all = torch.stack(closed)
        tvs_all = torch.stack(tvs)

        # reverse negamax walk-back over the call's steps, started over at
        # each closure (-tv) and each truncation (0, invalid)
        values = torch.empty((S, B), device=dev)
        valids = torch.empty((S, B), dtype=torch.bool, device=dev)
        v = torch.zeros(B, device=dev)
        ok = torch.zeros(B, dtype=torch.bool, device=dev)
        for t in reversed(range(S)):
            v = torch.where(closed[t], -tvs[t], torch.where(truncs[t], 0.0, -v))
            ok = closed[t] | (~truncs[t] & ok)
            values[t] = v
            valids[t] = ok

        # the carried fragment: row j is move j of the episode whose move
        # frag_len is this call's step 0
        frag_len = carry.move_count
        rows = torch.arange(M, device=dev, dtype=torch.int32)[:, None]
        dist = frag_len[None, :] - rows
        frag_valid = valids[0][None, :] & (rows < frag_len[None, :])
        frag_vals = values[0][None, :] * torch.where(dist % 2 == 1, -1.0, 1.0) * frag_valid

        traj = Trajectory(
            features=torch.cat([carry.frag_features, torch.stack(feats)]),
            pi=torch.cat([carry.frag_pi, torch.stack(pis)]),
            value=torch.cat([frag_vals, values * valids]),
            valid=torch.cat([frag_valid, valids]),
        )
        any_closed = closed_all.any(dim=0)
        last = (closed_all * torch.arange(S, device=dev)[:, None]).amax(dim=0)
        stats = SelfPlayStats(
            outcome=torch.where(any_closed, tvs_all.gather(0, last[None])[0], 0.0),
            num_moves=torch.full((B,), S, dtype=torch.int32, device=dev),
            done=any_closed,
        )
        return ActorCarry(state, mc, ff, fp), traj, stats

    return init_carry, play
