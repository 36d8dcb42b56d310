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
Gumbel noise for the move choice or for Gumbel search's root, playout-cap
randomization's permutation) are an input, ``ops.Draws``; the episode
generators take a callable ``draws(t) -> Draws`` for step ``t`` of a call,
which real runs build on ``ops.sample_draws`` and one ``torch.Generator``.
They take the model (``UniformModel``, ``AZResNet``, ``AZConvNet`` or ``MLPNet``) on
every call and rebuild its search ``apply_fn`` there (a conv net refolded,
an MLPNet's kernel weights repacked), so trained weights reach the actor.

With ``MCTSConfig.gumbel`` every generator searches with Gumbel
sequential halving (``mcts/gumbel.py``): the move is the halving winner
and the stored target the improved policy, with no temperature and no
categorical draw.

Under a ``mesh`` (``parallel/``) every generator plays this rank's games,
the rows ``batch_sharding`` gives it of the global batch, and returns
their trajectory, stats and carry; the caller gathers them in global game
order (``parallel.distributed.all_gather``). Every rank draws the global
step's draws and keeps its rows, so a game's moves are those of the
one-process run. Playout-cap randomization's sub-batches split over the
ranks as JAX's ``shard_map`` splits them: the step's boards are gathered,
each rank searches its share of the permuted full and cheap sub-batches,
and the outputs are gathered back; each sub-batch must divide over the
ranks. Each engine call, and so each per-batch choice a kernel wrapper
makes, sees the rank's own batch.

One semantic differs from the JAX package on purpose: recycling's
walk-back starts over at a truncation, so a truncated episode's samples
are invalid with value 0; the JAX scan marks them valid with the next
episode's values (ROADMAP queue 3, "ADVICE medium").
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

from alphazero_tpu_torch.config import MCTSConfig, SelfPlayConfig
from alphazero_tpu_torch.mcts.fused import make_fused_root_fn
from alphazero_tpu_torch.mcts.gumbel import check_gumbel_config, make_gumbel_search_fn
from alphazero_tpu_torch.mcts.hybrid import make_hybrid_root_fn
from alphazero_tpu_torch.mcts.search import dense_root_fn, make_search_fn, pruned_root_counts
from alphazero_tpu_torch.mcts.tt import tt_root_fn
from alphazero_tpu_torch.models import make_apply_fn
from alphazero_tpu_torch.ops import Draws, action_probs
from alphazero_tpu_torch.parallel.distributed import all_gather
from alphazero_tpu_torch.parallel.mesh import batch_sharding

DrawsFn = Callable[[int], Draws]


def _rows(mesh, batch: int, what: str = "self-play batch") -> slice:
    """This rank's games of a ``batch``-game call (all of them without a
    mesh)."""
    return slice(None) if mesh is None else batch_sharding(mesh, batch, what)


def _local_draws(d: Draws, rows: slice) -> Draws:
    """This rank's rows of a step's global draws; the permutation stays
    global."""
    return Draws(None if d.dirichlet is None else d.dirichlet[rows], d.tie[rows],
                 d.gumbel[rows], d.perm)


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


def _make_root_counts_fn(game, apply_fn, mcts_cfg: MCTSConfig) -> Callable[..., torch.Tensor]:
    """``(state, dirichlet) -> root visit counts f32[B, A]``.

    The port's engine ladder, as in the JAX package: the transposition
    engine (``mcts/tt.py``) first when ``mcts_cfg.transposition`` opts in;
    else the fused kernel for a model it can evaluate inside the kernel
    (the uniform prior, or an ``MLPNet`` of any widths through its
    ``kernel_eval_factory``) on a flat-ops game of at most 16 actions with
    a zero heuristic (Connect-Four, Gomoku of at most 16 cells), on any
    device; then the hybrid engine for any model on a flat-ops game, which
    also takes what the fused kernel declines; then the dense engine
    (``mcts/search.py``) for what both decline."""
    if getattr(mcts_cfg, "transposition", False):
        return tt_root_fn(game, apply_fn, mcts_cfg)
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


def _make_mover(game, apply_fn, mcts_cfg: MCTSConfig) -> Callable[..., Tuple[torch.Tensor,
                                                                          torch.Tensor]]:
    """``move(state, temp, draws) -> (pi, action)`` of every board: the
    ladder's counts and ``_choose``, or with ``mcts_cfg.gumbel`` Gumbel
    search from the root sample ``draws.gumbel`` (``pi`` the improved
    policy, ``action`` the halving winner; ``temp`` is not used)."""
    if getattr(mcts_cfg, "gumbel", False):
        gsearch = make_gumbel_search_fn(game, apply_fn, mcts_cfg)

        def gumbel_move(state, temp, draws: Draws):
            res = gsearch(state, draws.gumbel)
            return res.improved_pi, res.action

        return gumbel_move
    root_counts = _make_root_counts_fn(game, apply_fn, mcts_cfg)
    return lambda state, temp, draws: _move(root_counts, state, temp, draws)


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
    mesh=None,
):
    """Returns ``(init_carry, actor_step)``.

    ``init_carry() -> (state, move_count int32[B])`` on ``device``;
    ``actor_step(carry, draws) -> (carry, pi f32[B, A])`` where ``pi`` is
    the temperature-applied play distribution (temp 1 before move
    ``temp_threshold``, 0 after) and the move is
    ``argmax(log(pi + 1e-12) + draws.gumbel)`` — a categorical sample; with
    Gumbel search, the improved policy and the halving winner.

    Forced playouts raise: the JAX actor runs its fused/hybrid ladder,
    which never reads them, so it searches unforced without a word.

    Under ``mesh`` the carry holds this rank's games of the global
    ``batch_size``, ``draws`` are the global step's, and ``pi`` is this
    rank's rows."""
    if getattr(mcts_cfg, "forced_playouts", None) is not None:
        raise ValueError(
            "forced_playouts is a training-target device of the fixed scan "
            "(make_selfplay_fn); the actor step would search unforced (ROADMAP queue 3)"
        )
    move = _make_mover(game, apply_fn, mcts_cfg)
    rows = _rows(mesh, batch_size)
    B = batch_size if mesh is None else batch_size // mesh.data

    def init_carry() -> Tuple[torch.Tensor, torch.Tensor]:
        return game.init(B, device), torch.zeros(B, dtype=torch.int32, device=device)

    def actor_step(carry, draws: Draws):
        state, move_count = carry
        temp = (move_count < temp_threshold).float()
        pi, action = move(state, temp, _local_draws(draws, rows))
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
    mesh=None,
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

    With ``mcts_cfg.gumbel`` every move is Gumbel search's (``_make_mover``).

    Playout-cap randomization (``sp_cfg.full_search_prob = p``): each step
    exactly ``n_full = round(p * B)`` games search the full budget and the
    rest ``sp_cfg.cheap_sims`` simulations without root noise; the games are
    the first ``n_full`` of the step's permutation ``draws(t).perm``, and the
    two sub-batches search as two batches (the noise in permuted order,
    ``ops.Draws``), their results scattered back to game order. A cheap
    move advances the game and stores an all-zero ``pi``: a value-only
    sample. ``p`` of 0 or 1 runs one search of the whole batch.

    ``record_states=True`` makes ``play_games`` return ``(Trajectory,
    SelfPlayStats, states [T, B, ...])``, each sample's root state before
    its move (reanalyze's feed); the trajectory is the same. Tree reuse is
    not ported by design (ROADMAP, "Do not port").

    Under ``mesh`` ``play_games`` plays this rank's games from the global
    ``draws(t)`` and returns their rows (``B`` the rank's share)."""
    forced = getattr(mcts_cfg, "forced_playouts", None)
    gumbel = getattr(mcts_cfg, "gumbel", False)
    reuse = getattr(mcts_cfg, "tree_reuse", False)
    pcr = getattr(sp_cfg, "full_search_prob", None)
    if forced is not None and (
        gumbel
        or reuse
        or getattr(mcts_cfg, "transposition", False)
        or pcr is not None
    ):
        raise ValueError(
            "forced_playouts is a root-PUCT training-target device — "
            "mutually exclusive with gumbel/tree_reuse/transposition/"
            "playout-cap randomization"
        )
    B = sp_cfg.batch_size
    cheap_cfg = None
    if pcr is not None:
        if sp_cfg.cheap_sims is None:
            raise ValueError("full_search_prob requires cheap_sims")
        if reuse:
            raise ValueError(
                "playout-cap randomization is incompatible with tree_reuse "
                "(carried trees assume a fixed per-move budget/capacity)"
            )
        # cheap searches take no root noise (KataGo)
        cheap_cfg = dataclasses.replace(mcts_cfg, num_sims=int(sp_cfg.cheap_sims),
                                        max_nodes=None, dirichlet_alpha=None)
        n_full = max(0, min(B, int(round(pcr * B))))
        if mesh is not None and 0 < n_full < sp_cfg.batch_size:
            shards = int(mesh.shape.get("data", 1))
            if n_full % shards or (sp_cfg.batch_size - n_full) % shards:
                raise ValueError(
                    "full_search_prob sub-batches must divide the mesh "
                    f"data axis: round(p*B)={n_full} of B="
                    f"{sp_cfg.batch_size} over {shards} shards"
                )
    if gumbel and (reuse or getattr(mcts_cfg, "transposition", False)):
        raise ValueError(
            "gumbel is its own root/interior scoring rule — it is "
            "mutually exclusive with tree_reuse and transposition"
        )
    if reuse:
        raise NotImplementedError(
            "tree reuse (mcts/reuse.py) was measured and rejected and is not ported "
            "(ROADMAP, \"Do not port\")"
        )
    if gumbel:
        check_gumbel_config(mcts_cfg)   # when built, as the JAX generator refuses
    if forced is not None and getattr(mcts_cfg, "parallel_sims", 1) > 1:
        raise ValueError(
            "forced_playouts runs on the XLA engine — set "
            "parallel_sims=1"
        )
    T = sp_cfg.max_moves or game.max_moves
    cpuct = float(mcts_cfg.cpuct)
    rows = _rows(mesh, B)
    gather = (lambda x: x) if mesh is None else (lambda x: all_gather(x, mesh))

    def make_step(apply_fn) -> Callable:
        """``step(state, temp, draws) -> (pi, action)`` of every board of
        this rank, from the global step's ``draws``."""
        inner = make_inner_step(apply_fn)
        if pcr is not None:
            return inner
        return lambda state, temp, d: inner(state, temp, _local_draws(d, rows))

    def make_inner_step(apply_fn) -> Callable:
        if forced is not None:
            search = make_search_fn(game, apply_fn, mcts_cfg)

            def forced_step(state, temp, d: Draws):
                # play from the raw counts (the forcing is the exploration),
                # train on the pruned ones
                tree = search(state, d.dirichlet)
                _, action = _choose(tree.root_counts(), temp, d)
                return action_probs(pruned_root_counts(tree, float(forced), cpuct), temp,
                                    d.tie), action

            return forced_step
        if pcr is None:
            return _make_mover(game, apply_fn, mcts_cfg)
        if gumbel:
            full_search = make_gumbel_search_fn(game, apply_fn, mcts_cfg)
            cheap_search = make_gumbel_search_fn(game, apply_fn, cheap_cfg)

            def run_full(sub, noise):
                res = full_search(sub, noise)
                return res.improved_pi, res.action

            def run_cheap(sub, noise):
                # cheap moves emit value-only samples
                res = cheap_search(sub, noise)
                return torch.zeros_like(res.improved_pi), res.action
        else:
            root_counts = _make_root_counts_fn(game, apply_fn, mcts_cfg)
            cheap_counts = _make_root_counts_fn(game, apply_fn, cheap_cfg)

            def run_full(sub, noise):
                return (root_counts(sub, noise),)

            def run_cheap(sub, noise):
                return (cheap_counts(sub),)

        def split_search(state, d: Draws) -> tuple:
            """The full search of the step's first ``n_full`` permuted games
            and the cheap one of the rest, each output back in game order;
            ``(full bool[b], outputs)`` of this rank's ``b`` games. Under a
            mesh each rank searches its share of each permuted sub-batch,
            and the outputs are gathered back."""
            noise = d.gumbel if gumbel else d.dirichlet
            b = state.shape[0]
            if n_full >= B:
                return (torch.ones(b, dtype=torch.bool, device=state.device),
                        run_full(state, None if noise is None else noise[rows]))
            if n_full <= 0:
                return (torch.zeros(b, dtype=torch.bool, device=state.device),
                        run_cheap(state, None if noise is None else noise[rows]))
            if d.perm is None:
                raise ValueError(
                    "playout-cap randomization needs the step's permutation (Draws.perm)")
            inv = torch.argsort(d.perm)
            sub = gather(state)[d.perm]
            fr = _rows(mesh, n_full, "full sub-batch")
            cr = _rows(mesh, B - n_full, "cheap sub-batch")
            out_f = run_full(sub[:n_full][fr], None if noise is None else noise[:n_full][fr])
            out_c = run_cheap(sub[n_full:][cr], None if noise is None else noise[n_full:][cr])
            return (inv < n_full)[rows], tuple(
                torch.cat([gather(a), gather(c)])[inv][rows] for a, c in zip(out_f, out_c))

        def pcr_step(state, temp, d: Draws):
            full, out = split_search(state, d)
            if gumbel:
                return out
            pi, action = _choose(out[0], temp, _local_draws(d, rows))
            # a cheap move advances the game but stores a value-only sample
            return torch.where(full[:, None], pi, 0.0), action

        return pcr_step

    def play_games(model, draws: DrawsFn):
        step = make_step(make_apply_fn(model))
        b = B if mesh is None else B // mesh.data
        state = game.init(b, device)
        done = torch.zeros(b, dtype=torch.bool, device=device)
        outcome = torch.zeros(b, device=device)
        moves = torch.zeros(b, dtype=torch.int32, device=device)
        feats, pis, valid, roots = [], [], [], []
        for t in range(T):
            temp = 1.0 if t < sp_cfg.temp_threshold else 0.0
            pi, action = step(state, temp, draws(t))
            feats.append(game.to_features(state))
            pis.append(pi)
            if record_states:
                roots.append(state)
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
        stats = SelfPlayStats(outcome=outcome, num_moves=moves, done=done)
        if record_states:
            return traj, stats, torch.stack(roots)
        return traj, stats

    return play_games


def make_recycling_selfplay_fn(
    game,
    mcts_cfg: MCTSConfig,
    sp_cfg: SelfPlayConfig,
    device="cuda",
    mesh=None,
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
    closed. With ``mcts_cfg.gumbel`` every move is Gumbel search's
    (``_make_mover``). tree_reuse, forced playouts, transposition and
    playout-cap randomization raise the JAX package's ``ValueError``.

    Under ``mesh`` the carry, the trajectory and the stats hold this
    rank's games, and ``draws(t)`` are the global step's."""
    if getattr(mcts_cfg, "tree_reuse", False):
        raise ValueError("recycling self-play is incompatible with tree_reuse")
    if getattr(mcts_cfg, "forced_playouts", None) is not None:
        raise ValueError("recycling self-play is incompatible with forced_playouts")
    if getattr(mcts_cfg, "transposition", False):
        raise ValueError("recycling self-play is incompatible with transposition")
    if getattr(sp_cfg, "full_search_prob", None) is not None:
        raise ValueError("recycling self-play is incompatible with playout-cap randomization")
    if getattr(mcts_cfg, "gumbel", False):
        check_gumbel_config(mcts_cfg)
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
    own = _rows(mesh, B)
    if mesh is not None:
        B //= mesh.data

    def init_carry() -> ActorCarry:
        return ActorCarry(
            state=game.init(B, device),
            move_count=torch.zeros(B, dtype=torch.int32, device=device),
            frag_features=torch.zeros((M, B, *game.feature_shape), device=device),
            frag_pi=torch.zeros((M, B, A), device=device),
        )

    def play(model, carry: ActorCarry, draws: DrawsFn):
        move = _make_mover(game, make_apply_fn(model), mcts_cfg)
        dev = carry.move_count.device
        fresh = game.init(B, dev)
        games = torch.arange(B, device=dev)
        state, mc = carry.state, carry.move_count
        ff, fp = carry.frag_features.clone(), carry.frag_pi.clone()
        feats, pis, closed, tvs, truncs = [], [], [], [], []
        for t in range(S):
            pi, action = move(state, (mc < sp_cfg.temp_threshold).float(),
                              _local_draws(draws(t), own))
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
