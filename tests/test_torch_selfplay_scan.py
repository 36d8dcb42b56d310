"""The port's episode generators against the JAX package's, under JAX's own
draws (the four-way split of each scan step, replayed): the fixed scan
``make_selfplay_fn`` on Connect-Four and on Othello, and the recycling
``make_recycling_selfplay_fn`` on Connect-Four over two consecutive calls,
so that the carried fragment is emitted and resolved. Trajectory, stats
and carry must be bit-equal, but for the one place the port departs from
the reference on purpose: the rows of a truncated episode
(``test_recycling_truncation_masks_the_cut_episode``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.config import SelfPlayConfig as JaxSelfPlayConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.games import Othello as JaxOthello
from alphazero_tpu.games.connect_four import ConnectFourState
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu.selfplay import ActorCarry as JaxActorCarry
from alphazero_tpu.selfplay import make_recycling_selfplay_fn as jax_recycling
from alphazero_tpu.selfplay import make_selfplay_fn as jax_selfplay
from alphazero_tpu_torch.config import MCTSConfig, SelfPlayConfig
from alphazero_tpu_torch.games import ConnectFour, Othello
from alphazero_tpu_torch.models import make_uniform_model
from alphazero_tpu_torch.selfplay import (
    ActorCarry,
    make_recycling_selfplay_fn,
    make_selfplay_fn,
)
from tests.torch_parity import jax_scan_draws

B = 8
TEMP_THRESHOLD = 6


def _cfgs(sims=8, depth=48, alpha=1.0, **sp):
    jm = JaxMCTSConfig(num_sims=sims, max_depth=depth, dirichlet_alpha=alpha)
    js = JaxSelfPlayConfig(batch_size=B, temp_threshold=TEMP_THRESHOLD, **sp)
    return jm, js, MCTSConfig(**dataclasses.asdict(jm)), SelfPlayConfig(**dataclasses.asdict(js))


def _equal(jax_tuple, torch_tuple, what):
    for name, j, t in zip(jax_tuple._fields, jax_tuple, torch_tuple):
        if hasattr(j, "board"):
            j = j.board
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=f"{what}.{name}")


def test_fixed_scan_matches_jax_connect_four():
    jm, js, cfg, sp = _cfgs()
    jg, tg = JaxConnectFour(), ConnectFour()
    key = jax.random.key(11)
    j_traj, j_stats = jax.jit(jax_selfplay(jg, jax_uniform(jg).apply_fn, jm, js))({}, key)
    draws = jax_scan_draws(key, tg.max_moves, B, tg.num_actions, 1.0)
    play = make_selfplay_fn(tg, cfg, sp, device="cpu")
    t_traj, t_stats = play(make_uniform_model(tg), lambda t: draws[t])
    _equal(j_traj, t_traj, "traj")
    _equal(j_stats, t_stats, "stats")
    assert t_stats.done.all() and t_traj.valid.any()
    assert (t_traj.value[t_traj.valid] != 0).any()


def test_fixed_scan_matches_jax_othello_with_unfinished_games():
    """Othello through the hybrid engine, cut at 6 moves: no game ends, so
    every sample is masked and every value is 0, as in the reference."""
    jm, js, cfg, sp = _cfgs(sims=4, depth=80, alpha=0.3, max_moves=6)
    jg, tg = JaxOthello(), Othello()
    key = jax.random.key(12)
    j_traj, j_stats = jax.jit(jax_selfplay(jg, jax_uniform(jg).apply_fn, jm, js))({}, key)
    draws = jax_scan_draws(key, 6, B, tg.num_actions, 0.3)
    play = make_selfplay_fn(tg, cfg, sp, device="cpu")
    t_traj, t_stats = play(make_uniform_model(tg), lambda t: draws[t])
    _equal(j_traj, t_traj, "traj")
    _equal(j_stats, t_stats, "stats")
    assert not t_stats.done.any() and not t_traj.valid.any()
    assert (t_stats.num_moves == 6).all() and (t_traj.pi.sum(-1) > 0.99).all()


def _jax_carry(carry: ActorCarry, state_cls=ConnectFourState) -> JaxActorCarry:
    return JaxActorCarry(
        state=state_cls(board=jnp.asarray(carry.state.numpy())),
        move_count=jnp.asarray(carry.move_count.numpy()),
        frag_features=jnp.asarray(carry.frag_features.numpy()),
        frag_pi=jnp.asarray(carry.frag_pi.numpy()),
    )


def _recycle_both(jg, tg, jm, js, cfg, sp, keys, carry=None):
    """Consecutive recycling calls of both packages from the same carry
    (the initial one when None), one JAX key a call; yields each call's
    ``(jax (carry, traj, stats), port (carry, traj, stats))``."""
    j_init, j_play = jax_recycling(jg, jax_uniform(jg).apply_fn, jm, js)
    t_init, t_play = make_recycling_selfplay_fn(tg, cfg, sp, device="cpu")
    j_play = jax.jit(j_play)
    t_carry = t_init() if carry is None else carry
    j_carry = j_init() if carry is None else _jax_carry(carry)
    steps = sp.recycle_steps or sp.max_moves or tg.max_moves
    for key in keys:
        draws = jax_scan_draws(key, steps, B, tg.num_actions, cfg.dirichlet_alpha)
        j_out = j_play({}, j_carry, key)
        t_out = t_play(make_uniform_model(tg), t_carry, lambda t: draws[t])
        yield j_out, t_out
        j_carry, t_carry = j_out[0], t_out[0]


def test_recycling_matches_jax_over_two_calls():
    jm, js, cfg, sp = _cfgs(recycle=True)
    jg, tg = JaxConnectFour(), ConnectFour()
    M = tg.max_moves
    calls = list(_recycle_both(jg, tg, jm, js, cfg, sp, [jax.random.key(21), jax.random.key(22)]))
    for i, (j_out, t_out) in enumerate(calls):
        for what, j, t in zip(("carry", "traj", "stats"), j_out, t_out):
            _equal(j, t, f"call {i} {what}")
    (_, traj0, stats0), (carry1, traj1, _) = calls[0][1], calls[1][1]
    assert not traj0.valid[:M].any()             # the first call carries no fragment in
    assert traj1.valid[:M].any()                 # the second resolves the first's
    assert stats0.done.all() and (carry1.move_count > 0).any()


def _recycling_reference(tg, carry: ActorCarry, traj, draws, S: int):
    """One recycling call's valid rows and values, worked out game by game
    from its moves replayed on the game engine (each move the
    ``argmax(log(pi + 1e-12) + gumbel)`` of the call's pi and draws): an
    episode that closes values its samples by negamax from ``-tv`` at its
    closing move; an episode cut at ``M`` open moves, or still open at the
    call's end, leaves its rows invalid with value 0. The carried fragment's
    rows ``0..move_count - 1`` open the first episode. Returns numpy
    ``(valid, value, truncated)`` of shape ``[M + S, B]``, ``truncated``
    marking the cut episodes' rows."""
    M, B = tg.max_moves, carry.move_count.shape[0]
    valid = np.zeros((M + S, B), bool)
    value = np.zeros((M + S, B), np.float32)
    truncated = np.zeros((M + S, B), bool)
    actions = torch.stack([(torch.log(traj.pi[M + t] + 1e-12) + draws[t].gumbel).argmax(-1)
                           for t in range(S)])
    for b in range(B):
        board = carry.state[b:b + 1]
        episode = list(range(int(carry.move_count[b])))   # its rows, move by move
        for t in range(S):
            np.testing.assert_array_equal(tg.to_features(board)[0].numpy(),
                                          traj.features[M + t, b].numpy())
            episode.append(M + t)
            board = tg.step(board, actions[t, b:b + 1])
            done, tv = tg.terminal(board)
            if bool(done[0]):
                for k, row in enumerate(episode):
                    valid[row, b] = True
                    value[row, b] = -float(tv[0]) * (-1.0) ** (len(episode) - 1 - k)
            elif len(episode) == M:
                truncated[episode, b] = True
            if bool(done[0]) or len(episode) == M:
                board, episode = tg.init(1, "cpu"), []
    return valid, value, truncated


def test_recycling_truncation_masks_the_cut_episode():
    """ROADMAP queue 3, ADVICE medium: the JAX reverse scan ignores
    truncation, so a game cut at ``max_moves`` without ending emits its
    samples valid, carrying the next episode's values sign-flipped. The
    port starts the walk-back over at a truncation: those rows are invalid
    with value 0. On a Connect-Four whose ``max_moves`` is 12, with S = 24
    (so a cut can fall inside a call, with a closed episode after it) and
    some games one move from the cut, the port's valid rows and values are
    those of a per-game replay of the moves (``_recycling_reference``), and
    the port departs from the reference exactly on the truncated rows that
    the reference marks valid."""

    class JaxC4Cut(JaxConnectFour):
        max_moves = 12

    class C4Cut(ConnectFour):
        max_moves = 12

    S, M = 24, 12
    jm, js, cfg, sp = _cfgs(recycle=True, recycle_steps=S)
    jg, tg = JaxC4Cut(), C4Cut()
    # games 0-3 open at move 11 of a random-play board: each is cut by the
    # first step unless that move ends it
    carry = make_recycling_selfplay_fn(tg, cfg, sp, device="cpu")[0]()
    rng = np.random.default_rng(3)
    state = carry.state.clone()
    for _ in range(11):
        valid = tg.valid_moves(state).numpy()
        acts = torch.as_tensor([rng.choice(np.flatnonzero(v)) for v in valid])
        nxt = tg.step(state, acts)
        state = torch.where(tg.terminal(nxt)[0][:, None, None], state, nxt)
    live = ~tg.terminal(state)[0]
    open_at = torch.where(torch.arange(B) < 4, 11, 0).to(torch.int32) * live
    carry = carry._replace(state=torch.where((open_at > 0)[:, None, None], state, carry.state),
                           move_count=open_at)

    keys = [jax.random.key(31), jax.random.key(32)]
    differ = 0
    t_in = carry
    for i, (j_out, t_out) in enumerate(_recycle_both(jg, tg, jm, js, cfg, sp, keys, carry)):
        (j_carry, j_traj, j_stats), (t_carry, t_traj, t_stats) = j_out, t_out
        _equal(j_carry, t_carry, f"call {i} carry")
        _equal(j_stats, t_stats, f"call {i} stats")
        for j, t in zip(j_traj[:2], t_traj[:2]):   # features, pi
            np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=f"call {i} traj")
        draws = jax_scan_draws(keys[i], S, B, tg.num_actions, cfg.dirichlet_alpha)
        r_valid, r_value, truncated = _recycling_reference(tg, t_in, t_traj, draws, S)
        tv, tval = t_traj.valid.numpy(), t_traj.value.numpy()
        np.testing.assert_array_equal(tv, r_valid, err_msg=f"call {i} valid vs the replay")
        np.testing.assert_array_equal(tval, r_value, err_msg=f"call {i} value vs the replay")
        # the port departs from the reference exactly on the truncated rows
        # the reference marks valid; every other row is equal
        jv, jval = np.asarray(j_traj.valid), np.asarray(j_traj.value)
        cut = jv & ~tv
        np.testing.assert_array_equal(cut, truncated & jv, err_msg=f"call {i} cut rows")
        np.testing.assert_array_equal(jv[~cut], tv[~cut], err_msg=f"call {i} valid")
        np.testing.assert_array_equal(jval[~cut], tval[~cut], err_msg=f"call {i} value")
        differ += int(cut.sum())
        t_in = t_carry
    assert differ > 0   # truncation was reached and the two packages differ there
