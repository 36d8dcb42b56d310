"""The fused kernels on Gomoku boards of at most 16 cells: the uniform
``az_fused_gomoku`` and ``az_fused_gomoku_rounds`` (a group of G lanes a
game, G the smallest power of two >= A + 1) and the streamed MLP kernels
(``az_fused_mlp_stream``, ``az_fused_mlp_stream_rounds``,
``az_mlp_eval_stream``) on the Gomoku game policy, compiled with g++
against the CPU stand-in for the CUDA built-ins (tests/cuda_emu/; the
``emulated`` fixture of tests/torch_parity.py) and run on host memory, on
``Gomoku(3, 3)`` (tic-tac-toe, A = 9: 16 lanes), ``Gomoku(4, 4)`` (A = 16: a
whole warp), ``Gomoku(4, 3)`` (24 win lines) and ``Gomoku(2, 2)`` (A = 4:
eight lanes), at K=1 and at every K the reference's rule (K+1)^A < 2^24
admits: K <= 5 at A = 9, K = 1 only at A = 16, K <= 62 at A = 4 (past K = 9
the round's leaves go to the device scratch).

Tolerances: the uniform kernels' counts and root W bit-equal to the plain
versions (``fused_search``, ``fused_rounds_search`` on the game's flat
ops), on scratch filled with NaN; the MLP kernels with order-free weights
(``assert_order_free`` checks the plain f32 forward against float64):
counts and logits bit-equal, root W within num_sims x 1e-6 (glibc's
tanhf). And the port's fused route against the JAX fused kernel in the
Pallas interpreter (blocks of 4 games, as tests/test_torch_fallthrough.py
runs it) on the same boards and Dirichlet draws: the uniform counts exactly
equal; the MLP's with random weights within the bound the JAX package holds
its Mosaic kernel to against its XLA engine (>= 75% of games identical, max
|dpi| <= 0.25).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import Gomoku as JaxGomoku
from alphazero_tpu.mcts.fused import make_fused_root_fn as jax_fused_root_fn
from alphazero_tpu.models import MLPNet as JaxMLPNet
from alphazero_tpu.models import make_flax_apply_fn
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import Gomoku
from alphazero_tpu_torch.mcts import (
    fused_mlp_rounds_search,
    fused_mlp_search,
    fused_rounds_search,
    fused_search,
    make_fused_root_fn,
)
from alphazero_tpu_torch.mcts.fused import mlp_forward
from alphazero_tpu_torch.models import (
    convert_mlp,
    make_apply_fn,
    make_uniform_model,
    order_free_mlp_variables,
    random_mlp_variables,
)
from alphazero_tpu_torch.ops import sample_draws
from alphazero_tpu_torch.selfplay import _make_root_counts_fn
from tests.torch_parity import (  # noqa: F401  (emulated: a fixture)
    assert_order_free,
    bits,
    emulated,
    gomoku_jax_state,
    random_play_boards,
    torch_state,
)

EXP_ATOL = 1e-6     # a leaf value with bit-equal logits: glibc's tanhf against torch's
SAME_GAMES = 0.75   # the JAX package's Mosaic-vs-XLA bound
MAX_DPI = 0.25
BOARDS = {"3x3": (3, 3), "4x4": (4, 4), "4x4_win3": (4, 3), "2x2": (2, 2)}
B = 20


def _roots(game, seed: int, moves: int = 2):
    return torch_state(random_play_boards(game, B, moves, seed=seed, freeze_done=False))


def _checked(lib, calls, mlp: bool):
    """A stand-in for the fused wrappers (``kernels.fused``,
    ``fused_rounds``, ``fused_mlp``, ``fused_mlp_rounds``) on Gomoku: the
    emulated kernel on scratch filled with NaN AND its plain version on
    every call, counts bit-equal, root W bit-equal (uniform) or within
    num_sims x EXP_ATOL (MLP)."""

    def run(boards, priors, *search, ops):
        if mlp:
            weights, (num_sims, nodes, max_depth, cpuct, *rest) = search[0], search[1:]
        else:
            num_sims, nodes, max_depth, cpuct, uval, *rest = search
        K = rest[0] if rest else 1
        Bn, A = priors.shape
        rec = A + 1
        tree = torch.full((Bn, nodes, 4 * rec), float("nan"))
        rnd = torch.full((Bn, nodes, 2 * rec), float("nan"))
        counts, rootw = torch.empty(Bn, A), torch.empty(Bn, A)
        leaves = torch.empty(-(-Bn // 32) * 32 * K * lib.lib.az_fused_leaf_bytes(), dtype=torch.uint8)
        cfg = MCTSConfig(num_sims=num_sims, max_nodes=nodes, max_depth=max_depth, cpuct=cpuct,
                         parallel_sims=K)
        bp, pp, tp, cp, wp = (t.data_ptr() for t in (boards, priors, tree, counts, rootw))
        if mlp:
            args, _keep = kernels._stream_args(lib, weights, ops, Bn)
            if K == 1:
                rc = lib.lib.az_fused_mlp_stream(bp, pp, *args, tp, cp, wp, Bn, nodes, A, num_sims,
                                                 max_depth, cpuct, None)
                ref = fused_mlp_search(boards, priors, cfg, weights, ops)
            else:
                rc = lib.lib.az_fused_mlp_stream_rounds(
                    bp, pp, *args, tp, rnd.data_ptr(), leaves.data_ptr(), cp, wp, Bn, nodes, A, K,
                    num_sims, max_depth, cpuct, None)
                ref = fused_mlp_rounds_search(boards, priors, cfg, weights, ops)
        else:
            lines = kernels._gomoku_lines(ops, "cpu")
            if K == 1:
                rc = lib.lib.az_fused_gomoku(bp, pp, lines.data_ptr(), lines.numel(), tp, cp, wp, Bn,
                                             nodes, A, num_sims, max_depth, cpuct, uval, None)
                ref = fused_search(boards, priors, cfg, uval, ops)
            else:
                rc = lib.lib.az_fused_gomoku_rounds(
                    bp, pp, lines.data_ptr(), lines.numel(), tp, rnd.data_ptr(), leaves.data_ptr(),
                    cp, wp, Bn, nodes, A, K, num_sims, max_depth, cpuct, uval, None)
                ref = fused_rounds_search(boards, priors, cfg, uval, ops)
        assert rc == 0
        assert torch.equal(bits(counts), bits(ref[0])), f"counts at K={K}"
        if mlp:
            assert float((rootw - ref[1]).abs().max()) <= num_sims * EXP_ATOL, f"root W at K={K}"
        else:
            assert torch.equal(bits(rootw), bits(ref[1])), f"root W at K={K}"
        calls.append(K)
        return counts, rootw

    return run


def _conserved(game, state, counts, sims: int) -> None:
    live = ~game.terminal(state)[0]
    assert live.any()
    assert (counts.sum(1)[live] == sims).all() and (counts.sum(1)[~live] == 0).all()


UNIFORM_CASES = [("3x3", k) for k in (1, 2, 3, 4, 5)] + [("4x4", 1), ("4x4_win3", 1)] + [
    ("2x2", k) for k in (1, 2, 9, 10, 31, 62)]


@pytest.mark.parametrize("board,K", UNIFORM_CASES, ids=[f"{b}_K{k}" for b, k in UNIFORM_CASES])
def test_emulated_uniform_bit_equal_plain(emulated, board, K):
    """Uniform searches of 20 games (uval 0.3: W not an integer, so the
    order of the round's adds shows) through the ladder's fused engine and
    the emulated kernel, bit-equal to the plain search; the simulations are
    conserved and a finished root gets none."""
    game = Gomoku(*BOARDS[board])
    state = _roots(game, seed=K, moves=2 if game.num_actions > 4 else 1)
    cfg = MCTSConfig(num_sims=2 * K if K > 1 else 12, max_depth=16, parallel_sims=K)
    calls = []
    counts = make_fused_root_fn(game, make_uniform_model(game, 0.3).apply_fn, cfg,
                                kernel=_checked(emulated, calls, mlp=False))(state)
    assert calls == [K]
    _conserved(game, state, counts, cfg.num_sims)


@pytest.mark.parametrize("board", ["3x3", "4x4", "2x2"])
def test_emulated_uniform_cases(emulated, board):
    """The group layout's own cases on each group width (16, 32, 8 lanes):
    finished roots (the boards played on past their ends), a depth cutoff
    at 2, a tree of 3 slots that runs out, and Dirichlet roots; at 2x2
    every K the rule admits (1..62), each with one of the three."""
    game = Gomoku(*BOARDS[board])
    A = game.num_actions
    state = torch.cat([_roots(game, seed=7, moves=1)[: B // 2], _roots(game, seed=8, moves=A - 1)[B // 2:]])
    done = game.terminal(state)[0]
    assert done.any() and (~done).any()
    noise = sample_draws(torch.Generator().manual_seed(A), B, A, 0.5, "cpu").dirichlet
    cases = [(K, case) for K in range(1, 63) for case in [K % 3]] if board == "2x2" else [
        (1, case) for case in range(3)]
    for K, case in cases:
        for cfg in [(MCTSConfig(num_sims=2 * K, max_depth=2, parallel_sims=K),
                     MCTSConfig(num_sims=4 * K, max_depth=16, max_nodes=3, parallel_sims=K),
                     MCTSConfig(num_sims=2 * K, max_depth=16, dirichlet_alpha=0.5,
                                parallel_sims=K))[case]]:
            calls = []
            counts = make_fused_root_fn(game, make_uniform_model(game, 0.3).apply_fn, cfg,
                                        kernel=_checked(emulated, calls, mlp=False))(state, noise)
            assert calls == [K]
            live = ~game.terminal(state)[0]
            assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()


MLP_CASES = [("3x3", (32, 32), 1), ("3x3", (32, 32), 4), ("3x3", (), 5), ("4x4", (32, 32), 1),
             ("4x4", (512,), 1), ("4x4_win3", (32, 32), 1), ("2x2", (16,), 1), ("2x2", (16,), 12)]


@pytest.mark.parametrize("board,hidden,K", MLP_CASES,
                         ids=[f"{b}_{'x'.join(map(str, h)) or 'none'}_K{k}" for b, h, k in MLP_CASES])
def test_emulated_mlp_bit_equal_plain(emulated, board, hidden, K):
    """Order-free MLP searches (and the evaluator alone) through the
    emulated streamed kernels on the Gomoku game policy: logits and counts
    bit-equal to the plain versions, root W within num_sims x EXP_ATOL."""
    game = Gomoku(*BOARDS[board])
    ops, A = game.flat_ops(), game.num_actions
    apply_fn = make_apply_fn(convert_mlp(order_free_mlp_variables(A, hidden, cells=A, seed=K)))
    weights = apply_fn.kernel_eval_factory(ops)
    state = _roots(game, seed=K + 1, moves=2 if A > 4 else 1)
    boards = ops.from_state(state).contiguous()
    assert_order_free(boards, weights)
    # the evaluator alone
    logits, pm, value = torch.empty(B, A), torch.empty(B, A), torch.empty(B)
    args, _keep = kernels._stream_args(emulated, weights, ops, B)
    assert emulated.lib.az_mlp_eval_stream(boards.data_ptr(), *args, logits.data_ptr(),
                                           pm.data_ptr(), value.data_ptr(), B, A, None) == 0
    assert torch.equal(bits(logits), bits(mlp_forward(boards, weights)[0]))
    # the search through the ladder's fused engine
    cfg = MCTSConfig(num_sims=2 * K if K > 1 else 8, max_depth=16, parallel_sims=K)
    calls = []
    counts = make_fused_root_fn(game, apply_fn, cfg, kernel=_checked(emulated, calls, mlp=True))(state)
    assert calls == [K]
    _conserved(game, state, counts, cfg.num_sims)


def _dirichlet(key, batch: int, actions: int, alpha: float):
    """The root noise JAX's ``root_prior`` draws from ``key``."""
    return jax.random.dirichlet(key, jnp.full((actions,), alpha), (batch,))


JAX_CASES = [("3x3", 1), ("3x3", 4), ("4x4", 1), ("2x2", 12)]


@pytest.mark.parametrize("board,K", JAX_CASES, ids=[f"{b}_K{k}" for b, k in JAX_CASES])
def test_uniform_equals_jax_fused_kernel(emulated, board, K):
    """Uniform searches (Dirichlet 1.0, JAX's own draws) through the port's
    ladder with the emulated kernel: root counts exactly the JAX fused
    kernel's in the Pallas interpreter."""
    size, win = BOARDS[board]
    jg, tg = JaxGomoku(size, win), Gomoku(size, win)
    A = tg.num_actions
    jcfg = JaxMCTSConfig(num_sims=16 if K == 1 else 2 * K, max_depth=16, dirichlet_alpha=1.0,
                         parallel_sims=K)
    boards = random_play_boards(tg, 8, 2 if A > 4 else 1, seed=K)
    key = jax.random.key(K)
    ref = np.asarray(jax_fused_root_fn(jg, jax_uniform(jg).apply_fn, jcfg, block_size=4)(
        {}, gomoku_jax_state(boards), key))
    calls = []
    got = make_fused_root_fn(tg, make_uniform_model(tg).apply_fn, MCTSConfig(**dataclasses.asdict(jcfg)),
                             kernel=_checked(emulated, calls, mlp=False))(
        torch_state(boards), torch.as_tensor(np.array(_dirichlet(key, 8, A, 1.0))))
    assert calls == [K]
    np.testing.assert_array_equal(ref, got.numpy())


@pytest.mark.parametrize("board", ["3x3", "4x4"])
def test_mlp_close_to_jax_fused_kernel(emulated, board):
    """MLPNet (32, 32) with random weights, 16 sims, Dirichlet 1.0: the
    port's ladder with the emulated streamed kernel against the JAX fused
    kernel's in-kernel MLP, within the Mosaic-vs-XLA bound."""
    size, win = BOARDS[board]
    jg, tg = JaxGomoku(size, win), Gomoku(size, win)
    A = tg.num_actions
    jcfg = JaxMCTSConfig(num_sims=16, max_depth=16, dirichlet_alpha=1.0)
    variables = random_mlp_variables(A, (32, 32), cells=A, seed=size)
    boards = random_play_boards(tg, 16, 2, seed=size)
    key = jax.random.key(size)
    jax_apply = make_flax_apply_fn(JaxMLPNet(num_actions=A, hidden=(32, 32)))
    ref = np.asarray(jax_fused_root_fn(jg, jax_apply, jcfg, block_size=4)(
        variables, gomoku_jax_state(boards), key))
    calls = []
    cfg = MCTSConfig(**dataclasses.asdict(jcfg))
    got = make_fused_root_fn(tg, make_apply_fn(convert_mlp(variables)), cfg,
                             kernel=_checked(emulated, calls, mlp=True))(
        torch_state(boards), torch.as_tensor(np.array(_dirichlet(key, 16, A, 1.0)))).numpy()
    assert calls == [1]
    live = ref.sum(1) > 0
    assert live.any() and (got.sum(1) == ref.sum(1)).all()
    assert (ref == got).all(axis=1).mean() >= SAME_GAMES
    p_ref = ref[live] / ref[live].sum(1, keepdims=True)
    p_got = got[live] / got[live].sum(1, keepdims=True)
    assert np.abs(p_ref - p_got).max() <= MAX_DPI


def test_ladder_and_wrappers_route_gomoku():
    """The ladder picks the fused engine on every small board, with the
    uniform model and an MLPNet; the wrappers route Gomoku flat ops to the
    Gomoku and streamed instances (on CPU tensors their plain versions,
    launching nothing), check the boards' and priors' widths, refuse a
    Gomoku board past 16 cells and K past the reference's rule."""
    kernels.reset_launch_counts()
    for size, win in BOARDS.values():
        game = Gomoku(size, win)
        ops, A = game.flat_ops(), game.num_actions
        mlp = make_apply_fn(convert_mlp(random_mlp_variables(A, (8,), cells=A, seed=1)))
        cfg = MCTSConfig(num_sims=8)
        state = _roots(game, seed=size)
        for apply_fn in (make_uniform_model(game).apply_fn, mlp):
            root_counts = _make_root_counts_fn(game, apply_fn, cfg)
            assert root_counts.__qualname__.startswith("make_fused_root_fn.")
            _conserved(game, state, root_counts(state), 8)
        boards = ops.from_state(state)
        p = torch.full((B, A), 1.0 / A)
        got = kernels.fused(boards, p, 8, 9, 16, 1.0, 0.3, ops=ops)
        want = fused_search(boards, p, MCTSConfig(num_sims=8, max_depth=16), 0.3, ops)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        with pytest.raises(ValueError, match="expected shape"):
            kernels._fused_buffers("fused_gomoku", boards[:, :-1], p, 9, False, ops)
    assert all(v == 0 for v in kernels.launch_counts().values())
    g16 = Gomoku(4, 4).flat_ops()
    boards = torch.zeros(2, 16)
    with pytest.raises(ValueError, match=r"\(K\+1\)\^A < 2\^24"):
        kernels.fused_rounds(boards, torch.full((2, 16), 1 / 16), 4, 5, 16, 1.0, 0.0, 2, ops=g16)
    with pytest.raises(NotImplementedError, match="at most 16 cells"):
        kernels.fused(torch.zeros(2, 25), torch.full((2, 25), 0.04), 4, 5, 16, 1.0, 0.0,
                      ops=Gomoku(5).flat_ops())
