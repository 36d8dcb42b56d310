"""The port's hybrid engine (plain versions of the descend/merge/refresh
kernels on the CPU) gives root visit counts EQUAL to the JAX engines:
the XLA engine ``make_search_fn``, the JAX hybrid engine in interpret
mode, the frozen goldens and the C++ oracle. Conv models, whose bf16
forward differs in the last bits between frameworks, are held to a
bounded divergence instead."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu import native
from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
from alphazero_tpu.games import ConnectFour as JaxConnectFour
from alphazero_tpu.mcts.hybrid import make_hybrid_root_fn as jax_hybrid_root_fn
from alphazero_tpu.mcts.search import make_search_fn
from alphazero_tpu.models import AZResNet as JaxAZResNet
from alphazero_tpu.models import make_flax_apply_fn
from alphazero_tpu.models import make_uniform_model as jax_uniform
from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import (
    ConnectFour,
    FlatOps,
    GomokuFlatOps,
    HexFlatOps,
    Othello,
    OthelloFlatOps,
)
from alphazero_tpu_torch.mcts import PLAIN, make_fused_root_fn, make_hybrid_root_fn
from alphazero_tpu_torch.mcts import hybrid
from alphazero_tpu_torch.models import (
    convert_az_resnet,
    make_apply_fn,
    make_uniform_model,
    random_az_resnet_variables,
)
from tests.torch_parity import boards_from_seqs, jax_state, random_boards, torch_state

JG = JaxConnectFour()
TG = ConnectFour()


def _torch_counts(apply_fn, cfg, boards, noise=None):
    root_counts = make_hybrid_root_fn(TG, apply_fn, MCTSConfig(**dataclasses.asdict(cfg)))
    return root_counts(torch_state(boards), noise).numpy()


def _dyadic_models(seed=0):
    """A linear model with dyadic weights: logits and value are exact in
    both frameworks (0/1 features, sums of multiples of 1/64)."""
    rng = np.random.default_rng(seed)
    wp = (rng.integers(-4, 5, (84, 7)) / 8).astype(np.float32)
    bp = (rng.integers(-4, 5, 7) / 8).astype(np.float32)
    wv = (rng.integers(-2, 3, 84) / 64).astype(np.float32)

    def jax_apply(params, feats):
        x = feats.reshape(feats.shape[0], -1)
        return x @ wp + bp, jnp.clip(x @ wv + 1 / 16, -1.0, 1.0)

    twp, tbp, twv = map(torch.as_tensor, (wp, bp, wv))

    def torch_apply(feats):
        x = feats.reshape(feats.shape[0], -1)
        return x @ twp + tbp, torch.clamp(x @ twv + 1 / 16, -1.0, 1.0)

    torch_apply.needs_features = True
    return jax_apply, torch_apply


def _check_vs_xla(jax_apply, torch_apply, cfg, boards, rng=None):
    ref = np.asarray(make_search_fn(JG, jax_apply, cfg)({}, jax_state(boards), rng=rng).root_counts())
    noise = None
    if rng is not None:
        noise = torch.as_tensor(np.array(jax.random.dirichlet(rng, jnp.full((7,), cfg.dirichlet_alpha), (len(boards),))))
    got = _torch_counts(torch_apply, cfg, boards, noise)
    np.testing.assert_array_equal(ref, got)
    return got


@pytest.mark.parametrize("moves", [0, 6, 14])
def test_uniform_matches_xla_engine(moves):
    cfg = JaxMCTSConfig(num_sims=20, max_depth=48)
    got = _check_vs_xla(jax_uniform(JG).apply_fn, make_uniform_model(TG).apply_fn, cfg,
                        random_boards(8, moves, seed=moves))
    assert got.sum() > 0


@pytest.mark.parametrize(
    "cfg",
    [
        JaxMCTSConfig(num_sims=20, max_depth=48, max_nodes=8),           # slots run out
        JaxMCTSConfig(num_sims=16, max_depth=3),                         # depth cutoffs
        JaxMCTSConfig(num_sims=16, max_depth=48, cpuct=2.5),
    ],
    ids=["max_nodes8", "max_depth3", "cpuct2.5"],
)
def test_uniform_edge_configs_match_xla_engine(cfg):
    _check_vs_xla(jax_uniform(JG).apply_fn, make_uniform_model(TG).apply_fn, cfg,
                  random_boards(8, 7, seed=3))


def test_injected_dirichlet_matches_xla_engine():
    cfg = JaxMCTSConfig(num_sims=16, max_depth=48, dirichlet_alpha=0.7, dirichlet_frac=0.25)
    _check_vs_xla(jax_uniform(JG).apply_fn, make_uniform_model(TG).apply_fn, cfg,
                  random_boards(8, 2, seed=5), rng=jax.random.key(11))


def test_dyadic_model_matches_xla_engine():
    jax_apply, torch_apply = _dyadic_models()
    boards = random_boards(8, 4, seed=6)
    feats = np.stack([(boards == 1), (boards == -1)], -1).astype(np.float32)
    jl, jv = jax_apply({}, jnp.asarray(feats))
    tl, tv = torch_apply(torch.as_tensor(feats))
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())     # exact outputs
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    cfg = JaxMCTSConfig(num_sims=24, max_depth=48)
    got = _check_vs_xla(jax_apply, torch_apply, cfg, boards)
    assert (got.max(1) > got.min(1) + 2).any()                    # a non-uniform search


def test_matches_jax_hybrid_engine_in_interpret_mode():
    """Against the JAX hybrid engine itself (Pallas interpreter on CPU)."""
    jax_apply, torch_apply = _dyadic_models(seed=1)
    cfg = JaxMCTSConfig(num_sims=12, max_depth=48)
    boards = random_boards(8, 6, seed=7)
    jax_fn = jax_hybrid_root_fn(JG, jax_apply, cfg, block_size=4)
    np.testing.assert_array_equal(np.asarray(jax_fn({}, jax_state(boards))),
                                  _torch_counts(torch_apply, cfg, boards))


def test_frozen_goldens():
    with open(os.path.join(os.path.dirname(__file__), "golden_counts.json")) as f:
        spec = json.load(f)["connect_four"]
    cfg = JaxMCTSConfig(num_sims=50, max_depth=64)
    got = _torch_counts(make_uniform_model(TG).apply_fn, cfg, boards_from_seqs(spec["seqs"]))
    np.testing.assert_array_equal(got.astype(int), np.asarray(spec["counts"]))


@pytest.mark.parametrize("sims", [10, 100])
def test_matches_cpp_oracle(sims):
    seqs = [[], [3], [0, 1, 0, 1, 0, 1], [0, 1, 0, 1, 0], [3, 3, 2, 4, 1, 5],
            [2, 2, 2, 2, 2, 2, 0, 1]]
    boards = boards_from_seqs(seqs)
    got = _torch_counts(make_uniform_model(TG).apply_fn, JaxMCTSConfig(num_sims=sims, max_depth=48), boards)
    for i, b in enumerate(boards):
        oracle = native.oracle_search(b, (b != 0).sum(axis=0), sims, 1.0, 48)
        if oracle is None:
            pytest.skip("no C++ toolchain for the oracle")
        np.testing.assert_array_equal(got[i], oracle, err_msg=f"position {seqs[i]}")


def test_tiny_resnet_bounded_divergence():
    """bf16 AZResNet-8x1 on the same weights: the forward differs in the
    last bits between frameworks, so a near-tie can flip; sims are
    conserved, most games are identical and visit distributions stay
    close (the bound tests/test_fused.py uses for Mosaic vs XLA)."""
    variables = random_az_resnet_variables(7, 8, 1, seed=2)
    jax_apply = make_flax_apply_fn(JaxAZResNet(num_actions=7, channels=8, blocks=1))
    torch_apply = make_apply_fn(convert_az_resnet(variables, dtype=torch.bfloat16))
    cfg = JaxMCTSConfig(num_sims=24, max_depth=48)
    boards = random_boards(16, 5, seed=2)
    c_jax = np.asarray(make_search_fn(JG, jax_apply, cfg)(variables, jax_state(boards)).root_counts())
    c_port = _torch_counts(torch_apply, cfg, boards)
    assert (c_port.sum(1) == c_jax.sum(1)).all()
    assert (c_jax == c_port).all(axis=1).mean() >= 0.75
    p_j = c_jax / np.maximum(c_jax.sum(1, keepdims=True), 1)
    p_p = c_port / np.maximum(c_port.sum(1, keepdims=True), 1)
    assert np.abs(p_j - p_p).max() <= 0.25


def test_unported_paths_raise():
    uni = make_uniform_model(TG).apply_fn
    # K>1 rounds run on both engines (the fused engine's: K2)
    assert callable(make_hybrid_root_fn(TG, uni, MCTSConfig(num_sims=8, parallel_sims=2)))
    assert callable(make_fused_root_fn(TG, uni, MCTSConfig(num_sims=8, parallel_sims=2)))
    with pytest.raises(ValueError, match="divisible"):
        make_hybrid_root_fn(TG, uni, MCTSConfig(num_sims=10, parallel_sims=4))

    class NoFlatOps:
        name = "no_flat_ops"
        num_actions = 3

    # declined, as the JAX engine declines it: the ladder's dense engine takes it
    assert make_hybrid_root_fn(NoFlatOps(), uni, MCTSConfig(num_sims=8)) is None

    class HeuristicFreeOps:
        """Flat ops that cannot evaluate a depth-cutoff heuristic."""

        size, num_actions = 64, 65

    class NonzeroHeuristicGame(Othello):
        name = "nonzero_heuristic_without_flat_heuristic"

        def flat_ops(self):
            return HeuristicFreeOps()

    assert make_hybrid_root_fn(NonzeroHeuristicGame(), uni, MCTSConfig(num_sims=8)) is None
    # the same game with its own flat ops, which have the heuristic, is taken
    assert callable(make_hybrid_root_fn(Othello(), uni, MCTSConfig(num_sims=8)))


def test_terminal_root_is_not_descended():
    B, A, C = 3, 7, 5
    done = torch.zeros(B, C)
    done[1, 0] = 1.0
    besta = torch.zeros(B, C)
    bestc = torch.full((B, C), -1.0)
    boards = torch.zeros(B, 42)
    bd, patha, psgn, meta = hybrid.descend(besta, bestc, done, torch.zeros(B, C), boards, 48, FlatOps())
    assert torch.equal(meta[1], torch.tensor([0, 0, 1, 0, 0, 0, 0, 0.0]))
    assert torch.equal(patha[1], torch.zeros(C)) and torch.equal(bd[1], boards[1])
    # the live roots expand action 0 at the root: one edge, sign +1
    assert torch.equal(patha[0], torch.tensor([1.0, 0, 0, 0, 0]))
    assert meta[0, hybrid.M_EXP] == 1 and meta[0, hybrid.M_PSIGN] == -1


NO_LAUNCHES = {"descend": 0, "descend_othello": 0, "descend_gomoku": 0, "descend_hex": 0,
               "merge": 0, "merge_dense": 0, "refresh": 0, "refresh_dense": 0,
               "fused": 0, "fused_mlp": 0, "mlp_eval": 0, "descend_round": 0,
               "descend_round_othello": 0, "descend_round_gomoku": 0, "descend_round_hex": 0, "merge_round": 0, "merge_round_dense": 0, "refresh2": 0,
               "refresh2_dense": 0, "fused_rounds": 0, "fused_mlp_rounds": 0, "int8_tower": 0,
               "fused_gomoku": 0, "fused_rounds_gomoku": 0, "fused_mlp_stream": 0,
               "fused_mlp_stream_rounds": 0, "mlp_eval_stream": 0}


def test_wrappers_route_cpu_to_plain_and_refuse_other_devices():
    B, A, C = 2, 7, 4
    n, w, p = torch.zeros(B, A, C), torch.zeros(B, A, C), torch.rand(B, A, C)
    code = torch.full((B, A, C), -1.0)
    kernels.reset_launch_counts()
    for got, want in zip(kernels.refresh(n, w, p, code, 1.0), PLAIN.refresh(n, w, p, code, 1.0)):
        assert torch.equal(got, want)
    assert kernels.launch_counts() == NO_LAUNCHES
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.refresh(*(t.to("meta") for t in (n, w, p, code)), 1.0)
    with pytest.raises(ValueError, match="several devices"):
        kernels.refresh(n, w, p, code.to("meta"), 1.0)
    assert kernels.launch_counts() == NO_LAUNCHES


@pytest.mark.parametrize(
    "ops,entry",
    [
        (FlatOps(), "az_descend"),
        (OthelloFlatOps(), "az_descend_othello"),
        (GomokuFlatOps(7), "az_descend_gomoku"),      # 49 cells, as Hex
        (GomokuFlatOps(8), "az_descend_gomoku"),      # 64 cells, as Othello
        (GomokuFlatOps(9), "az_descend_gomoku"),
        (GomokuFlatOps(15), "az_descend_gomoku"),
        (GomokuFlatOps(16), "az_descend_gomoku"),     # 256 cells: 4 words a side
        (GomokuFlatOps(17), "az_descend_gomoku"),     # 289 cells: 5 words
        (GomokuFlatOps(19), "az_descend_gomoku"),
        (GomokuFlatOps(22), "az_descend_gomoku"),     # 484 cells: the 8 words' last edge
        (HexFlatOps(), "az_descend_hex"),
    ],
    ids=["connect_four", "othello", "gomoku7", "gomoku8", "gomoku9", "gomoku15", "gomoku16",
         "gomoku17", "gomoku19", "gomoku22", "hex"],
)
def test_descend_routes_by_the_flat_ops_type(ops, entry):
    """The CUDA descend is picked by the type of the game's flat ops, not by
    the board width: a 49-cell Gomoku board never reaches the Hex kernel,
    a 64-cell one never the Othello kernel; every Gomoku edge up to 22
    takes the one Gomoku instance; every other kernel instance refuses the
    board before it launches."""
    assert kernels.descend_entry(ops) == entry
    B, C = 2, 3
    planes = [torch.zeros(B, C) for _ in range(4)]
    boards = torch.zeros(B, ops.size)
    for other in set(kernels._DESCEND_ROUND_ENTRIES) - {entry}:
        with pytest.raises(ValueError, match="does not step"):
            kernels._descend(other, *planes, boards, 8, ops)


def test_descend_route_refuses_unknown_flat_ops():
    class SubclassedFlatOps(FlatOps):
        """Flat ops whose step may differ from the kernel's."""

    class OtherOps:
        size, num_actions = 42, 7

    for ops in (SubclassedFlatOps(), OtherOps()):
        with pytest.raises(NotImplementedError, match="no descend kernel"):
            kernels.descend_entry(ops)
    # Gomoku boards of every edge route to the Gomoku entry (above 768 cells,
    # once refused, its leaf-row instance); the other
    # games' instances refuse them before they launch
    for edge in (27, 28, 45, 64, 65):
        assert kernels.descend_entry(GomokuFlatOps(edge)) == "az_descend_gomoku"
    with pytest.raises(ValueError, match="does not step"):
        kernels._descend("az_descend_othello", *[torch.zeros(2, 3)] * 4, torch.zeros(2, 784), 8,
                         GomokuFlatOps(28))


def test_zero_heuristic_game_backs_up_zero_at_cutoffs():
    """A zero-heuristic game whose flat ops carry a ``heuristic`` attribute
    backs up 0 at depth cutoffs, as the JAX engine gates it on
    ``heuristic_is_zero``: counts equal the XLA engine's, while the same
    search backing the heuristic up would differ."""

    class FlatOpsWithHeuristic(FlatOps):
        def heuristic(self, board):
            weights = (torch.arange(42.0) * 7 % 11 - 5) / 8     # leaves differ by their stones
            return (board @ weights)[:, None].clamp(-1.0, 1.0)

    class ConnectFourWithFlatHeuristic(ConnectFour):
        def flat_ops(self):
            return FlatOpsWithHeuristic()

    game = ConnectFourWithFlatHeuristic()
    cfg = JaxMCTSConfig(num_sims=24, max_depth=1)        # every visit past the root's children is cut
    boards = random_boards(8, 6, seed=12)
    ref = np.asarray(make_search_fn(JG, jax_uniform(JG).apply_fn, cfg)({}, jax_state(boards)).root_counts())
    uniform = make_uniform_model(TG).apply_fn
    got = make_hybrid_root_fn(game, uniform, MCTSConfig(**dataclasses.asdict(cfg)))(torch_state(boards))
    np.testing.assert_array_equal(ref, got.numpy())

    ops = game.flat_ops()
    flat = ops.from_state(torch_state(boards))
    valid = TG.valid_moves(torch_state(boards))
    p_masked = torch.where(valid, valid.float() / valid.sum(1, keepdim=True), -1e30)

    def evaluate(bd, vm):
        return torch.where(vm, vm.float() / vm.sum(1, keepdim=True).clamp(min=1), -1e30), torch.zeros(len(bd))

    n, _ = hybrid.run_search(ops, flat, p_masked, MCTSConfig(**dataclasses.asdict(cfg)), evaluate, PLAIN,
                             heuristic=ops.heuristic)
    assert not np.array_equal(ref, n[:, :, 0].numpy())
