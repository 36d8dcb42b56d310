"""The streamed in-kernel MLP evaluator (csrc/mlp.cuh's streamed plan) and
the fused MLP kernels on it (``az_fused_mlp_stream``,
``az_fused_mlp_stream_rounds``, ``az_mlp_eval_stream``), compiled with g++
against the CPU stand-in for the CUDA built-ins (tests/cuda_emu/; the
``emulated`` fixture of tests/torch_parity.py) and run on host memory, for
the MLPs the resident/staged plan does not take: (512,), (512, 512), (300,)
(a width that is not a multiple of 16 or 8), (300, 20) (the padding
between two such layers), (64,) * 6 (deeper than 4),
(2048,) (the activations past shared memory, in the device scratch) and ()
(the head on the input itself), at K=1 and in K=4 rounds; and, for (),
the evaluator against the model itself (its ``apply_fn`` on
``game.to_features`` and flax ``MLPNet(hidden=())``) on Connect-Four and
Gomoku boards, since with no hidden layer the head is the matrix whose rows
``pack_mlp_weights`` must permute.

Tolerances. With order-free weights (``models.order_free_mlp_variables``;
``assert_order_free`` checks in every case that the plain f32 forward
equals its float64 evaluation, so that the tensor cores' order of the adds
gives the same bits, which holds at width 2048 and at depth 6 too) the
logits and the searches' counts are bit-equal to the plain versions
(``mlp_forward``, ``fused_mlp_search``, ``fused_mlp_rounds_search``), the
prior and the value within 1e-6 (glibc's expf and tanhf against torch's)
and root W within num_sims x 1e-6. With random He-scaled weights the
evaluator is within 4e-3 (logits, value) and 2e-3 (prior), the resident
plan's bound (tests/test_torch_kernels.py).

This checks the kernels' LOGIC on the CPU; whether the source builds with
nvcc and runs on the card is chip_smoke.py's job.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.models import MLPNet as JaxMLPNet

from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour, Gomoku
from alphazero_tpu_torch.games.connect_four import FlatOps
from alphazero_tpu_torch.mcts import fused_mlp_rounds_search, fused_mlp_search, make_fused_root_fn
from alphazero_tpu_torch.mcts.fused import mlp_forward, mlp_prior
from alphazero_tpu_torch.models import (
    convert_mlp,
    make_apply_fn,
    order_free_mlp_variables,
    random_mlp_variables,
)
from tests.torch_parity import (  # noqa: F401  (emulated: a fixture)
    assert_order_free,
    bits,
    emulated,
    random_boards,
    random_play_boards,
    torch_state,
)

TG = ConnectFour()
FLAT = FlatOps()
# (300, 20): padding columns of one layer (300 -> 304) feed the next, whose
# weight rows past 300 must be staged as zeros; 20 units are 2-byte copies
HIDDEN = [(512,), (512, 512), (300,), (300, 20), (64,) * 6, (2048,), ()]
HIDDEN_IDS = ["512", "512x512", "300", "300x20", "64x6", "2048", "no_hidden"]
EXP_ATOL = 1e-6       # prior and value with bit-equal logits: glibc's expf/tanhf against torch's
LOGIT_ATOL = 4e-3     # random weights: logits and value (the evaluator's bound)
PRIOR_ATOL = 2e-3     # ... and the masked prior
MODEL_ATOL = 1e-5     # no hidden layer, random weights: one f32 sum of 2 L terms in another order
B = 40                # a full block of 32 games and a ragged one


def _apply(hidden, kind: str, seed: int):
    make = order_free_mlp_variables if kind == "order_free" else random_mlp_variables
    return make_apply_fn(convert_mlp(make(7, hidden, seed=seed)))


def test_emulated_streamed_plan(emulated):
    """The streamed plan of each MLP: the activations in shared memory
    beside the ring (33,792 bytes) and the head outputs (1,024) while their
    two buffers fit, as at (512, 512); at 2048 units in a device scratch of
    2 x 32 x (2048 + 8) bf16 a block."""
    ring, out = 2 * 32 * 264 * 2, 32 * 8 * 4
    for hidden in HIDDEN:
        plan = kernels.mlp_plan(hidden, emulated)
        widest = max((-(-h // 16) * 16 for h in (84, *hidden)))
        act = 2 * 32 * (widest + 8) * 2
        assert plan.kind == "streamed", (hidden, plan)
        if hidden == (2048,):
            assert plan == ("streamed", out + ring, act)
        else:
            assert plan == ("streamed", out + ring + act, 0)
            assert plan.smem_bytes <= 232_448
    # Gomoku(4, 4)'s boards: 32 inputs, a head of 17
    assert kernels.mlp_plan((32, 32), emulated, cells=16, actions=16) == (
        "streamed", 32 * 17 * 4 + ring + 2 * 32 * 40 * 2, 0)


@pytest.mark.parametrize("kind", ["order_free", "random"])
@pytest.mark.parametrize("hidden", HIDDEN, ids=HIDDEN_IDS)
def test_emulated_streamed_evaluator(emulated, hidden, kind):
    """``az_mlp_eval_stream`` on 40 boards against ``mlp_forward`` and
    ``mlp_prior``: order-free logits bit-equal, prior and value within
    EXP_ATOL; random ones within LOGIT_ATOL and PRIOR_ATOL."""
    weights = _apply(hidden, kind, seed=len(hidden)).kernel_eval_factory(FLAT)
    boards = FLAT.from_state(torch_state(random_boards(B, 20, seed=3, freeze_done=False)))
    if kind == "order_free":
        assert_order_free(boards, weights)
    logits, pm, value = torch.empty(B, 7), torch.empty(B, 7), torch.empty(B)
    args, _keep = kernels._stream_args(emulated, weights, None, B)
    rc = emulated.lib.az_mlp_eval_stream(
        boards.data_ptr(), *args, logits.data_ptr(), pm.data_ptr(), value.data_ptr(), B, 7, None)
    assert rc == 0
    ref_logits, ref_value = mlp_forward(boards, weights)
    vm = FLAT.valid(boards)
    assert (~vm).any() and torch.equal(pm[~vm], torch.full_like(pm[~vm], -1e30))
    if kind == "order_free":
        assert torch.equal(bits(logits), bits(ref_logits)), "logits"
        torch.testing.assert_close(pm, mlp_prior(ref_logits, vm), atol=EXP_ATOL, rtol=0)
        torch.testing.assert_close(value, ref_value, atol=EXP_ATOL, rtol=0)
    else:
        torch.testing.assert_close(logits, ref_logits, atol=LOGIT_ATOL, rtol=0)
        torch.testing.assert_close(pm, mlp_prior(ref_logits, vm), atol=PRIOR_ATOL, rtol=0)
        torch.testing.assert_close(value, ref_value, atol=LOGIT_ATOL, rtol=0)


def _checked_stream(lib, calls):
    """A ``kernels.fused_mlp`` / ``fused_mlp_rounds`` stand-in running the
    emulated streamed kernel (``az_fused_mlp_stream`` at K=1, else
    ``az_fused_mlp_stream_rounds``) on scratch filled with NaN AND its plain
    version on every call: counts bit-equal, root W within num_sims x
    EXP_ATOL (each backed-up value may differ in its last bits)."""

    def fused_mlp(boards, priors, weights, num_sims, nodes, max_depth, cpuct, K=1, ops=None):
        assert ops is None or type(ops) is FlatOps
        Bn = boards.shape[0]
        tree = torch.full((Bn, nodes, 32), float("nan"))
        counts, rootw = torch.empty(Bn, 7), torch.empty(Bn, 7)
        args, _keep = kernels._stream_args(lib, weights, ops, Bn)
        cfg = MCTSConfig(num_sims=num_sims, max_nodes=nodes, max_depth=max_depth, cpuct=cpuct,
                         parallel_sims=K)
        if K == 1:
            rc = lib.lib.az_fused_mlp_stream(
                boards.data_ptr(), priors.data_ptr(), *args,
                *(t.data_ptr() for t in (tree, counts, rootw)),
                Bn, nodes, 7, num_sims, max_depth, cpuct, None)
            ref_counts, ref_w = fused_mlp_search(boards, priors, cfg, weights)
        else:
            rnd = torch.full((Bn, nodes, 16), float("nan"))
            rc = lib.lib.az_fused_mlp_stream_rounds(
                boards.data_ptr(), priors.data_ptr(), *args, tree.data_ptr(), rnd.data_ptr(), None,
                counts.data_ptr(), rootw.data_ptr(), Bn, nodes, 7, K, num_sims, max_depth, cpuct,
                None)
            ref_counts, ref_w = fused_mlp_rounds_search(boards, priors, cfg, weights)
        assert rc == 0
        assert torch.equal(bits(counts), bits(ref_counts)), "counts"
        assert float((rootw - ref_w).abs().max()) <= num_sims * EXP_ATOL, "root W"
        calls.append(K)
        return counts, rootw

    return fused_mlp


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("hidden", HIDDEN, ids=HIDDEN_IDS)
def test_emulated_streamed_search_bit_equal_plain(emulated, hidden, K):
    """Whole order-free MLP searches of 40 games (8 simulations; 2 rounds
    of 4) through the ladder's fused engine, which takes every width and
    depth, and the emulated streamed kernel: counts bit-equal to the plain
    search's, the simulations conserved."""
    apply_fn = _apply(hidden, "order_free", seed=K)
    state = torch_state(random_boards(B, 10, seed=len(hidden) + K))
    assert_order_free(FLAT.from_state(state), apply_fn.kernel_eval_factory(FLAT))
    cfg = MCTSConfig(num_sims=8, max_depth=48, parallel_sims=K)
    calls = []
    counts = make_fused_root_fn(TG, apply_fn, cfg, kernel=_checked_stream(emulated, calls))(state)
    assert calls == [K]
    live = ~TG.terminal(state)[0]
    assert live.any()
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()


NO_HIDDEN_GAMES = {"c4": ConnectFour(), "gomoku3x3": Gomoku(3, 3), "gomoku4x4": Gomoku(4, 4)}


@pytest.mark.parametrize("kind", ["order_free", "random"])
@pytest.mark.parametrize("game", list(NO_HIDDEN_GAMES.values()), ids=list(NO_HIDDEN_GAMES))
def test_emulated_no_hidden_evaluator_is_the_model(emulated, game, kind):
    """MLPNet(hidden=()): ``mlp_forward`` and the emulated
    ``az_mlp_eval_stream`` on the kernel's weights against the model's own
    forward (``apply_fn`` on the NHWC features) and flax
    ``MLPNet(hidden=())`` on the same variables. Order-free weights: logits
    bit-equal to both, value within EXP_ATOL; random ones: within
    MODEL_ATOL."""
    ops, A = game.flat_ops(), game.num_actions
    make = order_free_mlp_variables if kind == "order_free" else random_mlp_variables
    variables = make(A, (), cells=ops.size, seed=A)
    apply_fn = make_apply_fn(convert_mlp(variables))
    weights = apply_fn.kernel_eval_factory(ops)
    state = torch_state(random_play_boards(game, B, min(A - 2, 12), seed=A, freeze_done=False))
    boards = ops.from_state(state).contiguous()
    feats = game.to_features(state)
    logits, pm, value = torch.empty(B, A), torch.empty(B, A), torch.empty(B)
    args, _keep = kernels._stream_args(emulated, weights, ops, B)
    assert emulated.lib.az_mlp_eval_stream(boards.data_ptr(), *args, logits.data_ptr(),
                                           pm.data_ptr(), value.data_ptr(), B, A, None) == 0
    model_logits, model_value = apply_fn(feats)
    jl, jv = JaxMLPNet(num_actions=A, hidden=()).apply(variables, jnp.asarray(feats.numpy()))
    for ref_logits, ref_value in [(model_logits, model_value),
                                  (torch.as_tensor(np.array(jl)), torch.as_tensor(np.array(jv)))]:
        for got_logits, got_value in [mlp_forward(boards, weights), (logits, value)]:
            if kind == "order_free":
                assert torch.equal(bits(got_logits), bits(ref_logits)), "logits"
                torch.testing.assert_close(got_value, ref_value, atol=EXP_ATOL, rtol=0)
            else:
                torch.testing.assert_close(got_logits, ref_logits, atol=MODEL_ATOL, rtol=0)
                torch.testing.assert_close(got_value, ref_value, atol=MODEL_ATOL, rtol=0)
    assert len(set(logits.ravel().tolist())) > 20   # the logits are not degenerate
