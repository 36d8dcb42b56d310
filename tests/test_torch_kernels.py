"""The CUDA sources of the kernels (alphazero_tpu_torch/csrc/hybrid.cu,
fused.cu and int8_tower.cu, with c4.cuh, othello.cuh and mlp.cuh), compiled with g++ against
a CPU stand-in for the CUDA built-ins (tests/cuda_emu/cuda_runtime.h,
cuda_bf16.h) and run on host memory: every descend, merge and refresh call
of whole Connect-Four hybrid searches (through the A<=8 kernels) must be
bit-equal to the plain PyTorch versions, and the searches must reproduce
the goldens; so must every call of the K>1 round kernels in whole searches
of all four games (the Othello, Gomoku and Hex K=1 searches are
tests/test_torch_games_emu.py's, the uniform fused kernels' whole
searches tests/test_torch_fused_emu.py's, the descends on synthetic trees
tests/test_torch_descend_emu.py's, all on the same emulated library:
tests/torch_parity.py ``emulated``). The
dense merges work on the columns a merge writes, one warp per
game, with shuffle reductions: they are also held bit for bit against the
plain full refresh on synthetic records (slots past the capacity,
terminal-child links, root-only paths, cross-lane ties and illegal edges,
a parent off the path, a round's duplicate). The MLP evaluator runs its hidden layers on
the emulator's bf16 mma.sync, which adds in another order than the plain
version's k loop: with order-free (dyadic) weights its logits must be
bit-equal to the plain version's, and its searches identical on every game;
with random weights its logits stay within a stated tolerance and its
searches identical on >= 95% of games. Prior and value may also differ
where glibc's expf/tanhf and torch's CPU exp/tanh differ in the last bit.
The emulated bf16 instruction itself is held against a float64 product of
random fragments. The fused int8 tower's emulated cases are
tests/test_torch_tower_emu.py's.

This checks the kernels' LOGIC (indexing, record format, install/link/
backup, PUCT order of operations, first-max ties across a warp's lanes,
the Connect-Four win test, the Othello flips, the Gomoku overwrite, the
Hex transpose) on the CPU. Whether the sources build with nvcc and run on the card
is chip_smoke.py's job.
"""

import ctypes
import json
import os

import numpy as np
import pytest
import torch

from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games import ConnectFour, Gomoku, Hex, Othello
from alphazero_tpu_torch.games.connect_four import FlatOps
from alphazero_tpu_torch.mcts import (
    PLAIN,
    SearchKernels,
    fused_mlp_rounds_search,
    fused_mlp_search,
    hybrid,
    make_fused_root_fn,
    make_hybrid_root_fn,
)
from alphazero_tpu_torch.mcts.fused import mlp_forward, mlp_prior
from alphazero_tpu_torch.models import (
    convert_az_resnet,
    convert_mlp,
    make_apply_fn,
    make_uniform_model,
    random_az_resnet_variables,
    random_mlp_variables,
)
from alphazero_tpu_torch.ops import sample_draws
from tests.torch_parity import (  # noqa: F401  (emulated: a fixture)
    MERGE_CASES,
    assert_order_free,
    bits,
    boards_from_seqs,
    checked_kernels,
    descend_round_through_kernel,
    emulated,
    emulated_refresh,
    emulated_refresh2,
    fresh_planes,
    merge_case,
    order_free_mlp_apply,
    random_boards,
    random_play_boards,
    seed_priors,
    torch_state,
)

HERE = os.path.dirname(os.path.abspath(__file__))
TG = ConnectFour()


def test_emulated_kernels_reproduce_goldens(emulated):
    with open(os.path.join(HERE, "golden_counts.json")) as f:
        spec = json.load(f)["connect_four"]
    calls = {}
    root_counts = make_hybrid_root_fn(
        TG, make_uniform_model(TG).apply_fn, MCTSConfig(num_sims=50, max_depth=64),
        kernels=checked_kernels(emulated, calls),
    )
    counts = root_counts(torch_state(boards_from_seqs(spec["seqs"])))
    np.testing.assert_array_equal(counts.numpy().astype(int), np.asarray(spec["counts"]))
    assert calls == {"az_descend": 50, "az_merge": 50, "az_refresh": 1}


@pytest.mark.parametrize(
    "cfg,moves",
    [
        (MCTSConfig(num_sims=24, max_depth=48), 12),
        (MCTSConfig(num_sims=16, max_depth=3, cpuct=2.5), 6),          # depth cutoffs
        (MCTSConfig(num_sims=20, max_depth=48, max_nodes=8), 28),       # slots run out
    ],
    ids=["late_positions", "max_depth3", "max_nodes8"],
)
def test_emulated_kernels_bit_equal_plain_uniform(emulated, cfg, moves):
    calls = {}
    boards = torch_state(random_boards(40, moves, seed=moves))
    counts = make_hybrid_root_fn(
        TG, make_uniform_model(TG).apply_fn, cfg, kernels=checked_kernels(emulated, calls)
    )(boards)
    assert calls["az_merge"] == cfg.num_sims
    live = ~TG.terminal(boards)[0]
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()


def test_emulated_kernels_bit_equal_plain_resnet_dirichlet(emulated):
    """A non-uniform prior and value (f32 AZResNet-8x1) with root noise:
    terminal children, W backups of both signs."""
    cfg = MCTSConfig(num_sims=20, max_depth=48, dirichlet_alpha=1.0)
    apply_fn = make_apply_fn(convert_az_resnet(random_az_resnet_variables(7, 8, 1, seed=3), dtype=torch.float32))
    noise = sample_draws(torch.Generator().manual_seed(0), 32, 7, 1.0, "cpu").dirichlet
    calls = {}
    make_hybrid_root_fn(TG, apply_fn, cfg, kernels=checked_kernels(emulated, calls))(
        torch_state(random_boards(32, 16, seed=9)), noise
    )
    assert calls == {"az_descend": 20, "az_merge": 20, "az_refresh": 1}


# a game of each A of the seed tests: Connect-Four (the A <= 8 seed), Hex,
# Othello, Gomoku 9 and 15
SEED_GAMES = {7: ConnectFour(), 49: Hex(), 65: Othello(), 81: Gomoku(9), 225: Gomoku(15),
              529: Gomoku(23), 729: Gomoku(27)}


def _seed_entry(name: str, A: int) -> str:
    return f"az_{name}_dense" if A > hybrid.UNROLLED_MAX_A else f"az_{name}"


@pytest.mark.parametrize("A", [7, 49, 65, 81, 225, 529, 729])
def test_emulated_dense_refresh_ties_and_illegal_nodes(emulated, A):
    """The refresh, a fresh search's seed, at Connect-Four's A (the A <= 8
    seed) and the dense A of Hex (and Gomoku 7), Othello, Gomoku 9,
    Gomoku 15 and Gomoku 23 and 27 (24 actions a lane), on fresh planes (``_init_planes``) whose roots carry the
    scenarios (``seed_priors``): exact ties (uniform priors), illegal
    edges, an all-illegal root and a root whose one legal edge is the last:
    bit-equal to the plain version, whose first-max picks action 0 at the
    all-illegal root and the first legal edge among the ties; every other
    node is the empty node."""
    B, C = 5, 37
    p_masked = seed_priors(A, B, seed=A)
    n, w, p, code = fresh_planes(SEED_GAMES[A], p_masked, C)
    (best_a, best_c), entry = emulated_refresh(emulated, n, w, p, code, 1.0)
    assert entry == _seed_entry("refresh", A)
    assert best_a[0, 0] == 1 and best_a[1, 0] == 0 and best_a[2, 0] == A - 1
    assert (best_a[:, 1:] == 0).all() and (best_c == -1).all()
    legal = p_masked[0] > -5e29
    assert legal.sum() > 1 and (p_masked[0, legal] == p_masked[0, 1]).all()   # exact ties


@pytest.mark.parametrize("A", [16, 65, 225, 361, 729])
@pytest.mark.parametrize("case", MERGE_CASES[:-1])
def test_emulated_merge_dense_cases(emulated, case, A):
    """``az_merge_dense`` on synthetic planes and records of each case
    (``merge_case``): planes, done/tval and best planes bit-equal to the
    plain merge's full refresh."""
    args = merge_case(A, 1, case, seed=A)
    calls = {}
    merge = checked_kernels(emulated, calls).merge
    n, patha, meta2 = args[0], args[7], args[9]
    before = n.clone()
    merge(*args)
    assert calls == {"az_merge_dense": 1}
    assert (n != before).any()
    installs = int(meta2[:, hybrid.M2_EXPOK].sum())
    assert installs == (0 if case == "past_capacity" else n.shape[0])
    if case == "root_only":
        assert ((patha > 0).sum(dim=1) == 1).all() and (patha[:, 0] > 0).all()
    if case == "terminal_link":
        assert (args[3][torch.arange(6), meta2[:, 6].long(), meta2[:, 5].long()] == -2.0 - args[-2]).all()


@pytest.mark.parametrize("A", [16, 65, 225, 361])
@pytest.mark.parametrize("case", MERGE_CASES)
def test_emulated_merge_round_dense_cases(emulated, case, A):
    """``az_merge_round_dense`` at K=4 on synthetic planes and records of
    each case (``merge_case``): planes, done/tval and the four top-2 planes
    bit-equal to the plain round merge's full refresh2."""
    args = merge_case(A, 4, case, seed=A + 1)
    calls = {"past_capacity": 0}
    merge_round = _checked_round_kernels(emulated, calls).merge_round
    merge_round(*args)
    assert calls["az_merge_round_dense"] == 1
    inst = args[9][..., hybrid.M2_EXPOK]
    if case == "duplicate":
        assert (inst[1] == 0).all() and (args[7][1] > 0).any()
    if case == "past_capacity":
        assert calls["past_capacity"] == 1 and (inst[1:] == 0).all()


@pytest.mark.parametrize("K", [1, 4])
def test_emulated_dense_merges_refuse_above_512_actions(emulated, K):
    """The dense merges keep up to 24 actions a lane in registers (16 up
    to A=512, 24 above): at A=769 the entry returns an error and writes
    nothing."""
    args = merge_case(769, K, "root_only", seed=K)
    planes = [t.clone() for t in args[:-2]]
    entry = "az_merge_dense" if K == 1 else "az_merge_round_dense"
    B, A, C = args[0].shape
    dims = (B, A, C) if K == 1 else (B, A, C, K)
    rc = getattr(emulated.lib, entry)(*(t.data_ptr() for t in args[:-2]), *dims, args[-2],
                                      args[-1], None)
    assert rc != 0
    assert all(torch.equal(bits(t), bits(u)) for t, u in zip(args[:-2], planes))
    assert kernels.DENSE_MERGE_MAX_A == 768


def _mlp_apply(hidden, seed):
    return make_apply_fn(convert_mlp(random_mlp_variables(7, hidden, seed=seed)))


def _mlp_args(weights):
    """``(sections, [n_hidden, h0..h3])`` of the MLP entry points."""
    sections, *widths = kernels._mlp_args(weights)
    return sections, widths


# prior and value tolerance of the emulated MLP evaluator: glibc's expf and
# tanhf against torch's CPU exp and tanh, each within an ulp or two of the
# exact value (< 1e-7 absolute for values of magnitude <= 1)
MLP_EMU_ATOL = 1e-6
MLP_EMU_W_ATOL = 24 * MLP_EMU_ATOL   # root W: a sum of up to 24 leaf values here
# the evaluator's tolerance with random (He-scaled) weights, where its
# tensor-core sums add in another order than the plain k loop: a hidden unit
# of |h| < 2 may round to the other bf16 neighbour (a step <= 2^-7), which a
# head weight |w| < 0.5 carries into a logit as < 4e-3, into the prior as
# about half that (chip_smoke.py's gate; on an H100 at B=4096 the largest
# differences were 1.26e-3, 2.6e-4 and 4.5e-4; the emulator's are smaller)
MLP_LOGIT_ATOL = 4e-3
MLP_PRIOR_ATOL = 2e-3


@pytest.mark.parametrize("m_tiles,n_tiles", [(1, 1), (2, 4)], ids=["one_tile", "two_by_four"])
def test_emulated_bf16_mma_tile_matches_float64(emulated, m_tiles, n_tiles):
    """``emu_mma_m16n8k16_bf16`` of one warp against a float64 matmul:
    random bf16 A (16 m_tiles x 16) and B (16 x 8 n_tiles) and f32
    accumulators C, put into each lane's registers by the PTX ISA's
    fragment layout (built here, independently of the emulator), and D read
    back the same way. Each instruction rounds its exact sum once to f32,
    so D is within an f32 ulp of the float64 A B + C: a layout mistake
    would show as an O(1) error."""
    rng = np.random.default_rng(7)
    M, N = 16 * m_tiles, 8 * n_tiles
    A = torch.from_numpy(rng.standard_normal((M, 16)).astype(np.float32)).to(torch.bfloat16)
    Bm = torch.from_numpy(rng.standard_normal((16, N)).astype(np.float32)).to(torch.bfloat16)
    C = rng.standard_normal((M, N)).astype(np.float32)
    a_bits = A.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF
    b_bits = Bm.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF
    a = np.zeros((32, 4 * m_tiles), np.uint32)
    b = np.zeros((32, 2 * n_tiles), np.uint32)
    d = np.zeros((32, 4 * m_tiles * n_tiles), np.float32)
    for lane in range(32):
        gid, tq = lane // 4, lane % 4
        for i in range(m_tiles):
            for r in range(4):   # a0..a3: rows gid, gid+8, gid, gid+8; k 2tq (+8 for a2, a3)
                row, k = 16 * i + gid + 8 * (r % 2), 2 * tq + 8 * (r // 2)
                a[lane, 4 * i + r] = a_bits[row, k] | a_bits[row, k + 1] << 16
        for j in range(n_tiles):
            for r in range(2):   # b0, b1: k 2tq, 2tq+8 of column gid
                k, col = 2 * tq + 8 * r, 8 * j + gid
                b[lane, 2 * j + r] = b_bits[k, col] | b_bits[k + 1, col] << 16
        for i in range(m_tiles):
            for j in range(n_tiles):
                for e in range(4):   # d0, d1: row gid; d2, d3: row gid+8; columns 2tq, 2tq+1
                    d[lane, (i * n_tiles + j) * 4 + e] = C[16 * i + gid + 8 * (e // 2),
                                                           8 * j + 2 * tq + e % 2]
    rc = emulated.lib.emu_mma_bf16_tiles(
        ctypes.c_void_p(a.ctypes.data), ctypes.c_void_p(b.ctypes.data),
        ctypes.c_void_p(d.ctypes.data), m_tiles, n_tiles)
    assert rc == 0
    D = np.zeros((M, N), np.float32)
    for lane in range(32):
        gid, tq = lane // 4, lane % 4
        for i in range(m_tiles):
            for j in range(n_tiles):
                for e in range(4):
                    D[16 * i + gid + 8 * (e // 2), 8 * j + 2 * tq + e % 2] = \
                        d[lane, (i * n_tiles + j) * 4 + e]
    want = A.double().numpy() @ Bm.double().numpy() + C.astype(np.float64)
    np.testing.assert_allclose(D, want, rtol=2.0 ** -23, atol=1e-30)


# hidden widths, the weights' kind and the boards: order-free (dyadic)
# weights must give the plain version's bits; random ones stay within
# MLP_LOGIT_ATOL / MLP_PRIOR_ATOL
@pytest.mark.parametrize(
    "hidden,kind,batch",
    [
        ((64,), "order_free", 40),
        ((32, 32), "order_free", 40),
        ((256, 256), "order_free", 40),
        ((16, 24, 40, 8), "order_free", 40),
        ((20, 9), "order_free", 40),              # rows not 16-byte aligned: 2-byte copies
        ((256, 256, 256, 256), "order_free", 8),  # too large to stay resident: staged
        ((256, 256), "random", 40),
        ((16, 24, 40, 8), "random", 40),
    ],
    ids=["smoke64", "32x32", "256x256", "four_layers", "odd_widths", "staged_256x4",
         "256x256_random", "four_layers_random"],
)
def test_emulated_mlp_eval_bit_equal_plain_logits(emulated, hidden, kind, batch):
    """The kernel's evaluator on ``batch`` boards (40: a full block and a
    ragged one with padding games): with order-free weights, logits
    bit-equal to ``mlp_forward``; with random He-scaled weights within
    MLP_LOGIT_ATOL. Prior and value within MLP_EMU_ATOL of ``mlp_prior`` and
    the plain tanh (order-free), or within MLP_PRIOR_ATOL and
    MLP_LOGIT_ATOL (random)."""
    if kind == "order_free":
        apply_fn = order_free_mlp_apply(hidden, seed=len(hidden))
    else:
        apply_fn = _mlp_apply(hidden, seed=len(hidden))
    weights = apply_fn.kernel_eval_factory(FlatOps())
    boards = FlatOps().from_state(torch_state(random_boards(batch, 20, seed=3, freeze_done=False)))
    if kind == "order_free":
        assert_order_free(boards, weights)
    logits, pm, value = torch.empty(batch, 7), torch.empty(batch, 7), torch.empty(batch)
    sections, widths = _mlp_args(weights)
    rc = emulated.lib.az_mlp_eval(
        boards.data_ptr(), sections, logits.data_ptr(), pm.data_ptr(), value.data_ptr(), batch,
        *widths, None,
    )
    assert rc == 0
    ref_logits, ref_value = mlp_forward(boards, weights)
    vm = FlatOps().valid(boards)
    assert (~vm).any() and torch.equal(pm[~vm], torch.full_like(pm[~vm], -1e30))
    if kind == "order_free":
        assert torch.equal(bits(logits), bits(ref_logits)), "mlp logits"
        torch.testing.assert_close(pm, mlp_prior(ref_logits, vm), atol=MLP_EMU_ATOL, rtol=0)
        torch.testing.assert_close(value, ref_value, atol=MLP_EMU_ATOL, rtol=0)
    else:
        torch.testing.assert_close(logits, ref_logits, atol=MLP_LOGIT_ATOL, rtol=0)
        torch.testing.assert_close(pm, mlp_prior(ref_logits, vm), atol=MLP_PRIOR_ATOL, rtol=0)
        torch.testing.assert_close(value, ref_value, atol=MLP_LOGIT_ATOL, rtol=0)


def test_emulated_mlp_plan_resident_or_staged(emulated):
    """The evaluator's shared-memory plan: the mlp preset's (256, 256)
    stays resident in 222,720 bytes; 3 and 4 layers of 256 are staged; and
    every stack ``check_mlp_widths`` takes fits a block's 232,448 bytes."""
    assert kernels.mlp_plan((256, 256), emulated) == (222_720, True)
    assert kernels.mlp_plan((256, 256, 256), emulated)[1] is False
    assert kernels.mlp_plan((256, 256, 256, 256), emulated)[1] is False
    for n in range(1, 5):
        for width in (1, 8, 100, 255, 256):
            nbytes, _ = kernels.mlp_plan((width,) * n, emulated)
            assert nbytes <= 232_448, ((width,) * n, nbytes)


def _checked_fused_mlp(lib, calls):
    """A ``kernels.fused_mlp`` stand-in running the emulated
    ``az_fused_mlp`` AND the plain ``fused_mlp_search`` on every call,
    recording how many games give identical counts. Where they do, root W
    must agree within MLP_EMU_W_ATOL: each backed-up value may differ in
    its last bits (glibc's tanhf against torch's tanh), and W sums up to
    num_sims of them."""

    def fused_mlp(boards, priors, weights, num_sims, nodes, max_depth, cpuct):
        B = boards.shape[0]
        tree = torch.empty(B, nodes, 32)
        counts, rootw = torch.empty(B, 7), torch.empty(B, 7)
        sections, widths = _mlp_args(weights)
        rc = lib.lib.az_fused_mlp(
            boards.data_ptr(), priors.data_ptr(), sections,
            *(t.data_ptr() for t in (tree, counts, rootw)),
            B, nodes, num_sims, max_depth, *widths, cpuct, None,
        )
        assert rc == 0
        cfg = MCTSConfig(num_sims=num_sims, max_nodes=nodes, max_depth=max_depth, cpuct=cpuct)
        ref_counts, ref_w = fused_mlp_search(boards, priors, cfg, weights)
        same = (counts == ref_counts).all(1)
        assert (rootw - ref_w)[same].abs().max() <= MLP_EMU_W_ATOL
        calls["fused_mlp"] += 1
        calls["same"] += int(same.sum())
        calls["games"] += B
        return counts, rootw

    return fused_mlp


def _mlp_search_apply(weights: str, seed: int):
    """The searches' MLPNet (32, 32): random (He-scaled) or order-free
    weights, whose tensor-core sums are the plain version's bit for bit."""
    if weights == "order_free":
        return order_free_mlp_apply((32, 32), seed=seed)
    return _mlp_apply((32, 32), seed=seed)


@pytest.mark.parametrize(
    "cfg,moves,freeze,dirichlet,weights",
    [
        (MCTSConfig(num_sims=24, max_depth=48), 8, True, None, "random"),
        (MCTSConfig(num_sims=20, max_depth=48), 30, False, None, "random"),             # endgames, past wins
        (MCTSConfig(num_sims=16, max_depth=3, cpuct=2.5), 6, True, None, "random"),     # depth cutoffs
        (MCTSConfig(num_sims=20, max_depth=48, max_nodes=8), 12, True, None, "random"),  # slots run out
        (MCTSConfig(num_sims=16, max_depth=48, dirichlet_alpha=0.7), 4, True, 0.7, "random"),
        (MCTSConfig(num_sims=24, max_depth=48), 8, True, None, "order_free"),
        (MCTSConfig(num_sims=20, max_depth=48), 30, False, None, "order_free"),
    ],
    ids=["early", "endgames", "max_depth3", "max_nodes8", "dirichlet", "early_order_free",
         "endgames_order_free"],
)
def test_emulated_mlp_search_matches_plain(emulated, cfg, moves, freeze, dirichlet, weights):
    """Whole emulated MLP searches (40 games: a full block of 32 and a
    ragged one) through the fused engine: simulations conserved, and counts
    identical to ``fused_mlp_search``'s on >= 95% of games with random
    weights (the tensor-core sums' order, or a last-bit difference of
    exp/tanh, can flip a PUCT argmax), on every game with order-free
    weights."""
    boards = torch_state(random_boards(40, moves, seed=moves, freeze_done=freeze))
    noise = None
    if dirichlet is not None:
        noise = sample_draws(torch.Generator().manual_seed(2), 40, 7, dirichlet, "cpu").dirichlet
    apply_fn = _mlp_search_apply(weights, seed=moves)
    if weights == "order_free":
        assert_order_free(FlatOps().from_state(boards), apply_fn.kernel_eval_factory(FlatOps()))
    calls = {"fused_mlp": 0, "same": 0, "games": 0}
    counts = make_fused_root_fn(
        TG, apply_fn, cfg, kernel=_checked_fused_mlp(emulated, calls)
    )(boards, noise)
    assert calls["fused_mlp"] == 1
    live = ~TG.terminal(boards)[0]
    assert live.any()
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()
    need = calls["games"] if weights == "order_free" else 0.95 * calls["games"]
    assert calls["same"] >= need, f"{calls['same']} of {calls['games']} games equal"


def _checked_round_kernels(lib, calls):
    """SearchKernels whose round entry points run the emulated round
    kernels AND the plain versions on every call, asserting bit-equal
    outputs; each call goes to the kernel instance ``kernels`` routes it to
    on the card. ``calls`` counts the launches by entry and what the
    rounds exercised: runner-up takes, duplicate expansions, edges that
    two descents of a round share, and rounds with slots past the
    capacity."""

    def descend_round(besta, bestc, seca, secc, done, tval, boards, max_depth, ops, K):
        outs, entry = descend_round_through_kernel(lib, besta, bestc, seca, secc, done, tval, boards,
                                                   max_depth, ops, K)
        patha, meta = outs[1], outs[3]
        calls[entry] = calls.get(entry, 0) + 1
        calls["second"] += int(((patha - 1 == seca) & (patha > 0)).sum())
        calls["dup"] += int(meta[..., hybrid.M_DUP].sum())
        on = patha > 0
        calls["shared"] += int(((patha[:, None] == patha[None]) & on[:, None] & on[None]).sum() - on.sum())
        return tuple(outs)

    def merge_round(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc, seca, secc,
                    slot0, cpuct):
        B, A, C = n.shape
        K = patha.shape[0]
        entry = "az_merge_round_dense" if A > hybrid.UNROLLED_MAX_A else "az_merge_round"
        best4 = (besta, bestc, seca, secc)
        ref = [t.clone() for t in (n, w, p, code, done, tval, *best4)]
        planes = (n, w, p, code, done, tval, pm, patha, psgn, meta2, *best4)
        rc = getattr(lib.lib, entry)(*(t.data_ptr() for t in planes), B, A, C, K, slot0, cpuct, None)
        assert rc == 0
        hybrid.merge_round(*ref[:6], pm, patha, psgn, meta2, *ref[6:], slot0, cpuct)
        names = ("n", "w", "p", "code", "done", "tval", "besta", "bestc", "seca", "secc")
        for nm, got, want in zip(names, (n, w, p, code, done, tval, *best4), ref):
            assert torch.equal(bits(got), bits(want)), f"{entry} {nm} at slots {slot0}+"
        calls[entry] = calls.get(entry, 0) + 1
        calls["past_capacity"] += int(slot0 + K - 1 >= C)
        return best4

    def refresh2(n, w, p, code, cpuct):
        best, entry = emulated_refresh2(lib, n, w, p, code, cpuct)
        calls[entry] = calls.get(entry, 0) + 1
        return best

    return SearchKernels(hybrid.descend, hybrid.merge, hybrid.refresh, descend_round, merge_round, refresh2)


@pytest.mark.parametrize(
    "game,moves,cfg,model",
    [
        (ConnectFour(), 8, MCTSConfig(num_sims=24, max_depth=48, parallel_sims=4), "uniform"),
        (ConnectFour(), 20, MCTSConfig(num_sims=16, max_depth=48, max_nodes=10, parallel_sims=2), "resnet"),
        (Othello(), 20, MCTSConfig(num_sims=16, max_depth=80, parallel_sims=4), "resnet"),
        (Othello(), 10, MCTSConfig(num_sims=12, max_depth=3, parallel_sims=2, cpuct=2.5), "resnet"),
        (Gomoku(7), 10, MCTSConfig(num_sims=16, max_depth=48, parallel_sims=2), "uniform"),
        (Gomoku(15), 9, MCTSConfig(num_sims=12, max_depth=64, parallel_sims=4), "uniform"),
        (Gomoku(9), 20, MCTSConfig(num_sims=16, max_depth=48, parallel_sims=4), "resnet"),
        (Gomoku(4, 4), 5, MCTSConfig(num_sims=16, max_depth=48, parallel_sims=4), "uniform"),
        (Gomoku(19), 40, MCTSConfig(num_sims=12, max_depth=64, parallel_sims=4), "uniform"),
        (Gomoku(23), 40, MCTSConfig(num_sims=12, max_depth=64, parallel_sims=4), "uniform"),
        (Gomoku(27), 60, MCTSConfig(num_sims=12, max_depth=64, parallel_sims=4), "uniform"),
        (Hex(), 30, MCTSConfig(num_sims=16, max_depth=56, parallel_sims=4), "resnet"),
        (Hex(), 12, MCTSConfig(num_sims=16, max_depth=56, max_nodes=10, parallel_sims=2), "uniform"),
    ],
    ids=["c4_K4", "c4_K2_resnet_max_nodes10", "othello_K4_resnet", "othello_K2_max_depth3",
         "gomoku7_K2", "gomoku15_K4", "gomoku9_K4_resnet", "gomoku4_K4", "gomoku19_K4",
         "gomoku23_K4", "gomoku27_K4", "hex_K4_resnet", "hex_K2_max_nodes10"],
)
def test_emulated_round_kernels_bit_equal_plain(emulated, game, moves, cfg, model):
    """Whole K>1 searches (40 games: ten descend blocks of four warps, a
    game each) through the emulated round kernels, every call of the
    game's round descend, the round merge and the top-2 refresh bit-equal to
    the plain versions on the same planes, one launch of each per round
    and one refresh; runner-up takes occur, and at K=4 duplicate
    expansions and edges two descents of a round share; slots run past
    the capacity with ``max_nodes``; the root counts equal the plain
    rounds'."""
    A = game.num_actions
    apply_fn = make_uniform_model(game).apply_fn
    if model == "resnet":
        cells = 42 if isinstance(game, ConnectFour) else A - (1 if isinstance(game, Othello) else 0)
        apply_fn = make_apply_fn(convert_az_resnet(
            random_az_resnet_variables(A, 4, 1, cells=cells, seed=moves), dtype=torch.float32))
    boards = torch_state(random_play_boards(game, 40, moves, seed=moves, freeze_done=False))
    calls = {"second": 0, "dup": 0, "shared": 0, "past_capacity": 0}
    counts = make_hybrid_root_fn(game, apply_fn, cfg, kernels=_checked_round_kernels(emulated, calls))(boards)
    rounds = cfg.num_sims // cfg.parallel_sims
    entry = kernels._DESCEND_ROUND_ENTRIES[kernels.descend_entry(game.flat_ops())]
    dense = "_dense" if A > hybrid.UNROLLED_MAX_A else ""
    assert {k: v for k, v in calls.items() if k.startswith("az_")} == {
        entry: rounds, f"az_merge_round{dense}": rounds, f"az_refresh2{dense}": 1}
    assert calls["second"] > 0
    assert (calls["dup"] > 0 and calls["shared"] > 0) or cfg.parallel_sims < 3
    assert (calls["past_capacity"] > 0) == (cfg.max_nodes is not None)
    np.testing.assert_array_equal(counts, make_hybrid_root_fn(game, apply_fn, cfg, kernels=PLAIN)(boards))
    live = ~game.terminal(boards)[0]
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()


@pytest.mark.parametrize("A", [7, 49, 65, 225, 529, 729])
def test_emulated_refresh2_ties_illegal_and_lone_nodes(emulated, A):
    """The top-2 refresh, a fresh round search's seed, at Connect-Four's A
    (the A <= 8 seed) and the dense A of Hex, Othello, Gomoku 15 and Gomoku
    23 and 27, on
    fresh planes whose roots carry exact score ties, illegal edges, an
    all-illegal root and a root with one legal edge, the last
    (``seed_priors``): bit-equal to the plain version, with no runner-up
    (-1, code -1) where no second legal edge exists; every other node of
    the fresh planes is the empty node (0, -1, 1, -1). (Off fresh planes
    the unrolled top-2 keeps, as the runner-up code of a node without one,
    the code its scan displaced; the A <= 8 round merge's tests,
    tests/test_torch_merge_emu.py ``lone_legal``, pin that.)"""
    B, C = 5, 37
    p_masked = seed_priors(A, B, seed=A)
    n, w, p, code = fresh_planes(SEED_GAMES[A], p_masked, C)
    (best_a, best_c, sec_a, sec_c), entry = emulated_refresh2(emulated, n, w, p, code, 1.0)
    assert entry == _seed_entry("refresh2", A)
    assert best_a[0, 0] == 1 and sec_a[0, 0] == (p_masked[0, 2:] > -5e29).nonzero()[0, 0] + 2
    assert best_a[1, 0] == 0 and sec_a[1, 0] == -1 and best_a[2, 0] == A - 1 and sec_a[2, 0] == -1
    assert (best_a[:, 1:] == 0).all() and (sec_a[:, 1:] == 1).all()
    assert (best_c == -1).all() and (sec_c == -1).all()
    assert (sec_a[3:, 0] >= 0).all()


def _checked_fused_mlp_rounds(lib, calls):
    """A ``kernels.fused_mlp_rounds`` stand-in running the emulated
    ``az_fused_mlp_rounds`` AND the plain ``fused_mlp_rounds_search``, with
    the bookkeeping and W bound of ``_checked_fused_mlp``."""

    def fused_mlp_rounds(boards, priors, weights, num_sims, nodes, max_depth, cpuct, K):
        B = boards.shape[0]
        tree, rnd = torch.empty(B, nodes, 32), torch.empty(B, nodes, 16)
        counts, rootw = torch.empty(B, 7), torch.empty(B, 7)
        sections, widths = _mlp_args(weights)
        rc = lib.lib.az_fused_mlp_rounds(
            boards.data_ptr(), priors.data_ptr(), sections,
            *(t.data_ptr() for t in (tree, rnd, counts, rootw)),
            B, nodes, K, num_sims, max_depth, *widths, cpuct, None,
        )
        assert rc == 0
        cfg = MCTSConfig(num_sims=num_sims, max_nodes=nodes, max_depth=max_depth, cpuct=cpuct,
                         parallel_sims=K)
        ref_counts, ref_w = fused_mlp_rounds_search(boards, priors, cfg, weights)
        same = (counts == ref_counts).all(1)
        assert (rootw - ref_w)[same].abs().max() <= MLP_EMU_W_ATOL
        calls["fused_mlp_rounds"] += 1
        calls["same"] += int(same.sum())
        calls["games"] += B
        return counts, rootw

    return fused_mlp_rounds


@pytest.mark.parametrize(
    "cfg,moves,freeze,weights",
    [
        (MCTSConfig(num_sims=24, max_depth=48, parallel_sims=4), 8, True, "random"),
        (MCTSConfig(num_sims=18, max_depth=48, parallel_sims=9), 30, False, "random"),          # endgames
        (MCTSConfig(num_sims=16, max_depth=3, cpuct=2.5, parallel_sims=2), 6, True, "random"),  # cutoffs
        (MCTSConfig(num_sims=24, max_depth=48, max_nodes=10, parallel_sims=4), 12, True, "random"),
        (MCTSConfig(num_sims=24, max_depth=48, parallel_sims=4), 8, True, "order_free"),
        (MCTSConfig(num_sims=18, max_depth=48, parallel_sims=9), 30, False, "order_free"),
    ],
    ids=["K4", "K9_endgames", "K2_max_depth3", "K4_max_nodes10", "K4_order_free",
         "K9_endgames_order_free"],
)
def test_emulated_mlp_rounds_match_plain(emulated, cfg, moves, freeze, weights):
    """Whole emulated K>1 MLP searches (40 games: a full block of 32 and a
    ragged one; K block evaluations per round): simulations conserved and
    counts identical to ``fused_mlp_rounds_search``'s on >= 95% of games
    with random weights, on every game with order-free ones, as for K=1."""
    boards = torch_state(random_boards(40, moves, seed=moves, freeze_done=freeze))
    apply_fn = _mlp_search_apply(weights, seed=moves)
    if weights == "order_free":
        assert_order_free(FlatOps().from_state(boards), apply_fn.kernel_eval_factory(FlatOps()))
    calls = {"fused_mlp_rounds": 0, "same": 0, "games": 0}
    counts = make_fused_root_fn(
        TG, apply_fn, cfg, kernel=_checked_fused_mlp_rounds(emulated, calls)
    )(boards)
    assert calls["fused_mlp_rounds"] == 1
    live = ~TG.terminal(boards)[0]
    assert live.any()
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()
    need = calls["games"] if weights == "order_free" else 0.95 * calls["games"]
    assert calls["same"] >= need, f"{calls['same']} of {calls['games']} games equal"
