"""The CUDA sources of the kernels (alphazero_tpu_torch/csrc/hybrid.cu and
fused.cu, with c4.cuh, othello.cuh and mlp.cuh), compiled with g++ against
a CPU stand-in for the CUDA built-ins (tests/cuda_emu/cuda_runtime.h,
cuda_bf16.h) and run on host memory: every descend, merge and refresh call
of whole hybrid searches (Connect-Four through the A<=8 kernels, Othello
through its descend and the dense merge and refresh), and every whole
uniform fused search, must be bit-equal to the plain PyTorch versions, and
the searches must reproduce the goldens; so must whole Gomoku (edges 7, 8,
9, 15) and Hex searches through their descend instances and the dense
merge and refresh, every call of the K>1 round kernels, and whole uniform
fused searches in K>1 rounds. The MLP evaluator's logits must be bit-equal to its plain
version's; its prior and value, and so the MLP searches, may differ where
glibc's expf/tanhf and torch's CPU exp/tanh differ in the last bit.

This checks the kernels' LOGIC (indexing, record format, install/link/
backup, PUCT order of operations, first-max ties, the Connect-Four win
test, the Othello flips, the Gomoku overwrite, the Hex transpose) on the
CPU. Whether the sources build with nvcc and run on the card
is chip_smoke.py's job.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess

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
    fused_rounds_search,
    fused_search,
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
from tests.torch_parity import (
    boards_from_seqs,
    random_boards,
    random_othello_boards,
    random_play_boards,
    torch_state,
)

HERE = os.path.dirname(os.path.abspath(__file__))
TG = ConnectFour()
OTH = Othello()
# kernel<<<grid, threads, smem, stream>>>(args), the kernel maybe a template instance
_LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<(.*?),\s*(\w+),\s*(\w+),\s*\(cudaStream_t\)stream>>>\((.*?)\);", re.S)
_LAUNCHES = {"hybrid.cu": 10, "fused.cu": 5}   # kernel launches in each source
# a kernel's dynamic shared memory: the emulated launch's buffer
_DYNAMIC_SMEM = re.compile(r"extern __shared__ ([\w ]+?) (\w+)\[\];")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel library built for the host from every source, as
    ``kernels.library`` links it for the card (skips without g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    build_dir = tmp_path_factory.mktemp("emu")
    cpps = []
    for src in kernels.SOURCES:
        out = _LAUNCH.sub(r"emu_launch(\2, \3, \4, [&] { \1(\5); });", src.read_text())
        out = _DYNAMIC_SMEM.sub(r"\1* \2 = (\1*)emu_dynamic_smem;", out)
        assert out.count("emu_launch(") == _LAUNCHES[src.name], "every kernel launch must be rewritten"
        cpp = build_dir / f"{src.stem}_emu.cpp"
        cpp.write_text(out)
        cpps.append(str(cpp))
    so = build_dir / "libaz_emu.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-Wno-unknown-pragmas", "-I", os.path.join(HERE, "cuda_emu"),
         "-I", str(kernels.SOURCES[0].parent),
         "-o", str(so), *cpps, "-lpthread"],
        check=True, capture_output=True,
    )
    return kernels._Library(ctypes.CDLL(str(so)), so, 0.0, "")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _checked_kernels(lib, calls):
    """SearchKernels running the emulated kernels AND the plain versions
    on every call, asserting bit-equal outputs. Each call goes to the
    kernel instance ``kernels`` routes it to on the card: descend by the
    flat ops' type (``kernels.descend_entry``), merge and refresh by action
    count."""

    def descend(besta, bestc, done, tval, boards, max_depth, ops):
        B, C = besta.shape
        L = boards.shape[1]
        assert L == ops.size
        entry = kernels.descend_entry(ops)
        outs = [torch.empty(B, L), torch.empty(B, C), torch.empty(B, C), torch.empty(B, 8)]
        rc = getattr(lib.lib, entry)(
            *(t.data_ptr() for t in (besta, bestc, done, tval, boards, *outs)),
            B, C, max_depth, L, None,
        )
        assert rc == 0
        for nm, got, want in zip(("bd", "patha", "psgn", "meta"), outs,
                                 hybrid.descend(besta, bestc, done, tval, boards, max_depth, ops)):
            assert torch.equal(_bits(got), _bits(want)), f"{entry} {nm}"
        calls[entry] = calls.get(entry, 0) + 1
        return tuple(outs)

    def merge(n, w, p, code, done, tval, pm, patha, psgn, meta2, slot, cpuct):
        B, A, C = n.shape
        entry = "az_merge_dense" if A > hybrid.UNROLLED_MAX_A else "az_merge"
        ref_planes = [t.clone() for t in (n, w, p, code, done, tval)]
        best = [torch.empty(B, C), torch.empty(B, C)]
        rc = getattr(lib.lib, entry)(
            *(t.data_ptr() for t in (n, w, p, code, done, tval, pm, patha, psgn, meta2, *best)),
            B, A, C, slot, cpuct, None,
        )
        assert rc == 0
        ref_best = hybrid.merge(*ref_planes, pm, patha, psgn, meta2, slot, cpuct)
        names = ("n", "w", "p", "code", "done", "tval", "besta", "bestc")
        for nm, got, want in zip(names, [n, w, p, code, done, tval, *best], [*ref_planes, *ref_best]):
            assert torch.equal(_bits(got), _bits(want)), f"{entry} {nm} at slot {slot}"
        calls[entry] = calls.get(entry, 0) + 1
        return tuple(best)

    def refresh(n, w, p, code, cpuct):
        best, entry = _emulated_refresh(lib, n, w, p, code, cpuct)
        calls[entry] = calls.get(entry, 0) + 1
        return best

    return SearchKernels(descend, merge, refresh)


def _emulated_refresh(lib, n, w, p, code, cpuct):
    """The refresh kernel for A (``az_refresh`` or ``az_refresh_dense``),
    asserted bit-equal to the plain version: ``(best planes, entry)``."""
    B, A, C = n.shape
    entry = "az_refresh_dense" if A > hybrid.UNROLLED_MAX_A else "az_refresh"
    best = [torch.empty(B, C), torch.empty(B, C)]
    rc = getattr(lib.lib, entry)(*(t.data_ptr() for t in (n, w, p, code, *best)), B, A, C, cpuct, None)
    assert rc == 0
    for nm, got, want in zip(("besta", "bestc"), best, hybrid.refresh(n, w, p, code, cpuct)):
        assert torch.equal(_bits(got), _bits(want)), f"{entry} {nm}"
    return tuple(best), entry


def test_emulated_kernels_reproduce_goldens(emulated):
    with open(os.path.join(HERE, "golden_counts.json")) as f:
        spec = json.load(f)["connect_four"]
    calls = {}
    root_counts = make_hybrid_root_fn(
        TG, make_uniform_model(TG).apply_fn, MCTSConfig(num_sims=50, max_depth=64),
        kernels=_checked_kernels(emulated, calls),
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
        TG, make_uniform_model(TG).apply_fn, cfg, kernels=_checked_kernels(emulated, calls)
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
    make_hybrid_root_fn(TG, apply_fn, cfg, kernels=_checked_kernels(emulated, calls))(
        torch_state(random_boards(32, 16, seed=9)), noise
    )
    assert calls == {"az_descend": 20, "az_merge": 20, "az_refresh": 1}


def test_emulated_othello_kernels_reproduce_goldens(emulated):
    with open(os.path.join(HERE, "golden_counts.json")) as f:
        spec = json.load(f)["othello"]
    states = []
    for seq in spec["seqs"]:
        s = OTH.init(1, "cpu")
        for a in seq:
            s = OTH.step(s, torch.tensor([a]))
        states.append(s)
    calls = {}
    counts = make_hybrid_root_fn(
        OTH, make_uniform_model(OTH).apply_fn, MCTSConfig(num_sims=50, max_depth=64),
        kernels=_checked_kernels(emulated, calls),
    )(torch.cat(states))
    np.testing.assert_array_equal(counts.numpy().astype(int), np.asarray(spec["counts"]))
    assert calls == {"az_descend_othello": 50, "az_merge_dense": 50, "az_refresh_dense": 1}


@pytest.mark.parametrize(
    "cfg,moves,dirichlet",
    [
        (MCTSConfig(num_sims=24, max_depth=80), 20, None),
        (MCTSConfig(num_sims=24, max_depth=80), 56, None),                  # passes, endgames
        (MCTSConfig(num_sims=20, max_depth=3, cpuct=2.5), 10, None),        # depth cutoffs
        (MCTSConfig(num_sims=20, max_depth=80, max_nodes=8), 30, None),     # slots run out
        (MCTSConfig(num_sims=16, max_depth=80, dirichlet_alpha=0.3), 6, 0.3),
    ],
    ids=["midgame", "endgames", "max_depth3", "max_nodes8", "dirichlet"],
)
def test_emulated_othello_kernels_bit_equal_plain(emulated, cfg, moves, dirichlet):
    """Whole Othello searches (40 games: a full descend block of 32 and a
    ragged one) with an f32 AZResNet-8x1 prior and value, so W backs up
    values of both signs and the cutoff backs up the heuristic: every
    Othello descend, dense merge and dense refresh call bit-equal to the
    plain versions."""
    apply_fn = make_apply_fn(convert_az_resnet(random_az_resnet_variables(65, 8, 1, cells=64, seed=moves),
                                               dtype=torch.float32))
    boards = torch_state(random_othello_boards(40, moves, seed=moves))
    noise = None
    if dirichlet is not None:
        noise = sample_draws(torch.Generator().manual_seed(3), 40, 65, dirichlet, "cpu").dirichlet
    calls = {}
    counts = make_hybrid_root_fn(OTH, apply_fn, cfg, kernels=_checked_kernels(emulated, calls))(boards, noise)
    assert calls == {"az_descend_othello": cfg.num_sims, "az_merge_dense": cfg.num_sims,
                     "az_refresh_dense": 1}
    live = ~OTH.terminal(boards)[0]
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()


@pytest.mark.parametrize(
    "game,moves,cfg,model",
    [
        (Gomoku(7), 10, MCTSConfig(num_sims=16, max_depth=48), "uniform"),
        (Gomoku(7), 40, MCTSConfig(num_sims=16, max_depth=48), "uniform"),      # terminal children
        (Gomoku(8), 12, MCTSConfig(num_sims=16, max_depth=48, max_nodes=8), "uniform"),
        (Gomoku(9), 20, MCTSConfig(num_sims=16, max_depth=3, cpuct=2.5), "resnet"),   # cutoffs
        (Gomoku(15), 9, MCTSConfig(num_sims=12, max_depth=64), "uniform"),
        (Hex(), 0, MCTSConfig(num_sims=16, max_depth=56), "uniform"),
        (Hex(), 30, MCTSConfig(num_sims=16, max_depth=56), "resnet"),          # terminal children
        (Hex(), 12, MCTSConfig(num_sims=16, max_depth=3, max_nodes=8), "uniform"),
    ],
    ids=["gomoku7", "gomoku7_endgames", "gomoku8_max_nodes8", "gomoku9_resnet_max_depth3",
         "gomoku15", "hex_opening", "hex_resnet_endgames", "hex_max_depth3_max_nodes8"],
)
def test_emulated_gomoku_and_hex_kernels_bit_equal_plain(emulated, game, moves, cfg, model):
    """Whole Gomoku and Hex searches (40 games: a full descend block of 32
    and a ragged one; random positions played past the end, so some are
    finished and some children terminal) with the uniform model or an f32
    AZResNet-4x1 (W of both signs): every call of the game's descend
    instance, the dense merge and the dense refresh bit-equal to the plain
    versions, with exactly one launch of each per simulation and one
    refresh."""
    A = game.num_actions
    apply_fn = make_uniform_model(game).apply_fn
    if model == "resnet":
        apply_fn = make_apply_fn(convert_az_resnet(
            random_az_resnet_variables(A, 4, 1, cells=A, seed=moves), dtype=torch.float32))
    boards = torch_state(random_play_boards(game, 40, moves, seed=moves, freeze_done=False))
    calls = {}
    counts = make_hybrid_root_fn(game, apply_fn, cfg, kernels=_checked_kernels(emulated, calls))(boards)
    entry = kernels.descend_entry(game.flat_ops())
    assert entry == ("az_descend_hex" if isinstance(game, Hex) else "az_descend_gomoku")
    assert calls == {entry: cfg.num_sims, "az_merge_dense": cfg.num_sims, "az_refresh_dense": 1}
    live = ~game.terminal(boards)[0]
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()


@pytest.mark.parametrize("game", [Gomoku(5), Gomoku(7), Gomoku(8), Gomoku(9), Gomoku(15), Gomoku(16), Hex()],
                         ids=["gomoku5", "gomoku7", "gomoku8", "gomoku9", "gomoku15", "gomoku16", "hex"])
def test_emulated_descend_steps_every_action(emulated, game):
    """The game's descend instance on synthetic best planes whose path takes
    EVERY action from each of two positions (occupied cells of both colours
    included, which a search never picks), then a second edge to another
    action: leaf boards and path records bit-equal to the plain descend,
    whose step is the flat ops'."""
    ops = game.flat_ops()
    A = L = ops.size
    boards = ops.from_state(torch_state(random_play_boards(game, 2, A // 3, seed=A, freeze_done=False)))
    B, C = 2 * A, 3
    roots = boards.repeat_interleave(A, dim=0)
    acts = torch.arange(A, dtype=torch.float32).repeat(2)
    besta = torch.stack([acts, (acts * 7 + 3) % A, torch.zeros(B)], dim=1)
    calls = {}
    descend = _checked_kernels(emulated, calls).descend
    for second_edge in (False, True):          # one step; two steps (then unexpanded)
        bestc = torch.full((B, C), -1.0)
        if second_edge:
            bestc[:, 0] = 1.0
        bd, *_ = descend(besta, bestc, torch.zeros(B, C), torch.zeros(B, C), roots, 48, ops)
        want = ops.step(roots, acts[:, None])
        if second_edge:
            want = ops.step(want, besta[:, 1:2])
        assert torch.equal(bd, want + 0.0)
    assert calls == {kernels.descend_entry(ops): 2}
    occupied = roots[torch.arange(B), acts.long()]
    assert (occupied == 1).any() and (occupied == -1).any()


@pytest.mark.parametrize("A", [49, 65, 81, 225])
def test_emulated_dense_refresh_ties_and_illegal_nodes(emulated, A):
    """The dense refresh at Hex's and Gomoku-7's A, Othello's, Gomoku-9's
    and Gomoku-15's, on synthetic
    planes with exact score ties (equal priors, equal W and N), illegal
    edges and all-illegal nodes: bit-equal to the plain version, whose
    first-max picks action 0 where every edge is illegal."""
    rng = np.random.default_rng(A)
    B, C = 5, 37
    n = torch.as_tensor(rng.integers(0, 3, (B, A, C)).astype(np.float32))
    w = torch.as_tensor((rng.integers(-2, 3, (B, A, C)) / 2).astype(np.float32)) * (n > 0)
    p = torch.full((B, A, C), 1.0 / A)
    p[:, 3::5] = -1e30
    p[1, :, 4] = -1e30                                   # an all-illegal node
    code = torch.as_tensor(rng.integers(-3, C, (B, A, C)).astype(np.float32))
    (best_a, best_c), entry = _emulated_refresh(emulated, n, w, p, code, 1.0)
    assert entry == "az_refresh_dense"
    assert best_a[1, 4] == 0 and best_c[1, 4] == code[1, 0, 4]
    sq = torch.sqrt(n.sum(dim=1) + 1e-6)[:, None]
    score = torch.where(p <= -5e29, -1e30, w / n.clamp(min=1) + p * sq / (1 + n))
    assert ((score == score.amax(dim=1, keepdim=True)).sum(dim=1) > 1).any()   # exact ties


def _checked_fused(lib, calls):
    """A ``kernels.fused`` stand-in running the emulated ``az_fused`` AND
    the plain ``fused_search`` on every call, asserting bit-equal counts
    and root W."""

    def fused(boards, priors, num_sims, nodes, max_depth, cpuct, uval):
        B = boards.shape[0]
        tree = torch.empty(B, nodes, 32)
        counts, rootw = torch.empty(B, 7), torch.empty(B, 7)
        rc = lib.lib.az_fused(
            *(t.data_ptr() for t in (boards, priors, tree, counts, rootw)),
            B, nodes, num_sims, max_depth, cpuct, uval, None,
        )
        assert rc == 0
        cfg = MCTSConfig(num_sims=num_sims, max_nodes=nodes, max_depth=max_depth, cpuct=cpuct)
        ref_counts, ref_w = fused_search(boards, priors, cfg, uval)
        assert torch.equal(_bits(counts), _bits(ref_counts)), "fused counts"
        assert torch.equal(_bits(rootw), _bits(ref_w)), "fused root W"
        calls["fused"] += 1
        return counts, rootw

    return fused


def test_emulated_reproduces_goldens(emulated):
    with open(os.path.join(HERE, "golden_counts.json")) as f:
        spec = json.load(f)["connect_four"]
    calls = {"fused": 0}
    root_counts = make_fused_root_fn(
        TG, make_uniform_model(TG).apply_fn, MCTSConfig(num_sims=50, max_depth=64),
        kernel=_checked_fused(emulated, calls),
    )
    counts = root_counts(torch_state(boards_from_seqs(spec["seqs"])))
    np.testing.assert_array_equal(counts.numpy().astype(int), np.asarray(spec["counts"]))
    assert calls == {"fused": 1}


@pytest.mark.parametrize(
    "cfg,moves,value,freeze",
    [
        (MCTSConfig(num_sims=24, max_depth=48), 12, 0.0, True),
        (MCTSConfig(num_sims=24, max_depth=48), 30, 0.5, True),         # W signs, endgames
        (MCTSConfig(num_sims=16, max_depth=3, cpuct=2.5), 6, 0.0, True),  # depth cutoffs
        (MCTSConfig(num_sims=20, max_depth=48, max_nodes=8), 28, 0.0, True),  # slots run out
        (MCTSConfig(num_sims=12, max_depth=48), 36, -0.25, False),      # played past wins
    ],
    ids=["late_positions", "uval0.5_endgames", "max_depth3", "max_nodes8", "past_wins"],
)
def test_emulated_bit_equal_plain(emulated, cfg, moves, value, freeze):
    calls = {"fused": 0}
    boards = torch_state(random_boards(40, moves, seed=moves, freeze_done=freeze))
    counts = make_fused_root_fn(
        TG, make_uniform_model(TG, value).apply_fn, cfg, kernel=_checked_fused(emulated, calls)
    )(boards)
    assert calls == {"fused": 1}
    live = ~TG.terminal(boards)[0]
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()


def test_emulated_bit_equal_plain_dirichlet(emulated):
    cfg = MCTSConfig(num_sims=20, max_depth=48, dirichlet_alpha=0.7)
    noise = sample_draws(torch.Generator().manual_seed(1), 32, 7, 0.7, "cpu").dirichlet
    calls = {"fused": 0}
    make_fused_root_fn(
        TG, make_uniform_model(TG, 0.5).apply_fn, cfg, kernel=_checked_fused(emulated, calls)
    )(torch_state(random_boards(32, 8, seed=4)), noise)
    assert calls == {"fused": 1}


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


@pytest.mark.parametrize(
    "hidden", [(64,), (32, 32), (256, 256), (16, 24, 40, 8)],
    ids=["smoke64", "32x32", "256x256", "four_layers"],
)
def test_emulated_mlp_eval_bit_equal_plain_logits(emulated, hidden):
    """The kernel's evaluator on 40 boards (a full block and a ragged one
    with padding games): logits bit-equal to ``mlp_forward``; prior and
    value within MLP_EMU_ATOL of ``mlp_prior`` and the plain tanh."""
    weights = _mlp_apply(hidden, seed=len(hidden)).kernel_eval_factory(FlatOps())
    boards = FlatOps().from_state(torch_state(random_boards(40, 20, seed=3, freeze_done=False)))
    logits, pm, value = torch.empty(40, 7), torch.empty(40, 7), torch.empty(40)
    sections, widths = _mlp_args(weights)
    rc = emulated.lib.az_mlp_eval(
        boards.data_ptr(), sections, logits.data_ptr(), pm.data_ptr(), value.data_ptr(), 40,
        *widths, None,
    )
    assert rc == 0
    ref_logits, ref_value = mlp_forward(boards, weights)
    assert torch.equal(_bits(logits), _bits(ref_logits)), "mlp logits"
    vm = FlatOps().valid(boards)
    assert (~vm).any() and torch.equal(pm[~vm], torch.full_like(pm[~vm], -1e30))
    torch.testing.assert_close(pm, mlp_prior(ref_logits, vm), atol=MLP_EMU_ATOL, rtol=0)
    torch.testing.assert_close(value, ref_value, atol=MLP_EMU_ATOL, rtol=0)


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


@pytest.mark.parametrize(
    "cfg,moves,freeze,dirichlet",
    [
        (MCTSConfig(num_sims=24, max_depth=48), 8, True, None),
        (MCTSConfig(num_sims=20, max_depth=48), 30, False, None),             # endgames, past wins
        (MCTSConfig(num_sims=16, max_depth=3, cpuct=2.5), 6, True, None),     # depth cutoffs
        (MCTSConfig(num_sims=20, max_depth=48, max_nodes=8), 12, True, None),  # slots run out
        (MCTSConfig(num_sims=16, max_depth=48, dirichlet_alpha=0.7), 4, True, 0.7),
    ],
    ids=["early", "endgames", "max_depth3", "max_nodes8", "dirichlet"],
)
def test_emulated_mlp_search_matches_plain(emulated, cfg, moves, freeze, dirichlet):
    """Whole emulated MLP searches (40 games: a full block of 32 and a
    ragged one) through the fused engine: simulations conserved, and counts
    identical to ``fused_mlp_search``'s on >= 95% of games (a last-bit
    difference of exp/tanh can flip a PUCT argmax)."""
    boards = torch_state(random_boards(40, moves, seed=moves, freeze_done=freeze))
    noise = None
    if dirichlet is not None:
        noise = sample_draws(torch.Generator().manual_seed(2), 40, 7, dirichlet, "cpu").dirichlet
    calls = {"fused_mlp": 0, "same": 0, "games": 0}
    counts = make_fused_root_fn(
        TG, _mlp_apply((32, 32), seed=moves), cfg, kernel=_checked_fused_mlp(emulated, calls)
    )(boards, noise)
    assert calls["fused_mlp"] == 1
    live = ~TG.terminal(boards)[0]
    assert live.any()
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()
    assert calls["same"] >= 0.95 * calls["games"], f"{calls['same']} of {calls['games']} games equal"


def _checked_round_kernels(lib, calls):
    """SearchKernels whose round entry points run the emulated round
    kernels AND the plain versions on every call, asserting bit-equal
    outputs; each call goes to the kernel instance ``kernels`` routes it to
    on the card. ``calls`` counts the launches by entry and what the
    rounds exercised: runner-up takes, duplicate expansions, edges that
    two descents of a round share, and rounds with slots past the
    capacity."""

    def descend_round(besta, bestc, seca, secc, done, tval, boards, max_depth, ops, K):
        B, C = besta.shape
        L = boards.shape[1]
        entry = kernels._DESCEND_ROUND_ENTRIES[kernels.descend_entry(ops)]
        outs = [torch.empty(K, B, L), torch.empty(K, B, C), torch.empty(K, B, C), torch.empty(K, B, 8)]
        rc = getattr(lib.lib, entry)(
            *(t.data_ptr() for t in (besta, bestc, seca, secc, done, tval, boards, *outs)),
            B, C, K, max_depth, L, None,
        )
        assert rc == 0
        want = hybrid.descend_round(besta, bestc, seca, secc, done, tval, boards, max_depth, ops, K)
        for nm, got, ref in zip(("bd", "patha", "psgn", "meta"), outs, want):
            assert torch.equal(_bits(got), _bits(ref)), f"{entry} {nm}"
        patha, meta = outs[1], outs[3]
        calls[entry] = calls.get(entry, 0) + 1
        calls["second"] += int(((patha - 1 == seca) & (patha > 0)).sum())
        calls["dup"] += int(meta[..., hybrid.M_DUP].sum())
        on = patha > 0
        calls["shared"] += int(((patha[:, None] == patha[None]) & on[:, None] & on[None]).sum() - on.sum())
        return tuple(outs)

    def merge_round(n, w, p, code, done, tval, pm, patha, psgn, meta2, slot0, cpuct):
        B, A, C = n.shape
        K = patha.shape[0]
        entry = "az_merge_round_dense" if A > hybrid.UNROLLED_MAX_A else "az_merge_round"
        ref_planes = [t.clone() for t in (n, w, p, code, done, tval)]
        best = [torch.empty(B, C) for _ in range(4)]
        rc = getattr(lib.lib, entry)(
            *(t.data_ptr() for t in (n, w, p, code, done, tval, pm, patha, psgn, meta2, *best)),
            B, A, C, K, slot0, cpuct, None,
        )
        assert rc == 0
        ref_best = hybrid.merge_round(*ref_planes, pm, patha, psgn, meta2, slot0, cpuct)
        names = ("n", "w", "p", "code", "done", "tval", "besta", "bestc", "seca", "secc")
        for nm, got, want in zip(names, [n, w, p, code, done, tval, *best], [*ref_planes, *ref_best]):
            assert torch.equal(_bits(got), _bits(want)), f"{entry} {nm} at slots {slot0}+"
        calls[entry] = calls.get(entry, 0) + 1
        calls["past_capacity"] += int(slot0 + K - 1 >= C)
        return tuple(best)

    def refresh2(n, w, p, code, cpuct):
        best, entry = _emulated_refresh2(lib, n, w, p, code, cpuct)
        calls[entry] = calls.get(entry, 0) + 1
        return best

    return SearchKernels(hybrid.descend, hybrid.merge, hybrid.refresh, descend_round, merge_round, refresh2)


def _emulated_refresh2(lib, n, w, p, code, cpuct):
    """The top-2 refresh kernel for A (``az_refresh2`` or
    ``az_refresh2_dense``), asserted bit-equal to the plain version:
    ``(top-2 planes, entry)``."""
    B, A, C = n.shape
    entry = "az_refresh2_dense" if A > hybrid.UNROLLED_MAX_A else "az_refresh2"
    best = [torch.empty(B, C) for _ in range(4)]
    rc = getattr(lib.lib, entry)(*(t.data_ptr() for t in (n, w, p, code, *best)), B, A, C, cpuct, None)
    assert rc == 0
    for nm, got, want in zip(("besta", "bestc", "seca", "secc"), best, hybrid.refresh2(n, w, p, code, cpuct)):
        assert torch.equal(_bits(got), _bits(want)), f"{entry} {nm}"
    return tuple(best), entry


@pytest.mark.parametrize(
    "game,moves,cfg,model",
    [
        (ConnectFour(), 8, MCTSConfig(num_sims=24, max_depth=48, parallel_sims=4), "uniform"),
        (ConnectFour(), 20, MCTSConfig(num_sims=16, max_depth=48, max_nodes=10, parallel_sims=2), "resnet"),
        (Othello(), 20, MCTSConfig(num_sims=16, max_depth=80, parallel_sims=4), "resnet"),
        (Othello(), 10, MCTSConfig(num_sims=12, max_depth=3, parallel_sims=2, cpuct=2.5), "resnet"),
        (Gomoku(7), 10, MCTSConfig(num_sims=16, max_depth=48, parallel_sims=2), "uniform"),
        (Gomoku(15), 9, MCTSConfig(num_sims=12, max_depth=64, parallel_sims=4), "uniform"),
        (Hex(), 30, MCTSConfig(num_sims=16, max_depth=56, parallel_sims=4), "resnet"),
        (Hex(), 12, MCTSConfig(num_sims=16, max_depth=56, max_nodes=10, parallel_sims=2), "uniform"),
    ],
    ids=["c4_K4", "c4_K2_resnet_max_nodes10", "othello_K4_resnet", "othello_K2_max_depth3",
         "gomoku7_K2", "gomoku15_K4", "hex_K4_resnet", "hex_K2_max_nodes10"],
)
def test_emulated_round_kernels_bit_equal_plain(emulated, game, moves, cfg, model):
    """Whole K>1 searches (40 games: a full descend block of 32 and a
    ragged one) through the emulated round kernels, every call of the
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


@pytest.mark.parametrize("A", [7, 49, 65, 225])
def test_emulated_refresh2_ties_illegal_and_lone_nodes(emulated, A):
    """The top-2 refresh at Connect-Four's A (unrolled) and the dense A of
    Hex, Othello and Gomoku 15, on synthetic planes with exact score ties,
    illegal edges, an all-illegal node and a node with one legal edge:
    bit-equal to the plain version, with no runner-up (-1) where no second
    legal edge exists; there the dense branch's runner-up code is -1 and the
    unrolled one keeps what its scan left."""
    rng = np.random.default_rng(A)
    B, C = 5, 37
    n = torch.as_tensor(rng.integers(0, 3, (B, A, C)).astype(np.float32))
    w = torch.as_tensor((rng.integers(-2, 3, (B, A, C)) / 2).astype(np.float32)) * (n > 0)
    p = torch.full((B, A, C), 1.0 / A)
    p[:, 3::5] = -1e30
    p[1, :, 4] = -1e30                                   # an all-illegal node
    p[2, :, 5] = -1e30
    p[2, A - 1, 5] = 1.0                                 # a node with one legal edge, the last
    code = torch.as_tensor(rng.integers(-3, C, (B, A, C)).astype(np.float32))
    (best_a, best_c, sec_a, sec_c), entry = _emulated_refresh2(emulated, n, w, p, code, 1.0)
    assert entry == ("az_refresh2_dense" if A > 8 else "az_refresh2")
    assert best_a[1, 4] == 0 and sec_a[1, 4] == -1 and best_a[2, 5] == A - 1 and sec_a[2, 5] == -1
    if A > 8:
        assert sec_c[1, 4] == -1 and sec_c[2, 5] == -1
    else:
        assert sec_c[2, 5] == code[2, 0, 5]               # the scan's leftover: action 0's code
    sq = torch.sqrt(n.sum(dim=1) + 1e-6)[:, None]
    score = torch.where(p <= -5e29, -1e30, w / n.clamp(min=1) + p * sq / (1 + n))
    assert ((score == score.amax(dim=1, keepdim=True)).sum(dim=1) > 1).any()   # exact ties
    assert (sec_a >= 0).sum() > B * C - 4


def _checked_fused_rounds(lib, calls):
    """A ``kernels.fused_rounds`` stand-in running the emulated
    ``az_fused_rounds`` AND the plain ``fused_rounds_search`` on every call,
    asserting bit-equal counts and root W."""

    def fused_rounds(boards, priors, num_sims, nodes, max_depth, cpuct, uval, K):
        B = boards.shape[0]
        tree, rnd = torch.empty(B, nodes, 32), torch.empty(B, nodes, 16)
        counts, rootw = torch.empty(B, 7), torch.empty(B, 7)
        rc = lib.lib.az_fused_rounds(
            *(t.data_ptr() for t in (boards, priors, tree, rnd, counts, rootw)),
            B, nodes, K, num_sims, max_depth, cpuct, uval, None,
        )
        assert rc == 0
        cfg = MCTSConfig(num_sims=num_sims, max_nodes=nodes, max_depth=max_depth, cpuct=cpuct,
                         parallel_sims=K)
        ref_counts, ref_w = fused_rounds_search(boards, priors, cfg, uval)
        assert torch.equal(_bits(counts), _bits(ref_counts)), "fused_rounds counts"
        assert torch.equal(_bits(rootw), _bits(ref_w)), "fused_rounds root W"
        calls["fused_rounds"] += 1
        return counts, rootw

    return fused_rounds


@pytest.mark.parametrize(
    "cfg,moves,value,freeze,dirichlet",
    [
        (MCTSConfig(num_sims=24, max_depth=48, parallel_sims=2), 10, 0.0, True, None),
        (MCTSConfig(num_sims=24, max_depth=48, parallel_sims=2), 14, 0.3, True, None),
        (MCTSConfig(num_sims=24, max_depth=48, parallel_sims=4), 8, 0.0, True, None),
        (MCTSConfig(num_sims=24, max_depth=48, parallel_sims=4), 12, 0.3, True, None),
        (MCTSConfig(num_sims=27, max_depth=48, parallel_sims=9), 6, 0.0, True, None),
        (MCTSConfig(num_sims=27, max_depth=48, parallel_sims=9), 16, 0.3, True, None),
        (MCTSConfig(num_sims=16, max_depth=3, cpuct=2.5, parallel_sims=4), 6, 0.3, True, None),
        (MCTSConfig(num_sims=24, max_depth=48, max_nodes=10, parallel_sims=4), 20, 0.3, True, None),
        (MCTSConfig(num_sims=18, max_depth=48, parallel_sims=9), 36, 0.3, False, None),
        (MCTSConfig(num_sims=16, max_depth=48, dirichlet_alpha=0.7, parallel_sims=4), 4, 0.3, True, 0.7),
    ],
    ids=["K2", "K2_uval0.3", "K4", "K4_uval0.3", "K9", "K9_uval0.3", "K4_max_depth3",
         "K4_max_nodes10", "K9_terminal_roots", "K4_dirichlet"],
)
def test_emulated_fused_rounds_bit_equal_plain(emulated, cfg, moves, value, freeze, dirichlet):
    """Whole K>1 uniform fused searches (40 games) through the emulated
    ``az_fused_rounds``: counts and root W bit-equal to
    ``fused_rounds_search`` in one launch, at K = 2, 4 and 9, with the value
    0 (integer W) and 0.3 (where the order of the round's W additions shows
    in the bits), a depth cutoff, slots running out inside a round, finished
    roots and Dirichlet roots; the simulations are conserved."""
    boards = torch_state(random_boards(40, moves, seed=moves, freeze_done=freeze))
    noise = None
    if dirichlet is not None:
        noise = sample_draws(torch.Generator().manual_seed(5), 40, 7, dirichlet, "cpu").dirichlet
    calls = {"fused_rounds": 0}
    counts = make_fused_root_fn(
        TG, make_uniform_model(TG, value).apply_fn, cfg, kernel=_checked_fused_rounds(emulated, calls)
    )(boards, noise)
    assert calls == {"fused_rounds": 1}
    live = ~TG.terminal(boards)[0]
    assert live.any() and (freeze or (~live).any())
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()


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
    "cfg,moves,freeze",
    [
        (MCTSConfig(num_sims=24, max_depth=48, parallel_sims=4), 8, True),
        (MCTSConfig(num_sims=18, max_depth=48, parallel_sims=9), 30, False),            # endgames
        (MCTSConfig(num_sims=16, max_depth=3, cpuct=2.5, parallel_sims=2), 6, True),    # cutoffs
        (MCTSConfig(num_sims=24, max_depth=48, max_nodes=10, parallel_sims=4), 12, True),
    ],
    ids=["K4", "K9_endgames", "K2_max_depth3", "K4_max_nodes10"],
)
def test_emulated_mlp_rounds_match_plain(emulated, cfg, moves, freeze):
    """Whole emulated K>1 MLP searches (40 games: a full block of 32 and a
    ragged one; K block evaluations per round): simulations conserved and
    counts identical to ``fused_mlp_rounds_search``'s on >= 95% of games,
    as for K=1."""
    boards = torch_state(random_boards(40, moves, seed=moves, freeze_done=freeze))
    calls = {"fused_mlp_rounds": 0, "same": 0, "games": 0}
    counts = make_fused_root_fn(
        TG, _mlp_apply((32, 32), seed=moves), cfg, kernel=_checked_fused_mlp_rounds(emulated, calls)
    )(boards)
    assert calls["fused_mlp_rounds"] == 1
    live = ~TG.terminal(boards)[0]
    assert live.any()
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()
    assert calls["same"] >= 0.95 * calls["games"], f"{calls['same']} of {calls['games']} games equal"
