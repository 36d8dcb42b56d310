"""The CUDA sources of the kernels (alphazero_tpu_torch/csrc/hybrid.cu and
fused.cu, with c4.cuh), compiled with g++ against a CPU stand-in for the
CUDA built-ins (tests/cuda_emu/cuda_runtime.h) and run on host memory:
every descend, merge and refresh call of whole hybrid searches, and every
whole fused search, must be bit-equal to the plain PyTorch versions, and
the searches must reproduce the goldens.

This checks the kernels' LOGIC (indexing, record format, install/link/
backup, PUCT order of operations, first-max ties, the Connect-Four win
test) on the CPU. Whether the sources build with nvcc and run on the card
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
from alphazero_tpu_torch.games import ConnectFour
from alphazero_tpu_torch.mcts import (
    SearchKernels,
    fused_search,
    hybrid,
    make_fused_root_fn,
    make_hybrid_root_fn,
)
from alphazero_tpu_torch.models import (
    convert_az_resnet,
    make_apply_fn,
    make_uniform_model,
    random_az_resnet_variables,
)
from alphazero_tpu_torch.ops import sample_draws
from tests.torch_parity import boards_from_seqs, random_boards, torch_state

HERE = os.path.dirname(os.path.abspath(__file__))
TG = ConnectFour()
_LAUNCH = re.compile(r"(\w+)<<<(.*?),\s*(\w+),\s*0,\s*\(cudaStream_t\)stream>>>\((.*?)\);", re.S)
_LAUNCHES = {"hybrid.cu": 3, "fused.cu": 1}   # kernel launches in each source


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
        out = _LAUNCH.sub(r"emu_launch(\2, \3, [&] { \1(\4); });", src.read_text())
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
    on every call, asserting bit-equal outputs."""

    def descend(besta, bestc, done, tval, boards, max_depth):
        B, C = besta.shape
        outs = [torch.empty(B, 42), torch.empty(B, C), torch.empty(B, C), torch.empty(B, 8)]
        rc = lib.lib.az_descend(
            *(t.data_ptr() for t in (besta, bestc, done, tval, boards, *outs)),
            B, C, max_depth, None,
        )
        assert rc == 0
        for nm, got, want in zip(("bd", "patha", "psgn", "meta"), outs,
                                 hybrid.descend(besta, bestc, done, tval, boards, max_depth)):
            assert torch.equal(_bits(got), _bits(want)), f"descend {nm}"
        calls["descend"] += 1
        return tuple(outs)

    def merge(n, w, p, code, done, tval, pm, patha, psgn, meta2, slot, cpuct):
        B, A, C = n.shape
        ref_planes = [t.clone() for t in (n, w, p, code, done, tval)]
        best = [torch.empty(B, C), torch.empty(B, C)]
        rc = lib.lib.az_merge(
            *(t.data_ptr() for t in (n, w, p, code, done, tval, pm, patha, psgn, meta2, *best)),
            B, A, C, slot, cpuct, None,
        )
        assert rc == 0
        ref_best = hybrid.merge(*ref_planes, pm, patha, psgn, meta2, slot, cpuct)
        names = ("n", "w", "p", "code", "done", "tval", "besta", "bestc")
        for nm, got, want in zip(names, [n, w, p, code, done, tval, *best], [*ref_planes, *ref_best]):
            assert torch.equal(_bits(got), _bits(want)), f"merge {nm} at slot {slot}"
        calls["merge"] += 1
        return tuple(best)

    def refresh(n, w, p, code, cpuct):
        B, A, C = n.shape
        best = [torch.empty(B, C), torch.empty(B, C)]
        rc = lib.lib.az_refresh(
            *(t.data_ptr() for t in (n, w, p, code, *best)), B, A, C, cpuct, None
        )
        assert rc == 0
        for got, want in zip(best, hybrid.refresh(n, w, p, code, cpuct)):
            assert torch.equal(_bits(got), _bits(want)), "refresh"
        calls["refresh"] += 1
        return tuple(best)

    return SearchKernels(descend, merge, refresh)


def test_emulated_kernels_reproduce_goldens(emulated):
    with open(os.path.join(HERE, "golden_counts.json")) as f:
        spec = json.load(f)["connect_four"]
    calls = {"descend": 0, "merge": 0, "refresh": 0}
    root_counts = make_hybrid_root_fn(
        TG, make_uniform_model(TG).apply_fn, MCTSConfig(num_sims=50, max_depth=64),
        kernels=_checked_kernels(emulated, calls),
    )
    counts = root_counts(torch_state(boards_from_seqs(spec["seqs"])))
    np.testing.assert_array_equal(counts.numpy().astype(int), np.asarray(spec["counts"]))
    assert calls == {"descend": 50, "merge": 50, "refresh": 1}


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
    calls = {"descend": 0, "merge": 0, "refresh": 0}
    boards = torch_state(random_boards(40, moves, seed=moves))
    counts = make_hybrid_root_fn(
        TG, make_uniform_model(TG).apply_fn, cfg, kernels=_checked_kernels(emulated, calls)
    )(boards)
    assert calls["merge"] == cfg.num_sims
    live = ~TG.terminal(boards)[0]
    assert (counts.sum(1)[live] == cfg.num_sims).all() and (counts.sum(1)[~live] == 0).all()


def test_emulated_kernels_bit_equal_plain_resnet_dirichlet(emulated):
    """A non-uniform prior and value (f32 AZResNet-8x1) with root noise:
    terminal children, W backups of both signs."""
    cfg = MCTSConfig(num_sims=20, max_depth=48, dirichlet_alpha=1.0)
    apply_fn = make_apply_fn(convert_az_resnet(random_az_resnet_variables(7, 8, 1, seed=3), dtype=torch.float32))
    noise = sample_draws(torch.Generator().manual_seed(0), 32, 7, 1.0, "cpu").dirichlet
    calls = {"descend": 0, "merge": 0, "refresh": 0}
    make_hybrid_root_fn(TG, apply_fn, cfg, kernels=_checked_kernels(emulated, calls))(
        torch_state(random_boards(32, 16, seed=9)), noise
    )
    assert calls == {"descend": 20, "merge": 20, "refresh": 1}


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
