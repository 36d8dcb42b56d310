"""The A <= 8 merges, ``az_merge`` and ``az_merge_round``
(alphazero_tpu_torch/csrc/hybrid.cu: one warp per game, one lane per
column the merge writes), compiled with g++ against the CPU stand-in for
the CUDA built-ins (tests/cuda_emu/; the ``emulated`` fixture of
tests/torch_parity.py) and run on host memory. On synthetic planes and
records of every case of ``merge_case`` (slots past the capacity,
terminal-child links, root-only paths, ties with illegal and all-illegal
nodes, a node whose one legal edge follows illegal ones, a parent off the
path, a round's duplicate), and on paths long enough to touch more columns
than a warp has lanes, the planes, done/tval and the best planes must be
bit-equal to the plain merges, which refresh every node: the kernels read
and refresh only the columns they write, so the others' best planes must
already be right (the precondition: on entry they are the refresh of the
entry planes). Whole searches through these kernels are
tests/test_torch_kernels.py's.

This checks the kernels' LOGIC on the CPU; whether the source builds with
nvcc and runs on the card is chip_smoke.py's job.
"""

import pytest
import torch

from alphazero_tpu_torch.mcts import hybrid
from tests.torch_parity import (  # noqa: F401  (emulated: a fixture)
    MERGE_CASES,
    bits,
    emulated,
    merge_case,
)


def _merge_through_kernel(lib, args) -> str:
    """The merge kernel that ``kernels`` routes the A of ``args`` (a
    ``merge_case``) to on the card, on ``args`` in place, against the plain
    merge on copies: every plane bit-equal. Returns the entry."""
    rounds = args[7].dim() == 3
    B, A, C = args[0].shape
    dense = "_dense" if A > hybrid.UNROLLED_MAX_A else ""
    entry = f"az_merge_round{dense}" if rounds else f"az_merge{dense}"
    tensors, (slot, cpuct) = args[:-2], args[-2:]
    ref = [t.clone() for t in tensors]
    dims = (B, A, C, args[7].shape[0]) if rounds else (B, A, C)
    rc = getattr(lib.lib, entry)(*(t.data_ptr() for t in tensors), *dims, slot, cpuct, None)
    assert rc == 0
    (hybrid.merge_round if rounds else hybrid.merge)(*ref, slot, cpuct)
    names = ("n", "w", "p", "code", "done", "tval", "pm", "patha", "psgn", "meta2", "besta", "bestc",
             "seca", "secc")
    for nm, got, want in zip(names, tensors, ref):
        assert torch.equal(bits(got), bits(want)), f"{entry} {nm} at slot {slot}"
    return entry


@pytest.mark.parametrize("case", MERGE_CASES)
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("A", [2, 7, 8])
def test_emulated_small_merges_bit_equal_full_refresh(emulated, A, K, case):
    """``az_merge`` (K=1) and ``az_merge_round`` (K=4) on each case:
    bit-equal to the plain full refresh, with the first-max and top-2
    semantics of the unrolled refreshes at the all-illegal and the
    one-legal-edge roots."""
    args = merge_case(A, K, case, seed=10 * A + K)
    assert _merge_through_kernel(emulated, args) == ("az_merge" if K == 1 else "az_merge_round")
    code, best = args[3], args[10:-2]
    if case in ("ties_illegal", "lone_legal"):      # game 1: every edge of the root illegal
        assert best[0][1, 0] == 0 and best[1][1, 0] == code[1, 0, 0]
        if K > 1:
            assert best[2][1, 0] == -1 and best[3][1, 0] == -1
    if case == "lone_legal":                        # game 2: the root's last edge alone legal
        assert best[0][2, 0] == A - 1 and best[1][2, 0] == code[2, A - 1, 0]
        if K > 1:                                   # no runner-up; the code the scan displaced
            assert best[2][2, 0] == -1 and best[3][2, 0] == code[2, 0, 0]


@pytest.mark.parametrize("K", [1, 4])
def test_emulated_small_merges_more_columns_than_lanes(emulated, K):
    """Paths of up to 48 edges at C=101 (the main path's capacity): a game
    touches more than 32 columns, so its warp merges them in several
    batches; bit-equal to the plain full refresh."""
    args = merge_case(7, K, "terminal_link", seed=K, C=101, path_len=48)
    patha = args[7] if K > 1 else args[7][None]
    assert ((patha > 0).any(dim=0).sum(dim=1) > 32).any()
    assert _merge_through_kernel(emulated, args) == ("az_merge" if K == 1 else "az_merge_round")


@pytest.mark.parametrize("K", [1, 4])
def test_emulated_small_merges_refuse_above_8_actions(emulated, K):
    """The A <= 8 merges keep a column's A cells in registers: at A=9 the
    entry returns an error and writes nothing."""
    args = merge_case(9, K, "root_only", seed=K)
    planes = [t.clone() for t in args[:-2]]
    B, A, C = args[0].shape
    dims = (B, A, C) if K == 1 else (B, A, C, K)
    entry = "az_merge" if K == 1 else "az_merge_round"
    rc = getattr(emulated.lib, entry)(*(t.data_ptr() for t in args[:-2]), *dims, args[-2], args[-1],
                                      None)
    assert rc != 0
    assert all(torch.equal(bits(t), bits(u)) for t, u in zip(args[:-2], planes))
