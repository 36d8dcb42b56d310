"""Shared inputs for the JAX <-> PyTorch parity tests (tests/test_torch_*.py).

Inputs are made from a seed with numpy and handed to both packages as
numpy arrays: random-play Connect-Four, Othello, Gomoku and Hex boards,
a numpy replica of the position generator of tests/test_fused.py (which the
TPU goldens were frozen from), the conversions of a batch of boards
into each package's state, and MLPNet weights on a dyadic grid whose
forward is the same in every order of the adds; synthetic merge records
(``merge_case``). Also the ``emulated`` fixture: the CUDA kernel library
built with g++ against the CPU stand-in of tests/cuda_emu/ (once per hash
of what it compiles, shared by the test processes), which
tests/test_torch_kernels.py, tests/test_torch_fused_emu.py,
tests/test_torch_merge_emu.py, tests/test_torch_descend_emu.py and
tests/test_torch_games_emu.py share (``build_emulated`` builds a subset,
with the probes of the emulated instructions: tests/test_torch_tower_emu.py),
and its kernels run from it against
the plain versions (``descend_through_kernel``,
``descend_round_through_kernel``, ``checked_kernels`` for whole hybrid
searches, ``emulated_refresh``, ``emulated_refresh2``), and the fresh
planes the dense seeds take (``fresh_planes``, ``seed_priors``).
"""

import ctypes
import fcntl
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games.connect_four import ConnectFourState
from alphazero_tpu.games.gomoku import GomokuState
from alphazero_tpu.games.hex import HexState
from alphazero_tpu.games.othello import OthelloState
from alphazero_tpu_torch import kernels
from alphazero_tpu_torch.games import ConnectFour as TorchConnectFour
from alphazero_tpu_torch.games import Othello as TorchOthello
from alphazero_tpu_torch.mcts import SearchKernels, hybrid
from alphazero_tpu_torch.mcts.fused import _ordered_dot
from alphazero_tpu_torch.models import convert_mlp, make_apply_fn, order_free_mlp_variables
from alphazero_tpu_torch.ops import Draws

# Tier-1 runs several pytest workers side by side; keep each one's
# intra-op pool small.
torch.set_num_threads(2)

_GAME = TorchConnectFour()
_OTHELLO = TorchOthello()

# a full board with no four-in-a-row (an exact-0 draw)
DRAW_BOARD = np.array(
    [
        [-1, 1, -1, -1, -1, 1, -1],
        [-1, -1, 1, -1, 1, 1, -1],
        [1, 1, 1, -1, 1, 1, 1],
        [-1, -1, 1, 1, 1, -1, -1],
        [1, 1, -1, -1, -1, 1, -1],
        [-1, 1, -1, 1, -1, 1, 1],
    ],
    np.int8,
)


def random_boards(batch: int, moves: int, seed: int, freeze_done: bool = True) -> np.ndarray:
    """int8[B, 6, 7] canonical boards after ``moves`` uniformly random
    legal moves (games that finish freeze unless ``freeze_done`` is
    False, which keeps playing past wins while moves are legal)."""
    rng = np.random.default_rng(seed)
    state = _GAME.init(batch, "cpu")
    for _ in range(moves):
        valid = _GAME.valid_moves(state).numpy()
        acts = np.array([rng.choice(np.flatnonzero(v)) if v.any() else 0 for v in valid])
        nxt = _GAME.step(state, torch.as_tensor(acts))
        done, _ = _GAME.terminal(nxt)
        stop = ~torch.as_tensor(valid.any(axis=1))
        if freeze_done:
            stop |= done
        state = torch.where(stop[:, None, None], state, nxt)
    return state.numpy()


def jax_step_draws(k_noise, k_tie, k_act, batch: int, actions: int, alpha) -> Draws:
    """The draws a JAX search + move makes from its three keys: the
    Dirichlet sample of ``root_prior`` (None when ``alpha`` is None), the
    tie-break uniforms of ``action_probs`` and the Gumbel noise inside
    ``jax.random.categorical``."""
    dirichlet = None
    if alpha is not None:
        dirichlet = jax.random.dirichlet(k_noise, jnp.full((actions,), alpha), (batch,))
        dirichlet = torch.as_tensor(np.array(dirichlet))
    tie = jax.random.uniform(k_tie, (batch, actions))
    gumbel = jax.random.gumbel(k_act, (batch, actions))
    return Draws(dirichlet, torch.as_tensor(np.array(tie)), torch.as_tensor(np.array(gumbel)))


def jax_scan_draws(key, steps: int, batch: int, actions: int, alpha) -> list:
    """Each step's draws of a JAX self-play scan run with ``key``: both
    scans split ``rng, k_noise, k_tie, k_act = split(rng, 4)`` a step
    (selfplay.py :266 and :532)."""
    out = []
    for _ in range(steps):
        key, k_noise, k_tie, k_act = jax.random.split(key, 4)
        out.append(jax_step_draws(k_noise, k_tie, k_act, batch, actions, alpha))
    return out


def jax_gumbel_scan_draws(key, steps: int, batch: int, actions: int) -> list:
    """Each step's draws of a JAX Gumbel self-play scan run with ``key``: the
    same four-way split a step, the search's root sample
    ``gumbel(k_noise, [B, A])`` in ``Draws.gumbel`` (the move needs no
    other draw; ``tie`` is ``k_tie``'s uniforms, unused)."""
    out = []
    for _ in range(steps):
        key, k_noise, k_tie, _ = jax.random.split(key, 4)
        out.append(Draws(None, torch.as_tensor(np.array(jax.random.uniform(k_tie, (batch, actions)))),
                         torch.as_tensor(np.array(jax.random.gumbel(k_noise, (batch, actions))))))
    return out


def jax_pcr_scan_draws(key, steps: int, batch: int, actions: int, n_full: int, alpha,
                       gumbel: bool) -> list:
    """Each step's draws of a JAX playout-cap-randomized scan run with
    ``key``: the five-way split ``rng, k_noise, k_tie, k_act, k_coin`` a step
    (selfplay.py :238), the permutation ``permutation(k_coin, B)`` when
    ``0 < n_full < B``, and the search noise of the two sub-batches from
    ``kf, kc = split(k_noise)`` in permuted order: the full one's Dirichlet
    sample (``alpha``), or with ``gumbel`` both sub-batches' root samples,
    in ``Draws.gumbel``; else ``Draws.gumbel`` is the move's ``k_act`` noise."""
    out = []
    n_cheap = batch - n_full
    for _ in range(steps):
        key, k_noise, k_tie, k_act, k_coin = jax.random.split(key, 5)
        kf, kc = jax.random.split(k_noise)
        perm = None
        if 0 < n_full < batch:
            perm = torch.as_tensor(np.array(jax.random.permutation(k_coin, batch))).long()
        tie = torch.as_tensor(np.array(jax.random.uniform(k_tie, (batch, actions))))
        dirichlet = None
        if gumbel:
            parts = [jax.random.gumbel(k, (n, actions)) for k, n in ((kf, n_full), (kc, n_cheap))
                     if n > 0]
            noise = torch.as_tensor(np.concatenate([np.array(x) for x in parts]))
        else:
            noise = torch.as_tensor(np.array(jax.random.gumbel(k_act, (batch, actions))))
            if alpha is not None and n_full > 0:
                dirichlet = torch.zeros((batch, actions))
                dirichlet[:n_full] = torch.as_tensor(np.array(
                    jax.random.dirichlet(kf, jnp.full((actions,), alpha), (n_full,))))
        out.append(Draws(dirichlet, tie, noise, perm))
    return out


def jax_state(boards: np.ndarray) -> ConnectFourState:
    return ConnectFourState(board=jnp.asarray(boards, jnp.int8))


def torch_state(boards: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(boards, np.int8))


def boards_from_seqs(seqs) -> np.ndarray:
    """int8[N, 6, 7] boards reached by the given move sequences."""
    out = []
    for seq in seqs:
        s = _GAME.init(1, "cpu")
        for a in seq:
            s = _GAME.step(s, torch.tensor([a]))
        out.append(s)
    return torch.cat(out).numpy()


def random_othello_boards(batch: int, moves: int, seed: int, freeze_done: bool = True) -> np.ndarray:
    """int8[B, 8, 8] canonical Othello boards after ``moves`` uniformly
    random legal moves (the pass when it is the only one); finished games
    freeze unless ``freeze_done`` is False, which keeps passing."""
    rng = np.random.default_rng(seed)
    state = _OTHELLO.init(batch, "cpu")
    for _ in range(moves):
        valid = _OTHELLO.valid_moves(state).numpy()
        acts = np.array([rng.choice(np.flatnonzero(v)) for v in valid])
        nxt = _OTHELLO.step(state, torch.as_tensor(acts))
        if freeze_done:
            done, _ = _OTHELLO.terminal(state)
            nxt = torch.where(done[:, None, None], state, nxt)
        state = nxt
    return state.numpy()


def othello_jax_state(boards: np.ndarray) -> OthelloState:
    return OthelloState(board=jnp.asarray(boards, jnp.int8))


def random_play_boards(game, batch: int, moves: int, seed: int, freeze_done: bool = True) -> np.ndarray:
    """Canonical boards of a port ``game`` (Gomoku, Hex) after ``moves``
    uniformly random legal moves; finished games freeze unless
    ``freeze_done`` is False, which keeps playing past the end while empty
    cells remain."""
    rng = np.random.default_rng(seed)
    state = game.init(batch, "cpu")
    for _ in range(moves):
        valid = game.valid_moves(state).numpy()
        acts = np.array([rng.choice(np.flatnonzero(v)) if v.any() else 0 for v in valid])
        nxt = game.step(state, torch.as_tensor(acts))
        stop = ~torch.as_tensor(valid.any(axis=1))
        if freeze_done:
            stop |= game.terminal(state)[0]
        state = torch.where(stop[:, None, None], state, nxt)
    return state.numpy()


def fused_test_positions(game, batch: int, moves: int, seed: int) -> np.ndarray:
    """The boards of ``tests.test_fused._random_positions(jax_game, batch,
    moves, seed)`` made with the port's ``game``: one ``rng.choice`` per
    game per move over its valid moves, and a game keeps its state whenever
    its next state would be terminal."""
    rng = np.random.default_rng(seed)
    state = game.init(batch, "cpu")
    for _ in range(moves):
        vm = game.valid_moves(state).numpy()
        acts = np.array([rng.choice(np.nonzero(v)[0]) for v in vm])
        nxt = game.step(state, torch.as_tensor(acts))
        done, _ = game.terminal(nxt)
        state = torch.where(done[:, None, None], state, nxt)
    return state.numpy()


def gomoku_jax_state(boards: np.ndarray) -> GomokuState:
    return GomokuState(board=jnp.asarray(boards, jnp.int8))


def hex_jax_state(boards: np.ndarray) -> HexState:
    return HexState(board=jnp.asarray(boards, jnp.int8))


def order_free_mlp_apply(hidden, seed: int = 0):
    """The ``apply_fn`` of an ``MLPNet`` of the given hidden widths with
    ``order_free_mlp_variables`` weights (Connect-Four, 7 actions): its
    forward on 0/1 boards has exact partial sums, so a tensor-core tile's
    order of the adds gives the plain version's bits
    (``assert_order_free`` checks it on a batch of boards)."""
    return make_apply_fn(convert_mlp(order_free_mlp_variables(7, hidden, seed=seed)))


def assert_order_free(boards: torch.Tensor, weights) -> None:
    """The plain f32 forward of ``weights`` (``MLPKernelWeights``) on flat
    Connect-Four boards f32[B, 42] equals its float64 evaluation: every
    layer's ordered f32 sums, and the head's, are exact. Then every order
    of the adds gives the same bits."""
    x = torch.cat([boards == 1, boards == -1], dim=1).float()
    for i, (w, b) in enumerate(zip(weights.w, weights.b)):
        s32 = _ordered_dot(x, w.float())
        assert torch.equal(s32.double(), x.double() @ w.double()), f"layer {i} sums are not exact"
        y = (s32.to(torch.bfloat16).float() + b.float()).to(torch.bfloat16)
        x = torch.where(y > 0, y, 0).float()
    head32 = _ordered_dot(x, weights.wh)
    assert torch.equal(head32.double(), x.double() @ weights.wh.double()), "head sums are not exact"
    assert torch.equal((head32 + weights.bh).double(), head32.double() + weights.bh.double())


_HERE = os.path.dirname(os.path.abspath(__file__))
# kernel<<<grid, threads, smem, stream>>>(args), the kernel maybe a template instance
_LAUNCH = re.compile(r"(\w+(?:<[\w, ]+>)?)<<<(.*?),\s*(\w+),\s*(\w+),\s*\(cudaStream_t\)stream>>>\((.*?)\);", re.S)
_LAUNCHES = {"hybrid.cu": 7, "fused.cu": 5, "int8_tower.cu": 1}   # kernel launches in each source
# a kernel's dynamic shared memory: the emulated launch's buffer
_DYNAMIC_SMEM = re.compile(r"extern __shared__ ([\w ]+?) (\w+)\[\];")


def build_emulated(sources=kernels.SOURCES, probes=("mma_tile.cpp",)):
    """The kernel library built for the host with g++ from ``sources``, as
    ``kernels.library`` links them for the card, plus the probes of
    tests/cuda_emu/ (skips without g++). A build is kept under the temporary
    directory, named by the hash of everything it compiles, and shared by
    every test process (a file lock makes the first build it and the
    others wait)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    emu_dir = os.path.join(_HERE, "cuda_emu")
    flags = ["-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-Wno-unknown-pragmas",
             "-I", emu_dir, "-I", str(kernels.SOURCES[0].parent)]
    rewritten = {}
    for src in sources:
        out = _LAUNCH.sub(r"emu_launch(\2, \3, \4, [&] { \1(\5); });", src.read_text())
        out = _DYNAMIC_SMEM.sub(r"\1* \2 = (\1*)emu_dynamic_smem;", out)
        assert out.count("emu_launch(") == _LAUNCHES[src.name], "every kernel launch must be rewritten"
        rewritten[f"{src.stem}_emu.cpp"] = out
    digest = hashlib.sha256(" ".join([gxx, *flags, *probes]).encode())
    for name, text in sorted(rewritten.items()):
        digest.update(name.encode() + text.encode())
    headers = sorted(kernels.SOURCES[0].parent.glob("*.cuh")) + sorted(
        pathlib.Path(emu_dir).glob("*"))
    for path in headers:
        digest.update(path.name.encode() + path.read_bytes())
    build_dir = pathlib.Path(tempfile.gettempdir()) / "az_emu" / digest.hexdigest()[:20]
    build_dir.mkdir(parents=True, exist_ok=True)
    so = build_dir / "libaz_emu.so"
    with open(build_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            cpps = []
            for name, text in rewritten.items():
                (build_dir / name).write_text(text)
                cpps.append(str(build_dir / name))
            cpps += [os.path.join(emu_dir, probe) for probe in probes]
            part = build_dir / f"libaz_emu.{os.getpid()}.so"
            proc = subprocess.run([gxx, *flags, "-o", str(part), *cpps, "-lpthread"],
                                  capture_output=True, text=True)
            assert proc.returncode == 0, f"g++ failed:\n{proc.stderr[-4000:]}"
            os.replace(part, so)
    lib = ctypes.CDLL(str(so))
    if tuple(sources) == kernels.SOURCES:
        return kernels._Library(lib, so, 0.0, "")
    for fn, (args, res) in kernels._SIGNATURES.items():   # the entries these sources export
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, res
    return types.SimpleNamespace(lib=lib, path=so)


@pytest.fixture(scope="module")
def emulated():
    """The kernel library built for the host from every source (with the
    bf16 tile probe), as ``kernels.library`` links it for the card."""
    return build_emulated()


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s float32 bits as int32, for bit-equality checks."""
    return t.contiguous().view(torch.int32)


def descend_through_kernel(lib, besta, bestc, done, tval, boards, max_depth, ops):
    """The descend instance that ``kernels`` routes ``ops`` to on the card
    (``kernels.descend_entry``), run from the emulated library ``lib`` on
    these arguments and held bit-equal to ``hybrid.descend``: ``(bd, patha,
    psgn, meta), entry``."""
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
        assert torch.equal(bits(got), bits(want)), f"{entry} {nm}"
    return tuple(outs), entry


def descend_round_through_kernel(lib, besta, bestc, seca, secc, done, tval, boards, max_depth, ops,
                                 K):
    """The round descend instance that ``kernels`` routes ``ops`` to on the
    card, run from the emulated library ``lib`` and held bit-equal to
    ``hybrid.descend_round``: ``(bd, patha, psgn, meta), entry``, each
    output K-major."""
    B, C = besta.shape
    L = boards.shape[1]
    assert L == ops.size
    entry = kernels._DESCEND_ROUND_ENTRIES[kernels.descend_entry(ops)]
    outs = [torch.empty(K, B, L), torch.empty(K, B, C), torch.empty(K, B, C), torch.empty(K, B, 8)]
    rc = getattr(lib.lib, entry)(
        *(t.data_ptr() for t in (besta, bestc, seca, secc, done, tval, boards, *outs)),
        B, C, K, max_depth, L, None,
    )
    assert rc == 0
    want = hybrid.descend_round(besta, bestc, seca, secc, done, tval, boards, max_depth, ops, K)
    for nm, got, ref in zip(("bd", "patha", "psgn", "meta"), outs, want):
        assert torch.equal(bits(got), bits(ref)), f"{entry} {nm}"
    return tuple(outs), entry


def checked_kernels(lib, calls):
    """SearchKernels running the emulated kernels AND the plain versions
    on every call, asserting bit-equal outputs. Each call goes to the
    kernel instance ``kernels`` routes it to on the card: descend by the
    flat ops' type (``kernels.descend_entry``), merge and refresh by action
    count."""

    def descend(besta, bestc, done, tval, boards, max_depth, ops):
        outs, entry = descend_through_kernel(lib, besta, bestc, done, tval, boards, max_depth, ops)
        calls[entry] = calls.get(entry, 0) + 1
        return outs

    def merge(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc, slot, cpuct):
        B, A, C = n.shape
        entry = "az_merge_dense" if A > hybrid.UNROLLED_MAX_A else "az_merge"
        ref = [t.clone() for t in (n, w, p, code, done, tval, besta, bestc)]
        planes = (n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc)
        rc = getattr(lib.lib, entry)(*(t.data_ptr() for t in planes), B, A, C, slot, cpuct, None)
        assert rc == 0
        hybrid.merge(*ref[:6], pm, patha, psgn, meta2, *ref[6:], slot, cpuct)
        names = ("n", "w", "p", "code", "done", "tval", "besta", "bestc")
        for nm, got, want in zip(names, (n, w, p, code, done, tval, besta, bestc), ref):
            assert torch.equal(bits(got), bits(want)), f"{entry} {nm} at slot {slot}"
        calls[entry] = calls.get(entry, 0) + 1
        return besta, bestc

    def refresh(n, w, p, code, cpuct):
        best, entry = emulated_refresh(lib, n, w, p, code, cpuct)
        calls[entry] = calls.get(entry, 0) + 1
        return best

    return SearchKernels(descend, merge, refresh)


def emulated_refresh(lib, n, w, p, code, cpuct):
    """The seed kernel for A (``az_refresh`` or ``az_refresh_dense``),
    asserted bit-equal to the plain version on outputs filled with NaN
    first (so every cell must be written): ``(best planes, entry)``. Both
    seed a fresh search: ``n, w, p, code`` must be planes as
    ``hybrid._init_planes`` leaves them (``fresh_planes``)."""
    B, A, C = n.shape
    entry = "az_refresh_dense" if A > hybrid.UNROLLED_MAX_A else "az_refresh"
    best = [torch.full((B, C), float("nan")) for _ in range(2)]
    rc = getattr(lib.lib, entry)(*(t.data_ptr() for t in (n, w, p, code, *best)), B, A, C, cpuct, None)
    assert rc == 0
    for nm, got, want in zip(("besta", "bestc"), best, hybrid.refresh(n, w, p, code, cpuct)):
        assert torch.equal(bits(got), bits(want)), f"{entry} {nm}"
    return tuple(best), entry


def emulated_refresh2(lib, n, w, p, code, cpuct):
    """The top-2 seed kernel for A (``az_refresh2`` or
    ``az_refresh2_dense``, on fresh planes as ``emulated_refresh``'s),
    asserted bit-equal to the plain version on outputs filled with NaN
    first: ``(top-2 planes, entry)``."""
    B, A, C = n.shape
    entry = "az_refresh2_dense" if A > hybrid.UNROLLED_MAX_A else "az_refresh2"
    best = [torch.full((B, C), float("nan")) for _ in range(4)]
    rc = getattr(lib.lib, entry)(*(t.data_ptr() for t in (n, w, p, code, *best)), B, A, C, cpuct, None)
    assert rc == 0
    for nm, got, want in zip(("besta", "bestc", "seca", "secc"), best, hybrid.refresh2(n, w, p, code, cpuct)):
        assert torch.equal(bits(got), bits(want)), f"{entry} {nm}"
    return tuple(best), entry


def fresh_planes(game, p_masked: torch.Tensor, nodes: int, state=None) -> tuple:
    """The stat planes ``n, w, p, code f32[B, A, nodes]`` of fresh trees
    as ``run_search``/``run_rounds`` build them (``hybrid._init_planes``):
    the masked root priors ``p_masked f32[B, A]`` at node 0, the empty
    node everywhere else. ``state``: the roots (default: the initial
    position), which set only the done/tval planes."""
    ops = game.flat_ops()
    if state is None:
        state = game.init(p_masked.shape[0], "cpu")
    return hybrid._init_planes(ops, ops.from_state(state), p_masked, nodes, ops.aux("cpu"))[:4]


def seed_priors(A: int, B: int, seed: int) -> torch.Tensor:
    """Seeded masked root priors f32[B, A] (B >= 4; illegal edges
    INVALID_P), one scenario a game: game 0 uniform over its legal edges,
    a third of them illegal and edge 0 among those (exact ties, the first
    legal edge first); game 1 all illegal; game 2 one legal edge, the
    last; the others the root prior's mix of a uniform prior with a
    Dirichlet(0.3) sample over random legal edges."""
    rng = np.random.default_rng(seed)
    legal = rng.random((B, A)) > 1 / 3
    legal[:, :2] = [False, True]
    legal[1] = False
    legal[2] = np.arange(A) == A - 1
    p = np.full((B, A), -1e30, np.float32)
    for b in range(B):
        k = int(legal[b].sum())
        if b == 0 or b == 2:
            p[b, legal[b]] = np.float32(1.0) / np.float32(k)
        elif k:
            p[b, legal[b]] = 0.75 / k + 0.25 * rng.dirichlet(np.full(k, 0.3))
    return torch.as_tensor(p)


MERGE_CASES = ("past_capacity", "terminal_link", "root_only", "ties_illegal", "lone_legal",
               "detached_link", "duplicate")


def merge_case(A: int, K: int, case: str, seed: int, C: int = 37, path_len: int = 4):
    """Synthetic planes, their own refresh (K=1) or refresh2 (K > 1) as the
    best planes (the merges' precondition), and a merge's records of
    ``case``, as ``run_search``/``run_rounds`` would make them: B=6 games,
    C nodes, paths of 1 to ``path_len`` edges from the root through
    distinct nodes below the install slots (``slot0 = C - 17``).

    * past_capacity: install slots at or past C install nothing
      (``run_search``'s exp_ok, ``run_rounds``' inst are 0 there), the
      paths still back up;
    * terminal_link: expansions into finished children, whose link code
      is -2-s and whose done/tval are 1 and +-1;
    * root_only: every path is the root's edge alone;
    * ties_illegal: all-zero n and w, so every legal edge of a column ties
      on its prior, with exact ties between two actions (33 and 40 at
      A > 40, 5 and 12 at A > 12, 2 and 5 at A > 5: actions of different
      lanes of the dense merges, and for the A <= 8 ones the second after
      the first in one lane's scan; 0 and 1 at A=2), illegal edges
      (-1e30) and an all-illegal node on the path;
    * lone_legal: beside game 1's all-illegal root, game 2's root has one
      legal edge, the last: it is the best edge, there is no runner-up
      (-1), and the A <= 8 top-2 leaves as its code the one its scan
      displaced (edge 0's), the dense one -1;
    * detached_link: the expanded parent is a node off every path (a
      descent always expands at a node of its own path; the merges still
      take any record, as their plain versions do);
    * duplicate (rounds): descent 1 expands the edge descent 0 expanded,
      installs nothing and still backs up its value."""
    rng = np.random.default_rng(seed)
    B = 6
    n = torch.as_tensor(rng.integers(0, 3, (B, A, C)).astype(np.float32))
    # +0 where unvisited: a search's planes never hold -0 (see hybrid.cu)
    w = torch.where(n > 0, torch.as_tensor((rng.integers(-2, 3, (B, A, C)) / 2).astype(np.float32)), 0.0)
    p = torch.full((B, A, C), 1.0 / A)
    p[:, 3::5] = -1e30
    code = torch.as_tensor(rng.integers(-3, C, (B, A, C)).astype(np.float32))
    if case == "ties_illegal":
        n.zero_()
        w.zero_()
        lo, hi = (33, 40) if A > 40 else (5, 12) if A > 12 else (2, 5) if A > 5 else (0, 1)
        p[:, lo] = p[:, hi] = 2.0 / A
    if case in ("ties_illegal", "lone_legal"):
        p[1, :, 0] = -1e30                     # an all-illegal root on every path of game 1
    if case == "lone_legal":
        p[2, :A - 1, 0] = -1e30                # game 2's root: its last edge alone is legal
    done, tval = torch.zeros(B, C), torch.zeros(B, C)
    best = list((hybrid.refresh2 if K > 1 else hybrid.refresh)(n, w, p, code, 1.25))
    # slots slot0 .. slot0 + K - 1; past the capacity: K=1 at C, a round's
    # first at C - 1 and the rest past it
    slot0 = (C if K == 1 else C - 1) if case == "past_capacity" else C - 17
    patha, psgn = torch.zeros(K, B, C), torch.zeros(K, B, C)
    meta2 = torch.zeros(K, B, 8)
    for b in range(B):
        for k in range(K):
            edges = 1 if case == "root_only" else int(rng.integers(1, path_len + 1))
            nodes = [0, *rng.choice(np.arange(1, slot0 - K), edges - 1, replace=False)]
            acts = rng.choice(np.flatnonzero(p[b, :, 0] > 0) if p[b, :, 0].max() > 0 else np.arange(A),
                              edges)
            if case == "duplicate" and k == 1:
                nodes, acts = [int(c) for c in np.flatnonzero(patha[0, b])], None
                acts = [int(patha[0, b, c]) - 1 for c in nodes]
            for i, (c, a) in enumerate(zip(nodes, acts)):
                patha[k, b, int(c)] = a + 1.0
                psgn[k, b, int(c)] = 1.0 if i % 2 == 0 else -1.0
            s = slot0 + k
            inst = float(s < C and not (case == "duplicate" and k == 1))
            cdone = float(case == "terminal_link")
            parent = slot0 - 1 if case == "detached_link" else nodes[-1]   # paths use nodes < slot0 - K
            meta2[k, b] = torch.tensor([
                float(rng.integers(-4, 5)) / 4, inst, s + cdone * (-2.0 - 2.0 * s), cdone,
                cdone * float(rng.choice([-1, 1])), float(parent), float(acts[-1]), 0.0])
    pm = torch.full((K, B, A), 1.0 / A)
    pm[..., 1::4] = -1e30
    if K == 1:
        return (n, w, p, code, done, tval, pm[0], patha[0], psgn[0], meta2[0], *best, slot0, 1.25)
    return (n, w, p, code, done, tval, pm, patha, psgn, meta2, *best, slot0, 1.25)


# ---- the outer loop on any game: arenas and coaches of both packages

def port_az_config(jcfg):
    """The port's copy of a JAX ``AZConfig``."""
    import dataclasses

    from alphazero_tpu_torch import config as port_config

    sub = {f.name: getattr(port_config, type(getattr(jcfg, f.name)).__name__)(
        **dataclasses.asdict(getattr(jcfg, f.name)))
        for f in dataclasses.fields(jcfg) if dataclasses.is_dataclass(getattr(jcfg, f.name))}
    rest = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name not in sub}
    return port_config.AZConfig(**sub, **rest)


def jax_arena_ties(seed: int, batch: int, actions: int, moves: int, gumbel: bool = False) -> list:
    """The JAX arena's tie uniforms of each move (``rng, k_tie =
    split(rng)``, then ``uniform(k_tie, [B, A])`` inside
    ``action_probs``), or with ``gumbel`` a Gumbel arena's root samples
    ``gumbel(k_tie, [B, A])``, as torch tensors."""
    key = jax.random.key(seed)
    draw = jax.random.gumbel if gumbel else jax.random.uniform
    out = []
    for _ in range(moves):
        key, k_tie = jax.random.split(key)
        out.append(torch.from_numpy(np.array(draw(k_tie, (batch, actions)))))
    return out


def arena_both(jgame, pgame, jax_cand, jax_inc, port_cand, port_inc, num_games, seed,
               jax_params=({}, {}), **cfg):
    """``(JAX ArenaResult as ints, port ArenaResult)`` of one arena on a
    game: the JAX ``make_arena_fn`` jitted on its apply_fns, the port's
    on its models with the JAX tie uniforms replayed. ``inc`` in ``cfg``
    gives the incumbent side its own search settings."""
    from alphazero_tpu.arena import make_arena_fn as jax_make_arena_fn
    from alphazero_tpu.config import MCTSConfig as JaxMCTSConfig
    from alphazero_tpu_torch.arena import ArenaResult, make_arena_fn
    from alphazero_tpu_torch.config import MCTSConfig

    inc_cfg = cfg.pop("inc", None)
    jcfg = JaxMCTSConfig(**cfg)
    jinc = None if inc_cfg is None else JaxMCTSConfig(**{**cfg, **inc_cfg})
    play = jax.jit(jax_make_arena_fn(jgame, jax_cand, jax_inc, jcfg, num_games, mcts_cfg_inc=jinc))
    want = ArenaResult(*(int(x) for x in play(*jax_params, jax.random.key(seed))))
    pinc = None if inc_cfg is None else MCTSConfig(**{**cfg, **inc_cfg})
    ties = jax_arena_ties(seed, num_games, pgame.num_actions, pgame.max_moves,
                          gumbel=cfg.get("gumbel", False))
    got = make_arena_fn(pgame, MCTSConfig(**cfg), num_games, mcts_cfg_inc=pinc, device="cpu")(
        port_cand, port_inc, lambda t: ties[t])
    return want, got


# the anchored pass of the Othello full preset's shape at a tiny size:
# continuous mode, a warmup pass of two anchor arenas, a pool cross match
OUTER_ARENA = dict(num_games=2, update_threshold=None, num_sims=2, anchor_interval=1,
                   anchor_warmup=1, anchor_warmup_mult=2, pool_cross_matches=1)


def outer_cfg(**arena):
    """A tiny JAX ``AZConfig`` for both packages' coaches: the fixed scan
    at the game's own length (every game finishes), the anchored pass of
    ``OUTER_ARENA`` updated by ``arena``."""
    from alphazero_tpu import config as C

    return C.AZConfig(
        mcts=C.MCTSConfig(num_sims=4, max_depth=8),
        selfplay=C.SelfPlayConfig(batch_size=2, temp_threshold=6),
        replay=C.ReplayConfig(capacity=1 << 14),
        train=C.TrainConfig(batch_size=16, steps_per_iteration=2),
        arena=C.ArenaConfig(**{**OUTER_ARENA, **arena}),
        seed=0,
    )


def coach_runs(jgame, pgame, iterations: int, hidden=(16,), **arena) -> tuple:
    """``(jax run, port run)``: each package's coach on
    ``outer_cfg(**arena)`` with an MLPNet of ``hidden``, ``iterations``
    iterations; a run holds the coach, its records and its match graph."""
    from alphazero_tpu.coach import Coach as JaxCoach
    from alphazero_tpu.models import MLPNet as JaxMLPNet
    from alphazero_tpu_torch.coach import Coach
    from alphazero_tpu_torch.models import MLPNet

    runs = []
    for make in (lambda: JaxCoach(jgame, JaxMLPNet(num_actions=jgame.num_actions, hidden=hidden),
                                  outer_cfg(**arena)),
                 lambda: Coach(pgame, MLPNet(pgame.num_actions, hidden=hidden,
                                             cells=pgame.feature_shape[0] * pgame.feature_shape[1]),
                               port_az_config(outer_cfg(**arena)), device="cpu")):
        torch.manual_seed(0)
        coach = make()
        records = [coach.run_iteration() for _ in range(iterations)]
        runs.append(types.SimpleNamespace(coach=coach, records=records,
                                          pool_matches=[dict(m) for m in coach.pool_matches]))
    return tuple(runs)


def check_record_keys(jax_run, port_run) -> None:
    assert [list(r) for r in port_run.records] == [list(r) for r in jax_run.records]
    for r in port_run.records:
        assert np.isfinite(r["loss_last"]) and r["eval_folded"] is False
        if "anchored_elo" in r:
            assert np.isfinite(r["anchored_elo"]) and r["anchored_elo_se"] > 0


def check_replay_holds_the_symmetries(run, symmetries: int) -> None:
    """Every game of the fixed scan finishes, so every move is a valid
    sample and enters the ring once per symmetry."""
    moves = 0
    for r in run.records:
        assert r["selfplay_truncated"] == 0 and r["selfplay_moves"] > 0
        moves += r["selfplay_moves"]
        assert r["replay_total"] == symmetries * moves


def check_continuous(jax_run, port_run) -> None:
    n = len(port_run.records)
    assert [r["accepted"] for r in port_run.records] == [True] * n
    assert [r["model_id"] for r in port_run.records] == list(range(1, n + 1))
    assert port_run.coach.elo.ratings.keys() == jax_run.coach.elo.ratings.keys()


def match_graph_shape(matches) -> list:
    return [(m["a"], m["b"], m["wins_a"] + m["wins_b"] + m["draws"]) for m in matches]


def check_match_graph(jax_run, port_run) -> None:
    """Players in order and each match's game total, the fitted players
    and the pool's generations."""
    assert match_graph_shape(port_run.pool_matches) == match_graph_shape(jax_run.pool_matches)
    assert port_run.coach.anchored_ratings.keys() == jax_run.coach.anchored_ratings.keys()
    assert port_run.coach.anchored_ratings["anchor"] == 0.0
    assert [g for g, _ in port_run.coach.pool] == [g for g, _ in jax_run.coach.pool]
