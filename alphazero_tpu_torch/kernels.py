"""Build, binding and launch wrappers of the hand-written CUDA kernels.

The kernels live in ``csrc/`` (see each source's header for what it
replaces and how it is designed): ``hybrid.cu`` holds the hybrid engine's
descend (one instance per game: Connect-Four, and Othello, Gomoku and Hex,
whose steps are in ``othello.cuh``, ``gomoku.cuh`` and ``hex.cuh``), merge
(unrolled for A <= 8, dense above) and the seed refresh of a fresh search
(one kernel for every A), and the same three for K>1 leaf-parallel rounds
(``descend_round`` per game, ``merge_round`` and the top-2 ``refresh2``),
``fused.cu`` the fused search kernels (the uniform evaluator's, and the
MLP's with the evaluator of ``mlp.cuh``, each at K=1 and in K>1
leaf-parallel rounds); both include the Connect-Four and
PUCT helpers of ``c4.cuh``; ``int8_tower.cu`` the fused int8 ResNet
tower of ``models/int8_tower.py`` (timed by
``experiments/int8_fused_tower.py``). At first use the sources are
compiled with ``nvcc`` for ``sm_90a``, one process per source, all
started together, and linked into one shared library with a plain C
interface under ``csrc/build/<hash of sources, header and flags>/``, which
is loaded with ``ctypes``; nothing is built when this module is imported.

Each wrapper takes tensors on ONE device:

* CPU tensors run the plain PyTorch version (``mcts/hybrid.py``,
  ``mcts/fused.py``, ``models/int8_tower.py``);
* CUDA tensors launch the kernel on the current stream, or raise — a
  failed build, a bad shape/dtype/layout or a launch error never falls
  back to the plain version.

``descend``, ``merge`` and ``refresh`` route a CUDA call to the kernel
instance that takes it: ``descend`` by the type of the game's flat ops
(``descend_entry``: Connect-Four's ``FlatOps`` its own kernel, then
``descend_othello``, ``descend_gomoku`` (boards of any edge: the 8-word
instance up to 512 cells, the 12-word one up to 768, the leaf-row one
above) and ``descend_hex``; any other type raises), ``merge`` and
``refresh`` by action count (A <= 8 their own kernels; above,
``merge_dense`` and ``refresh_dense``, whose instances keep a column in
registers up to ``DENSE_MERGE_MAX_A`` actions and stream it above).
``descend_round``, ``merge_round`` and ``refresh2`` route the same way (to
``descend_round_othello`` etc., ``merge_round_dense``,
``refresh2_dense``); they take any K >= 1 descents per round (the merges
stage the records in shared memory up to ``MAX_ROUND_K``; the descend
counts in shared-memory bytes up to K = 255 and ``ROUND_MAX_NODES`` nodes,
above in 32-bit counters in a global scratch that the wrapper allocates).
The merges update the search's best planes (``besta, bestc``, and ``seca,
secc`` in rounds) in place and rewrite only the columns the merge touched,
so they need those planes to be the refresh of the planes they are given,
as the seed ``refresh``/``refresh2`` and every merge leave them. The seeds
``refresh``/``refresh2`` (and ``refresh_dense``/``refresh2_dense``, where
they route A > 8) take only a fresh search's planes
(``mcts.hybrid._init_planes``), where every node but the root is empty:
they read the roots' priors alone, at every A. ``fused`` and
``fused_mlp`` run a whole search in one launch, and ``fused_rounds`` and
``fused_mlp_rounds`` the same in rounds of K descents ((K+1)^A < 2^24,
the JAX package's rule), on Connect-Four and, routed by the type of the
flat ops (``ops=``), on Gomoku boards of at most 16 cells
(``fused_gomoku``, ``fused_rounds_gomoku``); their MLP evaluator runs on
the bf16 tensor cores from weights in shared memory (``mlp_plan``:
resident for the launch or staged a layer at a time for Connect-Four's 1-4
layers of at most 256 units; streamed through a ring for every other
width, depth and board, ``fused_mlp_stream``, ``fused_mlp_stream_rounds``,
``mlp_eval_stream``), so its sums add in another order than the plain
version's k loop: bit-equal for weights whose sums are exact
(``models.order_free_mlp_variables``), within a bf16 rounding step of a
hidden unit otherwise. ``int8_tower`` runs the whole 11-conv int8 tower of
any B >= 1 games in one launch. Each wrapper counts the launches of its
own kernel in a plain integer attribute, ``descend.launches`` etc.;
``reset_launch_counts()`` zeroes them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from alphazero_tpu_torch.config import MCTSConfig
from alphazero_tpu_torch.games.connect_four import FlatOps
from alphazero_tpu_torch.games.gomoku import GomokuFlatOps
from alphazero_tpu_torch.games.hex import HexFlatOps
from alphazero_tpu_torch.games.othello import OthelloFlatOps
from alphazero_tpu_torch.mcts import fused as _plain_fused
from alphazero_tpu_torch.mcts import hybrid as _plain
from alphazero_tpu_torch.models import int8_tower as _plain_tower

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "hybrid.cu", _CSRC / "fused.cu", _CSRC / "int8_tower.cu")
HEADERS = (_CSRC / "c4.cuh", _CSRC / "gomoku.cuh", _CSRC / "hex.cuh", _CSRC / "mlp.cuh",
           _CSRC / "othello.cuh")
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "--fmad=false",          # no a*b+c contraction: bit-exact PUCT scores
    "-Xptxas", "-v",         # registers / spills into the build log
    "-Xcompiler", "-fPIC",
)

_VP, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# exported C functions of the library: (argument types, result type)
_SIGNATURES = {
    "az_error_string": ([_I32], ctypes.c_char_p),
    "az_descend": ([_VP] * 9 + [_I32] * 4 + [_VP], _I32),
    "az_descend_othello": ([_VP] * 9 + [_I32] * 4 + [_VP], _I32),
    "az_descend_gomoku": ([_VP] * 9 + [_I32] * 4 + [_VP], _I32),
    "az_descend_hex": ([_VP] * 9 + [_I32] * 4 + [_VP], _I32),
    "az_merge": ([_VP] * 12 + [_I32] * 4 + [_F32, _VP], _I32),
    "az_merge_dense": ([_VP] * 12 + [_I32] * 4 + [_F32, _VP], _I32),
    "az_refresh": ([_VP] * 6 + [_I32] * 3 + [_F32, _VP], _I32),
    "az_refresh_dense": ([_VP] * 6 + [_I32] * 3 + [_F32, _VP], _I32),
    "az_descend_round": ([_VP] * 12 + [_I32] * 5 + [_VP], _I32),
    "az_descend_round_othello": ([_VP] * 12 + [_I32] * 5 + [_VP], _I32),
    "az_descend_round_gomoku": ([_VP] * 12 + [_I32] * 5 + [_VP], _I32),
    "az_descend_round_hex": ([_VP] * 12 + [_I32] * 5 + [_VP], _I32),
    "az_descend_round_scratch": ([_I32] * 3, ctypes.c_longlong),
    "az_merge_round": ([_VP] * 14 + [_I32] * 5 + [_F32, _VP], _I32),
    "az_merge_round_dense": ([_VP] * 14 + [_I32] * 5 + [_F32, _VP], _I32),
    "az_refresh2": ([_VP] * 8 + [_I32] * 3 + [_F32, _VP], _I32),
    "az_refresh2_dense": ([_VP] * 8 + [_I32] * 3 + [_F32, _VP], _I32),
    "az_fused": ([_VP] * 5 + [_I32] * 4 + [_F32] * 2 + [_VP], _I32),
    "az_fused_mlp": ([_VP] * 6 + [_I32] * 9 + [_F32, _VP], _I32),
    "az_fused_rounds": ([_VP] * 6 + [_I32] * 5 + [_F32] * 2 + [_VP], _I32),
    "az_fused_mlp_rounds": ([_VP] * 7 + [_I32] * 10 + [_F32, _VP], _I32),
    "az_mlp_eval": ([_VP] * 5 + [_I32] * 6 + [_VP], _I32),
    "az_mlp_plan": ([_I32] * 5 + [ctypes.POINTER(ctypes.c_int)], _I32),
    "az_fused_leaf_bytes": ([], _I32),
    "az_fused_gomoku": ([_VP] * 3 + [_I32] + [_VP] * 3 + [_I32] * 5 + [_F32] * 2 + [_VP], _I32),
    "az_fused_gomoku_rounds": ([_VP] * 3 + [_I32] + [_VP] * 5 + [_I32] * 6 + [_F32] * 2 + [_VP],
                               _I32),
    "az_mlp_stream_plan": ([_I32] * 2 + [_VP, _I32, ctypes.POINTER(ctypes.c_longlong)], _I32),
    "az_fused_mlp_stream": ([_VP] * 4 + [_I32] + [_VP] * 4 + [_I32] + [_VP] * 3 + [_I32] * 5
                            + [_F32, _VP], _I32),
    "az_fused_mlp_stream_rounds": ([_VP] * 4 + [_I32] + [_VP] * 4 + [_I32] + [_VP] * 5
                                   + [_I32] * 6 + [_F32, _VP], _I32),
    "az_mlp_eval_stream": ([_VP] * 3 + [_I32] + [_VP] * 4 + [_I32] + [_VP] * 3 + [_I32] * 2 + [_VP],
                           _I32),
    "az_int8_tower": ([_VP] * 3 + [_I32, _VP], _I32),
}


class _Library:
    """The loaded kernel library and what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds
        self.build_log = log
        for fn, (args, res) in _SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res

    def check(self, rc: int, name: str) -> None:
        if rc != 0:
            msg = self.lib.az_error_string(rc).decode()
            raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")


_LIB: Optional[_Library] = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _build(out_dir: Path, so_path: Path) -> str:
    """Compile every source to an object, one nvcc process each, all
    started together; link the objects into ``so_path``. Returns the log."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        objs = [Path(work) / f"{src.stem}.o" for src in SOURCES]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        log = "".join(f"[{src.name}]\n{text}" for src, text in zip(SOURCES, logs))
        if any(proc.returncode != 0 for proc in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        tmp_so = Path(work) / so_path.name
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp_so), *map(str, objs)],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(tmp_so, so_path)   # atomic: concurrent builds agree
    return log


def library() -> _Library:
    """Build (once per sources/header/flags hash) and load the kernel
    library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    blob = b"".join(p.read_bytes() for p in (*SOURCES, *HEADERS))
    key = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_DIR / key
    so_path = out_dir / "libaz.so"
    log = ""
    t0 = time.perf_counter()
    if not so_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        log = _build(out_dir, so_path)
    seconds = time.perf_counter() - t0
    _LIB = _Library(ctypes.CDLL(str(so_path)), so_path, seconds, log)
    return _LIB


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU; False when all are on one CUDA
    device; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _check(name: str, t: torch.Tensor, shape, dtype=torch.float32) -> int:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# the descend kernel instance of each game's flat ops: the game's step is
# compiled into it (descend_kernel<Game> in csrc/hybrid.cu)
_DESCEND_ENTRIES = {
    FlatOps: "az_descend",
    OthelloFlatOps: "az_descend_othello",
    GomokuFlatOps: "az_descend_gomoku",
    HexFlatOps: "az_descend_hex",
}
DENSE_MERGE_MAX_A = 768     # the dense merges' widest in-register instance (24 actions a lane);
                            # above, the streamed one


def descend_entry(ops) -> str:
    """The entry of the descend kernel instance that steps boards as
    ``ops.step`` does, by the exact type of the flat ops (a subclass may
    step otherwise). Raises for any other type."""
    entry = _DESCEND_ENTRIES.get(type(ops))
    if entry is None:
        raise NotImplementedError(
            f"no descend kernel steps {type(ops).__name__} boards: the ported games' flat "
            f"ops are {', '.join(t.__name__ for t in _DESCEND_ENTRIES)}"
        )
    return entry


def _descend(entry: str, besta, bestc, done, tval, boards, max_depth: int, ops):
    """Launch the descend kernel ``entry`` on CUDA tensors, for boards of
    the game whose flat ops it steps."""
    if descend_entry(ops) != entry:
        raise ValueError(f"{entry} does not step {type(ops).__name__} boards")
    B, C = besta.shape
    L = ops.size
    if B == 0:
        raise ValueError("descend kernel needs B > 0")
    lib = library()
    ptrs = [
        _check("besta", besta, (B, C)), _check("bestc", bestc, (B, C)),
        _check("done", done, (B, C)), _check("tval", tval, (B, C)),
        _check("boards", boards, (B, L)),
    ]
    bd = torch.empty((B, L), device=boards.device)
    patha = torch.empty((B, C), device=boards.device)
    psgn = torch.empty((B, C), device=boards.device)
    meta = torch.empty((B, 8), device=boards.device)
    rc = getattr(lib.lib, entry)(
        *ptrs, bd.data_ptr(), patha.data_ptr(), psgn.data_ptr(), meta.data_ptr(),
        B, C, int(max_depth), L, _stream(boards.device),
    )
    lib.check(rc, entry)
    return bd, patha, psgn, meta


def _descend_instance(name: str, entry: str, doc: str):
    """The wrapper of one game's descend kernel instance: the plain
    version on the CPU; on CUDA the kernel, for its own game's flat ops
    only."""

    def wrapper(besta, bestc, done, tval, boards, max_depth: int, ops):
        if _on_cpu(besta, bestc, done, tval, boards):
            return _plain.descend(besta, bestc, done, tval, boards, max_depth, ops)
        out = _descend(entry, besta, bestc, done, tval, boards, max_depth, ops)
        wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    return wrapper


descend_othello = _descend_instance(
    "descend_othello", "az_descend_othello",
    "``mcts.hybrid.descend`` for Othello boards f32[B, 64].")
descend_gomoku = _descend_instance(
    "descend_gomoku", "az_descend_gomoku",
    "``mcts.hybrid.descend`` for Gomoku boards f32[B, S*S], any edge S.")
descend_hex = _descend_instance(
    "descend_hex", "az_descend_hex",
    "``mcts.hybrid.descend`` for canonical Hex boards f32[B, 49].")
_DESCEND_WRAPPERS = {
    "az_descend_othello": descend_othello,
    "az_descend_gomoku": descend_gomoku,
    "az_descend_hex": descend_hex,
}


def descend(besta, bestc, done, tval, boards, max_depth: int, ops):
    """``mcts.hybrid.descend``: on CUDA, the kernel instance of the game's
    flat ops (``descend_entry``): Connect-Four boards f32[B, 42] run this
    wrapper's own kernel, the other games ``descend_othello``,
    ``descend_gomoku`` and ``descend_hex``; unknown flat ops raise."""
    if _on_cpu(besta, bestc, done, tval, boards):
        return _plain.descend(besta, bestc, done, tval, boards, max_depth, ops)
    entry = descend_entry(ops)
    if entry != "az_descend":
        return _DESCEND_WRAPPERS[entry](besta, bestc, done, tval, boards, max_depth, ops)
    out = _descend("az_descend", besta, bestc, done, tval, boards, max_depth, ops)
    descend.launches += 1
    return out


def _merge(entry: str, n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc, slot: int,
           cpuct: float):
    """Launch the merge kernel ``entry`` on CUDA tensors."""
    B, A, C = n.shape
    if B == 0:
        raise ValueError("merge kernel needs B > 0")
    lib = library()
    ptrs = [
        _check("n", n, (B, A, C)), _check("w", w, (B, A, C)),
        _check("p", p, (B, A, C)), _check("code", code, (B, A, C)),
        _check("done", done, (B, C)), _check("tval", tval, (B, C)),
        _check("pm", pm, (B, A)), _check("patha", patha, (B, C)),
        _check("psgn", psgn, (B, C)), _check("meta2", meta2, (B, 8)),
        _check("besta", besta, (B, C)), _check("bestc", bestc, (B, C)),
    ]
    rc = getattr(lib.lib, entry)(*ptrs, B, A, C, int(slot), float(cpuct), _stream(n.device))
    lib.check(rc, entry)
    return besta, bestc


def _check_seed_actions(name: str, A: int) -> None:
    """The dense seeds take what the dense refresh takes: the engines send
    it A > 8, and the empty node's constant row needs a runner-up edge."""
    if A < 2:
        raise ValueError(f"{name} takes A >= 2 actions, got {A}")


def merge(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc, slot: int, cpuct: float):
    """``mcts.hybrid.merge``: in place on ``n, w, p, code, done, tval`` and
    the best planes ``besta, bestc``, which it returns. On CUDA, A <= 8 runs
    this wrapper's kernel and larger A ``merge_dense``; both read and
    refresh only the columns the merge writes, so on entry ``besta, bestc``
    must be the refresh of the planes given (the plain version refreshes
    every node)."""
    args = (n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc)
    if _on_cpu(*args):
        return _plain.merge(*args, slot, cpuct)
    if n.shape[1] > _plain.UNROLLED_MAX_A:
        return merge_dense(*args, slot, cpuct)
    out = _merge("az_merge", *args, slot, cpuct)
    merge.launches += 1
    return out


def merge_dense(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc, slot: int,
                cpuct: float):
    """``mcts.hybrid.merge`` with the dense refresh, for any A (the main
    path sends it A > 8; above ``DENSE_MERGE_MAX_A`` the kernel streams a
    column in chunks). The kernel reads and refreshes only the columns
    the merge writes (path nodes, the install slot, the expanded parent)
    and leaves every other node's best planes as they are: on entry
    ``besta, bestc`` must be the refresh of the entry planes, as the
    search's seed refresh and every merge leave them."""
    args = (n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc)
    if _on_cpu(*args):
        return _plain.merge(*args, slot, cpuct)
    out = _merge("az_merge_dense", *args, slot, cpuct)
    merge_dense.launches += 1
    return out


def _refresh(entry: str, n, w, p, code, cpuct: float):
    """Launch the seed kernel ``entry`` on CUDA tensors: a fresh search's
    planes (``mcts.hybrid._init_planes``), of which it reads only the
    roots' priors ``p[:, :, 0]``."""
    B, A, C = n.shape
    if B == 0:
        raise ValueError("refresh kernel needs B > 0")
    lib = library()
    ptrs = [
        _check("n", n, (B, A, C)), _check("w", w, (B, A, C)),
        _check("p", p, (B, A, C)), _check("code", code, (B, A, C)),
    ]
    besta = torch.empty((B, C), device=n.device)
    bestc = torch.empty((B, C), device=n.device)
    rc = getattr(lib.lib, entry)(
        *ptrs, besta.data_ptr(), bestc.data_ptr(), B, A, C, float(cpuct), _stream(n.device)
    )
    lib.check(rc, entry)
    return besta, bestc


def refresh(n, w, p, code, cpuct: float):
    """``mcts.hybrid.refresh``, the PUCT argmax planes of every node, as
    the seed of a fresh search: on CUDA, A <= 8 runs this wrapper's kernel
    and larger A ``refresh_dense``, and both take only the planes
    ``mcts.hybrid._init_planes`` leaves (see ``refresh_dense``). The
    kernel reads only the roots' priors and writes every other node's row
    as the empty node's constant ``(0, -1)``, so on other planes its result
    is not the refresh. Nothing checks the planes here (it would
    synchronise with the card)."""
    if _on_cpu(n, w, p, code):
        return _plain.refresh(n, w, p, code, cpuct)
    if n.shape[1] > _plain.UNROLLED_MAX_A:
        return refresh_dense(n, w, p, code, cpuct)
    out = _refresh("az_refresh", n, w, p, code, cpuct)
    refresh.launches += 1
    return out


def refresh_dense(n, w, p, code, cpuct: float):
    """``mcts.hybrid.refresh``'s dense branch as a kernel, A >= 2 (the
    main path sends it A > 8), for the seed of a fresh search: the
    planes must be as ``mcts.hybrid._init_planes`` leaves them, the roots'
    priors in ``p[:, :, 0]`` and ``n = w = p = 0``, ``code = -1``
    everywhere else. There the kernel's planes are bit-equal to the plain
    full refresh's; it reads only the roots' priors (every other node is
    the empty node, whose refresh is the constant ``(0, -1)``), so on other
    planes its result is not the refresh."""
    if _on_cpu(n, w, p, code):
        return _plain.refresh(n, w, p, code, cpuct)
    _check_seed_actions("refresh_dense", n.shape[1])
    out = _refresh("az_refresh_dense", n, w, p, code, cpuct)
    refresh_dense.launches += 1
    return out


MAX_ROUND_K = 16          # csrc/hybrid.cu kMaxRoundK: round records a merge stages at once
ROUND_MAX_NODES = 29056   # the byte-counter round descend: 2 x C bytes a game, 4 games a block


def _check_round_k(K: int) -> None:
    """A round takes K >= 1 descents; that K divides ``num_sims`` is the
    engine's check (``mcts.hybrid.make_hybrid_root_fn``), as in JAX."""
    if K < 1:
        raise ValueError(f"the round kernels take K >= 1 descents, got {K}")


def _descend_round(entry: str, besta, bestc, seca, secc, done, tval, boards, max_depth: int, ops,
                   K: int):
    """Launch the round descend kernel ``entry`` on CUDA tensors, for
    boards of the game whose flat ops it steps."""
    if _DESCEND_ROUND_ENTRIES[descend_entry(ops)] != entry:
        raise ValueError(f"{entry} does not step {type(ops).__name__} boards")
    B, C = besta.shape
    L = ops.size
    if B == 0:
        raise ValueError("descend_round kernel needs B > 0")
    _check_round_k(K)
    lib = library()
    ptrs = [
        _check("besta", besta, (B, C)), _check("bestc", bestc, (B, C)),
        _check("seca", seca, (B, C)), _check("secc", secc, (B, C)),
        _check("done", done, (B, C)), _check("tval", tval, (B, C)),
        _check("boards", boards, (B, L)),
    ]
    dev = boards.device
    bd = torch.empty((K, B, L), device=dev)
    patha = torch.empty((K, B, C), device=dev)
    psgn = torch.empty((K, B, C), device=dev)
    meta = torch.empty((K, B, 8), device=dev)
    # the 32-bit counters past the byte ones (zeroed by the kernel)
    counters = lib.lib.az_descend_round_scratch(B, C, int(K))
    scratch = torch.empty(counters, dtype=torch.int32, device=dev) if counters else None
    rc = getattr(lib.lib, entry)(
        *ptrs, bd.data_ptr(), patha.data_ptr(), psgn.data_ptr(), meta.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        B, C, int(K), int(max_depth), L, _stream(dev),
    )
    lib.check(rc, entry)
    return bd, patha, psgn, meta


def _descend_round_instance(name: str, entry: str, doc: str):
    """The wrapper of one game's round descend instance: the plain
    version on the CPU; on CUDA the kernel, for its own game's flat ops
    only."""

    def wrapper(besta, bestc, seca, secc, done, tval, boards, max_depth: int, ops, K: int):
        args = (besta, bestc, seca, secc, done, tval, boards)
        if _on_cpu(*args):
            return _plain.descend_round(*args, max_depth, ops, K)
        out = _descend_round(entry, *args, max_depth, ops, K)
        wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    return wrapper


# the round descend instance of each game, by its K=1 descend's entry
_DESCEND_ROUND_ENTRIES = {entry: entry.replace("az_descend", "az_descend_round")
                          for entry in _DESCEND_ENTRIES.values()}
descend_round_othello = _descend_round_instance(
    "descend_round_othello", "az_descend_round_othello",
    "``mcts.hybrid.descend_round`` for Othello boards f32[B, 64].")
descend_round_gomoku = _descend_round_instance(
    "descend_round_gomoku", "az_descend_round_gomoku",
    "``mcts.hybrid.descend_round`` for Gomoku boards f32[B, S*S], any edge S.")
descend_round_hex = _descend_round_instance(
    "descend_round_hex", "az_descend_round_hex",
    "``mcts.hybrid.descend_round`` for canonical Hex boards f32[B, 49].")
_DESCEND_ROUND_WRAPPERS = {
    "az_descend_round_othello": descend_round_othello,
    "az_descend_round_gomoku": descend_round_gomoku,
    "az_descend_round_hex": descend_round_hex,
}


def descend_round(besta, bestc, seca, secc, done, tval, boards, max_depth: int, ops, K: int):
    """``mcts.hybrid.descend_round``, routed as ``descend`` is: on CUDA the
    round instance of the game's flat ops — Connect-Four boards f32[B, 42]
    run this wrapper's own kernel, the other games
    ``descend_round_othello``, ``descend_round_gomoku`` and
    ``descend_round_hex``; unknown flat ops raise."""
    args = (besta, bestc, seca, secc, done, tval, boards)
    if _on_cpu(*args):
        return _plain.descend_round(*args, max_depth, ops, K)
    entry = _DESCEND_ROUND_ENTRIES[descend_entry(ops)]
    if entry != "az_descend_round":
        return _DESCEND_ROUND_WRAPPERS[entry](*args, max_depth, ops, K)
    out = _descend_round("az_descend_round", *args, max_depth, ops, K)
    descend_round.launches += 1
    return out


def _merge_round(entry: str, n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc,
                 seca, secc, slot0: int, cpuct: float):
    """Launch the round merge kernel ``entry`` on CUDA tensors."""
    B, A, C = n.shape
    K = patha.shape[0]
    if B == 0:
        raise ValueError("merge_round kernel needs B > 0")
    _check_round_k(K)
    lib = library()
    ptrs = [
        _check("n", n, (B, A, C)), _check("w", w, (B, A, C)),
        _check("p", p, (B, A, C)), _check("code", code, (B, A, C)),
        _check("done", done, (B, C)), _check("tval", tval, (B, C)),
        _check("pm", pm, (K, B, A)), _check("patha", patha, (K, B, C)),
        _check("psgn", psgn, (K, B, C)), _check("meta2", meta2, (K, B, 8)),
        _check("besta", besta, (B, C)), _check("bestc", bestc, (B, C)),
        _check("seca", seca, (B, C)), _check("secc", secc, (B, C)),
    ]
    rc = getattr(lib.lib, entry)(*ptrs, B, A, C, K, int(slot0), float(cpuct), _stream(n.device))
    lib.check(rc, entry)
    return besta, bestc, seca, secc


def merge_round(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc, seca, secc,
                slot0: int, cpuct: float):
    """``mcts.hybrid.merge_round``: in place on ``n, w, p, code, done,
    tval`` and the top-2 planes ``besta, bestc, seca, secc``, which it
    returns. On CUDA, A <= 8 runs this wrapper's kernel and larger A
    ``merge_round_dense``; both read and refresh only the columns the K
    records write, so on entry the top-2 planes must be the refresh2 of the
    planes given (the plain version refreshes every node)."""
    args = (n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc, seca, secc)
    if _on_cpu(*args):
        return _plain.merge_round(*args, slot0, cpuct)
    if n.shape[1] > _plain.UNROLLED_MAX_A:
        return merge_round_dense(*args, slot0, cpuct)
    out = _merge_round("az_merge_round", *args, slot0, cpuct)
    merge_round.launches += 1
    return out


def merge_round_dense(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc, seca, secc,
                      slot0: int, cpuct: float):
    """``mcts.hybrid.merge_round`` with the dense top-2 refresh, for any A
    and K (the main path sends it A > 8; above ``DENSE_MERGE_MAX_A`` or
    ``MAX_ROUND_K`` the kernel streams). Like ``merge_dense`` it reads and
    refreshes only the columns the K records write: on entry the top-2
    planes must be the ``refresh2`` of the entry planes."""
    args = (n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc, seca, secc)
    if _on_cpu(*args):
        return _plain.merge_round(*args, slot0, cpuct)
    out = _merge_round("az_merge_round_dense", *args, slot0, cpuct)
    merge_round_dense.launches += 1
    return out


def _refresh2(entry: str, n, w, p, code, cpuct: float):
    """Launch the top-2 seed kernel ``entry`` on CUDA tensors, under
    ``_refresh``'s precondition."""
    B, A, C = n.shape
    if B == 0:
        raise ValueError("refresh2 kernel needs B > 0")
    lib = library()
    ptrs = [
        _check("n", n, (B, A, C)), _check("w", w, (B, A, C)),
        _check("p", p, (B, A, C)), _check("code", code, (B, A, C)),
    ]
    best = [torch.empty((B, C), device=n.device) for _ in range(4)]
    rc = getattr(lib.lib, entry)(
        *ptrs, *(t.data_ptr() for t in best), B, A, C, float(cpuct), _stream(n.device)
    )
    lib.check(rc, entry)
    return tuple(best)


def refresh2(n, w, p, code, cpuct: float):
    """``mcts.hybrid.refresh2``, the top-2 PUCT planes of every node, as
    the seed of a fresh round search: on CUDA, A <= 8 runs this wrapper's
    kernel and larger A ``refresh2_dense``, both under ``refresh``'s
    precondition (a fresh search's planes), where the kernels' four planes
    are bit-equal to the plain full refresh2's (every node but the root:
    ``(0, -1, 1, -1)``, at A = 1 ``(0, -1, -1, -1)``)."""
    if _on_cpu(n, w, p, code):
        return _plain.refresh2(n, w, p, code, cpuct)
    if n.shape[1] > _plain.UNROLLED_MAX_A:
        return refresh2_dense(n, w, p, code, cpuct)
    out = _refresh2("az_refresh2", n, w, p, code, cpuct)
    refresh2.launches += 1
    return out


def refresh2_dense(n, w, p, code, cpuct: float):
    """``mcts.hybrid.refresh2``'s dense branch as a kernel, A >= 2 (the
    main path sends it A > 8), for the seed of a fresh round search:
    the precondition of ``refresh_dense``, under which its four planes are
    bit-equal to the plain full refresh2's (every node but the root: ``(0,
    -1, 1, -1)``)."""
    if _on_cpu(n, w, p, code):
        return _plain.refresh2(n, w, p, code, cpuct)
    _check_seed_actions("refresh2_dense", n.shape[1])
    out = _refresh2("az_refresh2_dense", n, w, p, code, cpuct)
    refresh2_dense.launches += 1
    return out


FUSED_MAX_K = 9   # csrc/fused.cu kMaxRoundK: (K+1)^7 < 2^24, the JAX package's limit at A=7
SMALL_GOMOKU_CELLS = 16    # csrc/fused.cu kMaxSmallCells: the Gomoku boards the fused kernels take
RESIDENT_MAX_HIDDEN = 4    # the resident/staged evaluator plan (csrc/mlp.cuh kMaxHidden) ...
RESIDENT_MAX_WIDTH = 256   # ... and its widest layer (kMaxWidth); other MLPs stream


def _fused_game(ops) -> Tuple[int, int, bool]:
    """``(A, L, gomoku)`` of the fused kernels' game of the flat ops
    ``ops`` (None: Connect-Four), by the exact type of the flat ops, as
    ``descend_entry`` routes: Connect-Four's ``FlatOps`` and
    ``GomokuFlatOps`` boards of at most ``SMALL_GOMOKU_CELLS`` cells. Raises
    for anything else."""
    if ops is None or type(ops) is FlatOps:
        return 7, 42, False
    if type(ops) is GomokuFlatOps and ops.size <= SMALL_GOMOKU_CELLS:
        return ops.num_actions, ops.size, True
    raise NotImplementedError(
        f"no fused kernel steps {type(ops).__name__} boards of {getattr(ops, 'size', '?')} "
        f"cells: the fused kernels take Connect-Four's FlatOps and GomokuFlatOps of at most "
        f"{SMALL_GOMOKU_CELLS} cells (the JAX fused kernel's A <= 16)"
    )


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A small host tensor on ``device``; a CUDA copy goes through pinned
    memory, so that it does not wait for the work queued before it."""
    device = torch.device(device)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def _gomoku_lines(ops, device) -> torch.Tensor:
    """The win lines of a small Gomoku board as cell masks, int32[n_lines]
    on ``device`` (bit i: cell i), from the flat ops' win-line matrix (its
    zero padding columns dropped)."""
    m = ops.aux("cpu")
    m = m[:, m.sum(dim=0) > 0].t().to(torch.int64)
    return _to_device((m << torch.arange(ops.size)).sum(dim=1).to(torch.int32), device)


def _fused_buffers(name: str, boards, priors, nodes: int, rounds: bool, ops=None) -> tuple:
    """The checked addresses of flat boards f32[B, L] and masked root
    priors f32[B, A] of the game of ``ops`` (``_fused_game``), and a fused
    launch's fresh scratch and outputs: ``(B, ptrs, scratch, counts,
    rootw)``, ``scratch`` the tree f32[B, C, 4 R] (R = 8 record cells for
    Connect-Four, A + 1 for Gomoku) and, for rounds, the round records
    f32[B, C, 2 R]."""
    A, L, gomoku = _fused_game(ops)
    rec = A + 1 if gomoku else 8
    B = boards.shape[0]
    if B == 0:
        raise ValueError(f"{name} kernel needs B > 0")
    if nodes < 1:
        raise ValueError(f"{name} kernel needs nodes >= 1, got {nodes}")
    ptrs = [_check("boards", boards, (B, L)), _check("priors", priors, (B, A))]
    dev = boards.device
    scratch = [torch.empty((B, nodes, 4 * rec), device=dev)]
    if rounds:
        scratch.append(torch.empty((B, nodes, 2 * rec), device=dev))
    return B, ptrs, scratch, torch.empty((B, A), device=dev), torch.empty((B, A), device=dev)


def _leaf_scratch(lib: _Library, B: int, K: int, device) -> torch.Tensor:
    """The rounds' leaf scratch of the Gomoku and streamed kernels: K
    leaves a game for every game of the grid (B rounded up to a block of
    32)."""
    games = -(-B // 32) * 32
    return torch.empty(games * K * lib.lib.az_fused_leaf_bytes(), dtype=torch.uint8, device=device)


def _check_rounds(name: str, num_sims: int, K: int, A: int = 7) -> None:
    """The JAX package's rules for K > 1 rounds: ``num_sims`` divisible by
    K, and ``(K+1)**A < 2**24`` (K <= ``FUSED_MAX_K`` at Connect-Four's A =
    7)."""
    if K < 1 or (K + 1) ** A >= 1 << 24:
        raise ValueError(f"{name} takes 1 <= K with (K+1)^A < 2^24 descents per round "
                         f"(K <= {FUSED_MAX_K} at A=7), got K={K} at A={A}")
    if num_sims % K != 0:
        raise ValueError(f"{name}: num_sims={num_sims} must be divisible by K={K}")


def _search_cfg(num_sims: int, nodes: int, max_depth: int, cpuct: float, K: int = 1) -> MCTSConfig:
    return MCTSConfig(num_sims=num_sims, max_nodes=nodes, max_depth=max_depth, cpuct=cpuct,
                      parallel_sims=K)


def fused(boards, priors, num_sims: int, nodes: int, max_depth: int, cpuct: float, uval: float,
          ops=None):
    """``mcts.fused.fused_search``: a whole uniform-prior search of flat
    boards f32[B, L] from masked root priors f32[B, A] in one launch, on
    the game of ``ops`` (None: Connect-Four; Gomoku boards of at most 16
    cells route to ``fused_gomoku``). Returns ``(counts, rootw) f32[B,
    A]``."""
    if _fused_game(ops)[2]:
        return fused_gomoku(boards, priors, num_sims, nodes, max_depth, cpuct, uval, ops)
    if _on_cpu(boards, priors):
        return _plain_fused.fused_search(boards, priors, _search_cfg(num_sims, nodes, max_depth, cpuct),
                                         uval)
    lib = library()
    B, ptrs, scratch, counts, rootw = _fused_buffers("fused", boards, priors, nodes, False)
    rc = lib.lib.az_fused(
        *ptrs, *(t.data_ptr() for t in (*scratch, counts, rootw)),
        B, int(nodes), int(num_sims), int(max_depth), float(cpuct), float(uval),
        _stream(boards.device),
    )
    lib.check(rc, "fused")
    fused.launches += 1
    return counts, rootw


def fused_gomoku(boards, priors, num_sims: int, nodes: int, max_depth: int, cpuct: float,
                 uval: float, ops):
    """``fused`` on a Gomoku board of at most 16 cells (``ops``, its
    ``GomokuFlatOps``): ``az_fused_gomoku``, G lanes a game."""
    A, _, gomoku = _fused_game(ops)
    if not gomoku:
        raise ValueError("fused_gomoku takes GomokuFlatOps")
    if _on_cpu(boards, priors):
        return _plain_fused.fused_search(
            boards, priors, _search_cfg(num_sims, nodes, max_depth, cpuct), uval, ops)
    lib = library()
    B, ptrs, scratch, counts, rootw = _fused_buffers("fused_gomoku", boards, priors, nodes, False, ops)
    lines = _gomoku_lines(ops, boards.device)
    rc = lib.lib.az_fused_gomoku(
        *ptrs, lines.data_ptr(), lines.numel(), *(t.data_ptr() for t in (*scratch, counts, rootw)),
        B, int(nodes), A, int(num_sims), int(max_depth), float(cpuct), float(uval),
        _stream(boards.device),
    )
    lib.check(rc, "fused_gomoku")
    fused_gomoku.launches += 1
    return counts, rootw


def fused_rounds(boards, priors, num_sims: int, nodes: int, max_depth: int, cpuct: float,
                 uval: float, K: int, ops=None):
    """``mcts.fused.fused_rounds_search``: ``fused`` in ``num_sims // K``
    rounds of K leaf-parallel descents, (K+1)^A < 2^24, in one launch
    (Gomoku routes to ``fused_rounds_gomoku``). Returns ``(counts, rootw)
    f32[B, A]``."""
    if _fused_game(ops)[2]:
        return fused_rounds_gomoku(boards, priors, num_sims, nodes, max_depth, cpuct, uval, K, ops)
    _check_rounds("fused_rounds", num_sims, K)
    if _on_cpu(boards, priors):
        return _plain_fused.fused_rounds_search(
            boards, priors, _search_cfg(num_sims, nodes, max_depth, cpuct, K), uval)
    lib = library()
    B, ptrs, scratch, counts, rootw = _fused_buffers("fused_rounds", boards, priors, nodes, True)
    rc = lib.lib.az_fused_rounds(
        *ptrs, *(t.data_ptr() for t in (*scratch, counts, rootw)),
        B, int(nodes), int(K), int(num_sims), int(max_depth), float(cpuct), float(uval),
        _stream(boards.device),
    )
    lib.check(rc, "fused_rounds")
    fused_rounds.launches += 1
    return counts, rootw


def fused_rounds_gomoku(boards, priors, num_sims: int, nodes: int, max_depth: int, cpuct: float,
                        uval: float, K: int, ops):
    """``fused_rounds`` on a Gomoku board of at most 16 cells:
    ``az_fused_gomoku_rounds`` (leaves past K = 9 in a device scratch)."""
    A, _, gomoku = _fused_game(ops)
    if not gomoku:
        raise ValueError("fused_rounds_gomoku takes GomokuFlatOps")
    _check_rounds("fused_rounds_gomoku", num_sims, K, A)
    if _on_cpu(boards, priors):
        return _plain_fused.fused_rounds_search(
            boards, priors, _search_cfg(num_sims, nodes, max_depth, cpuct, K), uval, ops)
    lib = library()
    B, ptrs, scratch, counts, rootw = _fused_buffers("fused_rounds_gomoku", boards, priors, nodes,
                                                     True, ops)
    lines = _gomoku_lines(ops, boards.device)
    leaves = _leaf_scratch(lib, B, K, boards.device) if K > FUSED_MAX_K else None
    rc = lib.lib.az_fused_gomoku_rounds(
        *ptrs, lines.data_ptr(), lines.numel(), *(t.data_ptr() for t in scratch),
        leaves.data_ptr() if leaves is not None else None, counts.data_ptr(), rootw.data_ptr(),
        B, int(nodes), A, int(K), int(num_sims), int(max_depth), float(cpuct), float(uval),
        _stream(boards.device),
    )
    lib.check(rc, "fused_rounds_gomoku")
    fused_rounds_gomoku.launches += 1
    return counts, rootw


def _check_sections(weights, A: int, L: int) -> list:
    """Every section's address after checking its dtype, shape and
    contiguity: the hidden layers' bf16 [in, out] and [out] (in = 2 L for
    the first), the head f32 [last, A + 1] and [A + 1]."""
    hidden = tuple(weights.hidden)
    widths = (2 * L, *hidden)
    shapes = [s for k, h in zip(widths, hidden) for s in ((k, h), (h,))]
    dtypes = [torch.bfloat16] * len(shapes) + [torch.float32] * 2
    shapes += [(widths[-1], A + 1), (A + 1,)]   # the head: A logits | the value
    sections = weights.sections()
    if len(sections) != len(shapes):
        raise ValueError(f"expected {len(shapes)} weight sections, got {len(sections)}")
    return [_check(f"weight section {i}", t, shape, dtype)
            for i, (t, shape, dtype) in enumerate(zip(sections, shapes, dtypes))]


def _resident_takes(hidden, cells: int = 42, actions: int = 7) -> bool:
    """Whether the resident/staged evaluator plan takes an MLP of hidden
    widths ``hidden`` on boards of ``cells`` cells and ``actions`` actions:
    Connect-Four's, 1 to ``RESIDENT_MAX_HIDDEN`` hidden layers of 1 to
    ``RESIDENT_MAX_WIDTH`` units. Every other MLP streams."""
    hidden = tuple(hidden)
    return ((cells, actions) == (42, 7) and 1 <= len(hidden) <= RESIDENT_MAX_HIDDEN
            and all(1 <= h <= RESIDENT_MAX_WIDTH for h in hidden))


def _resident(weights, ops=None) -> bool:
    """``_resident_takes`` for ``MLPKernelWeights`` on the game of ``ops``."""
    A, L, _ = _fused_game(ops)
    return _resident_takes(weights.hidden, L, A)


def _mlp_args(weights) -> list:
    """The resident/staged kernels' ``sections, n_hidden, h0..h3`` for
    ``MLPKernelWeights`` of a Connect-Four MLP the plan takes
    (``sections``: a host array of each section's device address), after
    checking every section's dtype, shape and contiguity."""
    hidden = tuple(weights.hidden)
    if not _resident(weights):
        raise ValueError(f"the resident/staged evaluator takes 1 to {RESIDENT_MAX_HIDDEN} hidden "
                         f"layers of 1 to {RESIDENT_MAX_WIDTH} units, got {hidden}: it streams")
    ptrs = _check_sections(weights, 7, 42)
    return [(_VP * len(ptrs))(*ptrs), len(hidden), *hidden,
            *[0] * (RESIDENT_MAX_HIDDEN - len(hidden))]


class MlpPlan(NamedTuple):
    """The in-kernel evaluator's plan of an MLP (``csrc/mlp.cuh``):
    ``kind`` "resident" (every layer's weights in shared memory for the
    launch), "staged" (a layer at a time through one buffer at every
    evaluation) or "streamed" (any widths and depth: passes of 256 columns,
    the weights through a two-slot ring); the dynamic shared bytes of a
    launch; and the activation scratch a block of 32 games needs in device
    memory (0: the activations stay in shared memory)."""

    kind: str
    smem_bytes: int
    act_block_bytes: int


def mlp_plan(hidden, lib: Optional[_Library] = None, cells: int = 42,
             actions: int = 7) -> MlpPlan:
    """The in-kernel evaluator's plan for an MLP of hidden widths
    ``hidden`` on boards of ``cells`` cells and ``actions`` actions
    (Connect-Four's by default; another board streams). ``lib``: the
    kernel library to ask (default ``library()``)."""
    hidden = tuple(int(h) for h in hidden)
    lib = lib or library()
    if _resident_takes(hidden, cells, actions):
        resident = ctypes.c_int()
        nbytes = lib.lib.az_mlp_plan(len(hidden), *hidden,
                                     *[0] * (RESIDENT_MAX_HIDDEN - len(hidden)),
                                     ctypes.byref(resident))
        return MlpPlan("resident" if resident.value else "staged", nbytes, 0)
    return _stream_plan(lib, hidden, cells, actions)


def _stream_plan(lib: _Library, hidden: Tuple[int, ...], cells: int, actions: int) -> MlpPlan:
    act = ctypes.c_longlong()
    hid = (_I32 * max(len(hidden), 1))(*hidden)
    nbytes = lib.lib.az_mlp_stream_plan(cells, actions + 1, hid, len(hidden), ctypes.byref(act))
    return MlpPlan("streamed", nbytes, act.value)


def _stream_args(lib: _Library, weights, ops, B: int) -> tuple:
    """The streamed kernels' ``layers, hidden, n_hidden, wh, bh, act,
    lines, n_lines`` for ``MLPKernelWeights`` on the game of ``ops``, and
    the device tensors behind them (kept alive through the launch): the
    hidden layers' descriptors (int64 [n_hidden, 3]: w, b, k | n << 32), the
    activation scratch where the plan needs one, the win lines (Gomoku)."""
    A, L, gomoku = _fused_game(ops)
    ptrs = _check_sections(weights, A, L)
    hidden = tuple(weights.hidden)
    dev = weights.wh.device
    widths = (2 * L, *hidden)
    rows = [[ptrs[2 * i], ptrs[2 * i + 1], widths[i] | h << 32] for i, h in enumerate(hidden)]
    layers = _to_device(torch.tensor(rows or [[0, 0, 0]], dtype=torch.int64), dev)
    hid = (_I32 * max(len(hidden), 1))(*hidden)
    plan = _stream_plan(lib, hidden, L, A)
    act = None
    if plan.act_block_bytes:
        act = torch.empty(-(-B // 32) * plan.act_block_bytes, dtype=torch.uint8, device=dev)
    lines = _gomoku_lines(ops, dev) if gomoku else None
    args = [layers.data_ptr(), hid, len(hidden), ptrs[-2], ptrs[-1],
            act.data_ptr() if act is not None else None,
            lines.data_ptr() if lines is not None else None,
            lines.numel() if lines is not None else 0]
    return args, (layers, act, lines)


def fused_mlp(boards, priors, weights, num_sims: int, nodes: int, max_depth: int, cpuct: float,
              ops=None):
    """``mcts.fused.fused_mlp_search``: a whole search of flat boards
    f32[B, L] from masked root priors f32[B, A] with the MLP of ``weights``
    (``MLPKernelWeights``) evaluated inside the kernel, in one launch, on
    the game of ``ops`` (None: Connect-Four). A Connect-Four MLP of 1 to 4
    hidden layers of at most 256 units runs ``az_fused_mlp`` (the resident
    or staged plan); every other, Gomoku's too, ``fused_mlp_stream``.
    Returns ``(counts, rootw) f32[B, A]``."""
    if not _resident(weights, ops):
        return fused_mlp_stream(boards, priors, weights, num_sims, nodes, max_depth, cpuct, ops)
    on_cpu = _on_cpu(boards, priors, *weights.sections())
    sections, *widths = _mlp_args(weights)
    if on_cpu:
        return _plain_fused.fused_mlp_search(
            boards, priors, _search_cfg(num_sims, nodes, max_depth, cpuct), weights)
    lib = library()
    B, ptrs, scratch, counts, rootw = _fused_buffers("fused_mlp", boards, priors, nodes, False)
    rc = lib.lib.az_fused_mlp(
        *ptrs, sections, *(t.data_ptr() for t in (*scratch, counts, rootw)),
        B, int(nodes), int(num_sims), int(max_depth), *widths, float(cpuct),
        _stream(boards.device),
    )
    lib.check(rc, "fused_mlp")
    fused_mlp.launches += 1
    return counts, rootw


def fused_mlp_stream(boards, priors, weights, num_sims: int, nodes: int, max_depth: int,
                     cpuct: float, ops=None):
    """``fused_mlp`` with the streamed evaluator (any widths and depth, no
    hidden layer too), on Connect-Four (``ops`` None) or a Gomoku board of
    at most 16 cells: ``az_fused_mlp_stream``."""
    A, L, _ = _fused_game(ops)
    on_cpu = _on_cpu(boards, priors, *weights.sections())
    if on_cpu:
        _check_sections(weights, A, L)
        return _plain_fused.fused_mlp_search(
            boards, priors, _search_cfg(num_sims, nodes, max_depth, cpuct), weights, ops)
    lib = library()
    B, ptrs, scratch, counts, rootw = _fused_buffers("fused_mlp_stream", boards, priors, nodes,
                                                     False, ops)
    args, _keep = _stream_args(lib, weights, ops, B)
    rc = lib.lib.az_fused_mlp_stream(
        *ptrs, *args, *(t.data_ptr() for t in (*scratch, counts, rootw)),
        B, int(nodes), A, int(num_sims), int(max_depth), float(cpuct), _stream(boards.device),
    )
    lib.check(rc, "fused_mlp_stream")
    fused_mlp_stream.launches += 1
    return counts, rootw


def fused_mlp_rounds(boards, priors, weights, num_sims: int, nodes: int, max_depth: int,
                     cpuct: float, K: int, ops=None):
    """``mcts.fused.fused_mlp_rounds_search``: ``fused_mlp`` in
    ``num_sims // K`` rounds of K leaf-parallel descents, (K+1)^A < 2^24,
    in one launch (every MLP but the resident/staged plan's routes to
    ``fused_mlp_stream_rounds``). Returns ``(counts, rootw) f32[B, A]``."""
    if not _resident(weights, ops):
        return fused_mlp_stream_rounds(boards, priors, weights, num_sims, nodes, max_depth, cpuct,
                                       K, ops)
    _check_rounds("fused_mlp_rounds", num_sims, K)
    on_cpu = _on_cpu(boards, priors, *weights.sections())
    sections, *widths = _mlp_args(weights)
    if on_cpu:
        return _plain_fused.fused_mlp_rounds_search(
            boards, priors, _search_cfg(num_sims, nodes, max_depth, cpuct, K), weights)
    lib = library()
    B, ptrs, scratch, counts, rootw = _fused_buffers("fused_mlp_rounds", boards, priors, nodes, True)
    rc = lib.lib.az_fused_mlp_rounds(
        *ptrs, sections, *(t.data_ptr() for t in (*scratch, counts, rootw)),
        B, int(nodes), int(K), int(num_sims), int(max_depth), *widths, float(cpuct),
        _stream(boards.device),
    )
    lib.check(rc, "fused_mlp_rounds")
    fused_mlp_rounds.launches += 1
    return counts, rootw


def fused_mlp_stream_rounds(boards, priors, weights, num_sims: int, nodes: int, max_depth: int,
                            cpuct: float, K: int, ops=None):
    """``fused_mlp_rounds`` with the streamed evaluator:
    ``az_fused_mlp_stream_rounds`` (on Gomoku the leaves in a device
    scratch)."""
    A, L, gomoku = _fused_game(ops)
    _check_rounds("fused_mlp_stream_rounds", num_sims, K, A)
    on_cpu = _on_cpu(boards, priors, *weights.sections())
    if on_cpu:
        _check_sections(weights, A, L)
        return _plain_fused.fused_mlp_rounds_search(
            boards, priors, _search_cfg(num_sims, nodes, max_depth, cpuct, K), weights, ops)
    lib = library()
    B, ptrs, scratch, counts, rootw = _fused_buffers("fused_mlp_stream_rounds", boards, priors,
                                                     nodes, True, ops)
    args, _keep = _stream_args(lib, weights, ops, B)
    leaves = _leaf_scratch(lib, B, K, boards.device) if gomoku else None
    rc = lib.lib.az_fused_mlp_stream_rounds(
        *ptrs, *args, *(t.data_ptr() for t in scratch),
        leaves.data_ptr() if leaves is not None else None, counts.data_ptr(), rootw.data_ptr(),
        B, int(nodes), A, int(K), int(num_sims), int(max_depth), float(cpuct),
        _stream(boards.device),
    )
    lib.check(rc, "fused_mlp_stream_rounds")
    fused_mlp_stream_rounds.launches += 1
    return counts, rootw


def mlp_eval(boards, weights, ops=None):
    """The fused kernel's MLP evaluator alone, on flat boards f32[B, L] of
    the game of ``ops`` (None: Connect-Four): ``(pm f32[B, A], value
    f32[B], logits f32[B, A])``, the masked prior (INVALID_P on illegal
    moves), the value and the logits — for checking the evaluator against
    its plain version (``mcts.fused.mlp_forward`` and ``mlp_prior``). The
    resident/staged plan's MLPs run ``az_mlp_eval``, every other
    ``mlp_eval_stream``."""
    if not _resident(weights, ops):
        return mlp_eval_stream(boards, weights, ops)
    on_cpu = _on_cpu(boards, *weights.sections())
    mlp_args = _mlp_args(weights)
    if on_cpu:
        logits, value = _plain_fused.mlp_forward(boards, weights)
        return _plain_fused.mlp_prior(logits, FlatOps().valid(boards)), value, logits
    lib = library()
    B = boards.shape[0]
    if B == 0:
        raise ValueError("mlp_eval kernel needs B > 0")
    ptr = _check("boards", boards, (B, 42))
    dev = boards.device
    logits = torch.empty((B, 7), device=dev)
    pm = torch.empty((B, 7), device=dev)
    value = torch.empty((B,), device=dev)
    sections, *widths = mlp_args
    rc = lib.lib.az_mlp_eval(
        ptr, sections, logits.data_ptr(), pm.data_ptr(), value.data_ptr(), B, *widths, _stream(dev),
    )
    lib.check(rc, "mlp_eval")
    mlp_eval.launches += 1
    return pm, value, logits


def mlp_eval_stream(boards, weights, ops=None):
    """``mlp_eval`` with the streamed evaluator: ``az_mlp_eval_stream``."""
    A, L, _ = _fused_game(ops)
    on_cpu = _on_cpu(boards, *weights.sections())
    if on_cpu:
        _check_sections(weights, A, L)
        logits, value = _plain_fused.mlp_forward(boards, weights)
        valid = (ops or FlatOps()).valid(boards)
        return _plain_fused.mlp_prior(logits, valid), value, logits
    lib = library()
    B = boards.shape[0]
    if B == 0:
        raise ValueError("mlp_eval_stream kernel needs B > 0")
    ptr = _check("boards", boards, (B, L))
    dev = boards.device
    logits = torch.empty((B, A), device=dev)
    pm = torch.empty((B, A), device=dev)
    value = torch.empty((B,), device=dev)
    args, _keep = _stream_args(lib, weights, ops, B)
    rc = lib.lib.az_mlp_eval_stream(
        ptr, *args, logits.data_ptr(), pm.data_ptr(), value.data_ptr(), B, A, _stream(dev),
    )
    lib.check(rc, "mlp_eval_stream")
    mlp_eval_stream.launches += 1
    return pm, value, logits


def int8_tower(x, w):
    """``models.int8_tower.tower_plain``: the fused int8 ResNet
    tower of B >= 1 Connect-Four games in one launch. x f32[B*42, 64] (rows
    b*42 + r*7 + c), w int8[11, 64, 576] (``tower_weights_from_jax``) ->
    the last block's f f32[B*42, 64]."""
    if _on_cpu(x, w):
        return _plain_tower.tower_plain(x, w)
    rows = x.shape[0] if x.dim() == 2 else 0
    cells, ch, taps = _plain_tower.CELLS, _plain_tower.CH, _plain_tower.TAPS
    if rows == 0 or rows % cells:
        raise ValueError(f"int8_tower: x must be f32[B*{cells}, {ch}] with B >= 1, got {list(x.shape)}")
    ptrs = [_check("x", x, (rows, ch)),
            _check("w", w, (_plain_tower.N_LAYERS, ch, taps * ch), torch.int8)]
    if any(p % 16 for p in ptrs):
        raise ValueError("int8_tower: x and w must be 16-byte aligned")
    lib = library()
    out = torch.empty((rows, ch), device=x.device)
    rc = lib.lib.az_int8_tower(*ptrs, out.data_ptr(), rows // cells, _stream(x.device))
    lib.check(rc, "int8_tower")
    int8_tower.launches += 1
    return out


KERNELS = _plain.SearchKernels(descend, merge, refresh, descend_round, merge_round, refresh2)
_ALL = (descend, descend_othello, descend_gomoku, descend_hex, merge, merge_dense, refresh,
        refresh_dense, fused, fused_mlp, mlp_eval, descend_round, descend_round_othello,
        descend_round_gomoku, descend_round_hex, merge_round, merge_round_dense, refresh2,
        refresh2_dense, fused_rounds, fused_mlp_rounds, int8_tower, fused_gomoku,
        fused_rounds_gomoku, fused_mlp_stream, fused_mlp_stream_rounds, mlp_eval_stream)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in _ALL}


def reset_launch_counts() -> None:
    for k in _ALL:
        k.launches = 0


reset_launch_counts()
