"""Build, binding and launch wrappers of the hand-written CUDA kernels.

The kernels live in ``csrc/hybrid.cu`` (see its header for what each one
replaces and how it is designed). They are compiled at first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
under ``csrc/build/<hash of source and flags>/``, and loaded with
``ctypes``; nothing is built when this module is imported.

Each wrapper takes tensors on ONE device:

* CPU tensors run the plain PyTorch version from ``mcts/hybrid.py``;
* CUDA tensors launch the kernel on the current stream, or raise — a
  failed build, a bad shape/dtype/layout or a launch error never falls
  back to the plain version.

Each wrapper counts its kernel launches in a plain integer attribute,
``descend.launches`` etc.; ``reset_launch_counts()`` zeroes them.
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
from typing import Optional

import torch

from alphazero_tpu_torch.mcts import hybrid as _plain

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "hybrid.cu"
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "--fmad=false",          # no a*b+c contraction: bit-exact PUCT scores
    "-Xptxas", "-v",         # registers / spills into the build log
    "-shared", "-Xcompiler", "-fPIC",
)


class _Library:
    """The loaded kernel library and what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds
        self.build_log = log
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.az_max_actions.argtypes = []
        lib.az_max_actions.restype = i32
        lib.az_error_string.argtypes = [i32]
        lib.az_error_string.restype = ctypes.c_char_p
        lib.az_descend.argtypes = [vp] * 9 + [i32] * 3 + [vp]
        lib.az_descend.restype = i32
        lib.az_merge.argtypes = [vp] * 12 + [i32] * 4 + [f32, vp]
        lib.az_merge.restype = i32
        lib.az_refresh.argtypes = [vp] * 6 + [i32] * 3 + [f32, vp]
        lib.az_refresh.restype = i32
        self.max_actions = int(lib.az_max_actions())

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


def library() -> _Library:
    """Build (once per source/flags hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_DIR / key
    so_path = out_dir / "libazhybrid.so"
    log = ""
    t0 = time.perf_counter()
    if not so_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=out_dir, suffix=".so", delete=False) as tmp:
            tmp_path = Path(tmp.name)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp_path), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp_path.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp_path, so_path)   # atomic: concurrent builds agree
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


def _check(name: str, t: torch.Tensor, shape) -> int:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_actions(lib: _Library, A: int) -> None:
    if A > lib.max_actions:
        raise NotImplementedError(
            f"A={A} > {lib.max_actions}: the dense A>8 refresh (ROADMAP queue 2, "
            "K6 dense branch) is not yet ported"
        )


def descend(besta, bestc, done, tval, boards, max_depth: int):
    """``mcts.hybrid.descend`` for Connect-Four boards f32[B, 42]."""
    if _on_cpu(besta, bestc, done, tval, boards):
        return _plain.descend(besta, bestc, done, tval, boards, max_depth)
    B, C = besta.shape
    if B == 0 or boards.shape != (B, 42):
        raise ValueError(f"descend kernel takes Connect-Four boards [B>0, 42], got {tuple(boards.shape)}")
    lib = library()
    ptrs = [
        _check("besta", besta, (B, C)), _check("bestc", bestc, (B, C)),
        _check("done", done, (B, C)), _check("tval", tval, (B, C)),
        _check("boards", boards, (B, 42)),
    ]
    bd = torch.empty((B, 42), device=boards.device)
    patha = torch.empty((B, C), device=boards.device)
    psgn = torch.empty((B, C), device=boards.device)
    meta = torch.empty((B, 8), device=boards.device)
    rc = lib.lib.az_descend(
        *ptrs, bd.data_ptr(), patha.data_ptr(), psgn.data_ptr(), meta.data_ptr(),
        B, C, int(max_depth), _stream(boards.device),
    )
    lib.check(rc, "descend")
    descend.launches += 1
    return bd, patha, psgn, meta


def merge(n, w, p, code, done, tval, pm, patha, psgn, meta2, slot: int, cpuct: float):
    """``mcts.hybrid.merge``: in place on ``n, w, p, code, done, tval``;
    returns the refreshed ``(best_a, best_code)``."""
    if _on_cpu(n, w, p, code, done, tval, pm, patha, psgn, meta2):
        return _plain.merge(n, w, p, code, done, tval, pm, patha, psgn, meta2, slot, cpuct)
    B, A, C = n.shape
    lib = library()
    _check_actions(lib, A)
    if B == 0:
        raise ValueError("merge kernel needs B > 0")
    ptrs = [
        _check("n", n, (B, A, C)), _check("w", w, (B, A, C)),
        _check("p", p, (B, A, C)), _check("code", code, (B, A, C)),
        _check("done", done, (B, C)), _check("tval", tval, (B, C)),
        _check("pm", pm, (B, A)), _check("patha", patha, (B, C)),
        _check("psgn", psgn, (B, C)), _check("meta2", meta2, (B, 8)),
    ]
    besta = torch.empty((B, C), device=n.device)
    bestc = torch.empty((B, C), device=n.device)
    rc = lib.lib.az_merge(
        *ptrs, besta.data_ptr(), bestc.data_ptr(),
        B, A, C, int(slot), float(cpuct), _stream(n.device),
    )
    lib.check(rc, "merge")
    merge.launches += 1
    return besta, bestc


def refresh(n, w, p, code, cpuct: float):
    """``mcts.hybrid.refresh``: the PUCT argmax planes of every node."""
    if _on_cpu(n, w, p, code):
        return _plain.refresh(n, w, p, code, cpuct)
    B, A, C = n.shape
    lib = library()
    _check_actions(lib, A)
    if B == 0:
        raise ValueError("refresh kernel needs B > 0")
    ptrs = [
        _check("n", n, (B, A, C)), _check("w", w, (B, A, C)),
        _check("p", p, (B, A, C)), _check("code", code, (B, A, C)),
    ]
    besta = torch.empty((B, C), device=n.device)
    bestc = torch.empty((B, C), device=n.device)
    rc = lib.lib.az_refresh(
        *ptrs, besta.data_ptr(), bestc.data_ptr(), B, A, C, float(cpuct), _stream(n.device)
    )
    lib.check(rc, "refresh")
    refresh.launches += 1
    return besta, bestc


descend.launches = 0
merge.launches = 0
refresh.launches = 0

KERNELS = _plain.SearchKernels(descend, merge, refresh)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
