"""Multi-process execution over ``torch.distributed``.

Counterpart of ``alphazero_tpu/parallel/distributed.py``. The JAX package
runs one controller per host under ``jax.distributed`` and lets XLA insert
the collectives; here every rank is one process driving one device, runs
the same coach program on its share of each batch, and the modules that
take a ``mesh`` call the collectives below:

* ``initialize`` — bring-up: the rank's device (``cuda:{local rank}``, or
  the CPU with ``platform="cpu"``) and ``init_process_group`` over
  ``tcp://{coordinator_address}``. NCCL needs one card a rank; gloo runs
  on the CPU and also lets several ranks share one card. The backend is
  the caller's choice: it is never switched, and a rank asked for the
  card fails where there is none.
* ``is_primary`` / ``primary_only`` — the rank-0 gate for host-side side
  effects (metrics, checkpoint files, printing).
* ``all_reduce``, ``all_gather`` (in rank order), ``broadcast``,
  ``barrier`` and ``global_sum`` (an all-reduce whose backward all-reduces
  the incoming gradient). gloo has no collective for some CUDA tensors,
  so under gloo every CUDA tensor goes through a host copy, here and
  nowhere else; NCCL works on the device tensors directly.
* ``host_copy`` — a sharded tree gathered to numpy; ``replicate_host_value``
  — a host value broadcast from rank 0.
* ``launch_local_multihost`` — a gang of local ranks of the multi-process
  CLI (or any entry that takes its flags): on the cards under NCCL unless
  the caller asks for the CPU or gloo.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Optional, Sequence

import torch

_DEVICE: Optional[torch.device] = None


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    platform: Optional[str] = None,
    backend: Optional[str] = None,
) -> torch.device:
    """Join the process group as rank ``process_id`` of
    ``num_processes``; returns the rank's device. ``platform="cpu"`` runs
    the rank on the CPU, where only gloo runs; otherwise the rank takes
    ``cuda:{LOCAL_RANK}`` (``process_id`` modulo the card count when
    ``LOCAL_RANK`` is not set). ``backend`` defaults to gloo on the CPU
    and NCCL on the card."""
    global _DEVICE
    import torch.distributed as dist

    if platform not in (None, "cpu", "cuda", "gpu"):
        raise ValueError(f"unknown platform {platform!r}: cpu, or None/cuda/gpu for the card")
    on_cpu = platform == "cpu"
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    if on_cpu and backend != "gloo":
        raise ValueError(f"the {backend} backend needs the card: only gloo runs on the CPU")
    if on_cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("the rank was asked for the card, but CUDA is not available "
                               "(pass platform='cpu' to run on the CPU)")
        local = int(os.environ.get("LOCAL_RANK", process_id)) % torch.cuda.device_count()
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _DEVICE = dev
    return dev


def device() -> torch.device:
    """The device ``initialize`` chose for this rank."""
    if _DEVICE is None:
        raise RuntimeError("no rank device: call initialize first, or pass make_mesh a device")
    return _DEVICE


def shutdown() -> None:
    """Leave the process group."""
    global _DEVICE
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def is_primary() -> bool:
    """True on the rank that owns host-side side effects (rank 0, or the
    only process when no group is up)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def primary_only(fn):
    """Decorator: run ``fn`` only on rank 0 (returns None elsewhere)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if is_primary():
            return fn(*args, **kwargs)
        return None

    return wrapped


# ---- collectives ---------------------------------------------------------

def _staged(t: torch.Tensor, mesh) -> torch.Tensor:
    """The tensor a collective runs on: a contiguous copy, through the host
    for a CUDA tensor under gloo, and bool as uint8."""
    x = t.detach()
    if mesh.backend == "gloo" and x.is_cuda:
        x = x.cpu()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.contiguous().clone() if x.data_ptr() == t.data_ptr() else x.contiguous()


def _back(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(device=like.device, dtype=like.dtype)


def all_reduce(t: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """The elementwise ``op`` ("sum" or "max") of ``t`` over the ranks, as
    a new tensor on ``t``'s device."""
    import torch.distributed as dist

    x = _staged(t, mesh)
    dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                    group=mesh.group)
    return _back(x, t)


def all_gather(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (each
    rank's tensor of one shape)."""
    import torch.distributed as dist

    x = _staged(t, mesh)
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return _back(torch.cat(parts, dim=dim), t)


def broadcast(t: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, as a new tensor."""
    import torch.distributed as dist

    x = _staged(t, mesh)
    dist.broadcast(x, src=src, group=mesh.group)
    return _back(x, t)


def barrier(mesh) -> None:
    """Every rank waits for the others (a one-element all-reduce on the
    rank's device, which NCCL and gloo both order with the work before)."""
    all_reduce(torch.zeros(1, device=mesh.device), mesh)


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.mesh), None


def global_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable: each rank's loss
    depends on the sum, so the gradient that reaches a rank's ``t`` is the
    sum of every rank's incoming gradient."""
    return _GlobalSum.apply(t, mesh)


def all_reduce_grads(params: Sequence[torch.Tensor], mesh) -> None:
    """Sum the gradients of ``params`` over the ranks, in place, in one
    flat all-reduce."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def gather_batch(mesh, tree: Any, dim: int = 0) -> Any:
    """Every tensor leaf of ``tree`` gathered along ``dim`` in rank order:
    the inverse of ``mesh.shard_batch`` (``mesh=None``: ``tree`` as it
    is)."""
    from alphazero_tpu_torch.parallel.mesh import _map

    if mesh is None:
        return tree
    return _map(lambda x: all_gather(x, mesh, dim), tree)


def host_copy(tree: Any, mesh=None, dim: int = 0) -> Any:
    """Every tensor leaf of ``tree`` as numpy; with ``mesh``, each rank's
    rows gathered along ``dim`` first, so every rank gets the whole
    value."""
    from alphazero_tpu_torch.parallel.mesh import _map

    def fetch(x):
        if mesh is not None:
            x = all_gather(x, mesh, dim)
        return x.detach().cpu().numpy()

    return _map(fetch, tree)


def replicate_host_value(x: Any, mesh) -> torch.Tensor:
    """A host value (meant to be identical on every rank, e.g. a
    generator's state) made identical for certain: rank 0's copy,
    broadcast, on the rank's device."""
    return broadcast(torch.as_tensor(x).to(mesh.device), mesh)


# ---- local gangs ---------------------------------------------------------

MULTIHOST_ENTRY = ("-m", "alphazero_tpu_torch.examples.train_multihost")
# what a parent may carry that would tell a child a topology of its own
_SCRUB = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
          "GROUP_RANK", "JAX_PLATFORMS", "TORCHELASTIC_RUN_ID")


def launch_local_multihost(
    args: list,
    num_processes: int = 2,
    timeout: float = 180.0,
    platform: Optional[str] = None,
    backend: Optional[str] = None,
    entry: Sequence[str] = MULTIHOST_ENTRY,
) -> list:
    """Spawn ``num_processes`` local ranks of ``entry`` (the multi-process
    CLI by default) joined into one process group, and return process 0's
    JSON records (its stdout lines that start with ``{``). Each rank
    gets ``--coordinator localhost:PORT --num-processes N --process-id
    i``, ``--platform`` and ``--backend`` (when not None), then ``args``.
    By default each rank takes a card of its own under NCCL (the entry's
    defaults); ``platform="cpu", backend="gloo"`` runs the gang on the
    CPU, one intra-op thread a rank, and ``backend="gloo"`` alone lets
    ranks share a card. The gang shares one deadline; the first rank to
    fail, or the deadline, kills the rest."""
    import json
    import socket
    import subprocess
    import sys
    import time

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items() if k not in _SCRUB}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    if platform == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    flags = ([] if platform is None else ["--platform", platform]) + (
        [] if backend is None else ["--backend", backend])
    procs = [
        subprocess.Popen(
            [sys.executable, *entry,
             "--coordinator", f"localhost:{port}",
             "--num-processes", str(num_processes),
             "--process-id", str(pid), *flags, *map(str, args)],
            env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(num_processes)
    ]
    # one deadline for the whole gang, polled in short slices so that a
    # rank that dies early takes the others down at once
    deadline = time.monotonic() + timeout
    outs: list = [None] * len(procs)
    pending = list(range(len(procs)))
    failed = None
    try:
        while pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise subprocess.TimeoutExpired(procs[pending[0]].args, timeout)
            idx = pending[0]
            try:
                outs[idx] = procs[idx].communicate(timeout=min(remaining, 2.0))
            except subprocess.TimeoutExpired:
                pending = pending[1:] + [idx]
                continue
            pending.remove(idx)
            if procs[idx].returncode != 0:
                failed = idx
                break
    finally:
        if pending or failed is not None:
            for q in procs:
                if q.poll() is None:
                    q.kill()
            for q in procs:
                q.wait()
    if failed is not None:
        out, err = outs[failed]
        raise RuntimeError(
            f"multihost process {failed} failed rc={procs[failed].returncode}\n"
            f"stdout:\n{out}\nstderr:\n{err}"
        )
    records = [json.loads(line) for line in outs[0][0].splitlines() if line.startswith("{")]
    if not records:
        raise RuntimeError(f"no JSON records from process 0:\n{outs[0][0]}\n{outs[0][1]}")
    return records
