"""The data-parallel mesh over ``torch.distributed`` ranks.

Counterpart of ``alphazero_tpu/parallel/mesh.py``. The JAX package names
its devices on a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives; here a mesh is one process per rank and one device per
process, and the modules that take a ``mesh`` call the collectives of
``parallel/distributed.py`` themselves:

* ``data`` — the game/sample batch axis: self-play games, arena games,
  reanalyze rows and learner minibatch rows are split over the ranks in
  rank order (``batch_sharding``), and what the ranks compute is gathered
  back in global order or summed;
* ``model`` — the JAX package's tensor-parallel axis. Only size 1 is
  ported: ``make_mesh`` with a larger one raises (ROADMAP queue 1,
  "Tensor parallelism on the `model` axis"), and ``param_shardings`` is
  plain replication, as it is in JAX on a size-1 axis.

A sharding here is a ``slice`` of rows: the rank's rows of a batch
(``batch_sharding``) or all of them (``replicated``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group seen from one rank: its ``rank`` and ``size``
    (the world), the axis sizes (``shape``, as the JAX mesh's
    ``{"data": d, "model": 1}``), the ``backend`` and the rank's
    ``device``."""

    group: Any
    rank: int
    size: int
    shape: dict
    backend: str
    device: torch.device

    @property
    def data(self) -> int:
        return int(self.shape.get("data", 1))


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    group=None,
) -> Mesh:
    """The mesh over the ranks of ``group`` (the default group, which
    ``distributed.initialize`` sets up), on the device ``initialize``
    chose for this rank. ``shape=None`` puts every rank on the leading
    (data) axis; ``shape=(d, m)`` with ``m > 1`` raises
    ``NotImplementedError``."""
    import torch.distributed as dist

    from alphazero_tpu_torch.parallel import distributed

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "alphazero_tpu_torch.parallel.distributed.initialize first")
    size = dist.get_world_size(group)
    names = tuple(axis_names)
    if shape is None:
        shape = (size,) + (1,) * (len(names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) > len(names):
        raise ValueError(f"mesh shape {shape} has more axes than the names {names}")
    if any(s > 1 for s in shape[1:]):
        raise NotImplementedError(
            f"mesh shape {shape}: only the data axis is ported; a model axis larger than 1 "
            "is tensor parallelism (ROADMAP queue 1, \"Tensor parallelism on the `model` axis\")"
        )
    if math.prod(shape) != size:
        raise ValueError(f"mesh shape {shape} does not cover the {size} ranks")
    return Mesh(group, dist.get_rank(group), size, dict(zip(names, shape)),
                dist.get_backend(group), distributed.device())


def batch_sharding(mesh: Mesh, batch: int, what: str = "batch") -> slice:
    """This rank's rows of a ``batch``-row array split over the data axis
    in rank order; ``batch`` must divide evenly (as under JAX's
    ``shard_map``), else ``ValueError`` naming ``what``."""
    n = mesh.data
    if batch % n:
        raise ValueError(f"the {what} of {batch} does not divide over the mesh's {n} ranks")
    per = batch // n
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def replicated(mesh: Mesh) -> slice:
    """Every row: a replicated array is whole on every rank."""
    return slice(None)


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def shard_batch(mesh: Mesh, tree: Any, dim: int = 0) -> Any:
    """Every tensor leaf of ``tree`` cut to this rank's rows along ``dim``:
    the leading batch dimension, or ``dim=1`` for the ``[T, B]``
    trajectories and fragment buffers."""
    def cut(x):
        return x[(slice(None),) * dim + (batch_sharding(mesh, x.shape[dim]),)]

    return _map(cut, tree)


def param_shardings(mesh: Mesh, params: Any) -> Any:
    """The sharding of every parameter leaf: replicated, the JAX package's
    choice on a size-1 model axis (the only size ported)."""
    return _map(lambda x: replicated(mesh), params)
