"""Checkpoint and resume: one whole-state ``torch.save`` per step.

Counterpart of ``alphazero_tpu/checkpoint.py``. Checkpoint ``step`` is the
file ``ckpt_{step:06d}`` in the run's directory, with the JSON sidecar
``ckpt_{step:06d}.json`` beside it (counters, Elo history, the match
graph, and ``has_rings``, which marks a light save). The payload is a nest
of dicts and lists whose leaves are tensors, numbers and strings, so
``torch.load(..., weights_only=True)`` reads it.

Write order: the sidecar first, then the payload to a temporary name in
the same directory, renamed onto ``ckpt_{step:06d}`` by ``os.replace``
once it is whole. A crash therefore leaves either a sidecar with no
payload, or a temporary file, both of which ``latest_step`` and
``newest_ring_step`` do not see (they key off the payload's name), or a
complete pair.

Under a ``mesh`` (``parallel/``) every rank builds the payload (the whole
state, the same on every rank once the coach has gathered what it
shards), rank 0 alone writes it between two barriers, and every rank
restores it from the shared directory.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional, Tuple

import torch

from alphazero_tpu_torch.parallel.distributed import barrier

_CKPT_RE = re.compile(r"^ckpt_(\d+)$")


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"ckpt_{step:06d}")


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return [int(m.group(1)) for name in os.listdir(directory) if (m := _CKPT_RE.match(name))]


def save_checkpoint(directory: str, step: int, payload: Any, sidecar: Optional[dict] = None,
                    mesh=None) -> str:
    """Save ``payload`` as checkpoint ``step`` (and the JSON ``sidecar``,
    written first). Returns the payload's path. Under ``mesh`` rank 0
    writes once every rank has arrived, and every rank returns once it
    has written."""
    path = _ckpt_path(directory, step)
    if mesh is not None:
        barrier(mesh)
        if mesh.rank == 0:
            _write(directory, path, payload, sidecar)
        barrier(mesh)
        return path
    _write(directory, path, payload, sidecar)
    return path


def _write(directory: str, path: str, payload: Any, sidecar: Optional[dict]) -> None:
    os.makedirs(directory, exist_ok=True)
    if sidecar is not None:
        with open(path + ".json", "w") as f:
            json.dump(sidecar, f)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", suffix=".tmp",
                               dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def read_sidecar(directory: str, step: int) -> Optional[dict]:
    """The JSON sidecar of ``step``, or None."""
    path = _ckpt_path(directory, step) + ".json"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def newest_ring_step(directory: str, exclude: Optional[int] = None) -> Optional[int]:
    """The newest checkpoint whose sidecar does not mark it light
    (``has_rings: false``); one without a sidecar counts as ring-bearing.
    ``exclude`` skips a step whose classification is unreliable."""
    for step in sorted(_steps(directory), reverse=True):
        if step == exclude:
            continue
        sidecar = read_sidecar(directory, step)
        if sidecar is None or sidecar.get("has_rings", True):
            return step
    return None


def prune_checkpoints(directory: str, keep: int) -> list:
    """Delete all but the newest ``keep`` checkpoints and their sidecars,
    never the newest ring-bearing one. Returns the pruned steps."""
    if keep < 1:
        return []
    steps = sorted(_steps(directory))
    protect = newest_ring_step(directory)
    pruned = [s for s in steps[:-keep] if s != protect]
    for step in pruned:
        path = _ckpt_path(directory, step)
        for p in (path, path + ".json"):
            try:
                os.remove(p)
            except FileNotFoundError:
                pass
    return pruned


def latest_step(directory: str) -> Optional[int]:
    """The newest checkpoint step, by the payload files' numeric stems."""
    steps = _steps(directory)
    return max(steps) if steps else None


def _first_device(tree) -> Optional[torch.device]:
    if isinstance(tree, torch.Tensor):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, (list, tuple)) else ()
    for v in items:
        d = _first_device(v)
        if d is not None:
            return d
    return None


def _fit(saved, template, partial: bool, where: str):
    """``saved`` checked against ``template`` and placed like it: the same
    keys (with ``partial``, a dict of the template's keys is taken out of
    a larger saved dict), tensors of the same shape and dtype, each moved
    to its template tensor's device."""
    if isinstance(template, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"checkpoint {where}: a {type(saved).__name__}, not a dict")
        missing = [k for k in template if k not in saved]
        extra = [] if partial else [k for k in saved if k not in template]
        if missing or extra:
            raise ValueError(f"checkpoint {where}: keys missing {missing}, unexpected {extra}")
        return {k: _fit(saved[k], v, partial, f"{where}/{k}") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(template):
            raise ValueError(f"checkpoint {where}: not a sequence of {len(template)}")
        return type(template)(_fit(s, t, partial, f"{where}[{i}]")
                              for i, (s, t) in enumerate(zip(saved, template)))
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != template.shape \
                or saved.dtype != template.dtype:
            got = (tuple(saved.shape), saved.dtype) if isinstance(saved, torch.Tensor) else saved
            raise ValueError(f"checkpoint {where}: {got} where the template holds "
                             f"{(tuple(template.shape), template.dtype)}")
        return saved.to(template.device)
    return saved


def restore_checkpoint(
    directory: str, step: int, template: Any, partial: bool = False
) -> Tuple[Any, Optional[dict]]:
    """Restore the payload of ``step`` shaped like ``template`` (a nest of
    dicts whose tensors give each leaf's shape, dtype and device), and its
    sidecar. The file is read onto the device of the template's first
    tensor (``map_location``), and each tensor then moves to its own
    template tensor's device (a generator state or Adam's step counts live
    on the CPU). A payload whose structure, shapes or dtypes differ from
    the template's raises ``ValueError``. ``partial=True`` restores only
    the subtrees the template names (a play tool's weights, say)."""
    path = _ckpt_path(directory, step)
    saved = torch.load(path, map_location=_first_device(template) or "cpu", weights_only=True)
    payload = _fit(saved, template, partial, f"ckpt_{step:06d}")
    return payload, read_sidecar(directory, step)
