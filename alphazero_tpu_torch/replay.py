"""The replay ring on the device.

Counterpart of ``alphazero_tpu/replay.py``: one packed ``f32[Cap, F+A+1]``
tensor, a row per sample ``[features (NHWC-flat) | pi | value]``. Insert
expands each valid sample through ``game.symmetries`` and writes the rows
in one scatter at consecutive slots from ``pos``, wrapping modulo ``Cap``
(the overwrite is the FIFO eviction); sample draws rows uniformly with
replacement from the live region. The ring's counters are Python ints:
an insert reads its row count from the device once.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from alphazero_tpu_torch.config import ReplayConfig
from alphazero_tpu_torch.selfplay import Trajectory


class ReplayState(NamedTuple):
    data: torch.Tensor  # f32[Cap, F+A+1] packed rows
    pos: int            # next write slot
    size: int           # live rows (<= Cap)
    total: int          # rows inserted over the ring's life


def replay_total(replay: ReplayState) -> int:
    """Lifetime inserted-row count."""
    return int(replay.total)


def _widths(game) -> Tuple[int, int]:
    return math.prod(game.feature_shape), game.num_actions


def replay_init(game, cfg: ReplayConfig, device="cuda") -> ReplayState:
    F, A = _widths(game)
    return ReplayState(torch.zeros((cfg.capacity, F + A + 1), device=device), 0, 0, 0)


def replay_unpack(replay: ReplayState, game):
    """(features, pi, value) views of the whole ring."""
    F, A = _widths(game)
    feats = replay.data[:, :F].reshape((-1, *game.feature_shape))
    return feats, replay.data[:, F: F + A], replay.data[:, F + A]


def replay_insert(replay: ReplayState, game, traj: Trajectory) -> ReplayState:
    """Insert the valid samples of ``traj``, each expanded through
    ``game.symmetries``, in the JAX package's order: time-major, then
    batch, then symmetry index. The valid samples are compacted before the
    expansion, so only their rows are built. When more rows come than the
    ring holds, only the last ``Cap`` are written."""
    cap = replay.data.shape[0]
    T, B = traj.valid.shape
    keep = traj.valid.reshape(T * B).nonzero()[:, 0]   # ascending: t-major, then b
    feats = traj.features.reshape((T * B, *traj.features.shape[2:]))[keep]
    pis = traj.pi.reshape(T * B, -1)[keep]
    sym_f, sym_p = game.symmetries(feats, pis)
    S = sym_f.shape[1]
    n = keep.numel() * S
    # explicit widths: a call with no valid sample (every game cut by the
    # scan's length) inserts nothing
    rows = torch.cat(
        [sym_f.reshape(n, math.prod(sym_f.shape[2:])), sym_p.reshape(n, sym_p.shape[-1]),
         traj.value.reshape(T * B)[keep].repeat_interleave(S)[:, None]],
        dim=1,
    )
    first = max(n - cap, 0)
    slots = (replay.pos + torch.arange(first, n, device=rows.device)) % cap
    replay.data[slots] = rows[first:]
    return ReplayState(replay.data, (replay.pos + n) % cap, min(replay.size + n, cap),
                       replay.total + n)


def replay_sample(
    replay: ReplayState,
    batch_size: int,
    game,
    generator: Optional[torch.Generator] = None,
    idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``batch_size`` rows drawn uniformly with replacement from ``[0,
    max(size, 1))`` by ``generator`` (on the ring's device), or the rows
    ``idx`` when given; returned as ``(features, pi, value)``."""
    if idx is None:
        idx = torch.randint(0, max(replay.size, 1), (batch_size,), generator=generator,
                            device=replay.data.device)
    rows = replay.data[idx]
    F, A = _widths(game)
    return rows[:, :F].reshape((-1, *game.feature_shape)), rows[:, F: F + A], rows[:, F + A]
