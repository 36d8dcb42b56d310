"""Replay-target refresh by re-search ("reanalyze").

Counterpart of ``alphazero_tpu/reanalyze.py`` (the MuZero-Reanalyze idea
for terminal-outcome training): self-play records each sample's root state
(``make_selfplay_fn(record_states=True)``) into a ``PositionStore``, a ring
of states and their outcome targets on the device; a pass re-searches
``batch_size`` stored positions with the current model at the full budget,
without root noise, and returns a one-step ``Trajectory`` whose policy
target is the fresh search's (the normalised root counts, or with Gumbel
search its improved policy) and whose value is the stored outcome, for
``replay_insert``.

The PUCT pass searches through the engine ladder (``_make_root_counts_fn``)
on freshly built trees each time: on the hybrid route the seeds
(``kernels.refresh``/``refresh2``) see a fresh search's planes, their
precondition. The ring's counters are Python ints, as the replay ring's.
The row indices of a pass and its Gumbel sample are inputs.

Under a ``mesh`` (``parallel/``) the position ring is the same on every
rank (the coach inserts the gathered self-play rows), the pass's ``idx``
and Gumbel sample are the global ones, and each rank re-searches its
share of the ``R`` rows (``R`` must divide over the ranks); the returned
trajectory is the rank's rows, and the count and the mean age are the
global ones.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from alphazero_tpu_torch.config import MCTSConfig, ReanalyzeConfig
from alphazero_tpu_torch.mcts.gumbel import check_gumbel_config, make_gumbel_search_fn
from alphazero_tpu_torch.models import make_apply_fn
from alphazero_tpu_torch.parallel.distributed import all_reduce
from alphazero_tpu_torch.parallel.mesh import batch_sharding
from alphazero_tpu_torch.selfplay import Trajectory, _make_root_counts_fn


class PositionStore(NamedTuple):
    """Ring of root states and their outcome targets."""

    states: torch.Tensor  # [Cap, *state shape] game states
    value: torch.Tensor   # f32[Cap] outcome from the position's to-move view
    born: torch.Tensor    # i32[Cap] coach iteration the position was recorded at
    pos: int              # next write slot
    size: int             # live positions (<= Cap)


def position_init(game, capacity: int, device="cuda") -> PositionStore:
    proto = game.init(1, device)
    return PositionStore(
        states=torch.zeros((capacity, *proto.shape[1:]), dtype=proto.dtype, device=device),
        value=torch.zeros(capacity, device=device),
        born=torch.zeros(capacity, dtype=torch.int32, device=device),
        pos=0,
        size=0,
    )


def position_insert(store: PositionStore, states: torch.Tensor, value: torch.Tensor,
                    valid: torch.Tensor, iteration: int = 0, *, stride: int = 1) -> PositionStore:
    """Insert the valid positions of a recorded self-play call: ``states``
    [T, B, ...] (``record_states=True``), ``value`` and ``valid`` [T, B]
    (its trajectory's), stamped with the coach ``iteration``. ``stride``
    records only every ``stride``-th valid sample (time-major, then
    batch). The ring writes them at consecutive slots from ``pos``,
    wrapping; when more come than it holds, only the last ``Cap`` are
    written. One host synchronisation (the count)."""
    cap = store.value.shape[0]
    T, B = valid.shape
    keep = valid.reshape(T * B).nonzero()[:, 0]   # ascending: t-major, then b
    if stride > 1:
        keep = keep[::stride]
    num = keep.numel()
    first = max(num - cap, 0)
    keep = keep[first:]
    slots = (store.pos + torch.arange(first, num, device=keep.device)) % cap
    store.states[slots] = states.reshape(T * B, *states.shape[2:])[keep]
    store.value[slots] = value.reshape(T * B)[keep]
    store.born[slots] = int(iteration)
    return PositionStore(store.states, store.value, store.born, (store.pos + num) % cap,
                         min(store.size + num, cap))


def make_reanalyze_fn(game, mcts_cfg: MCTSConfig, rz_cfg: ReanalyzeConfig, mesh=None
                      ) -> Callable[..., Tuple[Trajectory, int, float]]:
    """Build ``reanalyze(model, store, idx, gumbel=None, iteration=0) ->
    (Trajectory [1, R], num_refreshed, age_mean)``.

    ``idx`` i64[R] are the rows to re-search (the JAX pass draws them
    uniformly from ``[0, max(size, 1))``); ``gumbel`` f32[R, A] is the root
    sample of a Gumbel search (``mcts_cfg.gumbel``). The search runs
    ``rz_cfg.num_sims`` (or the config's) simulations at the default
    capacity, without Dirichlet noise. Rows drawn from an empty store are
    masked; ``age_mean`` is the mean of ``iteration`` minus each refreshed
    position's stamp (near 0: the ring wraps within an iteration)."""
    search_cfg = dataclasses.replace(
        mcts_cfg,
        num_sims=int(rz_cfg.num_sims or mcts_cfg.num_sims),
        max_nodes=None,
        dirichlet_alpha=None,   # targets are refreshed noise-free
        tree_reuse=False,
    )
    gumbel_on = getattr(mcts_cfg, "gumbel", False)
    if gumbel_on:
        check_gumbel_config(search_cfg)
    rows = slice(None) if mesh is None else batch_sharding(mesh, rz_cfg.batch_size,
                                                           "reanalyze batch")

    def reanalyze(model, store: PositionStore, idx: torch.Tensor,
                  gumbel: Optional[torch.Tensor] = None, iteration: int = 0):
        apply_fn = make_apply_fn(model)
        R = idx.shape[0]
        idx = idx[rows]
        if gumbel is not None:
            gumbel = gumbel[rows]
        states = store.states[idx]
        if gumbel_on:
            pi = make_gumbel_search_fn(game, apply_fn, search_cfg)(states, gumbel).improved_pi
        else:
            counts = _make_root_counts_fn(game, apply_fn, search_cfg)(states)
            pi = counts / counts.sum(dim=-1, keepdim=True).clamp(min=1.0)
        live = store.size > 0
        valid = torch.full((1, idx.shape[0]), live, dtype=torch.bool, device=idx.device)
        traj = Trajectory(features=game.to_features(states)[None], pi=pi[None],
                          value=(store.value[idx] * live)[None], valid=valid)
        num = R if live else 0
        age = ((int(iteration) - store.born[idx]).float() * live).sum()
        if mesh is not None:
            age = all_reduce(age, mesh)
        return traj, num, float(age / max(num, 1))

    return reanalyze
