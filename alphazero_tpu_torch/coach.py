"""Coach: the self-play, replay, train, gate and rating outer loop.

Counterpart of ``alphazero_tpu/coach.py`` on one device. An iteration
runs, in order:

  (a) self-play: the recycling actor (``selfplay.recycle``) or the fixed
      scan, with the incumbent's weights;
  (b) replay: the ring insert with the game's symmetries; with
      ``cfg.reanalyze``, the recorded root states into the position ring,
      and every ``interval`` iterations a reanalyze pass whose refreshed
      samples go into the replay ring too (``reanalyze.py``);
  (c) train: the candidate, a copy of the incumbent (model, BatchNorm
      statistics, Adam moments and step), takes ``steps_per_iteration``
      minibatch steps; the incumbent stays as it was;
  (d) gate: the candidate plays the incumbent in the arena and replaces
      it iff its win rate reaches ``update_threshold``; ``model_id``
      counts the adoptions, and the per-gate ``EloTracker`` logs them;
  (e) the anchored rating pass every ``anchor_interval`` iterations (and
      at every iteration <= ``anchor_warmup``): the incumbent plays the
      pure-MCTS anchor, the ladder's rungs and the snapshot pool, and the
      whole match graph is refitted with the anchor pinned at Elo 0;
  (f) the whole-state checkpoint (``checkpoint.py``): weights, optimizer,
      rings (replay, positions), actor carry, the generator's state,
      counters; the sidecar
      holds the Elo history and the match graph, so a resume is exact.

Randomness: the coach holds one CPU ``torch.Generator`` seeded from
``cfg.seed``; each phase takes a seed from it (``_split``, the JAX
coach's key splits) and draws from a generator of its own on the device.
The coach's generator state is in every checkpoint.

One semantic differs from the JAX package on purpose: a ladder rung is
retired for the incumbent once the incumbent itself has swept it in its
last two matches against it; the JAX coach retires it once any two
generations have (ROADMAP queue 3, "ADVICE low, coach.py:950").

Under a ``mesh`` (``parallel/``, one process per rank, one device each)
every phase is data-parallel and the iteration equals the one-process
iteration of the same config (its integers exactly; its losses within
1e-5 where the learner computes in f32, while a bf16 learner's drift
further, since each rank rounds its bf16 weight gradients before the
ranks' sum, ``train.py``): every rank holds the same coach state and
draws every phase's global draws from generators seeded alike; self-play
plays the rank's games, and their trajectory is gathered in global game
order and inserted on every rank, so the replay and position rings are
the same everywhere (each rank holds the whole ring, where the JAX ring
is sharded over its capacity: ROADMAP queue 3); the learner trains on the
rank's rows of each minibatch with the gradients summed over the ranks;
the arenas and reanalyze split their games and rows and sum their
results, so Elo, the pool and the match graph are the same everywhere.
Rank 0 alone logs the metrics and writes the checkpoint; every rank
restores it, and the recycling actor's carry is gathered into global
order for the save and cut to the rank's games on restore.

The host archive of samples: with a ``checkpoint_dir`` and one rank, the
coach mirrors each iteration's valid self-play samples (features, pi,
value; step-major, as the trajectory holds them) into a
``native.ExampleStore`` of ``cfg.replay.capacity`` rows, right after the
replay insert, and saves the store as ``{iteration}.examples`` in the
checkpoint directory (``iteration`` counted before the iteration ends, as
the JAX coach names them: the first file is ``0.examples``). The file is
the JAX store's format, and holds every archived row the ring still has,
oldest first. Under a mesh of more than one rank no archive is written, as
under the JAX coach's multi-process runs; the whole-state checkpoint holds
the replay ring there. Without g++ on ``PATH`` the coach logs one warning
and writes none; any other failure of the store raises (the JAX coach
drops the archive on any exception).
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import logging
import math
import os
import pickle
import signal
import threading
from typing import Optional

import torch

from alphazero_tpu_torch import native
from alphazero_tpu_torch.arena import gate, make_arena_fn, tie_draws_from
from alphazero_tpu_torch.checkpoint import (
    latest_step,
    newest_ring_step,
    prune_checkpoints,
    read_sidecar,
    restore_checkpoint,
    save_checkpoint,
)
from alphazero_tpu_torch.config import AZConfig
from alphazero_tpu_torch.models import is_folded, make_uniform_model
from alphazero_tpu_torch.ops import gumbel_from_uniform, sample_draws
from alphazero_tpu_torch.parallel.distributed import all_reduce, gather_batch
from alphazero_tpu_torch.parallel.mesh import Mesh, shard_batch
from alphazero_tpu_torch.reanalyze import (
    PositionStore,
    make_reanalyze_fn,
    position_init,
    position_insert,
)
from alphazero_tpu_torch.replay import ReplayState, replay_init, replay_insert, replay_total
from alphazero_tpu_torch.selfplay import (
    ActorCarry,
    make_recycling_selfplay_fn,
    make_selfplay_fn,
)
from alphazero_tpu_torch.train import (
    TrainState,
    init_train_state,
    make_train_phase,
    prime_optimizer_state,
)
from alphazero_tpu_torch.utils import (
    EloTracker,
    MetricsLogger,
    PhaseTimer,
    elo_standard_errors,
    fit_elo,
    synchronize,
)

log = logging.getLogger(__name__)

_RINGS = ("replay", "positions", "actor")
# what a restore raises for a file that does not fit the template, is
# missing, or is cut short
_RESTORE_ERRORS = (ValueError, OSError, EOFError, RuntimeError, pickle.UnpicklingError)


def _gen_key(k):
    """JSON round-trip of a match-graph player: an int generation, or
    "anchor" / a ladder rung "anchor@SIMS"."""
    if isinstance(k, str) and k.startswith("anchor"):
        return k
    return int(k)


def copy_train_state(state: TrainState) -> TrainState:
    """An independent copy of the learner's state: model (parameters and
    BatchNorm statistics), optimizer (Adam moments) and step. The model
    and the optimizer go through one ``deepcopy``, so the copy's
    optimizer holds the copy's parameters."""
    model, optimizer = copy.deepcopy((state.model, state.optimizer))
    return TrainState(model, optimizer, state.step)


# the dimension of the batch in each field of the actor's carry
_CARRY_DIMS = {"state": 0, "move_count": 0, "frag_features": 1, "frag_pi": 1}


class Coach:
    """The outer loop over one device (``device``, the card unless the
    caller passes a CPU device), or with ``mesh`` over its ranks, each on
    its own device (``mesh.device`` unless ``device`` is given). The
    coach owns ``model``: it moves it to the device and trains copies of
    it; under a mesh every rank must pass the same weights."""

    def __init__(self, game, model, cfg: AZConfig, mesh=None, device=None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh (parallel.make_mesh), not "
                            f"{type(mesh).__name__}")
        if device is None:
            device = "cuda" if mesh is None else mesh.device
        self.mesh = mesh
        self._primary = mesh is None or mesh.rank == 0
        self._recycle = bool(getattr(cfg.selfplay, "recycle", False))
        rz_cfg = cfg.reanalyze
        if rz_cfg is not None and self._recycle:
            raise ValueError(
                "selfplay.recycle is incompatible with reanalyze "
                "(the position ring records the fixed scan's [T, B] root states)"
            )
        self.game = game
        self.cfg = cfg
        self.device = torch.device(device)
        dev = self.device
        self._eval_folded = is_folded(model)

        self.rng = torch.Generator(device="cpu").manual_seed(cfg.seed)
        self.incumbent = init_train_state(model.to(dev), cfg.train)
        prime_optimizer_state(self.incumbent.optimizer)
        self.replay = replay_init(game, cfg.replay, device=dev)
        self.actor_carry = None
        if self._recycle:
            init_actor, self._selfplay = make_recycling_selfplay_fn(
                game, cfg.mcts, cfg.selfplay, device=dev, mesh=mesh)
            self.actor_carry = init_actor()
        else:
            self._selfplay = make_selfplay_fn(game, cfg.mcts, cfg.selfplay, device=dev,
                                              record_states=rz_cfg is not None, mesh=mesh)
        self.positions = None
        self._reanalyze = None
        if rz_cfg is not None:
            self.positions = position_init(game, rz_cfg.capacity, device=dev)
            self._reanalyze = make_reanalyze_fn(game, cfg.mcts, rz_cfg, mesh=mesh)
        self._train_phase = make_train_phase(cfg.train, cfg.train.steps_per_iteration, game,
                                             mesh=mesh)

        # the arena plays noise-free greedy moves: no root Dirichlet, no
        # forced playouts (a training-target device)
        arena_cfg = dataclasses.replace(
            cfg.mcts,
            num_sims=cfg.arena.num_sims or cfg.mcts.num_sims,
            dirichlet_alpha=None,
            forced_playouts=None,
        )
        games = cfg.arena.num_games
        self._arena = make_arena_fn(game, arena_cfg, games, device=dev, mesh=mesh)
        self._uniform = make_uniform_model(game)
        self._anchor_arena = None
        self._rung_arenas = {}
        self._rung_chain = []
        if cfg.arena.anchor_interval:
            # the anchored pass is a standardized protocol: exact PUCT at
            # K=1 on the pure tree, whatever engine training uses, so that
            # the anchor's strength (pinned at 0) stays one across runs
            anchor_cfg = dataclasses.replace(
                arena_cfg, gumbel=False, transposition=False, parallel_sims=1)
            self._anchor_arena = make_arena_fn(game, anchor_cfg, games, device=dev, mesh=mesh)
            # the ladder's rungs: fixed pure-MCTS agents at higher budgets,
            # each with an arena against the net (asymmetric budgets) and a
            # chain arena from the rung below
            prev_name, prev_sims = "anchor", anchor_cfg.num_sims
            for sims in tuple(getattr(cfg.arena, "anchor_ladder", ()) or ()):
                rung_cfg = dataclasses.replace(anchor_cfg, num_sims=int(sims))
                name = f"anchor@{int(sims)}"
                self._rung_arenas[name] = make_arena_fn(
                    game, anchor_cfg, games, mcts_cfg_inc=rung_cfg, device=dev, mesh=mesh)
                self._rung_chain.append((prev_name, name, make_arena_fn(
                    game, dataclasses.replace(anchor_cfg, num_sims=prev_sims), games,
                    mcts_cfg_inc=rung_cfg, device=dev, mesh=mesh)))
                prev_name, prev_sims = name, int(sims)
            # incumbent-vs-pool matches ride the same protocol
            self._rating_arena = self._arena
            if anchor_cfg != arena_cfg:
                self._rating_arena = make_arena_fn(game, anchor_cfg, games, device=dev, mesh=mesh)

        self.iteration = 0
        self.model_id = 0
        self._selfplay_ran = False
        self._last_save_rings = True
        self.elo = EloTracker()
        self.pool = []           # [(model_id, host state dict)]
        self.pool_matches = []   # [{a, b, wins_a, wins_b, draws}]
        self._pool_ckpt = bool(cfg.arena.pool_in_checkpoint and cfg.arena.anchor_interval)
        self.anchored_ratings = {}
        self.metrics = MetricsLogger(cfg.checkpoint_dir if self._primary else None)
        self.timer = PhaseTimer()
        # the host archive of training samples, `{iteration}.examples`
        self.example_store = None
        if cfg.checkpoint_dir and (mesh is None or mesh.size == 1):
            if native.available():
                self.example_store = native.ExampleStore(
                    cfg.replay.capacity, feat_size=math.prod(game.feature_shape),
                    num_actions=game.num_actions)
            else:
                log.warning("no g++ on PATH: the host example archive ({iteration}.examples) "
                            "is not written")
        if cfg.checkpoint_dir:
            self._maybe_resume()

    # ------------------------------------------------------------------
    def _payload(self, rings: bool = True) -> dict:
        """The checkpoint's payload. ``rings=False`` is the LIGHT payload
        (``replay_save_stride``): no replay ring, position ring or actor
        carry, the only state a run regenerates."""
        inc = self.incumbent
        payload = {
            "incumbent": {
                "model": inc.model.state_dict(),
                "optimizer": inc.optimizer.state_dict(),
                "step": inc.step,
            },
            "rng": self.rng.get_state(),
        }
        if rings:
            r = self.replay
            payload["replay"] = {"data": r.data, "pos": r.pos, "size": r.size, "total": r.total}
            if self.positions is not None:
                # the reanalyze position ring resumes exactly with the run
                payload["positions"] = self.positions._asdict()
            if self.actor_carry is not None:
                # the recycling actor's live boards and open fragments, in
                # global game order: a resume continues mid-episode
                payload["actor"] = {k: gather_batch(self.mesh, v, _CARRY_DIMS[k])
                                    for k, v in self.actor_carry._asdict().items()}
        if self._pool_ckpt:
            payload["pool"] = self._pool_payload()
        return payload

    def _pool_payload(self) -> dict:
        """The pool's snapshots stacked to a fixed shape (``pool_size``
        rows, zero-padded, id -1 where empty), on the host."""
        P = max(self.cfg.arena.pool_size, 1)
        zeros = {k: torch.zeros_like(v, device="cpu")
                 for k, v in self.incumbent.model.state_dict().items()}
        ids = torch.full((P,), -1, dtype=torch.int32)
        snaps = []
        for i, (gen_id, snap) in enumerate(self.pool[:P]):
            ids[i] = gen_id
            snaps.append(snap)
        snaps += [zeros] * (P - len(snaps))
        return {"ids": ids, "vars": {k: torch.stack([s[k] for s in snaps]) for k in zeros}}

    def _restore_dropping_optional(self, step, template):
        """``restore_checkpoint``; when the exact template fails, retry
        without the smallest set of optional subtrees ("positions", "pool",
        "actor") that restores, and start those empty."""
        try:
            return restore_checkpoint(self.cfg.checkpoint_dir, step, template)
        except _RESTORE_ERRORS:
            optional = [k for k in ("positions", "pool", "actor") if k in template]
            if not optional:
                raise
            for r in range(1, len(optional) + 1):
                for drop in itertools.combinations(optional, r):
                    t2 = {k: v for k, v in template.items() if k not in drop}
                    try:
                        out = restore_checkpoint(self.cfg.checkpoint_dir, step, t2)
                    except _RESTORE_ERRORS:
                        continue
                    log.warning("checkpoint predates optional subtree(s) %s: resuming with "
                                "them empty", list(drop))
                    return out
            raise

    def _resume_light(self, step, template, exclude_ring=None) -> None:
        """The light plan (``replay_save_stride``): everything but the
        rings from ``step``, the rings from the newest ring-bearing step."""
        light_t = {k: v for k, v in template.items() if k not in _RINGS}
        payload, sidecar = self._restore_dropping_optional(step, light_t)
        ring_step = newest_ring_step(self.cfg.checkpoint_dir, exclude=exclude_ring)
        if ring_step is not None:
            rings_t = {k: template[k] for k in _RINGS if k in template}
            try:
                rings, _ = restore_checkpoint(self.cfg.checkpoint_dir, ring_step, rings_t,
                                              partial=True)
            except _RESTORE_ERRORS:
                try:
                    rings, _ = restore_checkpoint(self.cfg.checkpoint_dir, ring_step,
                                                  {"replay": template["replay"]}, partial=True)
                except _RESTORE_ERRORS:
                    rings = {}
            payload.update(rings)
            if rings:
                log.warning("light checkpoint %d: rings restored from ring-bearing checkpoint "
                            "%d (%d iterations older)", step, ring_step, step - ring_step)
            else:
                log.warning("light checkpoint %d: ring checkpoint %d is incompatible: resuming "
                            "with empty rings", step, ring_step)
        else:
            log.warning("light checkpoint %d with no ring-bearing checkpoint on disk: resuming "
                        "with empty rings", step)
        self._finish_resume(payload, sidecar, step)

    def _maybe_resume(self) -> None:
        step = latest_step(self.cfg.checkpoint_dir)
        if step is None:
            return
        template = self._payload()
        pre = read_sidecar(self.cfg.checkpoint_dir, step)
        if pre is not None and not pre.get("has_rings", True):
            self._resume_light(step, template)
            return
        try:
            payload, sidecar = self._restore_dropping_optional(step, template)
        except _RESTORE_ERRORS:
            # a light checkpoint whose sidecar is missing: the light plan,
            # with this step excluded from the ring candidates
            self._resume_light(step, template, exclude_ring=step)
            log.warning("checkpoint %d failed the exact restore but resumed through the light "
                        "plan (sidecar missing or misclassified)", step)
            return
        self._finish_resume(payload, sidecar, step)

    def _finish_resume(self, payload, sidecar, step) -> None:
        """Install a restored payload and sidecar."""
        inc = payload["incumbent"]
        self.incumbent.model.load_state_dict(inc["model"])
        self.incumbent.optimizer.load_state_dict(inc["optimizer"])
        self.incumbent.step = int(inc["step"])
        if "replay" in payload:
            r = payload["replay"]
            self.replay = ReplayState(r["data"], int(r["pos"]), int(r["size"]), int(r["total"]))
        if "positions" in payload and self.positions is not None:
            p = payload["positions"]
            self.positions = PositionStore(p["states"], p["value"], p["born"], int(p["pos"]),
                                           int(p["size"]))
        if "actor" in payload and self.actor_carry is not None:
            self.actor_carry = ActorCarry(**{
                k: v if self.mesh is None else shard_batch(self.mesh, v, _CARRY_DIMS[k])
                for k, v in payload["actor"].items()})
        if "pool" in payload:
            ids = payload["pool"]["ids"].tolist()
            for i, gen_id in enumerate(ids):
                if gen_id >= 0:
                    self.pool.append((int(gen_id), {k: v[i].clone() for k, v in
                                                    payload["pool"]["vars"].items()}))
            self.pool.sort(key=lambda t: t[0])
        self.rng.set_state(payload["rng"].cpu())
        if sidecar:
            self.iteration = sidecar.get("iteration", step)
            self.model_id = sidecar.get("model_id", 0)
            self.elo.history.extend(sidecar.get("elo_history", []))
            self.elo.ratings.update({int(k): v for k, v in sidecar.get("elo_ratings", {}).items()})
            self.pool_matches = [{**m, "a": _gen_key(m["a"]), "b": _gen_key(m["b"])}
                                 for m in sidecar.get("pool_matches", [])]
            if self.pool_matches:
                self.anchored_ratings = fit_elo(self.pool_matches, "anchor", 0.0)
        else:
            self.iteration = step

    def save(self, rings: bool = True) -> None:
        if not self.cfg.checkpoint_dir:
            return
        save_checkpoint(
            self.cfg.checkpoint_dir,
            self.iteration,
            self._payload(rings=rings),
            sidecar={
                "iteration": self.iteration,
                "model_id": self.model_id,
                "has_rings": rings,
                "elo_history": self.elo.history,
                "elo_ratings": self.elo.ratings,
                "pool_matches": self.pool_matches,
            },
            mesh=self.mesh,
        )
        self._last_save_rings = rings
        if self.cfg.keep_checkpoints and self._primary:
            prune_checkpoints(self.cfg.checkpoint_dir, self.cfg.keep_checkpoints)

    # ------------------------------------------------------------------
    def _split(self, n: int = 2) -> list:
        """``n`` phase seeds from the coach's generator."""
        return torch.randint(0, 1 << 62, (n,), generator=self.rng).tolist()

    def _gen(self, seed: int) -> torch.Generator:
        """A phase's generator on the device."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def _ties(self, seed: int, gumbel: bool = False):
        return tie_draws_from(self._gen(seed), self.cfg.arena.num_games,
                              self.game.num_actions, self.device, gumbel=gumbel)

    def _reanalyze_draws(self, seed: int) -> tuple:
        """A reanalyze pass's draws: ``batch_size`` rows uniform over the
        position ring's live region and, for Gumbel search, the root
        sample."""
        gen = self._gen(seed)
        R, A = self.cfg.reanalyze.batch_size, self.game.num_actions
        idx = torch.randint(0, max(self.positions.size, 1), (R,), generator=gen,
                            device=self.device)
        if not self.cfg.mcts.gumbel:
            return idx, None
        return idx, gumbel_from_uniform(torch.rand((R, A), generator=gen, device=self.device))

    def _model_from(self, snapshot: dict) -> torch.nn.Module:
        """A pool snapshot staged onto the device for its arena."""
        model = copy.deepcopy(self.incumbent.model)
        model.load_state_dict(snapshot)
        return model

    def run_iteration(self) -> dict:
        """One full coach iteration; returns the metrics record."""
        cfg = self.cfg
        game, dev = self.game, self.device
        k_sp, k_train, k_arena = self._split(3)

        # skip_first_play: on the first iteration after a (re)start, train
        # on the restored ring instead of generating new games
        skip_sp = cfg.skip_first_selfplay and not self._selfplay_ran and int(self.replay.size) > 0
        self._selfplay_ran = True
        selfplay_moves = 0
        selfplay_truncated = 0
        if not skip_sp:
            gen = self._gen(k_sp)
            B, A, alpha = cfg.selfplay.batch_size, game.num_actions, cfg.mcts.dirichlet_alpha
            permute = cfg.selfplay.full_search_prob is not None

            def draws(t):
                return sample_draws(gen, B, A, alpha, dev, permute=permute)

            with self.timer.phase("selfplay"):
                model = self.incumbent.model
                states = []
                if self._recycle:
                    self.actor_carry, traj, stats = self._selfplay(model, self.actor_carry, draws)
                else:
                    traj, stats, *states = self._selfplay(model, draws)
                # the ranks' games in global order ([T, B] samples)
                traj, states = gather_batch(self.mesh, (traj, states), dim=1)
                stats = gather_batch(self.mesh, stats)
                synchronize(traj.features)
            selfplay_moves, selfplay_truncated = torch.stack(
                [stats.num_moves.sum(), (~stats.done).sum()]).tolist()
            with self.timer.phase("replay_insert"):
                self.replay = replay_insert(self.replay, game, traj)
                if self._reanalyze is not None:
                    self.positions = position_insert(
                        self.positions, states[0], traj.value, traj.valid, self.iteration,
                        stride=cfg.reanalyze.record_stride)
                synchronize(self.replay.data)
            if self.example_store is not None:
                self._archive_examples(traj)
            del traj
        reanalyzed = reanalyze_age = None
        if self._reanalyze is not None and (self.iteration + 1) % cfg.reanalyze.interval == 0:
            (k_rz,) = self._split(1)
            with self.timer.phase("reanalyze"):
                rz_traj, reanalyzed, age = self._reanalyze(
                    self.incumbent.model, self.positions, *self._reanalyze_draws(k_rz),
                    iteration=self.iteration)
                rz_traj = gather_batch(self.mesh, rz_traj, dim=1)
                self.replay = replay_insert(self.replay, game, rz_traj)
                synchronize(self.replay.data)
            # the staleness metric: near 0, the ring wraps within an
            # iteration and the pass refreshes targets that were never stale
            reanalyze_age = round(age, 3)
        with self.timer.phase("train"):
            candidate, losses = self._train_phase(copy_train_state(self.incumbent), self.replay,
                                                  self._gen(k_train))
            synchronize(losses)
        with self.timer.phase("arena"):
            # a Gumbel gate arena takes root samples in place of tie uniforms
            result = self._arena(candidate.model, self.incumbent.model,
                                 self._ties(k_arena, cfg.mcts.gumbel))

        cw, iw, dr = result.cand_wins, result.inc_wins, result.draws
        accepted = gate(result, cfg.arena.update_threshold)
        cand_id = self.model_id + 1
        rating = self.elo.record_match(cand_id, self.model_id, cw, iw, dr, accepted)
        if accepted:
            self.incumbent = candidate
            self.model_id = cand_id
        del candidate

        self.iteration += 1
        anchor = anchored_elo = anchored_se = None
        if self._anchor_arena is not None and (
            self.iteration % cfg.arena.anchor_interval == 0
            or self.iteration <= (cfg.arena.anchor_warmup or 0)
        ):
            anchor, anchored_elo, anchored_se = self._anchored_rating_pass()

        phases = self.timer.reset()
        loss_first, loss_last = losses[[0, -1]].tolist()
        record = {
            "iteration": self.iteration,
            "model_id": self.model_id,
            "accepted": accepted,
            "arena_wins": cw,
            "arena_losses": iw,
            "arena_draws": dr,
            "win_rate": cw / max(cw + iw, 1),
            "candidate_elo": rating,
            "loss_first": loss_first,
            "loss_last": loss_last,
            "replay_size": int(self.replay.size),
            "replay_total": replay_total(self.replay),
            "selfplay_moves": selfplay_moves,
            "selfplay_truncated": selfplay_truncated,
            "eval_folded": self._eval_folded,
            **({"reanalyzed": reanalyzed} if reanalyzed is not None else {}),
            **({"reanalyze_age_mean": reanalyze_age} if reanalyze_age is not None else {}),
            **({"anchor_win_rate": round(anchor, 4)} if anchor is not None else {}),
            **({"anchored_elo": round(anchored_elo, 2)} if anchored_elo is not None else {}),
            # the ±1 Fisher-information standard error of the anchored fit
            **({"anchored_elo_se": round(anchored_se, 2)} if anchored_se is not None else {}),
            **{f"t_{k}": round(v, 3) for k, v in phases.items()},
        }
        if self._primary:
            self.metrics.log(record)
        interval = max(cfg.checkpoint_interval, 1)
        if self.iteration % interval == 0:
            # with replay_save_stride=k only every k-th periodic save
            # carries the rings, the first one among them
            stride = max(cfg.replay_save_stride, 1)
            self.save(rings=(self.iteration // interval) % stride == 1 % stride)
        return record

    def _archive_examples(self, traj) -> None:
        """Mirror the trajectory's valid samples into the host store and
        save it as ``{iteration}.examples`` in the checkpoint directory."""
        valid = traj.valid.reshape(-1)
        n = valid.shape[0]
        feats = traj.features.reshape(n, -1)[valid].float().cpu().numpy()
        pis = traj.pi.reshape(n, -1)[valid].float().cpu().numpy()
        vals = traj.value.reshape(-1)[valid].float().cpu().numpy()
        self.example_store.append(feats, pis, vals)
        self.example_store.save(os.path.join(self.cfg.checkpoint_dir,
                                             f"{self.iteration}.examples"))

    def _play(self, arena, model_a, model_b, reps: int = 1) -> tuple:
        """``reps`` arenas of ``model_a`` (the candidate's seat) against
        ``model_b``, each on its own seed: summed ``(wins_a, wins_b,
        draws)``."""
        w = l = d = 0
        for _ in range(reps):
            (k,) = self._split(1)
            with self.timer.phase("anchor"):
                r = arena(model_a, model_b, self._ties(k))
            w, l, d = w + r.cand_wins, l + r.inc_wins, d + r.draws
        return w, l, d

    def _anchored_rating_pass(self):
        """Anchored Elo: the incumbent against the fixed pure-MCTS anchor,
        the ladder's rungs and every pool snapshot; the whole match graph
        refitted with the anchor pinned at 0; then the incumbent
        snapshotted into the pool. Returns ``(anchor win rate, anchored
        Elo, its standard error)``."""
        me = self.model_id
        inc = self.incumbent.model
        cfg = self.cfg.arena

        # warmup passes repeat the anchor arena: the earliest
        # generation-vs-anchor edge lies on every path to the gauge
        in_warmup = self.iteration <= (cfg.anchor_warmup or 0)
        reps = max(int(cfg.anchor_warmup_mult), 1) if in_warmup else 1
        aw, al, ad = self._play(self._anchor_arena, inc, self._uniform, reps)
        anchor_wr = aw / max(aw + al, 1)
        self.pool_matches.append({"a": me, "b": "anchor", "wins_a": aw, "wins_b": al, "draws": ad})

        if self._rung_chain and not any(isinstance(m["a"], str) for m in self.pool_matches):
            # one-time ladder calibration: the rungs are fixed agents, so
            # the chain's edges are permanent (they persist in the sidecar)
            mult = max(int(cfg.anchor_warmup_mult), 1)
            for lo, hi, chain_arena in self._rung_chain:
                w, l, d = self._play(chain_arena, self._uniform, self._uniform, mult)
                self.pool_matches.append({"a": lo, "b": hi, "wins_a": w, "wins_b": l, "draws": d})
        for rung, rung_arena in self._rung_arenas.items():
            # a rung the incumbent itself swept (no loss, no draw) in its
            # last two matches against it carries no more information
            hist = [m for m in self.pool_matches if m["b"] == rung and m["a"] == me]
            if len(hist) >= 2 and all(m["wins_b"] == 0 and m["draws"] == 0 for m in hist[-2:]):
                continue
            w, l, d = self._play(rung_arena, inc, self._uniform, reps)
            self.pool_matches.append({"a": me, "b": rung, "wins_a": w, "wins_b": l, "draws": d})

        for gen_id, snap in self.pool:
            if gen_id == me:
                continue
            # snapshots stay on the host; each is staged onto the device
            # only for its arena
            w, l, d = self._play(self._rating_arena, inc, self._model_from(snap))
            self.pool_matches.append({"a": me, "b": gen_id, "wins_a": w, "wins_b": l, "draws": d})

        n_cross = int(cfg.pool_cross_matches or 0)
        if n_cross > 0 and len(self.pool) >= 2:
            # pool-vs-pool matches where the information is: the pair with
            # the fewest recorded games, ties toward the closest fitted
            # ratings, then by ids
            games_between = {}
            for m in self.pool_matches:
                k = frozenset((m["a"], m["b"]))
                games_between[k] = games_between.get(k, 0) + m["wins_a"] + m["wins_b"] + m["draws"]
            rat = self.anchored_ratings
            pool_by_id = dict(self.pool)
            cands = sorted(
                ((g1, g2) for (g1, g2) in itertools.combinations(sorted(pool_by_id), 2)
                 if g1 != me and g2 != me),
                key=lambda pair: (
                    games_between.get(frozenset(pair), 0),
                    abs(rat.get(pair[0], 0.0) - rat.get(pair[1], 0.0)),
                    pair,
                ),
            )
            for g1, g2 in cands[:n_cross]:
                w, l, d = self._play(self._rating_arena, self._model_from(pool_by_id[g1]),
                                     self._model_from(pool_by_id[g2]))
                self.pool_matches.append({"a": g1, "b": g2, "wins_a": w, "wins_b": l, "draws": d})

        self.anchored_ratings = fit_elo(self.pool_matches, "anchor", 0.0)
        se = elo_standard_errors(self.pool_matches, "anchor", self.anchored_ratings).get(me)
        self._pool_insert(me, inc.state_dict())
        return anchor_wr, self.anchored_ratings.get(me), se

    def _pool_insert(self, gen_id, snap: dict) -> None:
        """Keep the newest snapshot (a host copy of ``snap``, a state
        dict); evict toward evenly spaced generations: the member whose
        neighbours are closest, the youngest of a tie, never the newest."""
        snap = {k: v.detach().to("cpu", copy=True) for k, v in snap.items()}
        self.pool = [(g, v) for g, v in self.pool if g != gen_id]
        self.pool.append((gen_id, snap))
        self.pool.sort(key=lambda t: t[0])
        limit = max(self.cfg.arena.pool_size, 1)
        while len(self.pool) > limit:
            gens = [g for g, _ in self.pool]
            best_i, best_gap = 0, None
            for i in range(len(gens) - 1):
                lo = gens[i - 1] if i > 0 else 2 * gens[0] - gens[1]
                gap = gens[i + 1] - lo
                if best_gap is None or gap <= best_gap:
                    best_i, best_gap = i, gap
            del self.pool[best_i]

    def _any_rank(self, flag: bool) -> bool:
        """``flag`` on any rank (under a mesh every rank then stops
        together, its collectives matched)."""
        if self.mesh is None:
            return flag
        return bool(all_reduce(torch.tensor([int(flag)], device=self.device), self.mesh,
                               op="max"))

    def learn(self, num_iterations: Optional[int] = None) -> list:
        """The outer loop. SIGTERM is caught for its duration: the
        iteration in flight finishes, the whole state is saved, and
        ``learn`` returns; a new Coach over the same ``checkpoint_dir``
        resumes exactly. The run's last state is always saved with its
        rings. Under a mesh a SIGTERM to any rank stops every rank after
        the same iteration."""
        n = num_iterations if num_iterations is not None else self.cfg.num_iterations
        records = []
        caught = []
        prev_handler = None
        in_main = threading.current_thread() is threading.main_thread()
        if in_main:
            prev_handler = signal.signal(signal.SIGTERM, lambda signum, frame: caught.append(signum))
        try:
            for _ in range(n):
                records.append(self.run_iteration())
                if self._any_rank(bool(caught)):
                    if self.cfg.checkpoint_dir:
                        log.warning("SIGTERM: checkpointing at iteration %d and stopping "
                                    "(resume from %s)", self.iteration, self.cfg.checkpoint_dir)
                    else:
                        log.warning("SIGTERM: stopping at iteration %d; no checkpoint_dir is "
                                    "configured, the training state is NOT saved", self.iteration)
                    break
            if records and (self.iteration % max(self.cfg.checkpoint_interval, 1) != 0
                            or not self._last_save_rings):
                self.save(rings=True)
        finally:
            if in_main:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None else signal.SIG_DFL)
        return records
