"""Configuration of the port: search, self-play, replay, learner, arena
and the whole run.

The same fields, defaults and meaning as ``alphazero_tpu.config``'s
``MCTSConfig``, ``SelfPlayConfig``, ``ReplayConfig``, ``TrainConfig``,
``ArenaConfig``, ``ReanalyzeConfig`` and ``AZConfig`` (see there for each
knob's rationale), held here so that the port and
anything that runs it import nothing of the JAX package;
``tests/test_torch_imports.py`` pins each pair of dataclasses to each
other. ``MCTSConfig(**dataclasses.asdict(jax_cfg))`` converts a JAX config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# PUCT exploration epsilon (alphazero_tpu.config.PUCT_EPS)
PUCT_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class MCTSConfig:
    num_sims: int = 100              # simulations per move
    cpuct: float = 1.0               # PUCT exploration constant
    max_depth: int = 64              # descent depth cutoff
    max_nodes: Optional[int] = None  # tree capacity per game (num_sims + 1)
    dirichlet_alpha: Optional[float] = None  # root noise; None = off
    dirichlet_frac: float = 0.25
    parallel_sims: int = 1           # K leaf-parallel descents per round
    forced_playouts: Optional[float] = None  # opt-in (dense engine)
    transposition: bool = False      # opt-in transposition-DAG engine
    gumbel: bool = False             # opt-in Gumbel sequential halving
    gumbel_top_m: int = 16
    gumbel_c_visit: float = 50.0
    gumbel_value_scale: float = 0.1
    tree_reuse: bool = False         # opt-in subtree carry (dense engine)

    @property
    def nodes(self) -> int:
        return self.max_nodes if self.max_nodes is not None else self.num_sims + 1


@dataclasses.dataclass(frozen=True)
class SelfPlayConfig:
    batch_size: int = 1024           # games stepped in lockstep
    temp_threshold: int = 15         # temp 1 before this move index, 0 after
    max_moves: Optional[int] = None  # fixed scan length (game.max_moves)
    full_search_prob: Optional[float] = None  # playout-cap randomization; None = off
    cheap_sims: Optional[int] = None  # its reduced budget
    recycle: bool = False            # episode-recycling self-play
    recycle_steps: Optional[int] = None  # searches a recycling call (game.max_moves)


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    capacity: int = 1 << 18          # rows of the packed replay ring


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 256            # rows a minibatch
    learning_rate: float = 1e-3      # Adam
    steps_per_iteration: int = 256   # minibatch steps a training phase
    weight_decay: float = 0.0        # > 0: AdamW's decoupled decay
    l2_scale: float = 1e-4           # L2 on conv and dense kernels


@dataclasses.dataclass(frozen=True)
class ArenaConfig:
    num_games: int = 128             # arena games, half with each seating
    update_threshold: Optional[float] = 0.6  # gate; None = continuous (always adopt)
    num_sims: Optional[int] = None   # arena search budget (MCTSConfig's)
    anchor_interval: Optional[int] = None  # anchored rating pass every k iterations
    pool_size: int = 5               # past-generation snapshots kept
    anchor_ladder: tuple = ()        # pure-MCTS rungs at these budgets ("anchor@SIMS")
    anchor_warmup: int = 0           # also run the pass at iterations <= this
    anchor_warmup_mult: int = 1      # anchor arenas a warmup pass repeats
    pool_cross_matches: int = 0      # pool-vs-pool arenas a pass
    pool_in_checkpoint: bool = False  # persist the pool's snapshots


@dataclasses.dataclass(frozen=True)
class ReanalyzeConfig:
    batch_size: int = 1024           # positions re-searched a pass
    interval: int = 1                # a pass every k iterations
    capacity: int = 1 << 16          # position-ring slots
    num_sims: Optional[int] = None   # re-search budget (MCTSConfig's)
    record_stride: int = 1           # record every k-th valid sample


@dataclasses.dataclass(frozen=True)
class AZConfig:
    mcts: MCTSConfig = dataclasses.field(default_factory=MCTSConfig)
    selfplay: SelfPlayConfig = dataclasses.field(default_factory=SelfPlayConfig)
    replay: ReplayConfig = dataclasses.field(default_factory=ReplayConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    arena: ArenaConfig = dataclasses.field(default_factory=ArenaConfig)
    reanalyze: Optional[ReanalyzeConfig] = None  # not ported: raises in the coach
    num_iterations: int = 10         # coach iterations
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_interval: int = 1     # whole-state save every k iterations
    replay_save_stride: int = 1      # only every k-th periodic save carries the rings
    keep_checkpoints: Optional[int] = None  # retention: newest k (None keeps all)
    skip_first_selfplay: bool = False  # train on the restored ring first after a resume
