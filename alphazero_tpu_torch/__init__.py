"""alphazero_tpu_torch — the PyTorch/CUDA port of ``alphazero_tpu``.

The JAX package ``alphazero_tpu`` stays the reference; this package mirrors
its module names so each counterpart is easy to find, and is tested against
it on identical numpy inputs (``tests/test_torch_*.py``).

Ported so far (the Connect-Four self-play slices: ResNet, uniform, MLP;
Othello's, Gomoku's and Hex's self-play on the hybrid engine with any
model; the learner loop: episode generation, replay, training; the outer
loop: the arena gate, the coach with its anchored Elo, checkpoints, on
every game; the training CLIs and the checkpoint evaluator):

  - :mod:`alphazero_tpu_torch.config`   — ``MCTSConfig``, ``PUCT_EPS``, ``SelfPlayConfig``,
    ``ReplayConfig``, ``TrainConfig``, ``ArenaConfig``, ``ReanalyzeConfig``, ``AZConfig``
  - :mod:`alphazero_tpu_torch.games`    — ``Game`` protocol, ``ConnectFour`` + ``FlatOps``,
    ``Othello`` + ``OthelloFlatOps``, ``Gomoku`` + ``GomokuFlatOps``, ``Hex`` + ``HexFlatOps``
  - :mod:`alphazero_tpu_torch.ops`      — masked policy, action probabilities, root prior
  - :mod:`alphazero_tpu_torch.models`   — ``UniformModel``, ``AZResNet`` and ``AZConvNet``
    (BN-folded evals), ``MLPNet`` (with its packed in-kernel weights), the flax -> torch
    parameter converters
  - :mod:`alphazero_tpu_torch.mcts`     — the hybrid descend/merge engine and the fused engine
  - :mod:`alphazero_tpu_torch.kernels`  — the hand-written CUDA kernels of both engines
  - :mod:`alphazero_tpu_torch.selfplay` — the steady-state actor, the fixed-scan and the
    recycling episode generators with exact value targets
  - :mod:`alphazero_tpu_torch.replay`   — the packed replay ring on the device
  - :mod:`alphazero_tpu_torch.train`    — the learner: loss, Adam step, training phase
  - :mod:`alphazero_tpu_torch.arena`    — the batched arena and the gate
  - :mod:`alphazero_tpu_torch.coach`    — the outer loop: gate, anchored Elo, save and resume
  - :mod:`alphazero_tpu_torch.checkpoint` — whole-state checkpoints with a JSON sidecar
  - :mod:`alphazero_tpu_torch.utils`    — Elo ratings, metrics logging, phase timers
  - :mod:`alphazero_tpu_torch.examples` — the training CLIs ``train_connect_four``,
    ``train_othello``, ``train_gomoku``, ``train_hex``, and ``eval_checkpoints``

The package imports ``torch`` and nothing of ``jax`` or of the JAX package.
"""

from alphazero_tpu_torch.config import MCTSConfig, PUCT_EPS

__all__ = ["MCTSConfig", "PUCT_EPS"]
