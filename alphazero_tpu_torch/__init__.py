"""alphazero_tpu_torch — the PyTorch/CUDA port of ``alphazero_tpu``.

The JAX package ``alphazero_tpu`` stays the reference; this package mirrors
its module names so each counterpart is easy to find, and is tested against
it on identical numpy inputs (``tests/test_torch_*.py``).

Ported so far (the Connect-Four self-play slices: ResNet, uniform, MLP;
Othello's, Gomoku's and Hex's self-play on the hybrid engine with any
model):

  - :mod:`alphazero_tpu_torch.config`   — ``MCTSConfig``, ``PUCT_EPS``
  - :mod:`alphazero_tpu_torch.games`    — ``Game`` protocol, ``ConnectFour`` + ``FlatOps``,
    ``Othello`` + ``OthelloFlatOps``, ``Gomoku`` + ``GomokuFlatOps``, ``Hex`` + ``HexFlatOps``
  - :mod:`alphazero_tpu_torch.ops`      — masked policy, action probabilities, root prior
  - :mod:`alphazero_tpu_torch.models`   — ``UniformModel``, ``AZResNet`` (BN-folded eval),
    ``MLPNet`` (with its packed in-kernel weights), the flax -> torch parameter converter
  - :mod:`alphazero_tpu_torch.mcts`     — the hybrid descend/merge engine and the fused engine
  - :mod:`alphazero_tpu_torch.kernels`  — the hand-written CUDA kernels of both engines
  - :mod:`alphazero_tpu_torch.selfplay` — the steady-state self-play actor

The package imports ``torch`` and nothing of ``jax`` or of the JAX package.
"""

from alphazero_tpu_torch.config import MCTSConfig, PUCT_EPS

__all__ = ["MCTSConfig", "PUCT_EPS"]
