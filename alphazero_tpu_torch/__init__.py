"""alphazero_tpu_torch — the PyTorch/CUDA port of ``alphazero_tpu``.

The JAX package ``alphazero_tpu`` stays the reference; this package mirrors
its module names so each counterpart is easy to find, and is tested against
it on identical numpy inputs (``tests/test_torch_*.py``).

Ported so far (the Connect-Four ResNet self-play slice):

  - :mod:`alphazero_tpu_torch.config`   — ``MCTSConfig``, ``PUCT_EPS``
  - :mod:`alphazero_tpu_torch.games`    — ``Game`` protocol, ``ConnectFour`` + ``FlatOps``
  - :mod:`alphazero_tpu_torch.ops`      — masked policy, action probabilities, root prior
  - :mod:`alphazero_tpu_torch.models`   — ``UniformModel``, ``AZResNet`` (BN-folded eval),
    the flax -> torch parameter converter
  - :mod:`alphazero_tpu_torch.mcts`     — the hybrid descend/merge search engine
  - :mod:`alphazero_tpu_torch.kernels`  — the hand-written CUDA kernels of that engine
  - :mod:`alphazero_tpu_torch.selfplay` — the steady-state self-play actor

The package imports ``torch`` and nothing of ``jax`` or of the JAX package.
"""

from alphazero_tpu_torch.config import MCTSConfig, PUCT_EPS

__all__ = ["MCTSConfig", "PUCT_EPS"]
