from alphazero_tpu_torch.games.base import Game
from alphazero_tpu_torch.games.connect_four import ConnectFour, FlatOps

__all__ = ["Game", "ConnectFour", "FlatOps"]
