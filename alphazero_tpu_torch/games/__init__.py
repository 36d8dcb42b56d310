from alphazero_tpu_torch.games.base import Game
from alphazero_tpu_torch.games.connect_four import ConnectFour, FlatOps
from alphazero_tpu_torch.games.gomoku import Gomoku, GomokuFlatOps
from alphazero_tpu_torch.games.hex import Hex, HexFlatOps
from alphazero_tpu_torch.games.othello import Othello, OthelloFlatOps

__all__ = ["Game", "ConnectFour", "FlatOps", "Gomoku", "GomokuFlatOps", "Hex", "HexFlatOps",
           "Othello", "OthelloFlatOps"]
