from alphazero_tpu_torch.mcts.fused import (
    fused_mlp_rounds_search,
    fused_mlp_search,
    fused_rounds_search,
    fused_search,
    make_fused_root_fn,
    mlp_eval,
)
from alphazero_tpu_torch.mcts.gumbel import GumbelResult, make_gumbel_search_fn
from alphazero_tpu_torch.mcts.hybrid import PLAIN, SearchKernels, make_hybrid_root_fn
from alphazero_tpu_torch.mcts.search import make_search_fn
from alphazero_tpu_torch.mcts.tree import Tree
from alphazero_tpu_torch.mcts.tt import TTTree, make_tt_search_fn

__all__ = [
    "Tree",
    "make_search_fn",
    "TTTree",
    "make_tt_search_fn",
    "make_gumbel_search_fn",
    "GumbelResult",
    "make_fused_root_fn",
    "fused_search",
    "fused_mlp_search",
    "fused_rounds_search",
    "fused_mlp_rounds_search",
    "mlp_eval",
    "make_hybrid_root_fn",
    "SearchKernels",
    "PLAIN",
]
