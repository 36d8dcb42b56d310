from alphazero_tpu_torch.mcts.fused import (
    fused_mlp_search,
    fused_search,
    make_fused_root_fn,
    mlp_eval,
)
from alphazero_tpu_torch.mcts.hybrid import PLAIN, SearchKernels, make_hybrid_root_fn

__all__ = [
    "make_fused_root_fn",
    "fused_search",
    "fused_mlp_search",
    "mlp_eval",
    "make_hybrid_root_fn",
    "SearchKernels",
    "PLAIN",
]
