from alphazero_tpu_torch.mcts.fused import fused_search, make_fused_root_fn
from alphazero_tpu_torch.mcts.hybrid import PLAIN, SearchKernels, make_hybrid_root_fn

__all__ = ["make_fused_root_fn", "fused_search", "make_hybrid_root_fn", "SearchKernels", "PLAIN"]
