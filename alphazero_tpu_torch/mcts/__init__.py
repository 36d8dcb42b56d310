from alphazero_tpu_torch.mcts.hybrid import PLAIN, SearchKernels, make_hybrid_root_fn

__all__ = ["make_hybrid_root_fn", "SearchKernels", "PLAIN"]
