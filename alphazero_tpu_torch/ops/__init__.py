from alphazero_tpu_torch.ops.policy import (
    Draws,
    action_probs,
    masked_policy,
    root_prior,
    sample_draws,
)

__all__ = ["masked_policy", "action_probs", "root_prior", "Draws", "sample_draws"]
