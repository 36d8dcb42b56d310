from alphazero_tpu_torch.ops.policy import (
    Draws,
    action_probs,
    gumbel_from_uniform,
    masked_policy,
    root_prior,
    sample_draws,
)

__all__ = ["masked_policy", "action_probs", "root_prior", "Draws", "sample_draws",
           "gumbel_from_uniform"]
