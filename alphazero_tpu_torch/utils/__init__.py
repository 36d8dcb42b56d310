from alphazero_tpu_torch.utils.elo import (
    EloTracker,
    elo_from_match,
    elo_standard_errors,
    fit_elo,
)
from alphazero_tpu_torch.utils.logging import MetricsLogger
from alphazero_tpu_torch.utils.timing import PhaseTimer, synchronize

__all__ = [
    "elo_from_match",
    "EloTracker",
    "fit_elo",
    "elo_standard_errors",
    "MetricsLogger",
    "PhaseTimer",
    "synchronize",
]
