from .posteriors import (default_buckets, ensemble_log_posteriors,
                         ff_log_posteriors, rnn_log_posteriors)

__all__ = ["default_buckets", "ensemble_log_posteriors", "ff_log_posteriors",
           "rnn_log_posteriors"]
