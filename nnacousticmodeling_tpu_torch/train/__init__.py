from .stages import TrainStage, build_stages, index_padded
from .optimizers import make_optimizer
from .streams import sentence_shuffle_indices, stream_batch_indices
from .engine import TrainConfig, train_network, TrainResult
from .checkpoint import load_jax_params, load_pytree, save_pytree

__all__ = [
    "TrainStage",
    "build_stages",
    "index_padded",
    "make_optimizer",
    "sentence_shuffle_indices",
    "stream_batch_indices",
    "TrainConfig",
    "train_network",
    "TrainResult",
    "save_pytree",
    "load_pytree",
    "load_jax_params",
]
