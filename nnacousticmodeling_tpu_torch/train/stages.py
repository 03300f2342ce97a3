"""Staged hyperparameter schedules.

The reference trains each network through N stages, where the stage
lists (-e/-o/-b/--lr/--early-stopping) may have different lengths and
shorter lists repeat their last value (train.py:272-283 via
``index_padded``, orcus_util.py:6-8; documented in README.md:129-156).
A copy of the JAX package's ``train/stages.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence


def index_padded(values: Sequence, idx: int):
    """values[idx], clamped to the last element (orcus_util.py:6-8)."""
    return values[min(len(values) - 1, idx)]


@dataclass(frozen=True)
class TrainStage:
    epoch: int
    optimizer: str       # sgd | momentumsgd | adam
    batch_size: int
    lr: float
    early_stopping: bool


def build_stages(
    epochs: Sequence[int],
    optimizers: Sequence[str],
    batch_sizes: Sequence[int],
    lrs: Sequence[float],
    early_stopping: Sequence[bool],
) -> List[TrainStage]:
    n = max(len(epochs), len(optimizers), len(batch_sizes), len(lrs),
            len(early_stopping))
    return [
        TrainStage(
            epoch=index_padded(epochs, i),
            optimizer=index_padded(optimizers, i),
            batch_size=index_padded(batch_sizes, i),
            lr=index_padded(lrs, i),
            early_stopping=index_padded(early_stopping, i),
        )
        for i in range(n)
    ]
