"""Tracing: the port's named spans and a trace exporter.

Counterpart of ``nnacousticmodeling_tpu/utils/profiling.py``:

* ``span(name)`` -- a named host range (``torch.profiler.
  record_function``) around the port's work at its layer boundaries.
  Inside a ``torch.profiler`` session (``trace`` below, or any other)
  each span lies on the profiler's clock beside the device operations;
  a device operation's correlation id leads to its host launch, and the
  launch lies inside the span of the layer that made it. Outside a
  session a span is one flag check and a shared no-op context: it
  enters no profiler op;
* ``trace(dir)`` -- context manager around ``torch.profiler.profile``
  (CPU activity, plus CUDA when a card is present) that writes a
  TensorBoard-loadable trace (``tensorboard_trace_handler``) into
  ``dir``; the profile is also yielded, for ``key_averages()``.

The spans, all named ``nnam.<layer>.<what>``:

* training engine (``train/engine.py``): ``nnam.train.epoch`` (one
  epoch: its updates, metrics, validation, best-model copy and
  snapshot), inside it ``nnam.train.shuffle`` (the host's shuffle and
  index block), ``nnam.train.index_upload`` (the block's copy to the
  device), ``nnam.train.update`` (one update: a direct call or a CUDA
  graph replay), ``nnam.train.capture`` (the capture of the update),
  ``nnam.train.epoch_metrics`` (the epoch's mean loss and accuracy and
  their fetch), ``nnam.train.validate`` (validation, its fetch
  included), ``nnam.train.best_copy`` (the copy of the best model) and
  ``nnam.train.snapshot`` (writing the snapshot);
* network stack (``models/networks.py``, ``ops/numerics.py``):
  ``nnam.net.input_proj`` (a recurrent layer's input projection),
  ``nnam.net.layout`` (a copy between batch-major and time-major
  layouts), ``nnam.net.output`` (the output layer) and
  ``nnam.numerics.log_softmax``;
* decoder (``decoder/viterbi.py``): ``nnam.decode.forward`` (the Viterbi
  forward of whichever backend runs), ``nnam.decode.backtrace`` and
  ``nnam.decode.tables`` (the collapsed tables built for a new pack
  factor);
* ``nnam.kernels.build`` (``kernels.build``'s ``nvcc`` runs).

An update replayed from a CUDA graph runs no Python, so the work inside
one (the loss, the gradients, the optimizer step) has no span of its
own: a trace splits it by kernel name.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A named range in the current profiler session, or a shared no-op
    context when no session is recording."""
    if not getattr(_autograd_profiler, "_is_profiler_enabled", True):
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[object]:
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))
                 ) as prof:
        yield prof
