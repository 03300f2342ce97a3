"""End-to-end CTC phone recognition: a bidirectional wrapper over any
recurrent stack of the zoo feeds a phone + blank softmax trained with
CTC; greedy best-path decoding collapses repeats and removes blanks.

Counterpart of ``nnacousticmodeling_tpu/models/ctc.py``. ``BiRNNCTC`` is
an ``nn.Module`` whose ``fwd`` and ``bwd`` stacks are two modules of the
base's class and whose ``out`` is a fresh dense layer from the two
directions' concatenated last-layer states to ``num_phones + 1`` classes
(blank = 0); its ``state_dict`` names are the JAX params' paths
(``fwd.cells.0.wx``, ..., ``out.w``), so JAX params load through
``load_jax_params``. Each direction runs its stack's ``hidden_sequence``,
so with ``scan_impl="pallas"`` both run on the recurrence kernels: the
differentiable ``lstm_scan_train`` / ``gated_scan_train`` /
``peephole_scan_train`` when training, under autograd, the inference
kernels otherwise. The backward direction reads each utterance reversed
within its own length.

``ctc_loss`` is the JAX ``optax.ctc_loss(...).mean()``: the batch mean
of each sequence's negative log-likelihood, optax's recursion included
(``ops/ctc_cuda.py``): an alignment that cannot fit its frames gives
optax's large finite loss and a finite gradient. CUDA tensors take the
hand-written kernels of ``csrc/ctc_loss.cu``, CPU tensors the plain
version; no length is read back to the host.

``make_ctc_train_step`` keeps, per input shape, a step of static buffers
(as ``jax.jit`` keeps one program per shape); on the card it runs
through the training engine's ``_Updates``, so the step's second call
captures it as a CUDA graph and every later call is one replay, as the
JAX step is one jitted program. The graphs of one step function share
one memory pool, so the device memory they hold is about the largest
shape's, not the sum over shapes.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import ctc_cuda
from ..train.engine import _stage_tensors, _Updates
from . import cells
from .networks import _Dense, _RecurrentStack, redraw_params

BLANK_ID = 0


def _reverse_within_length(x: torch.Tensor, lengths) -> torch.Tensor:
    """Reverse (B, T, D) along T inside each row's length; padded
    positions keep their index (their content is masked downstream)."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    lens = torch.as_tensor(lengths, device=x.device).long()[:, None]
    idx = torch.where(pos < lens, lens - 1 - pos, pos)          # (B, T)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


class BiRNNCTC(nn.Module):
    """Bidirectional recurrent CTC model over ``base``, a stack of
    ``models.networks`` (its own output layer is kept, unused, as in the
    JAX params). ``bwd`` is a second stack of the same architecture with
    its own draw of weights (``redraw_params`` from ``seed + 1``); ``out``
    is drawn from ``seed``."""

    def __init__(self, base: _RecurrentStack, num_phones: int, *,
                 seed: int = 0):
        super().__init__()
        self.num_phones = num_phones
        self.fwd = base
        self.bwd = copy.deepcopy(base)
        self.bwd.load_state_dict(redraw_params(base, seed + 1))
        gen = torch.Generator().manual_seed(seed)
        self.out = _Dense(cells.dense_init(2 * base.units, self.num_classes,
                                           gen))
        self.to(base.device)

    @property
    def num_classes(self) -> int:
        return self.num_phones + 1

    @property
    def device(self) -> torch.device:
        return self.out.w.device

    def apply_sequence(self, xs: torch.Tensor, lengths=None,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        """(B, T, D) -> (B, T, num_phones + 1) logits.

        ``lengths`` (B,) makes the backward pass reverse each sequence
        within its own length, so logits on valid frames do not depend
        on the batch's padding; without it the whole padded axis
        reverses (right only for unpadded batches)."""
        h_fwd, _ = self.fwd.hidden_sequence(xs, train=train,
                                            generator=generator)
        if lengths is None:
            bwd_in = xs.flip(1)
        else:
            bwd_in = _reverse_within_length(xs, lengths)
        h_bwd, _ = self.bwd.hidden_sequence(bwd_in, train=train,
                                            generator=generator)
        if lengths is None:
            h_bwd = h_bwd.flip(1)
        else:
            h_bwd = _reverse_within_length(h_bwd, lengths)
        h = torch.cat([h_fwd, h_bwd], dim=-1)
        b, t, _ = h.shape
        logits = cells.dense({"w": self.out.w, "b": self.out.b},
                             h.reshape(b * t, -1))
        return logits.reshape(b, t, -1)

    forward = apply_sequence


def ctc_loss(logits: torch.Tensor, logit_lengths, labels,
             label_lengths) -> torch.Tensor:
    """Mean CTC loss over a padded batch (blank = 0): logits (B, T, C),
    labels (B, S) padded, the lengths (B,) (numpy arrays, lists or
    tensors)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return ctc_cuda.per_sequence_loss(logp, labels, logit_lengths,
                                      label_lengths).mean()


def greedy_decode(logits: torch.Tensor, lengths: Sequence[int]
                  ) -> List[List[int]]:
    """Best-path decode: framewise argmax, collapse repeats, drop
    blanks. Returns phone-id sequences (ids are 1-based; 0 = blank)."""
    path = logits.argmax(dim=-1).cpu().numpy()
    out = []
    for b in range(path.shape[0]):
        seq = []
        prev = -1
        for t in range(int(lengths[b])):
            s = int(path[b, t])
            if s != prev and s != BLANK_ID:
                seq.append(s)
            prev = s
        out.append(seq)
    return out


class _StepProgram:
    """The CTC step at one input shape: static buffers for the features,
    the two length vectors, the labels and the loss, and ``_Updates``
    over a function of them (on the card the second call captures it,
    every later call replays it; elsewhere each call is a direct
    call). ``pool``: the graph memory pool shared with the step
    function's other shapes (``_capture_update``'s; None: its own)."""

    def __init__(self, model, opt, xs, labels, generator, graph: bool,
                 pool=None):
        dev = model.device
        b = xs.shape[0]
        self.xs = torch.empty(xs.shape, dtype=xs.dtype, device=dev)
        self.x_lens = torch.zeros(b, dtype=torch.int64, device=dev)
        self.labels = torch.zeros(labels.shape, dtype=torch.int64,
                                  device=dev)
        self.y_lens = torch.zeros(b, dtype=torch.int64, device=dev)
        self.loss = torch.zeros((), dtype=torch.float32, device=dev)
        self.graph = graph
        self.generator = generator

        def body():
            logits = model.apply_sequence(self.xs, lengths=self.x_lens,
                                          train=True,
                                          generator=self.generator)
            loss = ctc_loss(logits, self.x_lens, self.labels, self.y_lens)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            with torch.no_grad():
                self.loss.copy_(loss)

        self.updates = _Updates(
            body, () if generator is None else generator,
            _stage_tensors(model, opt), graph, caller="make_ctc_train_step",
            pool=pool)

    def __call__(self, xs, x_lens, labels, y_lens, generator):
        if generator is not self.generator:
            if self.graph:
                raise ValueError(
                    "make_ctc_train_step: a step of this shape was captured "
                    "with another generator; pass the same one (or build "
                    "the step with cuda_graph=False)")
            self.generator = generator
        self.xs.copy_(xs)
        self.x_lens.copy_(torch.as_tensor(x_lens))
        self.labels.copy_(labels)
        self.y_lens.copy_(torch.as_tensor(y_lens))
        self.updates.begin_epoch()
        self.updates()
        return self.loss.clone()


def make_ctc_train_step(model: BiRNNCTC, opt: torch.optim.Optimizer,
                        cuda_graph: bool = True):
    """``step(xs, x_lens, labels, y_lens, generator=None) -> loss``: one
    update of ``model`` in place by ``opt`` (built over its parameters,
    e.g. ``train.make_optimizer("adam", lr, model.parameters())``) on
    the CTC loss of the training-mode logits; the JAX step's
    ``(params, opt_state)`` are the module and the optimizer here.

    The inputs (tensors, numpy arrays or lists) are copied into static
    buffers kept per ``(xs.shape, xs.dtype, labels.shape)``. On the card
    (and unless ``cuda_graph=False``) a shape's first call is a direct
    call (the warm-up, which also makes Adam's device state), its second
    captures the step as a CUDA graph with ``generator`` registered, and
    every later call replays it; a failed capture or replay raises, and
    so does a later call of that shape with another generator. The loss
    is a device scalar (no synchronisation).

    The shapes' graphs take their memory from one pool: they never replay
    at once, and each replay writes its temporaries before it reads them,
    so one shape's replay may overwrite another's. The gradients are made
    inside the captured step (``zero_grad(set_to_none=True)``), so after
    a replay ``param.grad`` holds the last captured shape's buffers, which
    a later replay of another shape may have overwritten: read gradients
    only after a direct call. Memory stays near the largest shape's need
    when the largest shape is captured first; a shape captured after
    smaller ones cannot reuse their blocks, which stay reserved."""
    programs: Dict[tuple, _StepProgram] = {}
    graph = cuda_graph and model.device.type == "cuda"
    pool = torch.cuda.graph_pool_handle() if graph else None

    def step(xs, x_lens, labels, y_lens, generator=None):
        xs, labels = torch.as_tensor(xs), torch.as_tensor(labels)
        key = (tuple(xs.shape), xs.dtype, tuple(labels.shape))
        prog = programs.get(key)
        if prog is None:
            prog = programs[key] = _StepProgram(model, opt, xs, labels,
                                                generator, graph, pool)
        return prog(xs, x_lens, labels, y_lens, generator)

    return step
