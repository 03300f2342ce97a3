"""The CTC loss: CUDA kernel wrappers and their plain PyTorch version.

Counterpart of ``optax.ctc_loss``, which the JAX package's
``models/ctc.py::ctc_loss`` calls: a ``jax.lax.scan`` over optax's own
lattice, compiled into the jitted training step, with no Pallas kernel.
The port keeps its own copy of that recursion (optax 0.2.6,
``ctc_loss_with_forward_probs``), so it gives optax's numbers, the
infeasible alignments included: an utterance whose labels cannot fit its
frames gets a large finite loss (log(0) is ``LOG_EPSILON``) and a finite
gradient.

The lattice of a sequence of S (padded) labels: ``phi`` (S+1), the blank
after n labels, and ``emit`` (S), label n being emitted. Each frame t
with blank log-probability ``lb`` and label log-probabilities ``le``
(S):

    P'[0] = P[0],  P'[n] = lae(P[n], E[n-1] + eps * rep[n-1])
    E_t[n] = lae(P'[n] + le[n], E[n] + le[n])
    P_t[0] = P'[0] + lb,
    P_t[n] = lae(P'[n] + lb, E[n-1] + lb + eps * (1 - rep[n-1]))

(``lae`` is logaddexp, ``rep[n]`` whether label n equals label n+1, 0
for the last). Frames at or past an utterance's length carry the state.
After the last frame ``last[n] = lae(P[n], E[n-1])`` and the loss is
``-last[L]`` at the label length L. A label outside ``[0, C)`` has
log-probability 0 (optax's one-hot of it is zero).

- ``ctc_loss_reference``: the plain version, a T-step loop over the
  batch; autograd through it gives what ``jax.grad`` gives through optax
  (its logaddexp carries ``jax.numpy.logaddexp``'s derivative,
  ``exp(x - out)``). CPU tensors take it.
- ``ctc_loss_forward`` / ``ctc_loss_backward``: the kernels of
  ``csrc/ctc_loss.cu`` (the loss and the lattice's states; the gradient
  with respect to the log-probabilities by the adjoint recursion, summed
  in a fixed order), bound by ``per_sequence_loss``'s
  ``torch.autograd.Function`` on CUDA tensors. Two routes give the same
  bits: one warp an utterance (label rows up to ``WARP_MAX_LABELS``),
  and one block an utterance (longer rows, or ``route="block"``), counted
  apart in ``kernels.launches`` (``ctc_loss_forward`` /
  ``ctc_loss_forward.block``). ``*_reference`` are their plain twins
  (same outputs).

Lengths and labels become device tensors once; nothing is read back to
the host, so the loss can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import kernels

BLANK_ID = 0
#: optax's ``log_epsilon``: log(0) on the lattice
LOG_EPSILON = -1e5


class _LogAddExp(torch.autograd.Function):
    """``torch.logaddexp`` with ``jax.numpy.logaddexp``'s derivative,
    ``g * exp(x - out)`` for each operand. The two derivatives are the
    same function, but on an infeasible alignment the operands sit near
    ``LOG_EPSILON``, where ``out`` is rounded to 2**-7, and the JAX form
    carries that rounding into the gradient."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


_lae = _LogAddExp.apply


def _lattice_inputs(logprobs: torch.Tensor, labels: torch.Tensor):
    """(label log-probabilities (B, T, S), blank log-probabilities
    (B, T, 1), eps * rep (B, S), eps * (1 - rep) (B, S))."""
    B, T, C = logprobs.shape
    S = labels.shape[1]
    valid = (labels >= 0) & (labels < C)
    emit = torch.gather(logprobs, 2, labels.clamp(0, C - 1)[:, None, :]
                        .expand(B, T, S))
    emit = torch.where(valid[:, None, :], emit, torch.zeros_like(emit))
    rep = torch.zeros((B, S), dtype=torch.float32, device=logprobs.device)
    rep[:, :-1] = (labels[:, :-1] == labels[:, 1:]).float()
    return (emit, logprobs[:, :, BLANK_ID:BLANK_ID + 1],
            LOG_EPSILON * rep, LOG_EPSILON * (1.0 - rep))


def _as_index(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def _states(logprobs, labels, logit_lengths, label_lengths, keep: bool):
    """The recursion: (per-sequence loss (B,), the states after each
    frame (B, T, 2S+1) ``[phi | emit]`` when ``keep``, else None)."""
    B, T, _ = logprobs.shape
    dev = logprobs.device
    labels = _as_index(labels, dev)
    S = labels.shape[1]
    lens = _as_index(logit_lengths, dev)
    label_lens = _as_index(label_lengths, dev)
    emit, blank, eps_rep, eps_norep = _lattice_inputs(logprobs, labels)
    pad = torch.arange(T, device=dev)[None, :] >= lens[:, None]     # (B, T)
    phi = torch.full((B, S + 1), LOG_EPSILON, device=dev)
    phi[:, 0] = 0.0
    em = torch.full((B, S), LOG_EPSILON, device=dev)
    kept = []
    for t in range(T):
        le, lb = emit[:, t], blank[:, t]
        p1 = torch.cat([phi[:, :1], _lae(phi[:, 1:], em + eps_rep)], dim=1)
        next_em = _lae(p1[:, :-1] + le, em + le)
        q = p1 + lb
        next_phi = torch.cat([q[:, :1], _lae(q[:, 1:], em + lb + eps_norep)],
                             dim=1)
        p = pad[:, t, None]
        em = torch.where(p, em, next_em)
        phi = torch.where(p, phi, next_phi)
        if keep:
            kept.append(torch.cat([phi, em], dim=1))
    last = torch.cat([phi[:, :1], _lae(phi[:, 1:], em)], dim=1)
    label_len = S - (torch.arange(S, device=dev)[None, :]
                     >= label_lens[:, None]).sum(dim=1)
    loss = -last.gather(1, label_len[:, None])[:, 0]
    return loss, (torch.stack(kept, dim=1) if keep else None)


def ctc_loss_reference(logprobs: torch.Tensor, labels, logit_lengths,
                       label_lengths) -> torch.Tensor:
    """Plain PyTorch CTC loss of each sequence (B,), optax's recursion:
    logprobs (B, T, C) float32 (log-softmaxed), labels (B, S) padded,
    the lengths (B,). Differentiable through autograd."""
    return _states(logprobs, labels, logit_lengths, label_lengths, False)[0]


def ctc_loss_forward_reference(logprobs, labels, logit_lengths,
                               label_lengths
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``ctc_loss_forward``: (loss (B,), states (B, T,
    2S+1)); a padded frame's row holds the carried state, which the
    kernel leaves unwritten."""
    with torch.no_grad():
        return _states(logprobs, labels, logit_lengths, label_lengths, True)


def ctc_loss_backward_reference(logprobs, labels, logit_lengths,
                                label_lengths, states, grad) -> torch.Tensor:
    """Plain twin of ``ctc_loss_backward``: d(sum grad * loss) /
    dlogprobs (B, T, C) by autograd through the plain version
    (``states`` unused)."""
    del states
    with torch.enable_grad():
        lp = logprobs.detach().requires_grad_(True)
        loss = ctc_loss_reference(lp, labels, logit_lengths, label_lengths)
        (g,) = torch.autograd.grad(loss, lp, grad)
    return g


# ---- the kernels -----------------------------------------------------------

#: the warp route's limits (``csrc/ctc_loss.cu``: K = 8 slots of a lane,
#: WARP_MAX_CLASSES); longer label rows or more classes take the block
#: route
WARP_MAX_LABELS = 255
WARP_MAX_CLASSES = 4096

_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]


def _lib():
    lib = kernels.load("ctc_loss")
    for route in ("warp", "block"):
        for entry, argtypes in (("forward", _FWD_ARGTYPES),
                                ("backward", _BWD_ARGTYPES)):
            fn = getattr(lib, f"ctc_loss_{entry}_{route}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def ctc_route(S: int, C: int, route: Optional[str] = None) -> str:
    """The route of a launch over S labels and C classes: ``"warp"`` (one
    warp an utterance) where S <= ``WARP_MAX_LABELS`` and C <=
    ``WARP_MAX_CLASSES``, else ``"block"`` (one block an utterance);
    ``route="block"`` forces the block route (tests and chip_smoke.py).
    Both give the same bits."""
    if route is None:
        return ("warp" if S <= WARP_MAX_LABELS and C <= WARP_MAX_CLASSES
                else "block")
    if route == "block":
        return route
    raise ValueError(f"ctc loss: route must be None or 'block', got "
                     f"{route!r}")


def _check_inputs(name, logprobs, labels, logit_lengths, label_lengths):
    """The kernels' int32 copies of labels and lengths, on logprobs'
    card (no copy where they already are)."""
    if logprobs.device.type != "cuda":
        raise ValueError(f"{name}: logprobs on {logprobs.device}, needs a "
                         f"CUDA tensor")
    if (logprobs.dtype != torch.float32 or logprobs.dim() != 3
            or not logprobs.is_contiguous()):
        raise ValueError(f"{name}: logprobs must be contiguous float32 (B, "
                         f"T, C), got {logprobs.dtype} "
                         f"{tuple(logprobs.shape)}")
    B = logprobs.shape[0]
    out = []
    for what, v, shape in (("labels", labels, None),
                           ("logit_lengths", logit_lengths, (B,)),
                           ("label_lengths", label_lengths, (B,))):
        if (not torch.is_tensor(v) or v.is_floating_point()
                or v.device != logprobs.device
                or (shape is not None and tuple(v.shape) != shape)
                or (shape is None and (v.dim() != 2 or v.shape[0] != B))):
            raise ValueError(f"{name}: {what} must be integers on "
                             f"{logprobs.device} shaped "
                             f"{shape or (B, 'S')}, got {v!r:.80}")
        out.append(v.to(torch.int32).contiguous())
    return out


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _counted(name, route):
    """``kernels.launches``' key of a launch: the warp route under the
    kernel's name, the block route apart (``name.block``)."""
    return name if route == "warp" else f"{name}.block"


def ctc_loss_forward(logprobs: torch.Tensor, labels: torch.Tensor,
                     logit_lengths: torch.Tensor,
                     label_lengths: torch.Tensor, route: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel wrapper (``csrc/ctc_loss.cu``; ``ctc_route`` picks one
    warp or, with ``route="block"`` or long label rows, one block an
    utterance): (loss (B,), states (B, T, 2S+1)), the states written for
    the frames before each utterance's length."""
    name = "ctc_loss_forward"
    lab, lens, label_lens = _check_inputs(name, logprobs, labels,
                                          logit_lengths, label_lengths)
    B, T, C = logprobs.shape
    S = lab.shape[1]
    route = ctc_route(S, C, route)
    dev = logprobs.device
    loss = torch.empty((B,), dtype=torch.float32, device=dev)
    states = torch.empty((B, T, 2 * S + 1), dtype=torch.float32, device=dev)
    if B == 0:
        return loss, states
    status = getattr(_lib(), f"ctc_loss_forward_{route}")(
        logprobs.data_ptr(), lab.data_ptr(), lens.data_ptr(),
        label_lens.data_ptr(), loss.data_ptr(), states.data_ptr(), B, T, C,
        S, _stream(dev))
    kernels.check(status, _counted(name, route))
    kernels.launches[_counted(name, route)] += 1
    return loss, states


def ctc_loss_backward(logprobs: torch.Tensor, labels: torch.Tensor,
                      logit_lengths: torch.Tensor,
                      label_lengths: torch.Tensor, states: torch.Tensor,
                      grad: torch.Tensor, route: Optional[str] = None
                      ) -> torch.Tensor:
    """CUDA kernel wrapper (``csrc/ctc_loss.cu``, routes as
    ``ctc_loss_forward``'s; either route reads either's states):
    d(sum grad * loss) / dlogprobs (B, T, C), zero on padded frames, from
    ``ctc_loss_forward``'s states; deterministic (no atomics)."""
    name = "ctc_loss_backward"
    lab, lens, label_lens = _check_inputs(name, logprobs, labels,
                                          logit_lengths, label_lengths)
    B, T, C = logprobs.shape
    S = lab.shape[1]
    route = ctc_route(S, C, route)
    dev = logprobs.device
    if (states.dtype != torch.float32 or states.device != dev
            or tuple(states.shape) != (B, T, 2 * S + 1)
            or not states.is_contiguous()):
        raise ValueError(f"{name}: states must be contiguous float32 "
                         f"({B}, {T}, {2 * S + 1}) on {dev}")
    grad = grad.to(device=dev, dtype=torch.float32).reshape(B).contiguous()
    dlogprobs = torch.empty_like(logprobs)
    if B == 0:
        return dlogprobs
    status = getattr(_lib(), f"ctc_loss_backward_{route}")(
        logprobs.data_ptr(), lab.data_ptr(), lens.data_ptr(),
        label_lens.data_ptr(), states.data_ptr(), grad.data_ptr(),
        dlogprobs.data_ptr(), B, T, C, S, _stream(dev))
    kernels.check(status, _counted(name, route))
    kernels.launches[_counted(name, route)] += 1
    return dlogprobs


class _CTCLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logprobs, labels, logit_lengths, label_lengths):
        loss, states = ctc_loss_forward(logprobs, labels, logit_lengths,
                                        label_lengths)
        ctx.save_for_backward(logprobs, labels, logit_lengths,
                              label_lengths, states)
        return loss

    @staticmethod
    def backward(ctx, grad):
        return (ctc_loss_backward(*ctx.saved_tensors, grad),
                None, None, None)


def per_sequence_loss(logprobs: torch.Tensor, labels, logit_lengths,
                      label_lengths) -> torch.Tensor:
    """CTC loss of each sequence (B,) of log-probabilities (B, T, C):
    the kernels for CUDA tensors (a build or launch failure raises), the
    plain version for CPU tensors. ``labels`` (B, S) and the lengths
    (B,) may be numpy arrays, lists or tensors."""
    if logprobs.device.type == "cpu":
        return ctc_loss_reference(logprobs, labels, logit_lengths,
                                  label_lengths)
    dev = logprobs.device
    return _CTCLoss.apply(logprobs.float().contiguous(), *(
        torch.as_tensor(v, device=dev).to(torch.int32)
        for v in (labels, logit_lengths, label_lengths)))
