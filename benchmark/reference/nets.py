"""Plain PyTorch LSTM and GRU stacks at the configurations' stated
precision, for serving (posteriors) and for TBPTT training steps.

Stated precision: every product in float32 with TF32 off, except the
recurrent products, whose operands (the input projection, the carried
hidden state, the GRU's r*h, the recurrent weights) are rounded to
bf16 and multiplied with float32 accumulation; gates, cell state and
hiddens are float32. The roundings pass gradients straight through, so
the training reference's backward is float32 autograd through that
forward. ``tf32=True`` computes the float32 products in TF32 instead:
the control, one step below the stated precision.

Parameters use the system's names (``cells.<l>.wx`` ...); the gate
order is Chainer's (LSTM a, i, f, o; GRU r, z, candidate).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products in IEEE float32 (TF32 off) or in TF32."""
    cuda = torch.backends.cuda.matmul
    before = (cuda.allow_tf32, torch.backends.cudnn.allow_tf32)
    cuda.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        cuda.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, as float32, with an identity gradient."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


def layers_of(params: Dict[str, torch.Tensor]) -> int:
    return len({k.split(".")[1] for k in params if k.startswith("cells.")})


def lstm_layer(p, proj: torch.Tensor, c: torch.Tensor, h: torch.Tensor):
    """proj (T, B, 4H) -> (c_T, h_T), hs (T, B, H)."""
    units = c.shape[1]
    wh = bf16(p["wh"])
    proj = bf16(proj)
    hs = []
    for t in range(proj.shape[0]):
        z = proj[t] + bf16(h) @ wh
        a = torch.tanh(z[:, :units])
        i = torch.sigmoid(z[:, units:2 * units])
        f = torch.sigmoid(z[:, 2 * units:3 * units])
        o = torch.sigmoid(z[:, 3 * units:])
        c = f * c + i * a
        h = o * torch.tanh(c)
        hs.append(h)
    return (c, h), torch.stack(hs)


def gru_layer(p, proj: torch.Tensor, h: torch.Tensor):
    """proj (T, B, 3H) packed [r, z, candidate] -> h_T, hs (T, B, H)."""
    units = h.shape[1]
    w_rz, w_c = bf16(p["wh_rz"]), bf16(p["wh_c"])
    proj = bf16(proj)
    hs = []
    for t in range(proj.shape[0]):
        rz = proj[t, :, :2 * units] + bf16(h) @ w_rz
        r = torch.sigmoid(rz[:, :units])
        z = torch.sigmoid(rz[:, units:])
        hb = torch.tanh(proj[t, :, 2 * units:] + bf16(r * h) @ w_c)
        h = z * hb + (1.0 - z) * h
        hs.append(h)
    return h, torch.stack(hs)


def zero_state(network: str, layers: int, batch: int, units: int,
               device) -> List[Tuple[torch.Tensor, ...]]:
    z = torch.zeros(batch, units, device=device)
    return [(z, z) if network == "lstm" else (z,) for _ in range(layers)]


def logits(network: str, params, xs: torch.Tensor, state):
    """(B, T, D) features -> ((B, T, C) logits, new state)."""
    b, t, _ = xs.shape
    x = xs
    new_state = []
    for layer in range(layers_of(params)):
        p = {k.split(".", 2)[2]: v for k, v in params.items()
             if k.startswith(f"cells.{layer}.")}
        bias = p["b"] if network == "lstm" else p["bx"]
        proj = (x.reshape(b * t, -1) @ p["wx"] + bias).reshape(
            b, t, -1).transpose(0, 1)
        if network == "lstm":
            carry, hs = lstm_layer(p, proj, *state[layer])
        else:
            h, hs = gru_layer(p, proj, *state[layer])
            carry = (h,)
        new_state.append(carry)
        x = hs.transpose(0, 1)
    y = x.reshape(b * t, -1) @ params["out.w"] + params["out.b"]
    return y.reshape(b, t, -1), new_state


@torch.no_grad()
def log_posteriors(network: str, params, xs: torch.Tensor,
                   log_priors: torch.Tensor, tf32: bool = False
                   ) -> torch.Tensor:
    """Serving: (B, T, D) features from a zero state -> (B, T, C)
    ``log_softmax(logits - log_priors)``."""
    units = params["out.w"].shape[0]
    state = zero_state(network, layers_of(params), xs.shape[0], units,
                       xs.device)
    with matmul_precision(tf32):
        y, _ = logits(network, params, xs, state)
        return torch.log_softmax(y - log_priors, dim=-1)


def train_steps(network: str, params: Dict[str, torch.Tensor], batches,
                optimizer: dict, tf32: bool = False, loss_rows=None,
                state=None, slots=None, updates_before: int = 0):
    """TBPTT updates from ``params``: each batch (xb (B, L, D), yb (B, L))
    one update of the loss sum over the L steps of the batch-mean
    cross-entropy, the recurrent state carried between updates as a
    constant from ``state`` (each layer's (c, h) or (h,); zero if None).
    ``optimizer``: ``{"name": "momentumsgd", "lr": ...}`` (momentum 0.9,
    buf = g + 0.9 buf) or ``{"name": "adam"}`` (alpha 1e-3, betas 0.9 /
    0.999, eps 1e-8); ``slots`` its state by parameter (the momentum
    buffer; Adam's two moments) after ``updates_before`` updates, or
    None at the start. ``loss_rows`` takes the mean over the first that
    many streams only (a fault for the comparison's readings). Returns
    each update's loss / L, the first update's gradients and (B, L, C)
    logits, and the params after the last update."""
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    names = list(p)
    units = params["out.w"].shape[0]
    losses, first_grads, first_logits = [], None, None
    slots = {k: [v.detach().clone() for v in vs]
             for k, vs in (slots or {}).items()}
    with matmul_precision(tf32):
        for step, (xb, yb) in enumerate(batches, start=updates_before + 1):
            b, length, _ = xb.shape
            if state is None:
                state = zero_state(network, layers_of(p), b, units,
                                   xb.device)
            y, new_state = logits(network, p, xb, state)
            ce = F.cross_entropy(y.reshape(b * length, -1),
                                 yb.reshape(-1).long(), reduction="none")
            total = ce.reshape(b, length)[:loss_rows].mean(dim=0).sum()
            grads = torch.autograd.grad(total, [p[k] for k in names])
            losses.append(float(total.detach()) / length)
            if first_grads is None:
                first_grads = {k: g.detach().clone()
                               for k, g in zip(names, grads)}
                first_logits = y.detach()
            with torch.no_grad():
                for k, g in zip(names, grads):
                    _optimizer_step(optimizer, step, p[k], g,
                                    slots.setdefault(k, []))
            state = [tuple(a.detach() for a in layer) for layer in new_state]
    return (losses, first_grads, {k: v.detach() for k, v in p.items()},
            first_logits)


def _optimizer_step(opt: dict, step: int, w: torch.Tensor, g: torch.Tensor,
                    slot: list) -> None:
    if opt["name"] == "momentumsgd":
        if not slot:
            slot.append(g.clone())
        else:
            slot[0].mul_(0.9).add_(g)
        w.sub_(opt["lr"] * slot[0])
    elif opt["name"] == "adam":
        b1, b2, eps, alpha = 0.9, 0.999, 1e-8, 1e-3
        if not slot:
            slot += [torch.zeros_like(g), torch.zeros_like(g)]
        m, v = slot
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        m_hat = m / (1 - b1 ** step)
        v_hat = v / (1 - b2 ** step)
        w.sub_(alpha * m_hat / (v_hat.sqrt() + eps))
    else:
        raise ValueError(f"unknown optimizer {opt['name']!r}")
