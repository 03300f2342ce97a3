"""LSTM recurrence over a hoisted input projection: CUDA kernel wrappers
and their plain PyTorch versions, for inference and for training.

Counterpart of ``nnacousticmodeling_tpu/ops/rnn_pallas.py``:

- ``lstm_scan`` <- ``lstm_scan_pallas`` (twin ``lstm_scan_mixed_reference``),
  kernel ``csrc/lstm_scan.cu``; inference only, it has no backward;
- ``lstm_scan_train`` <- ``lstm_scan_pallas_train``, a
  ``torch.autograd.Function`` over ``lstm_train_forward``
  (<- ``_lstm_train_fwd_impl``) and ``lstm_train_backward``
  (<- ``_lstm_train_bwd_impl``, with its dW contraction
  ``lstm_train_dw``), kernels ``csrc/lstm_train.cu``.

The sources say what bounds the kernels and how they are laid out.
Precision contract (the TPU kernels'): ``proj`` rounded to bf16 even
when it is float32, bf16 operands for ``h @ W_h`` with float32
accumulation, float32 gates and carry, ``hs`` in proj's dtype, the
final carry in ``c0``'s dtype. Training stores the residuals
``[a | i | f | o | tanh c_t | c_{t-1} | h_{t-1}]`` in bf16; ``dproj``
takes the unrounded float32 ``dz`` in proj's dtype, while ``dh`` and
``dW`` take ``bf16(dz)``.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes
its plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

_SCAN_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_FWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_DW_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _lib():
    lib = kernels.load("lstm_scan")
    for fn in (lib.lstm_scan_f32, lib.lstm_scan_bf16):
        fn.argtypes = _SCAN_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _train_lib():
    lib = kernels.load("lstm_train")
    for fns, argtypes in (((lib.lstm_train_fwd_f32, lib.lstm_train_fwd_bf16),
                           _FWD_ARGTYPES),
                          ((lib.lstm_train_bwd_f32, lib.lstm_train_bwd_bf16),
                           _BWD_ARGTYPES),
                          ((lib.lstm_train_dw,), _DW_ARGTYPES)):
        for fn in fns:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _cell(z: torch.Tensor, c: torch.Tensor, h_dim: int):
    """Gates and carry update of one float32 step: a, i, f, o, c_t,
    tanh c_t, h_t."""
    a = torch.tanh(z[:, :h_dim])
    ig = torch.sigmoid(z[:, h_dim:2 * h_dim])
    f = torch.sigmoid(z[:, 2 * h_dim:3 * h_dim])
    o = torch.sigmoid(z[:, 3 * h_dim:])
    c_new = f * c + ig * a
    tc = torch.tanh(c_new)
    return a, ig, f, o, c_new, tc, o * tc


def _bf16f(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, as float32."""
    return x.to(torch.bfloat16).float()


def _check_scan_args(name, proj, wh, c0, h0):
    t, b, g = proj.shape
    h_dim = wh.shape[0]
    if g != 4 * h_dim or wh.shape != (h_dim, g):
        raise ValueError(f"{name}: proj gate dim {g} / wh {tuple(wh.shape)} "
                         f"do not match 4*H")
    if c0.shape != (b, h_dim) or h0.shape != (b, h_dim):
        raise ValueError(f"{name}: c0/h0 must be (B, H)")
    if t < 1:
        raise ValueError(f"{name}: needs at least one timestep")


def _check_cuda(name, first, *others):
    """Raise unless ``first`` is a CUDA tensor and ``others`` lie on its
    device. Returns the kernel stream handle."""
    if first.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    for i, x in enumerate(others):
        if x.device != first.device:
            raise ValueError(f"{name}: argument {i + 1} on {x.device}, "
                             f"argument 0 on {first.device}")
    return torch.cuda.current_stream(first.device).cuda_stream


def _dtype_suffix(name, dtype):
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.bfloat16:
        return "bf16"
    raise TypeError(f"{name}: dtype {dtype} not supported")


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

def lstm_scan_reference(proj, wh, c0, h0):
    """Plain PyTorch version of the kernel, same contract.

    ``h`` and ``W_h`` are rounded to bf16 and multiplied in float32: a
    bf16 ``matmul`` would round its output to bf16 as well, which the
    kernel (f32 accumulation) does not.
    """
    h_dim = wh.shape[0]
    out_dtype = proj.dtype
    projf = _bf16f(proj)
    whf = _bf16f(wh)
    c = c0.float()
    h = h0.float()
    hs = torch.empty(proj.shape[:2] + (h_dim,), dtype=out_dtype,
                     device=proj.device)
    for t in range(proj.shape[0]):
        z = projf[t] + _bf16f(h) @ whf
        *_, c, _, h = _cell(z, c, h_dim)
        hs[t] = h.to(out_dtype)
    return (c.to(c0.dtype), h.to(c0.dtype)), hs


def lstm_scan(proj, wh, c0, h0):
    """Run the LSTM recurrence. proj (T, B, 4H), wh (H, 4H), c0/h0
    (B, H). Returns ``(c_T, h_T), hs`` with hs (T, B, H).

    CUDA tensors launch the kernel (or raise); CPU tensors take
    ``lstm_scan_reference``. The kernel has no backward: on the card a
    tensor that requires grad under grad mode raises, and training goes
    through ``lstm_scan_train``.
    """
    _check_scan_args("lstm_scan", proj, wh, c0, h0)
    if proj.device.type == "cpu":
        return lstm_scan_reference(proj, wh, c0, h0)
    stream = _check_cuda("lstm_scan", proj, wh, c0, h0)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (proj, wh, c0, h0)):
        raise RuntimeError(
            "lstm_scan: the inference kernel has no backward, and its "
            "outputs would carry no gradient; train through "
            "lstm_scan_train, or run under torch.no_grad() / "
            "torch.inference_mode()")
    fn = getattr(_lib(), "lstm_scan_" + _dtype_suffix("lstm_scan",
                                                      proj.dtype))
    if not proj.is_contiguous():
        raise ValueError("lstm_scan: proj must be contiguous")
    t, b, _ = proj.shape
    h_dim = wh.shape[0]
    whb = wh.to(torch.bfloat16).contiguous()
    h_a = h0.float().contiguous().clone()
    h_b = torch.empty_like(h_a)
    c = c0.float().contiguous().clone()
    hs = torch.empty((t, b, h_dim), dtype=proj.dtype, device=proj.device)
    kernels.check(fn(proj.data_ptr(), whb.data_ptr(), h_a.data_ptr(),
                     h_b.data_ptr(), c.data_ptr(), hs.data_ptr(), t, b,
                     h_dim, stream), "lstm_scan")
    kernels.launches["lstm_scan"] += 1
    h_t = h_a if t % 2 == 0 else h_b
    return (c.to(c0.dtype), h_t.to(c0.dtype)), hs


# ---------------------------------------------------------------------------
# training: forward with residuals
# ---------------------------------------------------------------------------

def lstm_train_forward_reference(proj, wh, c0, h0):
    """Plain version of ``lstm_train_forward``: the step loop of
    ``_lstm_train_fwd_impl`` (rnn_pallas.py:417-441) with its bf16
    roundings. Returns ``hs, res, c_T, h_T`` (carries in float32)."""
    h_dim = wh.shape[0]
    t_len, b = proj.shape[:2]
    projf = _bf16f(proj)
    whf = _bf16f(wh)
    c = c0.float()
    h = h0.float()
    hs = torch.empty((t_len, b, h_dim), dtype=proj.dtype, device=proj.device)
    res = torch.empty((t_len, b, 7 * h_dim), dtype=torch.bfloat16,
                      device=proj.device)
    for t in range(t_len):
        z = projf[t] + _bf16f(h) @ whf
        a, ig, f, o, c_new, tc, h_new = _cell(z, c, h_dim)
        res[t] = torch.cat([a, ig, f, o, tc, c, h], dim=1).to(torch.bfloat16)
        c, h = c_new, h_new
        hs[t] = h.to(proj.dtype)
    return hs, res, c, h


def lstm_train_forward(proj, wh, c0, h0):
    """Forward of the trainable recurrence. proj (T, B, 4H), wh (H, 4H),
    c0/h0 (B, H). Returns ``hs`` (T, B, H) in proj's dtype, the
    residuals ``res`` (T, B, 7H) bf16, and ``c_T``, ``h_T`` float32.

    hs, c_T and h_T equal ``lstm_scan``'s on the same inputs.
    """
    _check_scan_args("lstm_train_forward", proj, wh, c0, h0)
    if proj.device.type == "cpu":
        return lstm_train_forward_reference(proj, wh, c0, h0)
    stream = _check_cuda("lstm_train_forward", proj, wh, c0, h0)
    fn = getattr(_train_lib(), "lstm_train_fwd_" + _dtype_suffix(
        "lstm_train_forward", proj.dtype))
    if not proj.is_contiguous():
        raise ValueError("lstm_train_forward: proj must be contiguous")
    t, b, _ = proj.shape
    h_dim = wh.shape[0]
    whb = wh.detach().to(torch.bfloat16).contiguous()
    h_a = h0.detach().float().contiguous().clone()
    h_b = torch.empty_like(h_a)
    c = c0.detach().float().contiguous().clone()
    hs = torch.empty((t, b, h_dim), dtype=proj.dtype, device=proj.device)
    res = torch.empty((t, b, 7 * h_dim), dtype=torch.bfloat16,
                      device=proj.device)
    kernels.check(fn(proj.data_ptr(), whb.data_ptr(), h_a.data_ptr(),
                     h_b.data_ptr(), c.data_ptr(), hs.data_ptr(),
                     res.data_ptr(), t, b, h_dim, stream),
                  "lstm_train_forward")
    kernels.launches["lstm_train_forward"] += 1
    return hs, res, c, (h_a if t % 2 == 0 else h_b)


# ---------------------------------------------------------------------------
# training: reverse-time backward and the dW contraction
# ---------------------------------------------------------------------------

def lstm_train_dw_reference(res, dz):
    """Plain version of ``lstm_train_dw``: float32 product of the
    bf16 ``h_{t-1}`` rows of ``res`` and the bf16 ``dz`` rows."""
    h_dim = res.shape[-1] // 7
    hp = res[..., 6 * h_dim:].reshape(-1, h_dim).float()
    return hp.T @ dz.reshape(-1, 4 * h_dim).float()


def lstm_train_dw(res, dz):
    """``dW_h = sum_t bf16(h_{t-1})^T bf16(dz_t)`` in float32 from the
    residuals res (T, B, 7H) bf16 and dz (T, B, 4H) bf16 -> (H, 4H)."""
    t, b, seven_h = res.shape
    h_dim = seven_h // 7
    if (seven_h != 7 * h_dim or dz.shape != (t, b, 4 * h_dim)
            or res.dtype != torch.bfloat16 or dz.dtype != torch.bfloat16):
        raise ValueError("lstm_train_dw: res (T, B, 7H) and dz (T, B, 4H) "
                         "must be bf16")
    if res.device.type == "cpu":
        return lstm_train_dw_reference(res, dz)
    stream = _check_cuda("lstm_train_dw", res, dz)
    if not (res.is_contiguous() and dz.is_contiguous()):
        raise ValueError("lstm_train_dw: res and dz must be contiguous")
    dw = torch.empty((h_dim, 4 * h_dim), dtype=torch.float32,
                     device=res.device)
    kernels.check(_train_lib().lstm_train_dw(
        res.data_ptr(), dz.data_ptr(), dw.data_ptr(), t * b, h_dim, stream),
        "lstm_train_dw")
    kernels.launches["lstm_train_dw"] += 1
    return dw


def lstm_train_backward_reference(res, wh, dhs, dc_T, dh_T, proj_dtype):
    """Plain version of ``lstm_train_backward``: the reverse step loop
    of ``_lstm_train_bwd_impl`` (rnn_pallas.py:532-580) with its bf16
    roundings, then ``lstm_train_dw_reference``."""
    t_len, b, seven_h = res.shape
    h_dim = seven_h // 7
    whf = _bf16f(wh)
    dc = dc_T.float()
    dh = dh_T.float()
    dproj = torch.empty((t_len, b, 4 * h_dim), dtype=proj_dtype,
                        device=res.device)
    dzb = torch.empty((t_len, b, 4 * h_dim), dtype=torch.bfloat16,
                      device=res.device)
    for t in range(t_len - 1, -1, -1):
        a, ig, f, o, tc, c_prev = res[t, :, :6 * h_dim].float().split(
            h_dim, dim=1)
        dh_tot = dhs[t].float() + dh
        do = dh_tot * tc
        dc = dc + dh_tot * o * (1.0 - tc * tc)
        da = dc * ig
        dig = dc * a
        df = dc * c_prev
        dc_prev = dc * f
        dz = torch.cat([da * (1.0 - a * a), dig * ig * (1.0 - ig),
                        df * f * (1.0 - f), do * o * (1.0 - o)], dim=1)
        dproj[t] = dz.to(proj_dtype)
        dzb[t] = dz.to(torch.bfloat16)
        dh = dzb[t].float() @ whf.T
        dc = dc_prev
    dwh = lstm_train_dw_reference(res, dzb).to(wh.dtype)
    return dproj, dwh, dc, dh


def lstm_train_backward(res, wh, dhs, dc_T, dh_T, proj_dtype):
    """Backward of the trainable recurrence from its residuals.

    res (T, B, 7H) bf16, wh (H, 4H), dhs (T, B, H), dc_T/dh_T (B, H).
    Returns ``dproj`` (T, B, 4H) in ``proj_dtype``, ``dW_h`` (H, 4H) in
    wh's dtype, and ``dc0``, ``dh0`` float32.
    """
    t, b, seven_h = res.shape
    h_dim = seven_h // 7
    if (seven_h != 7 * h_dim or wh.shape != (h_dim, 4 * h_dim)
            or dhs.shape != (t, b, h_dim) or dc_T.shape != (b, h_dim)
            or dh_T.shape != (b, h_dim) or res.dtype != torch.bfloat16):
        raise ValueError("lstm_train_backward: shapes do not match "
                         "res (T, B, 7H) bf16")
    if t < 1:
        raise ValueError("lstm_train_backward: needs at least one timestep")
    if res.device.type == "cpu":
        return lstm_train_backward_reference(res, wh, dhs, dc_T, dh_T,
                                             proj_dtype)
    stream = _check_cuda("lstm_train_backward", res, wh, dhs, dc_T, dh_T)
    fn = getattr(_train_lib(), "lstm_train_bwd_" + _dtype_suffix(
        "lstm_train_backward", proj_dtype))
    if not res.is_contiguous():
        raise ValueError("lstm_train_backward: res must be contiguous")
    whb = wh.detach().to(torch.bfloat16).contiguous()
    dhs_f = dhs.float().contiguous()
    dh_t = dh_T.float().contiguous()
    dc = dc_T.float().contiguous().clone()
    dproj = torch.empty((t, b, 4 * h_dim), dtype=proj_dtype,
                        device=res.device)
    dz = torch.empty((t, b, 4 * h_dim), dtype=torch.bfloat16,
                     device=res.device)
    dh0 = torch.empty((b, h_dim), dtype=torch.float32, device=res.device)
    kernels.check(fn(res.data_ptr(), whb.data_ptr(), dhs_f.data_ptr(),
                     dh_t.data_ptr(), dc.data_ptr(), dproj.data_ptr(),
                     dz.data_ptr(), dh0.data_ptr(), t, b, h_dim, stream),
                  "lstm_train_backward")
    kernels.launches["lstm_train_backward"] += 1
    dwh = lstm_train_dw(res, dz).to(wh.dtype)
    return dproj, dwh, dc, dh0


class _LSTMScanTrain(torch.autograd.Function):
    """Custom backward of the recurrence: the twin of the JAX
    ``lstm_scan_pallas_train`` custom VJP (rnn_pallas.py:627-667).
    ``lstm_train_forward`` / ``lstm_train_backward`` are looked up at
    call time, so a caller can swap in the plain versions."""

    @staticmethod
    def forward(ctx, proj, wh, c0, h0):
        hs, res, c_t, h_t = lstm_train_forward(proj, wh, c0, h0)
        ctx.save_for_backward(res, wh)
        ctx.proj_dtype = proj.dtype
        # TBPTT reads no c_T / h_T cotangent: they arrive as zeros
        ctx.set_materialize_grads(True)
        return c_t.to(c0.dtype), h_t.to(c0.dtype), hs

    @staticmethod
    def backward(ctx, dc_t, dh_t, dhs):
        res, wh = ctx.saved_tensors
        dproj, dwh, dc0, dh0 = lstm_train_backward(res, wh, dhs, dc_t, dh_t,
                                                   ctx.proj_dtype)
        return dproj, dwh, dc0.to(dc_t.dtype), dh0.to(dh_t.dtype)


def lstm_scan_train(proj, wh, c0, h0):
    """Differentiable LSTM recurrence for training, same signature and
    forward values as ``lstm_scan``: ``(c_T, h_T), hs``. Gradients come
    from the reverse-time kernel (``lstm_train_backward``) with bf16
    residuals, as from the JAX custom VJP."""
    c_t, h_t, hs = _LSTMScanTrain.apply(proj, wh, c0, h0)
    return (c_t, h_t), hs
