"""The port's trainable LSTM recurrence against the JAX custom VJP.

On CPU tensors ``lstm_train_forward`` / ``lstm_train_backward`` take
their plain versions (explicit step loops with the TPU kernels' bf16
roundings); they are held against the JAX Pallas kernels
``_lstm_train_fwd_impl`` / ``_lstm_train_bwd_impl`` run in interpret
mode, through ``jax.grad`` of ``lstm_scan_pallas_train``.

Tolerances and the maxima observed at these sizes (CPU):

- forward ``hs``, ``c_T``, ``h_T``: atol 1e-5 (observed 1.8e-7: the two
  float32 sums of the recurrent product run in another order);
- residuals (bf16): rtol 2**-7, one bf16 ulp (observed 2 of 9984 values
  one ulp apart, at T=13);
- gradients: ``1e-5 * max|JAX gradient|`` per tensor (observed 2.6e-7);
- the network's ``W_h`` gradient on the kernel route: ``1e-5 * scale``
  (observed 8.6e-8), while the float32-residual autograd value that the
  route gave before lies 3.7e-3 * scale away.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from nnacousticmodeling_tpu.models import get_network as j_get_network
from nnacousticmodeling_tpu.ops.rnn_pallas import (
    _lstm_train_fwd_impl,
    lstm_scan_pallas_train,
)
from nnacousticmodeling_tpu.train.checkpoint import save_pytree
from nnacousticmodeling_tpu_torch import kernels
from nnacousticmodeling_tpu_torch.models import get_network, networks
from nnacousticmodeling_tpu_torch.ops.rnn_cuda import (
    lstm_scan_reference,
    lstm_scan_train,
    lstm_train_backward,
    lstm_train_backward_reference,
    lstm_train_dw,
    lstm_train_dw_reference,
    lstm_train_forward,
    lstm_train_forward_reference,
)
from nnacousticmodeling_tpu_torch.train import load_jax_params

FWD_ATOL = 1e-5
RES_RTOL = 2.0 ** -7
GRAD_RTOL = 1e-5


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _case(seed, t, b=8, h=16):
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((t, b, 4 * h)).astype(np.float32)
    wh = (rng.standard_normal((h, 4 * h)) * 0.2).astype(np.float32)
    c0 = (rng.standard_normal((b, h)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((b, h)) * 0.1).astype(np.float32)
    w_out = rng.standard_normal((h, 4)).astype(np.float32)
    return proj, wh, c0, h0, w_out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [5, 8, 13])
def test_train_forward_matches_jax_kernel(t, dtype):
    proj, wh, c0, h0, _ = _case(t, t)
    hs_j, res_j, ct_j, ht_j = _lstm_train_fwd_impl(
        jnp.asarray(proj).astype(dtype), jnp.asarray(wh), jnp.asarray(c0),
        jnp.asarray(h0), interpret=True)
    tproj = torch.from_numpy(proj).to(getattr(torch, dtype))
    args = [torch.from_numpy(a) for a in (wh, c0, h0)]
    before = dict(kernels.launches)
    hs, res, ct, ht = lstm_train_forward(tproj, *args)
    assert dict(kernels.launches) == before          # CPU: plain version
    assert hs.dtype == tproj.dtype and hs.shape == (t, 8, 16)
    assert res.dtype == torch.bfloat16 and res.shape == (t, 8, 7 * 16)
    assert ct.dtype == ht.dtype == torch.float32
    np.testing.assert_allclose(_f32(hs), _f32(hs_j), atol=FWD_ATOL)
    np.testing.assert_allclose(_f32(ct), _f32(ct_j), atol=FWD_ATOL)
    np.testing.assert_allclose(_f32(ht), _f32(ht_j), atol=FWD_ATOL)
    # the JAX kernel pads time to its block of 8; the port has no padding
    np.testing.assert_allclose(_f32(res), _f32(res_j)[:t], rtol=RES_RTOL,
                               atol=1e-7)
    (c_s, h_s), hs_s = lstm_scan_reference(tproj, *args)
    assert torch.equal(hs, hs_s)
    assert torch.equal(ct, c_s) and torch.equal(ht, h_s)


def _jax_grads(proj, wh, c0, h0, w_out, carry_terms):
    def loss(p, w, c, h):
        (ct, ht), hs = lstm_scan_pallas_train(p, w, c, h)
        out = jnp.tanh(hs.astype(jnp.float32) @ w_out).sum()
        if carry_terms:
            out = out + 0.5 * ct.sum() + 0.25 * ht.sum()
        return out
    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (proj, wh, c0, h0)))


def _port_grads(proj, wh, c0, h0, w_out, carry_terms):
    args = [torch.from_numpy(a).requires_grad_() for a in (proj, wh, c0, h0)]
    (ct, ht), hs = lstm_scan_train(*args)
    loss = torch.tanh(hs @ torch.from_numpy(w_out)).sum()
    if carry_terms:
        loss = loss + 0.5 * ct.sum() + 0.25 * ht.sum()
    loss.backward()
    return [a.grad for a in args]


@pytest.mark.parametrize("carry_terms", [True, False],
                         ids=["hs_and_carry", "hs_only"])
@pytest.mark.parametrize("t", [5, 6, 7, 11])
def test_scan_train_grads_match_jax_vjp(t, carry_terms):
    """The loss of tests/test_rnn_pallas.py:223-225 (hs, c_T and h_T
    terms), and one that reads hs only, so c_T / h_T get no cotangent
    and must arrive as zeros."""
    case = _case(100 + t, t)
    want = _jax_grads(*case, carry_terms)
    got = _port_grads(*case, carry_terms)
    for g, w, name in zip(got, want, ["dproj", "dwh", "dc0", "dh0"]):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_RTOL * scale,
                                   rtol=0, err_msg=f"T={t} {name}")


def test_scan_train_forward_equals_inference():
    proj, wh, c0, h0, _ = _case(3, 9)
    args = [torch.from_numpy(a) for a in (proj, wh, c0, h0)]
    (ct, ht), hs = lstm_scan_train(*args)
    (cs, hs_c), hs_s = lstm_scan_reference(*args)
    assert torch.equal(hs, hs_s) and torch.equal(ct, cs)
    assert torch.equal(ht, hs_c)


@pytest.mark.parametrize("proj_dtype", [torch.float32, torch.bfloat16])
def test_backward_dtypes_follow_jax(proj_dtype):
    """dproj in proj's dtype, dW_h in wh's, dc0/dh0 in the carry's
    (rnn_pallas.py:657-664); bf16 params give bf16 gradients."""
    proj, wh, c0, h0, _ = _case(4, 6)
    p = torch.from_numpy(proj).to(proj_dtype).requires_grad_()
    w = torch.from_numpy(wh).to(proj_dtype).requires_grad_()
    c = torch.from_numpy(c0).to(proj_dtype).requires_grad_()
    h = torch.from_numpy(h0).to(proj_dtype).requires_grad_()
    (ct, ht), hs = lstm_scan_train(p, w, c, h)
    assert hs.dtype == ct.dtype == ht.dtype == proj_dtype
    (hs.float().sum() + ct.float().sum()).backward()
    for x in (p, w, c, h):
        assert x.grad.dtype == proj_dtype


def test_backward_and_dw_wrappers_route_cpu_to_plain():
    proj, wh, c0, h0, _ = _case(8, 7)
    args = [torch.from_numpy(a) for a in (proj, wh, c0, h0)]
    _, res, _, _ = lstm_train_forward_reference(*args)
    rng = np.random.default_rng(1)
    dhs = torch.from_numpy(rng.standard_normal((7, 8, 16)).astype(
        np.float32))
    dct = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    dht = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    before = dict(kernels.launches)
    got = lstm_train_backward(res, args[1], dhs, dct, dht, torch.float32)
    want = lstm_train_backward_reference(res, args[1], dhs, dct, dht,
                                         torch.float32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    dz = torch.from_numpy(rng.standard_normal((7, 8, 64)).astype(
        np.float32)).to(torch.bfloat16)
    assert torch.equal(lstm_train_dw(res, dz),
                       lstm_train_dw_reference(res, dz))
    assert dict(kernels.launches) == before


def test_network_kernel_route_gets_the_custom_vjp_gradient(tmp_path):
    """``scan_impl="pallas"`` with ``train=True`` differentiates through
    ``lstm_scan_train``: W_h's gradient equals the JAX network's (its
    custom VJP with bf16 residuals), not the float32-residual autograd
    value of ``lstm_scan_reference`` that the route used to give."""
    jnet = dataclasses.replace(j_get_network("lstm", 2, [16], 11),
                               scan_impl="pallas")
    params = jnet.init(jax.random.PRNGKey(3), 8)
    save_pytree(str(tmp_path / "m.npz"), params)
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((4, 9, 8)).astype(np.float32)
    ys = rng.integers(0, 11, (4, 9))

    def j_loss(p):
        logits, _ = jnet.apply_sequence(p, jnp.asarray(xs), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(ys)).mean(0).sum()

    want = jax.grad(j_loss)(params)

    def port_wh_grads():
        net = get_network("lstm", 2, [16], 11, in_dim=8, scan_impl="pallas",
                          device="cpu")
        net.load_state_dict(load_jax_params(tmp_path / "m.npz",
                                            device="cpu"))
        logits, _ = net.apply_sequence(torch.from_numpy(xs), train=True)
        F.cross_entropy(logits.reshape(-1, 11),
                        torch.from_numpy(ys).reshape(-1), reduction="none"
                        ).reshape(4, 9).mean(0).sum().backward()
        return [net.cells[l].wh.grad.numpy() for l in range(2)]

    got = port_wh_grads()
    with mock.patch.object(networks, "lstm_scan_train",
                           lstm_scan_reference):
        f32_residuals = port_wh_grads()
    for l in range(2):
        w = np.asarray(want["cells"][l]["wh"])
        scale = np.abs(w).max()
        assert np.abs(got[l] - w).max() <= GRAD_RTOL * scale
        assert np.abs(f32_residuals[l] - w).max() >= 1e-3 * scale
