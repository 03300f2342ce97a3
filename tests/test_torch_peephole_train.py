"""The port's trainable peephole recurrence against the JAX custom VJP,
and the training engine on the peephole and zoneout LSTMs against JAX
``train_network`` (the CLI and zoneout at ratios above 0:
``test_torch_peephole_cli.py``).

On CPU tensors ``peephole_train_forward`` / ``peephole_train_backward``
take their plain versions (explicit step loops with the TPU kernels' bf16
roundings); they are held against the JAX Pallas kernels
``_peep_train_fwd_impl`` / ``_peep_train_bwd_impl`` run in interpret
mode, and through ``jax.grad`` of ``peephole_scan_pallas_train``, at the
odd lengths that the JAX backward pads to its time block of 4
(rnn_pallas.py:1117-1124).

Tolerances and the maxima observed at these sizes (CPU):

- forward hs, c_T and h_T: ``1e-5 * max|x|`` (observed 1.7e-7);
- residuals (bf16): rtol 2**-7, one bf16 ulp (observed: all equal);
- backward on the same residuals: ``1e-3 * max|JAX gradient|`` per
  tensor (observed 1.7e-4, dh0; dP_f 1.1e-4 at T=7): the float32 sums of
  the reverse products run in another order, and a bf16 rounding of dz
  that flips moves a gradient by a share of one bf16 ulp (2**-8); a
  rounding point left out shows at ~1e-2;
- gradients through the custom backward and the network's gradients on
  the kernel route: the same ``1e-3`` (observed 2.6e-7 and 8.6e-7);
- ``train_network`` over a momentum stage: the float32 loop, losses rtol
  1e-5 (observed 3.1e-7) and params atol 1e-5 (observed 1.4e-6); the
  kernel route, losses rtol 1e-3 (observed 3.4e-5) and params atol 5e-3
  (observed 1.7e-3), as the bf16 rounding flips of two runs compound
  from update to update; the zoneout LSTM at ratios 0, where zoneout is
  the identity and nothing depends on the masks, on the kernel route
  (its training takes the step loop, its validation ``lstm_scan``):
  losses rtol 1e-5 (observed 1.1e-7), params atol 1e-5 (observed
  1.2e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from nnacousticmodeling_tpu.decoder import make_synthetic_image
from nnacousticmodeling_tpu.models import get_network as j_get_network
from nnacousticmodeling_tpu.ops.rnn_pallas import (
    _peep_train_bwd_impl,
    _peep_train_fwd_impl,
    peephole_scan_pallas_train,
)
from nnacousticmodeling_tpu.train import TrainConfig as JTrainConfig
from nnacousticmodeling_tpu.train import TrainStage as JTrainStage
from nnacousticmodeling_tpu.train import load_pytree as j_load
from nnacousticmodeling_tpu.train import train_network as j_train_network
from nnacousticmodeling_tpu.train.checkpoint import _path_str
from nnacousticmodeling_tpu.train.checkpoint import save_pytree as j_save
from nnacousticmodeling_tpu.utils.synthetic import make_synthetic_corpus
from nnacousticmodeling_tpu_torch import kernels
from nnacousticmodeling_tpu_torch.models import get_network
from nnacousticmodeling_tpu_torch.ops.rnn_cuda import (
    peephole_scan_reference,
    peephole_scan_train,
    peephole_train_backward,
    peephole_train_backward_reference,
    peephole_train_dw,
    peephole_train_dw_reference,
    peephole_train_forward,
    peephole_train_forward_reference,
)
from nnacousticmodeling_tpu_torch.train import (
    TrainConfig,
    TrainStage,
    load_jax_params,
    train_network,
)

FWD_RTOL = 1e-5
RES_RTOL = 2.0 ** -7
GRAD_RTOL = 1e-3
GRADS = ["dproj", "dwh", "dpi", "dpf", "dpo", "dc0", "dh0"]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rtol, what):
    got, want = _f32(got), _f32(want)
    scale = max(np.abs(want).max(), 1e-3)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def _case(seed, t, b=8, h=16):
    """proj, wh, pi, pf, po, c0, h0 and an output projection."""
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((t, b, 4 * h)).astype(np.float32)
    weights = [(rng.standard_normal((h, n)) * 0.2).astype(np.float32)
               for n in (4 * h, h, h, h)]
    c0, h0 = [(rng.standard_normal((b, h)) * 0.1).astype(np.float32)
              for _ in range(2)]
    w_out = rng.standard_normal((h, 4)).astype(np.float32)
    return [proj, *weights, c0, h0], w_out


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [7, 13])
def test_peephole_train_forward_matches_jax_kernel(t, dtype):
    args, _ = _case(t, t)
    jargs = _jax(args)
    jargs[0] = jargs[0].astype(dtype)
    hs_j, res_j, ct_j, ht_j = _peep_train_fwd_impl(*jargs, interpret=True)
    targs = _torch(args)
    targs[0] = targs[0].to(getattr(torch, dtype))
    before = dict(kernels.launches)
    hs, res, ct, ht = peephole_train_forward(*targs)
    assert dict(kernels.launches) == before          # CPU: plain version
    assert hs.dtype == targs[0].dtype and hs.shape == (t, 8, 16)
    assert res.dtype == torch.bfloat16 and res.shape == (t, 8, 128)
    assert ct.dtype == ht.dtype == torch.float32
    _close(hs, hs_j, FWD_RTOL, "hs")
    _close(ct, ct_j, FWD_RTOL, "c_T")
    _close(ht, ht_j, FWD_RTOL, "h_T")
    # the JAX kernel pads time to its block of 8; the port has no padding
    np.testing.assert_allclose(_f32(res), _f32(res_j)[:t], rtol=RES_RTOL,
                               atol=1e-7)
    (ct_s, ht_s), hs_s = peephole_scan_reference(*targs)
    assert torch.equal(hs, hs_s) and torch.equal(ct, ct_s)
    assert torch.equal(ht, ht_s)


@pytest.mark.parametrize("t", [5, 6, 7, 11])
def test_peephole_train_backward_matches_jax_kernel(t):
    """The port's backward and the JAX kernel on the same residuals, at
    lengths the JAX backward pads to its time block of 4 (the odd-length
    coverage of COVERAGE.md:101-104)."""
    args, _ = _case(50 + t, t)
    targs = _torch(args)
    _, res, _, _ = peephole_train_forward_reference(*targs)
    rng = np.random.default_rng(t)
    dhs = rng.standard_normal((t, 8, 16)).astype(np.float32)
    dct, dht = [rng.standard_normal((8, 16)).astype(np.float32)
                for _ in range(2)]
    got = peephole_train_backward(res, *targs[1:5], *_torch([dhs, dct, dht]),
                                  torch.float32)
    wh, pi, pf, po = (jnp.asarray(a).astype(jnp.bfloat16).T
                      for a in args[1:5])
    want = _peep_train_bwd_impl(
        jnp.asarray(res.float().numpy()).astype(jnp.bfloat16), wh, pi, pf,
        po, *_jax([dhs, dct, dht]), t, jnp.float32, jnp.float32,
        interpret=True)
    for g, w, name in zip(got, want, GRADS):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close(g, w, GRAD_RTOL, f"T={t} {name}")


def _jax_grads(args, w_out, carry_terms):
    def loss(*a):
        (ct, ht), hs = peephole_scan_pallas_train(*a)
        out = jnp.tanh(hs.astype(jnp.float32) @ w_out).sum()
        return out + 0.5 * (ct.sum() + ht.sum()) if carry_terms else out

    return jax.grad(loss, argnums=tuple(range(7)))(*_jax(args))


def _port_grads(args, w_out, carry_terms):
    targs = [a.requires_grad_() for a in _torch(args)]
    (ct, ht), hs = peephole_scan_train(*targs)
    loss = torch.tanh(hs @ torch.from_numpy(w_out)).sum()
    if carry_terms:
        loss = loss + 0.5 * (ct.sum() + ht.sum())
    loss.backward()
    return [a.grad for a in targs]


@pytest.mark.parametrize("carry_terms", [True, False],
                         ids=["hs_and_carry", "hs_only"])
@pytest.mark.parametrize("t", [5, 7])
def test_peephole_scan_train_grads_match_jax_vjp(t, carry_terms):
    """A loss on hs and the final carry, and one on hs only, so c_T and
    h_T get no cotangent and must arrive as zeros."""
    args, w_out = _case(100 + t, t)
    want = _jax_grads(args, w_out, carry_terms)
    got = _port_grads(args, w_out, carry_terms)
    for g, w, name in zip(got, want, GRADS):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close(g, w, GRAD_RTOL, f"T={t} {name}")


def test_peephole_backward_dtypes_follow_jax():
    """dproj in proj's dtype, the weight gradients in the weights', dc0 /
    dh0 in the carry's (rnn_pallas.py:1291-1300); bf16 inputs give bf16
    gradients."""
    args, _ = _case(4, 6)
    targs = [a.to(torch.bfloat16).requires_grad_() for a in _torch(args)]
    (ct, ht), hs = peephole_scan_train(*targs)
    assert hs.dtype == ct.dtype == ht.dtype == torch.bfloat16
    (hs.float().sum() + ct.float().sum() + ht.float().sum()).backward()
    assert all(a.grad.dtype == torch.bfloat16 for a in targs)


def test_peephole_backward_and_dw_wrappers_route_cpu_to_plain():
    args, _ = _case(8, 7)
    targs = _torch(args)
    _, res, _, _ = peephole_train_forward_reference(*targs)
    rng = np.random.default_rng(1)
    dhs = torch.from_numpy(rng.standard_normal((7, 8, 16)).astype(
        np.float32))
    dct, dht = [torch.from_numpy(rng.standard_normal((8, 16)).astype(
        np.float32)) for _ in range(2)]
    before = dict(kernels.launches)
    got = peephole_train_backward(res, *targs[1:5], dhs, dct, dht,
                                  torch.float32)
    want = peephole_train_backward_reference(res, *targs[1:5], dhs, dct, dht,
                                             torch.float32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    dz = torch.from_numpy(rng.standard_normal((7, 8, 64)).astype(
        np.float32)).to(torch.bfloat16)
    assert all(torch.equal(g, w) for g, w in zip(
        peephole_train_dw(res, dz), peephole_train_dw_reference(res, dz)))
    assert dict(kernels.launches) == before
    with pytest.raises(ValueError, match="8H"):
        peephole_train_dw(res[..., :120], dz)


def test_network_kernel_route_gets_the_custom_vjp_gradient(tmp_path):
    """``scan_impl="pallas"`` with ``train=True`` differentiates through
    ``peephole_scan_train``; the recurrent and peephole weights'
    gradients equal the JAX network's custom VJP."""
    jnet = dataclasses.replace(j_get_network("peepholelstm", 2, [16], 11),
                               scan_impl="pallas")
    params = jnet.init(jax.random.PRNGKey(3), 8)
    j_save(str(tmp_path / "m.npz"), params)
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((4, 9, 8)).astype(np.float32)
    ys = rng.integers(0, 11, (4, 9))

    def j_loss(p):
        logits, _ = jnet.apply_sequence(p, jnp.asarray(xs), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(ys)).mean(0).sum()

    want = jax.grad(j_loss)(params)
    net = get_network("peepholelstm", 2, [16], 11, in_dim=8,
                      scan_impl="pallas", device="cpu")
    net.load_state_dict(load_jax_params(tmp_path / "m.npz", device="cpu"))
    logits, _ = net.apply_sequence(torch.from_numpy(xs), train=True)
    F.cross_entropy(logits.reshape(-1, 11), torch.from_numpy(ys).reshape(-1),
                    reduction="none").reshape(4, 9).mean(0).sum().backward()
    for l in range(2):
        for key in ("wx", "wh", "peep_i", "peep_f", "peep_o"):
            _close(getattr(net.cells[l], key).grad,
                   np.asarray(want["cells"][l][key]), GRAD_RTOL,
                   f"cells.{l}.{key}")


# ---- the engine -----------------------------------------------------------

STAGES = [dict(epoch=2, optimizer="momentumsgd", batch_size=4, lr=1e-2,
               early_stopping=False)]


@pytest.fixture(scope="module")
def corpus():
    img = make_synthetic_image(num_phones=4, num_states=16, seed=3,
                               tied=False)
    return make_synthetic_corpus(img, dim=10, num_train=8, num_dev=4,
                                 num_test=2, noise=0.4, seed=3)


def _jax_run(corpus, name, init_path, impl, stages, dropout):
    jnet = dataclasses.replace(
        j_get_network(name, 2, [16], 16, dropout=dropout), scan_impl=impl)
    params = j_load(str(init_path), jnet.init(jax.random.PRNGKey(1), 10))
    cfg = JTrainConfig(stages=[JTrainStage(**s) for s in stages],
                       bprop_len=5, seed=0, log=None)
    c = corpus
    return j_train_network(jnet, c.train.data, c.train.targets, cfg,
                           offsets=c.train.offsets, x_dev=c.dev.data,
                           y_dev=c.dev.targets, init_params=params)


def _port_run(corpus, name, init_path, impl, stages, dropout):
    net = get_network(name, 2, [16], 16, dropout=dropout, in_dim=10,
                      scan_impl=impl, device="cpu")
    cfg = TrainConfig(stages=[TrainStage(**s) for s in stages],
                      bprop_len=5, seed=0, log=None)
    c = corpus
    return train_network(net, c.train.data, c.train.targets, cfg,
                         offsets=c.train.offsets, x_dev=c.dev.data,
                         y_dev=c.dev.targets,
                         init_params=load_jax_params(init_path, device="cpu"),
                         device="cpu")


@pytest.mark.parametrize("name,impl,dropout,loss_rtol,param_atol", [
    ("peepholelstm", "xla", [0.0], 1e-5, 1e-5),
    ("peepholelstm", "pallas", [0.0], 1e-3, 5e-3),
    ("zoneoutlstm", "pallas", [0.0, 0.0], 1e-5, 1e-5),
], ids=["peephole-xla", "peephole-pallas", "zoneout0-pallas"])
def test_engine_matches_jax(tmp_path, corpus, name, impl, dropout,
                            loss_rtol, param_atol):
    """Same npz init, dropout 0, zoneout ratios 0 (zoneout the identity,
    so nothing depends on the masks), the same seed and so the same
    minibatches: per-epoch losses and final params against JAX
    ``train_network``."""
    init_path = tmp_path / "init.npz"
    j_save(str(init_path), j_get_network(name, 2, [16], 16).init(
        jax.random.PRNGKey(0), 10))
    want = _jax_run(corpus, name, init_path, impl, STAGES, dropout)
    got = _port_run(corpus, name, init_path, impl, STAGES, dropout)
    assert len(got.history) == len(want.history) == 2
    for hp, hj in zip(got.history, want.history):
        assert (hp["stage"], hp["epoch"]) == (hj["stage"], hj["epoch"])
        for k in ("main/loss", "validation/main/loss"):
            np.testing.assert_allclose(hp[k], hj[k], rtol=loss_rtol,
                                       err_msg=k)
    flat = jax.tree_util.tree_flatten_with_path(want.params)[0]
    assert len(flat) == len(got.params)
    for path, leaf in flat:
        key = _path_str(path).replace("/", ".")
        np.testing.assert_allclose(got.params[key].numpy(), np.asarray(leaf),
                                   atol=param_atol, rtol=0, err_msg=key)
    assert got.history[-1]["main/loss"] < got.history[0]["main/loss"]
