"""The port's trainable gated recurrences against the JAX custom VJP, and
the training engine on the gated nets against JAX ``train_network``.

On CPU tensors ``gated_train_forward`` / ``gated_train_backward`` take
their plain versions (explicit step loops with the TPU kernels' bf16
roundings); they are held against the JAX Pallas kernels
``_gated_train_fwd_impl`` / ``_gated_train_bwd_impl`` run in interpret
mode, through ``jax.grad`` of ``gated_scan_pallas_train``, at the odd
lengths that the JAX backward pads to its time block of 4
(rnn_pallas.py:799-806).

Tolerances and the maxima observed at these sizes (CPU):

- forward hs and h_T: ``1e-5 * max|x|`` (observed 1.9e-7);
- residuals (bf16): rtol 2**-7, one bf16 ulp (observed: all equal);
- gradients: ``1e-4 * max|JAX gradient|`` per tensor (observed 2.9e-5,
  dh0 of ``mgru_r`` at T=7; the rest within 1e-5): the float32 sums of
  the reverse products run in another order, and a bf16 rounding of
  ``pair`` or ``dcpre`` that flips moves a gradient by a share of one
  bf16 ulp (2**-8); a rounding point left out shows at ~1e-2;
- the networks' recurrent-weight gradients on the kernel route:
  ``1e-5 * scale`` (observed 1.5e-7);
- ``train_network``: the float32 loop, losses rtol 1e-5 (observed
  1.1e-6) and params atol 1e-5 (observed 6.0e-7) over a momentum and an
  adam stage; the kernel route over the momentum stage, losses rtol
  1e-3 (observed 2.9e-4) and params atol 5e-3 (observed 1.0e-3), as the
  bf16 rounding flips of two runs compound from update to update; bf16
  compute (GRU), losses rtol 5e-3 (observed 1.3e-3) and params atol
  1e-2 (observed 2.5e-3).
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
    _gated_train_fwd_impl,
    gated_scan_pallas_train,
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
    gated_scan_reference,
    gated_scan_train,
    gated_train_backward,
    gated_train_backward_reference,
    gated_train_dw,
    gated_train_dw_reference,
    gated_train_forward,
    gated_train_forward_reference,
)
from nnacousticmodeling_tpu_torch.train import (
    TrainConfig,
    TrainStage,
    load_jax_params,
    train_network,
)

FWD_RTOL = 1e-5
RES_RTOL = 2.0 ** -7
GRAD_RTOL = 1e-4

KINDS = {"gru": (3, "tanh"), "mgru_r": (3, "relu"), "mgru": (2, "relu")}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rtol, what):
    got, want = _f32(got), _f32(want)
    scale = max(np.abs(want).max(), 1e-3)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def _case(seed, kind, t, b=8, h=16):
    rng = np.random.default_rng(seed)
    gp = KINDS[kind][0]
    proj = rng.standard_normal((t, b, gp * h)).astype(np.float32)
    w1 = (rng.standard_normal((h, 2 * h)) * 0.2).astype(np.float32)
    w2 = (None if kind == "mgru" else
          (rng.standard_normal((h, h)) * 0.2).astype(np.float32))
    h0 = (rng.standard_normal((b, h)) * 0.1).astype(np.float32)
    w_out = rng.standard_normal((h, 4)).astype(np.float32)
    return proj, w1, w2, h0, w_out


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [7, 13])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_gated_train_forward_matches_jax_kernel(kind, t, dtype):
    proj, w1, w2, h0, _ = _case(t, kind, t)
    act = KINDS[kind][1]
    hs_j, res_j, ht_j = _gated_train_fwd_impl(
        kind, act, jnp.asarray(proj).astype(dtype), *_jax(w1, w2, h0),
        interpret=True)
    tproj = torch.from_numpy(proj).to(getattr(torch, dtype))
    args = _torch(w1, w2, h0)
    before = dict(kernels.launches)
    hs, res, ht = gated_train_forward(tproj, *args, kind=kind,
                                      activation=act)
    assert dict(kernels.launches) == before          # CPU: plain version
    assert hs.dtype == tproj.dtype and hs.shape == (t, 8, 16)
    assert res.dtype == torch.bfloat16 and res.shape == (t, 8, 64)
    assert ht.dtype == torch.float32
    _close(hs, hs_j, FWD_RTOL, "hs")
    _close(ht, ht_j, FWD_RTOL, "h_T")
    # the JAX kernel pads time to its block of 8; the port has no padding
    np.testing.assert_allclose(_f32(res), _f32(res_j)[:t], rtol=RES_RTOL,
                               atol=1e-7)
    ht_s, hs_s = gated_scan_reference(tproj, *args, kind=kind,
                                      activation=act)
    assert torch.equal(hs, hs_s) and torch.equal(ht, ht_s)


def _jax_grads(kind, proj, w1, w2, h0, w_out, carry_terms):
    act = KINDS[kind][1]

    def loss(p, a, b, h):
        ht, hs = gated_scan_pallas_train(p, a, b, h, kind=kind,
                                         activation=act)
        out = jnp.tanh(hs.astype(jnp.float32) @ w_out).sum()
        return out + 0.5 * ht.sum() if carry_terms else out

    return jax.grad(loss, argnums=(0, 1, 2, 3))(*_jax(proj, w1, w2, h0))


def _port_grads(kind, proj, w1, w2, h0, w_out, carry_terms):
    args = [None if a is None else torch.from_numpy(a).requires_grad_()
            for a in (proj, w1, w2, h0)]
    ht, hs = gated_scan_train(*args, kind=kind, activation=KINDS[kind][1])
    loss = torch.tanh(hs @ torch.from_numpy(w_out)).sum()
    if carry_terms:
        loss = loss + 0.5 * ht.sum()
    loss.backward()
    return [None if a is None else a.grad for a in args]


@pytest.mark.parametrize("carry_terms", [True, False],
                         ids=["hs_and_carry", "hs_only"])
@pytest.mark.parametrize("t", [5, 6, 7])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_gated_scan_train_grads_match_jax_vjp(kind, t, carry_terms):
    """The loss of tests/test_rnn_pallas.py:429-433 (hs and h_T terms),
    and one that reads hs only, so h_T gets no cotangent and must arrive
    as zeros; ``mgru`` has no w2 and gets no w2 gradient."""
    case = _case(100 + t, kind, t)
    want = _jax_grads(kind, *case, carry_terms)
    got = _port_grads(kind, *case, carry_terms)
    for g, w, name in zip(got, want, ["dproj", "dw1", "dw2", "dh0"]):
        if w is None:
            assert g is None and kind == "mgru", name
            continue
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close(g, w, GRAD_RTOL, f"{kind} T={t} {name}")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_gated_backward_dtypes_follow_jax(kind):
    """dproj in proj's dtype, dW1 / dW2 in the weights', dh0 in the
    carry's (rnn_pallas.py:958-971); bf16 inputs give bf16 gradients."""
    proj, w1, w2, h0, _ = _case(4, kind, 6)
    args = [None if a is None else
            torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
            for a in (proj, w1, w2, h0)]
    ht, hs = gated_scan_train(*args, kind=kind, activation=KINDS[kind][1])
    assert hs.dtype == ht.dtype == torch.bfloat16
    (hs.float().sum() + ht.float().sum()).backward()
    for x in args:
        assert x is None or x.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_gated_backward_and_dw_wrappers_route_cpu_to_plain(kind):
    proj, w1, w2, h0, _ = _case(8, kind, 7)
    act = KINDS[kind][1]
    args = _torch(proj, w1, w2, h0)
    _, res, _ = gated_train_forward_reference(*args, kind=kind,
                                              activation=act)
    rng = np.random.default_rng(1)
    dhs = torch.from_numpy(rng.standard_normal((7, 8, 16)).astype(
        np.float32))
    dht = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    before = dict(kernels.launches)
    got = gated_train_backward(res, args[1], args[2], dhs, dht,
                               torch.float32, kind=kind, activation=act)
    want = gated_train_backward_reference(res, args[1], args[2], dhs, dht,
                                          torch.float32, kind=kind,
                                          activation=act)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    pair = torch.from_numpy(rng.standard_normal((7, 8, 32)).astype(
        np.float32)).to(torch.bfloat16)
    dc = (None if kind == "mgru" else torch.from_numpy(
        rng.standard_normal((7, 8, 16)).astype(np.float32)).to(
            torch.bfloat16))
    for g, w in zip(gated_train_dw(res, pair, dc),
                    gated_train_dw_reference(res, pair, dc)):
        assert (g is None and w is None) or torch.equal(g, w)
    assert dict(kernels.launches) == before


# ---- the networks on the kernel route ------------------------------------

RECURRENT = {"gru": ("wh_rz", "wh_c"), "mgrurelu": ("u_z", "u"),
             "mgrurelur": ("u_z", "u", "u_r")}


@pytest.mark.parametrize("name", sorted(RECURRENT))
def test_network_kernel_route_gets_the_custom_vjp_gradient(tmp_path, name):
    """``scan_impl="pallas"`` with ``train=True`` differentiates through
    ``gated_scan_train``; the recurrent weights' gradients -- for MGRU
    split back out of the ``[u_z | u]`` / ``[u_z | u_r]`` concatenation
    by autograd -- equal the JAX network's custom VJP."""
    jnet = dataclasses.replace(j_get_network(name, 2, [16], 11),
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
    net = get_network(name, 2, [16], 11, in_dim=8, scan_impl="pallas",
                      device="cpu")
    net.load_state_dict(load_jax_params(tmp_path / "m.npz", device="cpu"))
    logits, _ = net.apply_sequence(torch.from_numpy(xs), train=True)
    F.cross_entropy(logits.reshape(-1, 11), torch.from_numpy(ys).reshape(-1),
                    reduction="none").reshape(4, 9).mean(0).sum().backward()
    for l in range(2):
        for key in RECURRENT[name] + ("wx" if name == "gru" else "w",):
            w = np.asarray(want["cells"][l][key])
            g = getattr(net.cells[l], key).grad.numpy()
            _close(g, w, GRAD_RTOL, f"cells.{l}.{key}")


# ---- the engine -----------------------------------------------------------

STAGES = [dict(epoch=2, optimizer="momentumsgd", batch_size=4, lr=1e-2,
               early_stopping=False),
          dict(epoch=1, optimizer="adam", batch_size=4, lr=1e-2,
               early_stopping=False)]


@pytest.fixture(scope="module")
def corpus():
    img = make_synthetic_image(num_phones=4, num_states=16, seed=3,
                               tied=False)
    return make_synthetic_corpus(img, dim=10, num_train=8, num_dev=4,
                                 num_test=2, noise=0.4, seed=3)


def _jax_run(corpus, name, init_path, impl, stages, **kw):
    jnet = dataclasses.replace(j_get_network(name, 2, [16], 16),
                               scan_impl=impl)
    template = jnet.init(jax.random.PRNGKey(1), 10)
    params = j_load(str(init_path), template)
    cfg = JTrainConfig(stages=[JTrainStage(**s) for s in stages],
                       bprop_len=5, seed=0, log=None, **kw)
    c = corpus
    return j_train_network(jnet, c.train.data, c.train.targets, cfg,
                           offsets=c.train.offsets, x_dev=c.dev.data,
                           y_dev=c.dev.targets, init_params=params)


def _port_run(corpus, name, init_path, impl, stages=STAGES, layers=2,
              dropout_rate=0.0, **kw):
    net = get_network(name, layers, [16], 16, dropout=[dropout_rate],
                      in_dim=10, scan_impl=impl, device="cpu")
    init = (load_jax_params(init_path, device="cpu") if init_path
            else None)
    cfg = TrainConfig(stages=[TrainStage(**s) for s in stages],
                      bprop_len=5, seed=0, log=None, **kw)
    c = corpus
    return train_network(net, c.train.data, c.train.targets, cfg,
                         offsets=c.train.offsets, x_dev=c.dev.data,
                         y_dev=c.dev.targets, init_params=init,
                         device="cpu")


@pytest.mark.parametrize("name,impl,dtype,stages,loss_rtol,param_atol", [
    ("gru", "xla", "float32", STAGES, 1e-5, 1e-5),
    ("mgrurelur", "xla", "float32", STAGES, 1e-5, 1e-5),
    ("gru", "pallas", "float32", STAGES[:1], 1e-3, 5e-3),
    ("mgrurelur", "pallas", "float32", STAGES[:1], 1e-3, 5e-3),
    ("gru", "pallas", "bfloat16", STAGES[:1], 5e-3, 1e-2),
], ids=["gru-xla", "mgrurelur-xla", "gru-pallas", "mgrurelur-pallas",
        "gru-pallas_bf16"])
def test_engine_matches_jax_on_gated_nets(tmp_path, corpus, name, impl,
                                          dtype, stages, loss_rtol,
                                          param_atol):
    """The xla route through both stages (the optimizer rebuilt at the
    stage switch); the kernel route through the momentum stage, before
    bf16 rounding flips, compounded by adam's normalised steps, carry
    the two runs apart (epoch 3 after adam: 1.5e-3 relative loss); bf16
    compute on the GRU (the relu MGRU-r drifts 1.4e-2 apart in bf16
    within two epochs, while its bf16 forward equals JAX's to 2.4e-7:
    ``test_torch_gated.py::test_half_precision_gated_posteriors_match_jax``)."""
    init_path = tmp_path / "init.npz"
    j_save(str(init_path), j_get_network(name, 2, [16], 16).init(
        jax.random.PRNGKey(0), 10))
    want = _jax_run(corpus, name, init_path, impl, stages,
                    compute_dtype=dtype)
    got = _port_run(corpus, name, init_path, impl, stages,
                    compute_dtype=dtype)
    assert len(got.history) == len(want.history) == sum(
        s["epoch"] for s in stages)
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


@pytest.mark.parametrize("name", ["gru", "mgrurelur"])
def test_resume_mid_stage_replays_gated_run_exactly(tmp_path, corpus, name):
    """A gated run killed after an epoch and resumed from its snapshot
    makes exactly the uninterrupted run's remaining epochs: the snapshot
    carries the ``(h, fresh)`` stream state of every layer (dropout 0.2,
    kernel route)."""
    stages = [dict(epoch=3, optimizer="momentumsgd", batch_size=4, lr=1e-2,
                   early_stopping=False)]

    class Crash(Exception):
        pass

    def crash(stage, epoch):
        if (stage, epoch) == (0, 1):
            raise Crash

    def run(snap, resume, hook=None):
        return _port_run(corpus, name, None, "pallas", stages=stages,
                         dropout_rate=0.2, snapshot_path=snap,
                         resume_snapshot=resume, epoch_hook=hook)

    ref = run(str(tmp_path / "ref.npz"), False)
    snap = str(tmp_path / "snap.npz")
    with pytest.raises(Crash):
        run(snap, False, crash)
    blob = np.load(snap)
    assert [blob[f"__st_{i}__"].shape for i in range(4)] == \
        [(4, 16), (4, 1)] * 2
    assert float(np.abs(blob["__st_1__"]).max()) == 0.0    # fresh spent
    res = run(snap, True)
    assert len(res.history) == 2
    for h_res, h_ref in zip(res.history, ref.history[1:]):
        assert h_res["main/loss"] == h_ref["main/loss"]
        assert h_res["validation/main/loss"] == h_ref["validation/main/loss"]
    for k in ref.params:
        assert torch.equal(res.params[k], ref.params[k]), k
