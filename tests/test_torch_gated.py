"""The port's gated recurrences (GRU, MGRU with and without the reset
gate) against the JAX package, inference side.

``gated_scan`` on CPU tensors takes its plain version
(``gated_scan_reference``); it is held against the JAX Pallas kernel
``gated_scan_pallas`` run in interpret mode and against the JAX
mixed-precision twin ``gated_scan_mixed_reference``, across the JAX
kernel's time block of 8. The ``GRU`` and ``MGRUNet`` stacks, their
``(h, fresh)`` carry and the converted-checkpoint U biases are held
against the JAX networks on shared ``save_pytree`` weights.

Tolerances, relative to the largest value of each tensor (the relu
candidate of MGRU is unbounded, so an absolute tolerance sized for the
LSTM would not do), and the maxima observed at these sizes (CPU):

- against the interpreted kernel, hs and h_T: ``1e-5 * max|x|``
  (observed 2.6e-7: the same operations, the float32 sums of the
  recurrent products in another order);
- against the mixed twin, whose hs is bf16 even for float32 proj and
  whose h_T is float32: ``2**-7 * max|x|`` for hs, one bf16 ulp of its
  largest value (observed 2.7e-3), ``1e-5 * max|x|`` for h_T (observed
  2.6e-7);
- the stacks' log-posteriors, float32 loop (``scan_impl="xla"``) and
  kernel route each against the JAX network on the same route: atol
  ``1e-5`` (observed 4.8e-7 on both); the carried h ``1e-5`` of its
  largest value (observed 2.1e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu.models import get_network as j_get_network
from nnacousticmodeling_tpu.ops.numerics import log_softmax as j_log_softmax
from nnacousticmodeling_tpu.ops.rnn_pallas import (
    gated_scan_mixed_reference,
    gated_scan_pallas,
)
from nnacousticmodeling_tpu.train.checkpoint import save_pytree as j_save
from nnacousticmodeling_tpu_torch import kernels
from nnacousticmodeling_tpu_torch.models import GRU, MGRUNet, get_network
from nnacousticmodeling_tpu_torch.ops.numerics import log_softmax
from nnacousticmodeling_tpu_torch.ops.rnn_cuda import gated_scan
from nnacousticmodeling_tpu_torch.train import (
    load_jax_params,
    load_pytree,
    save_pytree,
)

KERNEL_RTOL = 1e-5
HS_TWIN_RTOL = 2.0 ** -7
NET_ATOL = 1e-5

KINDS = {"gru": (3, "tanh"), "mgru_r": (3, "relu"), "mgru": (2, "relu")}
J_ACTS = {"tanh": jnp.tanh, "relu": jax.nn.relu}
NETS = ["gru", "mgrurelu", "mgrurelur"]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rtol, what):
    got, want = _f32(got), _f32(want)
    scale = max(np.abs(want).max(), 1e-3)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def gated_case(seed, kind, t, b=8, h=16):
    rng = np.random.default_rng(seed)
    gp = KINDS[kind][0]
    proj = (rng.standard_normal((t, b, gp * h)) * 0.5).astype(np.float32)
    w1 = (rng.standard_normal((h, 2 * h)) * 0.3).astype(np.float32)
    w2 = (None if kind == "mgru" else
          (rng.standard_normal((h, h)) * 0.3).astype(np.float32))
    h0 = (rng.standard_normal((b, h)) * 0.1).astype(np.float32)
    return proj, w1, w2, h0


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [7, 8, 13])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_gated_scan_matches_jax_kernel(kind, t, dtype):
    proj, w1, w2, h0 = gated_case(t, kind, t)
    act = KINDS[kind][1]
    tproj = torch.from_numpy(proj).to(getattr(torch, dtype))
    jproj = jnp.asarray(proj).astype(dtype)
    before = dict(kernels.launches)
    ht, hs = gated_scan(tproj, *_torch(w1, w2, h0), kind=kind,
                        activation=act)
    assert dict(kernels.launches) == before          # CPU: plain version
    assert hs.dtype == tproj.dtype and hs.shape == (t, 8, 16)
    assert ht.dtype == torch.float32 and ht.shape == (8, 16)
    jargs = _jax(w1, w2, h0)
    ht_k, hs_k = gated_scan_pallas(jproj, *jargs, kind=kind,
                                   activation=J_ACTS[act], interpret=True)
    _close(hs, hs_k, KERNEL_RTOL, "hs vs kernel")
    _close(ht, ht_k, KERNEL_RTOL, "h_T vs kernel")
    ht_r, hs_r = gated_scan_mixed_reference(jproj, *jargs, kind=kind,
                                            activation=J_ACTS[act])
    _close(hs, hs_r, HS_TWIN_RTOL, "hs vs twin")
    _close(ht, ht_r, KERNEL_RTOL, "h_T vs twin")


@pytest.mark.parametrize("kwargs,match", [
    (dict(kind="lstm"), "unknown kind"),
    (dict(kind="mgru", activation="gelu"), "unknown activation"),
])
def test_gated_scan_rejects_unknown_kind_and_activation(kwargs, match):
    kind = "mgru" if kwargs["kind"] == "mgru" else "gru"
    proj, w1, w2, h0 = gated_case(1, kind, 3)
    with pytest.raises(ValueError, match=match):
        gated_scan(*_torch(proj, w1, w2, h0), **kwargs)


def test_gated_scan_checks_w2_against_kind():
    proj, w1, _, h0 = gated_case(2, "gru", 3)
    with pytest.raises(ValueError, match="w2"):
        gated_scan(*_torch(proj, w1, None, h0), kind="gru")
    proj, w1, _, h0 = gated_case(2, "mgru", 3)
    with pytest.raises(ValueError, match="no w2"):
        gated_scan(*_torch(proj, w1, w1[:, :16].copy(), h0), kind="mgru")


# ---- the stacks ---------------------------------------------------------

def shared_net(tmp_path, name, layers=2, units=16, in_dim=8, classes=11,
               bu=False):
    """A JAX network, its params (with converted-checkpoint U biases when
    ``bu``) and their ``save_pytree`` file."""
    jnet = j_get_network(name, layers, [units], classes)
    params = jnet.init(jax.random.PRNGKey(3), in_dim)
    if bu:
        rng = np.random.default_rng(6)
        for cell in params["cells"]:
            keys = (["bu"] if name == "gru" else
                    ["bu_z", "bu"] + (["bu_r"] if name == "mgrurelur"
                                      else []))
            for k in keys:
                n = 3 * units if k == "bu" and name == "gru" else units
                cell[k] = jnp.asarray(rng.standard_normal(n), jnp.float32)
    path = str(tmp_path / f"{name}.npz")
    j_save(path, params)
    return jnet, params, path


def port_net(path, name, impl, layers=2, units=16, in_dim=8, classes=11):
    net = get_network(name, layers, [units], classes, in_dim=in_dim,
                      scan_impl=impl, device="cpu")
    net.load_state_dict(load_jax_params(path, device="cpu"))
    return net


def _run_both(jnet, params, net, xs, state=None, j_state=None):
    jy, j_st = jnet.apply_sequence(params, jnp.asarray(xs), state=j_state)
    with torch.inference_mode():
        y, st = net.apply_sequence(torch.from_numpy(xs), state)
        y = log_softmax(y, dim=-1).numpy()
    return y, st, np.asarray(j_log_softmax(jy, axis=-1)), j_st


def _assert_state(st, j_st, rtol):
    assert len(st) == len(j_st)
    for (h, fresh), (jh, jfresh) in zip(st, j_st):
        assert h.dtype == fresh.dtype == torch.float32
        assert fresh.shape == tuple(jfresh.shape)
        np.testing.assert_array_equal(fresh.numpy(), np.asarray(jfresh))
        _close(h, jh, rtol, "carried h")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", NETS)
def test_gated_stack_matches_jax(tmp_path, name, impl):
    jnet, params, path = shared_net(tmp_path, name)
    jnet = dataclasses.replace(jnet, scan_impl=impl)
    net = port_net(path, name, impl)
    assert isinstance(net, GRU if name == "gru" else MGRUNet)
    xs = np.random.default_rng(7).standard_normal((3, 13, 8)).astype(
        np.float32)
    y, st, want, j_st = _run_both(jnet, params, net, xs)
    assert y.shape == (3, 13, 11)
    np.testing.assert_allclose(y, want, atol=NET_ATOL)
    _assert_state(st, j_st, NET_ATOL)
    assert all(float(f.abs().max()) == 0.0 for _, f in st)
    # the carried state goes on where the first call stopped
    y2, st2, want2, j_st2 = _run_both(jnet, params, net, xs, st, j_st)
    np.testing.assert_allclose(y2, want2, atol=NET_ATOL)
    _assert_state(st2, j_st2, NET_ATOL)


@pytest.mark.parametrize("name", ["gru", "mgrurelur"])
def test_gated_pallas_converted_bias_first_step(tmp_path, name):
    """Twin of tests/test_rnn_pallas.py:167-185: converted-checkpoint U
    biases stay gated off on the fresh first step on the kernel route,
    and are live from step 0 of a call on a carried state. Each port
    route is held against the same JAX route (``NET_ATOL``), and the
    kernel route against the JAX float32 loop, whose ``gru_step`` /
    ``mgru_step`` gate the biases with ``fresh``, within the JAX test's
    5e-2."""
    jnet, params, path = shared_net(tmp_path, name, layers=1, bu=True)
    xs = np.random.default_rng(7).standard_normal((3, 6, 8)).astype(
        np.float32)
    for impl in ("pallas", "xla"):
        net = port_net(path, name, impl, layers=1)
        assert "cells.0.bu" in net.state_dict()
        jnet_i = dataclasses.replace(jnet, scan_impl=impl)
        y, st, want, j_st = _run_both(jnet_i, params, net, xs)
        np.testing.assert_allclose(y, want, atol=NET_ATOL)
        y2, _, want2, _ = _run_both(jnet_i, params, net, xs, st, j_st)
        np.testing.assert_allclose(y2, want2, atol=NET_ATOL)
    _, _, want_x, _ = _run_both(jnet, params, net, xs)
    net_pl = port_net(path, name, "pallas", layers=1)
    y, _, _, _ = _run_both(jnet, params, net_pl, xs)
    np.testing.assert_allclose(y, want_x, atol=5e-2)
    # without the fresh gate the first frame would differ
    no_gate = [(h, torch.zeros_like(f)) for h, f in net_pl.init_state(3)]
    with torch.inference_mode():
        y_live, _ = net_pl.apply_sequence(torch.from_numpy(xs), no_gate)
    assert np.abs(log_softmax(y_live, dim=-1).numpy()[:, 0]
                  - want_x[:, 0]).max() > 1e-1


def test_mgru_ignores_activation_argument():
    """``get_network`` builds MGRU with its default relu candidate and
    ignores ``-a``, as the JAX factory does (networks.py:575-580)."""
    net = get_network("mgrurelu", 1, [4], 3, activation="tanh", in_dim=2,
                      device="cpu")
    assert net.activation == j_get_network("mgrurelu", 1, [4], 3,
                                           activation="tanh").activation
    assert net.activation == "relu"


@pytest.mark.parametrize("name", NETS)
def test_gated_checkpoints_carry_jax_keys_both_ways(tmp_path, name):
    """``load_jax_params`` takes the JAX gated layouts (npz and nested
    dict, ``bu*`` keys included) and the port's ``save_pytree`` writes
    them back under the JAX keys, which JAX ``load_pytree`` reads."""
    from nnacousticmodeling_tpu.train import load_pytree as j_load
    _, params, path = shared_net(tmp_path, name, bu=True)
    from_file = load_jax_params(path, device="cpu")
    from_dict = load_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    assert sorted(from_file) == sorted(from_dict)
    for k in from_file:
        assert torch.equal(from_file[k], from_dict[k]), k
    net = port_net(path, name, "pallas")
    state = net.state_dict()
    assert sorted(state) == sorted(from_file)
    save_pytree(tmp_path / "port", net)
    back = j_load(str(tmp_path / "port.npz"), params)
    for k, v in state.items():
        leaf = back["cells"][int(k.split(".")[1])][k.split(".")[2]] \
            if k.startswith("cells") else back["out"][k.split(".")[1]]
        np.testing.assert_array_equal(np.asarray(leaf), v.numpy())
    again = load_pytree(tmp_path / "port.npz", net)
    assert all(torch.equal(again[k], state[k]) for k in state)


@pytest.mark.parametrize("name", NETS)
def test_half_precision_gated_posteriors_match_jax(tmp_path, name):
    """The bf16 serving forward (``models/precision.py``) of the gated
    nets on the kernel route equals the JAX ``HalfPrecisionNet``
    posteriors within 1e-5 (observed 4.8e-7), casts the ``(h, fresh)``
    state to bf16 as the JAX ``state_cast`` does, and is really bf16:
    more than 1e-3 away from float32."""
    from nnacousticmodeling_tpu.infer.posteriors import (
        rnn_log_posteriors as j_rnn_log_posteriors)
    from nnacousticmodeling_tpu.models.precision import (
        HalfPrecisionNet as JHalfPrecisionNet)
    from nnacousticmodeling_tpu_torch.infer import rnn_log_posteriors
    from nnacousticmodeling_tpu_torch.models import HalfPrecisionNet
    jnet, params, path = shared_net(tmp_path, name, units=32)
    jh = JHalfPrecisionNet(dataclasses.replace(jnet, scan_impl="pallas"))
    rng = np.random.default_rng(9)
    offsets = np.concatenate([[0], np.cumsum([7, 12, 3, 9, 10])])
    x = rng.standard_normal((offsets[-1], 8)).astype(np.float32)
    kw = dict(batch=4, bucket_sizes=[8, 16])
    want = j_rnn_log_posteriors(jh, jh.cast(params), x, offsets, **kw)
    net = port_net(path, name, "pallas", units=32)
    half = HalfPrecisionNet(net)
    assert all(h.dtype == f.dtype == torch.bfloat16
               for h, f in half.init_state(2))
    got = rnn_log_posteriors(half, x, offsets, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - rnn_log_posteriors(net, x, offsets, **kw)).max() \
        > 1e-3
