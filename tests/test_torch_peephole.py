"""The port's peephole LSTM and zoneout LSTMs against the JAX package,
inference side.

``peephole_scan`` on CPU tensors takes its plain version
(``peephole_scan_reference``); it is held against the JAX Pallas kernel
``peephole_scan_pallas`` run in interpret mode and against the JAX
mixed-precision twin ``peephole_scan_mixed_reference``, across the JAX
kernel's time block of 8. The ``PeepholeLSTM``, ``ZoneoutLSTM`` and
``ZoneoutDropoutLSTM`` stacks are held against the JAX networks on shared
``save_pytree`` weights, on both routes.

Tolerances and the maxima observed at these sizes (CPU):

- against the interpreted kernel, float32 hs, c_T and h_T:
  ``1e-3 * max|x|`` (observed 1.2e-7 at T=13, the same operations with
  the float32 sums of the recurrent products in another order; 1.8e-4
  at T=5, where one bf16 rounding of c lies so near a tie that the two
  sum orders round it apart, as the JAX kernel and its own twin do there
  too; a rounding point left out shows at ~1e-2); bf16 hs within one
  bf16 ulp of its largest value, ``2**-7 * max|x|`` (observed 1.2e-3);
- against the mixed twin, whose hs is bf16 even for float32 proj: hs
  ``2**-7 * max|x|`` (observed 2.3e-3), c_T and h_T ``1e-3 * max|x|``
  (observed 1.7e-7);
- the stacks' log-posteriors, each route against the JAX network on the
  same route: atol ``1e-5`` (observed 4.8e-7), the carried c and h
  ``1e-5`` of their largest value (observed 3.1e-7);
- the zoneout LSTMs at eval equal the port's ``LSTM`` on the same
  weights bit for bit, on each route (zoneout passes the new state
  through at eval);
- the bf16 serving forward against the JAX ``HalfPrecisionNet``: atol
  ``1e-5`` (observed 2.4e-7).
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
    peephole_scan_mixed_reference,
    peephole_scan_pallas,
)
from nnacousticmodeling_tpu.train.checkpoint import save_pytree as j_save
from nnacousticmodeling_tpu_torch import kernels
from nnacousticmodeling_tpu_torch.models import (
    PeepholeLSTM,
    ZoneoutDropoutLSTM,
    ZoneoutLSTM,
    get_network,
)
from nnacousticmodeling_tpu_torch.ops.numerics import log_softmax
from nnacousticmodeling_tpu_torch.ops.rnn_cuda import peephole_scan
from nnacousticmodeling_tpu_torch.train import (
    load_jax_params,
    load_pytree,
    save_pytree,
)

KERNEL_RTOL = 1e-3
HS_TWIN_RTOL = 2.0 ** -7
NET_ATOL = 1e-5

NETS = {"peepholelstm": PeepholeLSTM, "zoneoutlstm": ZoneoutLSTM,
        "zoneoutdropoutlstm": ZoneoutDropoutLSTM}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rtol, what):
    got, want = _f32(got), _f32(want)
    scale = max(np.abs(want).max(), 1e-3)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def peephole_case(seed, t, b=8, h=16):
    rng = np.random.default_rng(seed)
    proj = (rng.standard_normal((t, b, 4 * h)) * 0.5).astype(np.float32)
    wh = (rng.standard_normal((h, 4 * h)) * 0.3).astype(np.float32)
    peeps = [(rng.standard_normal((h, h)) * 0.3).astype(np.float32)
             for _ in range(3)]
    c0 = (rng.standard_normal((b, h)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((b, h)) * 0.1).astype(np.float32)
    return proj, wh, *peeps, c0, h0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [5, 13])
def test_peephole_scan_matches_jax_kernel(t, dtype):
    proj, *rest = peephole_case(t, t)
    tproj = torch.from_numpy(proj).to(getattr(torch, dtype))
    jproj = jnp.asarray(proj).astype(dtype)
    targs = [torch.from_numpy(a) for a in rest]
    jargs = [jnp.asarray(a) for a in rest]
    before = dict(kernels.launches)
    (ct, ht), hs = peephole_scan(tproj, *targs)
    assert dict(kernels.launches) == before          # CPU: plain version
    assert hs.dtype == tproj.dtype and hs.shape == (t, 8, 16)
    assert ct.dtype == ht.dtype == torch.float32 and ct.shape == (8, 16)
    (ct_k, ht_k), hs_k = peephole_scan_pallas(jproj, *jargs, interpret=True)
    _close(hs, hs_k, HS_TWIN_RTOL if dtype == "bfloat16" else KERNEL_RTOL,
           "hs vs kernel")
    _close(ct, ct_k, KERNEL_RTOL, "c_T vs kernel")
    _close(ht, ht_k, KERNEL_RTOL, "h_T vs kernel")
    (ct_r, ht_r), hs_r = peephole_scan_mixed_reference(jproj, *jargs)
    _close(hs, hs_r, HS_TWIN_RTOL, "hs vs twin")
    _close(ct, ct_r, KERNEL_RTOL, "c_T vs twin")
    _close(ht, ht_r, KERNEL_RTOL, "h_T vs twin")


def test_peephole_scan_checks_the_peephole_shapes():
    proj, wh, pi, pf, po, c0, h0 = [torch.from_numpy(a)
                                    for a in peephole_case(1, 3)]
    with pytest.raises(ValueError, match="peephole"):
        peephole_scan(proj, wh, pi[:, :8], pf, po, c0, h0)
    with pytest.raises(ValueError, match="4\\*H"):
        peephole_scan(proj[..., :48], wh, pi, pf, po, c0, h0)


# ---- the stacks ---------------------------------------------------------

def shared_net(tmp_path, name, layers=2, units=16, in_dim=8, classes=11,
               dropout=(0.0,)):
    """A JAX network, its params and their ``save_pytree`` file."""
    jnet = j_get_network(name, layers, [units], classes, dropout=dropout)
    params = jnet.init(jax.random.PRNGKey(3), in_dim)
    path = str(tmp_path / f"{name}.npz")
    j_save(path, params)
    return jnet, params, path


def port_net(path, name, impl, layers=2, units=16, in_dim=8, classes=11,
             dropout=(0.0,)):
    net = get_network(name, layers, [units], classes, dropout=dropout,
                      in_dim=in_dim, scan_impl=impl, device="cpu")
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
    for (c, h), (jc, jh) in zip(st, j_st):
        assert c.dtype == h.dtype == torch.float32
        _close(c, jc, rtol, "carried c")
        _close(h, jh, rtol, "carried h")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_lstm_family_stack_matches_jax(tmp_path, name, impl):
    jnet, params, path = shared_net(tmp_path, name, dropout=(0.2, 0.3))
    jnet = dataclasses.replace(jnet, scan_impl=impl)
    net = port_net(path, name, impl, dropout=(0.2, 0.3))
    assert type(net) is NETS[name]
    xs = np.random.default_rng(7).standard_normal((3, 13, 8)).astype(
        np.float32)
    y, st, want, j_st = _run_both(jnet, params, net, xs)
    assert y.shape == (3, 13, 11)
    np.testing.assert_allclose(y, want, atol=NET_ATOL)
    _assert_state(st, j_st, NET_ATOL)
    # the carried state goes on where the first call stopped
    y2, st2, want2, j_st2 = _run_both(jnet, params, net, xs, st, j_st)
    np.testing.assert_allclose(y2, want2, atol=NET_ATOL)
    _assert_state(st2, j_st2, NET_ATOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", ["zoneoutlstm", "zoneoutdropoutlstm"])
def test_zoneout_eval_is_the_lstm_bit_for_bit(tmp_path, name, impl):
    """At eval zoneout passes the new state through, so the zoneout nets'
    posteriors are the plain LSTM's on the same weights, exactly, on the
    float32 loop and on the kernel route (``lstm_scan``)."""
    _, _, path = shared_net(tmp_path, name, dropout=(0.2, 0.5, 0.5))
    net = port_net(path, name, impl, dropout=(0.2, 0.5, 0.5))
    lstm = port_net(path, "lstm", impl)
    xs = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 9, 8)).astype(np.float32))
    with torch.inference_mode():
        y, st = net.apply_sequence(xs)
        y_l, st_l = lstm.apply_sequence(xs)
    assert torch.equal(y, y_l)
    for a, b in zip(st, st_l):
        assert all(torch.equal(x, z) for x, z in zip(a, b))


@pytest.mark.parametrize("name,dropout,want", [
    ("zoneoutlstm", [], (0.0, 0.5, 0.5)),
    ("zoneoutlstm", [0.2], (0.0, 0.2, 0.5)),
    ("zoneoutlstm", [0.2, 0.1], (0.0, 0.2, 0.1)),
    ("zoneoutdropoutlstm", [0.3], (0.3, 0.5, 0.5)),
    ("zoneoutdropoutlstm", [0.3, 0.2, 0.1], (0.3, 0.2, 0.1)),
    ("peepholelstm", [0.2], (0.2, None, None)),
])
def test_get_network_maps_the_dropout_list_positionally(name, dropout, want):
    """``-d`` maps onto (c_ratio, h_ratio) for ``zoneoutlstm`` and onto
    (dropout, c_ratio, h_ratio) for ``zoneoutdropoutlstm``, 0.5 for the
    ratios left out, as the JAX factory does (networks.py:553-568)."""
    net = get_network(name, 1, [4], 3, dropout=dropout, in_dim=2,
                      device="cpu")
    jnet = j_get_network(name, 1, [4], 3, dropout=dropout)
    got = (net.dropout, getattr(net, "c_ratio", None),
           getattr(net, "h_ratio", None))
    assert got == want
    assert got == (jnet.input_dropout_rate, getattr(jnet, "c_ratio", None),
                   getattr(jnet, "h_ratio", None))


def test_peephole_init_has_zero_bias_and_full_peepholes():
    """No forget bias of 1 (unlike the LSTM) and (H, H) peephole
    matrices, as cells.py:124-136 inits them."""
    net = get_network("peepholelstm", 2, [6], 3, in_dim=4, device="cpu")
    state = net.state_dict()
    jparams = j_get_network("peepholelstm", 2, [6], 3).init(
        jax.random.PRNGKey(0), 4)
    for l in range(2):
        assert float(state[f"cells.{l}.b"].abs().max()) == 0.0
        for key, leaf in jparams["cells"][l].items():
            assert tuple(state[f"cells.{l}.{key}"].shape) == leaf.shape, key
        for key in ("peep_i", "peep_f", "peep_o"):
            assert state[f"cells.{l}.{key}"].shape == (6, 6)
            assert float(state[f"cells.{l}.{key}"].abs().min()) > 0.0


def test_peephole_checkpoints_carry_jax_keys_both_ways(tmp_path):
    """``load_jax_params`` maps ``cells/<l>/peep_i`` and its siblings from a
    JAX ``PeepholeLSTM`` ``save_pytree`` file, and the port's
    ``save_pytree`` writes them back under the JAX keys."""
    from nnacousticmodeling_tpu.train import load_pytree as j_load
    _, params, path = shared_net(tmp_path, "peepholelstm")
    loaded = load_jax_params(path, device="cpu")
    assert {"cells.0.peep_i", "cells.1.peep_f", "cells.1.peep_o"} <= set(loaded)
    net = port_net(path, "peepholelstm", "pallas")
    state = net.state_dict()
    assert sorted(state) == sorted(loaded)
    save_pytree(tmp_path / "port", net)
    back = j_load(str(tmp_path / "port.npz"), params)
    for l in range(2):
        for key, leaf in back["cells"][l].items():
            np.testing.assert_array_equal(np.asarray(leaf),
                                          state[f"cells.{l}.{key}"].numpy())
    again = load_pytree(tmp_path / "port.npz", net)
    assert all(torch.equal(again[k], state[k]) for k in state)


def test_half_precision_peephole_posteriors_match_jax(tmp_path):
    """The bf16 serving forward of the peephole net on the kernel route
    equals the JAX ``HalfPrecisionNet`` posteriors within 1e-5 and is
    really bf16: more than 1e-3 away from float32."""
    from nnacousticmodeling_tpu.infer.posteriors import (
        rnn_log_posteriors as j_rnn_log_posteriors)
    from nnacousticmodeling_tpu.models.precision import (
        HalfPrecisionNet as JHalfPrecisionNet)
    from nnacousticmodeling_tpu_torch.infer import rnn_log_posteriors
    from nnacousticmodeling_tpu_torch.models import HalfPrecisionNet
    jnet, params, path = shared_net(tmp_path, "peepholelstm", units=32)
    jh = JHalfPrecisionNet(dataclasses.replace(jnet, scan_impl="pallas"))
    rng = np.random.default_rng(9)
    offsets = np.concatenate([[0], np.cumsum([7, 12, 3, 9, 10])])
    x = rng.standard_normal((offsets[-1], 8)).astype(np.float32)
    kw = dict(batch=4, bucket_sizes=[8, 16])
    want = j_rnn_log_posteriors(jh, jh.cast(params), x, offsets, **kw)
    net = port_net(path, "peepholelstm", "pallas", units=32)
    got = rnn_log_posteriors(HalfPrecisionNet(net), x, offsets, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - rnn_log_posteriors(net, x, offsets, **kw)).max() \
        > 1e-3
