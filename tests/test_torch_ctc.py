"""The port's CTC model (``models/ctc.py``) against the JAX package's on
the same params: logits of ``BiRNNCTC`` over an LSTM and a GRU base,
with and without lengths, padding invariance, ``ctc_loss``,
``greedy_decode`` and three Adam steps of ``make_ctc_train_step``
(``test_torch_ctc_loss.py`` holds the loss itself).

Both sides run the float32 step loop (``scan_impl="xla"``). Tolerances:
logits atol 1e-5, the loss rtol 1e-5, params after 3 steps atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu.models import get_network as j_get_network
from nnacousticmodeling_tpu.models.ctc import BiRNNCTC as JBiRNNCTC
from nnacousticmodeling_tpu.models.ctc import ctc_loss as j_ctc_loss
from nnacousticmodeling_tpu.models.ctc import greedy_decode as j_greedy
from nnacousticmodeling_tpu.models.ctc import (
    make_ctc_train_step as j_make_step,
)
from nnacousticmodeling_tpu.train.checkpoint import _path_str
from nnacousticmodeling_tpu.train.optimizers import (
    make_optimizer as j_make_optimizer,
)
from nnacousticmodeling_tpu_torch.models import get_network
from nnacousticmodeling_tpu_torch.models.ctc import (
    BiRNNCTC, _reverse_within_length, ctc_loss, greedy_decode,
    make_ctc_train_step,
)
from nnacousticmodeling_tpu_torch.train import load_jax_params, make_optimizer

D, H, PHONES = 6, 12, 5


def _pair(network, seed=0):
    jm = JBiRNNCTC(base=j_get_network(network, 2, [H], 1), num_phones=PHONES)
    params = jm.init(jax.random.PRNGKey(seed), D)
    pm = BiRNNCTC(get_network(network, 2, [H], 1, in_dim=D, device="cpu"),
                  PHONES)
    pm.load_state_dict(load_jax_params(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return jm, params, pm


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((3, 17, D)).astype(np.float32)
    x_lens = np.array([17, 11, 6], np.int32)
    labels = np.array([[1, 2, 3, 4, 2], [5, 1, 0, 0, 0], [3, 3, 0, 0, 0]],
                      np.int32)
    y_lens = np.array([5, 2, 2], np.int32)
    return xs, x_lens, labels, y_lens


def test_state_dict_names_are_the_jax_paths():
    jm, params, pm = _pair("lstm")
    paths = {_path_str(p).replace("/", ".") for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(pm.state_dict()) == paths


@pytest.mark.parametrize("network", ["lstm", "gru"])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_logits_match_jax(network, with_lengths):
    jm, params, pm = _pair(network)
    xs, x_lens, _, _ = _batch()
    lens = x_lens if with_lengths else None
    want = np.asarray(jm.apply_sequence(
        params, jnp.asarray(xs),
        lengths=None if lens is None else jnp.asarray(lens)))
    with torch.no_grad():
        got = pm.apply_sequence(torch.from_numpy(xs), lengths=lens).numpy()
    assert got.shape == (3, 17, PHONES + 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_reverse_within_length():
    x = torch.arange(2 * 5, dtype=torch.float32).reshape(2, 5, 1)
    got = _reverse_within_length(x, [5, 3])[..., 0].tolist()
    assert got == [[4, 3, 2, 1, 0], [7, 6, 5, 8, 9]]


def test_padding_invariance():
    _, _, pm = _pair("gru")
    x = np.random.default_rng(4).standard_normal((1, 9, D)).astype(
        np.float32)
    padded = np.zeros((1, 20, D), np.float32)
    padded[:, :9] = x
    with torch.no_grad():
        alone = pm.apply_sequence(torch.from_numpy(x), lengths=[9])
        in_batch = pm.apply_sequence(torch.from_numpy(padded), lengths=[9])
    np.testing.assert_allclose(alone[0].numpy(), in_batch[0, :9].numpy(),
                               atol=1e-5)


def test_ctc_loss_matches_optax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 17, PHONES + 1)).astype(np.float32)
    _, x_lens, labels, y_lens = _batch()
    want = float(j_ctc_loss(jnp.asarray(logits), jnp.asarray(x_lens),
                            jnp.asarray(labels), jnp.asarray(y_lens)))
    got = float(ctc_loss(torch.from_numpy(logits), x_lens, labels, y_lens))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_greedy_decode_matches_jax():
    logits = np.eye(4)[[1, 1, 0, 1, 2, 2, 0, 0, 3]][None] * 10.0
    assert greedy_decode(torch.from_numpy(logits), [9]) == [[1, 1, 2, 3]]
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 12, PHONES + 1)).astype(np.float32)
    lens = [12, 7, 1, 0]
    assert (greedy_decode(torch.from_numpy(logits), lens)
            == j_greedy(jnp.asarray(logits), lens))


def test_train_steps_match_jax():
    jm, params, pm = _pair("lstm")
    xs, x_lens, labels, y_lens = _batch()
    opt = j_make_optimizer("adam", 1e-3)
    opt_state = opt.init(params)
    j_step = j_make_step(jm, opt)
    step = make_ctc_train_step(pm, make_optimizer("adam", 1e-3,
                                                  pm.parameters()))
    for _ in range(3):
        params, opt_state, j_loss = j_step(
            params, opt_state, jnp.asarray(xs), jnp.asarray(x_lens),
            jnp.asarray(labels), jnp.asarray(y_lens), None)
        loss = step(torch.from_numpy(xs), x_lens, labels, y_lens)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    got = pm.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = _path_str(path).replace("/", ".")
        np.testing.assert_allclose(got[key].numpy(), np.asarray(leaf),
                                   atol=1e-4, rtol=0, err_msg=key)


def test_infeasible_alignment_values():
    """Four labels (one repeat, so five frames needed) on three frames:
    optax clamps at its log_epsilon and returns a large finite loss; the
    port runs optax's recursion and returns the same value."""
    logits = np.random.default_rng(0).standard_normal((1, 3, 6)).astype(
        np.float32)
    labels = np.array([[1, 1, 2, 3]], np.int32)
    want = float(j_ctc_loss(jnp.asarray(logits), jnp.asarray([3]),
                            jnp.asarray(labels), jnp.asarray([4])))
    got = float(ctc_loss(torch.from_numpy(logits), [3], labels, [4]))
    assert np.isfinite(want) and want > 1e4
    np.testing.assert_allclose(got, want, rtol=1e-5)
