"""The port's training engine against the JAX package's.

Both engines start from one ``save_pytree`` init (carried into the port
with ``load_jax_params``), dropout 0 and the same seed, so they draw the
same minibatches from the shared numpy shuffle. Tolerances and the
maxima observed (CPU, 2-layer x 16-unit LSTM, momentumsgd then adam,
bprop 5, batch 4, 4 epochs):

- ``scan_impl="xla"`` (float32 step loop vs ``lax.scan``): history
  losses rtol 1e-5 (observed 3.8e-7), final params atol 1e-5 (5.1e-7);
- ``scan_impl="pallas"`` (the kernels' plain versions vs the Pallas
  kernels in interpret mode): both round the recurrent operands and the
  residuals to bf16, and a sum taken in another order can land on the
  other side of a bf16 rounding, so: losses rtol 1e-4 (observed 3.8e-5),
  params atol 5e-3 (observed 2.0e-3: adam's normalised steps make
  parameters with near-zero gradients move by up to lr = 1e-3 apart);
- ``compute_dtype="bfloat16"`` (pallas route): losses rtol 1e-3
  (observed 1.9e-4), params atol 1e-2 (observed 2.6e-3).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnacousticmodeling_tpu.decoder import make_synthetic_image
from nnacousticmodeling_tpu.models import get_network as j_get_network
from nnacousticmodeling_tpu.ops.timedelay import (
    apply_time_delay as j_apply_time_delay,
)
from nnacousticmodeling_tpu.train import TrainConfig as JTrainConfig
from nnacousticmodeling_tpu.train import TrainStage as JTrainStage
from nnacousticmodeling_tpu.train import build_stages as j_build_stages
from nnacousticmodeling_tpu.train import make_optimizer as j_make_optimizer
from nnacousticmodeling_tpu.train import (
    sentence_shuffle_indices as j_sentence_shuffle_indices,
)
from nnacousticmodeling_tpu.train import (
    stream_batch_indices as j_stream_batch_indices,
)
from nnacousticmodeling_tpu.train import train_network as j_train_network
from nnacousticmodeling_tpu.train.checkpoint import _path_str
from nnacousticmodeling_tpu.train.checkpoint import save_pytree as j_save
from nnacousticmodeling_tpu.utils.synthetic import make_synthetic_corpus
from nnacousticmodeling_tpu_torch.infer import rnn_log_posteriors
from nnacousticmodeling_tpu_torch.models import HalfPrecisionNet, get_network
from nnacousticmodeling_tpu_torch.models.networks import dropout
from nnacousticmodeling_tpu_torch.ops.timedelay import apply_time_delay
from nnacousticmodeling_tpu_torch.parallel.mesh import Mesh
from nnacousticmodeling_tpu_torch.train import (
    TrainConfig,
    TrainStage,
    build_stages,
    load_jax_params,
    load_pytree,
    make_optimizer,
    save_pytree,
    sentence_shuffle_indices,
    stream_batch_indices,
    train_network,
)

STAGES = [dict(epoch=2, optimizer="momentumsgd", batch_size=4, lr=1e-2,
               early_stopping=False),
          dict(epoch=2, optimizer="adam", batch_size=4, lr=1e-2,
               early_stopping=False)]


@pytest.fixture(scope="module")
def corpus():
    img = make_synthetic_image(num_phones=4, num_states=16, seed=3,
                               tied=False)
    return make_synthetic_corpus(img, dim=10, num_train=8, num_dev=4,
                                 num_test=2, noise=0.4, seed=3)


@pytest.fixture(scope="module")
def init_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("train") / "init.npz"
    params = j_get_network("lstm", 2, [16], 16).init(jax.random.PRNGKey(0),
                                                     10)
    j_save(str(path), params)
    return path


def _jax_run(corpus, init_path, impl, stages=STAGES, **kw):
    jnet = dataclasses.replace(j_get_network("lstm", 2, [16], 16),
                               scan_impl=impl)
    template = jnet.init(jax.random.PRNGKey(1), 10)
    from nnacousticmodeling_tpu.train import load_pytree as j_load
    params = j_load(str(init_path), template)
    cfg = JTrainConfig(stages=[JTrainStage(**s) for s in stages],
                       bprop_len=5, seed=0, log=None, **kw)
    c = corpus
    return j_train_network(jnet, c.train.data, c.train.targets, cfg,
                           offsets=c.train.offsets, x_dev=c.dev.data,
                           y_dev=c.dev.targets, init_params=params)


def _port_run(corpus, init_path, impl, stages=STAGES, dropout_rate=0.0,
              layers=2, **kw):
    net = get_network("lstm", layers, [16], 16, dropout=[dropout_rate],
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


def _assert_same_run(port, jax_res, loss_rtol, param_atol):
    assert len(port.history) == len(jax_res.history)
    for hp, hj in zip(port.history, jax_res.history):
        assert set(hp) == set(hj)
        assert (hp["stage"], hp["epoch"]) == (hj["stage"], hj["epoch"])
        for k in ("main/loss", "validation/main/loss"):
            np.testing.assert_allclose(hp[k], hj[k], rtol=loss_rtol, err_msg=k)
    flat = jax.tree_util.tree_flatten_with_path(jax_res.params)[0]
    assert len(flat) == len(port.params)
    for path, leaf in flat:
        key = _path_str(path).replace("/", ".")
        assert port.params[key].dtype == torch.float32
        np.testing.assert_allclose(port.params[key].numpy(),
                                   np.asarray(leaf), atol=param_atol,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("impl,dtype,loss_rtol,param_atol", [
    ("xla", "float32", 1e-5, 1e-5),
    ("pallas", "float32", 1e-4, 5e-3),
    ("pallas", "bfloat16", 1e-3, 1e-2),
], ids=["xla", "pallas", "pallas_bf16"])
def test_engine_matches_jax(corpus, init_path, impl, dtype, loss_rtol,
                            param_atol):
    want = _jax_run(corpus, init_path, impl, compute_dtype=dtype)
    got = _port_run(corpus, init_path, impl, compute_dtype=dtype)
    _assert_same_run(got, want, loss_rtol, param_atol)
    assert got.history[-1]["main/loss"] < got.history[0]["main/loss"]


def _port_run_capturing(corpus, init_path, stages):
    """A port run that records the network's params after every epoch."""
    seen = {}
    net = get_network("lstm", 2, [16], 16, in_dim=10, scan_impl="xla",
                      device="cpu")

    def hook(stage, epoch):
        seen[(stage, epoch)] = {k: v.clone()
                                for k, v in net.state_dict().items()}

    cfg = TrainConfig(stages=[TrainStage(**s) for s in stages], bprop_len=5,
                      seed=0, log=None, epoch_hook=hook)
    c = corpus
    got = train_network(net, c.train.data, c.train.targets, cfg,
                        offsets=c.train.offsets, x_dev=c.dev.data,
                        y_dev=c.dev.targets,
                        init_params=load_jax_params(init_path, device="cpu"),
                        device="cpu")
    return got, seen


def test_early_stopping_fires_at_jax_epoch_and_keeps_last(corpus,
                                                          init_path):
    """A large lr makes the validation loss climb: the stage stops at the
    JAX engine's epoch and keeps its last model."""
    stages = [dict(epoch=10, optimizer="momentumsgd", batch_size=4, lr=1.0,
                   early_stopping=True)]
    want = _jax_run(corpus, init_path, "xla", stages=stages)
    got, seen = _port_run_capturing(corpus, init_path, stages)
    assert len(got.history) < 10
    assert [h["epoch"] for h in got.history] == \
        [h["epoch"] for h in want.history]
    last = seen[(0, len(got.history))]
    for k, v in got.params.items():
        assert torch.equal(v, last[k])


def test_fixed_epoch_stage_keeps_best_validation_model(corpus, init_path):
    stages = [dict(epoch=4, optimizer="momentumsgd", batch_size=4, lr=1.0,
                   early_stopping=False)]
    got, seen = _port_run_capturing(corpus, init_path, stages)
    best = int(np.argmin([h["validation/main/loss"]
                          for h in got.history])) + 1
    assert best < 4
    for k, v in got.params.items():
        assert torch.equal(v, seen[(0, best)][k])


def _crash_at(stage_epoch):
    class Crash(Exception):
        pass

    def hook(stage, epoch):
        if (stage, epoch) == stage_epoch:
            raise Crash
    return Crash, hook


_MID_STAGE = [dict(epoch=4, optimizer="momentumsgd", batch_size=4, lr=1e-2,
                   early_stopping=False)]


@pytest.mark.parametrize("stages,crash,dtype", [
    (_MID_STAGE, (0, 2), "float32"),
    (STAGES, (0, 2), "float32"),
    (_MID_STAGE, (0, 2), "bfloat16"),
], ids=["mid_stage", "stage_boundary", "mid_stage_bf16"])
def test_resume_replays_uninterrupted_run_exactly(tmp_path, corpus, stages,
                                                  crash, dtype):
    """Counterpart of tests/test_train.py:388: snapshots carry the numpy
    shuffle state, the dropout generator, the optimizer state, the
    stream state (bf16 under bf16 compute) and the best-model tracking,
    so a run killed after an epoch and resumed makes exactly the
    uninterrupted run's remaining epochs and final params (dropout 0.2
    on, pallas route)."""
    def run(snap, resume, hook=None):
        return _port_run(corpus, None, "pallas", stages=stages,
                         dropout_rate=0.2, layers=1, snapshot_path=snap,
                         resume_snapshot=resume, epoch_hook=hook,
                         compute_dtype=dtype)

    ref = run(str(tmp_path / "ref.npz"), False)
    crash_exc, hook = _crash_at(crash)
    snap = str(tmp_path / "snap.npz")
    with pytest.raises(crash_exc):
        run(snap, False, hook)
    res = run(snap, True)
    done = len(ref.history) - len(res.history)
    assert done == crash[1]
    for h_res, h_ref in zip(res.history, ref.history[done:]):
        assert (h_res["stage"], h_res["epoch"]) == (h_ref["stage"],
                                                    h_ref["epoch"])
        assert h_res["main/loss"] == h_ref["main/loss"]
        assert h_res["validation/main/loss"] == h_ref["validation/main/loss"]
    for k in ref.params:
        assert torch.equal(res.params[k], ref.params[k]), k


def test_truncated_snapshot_is_skipped(tmp_path, corpus):
    stages = [dict(epoch=2, optimizer="momentumsgd", batch_size=4, lr=1e-2,
                   early_stopping=False)]
    snap = str(tmp_path / "snapshot.npz")
    _port_run(corpus, None, "xla", stages=stages, layers=1,
              snapshot_path=snap)
    assert not (tmp_path / "snapshot.npz.tmp").exists()
    data = (tmp_path / "snapshot.npz").read_bytes()
    (tmp_path / "snapshot.npz").write_bytes(data[: len(data) // 2])
    with pytest.warns(UserWarning, match="unreadable"):
        res = _port_run(corpus, None, "xla", stages=stages, layers=1,
                        snapshot_path=snap, resume_snapshot=True)
    assert len(res.history) == 2
    assert all(np.isfinite(h["main/loss"]) for h in res.history)


def test_defer_metrics_and_dispatch_modes_same_history(corpus):
    stages = [dict(epoch=2, optimizer="adam", batch_size=4, lr=1e-3,
                   early_stopping=False)]
    base = _port_run(corpus, None, "xla", stages=stages, layers=1)
    for kw in (dict(defer_metrics=True), dict(dispatch="scan"),
               dict(dispatch="per_step")):
        other = _port_run(corpus, None, "xla", stages=stages, layers=1, **kw)
        for ha, hb in zip(base.history, other.history):
            assert isinstance(hb["main/loss"], float)
            assert ha["main/loss"] == hb["main/loss"]
            assert ha["validation/main/loss"] == hb["validation/main/loss"]


@pytest.mark.parametrize("kw,exc,match", [
    (dict(compute_dtype="float16"), ValueError, "unsupported compute dtype"),
    (dict(dispatch="graph"), ValueError, "dispatch"),
    (dict(mesh=Mesh({"data": 3})), ValueError, "not divisible"),
    (dict(mesh=Mesh({"model": 1})), ValueError, "has no 'data' axis"),
])
def test_config_errors(corpus, kw, exc, match):
    """Bad configs raise before any update; a mesh (here one that needs
    no process group to be checked) whose data axis does not divide the
    batch, or that has none, as JAX ``_mesh_place`` does."""
    with pytest.raises(exc, match=match):
        _port_run(corpus, None, "xla", stages=STAGES[:1], layers=1, **kw)


# ---- numpy copies, optimizers, dropout, checkpoint ------------------------

def test_stages_equal_jax():
    args = ([20], ["adam", "momentumsgd"], [512, 128],
            [1e-2, 1e-3, 1e-4, 1e-5], [True])
    assert [dataclasses.asdict(s) for s in build_stages(*args)] == \
        [dataclasses.asdict(s) for s in j_build_stages(*args)]


def test_streams_and_timedelay_equal_jax():
    offsets = np.array([0, 3, 8, 10, 17, 30])
    a = sentence_shuffle_indices(offsets, 30, np.random.default_rng(4))
    b = j_sentence_shuffle_indices(offsets, 30, np.random.default_rng(4))
    np.testing.assert_array_equal(a, b)
    for start in (0, 3, 29):
        np.testing.assert_array_equal(stream_batch_indices(a, 4, start, 5),
                                      j_stream_batch_indices(b, 4, start, 5))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((30, 3)).astype(np.float32)
    y = rng.integers(0, 5, 30).astype(np.int32)
    for k in (0, 2, -1):
        for got, want in zip(apply_time_delay(x, y, offsets, k),
                             j_apply_time_delay(x, y, offsets, k)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["sgd", "momentumsgd", "adam"])
def test_optimizer_steps_equal_optax(name):
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(3)]
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(name, 0.05, [p])
    jopt = j_make_optimizer(name, 0.05)
    jp = jnp.asarray(p0)
    state = jopt.init(jp)
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
        upd, state = jopt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        make_optimizer("rmsprop", 0.1, [p])


def test_dropout_scaling_and_identity():
    x = torch.ones(4000)
    gen = torch.Generator().manual_seed(0)
    assert dropout(x, 0.25, False, gen) is x
    assert dropout(x, 0.0, True, gen) is x
    assert dropout(x, 0.25, True, None) is x
    y = dropout(x, 0.25, True, gen)
    kept = y != 0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert 0.2 < 1 - kept.float().mean().item() < 0.3
    again = dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    net = get_network("lstm", 1, [8], 5, dropout=[0.5], in_dim=3,
                      device="cpu")
    xs = torch.randn(2, 4, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        eval_a, _ = net.apply_sequence(xs)
        eval_b, _ = net.apply_sequence(xs, train=True)     # no generator
        train, _ = net.apply_sequence(
            xs, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(eval_a, eval_b)
    assert not torch.equal(eval_a, train)


def test_save_pytree_round_trips_with_jax(tmp_path, init_path):
    from nnacousticmodeling_tpu.train import load_pytree as j_load
    net = get_network("lstm", 2, [16], 16, in_dim=10, device="cpu", seed=7)
    save_pytree(tmp_path / "model", net)
    template = j_get_network("lstm", 2, [16], 16).init(
        jax.random.PRNGKey(0), 10)
    loaded = j_load(str(tmp_path / "model.npz"), template)
    flat = jax.tree_util.tree_flatten_with_path(loaded)[0]
    state = net.state_dict()
    assert len(flat) == len(state)
    for path, leaf in flat:
        np.testing.assert_array_equal(
            np.asarray(leaf), state[_path_str(path).replace("/", ".")])
    back = load_pytree(tmp_path / "model.npz", net)
    assert all(torch.equal(back[k], state[k]) for k in state)
    with pytest.raises(ValueError, match="shape"):
        load_pytree(tmp_path / "model.npz",
                    get_network("lstm", 2, [8], 16, in_dim=10, device="cpu"))
    assert json.dumps(sorted(np.load(tmp_path / "model.npz").files)) == \
        json.dumps(sorted(np.load(init_path).files))


def test_half_precision_net_posteriors_match_jax(tmp_path):
    """The bf16 serving forward (``models/precision.py``) on the kernel
    route equals the JAX ``HalfPrecisionNet`` posteriors within 1e-5
    (observed 2.4e-7) and is really bf16: 2e-3 away from float32."""
    from nnacousticmodeling_tpu.infer.posteriors import (
        rnn_log_posteriors as j_rnn_log_posteriors)
    from nnacousticmodeling_tpu.models.precision import (
        HalfPrecisionNet as JHalfPrecisionNet)
    jnet = dataclasses.replace(j_get_network("lstm", 2, [32], 11),
                               scan_impl="pallas")
    params = jnet.init(jax.random.PRNGKey(3), 8)
    j_save(str(tmp_path / "m.npz"), params)
    rng = np.random.default_rng(9)
    offsets = np.concatenate([[0], np.cumsum([7, 12, 3, 9, 10])])
    x = rng.standard_normal((offsets[-1], 8)).astype(np.float32)
    jh = JHalfPrecisionNet(jnet)
    want = j_rnn_log_posteriors(jh, jh.cast(params), x, offsets, batch=4,
                                bucket_sizes=[8, 16])
    net = get_network("lstm", 2, [32], 11, in_dim=8, scan_impl="pallas",
                      device="cpu")
    net.load_state_dict(load_jax_params(tmp_path / "m.npz", device="cpu"))
    kw = dict(batch=4, bucket_sizes=[8, 16])
    got = rnn_log_posteriors(HalfPrecisionNet(net), x, offsets, **kw)
    f32 = rnn_log_posteriors(net, x, offsets, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - f32).max() > 1e-4
