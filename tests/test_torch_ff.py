"""The port's feed-forward nets, their posteriors, the engine's
feed-forward stage and the training CLI for ``-n ff`` / ``-n tdnn``,
against the JAX package on the same inputs and ``.npz`` weights.

Tolerances (CPU, the maxima observed in brackets):

- MLP / TDNN forward, float32: atol 1e-5 [3.6e-7];
- the bf16 route (``HalfPrecisionNet.apply`` against JAX
  ``HalfPrecisionNet.apply`` on ``cast_params``): both round every
  product's operands to bf16, and a value may round to the neighbouring
  bf16 (2**-8 relative) after sums in another order and carry that into
  the next layer: atol 3e-2 [the MLP 0.0; the TDNN 8.4e-3, whose JAX
  conv returns float32 where ``F.conv1d`` rounds to bf16], and at least
  1e-3 away from the float32 forward (it really is bf16). The TDNN case
  has one conv layer: with two, the JAX bf16 route raises on the second
  conv's mixed operand dtypes;
- ``ff_log_posteriors``: atol 1e-5 [9.5e-7];
- the FF stage on an MLP 2x64 (dropout 0, one ``save_pytree`` init, one
  seed, so both draw the same minibatches): float32 losses rtol 1e-4
  [2.2e-5, adam; the other optimizers 4.7e-7] and final params atol
  1e-3 [1.9e-4, adam: its normalised steps move a parameter whose
  gradient is near zero by up to lr = 1e-3 on a rounding difference; the
  other optimizers 1.8e-7]; bf16 losses rtol 1e-2 [3.8e-3], params atol
  1e-2 [5.9e-3];
- models trained by the port and decoded by both packages: identical
  MLF text.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu.decoder.image import (
    make_synthetic_image,
    save_image,
)
from nnacousticmodeling_tpu.infer import ff_log_posteriors as j_ff_lp
from nnacousticmodeling_tpu.models import TDNN as JTDNN
from nnacousticmodeling_tpu.models import get_network as j_get_network
from nnacousticmodeling_tpu.models.precision import (
    HalfPrecisionNet as JHalfPrecisionNet,
)
from nnacousticmodeling_tpu.pipeline import evaluate as j_evaluate
from nnacousticmodeling_tpu.train import TrainConfig as JTrainConfig
from nnacousticmodeling_tpu.train import TrainStage as JTrainStage
from nnacousticmodeling_tpu.train import load_pytree as j_load_pytree
from nnacousticmodeling_tpu.train import train_network as j_train_network
from nnacousticmodeling_tpu.train.checkpoint import _path_str
from nnacousticmodeling_tpu.train.checkpoint import save_pytree as j_save
from nnacousticmodeling_tpu.utils.synthetic import (
    make_synthetic_corpus,
    write_corpus_tree,
)
from nnacousticmodeling_tpu_torch.infer import ff_log_posteriors
from nnacousticmodeling_tpu_torch.models import (
    MLP,
    TDNN,
    HalfPrecisionNet,
    get_network,
)
from nnacousticmodeling_tpu_torch.pipeline import evaluate, train_cli
from nnacousticmodeling_tpu_torch.train import (
    TrainConfig,
    TrainStage,
    load_jax_params,
    train_network,
)

F32_ATOL = 1e-5
BF16_ATOL = 3e-2


def _shared(jnet, in_dim, tmp_path, seed=1):
    """JAX params of ``jnet`` and the same weights in the port's keys."""
    params = jnet.init(jax.random.PRNGKey(seed), in_dim)
    j_save(str(tmp_path / "w.npz"), params)
    return params, load_jax_params(tmp_path / "w.npz", device="cpu")


def _x(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


# ---- the nets -------------------------------------------------------------

@pytest.mark.parametrize("layers", [0, 1, 3])
@pytest.mark.parametrize("activation", ["relu", "sigmoid", "tanh"])
def test_mlp_matches_jax(tmp_path, activation, layers):
    jnet = j_get_network("ff", layers, [24], 7, activation)
    params, state = _shared(jnet, 30, tmp_path)
    net = get_network("ff", layers, [24], 7, activation, in_dim=30,
                      device="cpu")
    assert isinstance(net, MLP) and not net.is_recurrent
    net.load_state_dict(state)
    x = _x(13, 30)
    with torch.no_grad():
        got = net.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.apply(params, x)),
                               atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("chainer_layout", [False, True])
@pytest.mark.parametrize("ksize,feat", [((3, 3), 6), ((5, 5, 9, 9), 4)])
def test_tdnn_matches_jax(tmp_path, ksize, feat, chainer_layout):
    units = tuple(12 + 2 * i for i in range(len(ksize)))
    jnet = JTDNN(units=units, num_classes=7, ksize=ksize,
                 chainer_layout=chainer_layout)
    in_dim = jnet.input_win_size * feat
    params, state = _shared(jnet, in_dim, tmp_path)
    net = TDNN(units, 7, ksize, chainer_layout=chainer_layout,
               in_dim=in_dim, device="cpu")
    assert net.input_win_size == jnet.input_win_size
    net.load_state_dict(state)
    assert tuple(net.conv[0].w.shape) == (ksize[0], feat, units[0])
    x = _x(9, in_dim)
    with torch.no_grad():
        got = net.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.apply(params, x)),
                               atol=F32_ATOL, rtol=0)


def test_tdnn_layouts_differ_and_bad_input_raises():
    a = TDNN((8, 8), 5, (3, 3), in_dim=20, device="cpu", seed=3)
    b = TDNN((8, 8), 5, (3, 3), chainer_layout=True, in_dim=20, device="cpu",
             seed=3)
    x = torch.from_numpy(_x(4, 20))
    with torch.no_grad():
        assert not torch.allclose(a.apply(x), b.apply(x))
    with pytest.raises(ValueError, match="not divisible"):
        TDNN((8,), 5, (3,), in_dim=10, device="cpu")
    with pytest.raises(ValueError, match="same length"):
        TDNN((8, 8), 5, (3,), in_dim=9, device="cpu")


def test_get_network_argument_mapping():
    """``get_network("ff"/"tdnn")`` maps its arguments as the JAX
    factory does (networks.py:543-550)."""
    for args in [("ff", 3, [48, 7], 11, "tanh", (5,), [0.3, 0.1]),
                 ("tdnn", 9, [16, 24], 11, "sigmoid", (3, 5), [0.2])]:
        want = j_get_network(*args)
        got = get_network(*args, in_dim=7 * 6, device="cpu")
        assert type(got).__name__ == type(want).__name__
        for field in dataclasses.fields(want):
            if field.name in ("is_recurrent", "chainer_layout"):
                continue
            assert getattr(got, field.name) == getattr(want, field.name), \
                field.name
        assert not got.is_recurrent and not got.chainer_layout \
            if args[0] == "tdnn" else not got.is_recurrent


@pytest.mark.parametrize("kind", ["ff", "tdnn"])
def test_bf16_route_matches_jax_cast_params(tmp_path, kind):
    if kind == "ff":
        jnet, in_dim = j_get_network("ff", 3, [64], 9), 40
        net = get_network("ff", 3, [64], 9, in_dim=in_dim, device="cpu")
    else:
        # one conv layer: the JAX TDNN's conv returns float32
        # (preferred_element_type), so a second bf16 conv there raises
        # on its mixed operand dtypes
        jnet = j_get_network("tdnn", 0, [32], 9, tdnn_ksize=(5,))
        in_dim = 5 * 8
        net = get_network("tdnn", 0, [32], 9, tdnn_ksize=(5,),
                          in_dim=in_dim, device="cpu")
    params, state = _shared(jnet, in_dim, tmp_path)
    net.load_state_dict(state)
    x = _x(64, in_dim)
    jh = JHalfPrecisionNet(jnet)
    want = np.asarray(jh.apply(jh.cast(params), x))
    with torch.no_grad():
        got = HalfPrecisionNet(net).apply(torch.from_numpy(x))
        f32 = net.apply(torch.from_numpy(x)).numpy()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL, rtol=0)
    assert np.abs(got.numpy() - f32).max() > 1e-3


@pytest.mark.parametrize("kind", ["ff", "tdnn"])
def test_dropout_after_each_activation(kind):
    kw = dict(tdnn_ksize=(3, 3)) if kind == "tdnn" else {}
    net = get_network(kind, 2, [16, 16], 5, dropout=[0.5], in_dim=25,
                      device="cpu", **kw)
    x = torch.from_numpy(_x(8, 25))
    with torch.no_grad():
        ev = net.apply(x)
        assert torch.equal(ev, net.apply(x, train=True))   # no generator
        a = net.apply(x, train=True,
                      generator=torch.Generator().manual_seed(0))
        b = net.apply(x, train=True,
                      generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, ev)


# ---- posteriors -----------------------------------------------------------

@pytest.mark.parametrize("n,chunk", [(150, 64), (8200, 8192), (37, 8192)])
@pytest.mark.parametrize("with_ap", [False, True])
def test_ff_log_posteriors_match_jax(tmp_path, n, chunk, with_ap):
    jnet = j_get_network("ff", 2, [32], 11)
    params, state = _shared(jnet, 20, tmp_path)
    net = get_network("ff", 2, [32], 11, in_dim=20, device="cpu")
    net.load_state_dict(state)
    x = _x(n, 20, seed=n)
    ap = (np.log(np.random.default_rng(2).dirichlet(np.ones(11)))[None]
          .astype(np.float32) if with_ap else None)
    got = ff_log_posteriors(net, x, ap=ap, chunk=chunk)
    want = j_ff_lp(jnet, params, x, ap=ap, chunk=chunk)
    assert got.shape == (n, 11) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


# ---- the FF stage ---------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    img = make_synthetic_image(num_phones=4, num_states=16, seed=3,
                               tied=False)
    return make_synthetic_corpus(img, dim=10, num_train=8, num_dev=4,
                                 num_test=2, noise=0.4, seed=3)


@pytest.fixture(scope="module")
def ff_init(tmp_path_factory):
    path = tmp_path_factory.mktemp("ff_stage") / "init.npz"
    j_save(str(path), j_get_network("ff", 2, [64], 16).init(
        jax.random.PRNGKey(0), 10))
    return path


def _runs(corpus, init_path, stages, **kw):
    jnet = j_get_network("ff", 2, [64], 16)
    template = jnet.init(jax.random.PRNGKey(1), 10)
    c = corpus
    want = j_train_network(
        jnet, c.train.data, c.train.targets,
        JTrainConfig(stages=[JTrainStage(**s) for s in stages], seed=0,
                     log=None, **kw),
        offsets=c.train.offsets, x_dev=c.dev.data, y_dev=c.dev.targets,
        init_params=j_load_pytree(str(init_path), template))
    net = get_network("ff", 2, [64], 16, in_dim=10, device="cpu")
    got = train_network(
        net, c.train.data, c.train.targets,
        TrainConfig(stages=[TrainStage(**s) for s in stages], seed=0,
                    log=None, **kw),
        offsets=c.train.offsets, x_dev=c.dev.data, y_dev=c.dev.targets,
        init_params=load_jax_params(init_path, device="cpu"), device="cpu")
    return got, want


def _assert_same_run(got, want, loss_rtol, param_atol, of_max=False):
    """History entries and final params as the JAX run's; with
    ``of_max`` each param tensor within ``param_atol`` of its largest
    value."""
    assert [(h["stage"], h["epoch"]) for h in got.history] == \
        [(h["stage"], h["epoch"]) for h in want.history]
    for hp, hj in zip(got.history, want.history):
        assert set(hp) == set(hj)
        for k in ("main/loss", "validation/main/loss", "main/accuracy"):
            np.testing.assert_allclose(hp[k], hj[k], rtol=loss_rtol,
                                       atol=loss_rtol if "acc" in k else 0,
                                       err_msg=k)
    flat = jax.tree_util.tree_flatten_with_path(want.params)[0]
    assert len(flat) == len(got.params)
    for path, leaf in flat:
        key = _path_str(path).replace("/", ".")
        leaf = np.asarray(leaf)
        atol = param_atol * (np.abs(leaf).max() if of_max else 1.0)
        np.testing.assert_allclose(got.params[key].numpy(), leaf, atol=atol,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("dtype,loss_rtol,param_atol", [
    ("float32", 1e-4, 1e-3), ("bfloat16", 1e-2, 1e-2)], ids=["f32", "bf16"])
@pytest.mark.parametrize("shuffle_sequences", [False, True],
                         ids=["perm", "streams"])
@pytest.mark.parametrize("optimizer,lr", [("sgd", 0.1),
                                          ("momentumsgd", 1e-2),
                                          ("adam", 1e-3)])
def test_ff_stage_matches_jax(corpus, ff_init, optimizer, lr,
                              shuffle_sequences, dtype, loss_rtol,
                              param_atol):
    """Two fixed-epoch stages (batch 32, then 16 with the final partial
    batch dropped) and an early-stopping stage: per-epoch train and
    validation losses and the final params as the JAX engine's."""
    stages = [dict(epoch=2, optimizer=optimizer, batch_size=32, lr=lr,
                   early_stopping=False),
              dict(epoch=1, optimizer=optimizer, batch_size=50, lr=lr,
                   early_stopping=False),
              dict(epoch=2, optimizer=optimizer, batch_size=16, lr=lr,
                   early_stopping=True)]
    got, want = _runs(corpus, ff_init, stages, compute_dtype=dtype,
                      shuffle_sequences=shuffle_sequences)
    _assert_same_run(got, want, loss_rtol, param_atol)
    assert got.history[-1]["main/loss"] < got.history[0]["main/loss"]


def test_ff_early_stopping_fires_at_jax_epoch(corpus, ff_init):
    stages = [dict(epoch=8, optimizer="momentumsgd", batch_size=16, lr=1.0,
                   early_stopping=True)]
    got, want = _runs(corpus, ff_init, stages)
    assert len(got.history) < 8
    # lr 1 drives the weights to ~1e3, where float32 sums in another
    # order differ by ~1e-4 of a value and the steps carry that on:
    # losses rtol 1e-3, params within 1e-4 of their largest value
    # (observed 9.1e-6 and 2.7e-5)
    _assert_same_run(got, want, 1e-3, 1e-4, of_max=True)


def test_ff_eval_chunks_and_no_validation(corpus, ff_init):
    """A validation chunk smaller than the dev set sums to the same
    loss; without a dev set the history has no validation keys."""
    stages = [dict(epoch=1, optimizer="adam", batch_size=64, lr=1e-3,
                   early_stopping=False)]
    got, want = _runs(corpus, ff_init, stages, eval_chunk=100)
    _assert_same_run(got, want, 1e-5, 1e-4)
    net = get_network("ff", 2, [64], 16, in_dim=10, device="cpu")
    res = train_network(net, corpus.train.data, corpus.train.targets,
                        TrainConfig(stages=[TrainStage(**stages[0])],
                                    log=None), device="cpu")
    assert "validation/main/loss" not in res.history[0]


def test_ff_resume_replays_uninterrupted_run(tmp_path, corpus):
    """Snapshots of an FF run (dropout 0.3 on) carry the numpy shuffle
    state and the dropout generator: a run stopped after an epoch and
    resumed makes the uninterrupted run's remaining epochs exactly."""
    stages = [TrainStage(3, "momentumsgd", 32, 1e-2, False)]

    def run(snap, resume, hook=None):
        net = get_network("ff", 2, [32], 16, dropout=[0.3], in_dim=10,
                          device="cpu", seed=4)
        return train_network(net, corpus.train.data, corpus.train.targets,
                             TrainConfig(stages=stages, log=None,
                                         snapshot_path=snap,
                                         resume_snapshot=resume,
                                         epoch_hook=hook),
                             x_dev=corpus.dev.data, y_dev=corpus.dev.targets,
                             device="cpu")

    class Crash(Exception):
        pass

    def hook(stage, epoch):
        if epoch == 1:
            raise Crash

    ref = run(str(tmp_path / "ref.npz"), False)
    with pytest.raises(Crash):
        run(str(tmp_path / "snap.npz"), False, hook)
    res = run(str(tmp_path / "snap.npz"), True)
    assert [h["epoch"] for h in res.history] == [2, 3]
    for a, b in zip(res.history, ref.history[1:]):
        assert a["main/loss"] == b["main/loss"]
    for k in ref.params:
        assert torch.equal(res.params[k], ref.params[k]), k


# ---- the training CLI ------------------------------------------------------

NUM_CLASSES = 17          # make_synthetic_image(num_phones=5): 3*5 + 2 pdfs
DIM = 8


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ff_cli")
    img = make_synthetic_image(num_phones=5, seed=1,
                               pdf_tied_transitions=True)
    corpus = make_synthetic_corpus(img, dim=DIM, num_train=12, num_dev=3,
                                   num_test=4, noise=0.5, seed=1,
                                   max_phones=4)
    write_corpus_tree(corpus, str(root))
    save_image(str(root / "recog" / "kaldiTri1909.img"), img)
    np.save(root / "recog" / "log_ap_Kaldi1909.npy", corpus.log_priors)
    return root


NETS = {"ff": ["-n", "ff", "-l", "2", "-u", "32", "--splice", "2"],
        "tdnn": ["-n", "tdnn", "--tdnn-ksize", "3", "3", "-u", "16", "24",
                 "-a", "sigmoid"]}


def _cli_args(root, spec):
    return NETS[spec] + [
        "--num-classes", str(NUM_CLASSES), "-b", "64", "-o", "adam",
        "momentumsgd", "--lr", "0.01", "-e", "2", "--early-stopping",
        "false", "--noplot", "--data-dir", f"{root}/data",
        "--offset-dir", f"{root}/data", "--target-dir", f"{root}/data"]


@pytest.mark.parametrize("spec", sorted(NETS))
def test_train_cli_model_reads_in_jax_and_decodes_identically(tree,
                                                              tmp_path,
                                                              spec):
    out = tmp_path / "port"
    result = train_cli.main(_cli_args(tree, spec)
                            + ["--out", str(out), "--device", "cpu"])
    log = json.loads((out / "log.json").read_text())
    assert [(h["stage"], h["epoch"]) for h in log] == \
        [(0, 1), (0, 2), (1, 1), (1, 2)]
    assert all(np.isfinite(h["main/loss"]) for h in log)
    splice = 2 if spec == "ff" else 2
    jnet = j_get_network(*(("ff", 2, [32]) if spec == "ff" else
                           ("tdnn", 2, [16, 24])), NUM_CLASSES,
                         "relu" if spec == "ff" else "sigmoid", (3, 3))
    params = j_load_pytree(str(out / "model.npz"),
                           jnet.init(jax.random.PRNGKey(0),
                                     DIM * (2 * splice + 1)))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(result.params)
    for path, leaf in flat:
        np.testing.assert_array_equal(
            np.asarray(leaf),
            result.params[_path_str(path).replace("/", ".")].numpy())
    ev = NETS[spec] + ["--num-classes", str(NUM_CLASSES),
                       "--model", f"{out}/model",
                       "--data-dir", f"{tree}/data",
                       "--offset-dir", f"{tree}/data",
                       "--utt-list-dir", f"{tree}/data",
                       "--recog-dir", f"{tree}/recog", "--PIP", "5",
                       "--test-or-dev", "test"]
    per_j = j_evaluate.main(ev + ["--out-mlf", tmp_path / "j.mlf"])
    per_t = evaluate.main(ev + ["--device", "cpu",
                                "--out-mlf", tmp_path / "t.mlf"])
    text = (tmp_path / "j.mlf").read_text()
    assert text.count('"*/') == 4
    assert (tmp_path / "t.mlf").read_text() == text
    assert per_t == per_j


def test_train_cli_ff_fold_and_shuffle_sequences(tree, tmp_path):
    """``--train-fold`` on an FF net trains on the other folds' frames
    and copies the model; ``--shuffle-sequences`` reads the offsets."""
    folds = tmp_path / "folds"
    folds.mkdir()
    x = np.load(tree / "data" / "data_train.npy")
    y = np.load(tree / "data" / "targets_train.npy")
    off = np.load(tree / "data" / "offsets_train.npy")
    half = len(off) // 2
    for k, (a, b) in enumerate([(0, half), (half, len(off) - 1)]):
        np.save(folds / f"data_{k}.npy", x[off[a]:off[b]])
        np.save(folds / f"targets_{k}.npy", y[off[a]:off[b]])
    args = _cli_args(tree, "ff") + [
        "--device", "cpu", "-e", "1", "--train-fold", "0",
        "--fold-data-dir", str(folds), "--fold-model-dir",
        str(tmp_path / "models"), "--out", str(tmp_path / "fold0")]
    res = train_cli.main(args)
    assert (tmp_path / "models" / "fold_0.npz").is_file()
    assert np.isfinite(res.history[-1]["main/loss"])
    shuffled = train_cli.main(_cli_args(tree, "ff") + [
        "--device", "cpu", "-e", "1", "--shuffle-sequences",
        "--out", str(tmp_path / "ss")])
    assert shuffled.history[0]["main/loss"] != \
        train_cli.main(_cli_args(tree, "ff") + [
            "--device", "cpu", "-e", "1",
            "--out", str(tmp_path / "perm")]).history[0]["main/loss"]
