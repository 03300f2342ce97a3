"""The port's RPL heads, ensembles, ensemble posteriors and the CLIs
around them (``train_cli --train-rpl``, ``evaluate --rpl``,
``predict_folds``), against the JAX package on the same inputs and
``.npz`` weights.

Tolerances (CPU, the maxima observed in brackets):

- RPL0-4 forward, float32: atol 1e-5 [1.9e-6];
- ``Ensemble`` on an MLP, float32: atol 1e-5 [4.8e-7];
- ``Ensemble`` on a 2-layer LSTM, the ``pallas`` route (the kernels'
  plain versions against the Pallas kernels in interpret mode): both
  round the recurrent operands to bf16, and a sum in another order can
  land on the neighbouring bf16 and carry on: atol 1e-4 [4.8e-7];
- ``ensemble_log_posteriors``: as the ensemble it runs [9.5e-7 FF,
  5.0e-6 LSTM];
- an ``apply_fn`` stage: losses rtol 1e-5, params atol 1e-5 [3.1e-7];
- ``train_cli --train-rpl``: RPL4's init is deterministic and both
  engines draw the same minibatches from one seed, so the two
  ``model.npz`` agree within atol 1e-5 [3.7e-8] (adam, lr 1e-3);
- ``predict_folds``: FF atol 1e-5 [9.5e-7]; LSTM (``pallas`` route, the
  zero tail of ``--timedelay``) atol 1e-4 [4.8e-7];
- ``evaluate --rpl``: identical MLF text and PER.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu.decoder.image import (
    make_synthetic_image,
    save_image,
)
from nnacousticmodeling_tpu.infer import (
    ensemble_log_posteriors as j_ensemble_lp,
)
from nnacousticmodeling_tpu.models import Ensemble as JEnsemble
from nnacousticmodeling_tpu.models import get_network as j_get_network
from nnacousticmodeling_tpu.models import get_rpl as j_get_rpl
from nnacousticmodeling_tpu.models import (
    stack_fold_params as j_stack_fold_params,
)
from nnacousticmodeling_tpu.ops.numerics import ref_logsum as j_ref_logsum
from nnacousticmodeling_tpu.pipeline import evaluate as j_evaluate
from nnacousticmodeling_tpu.pipeline import predict_folds as j_predict_folds
from nnacousticmodeling_tpu.pipeline import train_cli as j_train_cli
from nnacousticmodeling_tpu.train import TrainConfig as JTrainConfig
from nnacousticmodeling_tpu.train import TrainStage as JTrainStage
from nnacousticmodeling_tpu.train import train_network as j_train_network
from nnacousticmodeling_tpu.train.checkpoint import save_pytree as j_save
from nnacousticmodeling_tpu.utils.synthetic import (
    make_synthetic_corpus,
    write_corpus_tree,
)
from nnacousticmodeling_tpu_torch.infer import ensemble_log_posteriors
from nnacousticmodeling_tpu_torch.models import (
    RPL3,
    Ensemble,
    get_network,
    get_rpl,
    stack_fold_params,
)
from nnacousticmodeling_tpu_torch.models.rpl import _logaddexp
from nnacousticmodeling_tpu_torch.ops.numerics import REF_INF, ref_logsum
from nnacousticmodeling_tpu_torch.pipeline import (
    evaluate,
    predict_folds,
    train_cli,
)
from nnacousticmodeling_tpu_torch.train import (
    TrainConfig,
    TrainStage,
    load_jax_params,
    train_network,
)

F32_ATOL = 1e-5
LSTM_ATOL = 1e-4
C = 9


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port_params(tree, tmp_path, name="p.npz"):
    j_save(str(tmp_path / name), tree)
    return load_jax_params(tmp_path / name, device="cpu")


# ---- numerics and heads ----------------------------------------------------

def test_ref_logsum_is_the_jax_copy():
    lp = np.log(np.random.default_rng(1).dirichlet(np.ones(6), size=5))
    lp = lp.astype(np.float32)
    lp[2] = np.nan
    np.testing.assert_array_equal(ref_logsum(lp, axis=1),
                                  j_ref_logsum(lp, axis=1))
    assert ref_logsum(lp, axis=1)[2, 0] == -REF_INF == -1e20


def _rpl_params(variant, seed):
    """Random (not init) params of each head, in the JAX pytree."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (0.3 * rng.standard_normal(s)).astype(np.float32)
    if variant == 1:
        return {"l": {"w": r(C, C), "b": r(C)}}
    if variant in (2, 3):
        return {"l": {"w": r(C, C), "b": r(C)}, "lb": r(1, C) - 4.0}
    return {"w": r(1, C), "b": r(1, C), "lb": r(1, C) - 4.0}


@pytest.mark.parametrize("variant", [0, 1, 2, 3, 4])
def test_rpl_forward_matches_jax(tmp_path, variant):
    jrpl = j_get_rpl(variant, C)
    rpl = get_rpl(variant, C, device="cpu")
    assert type(rpl).__name__ == type(jrpl).__name__
    x = _x((17, C)) * 4.0
    if variant == 0:
        assert torch.equal(rpl.apply(torch.from_numpy(x)),
                           torch.from_numpy(x))
        return
    if variant >= 2:
        # deterministic init: zeros, and the log-floor lb = -20
        init = jrpl.init(jax.random.PRNGKey(0))
        for k, v in _port_params(init, tmp_path, "init.npz").items():
            assert torch.equal(rpl.state_dict()[k], v), k
    params = _rpl_params(variant, variant)
    rpl.load_state_dict(_port_params(params, tmp_path))
    with torch.no_grad():
        got = rpl.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jrpl.apply(params, x)),
                               atol=F32_ATOL, rtol=0)
    assert RPL3 is type(get_rpl(2, C, device="cpu"))


def test_logaddexp_keeps_the_reference_op_order():
    h = torch.tensor([-30.0, -20.0, 0.5, 90.0])
    lb = torch.full_like(h, -20.0)
    mx, mn = torch.maximum(h, lb), torch.minimum(h, lb)
    assert torch.equal(_logaddexp(h, lb),
                       mx + torch.log(1.0 + torch.exp(mn - mx)))
    assert float(_logaddexp(h, lb)[1]) == pytest.approx(-20.0 + np.log(2.0))


# ---- ensembles -------------------------------------------------------------

K = 3


def _nets(kind):
    """(JAX net, port net, input dim); LSTM on the pallas route."""
    if kind == "ff":
        return (j_get_network("ff", 2, [16], C),
                get_network("ff", 2, [16], C, in_dim=6, device="cpu"), 6)
    jnet = dataclasses.replace(j_get_network("lstm", 2, [16], C),
                               scan_impl="pallas")
    return jnet, get_network("lstm", 2, [16], C, in_dim=6,
                             scan_impl="pallas", device="cpu"), 6


COMBOS = [(True, False, False), (True, False, True), (True, True, False),
          (True, True, True), (False, True, False), (False, True, True)]
COMBO_IDS = ["master", "master+rpl", "master+folds", "master+folds+rpl",
             "folds", "folds+rpl"]


def _ensembles(kind, tmp_path, master, folds, rpl):
    jnet, net, d = _nets(kind)
    jp = {"master": None, "folds": None, "rpl": None}
    tp = {"master": None, "folds": None, "rpl": None}
    if master:
        jp["master"] = jnet.init(jax.random.PRNGKey(1), d)
        tp["master"] = _port_params(jp["master"], tmp_path, "m.npz")
    if folds:
        fl = [jnet.init(jax.random.PRNGKey(10 + k), d) for k in range(K)]
        jp["folds"] = j_stack_fold_params(fl)
        tp["folds"] = stack_fold_params(
            [_port_params(p, tmp_path, f"f{k}.npz")
             for k, p in enumerate(fl)])
    jrpl = trpl = None
    if rpl:
        jrpl, trpl = j_get_rpl(4, C), get_rpl(4, C, device="cpu")
        jp["rpl"] = _rpl_params(4, 7)
        tp["rpl"] = _port_params(jp["rpl"], tmp_path, "r.npz")
    nf = K if folds else 0
    return (JEnsemble(network=jnet, rpl=jrpl, num_folds=nf), jp,
            Ensemble(network=net, rpl=trpl, num_folds=nf), tp, d)


@pytest.mark.parametrize("master,folds,rpl", COMBOS, ids=COMBO_IDS)
@pytest.mark.parametrize("kind", ["ff", "lstm"])
def test_ensemble_matches_jax(tmp_path, kind, master, folds, rpl):
    jens, jp, ens, tp, d = _ensembles(kind, tmp_path, master, folds, rpl)
    with torch.no_grad():
        if kind == "ff":
            x = _x((21, d))
            want = np.asarray(jens.apply(jp, x))
            got = ens.apply(tp, torch.from_numpy(x)).numpy()
            atol = F32_ATOL
        else:
            xs = _x((3, 7, d))
            want, jstate = jens.apply_sequence(jp, xs)
            got, state = ens.apply_sequence(tp, torch.from_numpy(xs))
            want, got, atol = np.asarray(want), got.numpy(), LSTM_ATOL
            # the state threads on: a second chunk from the carried state
            xs2 = _x((3, 4, d), seed=1)
            want2, _ = jens.apply_sequence(jp, xs2, jstate)
            got2, _ = ens.apply_sequence(tp, torch.from_numpy(xs2), state)
            np.testing.assert_allclose(got2.numpy(), np.asarray(want2),
                                       atol=atol, rtol=0)
            assert (state["folds"] is None) == (not folds)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_combine_rule():
    ens = Ensemble(network=None)
    m = torch.tensor([[1.0, 2.0]])
    f = torch.tensor([[[3.0, 0.0]], [[5.0, 2.0]]])
    assert torch.equal(ens.combine(m, None), m)
    assert torch.equal(ens.combine(m, f), (m * 2 + f[0] + f[1]) / 4)
    assert torch.equal(ens.combine(None, f), (f[0] + f[1]) / 2)


@pytest.mark.parametrize("kind", ["ff", "lstm"])
def test_ensemble_log_posteriors_match_jax(tmp_path, kind):
    jens, jp, ens, tp, d = _ensembles(kind, tmp_path, True, True, True)
    offsets = np.array([0, 5, 14, 16, 27])
    x = _x((27, d), seed=4)
    ap = np.log(np.random.default_rng(5).dirichlet(np.ones(C)))[None]
    kw = dict(offsets=offsets if kind == "lstm" else None,
              ap=ap.astype(np.float32), timedelay=0, batch=2, chunk=8)
    got = ensemble_log_posteriors(ens, tp, x, **kw)
    want = j_ensemble_lp(jens, jp, x, **kw)
    np.testing.assert_allclose(got, want,
                               atol=F32_ATOL if kind == "ff" else LSTM_ATOL,
                               rtol=0)
    if kind == "lstm":
        with pytest.raises(ValueError, match="offsets"):
            ensemble_log_posteriors(ens, tp, x)


def test_apply_fn_stage_matches_jax(tmp_path):
    """An FF stage whose forward is ``apply_fn`` (here RPL4's math on
    the net's own out layer) draws the same minibatches and makes the
    same updates as the JAX engine's ``apply_fn``."""
    jnet = j_get_network("ff", 0, [8], C)
    init = jnet.init(jax.random.PRNGKey(2), C)
    rng = np.random.default_rng(3)
    x = np.log(rng.dirichlet(np.ones(C), size=300)).astype(np.float32)
    y = rng.integers(0, C, 300).astype(np.int32)

    def j_apply(p, xb, rng, train):
        return jax.nn.log_softmax(xb) * (1 + p["out"]["w"][0]) + p["out"]["b"]

    def t_apply(p, xb, generator, train):
        return torch.log_softmax(xb, -1) * (1 + p["out.w"][0]) + p["out.b"]

    stages = [dict(epoch=2, optimizer="adam", batch_size=64, lr=1e-3,
                   early_stopping=False)]
    want = j_train_network(
        jnet, x, y, JTrainConfig(stages=[JTrainStage(**s) for s in stages],
                                 log=None),
        x_dev=x[:50], y_dev=y[:50], init_params=init, apply_fn=j_apply)
    net = get_network("ff", 0, [8], C, in_dim=C, device="cpu")
    got = train_network(
        net, x, y, TrainConfig(stages=[TrainStage(**s) for s in stages],
                               log=None),
        x_dev=x[:50], y_dev=y[:50],
        init_params=_port_params(init, tmp_path), apply_fn=t_apply,
        device="cpu")
    for hp, hj in zip(got.history, want.history):
        for k in ("main/loss", "validation/main/loss"):
            np.testing.assert_allclose(hp[k], hj[k], rtol=1e-5)
    np.testing.assert_allclose(got.params["out.b"].numpy(),
                               np.asarray(want.params["out"]["b"]),
                               atol=F32_ATOL)


# ---- the CLIs --------------------------------------------------------------

NUM_CLASSES = 17          # make_synthetic_image(num_phones=5): 3*5 + 2 pdfs
DIM = 8


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A corpus tree, its train set cut into two folds, and for each net
    kind a JAX-written master, two fold models and an RPL4 head."""
    root = tmp_path_factory.mktemp("ens_cli")
    img = make_synthetic_image(num_phones=5, seed=2,
                               pdf_tied_transitions=True)
    corpus = make_synthetic_corpus(img, dim=DIM, num_train=8, num_dev=3,
                                   num_test=4, noise=0.5, seed=2,
                                   max_phones=4)
    write_corpus_tree(corpus, str(root))
    save_image(str(root / "recog" / "kaldiTri1909.img"), img)
    np.save(root / "recog" / "log_ap_Kaldi1909.npy", corpus.log_priors)
    folds = root / "folds"
    folds.mkdir()
    off = corpus.train.offsets
    for k, (a, b) in enumerate([(0, 3), (3, len(off) - 1)]):
        beg, end = off[a], off[b]
        np.save(folds / f"data_{k}.npy", corpus.train.data[beg:end])
        np.save(folds / f"targets_{k}.npy", corpus.train.targets[beg:end])
        np.save(folds / f"offsets_{k}.npy", off[a:b + 1] - beg)
    for kind, spec in SPECS.items():
        jnet = j_get_network(kind, 1 if kind == "lstm" else 2, [12],
                             NUM_CLASSES)
        d = DIM * (5 if kind == "ff" else 1)
        models = root / "models" / kind
        models.mkdir(parents=True)
        j_save(str(models / "master.npz"),
               jnet.init(jax.random.PRNGKey(0), d))
        for k in range(2):
            j_save(str(models / f"fold_{k}.npz"),
                   jnet.init(jax.random.PRNGKey(1 + k), d))
        rpl = {"w": _x((1, NUM_CLASSES), 8) * 0.2,
               "b": _x((1, NUM_CLASSES), 9) * 0.2,
               "lb": np.full((1, NUM_CLASSES), -20.0, np.float32)}
        j_save(str(models / "rpl.npz"), rpl)
    return root


SPECS = {"ff": ["-n", "ff", "-l", "2", "-u", "12", "--splice", "2"],
         "lstm": ["-n", "lstm", "-l", "1", "-u", "12", "--timedelay", "2",
                  "--scan-impl", "pallas"]}


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_predict_folds_matches_jax(tree, tmp_path, kind):
    """Fold mode (each fold net over its own fold) and dev mode (the
    fold average renormalised by ``ref_logsum``) on JAX-written fold
    models."""
    common = SPECS[kind] + ["--num-classes", NUM_CLASSES,
                            "--data-dir", f"{tree}/data",
                            "--offset-dir", f"{tree}/data",
                            "--fold-data-dir", f"{tree}/folds",
                            "--fold-model-dir", f"{tree}/models/{kind}"]
    for mode in ([], ["--fold-output-dev", "data_dev.npy"]):
        j_predict_folds.main(common + mode
                             + ["--fold-output-dir", tmp_path / "j"])
        predict_folds.main(common + mode + ["--fold-output-dir",
                                            tmp_path / "t", "--device",
                                            "cpu"])
    atol = F32_ATOL if kind == "ff" else LSTM_ATOL
    for name in ("data_0.npy", "data_1.npy", "data_dev.npy"):
        want = np.load(tmp_path / "j" / name)
        got = np.load(tmp_path / "t" / name)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                   err_msg=name)
    if kind == "lstm":      # the reference's zero tail of --timedelay 2
        off = np.load(tree / "folds" / "offsets_0.npy")
        got = np.load(tmp_path / "t" / "data_0.npy")
        assert not got[off[1] - 2:off[1]].any()


def test_predict_folds_without_models_raises(tree, tmp_path):
    with pytest.raises(FileNotFoundError, match="No fold networks"):
        predict_folds.main(SPECS["ff"] + [
            "--fold-model-dir", tmp_path, "--fold-output-dir", tmp_path,
            "--device", "cpu"])


def test_train_rpl_matches_jax(tree, tmp_path):
    """RPL4 trained on the fold outputs (validated on the dev-set fold
    average) by both CLIs from the same deterministic init."""
    outs = tmp_path / "fold_out"
    predict = SPECS["ff"] + ["--num-classes", NUM_CLASSES,
                             "--data-dir", f"{tree}/data",
                             "--fold-data-dir", f"{tree}/folds",
                             "--fold-model-dir", f"{tree}/models/ff",
                             "--fold-output-dir", outs]
    j_predict_folds.main(predict)
    j_predict_folds.main(predict + ["--fold-output-dev", "data_dev.npy"])
    common = ["--train-rpl", "--tri", "--num-classes", NUM_CLASSES,
              "--seed", "3", "--data-dir", outs,
              "--target-dir", f"{tree}/data", "--data", "data_dev.npy",
              "--fold-data-dir", f"{tree}/folds", "--fold-output-dir", outs,
              "-b", "64", "--epoch", "3", "-o", "adam", "--lr", "1e-3",
              "--early-stopping", "false", "--noplot"]
    j_train_cli.main(common + ["--out", tmp_path / "j"])
    res = train_cli.main(common + ["--out", tmp_path / "t", "--device",
                                   "cpu"])
    want = np.load(tmp_path / "j" / "model.npz")
    got = np.load(tmp_path / "t" / "model.npz")
    assert sorted(got.files) == sorted(want.files) == ["b", "lb", "w"]
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], atol=F32_ATOL, rtol=0,
                                   err_msg=k)
    assert np.abs(got["w"]).max() > 1e-4          # it did train
    assert len(res.history) == 3 and "validation/main/loss" in res.history[0]


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_evaluate_rpl_decodes_identically(tree, tmp_path, kind):
    models = tree / "models" / kind
    args = SPECS[kind] + [
        "--num-classes", NUM_CLASSES, "--rpl",
        "--master-network", f"{models}/master",
        "--fold-model-dir", models, "--rpl-model", f"{models}/rpl",
        "--data-dir", f"{tree}/data", "--offset-dir", f"{tree}/data",
        "--utt-list-dir", f"{tree}/data", "--recog-dir", f"{tree}/recog",
        "--PIP", "5", "--test-or-dev", "test"]
    per_j = j_evaluate.main(args + ["--out-mlf", tmp_path / "j.mlf"])
    per_t = evaluate.main(args + ["--device", "cpu",
                                  "--out-mlf", tmp_path / "t.mlf"])
    text = (tmp_path / "j.mlf").read_text()
    assert text.count('"*/') == 4
    assert (tmp_path / "t.mlf").read_text() == text
    assert per_t == per_j
