"""The port's fold-parallel training (``train/fold_parallel.py``) against
the JAX package's ``train_folds_parallel``.

Both start from JAX's K inits (``split(PRNGKey(seed), K + 1)[1:]``, what
the JAX function draws itself), passed to the port through
``init_params``, with dropout 0 and one seed, so both draw the same
minibatches from the shared numpy shuffle. The run: an early-stopping
stage that stops the folds at different epochs (and so compacts the
stack), then a fixed-epoch stage that keeps each fold's best-validation
params. The per-fold train and dev losses are read from the two
functions' log lines, printed at full precision for the test (the JAX
function reports them only there), beside the fold lists and the
compaction lines, which must be equal. Tolerances are
``test_torch_train.py``'s: the float32 step loop (``xla``) losses rtol
1e-5, params atol 1e-5; the kernels' plain versions against the Pallas
kernels in interpret mode (``pallas``) 1e-4 / 5e-3.

Also: JAX's ``compact=False`` (stopped folds kept in the vmap, masked)
gives the params of the port, which always drops them; ``train_cli
--train-all-folds`` writes K ``.npz`` files that JAX ``load_pytree``
reads and that JAX ``evaluate`` decodes to the port's MLFs; ``master
--fold-parallel`` runs its six phases.
"""

import dataclasses
import functools
import re

import jax
import numpy as np
import pytest

from nnacousticmodeling_tpu.decoder import make_synthetic_image
from nnacousticmodeling_tpu.models import get_network as j_get_network
from nnacousticmodeling_tpu.pipeline import evaluate as j_evaluate
from nnacousticmodeling_tpu.pipeline.synth_data import main as j_synth
from nnacousticmodeling_tpu.train import TrainConfig as JTrainConfig
from nnacousticmodeling_tpu.train import TrainStage as JTrainStage
from nnacousticmodeling_tpu.train import load_pytree as j_load_pytree
from nnacousticmodeling_tpu.train.checkpoint import _path_str
from nnacousticmodeling_tpu.train.fold_parallel import (
    fold_index_universe as j_fold_index_universe,
)
from nnacousticmodeling_tpu.train.fold_parallel import (
    train_folds_parallel as j_train_folds_parallel,
)
from nnacousticmodeling_tpu.utils.synthetic import make_synthetic_corpus
from nnacousticmodeling_tpu_torch.models import get_network
from nnacousticmodeling_tpu_torch.pipeline import evaluate, train_cli
from nnacousticmodeling_tpu_torch.pipeline.generate_folds import (
    main as generate_folds,
)
from nnacousticmodeling_tpu_torch.pipeline.master import main as master
from nnacousticmodeling_tpu_torch.train import (
    TrainConfig, TrainStage, load_jax_params,
)
from nnacousticmodeling_tpu_torch.train.fold_parallel import (
    fold_index_universe, train_folds_parallel,
)

K, H, DIM, CLASSES = 3, 32, 10, 16
# (early-stopping stage, fixed-epoch stage) a case
ES_FF = dict(epoch=6, optimizer="sgd", batch_size=8, lr=0.5,
             early_stopping=True)
ES_LSTM = dict(ES_FF, epoch=10)
FIXED = dict(epoch=2, optimizer="momentumsgd", batch_size=8, lr=0.05,
             early_stopping=False)
GENTLE = [dict(ES_FF, epoch=3, lr=0.05), dict(FIXED, lr=0.01)]
LINE = re.compile(r"stage=(\d+) epoch=(\d+) folds=\[(.*?)\] loss=\[(.*?)\] "
                  r"\(.*?s\)(?: val=\[(.*?)\])?", re.S)


def test_fold_index_universe_matches_jax():
    offsets = np.array([0, 3, 7, 10, 12])
    utt_folds = np.array([0, 1, 0, 1])
    frames, local = fold_index_universe(offsets, utt_folds, fold=1)
    np.testing.assert_array_equal(frames, [0, 1, 2, 7, 8, 9])
    np.testing.assert_array_equal(local, [0, 3, 6])
    rng = np.random.default_rng(0)
    offsets = np.concatenate([[0], np.cumsum(rng.integers(1, 9, 11))])
    utt_folds = rng.integers(0, 4, 11)
    for k in range(4):
        for a, b in zip(fold_index_universe(offsets, utt_folds, k),
                        j_fold_index_universe(offsets, utt_folds, k)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


@pytest.fixture(scope="module")
def corpus():
    img = make_synthetic_image(num_phones=4, num_states=CLASSES, seed=5,
                               tied=False)
    return make_synthetic_corpus(img, dim=DIM, num_train=12, num_dev=4,
                                 num_test=2, noise=0.9, seed=5)


@pytest.fixture
def full_precision(monkeypatch):
    """Both functions log their per-fold losses through
    ``np.array2string(a, precision=3)``: print them whole instead."""
    orig = np.array2string
    monkeypatch.setattr(np, "array2string", functools.partial(
        lambda a, precision=None, _f=orig: _f(a, precision=9,
                                              max_line_width=10 ** 6)))


def _jax_inits(jnet):
    keys = jax.random.split(jax.random.PRNGKey(0), K + 1)
    return [jax.tree_util.tree_map(np.asarray, jnet.init(keys[k + 1], DIM))
            for k in range(K)]


def _parse(logs):
    """(header and compaction lines, [(stage, epoch, folds, losses,
    vals)])."""
    rows, other = [], []
    for m in logs:
        hit = LINE.search(m)
        if hit is None:
            other.append(m)
            continue
        s, e, folds, loss, val = hit.groups()
        rows.append((int(s), int(e), folds,
                     np.array(loss.split(), np.float64),
                     np.array(val.split(), np.float64)))
    return other, rows


def _runs(corpus, network, impl, stages, compact=True):
    c, d = corpus.train, corpus.dev
    utt_folds = np.arange(c.num_utts) % K
    jnet = dataclasses.replace(j_get_network(network, 1, [H], CLASSES),
                               **({"scan_impl": impl}
                                  if network != "ff" else {}))
    j_logs, t_logs = [], []
    j_res = j_train_folds_parallel(
        jnet, c.data, c.targets, c.offsets, utt_folds, K,
        JTrainConfig(stages=[JTrainStage(**s) for s in stages], bprop_len=5,
                     seed=0, log=j_logs.append),
        x_dev=d.data, y_dev=d.targets, compact=compact)
    net = get_network(network, 1, [H], CLASSES, in_dim=DIM, scan_impl=impl,
                      device="cpu")
    t_res = train_folds_parallel(
        net, c.data, c.targets, c.offsets, utt_folds, K,
        TrainConfig(stages=[TrainStage(**s) for s in stages], bprop_len=5,
                    seed=0, log=t_logs.append),
        x_dev=d.data, y_dev=d.targets,
        init_params=[load_jax_params(p, device="cpu")
                     for p in _jax_inits(jnet)])
    return j_res, j_logs, t_res, t_logs


def _assert_params(t_res, j_res, atol):
    assert len(t_res) == len(j_res) == K
    for tp, jp in zip(t_res, j_res):
        flat = jax.tree_util.tree_flatten_with_path(jp)[0]
        assert set(tp) == {_path_str(p).replace("/", ".") for p, _ in flat}
        for path, leaf in flat:
            key = _path_str(path).replace("/", ".")
            np.testing.assert_allclose(tp[key].numpy(), np.asarray(leaf),
                                       atol=atol, rtol=0, err_msg=key)


@pytest.mark.parametrize("network,impl,stages,stops,loss_rtol,param_atol", [
    ("ff", "xla", [ES_FF, FIXED], True, 1e-5, 1e-5),
    ("lstm", "xla", [ES_LSTM, FIXED], True, 1e-5, 1e-5),
    ("lstm", "pallas", GENTLE, False, 1e-4, 5e-3),
], ids=["ff", "lstm-xla", "lstm-pallas"])
def test_matches_jax_train_folds_parallel(corpus, full_precision, network,
                                          impl, stages, stops, loss_rtol,
                                          param_atol):
    """On the kernel route (bf16 recurrent operands) a sum taken in
    another order flips a rounding now and then; at the learning rate
    that makes the folds stop (sgd 0.5) those flips grow past 1e-4 of the
    loss within a few epochs, on either side, so that route runs a
    gentler schedule under which no fold stops."""
    j_res, j_logs, t_res, t_logs = _runs(corpus, network, impl, stages)
    j_other, j_rows = _parse(j_logs)
    t_other, t_rows = _parse(t_logs)
    assert t_other == j_other
    assert [r[:3] for r in t_rows] == [r[:3] for r in j_rows]
    epochs = [r[0] for r in t_rows]
    assert epochs.count(1) == stages[1]["epoch"]
    if stops:
        # folds stopped at two epochs: one compaction, then the last
        # fold's stop ended the stage early
        assert sum("compacted" in m for m in t_other) == 1, t_logs
        assert epochs.count(0) < stages[0]["epoch"]
    for tr, jr in zip(t_rows, j_rows):
        np.testing.assert_allclose(tr[3], jr[3], rtol=loss_rtol)
        np.testing.assert_allclose(tr[4], jr[4], rtol=loss_rtol)
    _assert_params(t_res, j_res, param_atol)


def test_compact_false_gives_the_same_params(corpus):
    """The port has no ``compact`` option: stopped folds always leave
    its stacks. JAX's masked ``compact=False`` run ends at the same
    params, so nothing depends on the option."""
    j_res, j_logs, t_res, t_logs = _runs(corpus, "ff", "xla",
                                         [ES_FF, FIXED], compact=False)
    assert any("compacted" in m for m in t_logs)
    assert not any("compacted" in m for m in j_logs)
    _assert_params(t_res, j_res, 1e-5)


def test_mesh_raises():
    net = get_network("ff", 1, [8], 4, in_dim=4, device="cpu")
    cfg = TrainConfig(stages=[TrainStage(1, "sgd", 4, 1e-2, False)],
                      log=None, use_validation=False)
    with pytest.raises(NotImplementedError, match="Parallelism"):
        train_folds_parallel(net, np.zeros((12, 4), np.float32),
                             np.zeros(12, np.int32), None,
                             np.zeros(1, np.int64), 3, cfg, mesh=object())


# ---- the CLIs -------------------------------------------------------------

@pytest.fixture(scope="module")
def fold_tree(tmp_path_factory):
    """``tests/test_pipeline.py``'s tiny corpus (5 phones, dim 16) and its
    2 folds."""
    root = tmp_path_factory.mktemp("fold_cli")
    j_synth(["--root", root, "--num-phones", 5, "--dim", 16,
             "--num-train", 24, "--num-dev", 4, "--num-test", 4,
             "--noise", 0.5, "--seed", 1])
    generate_folds(["-n", 2, "--data-dir", root / "data",
                    "--offset-dir", root / "data",
                    "--target-dir", root / "data",
                    "--utt-list-dir", root / "data",
                    "--fold-data-dir", root / "folds", "--seed", 0])
    return root


NET = ["-n", "lstm", "-l", "1", "-u", "16", "--num-classes", "17"]


def test_train_all_folds_cli_decodes_as_jax(fold_tree, tmp_path):
    root = fold_tree
    params = train_cli.main(
        NET + ["-b", "4", "--bproplen", "5", "-e", "2", "-o", "momentumsgd",
               "--lr", "0.05", "--early-stopping", "false", "--noplot",
               "--train-all-folds", "--fold-data-dir", root / "folds",
               "--fold-model-dir", tmp_path / "models",
               "--data-dir", root / "data", "--offset-dir", root / "data",
               "--target-dir", root / "data", "--out", tmp_path / "out",
               "--device", "cpu"])
    assert sorted(p.name for p in (tmp_path / "models").iterdir()) == [
        "fold_0.npz", "fold_1.npz"]
    template = j_get_network("lstm", 1, [16], 17).init(
        jax.random.PRNGKey(0), 16)
    for k in range(2):
        got = j_load_pytree(str(tmp_path / "models" / f"fold_{k}.npz"),
                            template)
        np.testing.assert_array_equal(np.asarray(got["cells"][0]["wh"]),
                                      params[k]["cells.0.wh"].numpy())
        args = NET + ["--model", tmp_path / "models" / f"fold_{k}",
                      "--data-dir", root / "data",
                      "--offset-dir", root / "data",
                      "--utt-list-dir", root / "data",
                      "--recog-dir", root / "recog", "--PIP", "5"]
        per_j = j_evaluate.main(args + ["--out-mlf", tmp_path / "j.mlf"])
        per_t = evaluate.main(args + ["--device", "cpu",
                                      "--out-mlf", tmp_path / "t.mlf"])
        assert (tmp_path / "t.mlf").read_bytes() == \
            (tmp_path / "j.mlf").read_bytes()
        assert per_t == per_j
    assert not np.array_equal(params[0]["out.w"].numpy(),
                              params[1]["out.w"].numpy())


def test_master_fold_parallel_runs_six_phases(fold_tree, tmp_path,
                                              monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    root = fold_tree
    pers = master([
        "--num-folds", "2", "--gen-folds", "--fold-parallel",
        "--data-dir", f"{root}/data", "--offset-dir", f"{root}/data",
        "--target-dir", f"{root}/data", "--utt-list-dir", f"{root}/data",
        "--recog-dir", f"{root}/recog", "--output-dir", tmp_path / "res",
        "--output-id", "fp", "--network-spec=-n ff -l 2 -u 32 --splice 2",
        "--rpl-train-setup=-b 256 --epoch 2 -o adam --early-stopping false",
        "--epoch", "2", "-o", "adam", "-b", "128", "--early-stopping",
        "false", "--PIP", "5", "--seed", "0", "--num-classes", "17",
        "--eval-data", "test", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "==== Training all 2 folds in parallel" in out
    assert "==== Training fold" not in out
    assert len(pers) == 6
    assert all(np.isfinite(v) and 0 <= v <= 100 for v in pers.values())
    for k in range(2):
        assert (tmp_path / "res" / "models" / "folds" / "2" / "fp"
                / f"fold_{k}.npz").is_file()
