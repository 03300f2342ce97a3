"""The port's training CLI end to end against the JAX package.

The port's ``train_cli --device cpu`` trains an LSTM on a synthetic
corpus tree (the kernel route, ``--scan-impl pallas``, through the
kernels' plain versions), writes ``model.npz`` under the JAX keys,
``log.json`` and ``args.txt``; the JAX package's ``load_pytree`` reads
the model, and JAX ``evaluate --scan-impl pallas`` and the port's
``evaluate --device cpu`` decode it to byte-identical MLFs. The same
holds for a GRU trained with ``-n gru --timedelay 2 -d 0.2``.
"""

import json

import jax
import numpy as np
import pytest

from nnacousticmodeling_tpu.decoder.image import (
    make_synthetic_image,
    save_image,
)
from nnacousticmodeling_tpu.models import get_network as j_get_network
from nnacousticmodeling_tpu.pipeline import evaluate as j_evaluate
from nnacousticmodeling_tpu.pipeline import train_cli as j_train_cli
from nnacousticmodeling_tpu.train import load_pytree as j_load_pytree
from nnacousticmodeling_tpu.utils.synthetic import (
    make_synthetic_corpus,
    write_corpus_tree,
)
from nnacousticmodeling_tpu_torch.pipeline import evaluate, train_cli

NUM_CLASSES = 17          # make_synthetic_image(num_phones=5): 3*5 + 2 pdfs
DIM = 8


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    img = make_synthetic_image(num_phones=5, seed=1,
                               pdf_tied_transitions=True)
    corpus = make_synthetic_corpus(img, dim=DIM, num_train=8, num_dev=2,
                                   num_test=4, noise=0.5, seed=1,
                                   max_phones=4)
    write_corpus_tree(corpus, str(root))
    save_image(str(root / "recog" / "kaldiTri1909.img"), img)
    np.save(root / "recog" / "log_ap_Kaldi1909.npy", corpus.log_priors)
    return root


def _train_args(root, out):
    return ["-n", "lstm", "-l", "2", "-u", "32",
            "--num-classes", str(NUM_CLASSES), "-b", "4", "--bproplen", "5",
            "-o", "momentumsgd", "--lr", "0.05", "-e", "2",
            "--early-stopping", "false", "--noplot",
            "--data-dir", f"{root}/data", "--offset-dir", f"{root}/data",
            "--target-dir", f"{root}/data", "--out", str(out)]


@pytest.fixture(scope="module")
def trained(tree):
    out = tree / "port_result"
    result = train_cli.main(_train_args(tree, out)
                            + ["--scan-impl", "pallas", "--device", "cpu"])
    return out, result


def test_train_cli_writes_model_log_and_args(tree, trained, tmp_path):
    out, result = trained
    for name in ("model.npz", "log.json", "args.txt", "snapshot.npz"):
        assert (out / name).is_file(), name
    log = json.loads((out / "log.json").read_text())
    assert [h["epoch"] for h in log] == [1, 2]
    assert all(np.isfinite(h["main/loss"]) for h in log)
    assert log == result.history
    args_txt = (out / "args.txt").read_text()
    assert "# device: cpu" in args_txt and "# bproplen: 5" in args_txt
    j_train_cli.main(_train_args(tree, tmp_path / "jax")
                     + ["--scan-impl", "xla"])
    j_log = json.loads((tmp_path / "jax" / "log.json").read_text())
    assert [sorted(h) for h in log] == [sorted(h) for h in j_log]


def test_jax_load_pytree_reads_port_model(trained):
    out, result = trained
    template = j_get_network("lstm", 2, [32], NUM_CLASSES).init(
        jax.random.PRNGKey(0), DIM)
    params = j_load_pytree(str(out / "model.npz"), template)
    np.testing.assert_array_equal(np.asarray(params["cells"][1]["wh"]),
                                  result.params["cells.1.wh"].numpy())
    np.testing.assert_array_equal(np.asarray(params["out"]["b"]),
                                  result.params["out.b"].numpy())


def test_port_trained_model_decodes_identically(tree, trained, tmp_path):
    out, _ = trained
    args = ["-n", "lstm", "-l", "2", "-u", "32",
            "--num-classes", str(NUM_CLASSES), "--scan-impl", "pallas",
            "--model", f"{out}/model",
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


RAISES = {
    "--train-all-folds --mesh fold=2": "need 2 ranks, have 1",
    "--mesh data=2": "need 2 ranks, have 1",
    "--distributed": "MASTER_ADDR",
    "--coordinator localhost:1234": "--num-processes and --process-id",
}


@pytest.mark.parametrize("extra", [
    ["--train-all-folds", "--mesh", "fold=2"], ["--mesh", "data=2"],
    ["--distributed"], ["--coordinator", "localhost:1234"],
])
def test_unported_options_raise(tree, tmp_path, extra, monkeypatch):
    """The parallel options refuse what this process cannot do, before
    any training: a mesh larger than the world (one rank here), an
    env:// world without its address, a coordinator without the world
    size and rank."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=RAISES[" ".join(extra)]):
        train_cli.main(_train_args(tree, tmp_path) + ["--device", "cpu"]
                       + extra)


def test_one_rank_mesh_and_world_equal_plain_run(tree, tmp_path,
                                                  monkeypatch):
    """``--mesh data=1,model=1`` and ``--distributed`` over a one-rank
    gloo world (env:// as torchrun sets it) give the model of the plain
    run, bit for bit."""
    import socket

    import torch.distributed as dist

    runs = {}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    for tag, extra in (("plain", []), ("mesh", ["--mesh", "data=1,model=1"]),
                       ("world", ["--distributed", "--mesh", "data=1"])):
        out = tmp_path / tag
        try:
            train_cli.main(_train_args(tree, out) + ["--device", "cpu"]
                           + extra)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        with np.load(out / "model.npz") as data:
            runs[tag] = {k: data[k] for k in data.files}
    for tag in ("mesh", "world"):
        assert sorted(runs[tag]) == sorted(runs["plain"])
        for k, v in runs["plain"].items():
            np.testing.assert_array_equal(runs[tag][k], v, err_msg=k)


def test_train_fold_and_resume(tree, tmp_path):
    """--train-fold trains on every fold but the named one and copies the
    model to the fold directory; --resume on a finished run runs no
    epoch and keeps the model."""
    folds = tmp_path / "folds"
    folds.mkdir()
    x = np.load(tree / "data" / "data_train.npy")
    y = np.load(tree / "data" / "targets_train.npy")
    off = np.load(tree / "data" / "offsets_train.npy")
    half = len(off) // 2
    for k, (a, b) in enumerate([(0, half), (half, len(off) - 1)]):
        beg, end = off[a], off[b]
        np.save(folds / f"data_{k}.npy", x[beg:end])
        np.save(folds / f"targets_{k}.npy", y[beg:end])
        np.save(folds / f"offsets_{k}.npy", off[a:b + 1] - beg)
    out = tmp_path / "fold1"
    args = _train_args(tree, out) + [
        "--device", "cpu", "--train-fold", "1", "--fold-data-dir",
        str(folds), "--fold-model-dir", str(tmp_path / "models"), "-e", "1"]
    first = train_cli.main(args)
    assert (tmp_path / "models" / "fold_1.npz").is_file()
    again = train_cli.main(args + ["--resume", "auto"])
    assert again.history == []
    for k, v in first.params.items():
        np.testing.assert_array_equal(again.params[k].numpy(), v.numpy())


# ---- the GRU (the networks of specom2018.sh / slsp2018.sh) ---------------

def _gru_args(root, out):
    args = _train_args(root, out)
    args[args.index("-n") + 1] = "gru"
    return args + ["--timedelay", "2", "-d", "0.2"]


@pytest.fixture(scope="module")
def trained_gru(tree):
    out = tree / "port_gru"
    result = train_cli.main(_gru_args(tree, out)
                            + ["--scan-impl", "pallas", "--device", "cpu"])
    return out, result


def test_gru_train_cli_writes_a_model_jax_reads(trained_gru):
    out, result = trained_gru
    log = json.loads((out / "log.json").read_text())
    assert [h["epoch"] for h in log] == [1, 2]
    assert all(np.isfinite(h["main/loss"]) for h in log)
    template = j_get_network("gru", 2, [32], NUM_CLASSES).init(
        jax.random.PRNGKey(0), DIM)
    params = j_load_pytree(str(out / "model.npz"), template)
    for key in ("wx", "bx", "wh_rz", "wh_c"):
        np.testing.assert_array_equal(
            np.asarray(params["cells"][1][key]),
            result.params[f"cells.1.{key}"].numpy())


def test_gru_trained_model_decodes_identically(tree, trained_gru, tmp_path):
    out, _ = trained_gru
    args = ["-n", "gru", "-l", "2", "-u", "32",
            "--num-classes", str(NUM_CLASSES), "--scan-impl", "pallas",
            "--model", f"{out}/model",
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
