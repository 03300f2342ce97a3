"""The peephole and zoneout LSTMs through the port's training CLI, and
zoneout training at ratios above 0.

``train_cli --device cpu`` on the kernel route (``--scan-impl pallas``,
the kernels' plain versions) trains ``-n peepholelstm`` and the SPECOM
``-n zoneoutlstm --timedelay 2 -d 0.2`` and writes ``model.npz`` under
the JAX keys; JAX ``load_pytree`` reads it, and JAX ``evaluate`` and the
port's ``evaluate --device cpu`` decode it to byte-identical MLFs.

Zoneout masks come from each framework's own generator, so at ratios
above 0 the port is held to its own run: every loss is finite, the loss
falls, and a run killed after an epoch and resumed from its snapshot
makes exactly the uninterrupted run's remaining epoch.
"""

import json

import jax
import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu.decoder.image import (
    make_synthetic_image,
    save_image,
)
from nnacousticmodeling_tpu.models import get_network as j_get_network
from nnacousticmodeling_tpu.pipeline import evaluate as j_evaluate
from nnacousticmodeling_tpu.train import load_pytree as j_load
from nnacousticmodeling_tpu.utils.synthetic import (
    make_synthetic_corpus,
    write_corpus_tree,
)
from nnacousticmodeling_tpu_torch.models import get_network
from nnacousticmodeling_tpu_torch.pipeline import evaluate, train_cli
from nnacousticmodeling_tpu_torch.train import (
    TrainConfig,
    TrainStage,
    train_network,
)

NUM_CLASSES = 17          # make_synthetic_image(num_phones=5): 3*5 + 2 pdfs
DIM = 8


@pytest.fixture(scope="module")
def corpus():
    img = make_synthetic_image(num_phones=5, seed=1,
                               pdf_tied_transitions=True)
    return img, make_synthetic_corpus(img, dim=DIM, num_train=8, num_dev=2,
                                      num_test=4, noise=0.5, seed=1,
                                      max_phones=4)


@pytest.fixture(scope="module")
def tree(tmp_path_factory, corpus):
    root = tmp_path_factory.mktemp("peephole_cli")
    img, c = corpus
    write_corpus_tree(c, str(root))
    save_image(str(root / "recog" / "kaldiTri1909.img"), img)
    np.save(root / "recog" / "log_ap_Kaldi1909.npy", c.log_priors)
    return root


@pytest.mark.parametrize("name,extra", [
    ("peepholelstm", []), ("zoneoutlstm", ["--timedelay", "2", "-d", "0.2"])])
def test_train_cli_model_decodes_identically_in_jax(tree, tmp_path, name,
                                                    extra):
    out = tmp_path / "port"
    net_args = ["-n", name, "-l", "2", "-u", "32",
                "--num-classes", str(NUM_CLASSES), "--scan-impl", "pallas"]
    data = ["--data-dir", f"{tree}/data", "--offset-dir", f"{tree}/data",
            "--target-dir", f"{tree}/data"]
    result = train_cli.main(
        net_args + data + extra
        + ["-b", "4", "--bproplen", "5", "-o", "momentumsgd", "--lr",
           "0.05", "-e", "2", "--early-stopping", "false", "--noplot",
           "--out", str(out), "--device", "cpu"])
    log = json.loads((out / "log.json").read_text())
    assert [h["epoch"] for h in log] == [1, 2]
    assert all(np.isfinite(h["main/loss"]) for h in log)
    template = j_get_network(name, 2, [32], NUM_CLASSES).init(
        jax.random.PRNGKey(0), DIM)
    params = j_load(str(out / "model.npz"), template)
    for key in template["cells"][1]:
        np.testing.assert_array_equal(np.asarray(params["cells"][1][key]),
                                      result.params[f"cells.1.{key}"].numpy())
    args = net_args + data + [
        "--model", f"{out}/model", "--utt-list-dir", f"{tree}/data",
        "--recog-dir", f"{tree}/recog", "--PIP", "5", "--test-or-dev",
        "test"]
    per_j = j_evaluate.main(args + ["--out-mlf", tmp_path / "j.mlf"])
    per_t = evaluate.main(args + ["--device", "cpu",
                                  "--out-mlf", tmp_path / "t.mlf"])
    text = (tmp_path / "j.mlf").read_text()
    assert text.count('"*/') == 4
    assert (tmp_path / "t.mlf").read_text() == text
    assert per_t == per_j


def test_zoneout_training_falls_and_resumes_exactly(tmp_path, corpus):
    """``zoneoutlstm`` with the SPECOM ``-d 0.2`` (c_ratio 0.2, h_ratio
    0.5): the zoneout masks come from the generator whose state the
    snapshot carries, so a resumed run replays the uninterrupted one."""
    _, c = corpus
    stages = [TrainStage(epoch=2, optimizer="momentumsgd", batch_size=4,
                         lr=5e-2, early_stopping=False)]

    class Crash(Exception):
        pass

    def crash(stage, epoch):
        if (stage, epoch) == (0, 1):
            raise Crash

    def run(snap, resume, hook=None):
        net = get_network("zoneoutlstm", 2, [16], NUM_CLASSES, dropout=[0.2],
                          in_dim=DIM, scan_impl="pallas", device="cpu")
        assert (net.c_ratio, net.h_ratio) == (0.2, 0.5)
        cfg = TrainConfig(stages=stages, bprop_len=5, seed=0, log=None,
                          snapshot_path=snap, resume_snapshot=resume,
                          epoch_hook=hook)
        return train_network(net, c.train.data, c.train.targets, cfg,
                             offsets=c.train.offsets, x_dev=c.dev.data,
                             y_dev=c.dev.targets, device="cpu")

    ref = run(str(tmp_path / "ref.npz"), False)
    losses = [h[k] for h in ref.history
              for k in ("main/loss", "validation/main/loss")]
    assert np.isfinite(losses).all()
    assert ref.history[1]["main/loss"] < ref.history[0]["main/loss"]
    snap = str(tmp_path / "snap.npz")
    with pytest.raises(Crash):
        run(snap, False, crash)
    res = run(snap, True)
    assert len(res.history) == 1
    assert res.history[0]["main/loss"] == ref.history[1]["main/loss"]
    assert (res.history[0]["validation/main/loss"]
            == ref.history[1]["validation/main/loss"])
    for k in ref.params:
        assert torch.equal(res.params[k], ref.params[k]), k
