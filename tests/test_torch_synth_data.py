"""The port's ``synth_data`` CLI and the untied-image decode end to end
against the JAX package.

The port's ``synth_data`` must write the same tree as the JAX CLI (the
same ``.npy`` arrays, utterance lists, reference MLFs and image). Its
default image is untied (``tied=False``), which both kernels refuse, so
the port's ``evaluate --device cpu`` decodes it through the cube scan
twin; the MLF must be byte-identical to JAX ``evaluate``'s and the PER
equal. JAX decodes off-TPU on its XLA scan path.
"""

import jax
import numpy as np
import pytest

from nnacousticmodeling_tpu.models import get_network as j_get_network
from nnacousticmodeling_tpu.pipeline import evaluate as j_evaluate
from nnacousticmodeling_tpu.pipeline import synth_data as j_synth_data
from nnacousticmodeling_tpu.train.checkpoint import save_pytree
from nnacousticmodeling_tpu_torch.decoder.image import load_image
from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
from nnacousticmodeling_tpu_torch.pipeline import evaluate, synth_data

ARGS = ["--num-phones", "4", "--dim", "8", "--num-train", "4", "--num-dev",
        "2", "--num-test", "4", "--seed", "3"]
NUM_CLASSES = 14          # 3 * 4 + 2 pdfs


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    j_synth_data.main(["--root", root / "jax"] + ARGS)
    synth_data.main(["--root", root / "port"] + ARGS)
    return root / "jax", root / "port"


def test_same_tree_as_jax(trees):
    jax_root, port_root = trees
    want = sorted(p.relative_to(jax_root) for p in jax_root.rglob("*")
                  if p.is_file())
    got = sorted(p.relative_to(port_root) for p in port_root.rglob("*")
                 if p.is_file())
    assert got == want and len(want) > 10
    for rel in want:
        a, b = jax_root / rel, port_root / rel
        if rel.suffix == ".npy":
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype, rel
            np.testing.assert_array_equal(x, y, err_msg=str(rel))
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def test_timit_graph_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        synth_data.main(["--root", tmp_path, "--timit-graph"])


def test_evaluate_untied_tree_matches_jax(trees, tmp_path):
    jax_root, port_root = trees
    img = load_image(str(port_root / "recog" / "kaldiTri1909.img"))
    assert img.num_states == NUM_CLASSES
    assert ViterbiDecoder(img, device="cpu").backend == "xla"
    net = j_get_network("lstm", 2, [16], NUM_CLASSES)
    save_pytree(str(tmp_path / "model.npz"),
                net.init(jax.random.PRNGKey(0), 8))

    def args(root):
        return ["-n", "lstm", "-l", "2", "-u", "16", "--num-classes",
                str(NUM_CLASSES), "--scan-impl", "pallas", "--model",
                f"{tmp_path}/model", "--data-dir", f"{root}/data",
                "--offset-dir", f"{root}/data", "--utt-list-dir",
                f"{root}/data", "--recog-dir", f"{root}/recog", "--PIP", "5"]

    per_j = j_evaluate.main(args(jax_root) + ["--out-mlf",
                                              tmp_path / "j.mlf"])
    per_t = evaluate.main(args(port_root) + ["--device", "cpu", "--out-mlf",
                                             tmp_path / "t.mlf"])
    text = (tmp_path / "j.mlf").read_text()
    assert text.count('"*/') == 4
    assert (tmp_path / "t.mlf").read_text() == text
    assert per_t == per_j
