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


def _dense_cube(image_module):
    """A stand-in for ``build_timit_image`` from ``image_module`` (either
    package's ``decoder.image``): a small tied image over the dense
    triphone cube, as the TIMIT graph is."""
    return lambda: image_module.make_synthetic_image(
        num_phones=5, seed=7, full_context=True, tied=True)


def test_timit_graph_tree_matches_jax(tmp_path, monkeypatch):
    """``--timit-graph`` goes through each package's own
    ``build_timit_image`` (patched in both CLIs' namespaces with one
    function making a small dense cube): the two CLIs write
    byte-identical trees, the image that function's."""
    from nnacousticmodeling_tpu.decoder import image as j_image
    from nnacousticmodeling_tpu_torch.decoder import image as t_image
    monkeypatch.setattr(j_synth_data, "build_timit_image",
                        _dense_cube(j_image))
    monkeypatch.setattr(synth_data, "build_timit_image", _dense_cube(t_image))
    argv = ["--timit-graph", "--dim", "8", "--num-train", "3", "--num-dev",
            "2", "--num-test", "2", "--seed", "5"]
    j_synth_data.main(["--root", tmp_path / "jax"] + argv)
    synth_data.main(["--root", tmp_path / "port"] + argv)
    want = sorted(p.relative_to(tmp_path / "jax")
                  for p in (tmp_path / "jax").rglob("*") if p.is_file())
    got = sorted(p.relative_to(tmp_path / "port")
                 for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert got == want and len(want) > 10
    for rel in want:
        assert (tmp_path / "jax" / rel).read_bytes() == \
            (tmp_path / "port" / rel).read_bytes(), rel
    img = load_image(str(tmp_path / "port" / "recog" / "kaldiTri1909.img"))
    assert img.num_phones == 5


def test_timit_graph_not_ported(tmp_path, monkeypatch):
    """Without the TIMIT bundle ``--timit-graph`` raises what the JAX
    CLI raises: the missing Kaldi tree (each package's own
    ``build_timit_image``, its bundle paths pointed at an empty
    directory)."""
    import functools

    from nnacousticmodeling_tpu.decoder import graph as j_graph
    from nnacousticmodeling_tpu_torch.decoder import graph as t_graph
    missing = tmp_path / "bundle"
    for cli, graph in ((j_synth_data, j_graph), (synth_data, t_graph)):
        monkeypatch.setattr(cli, "build_timit_image", functools.partial(
            graph.build_timit_image, tree_file=str(missing / "kaldi/tree"),
            mdl_file=str(missing / "kaldi/final.mdl"),
            phone_map_file=str(missing / "recog/phones.60-48-39.map")))
    raised = []
    for cli in (j_synth_data, synth_data):
        with pytest.raises(FileNotFoundError) as exc:
            cli.main(["--root", tmp_path / cli.__name__, "--timit-graph"])
        raised.append(exc.value.filename)
    assert raised == [str(missing / "kaldi/tree")] * 2


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
