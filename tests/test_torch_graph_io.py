"""The port's ``io/binio``, ``io/kaldi_mdl``, ``io/kaldi_tree``,
``decoder/graph`` and ``evaluate --lm-from-mlf`` against the JAX
package's.

The Kaldi files are small ones the test writes: a text transition model
of three phones (``sil`` with the 0.5/0.5 topology, two with 0.75/0.25,
trained log probs) and a binary decision tree with table (``TE``),
split (``SE``), constant (``CE``) and ``NULL`` nodes, one pdf depending
on the left context. ``build_image`` on them, and the synthetic cube
images' ``cube_phone_names`` / ``estimate_bigram_lm`` /
``image_with_bigram_lm``, equal the JAX functions' array for array; the
image-minting CLI writes the JAX CLI's bytes; ``evaluate
--lm-from-mlf`` writes the JAX CLI's MLF byte for byte.
"""

import struct

import numpy as np
import pytest

from nnacousticmodeling_tpu.decoder import graph as j_graph
from nnacousticmodeling_tpu.decoder.image import (
    make_synthetic_image as j_make_synthetic_image,
)
from nnacousticmodeling_tpu.io import binio as j_binio
from nnacousticmodeling_tpu.io.kaldi_mdl import (
    load_transition_model as j_load_transition_model,
)
from nnacousticmodeling_tpu.io.kaldi_tree import load_tree as j_load_tree
from nnacousticmodeling_tpu.pipeline import evaluate as j_evaluate
from nnacousticmodeling_tpu.pipeline.synth_data import main as j_synth
from nnacousticmodeling_tpu_torch.decoder import graph
from nnacousticmodeling_tpu_torch.decoder.image import make_synthetic_image
from nnacousticmodeling_tpu_torch.io import load_bin, load_mlf, save_bin
from nnacousticmodeling_tpu_torch.io.kaldi_mdl import load_transition_model
from nnacousticmodeling_tpu_torch.io.kaldi_tree import load_tree
from nnacousticmodeling_tpu_torch.pipeline import evaluate, train_cli

IMAGE_FIELDS = ("start_idxs", "end_idxs", "biphone_in", "biphone_out",
                "state_idxs", "tp_selfloop", "tp_transition", "out_offsets",
                "out_values", "lm")


# ---- binio -----------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [((7,), np.float32),
                                         ((5, 3), np.float32),
                                         ((4, 1), np.int32),
                                         ((0, 6), np.float32)])
def test_save_bin_bytes_equal_jax(tmp_path, shape, dtype):
    x = (np.random.default_rng(0).standard_normal(shape) * 100).astype(dtype)
    save_bin(str(tmp_path / "t.lab"), x)
    j_binio.save_bin(str(tmp_path / "j.lab"), x)
    assert (tmp_path / "t.lab").read_bytes() == \
        (tmp_path / "j.lab").read_bytes()
    got = load_bin(str(tmp_path / "t.lab"), dtype)
    want = j_binio.load_bin(str(tmp_path / "j.lab"), dtype)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(-1), x.reshape(-1))


def test_save_bin_refuses_3d(tmp_path):
    with pytest.raises(ValueError, match="1-D or 2-D"):
        save_bin(str(tmp_path / "x.lab"), np.zeros((2, 2, 2), np.float32))


# ---- small Kaldi files -----------------------------------------------------

def _topo_entry(phones, p_self):
    states = "".join(
        f"<State> {s} <PdfClass> {s} <Transition> {s} {p_self} "
        f"<Transition> {s + 1} {1 - p_self} </State>\n" for s in range(3))
    return (f"<TopologyEntry>\n<ForPhones>\n{' '.join(map(str, phones))}\n"
            f"</ForPhones>\n{states}<State> 3 </State>\n</TopologyEntry>\n")


# (phone, hmm state, pdf): pdf 3(p-1)+s, and pdf 9 for phone 2 state 1
# after sil (the tree's left-context split)
TRIPLES = [(p, s, 3 * (p - 1) + s) for p in (1, 2, 3) for s in range(3)] + [
    (2, 1, 9)]


def write_mdl(path, rng):
    lps = np.log(rng.uniform(0.2, 0.8, size=2 * len(TRIPLES)))
    triples = "\n".join(" ".join(map(str, t)) for t in TRIPLES)
    path.write_text(
        "<TransitionModel>\n<Topology>\n" + _topo_entry([1], 0.5)
        + _topo_entry([2, 3], 0.75) + "</Topology>\n"
        f"<Triples> {len(TRIPLES)}\n{triples}\n</Triples>\n"
        "<LogProbs>\n [ 0 " + " ".join(repr(float(v)) for v in lps)
        + " ]\n</LogProbs>\n</TransitionModel>\n")


def _int(v):
    return bytes([4]) + struct.pack("<i", v)


def _ce(pdf):
    return b"CE " + _int(pdf)


def write_tree(path):
    """ToPdf = TE(pdf class) -> TE(center phone) -> CE, with NULL for
    phone id 0 and, for phone 2 in state 1, SE(left phone in {1})."""
    def by_phone(cls):
        kids = [b"NULL "]
        for p in (1, 2, 3):
            leaf = _ce(3 * (p - 1) + cls)
            if p == 2 and cls == 1:
                leaf = (b"SE " + _int(0) + _int(1) + struct.pack("<i", 1)
                        + b"{ " + _ce(9) + leaf + b"} ")
            kids.append(leaf)
        return b"TE " + _int(1) + _int(4) + b"( " + b"".join(kids) + b") "

    root = (b"TE " + _int(-1) + _int(3) + b"( "
            + b"".join(by_phone(c) for c in range(3)) + b") ")
    path.write_bytes(b"\0BContextDependency " + _int(3) + _int(1)
                     + b"ToPdf " + root + b"EndContextDependency ")


def write_phone_map(path):
    path.write_text("h# sil sil\naa aa aa\nao aa aa\nb b b\n")


@pytest.fixture(scope="module")
def kaldi(tmp_path_factory):
    d = tmp_path_factory.mktemp("kaldi")
    write_mdl(d / "final.mdl", np.random.default_rng(3))
    write_tree(d / "tree")
    write_phone_map(d / "phones.map")
    return d


def test_transition_model_matches_jax(kaldi):
    tm = load_transition_model(str(kaldi / "final.mdl"))
    jtm = j_load_transition_model(str(kaldi / "final.mdl"))
    assert tm.phones == jtm.phones == [1, 2, 3]
    assert tm.triples == jtm.triples == TRIPLES
    assert tm.num_tids == jtm.num_tids == 2 * len(TRIPLES)
    assert tm.num_pdfs == jtm.num_pdfs == 10
    np.testing.assert_array_equal(tm.log_probs, jtm.log_probs)
    for p in tm.phones:
        assert [(s.pdf_class, s.transitions) for s in tm.topology[p]] == \
            [(s.pdf_class, s.transitions) for s in jtm.topology[p]]
    for t in TRIPLES:
        assert tm.state_log_probs(*t) == jtm.state_log_probs(*t)


def test_tree_matches_jax(kaldi):
    tree = load_tree(str(kaldi / "tree"))
    jtree = j_load_tree(str(kaldi / "tree"))
    assert (tree.context_width, tree.central_position) == (3, 1)
    assert tree.num_pdfs() == jtree.num_pdfs() == 10
    for a in range(5):
        for b in range(5):
            for c in range(4):
                for cls in range(4):
                    assert tree.map_to_pdf((a, b, c), cls) == \
                        jtree.map_to_pdf((a, b, c), cls)
    assert tree.map_to_pdf((1, 2, 3), 1) == 9
    assert tree.map_to_pdf((3, 2, 3), 1) == 4
    assert tree.map_to_pdf((1, 0, 3), 1) is None


def _assert_same_image(got, want):
    for f in ("num_phones", "num_biphones", "num_triphones", "num_states",
              "phone_names"):
        assert getattr(got, f) == getattr(want, f), f
    for f in IMAGE_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_build_image_and_minting_cli_match_jax(kaldi, tmp_path):
    names = graph.timit48_phone_names(str(kaldi / "phones.map"))
    assert names == j_graph.timit48_phone_names(str(kaldi / "phones.map"))
    assert names == ["sil", "aa", "b"]
    tree, tm = load_tree(str(kaldi / "tree")), load_transition_model(
        str(kaldi / "final.mdl"))
    jtree, jtm = j_load_tree(str(kaldi / "tree")), j_load_transition_model(
        str(kaldi / "final.mdl"))
    img = graph.build_image(tree, tm, names)
    _assert_same_image(img, j_graph.build_image(jtree, jtm, names))
    assert img.num_triphones == 27
    lm = np.log(np.random.default_rng(1).dirichlet(np.ones(3), 3))
    _assert_same_image(graph.build_image(tree, tm, names, lm=lm),
                       j_graph.build_image(jtree, jtm, names, lm=lm))

    mlf = tmp_path / "ref.mlf"
    mlf.write_text('#!MLF!#\n"*/u1.lab"\n0 1 sil\n1 2 aa\n2 3 b\n3 4 aa\n'
                   '.\n"*/u2.lab"\n0 1 b\n1 2 b\n2 3 sil\n.\n')
    files = ["--tree", kaldi / "tree", "--mdl", kaldi / "final.mdl",
             "--phone-map", kaldi / "phones.map", "--lm-from-mlf", mlf]
    got = graph.main(["--out", tmp_path / "t.img"] + files)
    want = j_graph.main(["--out", tmp_path / "j.img"] + files)
    _assert_same_image(got, want)
    assert (tmp_path / "t.img").read_bytes() == \
        (tmp_path / "j.img").read_bytes()


@pytest.mark.parametrize("phones,seed", [(4, 0), (6, 3)])
def test_cube_names_and_bigram_lm_match_jax(tmp_path, phones, seed):
    img = make_synthetic_image(num_phones=phones, seed=seed)
    jimg = j_make_synthetic_image(num_phones=phones, seed=seed)
    names = graph.cube_phone_names(img)
    assert names == j_graph.cube_phone_names(jimg) == [
        f"p{p}" for p in range(phones)]
    rng = np.random.default_rng(seed)
    words = {f"u{i}": [f"p{v}" for v in rng.integers(0, phones, 9)]
             for i in range(6)}
    pm = tmp_path / "map"
    pm.write_text("".join(f"x{p} p{p} p{p % 3}\n" for p in range(phones)))
    for pm_file in (None, str(pm)):
        lm = graph.estimate_bigram_lm(words, names, pm_file, add_k=0.5)
        want = j_graph.estimate_bigram_lm(words, names, pm_file, add_k=0.5)
        assert lm.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(lm, want)
        _assert_same_image(graph.image_with_bigram_lm(img, lm),
                           j_graph.image_with_bigram_lm(jimg, want))
    with pytest.raises(ValueError, match="lm shape"):
        graph.image_with_bigram_lm(img, np.zeros((phones, phones + 1)))


# ---- evaluate --lm-from-mlf ---------------------------------------------------

@pytest.fixture(scope="module")
def lm_tree(tmp_path_factory):
    """A synth_data tree (5 phones, dim 16, a cube image) and an FF net
    the port trained on it (so the decode follows the data and the LM
    decides between phones)."""
    root = tmp_path_factory.mktemp("lm_tree")
    j_synth(["--root", root, "--num-phones", 5, "--dim", 16,
             "--num-train", 12, "--num-dev", 2, "--num-test", 5,
             "--noise", 0.5, "--seed", 2])
    train_cli.main(["-n", "ff", "-l", "1", "-u", "32", "--num-classes", "17",
                    "-e", "1", "-o", "adam", "-b", "32", "--early-stopping",
                    "false", "--noplot", "--data-dir", root / "data",
                    "--offset-dir", root / "data", "--target-dir",
                    root / "data", "--out", root / "ff", "--device", "cpu"])
    return root


def lm_eval_args(root, decoder="tpu"):
    return ["-n", "ff", "-l", "1", "-u", "32", "--num-classes", "17",
            "--model", root / "ff" / "model", "--data-dir", root / "data",
            "--offset-dir", root / "data", "--utt-list-dir", root / "data",
            "--recog-dir", root / "recog", "--PIP", "5", "--decoder",
            decoder, "--lm-from-mlf", root / "recog" / "dev_ref.mlf",
            root / "recog" / "test_ref.mlf"]


def test_evaluate_lm_from_mlf_writes_jax_mlf(lm_tree, tmp_path):
    per_j = j_evaluate.main(lm_eval_args(lm_tree)
                            + ["--out-mlf", tmp_path / "j.mlf"])
    per_t = evaluate.main(lm_eval_args(lm_tree)
                          + ["--out-mlf", tmp_path / "t.mlf",
                             "--device", "cpu"])
    text = (tmp_path / "j.mlf").read_text()
    assert text.count('"*/') == 5
    assert (tmp_path / "t.mlf").read_text() == text
    assert per_t == per_j
    # the estimated LM changes the decode against the image's own LM
    args = lm_eval_args(lm_tree)[:-3]
    evaluate.main(args + ["--out-mlf", tmp_path / "own.mlf",
                          "--device", "cpu"])
    assert load_mlf(str(tmp_path / "own.mlf")) != load_mlf(
        str(tmp_path / "t.mlf"))
