"""The port's fold generation and six-phase master pipeline against the
JAX package's.

- ``generate_folds``: the same argv and seed write byte-identical
  ``.npy`` files (an empty fold included) and an ``utt_idx.npz`` with the
  same arrays under the same names (a zip member also carries its write
  time, so the archive's bytes are not compared).
- The master pipeline on ``tests/test_pipeline.py``'s tiny corpus (5
  phones, dim 16, 40/12/10 utterances): the JAX ``master.main`` with
  ``--num-folds 2 --gen-folds`` and a small FF spec runs all six phases;
  the port's ``master.main --no-train-master --no-train-folds`` on a copy
  of that results tree runs phases 4-6 (predict the fold outputs, train
  the RPL, evaluate the 2^3 sweep) on the JAX-trained nets and must
  return the same six PER values, its fold outputs within atol 1e-5 of
  JAX's. The port's own six-phase run returns six finite PERs.
"""

import shutil

import numpy as np
import pytest

from nnacousticmodeling_tpu.pipeline.generate_folds import (
    main as j_generate_folds,
)
from nnacousticmodeling_tpu.pipeline.master import main as j_master
from nnacousticmodeling_tpu.pipeline.synth_data import main as j_synth
from nnacousticmodeling_tpu_torch.pipeline import evaluate
from nnacousticmodeling_tpu_torch.pipeline.generate_folds import (
    main as generate_folds,
)
from nnacousticmodeling_tpu_torch.pipeline.master import main as master

TAGS = ["-folds +master -rpl", "-folds +master +rpl", "+folds -master -rpl",
        "+folds -master +rpl", "+folds +master -rpl", "+folds +master +rpl"]


# ---- generate_folds ---------------------------------------------------------

@pytest.fixture
def fold_corpus(tmp_path):
    """12 utterances of 3 speakers each of 4, 3 + 1..12 frames, with
    i-vectors."""
    d = tmp_path / "data"
    d.mkdir()
    names = [f"SPK{u % 4}X_SX{u}" for u in range(12)]
    (d / "train.list").write_text("\n".join(names) + "\n")
    lens = 3 + np.arange(1, 13)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    rng = np.random.default_rng(0)
    np.save(d / "data_train.npy",
            rng.standard_normal((off[-1], 5)).astype(np.float32))
    np.save(d / "offsets_train.npy", off)
    np.save(d / "targets_train.npy", np.arange(off[-1], dtype=np.int32))
    iv = tmp_path / "iv"
    iv.mkdir()
    np.save(iv / "ivectors_train.npy",
            rng.standard_normal((off[-1], 3)).astype(np.float32))
    return tmp_path


def _gen_args(root, out, n, seed):
    return ["-n", n, "--data-dir", root / "data",
            "--offset-dir", root / "data", "--target-dir", root / "data",
            "--utt-list-dir", root / "data", "--ivector-dir", root / "iv",
            "--fold-data-dir", out, "--seed", seed]


@pytest.mark.parametrize("n,seed", [(2, 0), (3, 1), (5, 0)])
def test_generate_folds_byte_identical(fold_corpus, n, seed):
    root = fold_corpus
    j_generate_folds(_gen_args(root, root / "j", n, seed))
    generate_folds(_gen_args(root, root / "t", n, seed))
    names = sorted(p.name for p in (root / "j").iterdir())
    assert names == sorted(p.name for p in (root / "t").iterdir())
    assert len(names) == 4 * n + 1
    for name in names:
        if name.endswith(".npy"):
            assert (root / "t" / name).read_bytes() == \
                (root / "j" / name).read_bytes(), name
    with np.load(root / "j" / "utt_idx.npz") as a, \
            np.load(root / "t" / "utt_idx.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    sizes = [len(np.load(root / "t" / f"offsets_{k}.npy")) - 1
             for k in range(n)]
    assert sum(sizes) == 12
    if n == 5:      # 4 speakers over 5 folds: at least one fold is empty
        k = sizes.index(0)
        assert np.load(root / "t" / f"data_{k}.npy").shape == (0, 5)
        assert np.load(root / "t" / f"ivectors_{k}.npy").shape == (0, 3)
        assert np.load(root / "t" / f"targets_{k}.npy").shape == (0,)
        np.testing.assert_array_equal(
            np.load(root / "t" / f"offsets_{k}.npy"), [0])


def test_generate_folds_reuses_index_and_checks_list(fold_corpus):
    root = fold_corpus
    generate_folds(_gen_args(root, root / "t", 2, 0))
    first = np.load(root / "t" / "data_0.npy")
    generate_folds(_gen_args(root, root / "t", 2, 123))
    np.testing.assert_array_equal(np.load(root / "t" / "data_0.npy"), first)
    (root / "data" / "train.list").write_text("ONLY1_SX1\n")
    with pytest.raises(ValueError, match="mismatch"):
        generate_folds(_gen_args(root, root / "u", 2, 0))


# ---- the master pipeline ---------------------------------------------------

@pytest.fixture(scope="module")
def corpus_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("master")
    j_synth(["--root", root, "--num-phones", 5, "--dim", 16,
             "--num-train", 40, "--num-dev", 12, "--num-test", 10,
             "--noise", 0.5, "--seed", 1])
    return root


def _master_args(root, out, tag):
    return ["--num-folds", "2",
            "--data-dir", f"{root}/data", "--offset-dir", f"{root}/data",
            "--target-dir", f"{root}/data", "--utt-list-dir", f"{root}/data",
            "--recog-dir", f"{root}/recog", "--output-dir", out,
            "--output-id", tag,
            "--network-spec=-n ff -l 2 -u 32 --splice 2",
            "--rpl-train-setup=-b 256 --epoch 2 -o adam --early-stopping "
            "false",
            "--epoch", "2", "-o", "adam", "-b", "128",
            "--early-stopping", "false", "--PIP", "5", "--seed", "0",
            "--num-classes", "17", "--eval-data", "test"]


@pytest.fixture(scope="module")
def jax_run(corpus_root):
    """The JAX master's six phases: the nets the port's phases 4-6 use."""
    out = corpus_root / "results_jax"
    return out, j_master(_master_args(corpus_root, out, "m") + ["--gen-folds"])


def test_master_phases_4_to_6_on_jax_models_give_jax_pers(corpus_root,
                                                          jax_run):
    out_j, pers_j = jax_run
    assert sorted(k[1] for k in pers_j) == sorted(TAGS)
    out_t = corpus_root / "results_port"
    shutil.copytree(out_j, out_t)
    pers_t = master(_master_args(corpus_root, out_t, "m")
                    + ["--no-train-master", "--no-train-folds",
                       "--device", "cpu"])
    assert pers_t == pers_j
    # phase 4 rewrote the fold outputs; they are JAX's within 1e-5
    for name in ("data_0.npy", "data_1.npy", "data_dev.npy"):
        got = np.load(out_t / "fold_data_out" / "2" / "m" / name)
        want = np.load(out_j / "fold_data_out" / "2" / "m" / name)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=name)
    # phase 5 retrained the RPL from its deterministic init
    got = np.load(out_t / "models" / "rpl" / "2" / "m" / "model.npz")
    want = np.load(out_j / "models" / "rpl" / "2" / "m" / "model.npz")
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0)


def test_port_master_runs_all_six_phases(corpus_root, monkeypatch,
                                         tmp_path):
    monkeypatch.chdir(tmp_path)
    out = corpus_root / "results_port_full"
    pers = master(_master_args(corpus_root, out, "p")
                  + ["--gen-folds", "--device", "cpu"])
    assert sorted(k[1] for k in pers) == sorted(TAGS)
    assert all(k[0] == "test" and np.isfinite(v) and 0 <= v <= 100
               for k, v in pers.items())
    for rel in ("fold_data/2/data/utt_idx.npz", "fold_data_out/2/p/data_dev.npy",
                "models/folds/2/p/fold_1.npz", "models/master/2/p/model.npz",
                "models/rpl/2/p/model.npz"):
        assert (out / rel).is_file(), rel
    assert not (tmp_path / "result_fold_tmp").exists()


def test_master_without_folds_evaluates_the_master_alone(corpus_root):
    args = _master_args(corpus_root, corpus_root / "results_mo", "mo")
    args[args.index("--num-folds") + 1] = "0"
    pers = master(args + ["--device", "cpu", "--eval-only-master"])
    assert list(pers) == [("test", "-folds +master -rpl")]


@pytest.mark.parametrize("extra,match", [
    (["--fold-parallel", "--mesh", "fold=2"], "need 2 ranks, have 1"),
    (["--mesh", "fold=2"], "need 2 ranks, have 1"),
])
def test_master_unported_options_raise(corpus_root, tmp_path, extra, match):
    """A ``--mesh`` larger than the world (one rank here) fails before
    any phase writes."""
    with pytest.raises(ValueError, match=match):
        master(_master_args(corpus_root, tmp_path, "x") + ["--device", "cpu"]
               + extra)
    assert not any(tmp_path.iterdir())


def test_evaluate_native_decoder_raises(corpus_root, jax_run, tmp_path,
                                       monkeypatch):
    """With no toolchain to build the native decoder, ``evaluate
    --decoder native`` raises instead of decoding on another route."""
    from nnacousticmodeling_tpu_torch.decoder import native
    out_j, _ = jax_run
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "lib.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no native toolchain"):
        evaluate.main([
            "-n", "ff", "-l", "2", "-u", "32", "--splice", "2",
            "--num-classes", "17",
            "--model", out_j / "models" / "master" / "2" / "m" / "model",
            "--data-dir", f"{corpus_root}/data",
            "--offset-dir", f"{corpus_root}/data",
            "--utt-list-dir", f"{corpus_root}/data",
            "--recog-dir", f"{corpus_root}/recog", "--PIP", "5",
            "--decoder", "native", "--device", "cpu"])
