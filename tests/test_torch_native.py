"""The port's native decoder (``decoder/native.py``) and ``evaluate
--decoder native`` against the JAX package's.

``build_native`` compiles ``native/``'s library into ``build/native/``
with one ``g++`` call, again when a source changes. On a synthetic tied image,
the port's ``NativeDecoder`` gives the JAX ``NativeDecoder``'s segments
and the port's own decoder's, exact and with a beam; ``decode_batch``
equals sequential decoding; bad shapes raise; ``evaluate --decoder
native`` (and with ``--lm-from-mlf``) writes the JAX CLI's MLF.
"""

import shutil

import numpy as np
import pytest

from nnacousticmodeling_tpu.decoder.native import (
    NativeDecoder as JNativeDecoder,
)
from nnacousticmodeling_tpu.decoder.native import (
    build_native as j_build_native,
)
from nnacousticmodeling_tpu.pipeline import evaluate as j_evaluate
from nnacousticmodeling_tpu.pipeline.synth_data import main as j_synth
from nnacousticmodeling_tpu_torch.decoder import native
from nnacousticmodeling_tpu_torch.decoder.image import (
    make_synthetic_image, save_image,
)
from nnacousticmodeling_tpu_torch.decoder.native import NativeDecoder
from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
from nnacousticmodeling_tpu_torch.io import save_bin
from nnacousticmodeling_tpu_torch.pipeline import evaluate, train_cli

LENGTHS = [35, 50, 8, 22, 1]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(11)
    img = make_synthetic_image(num_phones=4, num_states=25, seed=11)
    save_image(str(tmp / "syn.img"), img)
    posteriors = [np.log(rng.dirichlet(np.ones(25), size=t)).astype(
        np.float32) for t in LENGTHS]
    lines = []
    for i, lp in enumerate(posteriors):
        save_bin(str(tmp / f"u{i}.lab"), lp)
        lines.append(str(tmp / f"u{i}.lab"))
    (tmp / "t.scp").write_text("\n".join(lines) + "\n")
    return tmp, img, posteriors


def test_library_lands_in_build_native():
    lib = native.build_native()
    assert lib == native.REPO / "build" / "native" / "libnnam_decoder.so"
    assert lib.is_file()
    assert (native.BUILD_DIR / "sources.sha256").read_text() == \
        native._source_hash()
    assert native.build_native() == lib          # built: a no-op


def test_changed_source_rebuilds(tmp_path, monkeypatch):
    """The stamp holds the sources' hash: an unchanged tree is not
    rebuilt, a changed source is."""
    src = tmp_path / "native"
    shutil.copytree(native.NATIVE_DIR, src,
                    ignore=shutil.ignore_patterns("build*"))
    out = tmp_path / "out"
    monkeypatch.setattr(native, "NATIVE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", out)
    monkeypatch.setattr(native, "LIB_PATH", out / "libnnam_decoder.so")
    lib = native.build_native()
    first = lib.stat().st_mtime_ns
    assert native.build_native() == lib
    assert lib.stat().st_mtime_ns == first
    with open(src / "src" / "decoder.cc", "a") as f:
        f.write("\n// changed\n")
    assert (out / "sources.sha256").read_text() != native._source_hash()
    native.build_native()
    assert lib.stat().st_mtime_ns != first
    assert (out / "sources.sha256").read_text() == native._source_hash()


@pytest.mark.parametrize("beam", [None, 6.0])
def test_segments_match_jax_and_the_port_decoder(setup, beam):
    tmp, img, posteriors = setup
    nat = NativeDecoder(str(tmp / "syn.img"), pip=20.0, lmw=1.0, beam=beam)
    jnat = JNativeDecoder(str(tmp / "syn.img"), pip=20.0, lmw=1.0,
                          beam=beam)
    dec = ViterbiDecoder(img, pip=20.0, lmw=1.0, beam=beam, device="cpu")
    for lp in posteriors:
        got = nat.decode_one(lp).segments
        assert got == jnat.decode_one(lp).segments
        assert got == dec.decode_one(lp).segments
        assert got
    assert nat.skipped_updates == jnat.skipped_updates
    assert (nat.skipped_updates > 0) == (beam is not None)


def test_decode_batch_equals_sequential(setup):
    tmp, _, posteriors = setup
    nat = NativeDecoder(str(tmp / "syn.img"), pip=5.0, lmw=2.0)
    seq = [nat.decode_one(lp).segments for lp in posteriors]
    batch = nat.decode_batch(posteriors * 6, n_threads=4)
    assert [r.segments for r in batch] == seq * 6
    assert [r.segments for r in nat.decode_batch(posteriors[:1])] == seq[:1]


def test_bad_shapes_and_images_raise(setup, tmp_path):
    tmp, _, _ = setup
    nat = NativeDecoder(str(tmp / "syn.img"))
    with pytest.raises(ValueError, match="columns"):
        nat.decode_one(np.zeros((5, 7), dtype=np.float32))
    with pytest.raises(ValueError, match=r"\(T, S\)"):
        nat.decode_one(np.zeros(25, dtype=np.float32))
    with pytest.raises(RuntimeError, match="cannot load image"):
        NativeDecoder(str(tmp_path / "missing.img"))


def test_gxx_build_without_cmake(setup, tmp_path, monkeypatch):
    """With cmake and ninja off PATH, g++ builds the library from
    CMakeLists.txt's sources, and it decodes as the JAX package's."""
    tmp, _, posteriors = setup
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libnnam_decoder.so")
    real_which = native.shutil.which
    monkeypatch.setattr(native.shutil, "which", lambda name: (
        None if name in ("cmake", "ninja") else real_which(name)))
    assert native.build_native() == tmp_path / "libnnam_decoder.so"
    assert not (tmp_path / "build.ninja").exists()
    want = JNativeDecoder(str(tmp / "syn.img"))
    nat = NativeDecoder(str(tmp / "syn.img"))
    for lp in posteriors:
        assert nat.decode_one(lp).segments == want.decode_one(lp).segments


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """A synth_data tree (5 phones, dim 16) and an FF net the port
    trained on it for one epoch."""
    root = tmp_path_factory.mktemp("native_eval")
    j_synth(["--root", root, "--num-phones", 5, "--dim", 16,
             "--num-train", 12, "--num-dev", 2, "--num-test", 5,
             "--noise", 0.5, "--seed", 4])
    train_cli.main(["-n", "ff", "-l", "1", "-u", "32", "--num-classes", "17",
                    "-e", "1", "-o", "adam", "-b", "32", "--early-stopping",
                    "false", "--noplot", "--data-dir", root / "data",
                    "--offset-dir", root / "data", "--target-dir",
                    root / "data", "--out", root / "ff", "--device", "cpu"])
    return root


@pytest.mark.parametrize("lm", [False, True], ids=["image-lm", "lm-from-mlf"])
def test_evaluate_native_writes_jax_mlf(eval_tree, tmp_path, lm):
    root = eval_tree
    if not j_build_native():
        pytest.skip("the JAX package's native build needs cmake + ninja")
    args = ["-n", "ff", "-l", "1", "-u", "32", "--num-classes", "17",
            "--model", root / "ff" / "model", "--data-dir", root / "data",
            "--offset-dir", root / "data", "--utt-list-dir", root / "data",
            "--recog-dir", root / "recog", "--PIP", "5", "--decoder",
            "native"]
    if lm:
        args += ["--lm-from-mlf", root / "recog" / "dev_ref.mlf"]
    per_j = j_evaluate.main(args + ["--out-mlf", tmp_path / "j.mlf"])
    per_t = evaluate.main(args + ["--device", "cpu",
                                  "--out-mlf", tmp_path / "t.mlf"])
    text = (tmp_path / "j.mlf").read_text()
    assert text.count('"*/') == 5
    assert (tmp_path / "t.mlf").read_text() == text
    assert per_t == per_j
    # the port's card decoder (its plain version here) agrees
    evaluate.main(args[:args.index("--decoder")]
                  + args[args.index("--decoder") + 2:]
                  + ["--device", "cpu", "--out-mlf", tmp_path / "c.mlf"])
    assert (tmp_path / "c.mlf").read_text() == text
