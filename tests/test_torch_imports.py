"""The port stands alone and defaults to the card.

Every module of ``nnacousticmodeling_tpu_torch``, ``chip_smoke.py`` and
the port's ``bench_*.py`` scripts imports neither JAX nor the JAX package (an AST scan, so nothing is
imported to find out). Entry points called without ``device="cpu"``
run on CUDA: on a machine without a card they raise instead of running
on the CPU.
"""

import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import nnacousticmodeling_tpu_torch as port
from nnacousticmodeling_tpu_torch.decoder.image import make_synthetic_image
from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
from nnacousticmodeling_tpu_torch.decoder.viterbi_collapsed import (
    CollapsedViterbi,
)
from nnacousticmodeling_tpu_torch.decoder.viterbi_cube import CubeViterbi
from nnacousticmodeling_tpu_torch.models import get_network, get_rpl
from nnacousticmodeling_tpu_torch.parallel import (
    make_mesh,
    make_sharded_train_step,
)
from nnacousticmodeling_tpu_torch.parallel.pipeline import PipelinedMLP
from nnacousticmodeling_tpu_torch.ops.features import fbank, fbank_cuda, mfcc
from nnacousticmodeling_tpu_torch.pipeline import (
    evaluate,
    master,
    parity,
    predict_folds,
    train_cli,
)
from nnacousticmodeling_tpu_torch.train import (
    TrainConfig,
    TrainStage,
    load_jax_params,
    make_optimizer,
    train_network,
)
from nnacousticmodeling_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(Path(port.__file__).parent.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "nnacousticmodeling_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value.split(".")[0]


def test_port_files_found():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert "nnacousticmodeling_tpu_torch/ops/rnn_cuda.py" in names
    assert "nnacousticmodeling_tpu_torch/decoder/viterbi_collapsed.py" in names
    for mod in ("train/engine.py", "train/stages.py", "train/streams.py",
                "train/optimizers.py", "models/precision.py",
                "models/cells.py", "models/networks.py",
                "ops/timedelay.py", "pipeline/train_cli.py",
                "decoder/viterbi_cube.py", "ops/features.py",
                "pipeline/synth_data.py", "models/rpl.py",
                "models/ensemble.py", "pipeline/generate_folds.py",
                "pipeline/predict_folds.py", "pipeline/master.py",
                "train/fold_parallel.py", "decoder/native.py",
                "decoder/graph.py", "io/binio.py", "io/kaldi_mdl.py",
                "io/kaldi_tree.py", "models/convert.py", "models/ctc.py",
                "pipeline/parity.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/pipeline.py",
                "parallel/distributed.py", "parallel/comm.py",
                "utils/profiling.py", "decoder/viterbi_scan.py"):
        assert f"nnacousticmodeling_tpu_torch/{mod}" in names
    for src in ("gated_persistent.cuh", "gated_scan.cu", "gated_train.cu",
                "peephole_persistent.cuh", "peephole_scan.cu",
                "peephole_train.cu", "viterbi_cube.cu", "fbank.cu",
                "viterbi_scan.cu"):
        assert (REPO / "nnacousticmodeling_tpu_torch" / "csrc" / src).is_file()
    assert (REPO / "chip_smoke.py").is_file()


@pytest.mark.parametrize(
    "path", PORT_FILES + [REPO / "chip_smoke.py"]
    + sorted(REPO.glob("bench_*.py")),
    ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def _entry_points(tmp_path):
    img = make_synthetic_image(num_phones=3, seed=0,
                               pdf_tied_transitions=True)
    np.savez(tmp_path / "m.npz", **{"out/w": np.zeros((2, 2), np.float32)})
    return {
        "resolve_device": lambda: resolve_device(),
        "get_network": lambda: get_network("lstm", 1, [4], 5, in_dim=3),
        "get_network gru": lambda: get_network("gru", 1, [4], 5, in_dim=3),
        "get_network mgrurelur": lambda: get_network("mgrurelur", 1, [4], 5,
                                                     in_dim=3),
        "get_network peepholelstm": lambda: get_network(
            "peepholelstm", 1, [4], 5, in_dim=3),
        "get_network zoneoutlstm": lambda: get_network(
            "zoneoutlstm", 1, [4], 5, in_dim=3),
        "get_network zoneoutdropoutlstm": lambda: get_network(
            "zoneoutdropoutlstm", 1, [4], 5, in_dim=3),
        "get_network ff": lambda: get_network("ff", 1, [4], 5, in_dim=3),
        "get_network tdnn": lambda: get_network("tdnn", 1, [4], 5,
                                                tdnn_ksize=(3,), in_dim=3),
        "get_rpl": lambda: get_rpl(4, 5),
        "ViterbiDecoder": lambda: ViterbiDecoder(img),
        "ViterbiDecoder pallas": lambda: ViterbiDecoder(img,
                                                        backend="pallas"),
        "CubeViterbi": lambda: CubeViterbi(img, "abc", pip=-5.0, lmw=1.0),
        "CollapsedViterbi": lambda: CollapsedViterbi(img, "abc", pip=-5.0,
                                                     lmw=1.0),
        "fbank": lambda: fbank(np.zeros(800, np.float32)),
        "fbank_cuda": lambda: fbank_cuda(np.zeros(800, np.float32)),
        "mfcc": lambda: mfcc(np.zeros(800, np.float32)),
        "load_jax_params": lambda: load_jax_params(tmp_path / "m.npz"),
        "evaluate.main": lambda: evaluate.main(
            ["-n", "lstm", "--recog-dir", str(tmp_path),
             "--data-dir", str(tmp_path)]),
        "train_cli.main": lambda: train_cli.main(
            ["-n", "lstm", "--data-dir", str(tmp_path),
             "--out", str(tmp_path / "out")]),
        "train_cli.main ff": lambda: train_cli.main(
            ["-n", "ff", "--data-dir", str(tmp_path),
             "--out", str(tmp_path / "out")]),
        "predict_folds.main": lambda: predict_folds.main(
            ["-n", "ff", "--fold-output-dir", str(tmp_path / "o"),
             "--fold-model-dir", str(tmp_path)]),
        "master.main": lambda: master.main(
            ["--output-dir", str(tmp_path / "results")]),
        "train_cli.main all folds": lambda: train_cli.main(
            ["-n", "lstm", "--train-all-folds", "--fold-data-dir",
             str(tmp_path), "--out", str(tmp_path / "out")]),
        "parity.main": lambda: parity.main(
            ["--checkpoint", str(tmp_path / "m.npz"), "-n", "lstm",
             "--data-dir", str(tmp_path)]),
        "train_network": lambda: train_network(
            get_network("lstm", 1, [4], 5, in_dim=3, device="cpu"),
            np.zeros((8, 3), np.float32), np.zeros(8, np.int32),
            TrainConfig(stages=[TrainStage(1, "sgd", 2, 0.1, False)],
                        log=None)),
        "make_sharded_train_step": lambda: make_sharded_train_step(
            get_network("ff", 1, [4], 5, in_dim=3),
            functools.partial(make_optimizer, "sgd", 0.1),
            make_mesh({"data": 1})),
        "PipelinedMLP.apply": lambda: PipelinedMLP(
            get_network("ff", 2, [4], 5, in_dim=3),
            make_mesh({"stage": 1})).apply({}, np.zeros((4, 3))),
        "train_cli.main --mesh": lambda: train_cli.main(
            ["-n", "lstm", "--mesh", "data=1", "--data-dir", str(tmp_path),
             "--out", str(tmp_path / "out")]),
    }


@pytest.mark.parametrize("name", ["resolve_device", "get_network",
                                  "get_network gru", "get_network mgrurelur",
                                  "get_network peepholelstm",
                                  "get_network zoneoutlstm",
                                  "get_network zoneoutdropoutlstm",
                                  "get_network ff", "get_network tdnn",
                                  "get_rpl",
                                  "ViterbiDecoder", "ViterbiDecoder pallas",
                                  "CubeViterbi", "CollapsedViterbi",
                                  "fbank", "fbank_cuda",
                                  "mfcc", "load_jax_params",
                                  "evaluate.main", "train_cli.main",
                                  "train_cli.main ff", "predict_folds.main",
                                  "master.main", "train_cli.main all folds",
                                  "parity.main", "train_network",
                                  "make_sharded_train_step",
                                  "PipelinedMLP.apply",
                                  "train_cli.main --mesh"])
def test_default_device_is_cuda(tmp_path, name):
    call = _entry_points(tmp_path)[name]
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_cpu_on_request():
    assert resolve_device("cpu").type == "cpu"
    for name in ("lstm", "gru", "mgrurelu", "mgrurelur", "peepholelstm",
                 "zoneoutlstm", "zoneoutdropoutlstm", "ff", "tdnn"):
        net = get_network(name, 1, [4], 5, tdnn_ksize=(3,), in_dim=3,
                          device="cpu")
        assert net.device.type == "cpu"
    for variant in range(5):
        assert get_rpl(variant, 5, device="cpu").device.type == "cpu"
