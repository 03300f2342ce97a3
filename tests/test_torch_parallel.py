"""The port's ``parallel/`` and ``utils/profiling.py`` in one process.

``parse_mesh_spec`` and ``_stage_bounds`` against the JAX package's on
the same inputs, errors included; the ``make_mesh`` rule (the axes must
multiply to the world size; a one-rank mesh needs no process group);
``param_shardings`` against JAX's spec leaf by leaf at ``model=2``, the
recurrent cells' leaves excepted (replicated in the port: the
recurrence kernels read them whole); ``PipelinedMLP``'s restrictions;
one-rank meshes through ``train_network`` and ``train_folds_parallel``,
bit-equal to the runs without one; the helpers without a world;
``Stopwatch`` as ``tests/test_ops.py`` uses it; ``trace`` writing a
trace file on the CPU. The multi-rank paths are in
``tests/test_torch_distributed.py``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu.models import get_network as j_get_network
from nnacousticmodeling_tpu.parallel import make_mesh as j_make_mesh
from nnacousticmodeling_tpu.parallel import param_shardings as j_shardings
from nnacousticmodeling_tpu.parallel import parse_mesh_spec as j_parse
from nnacousticmodeling_tpu.parallel.pipeline import (
    _stage_bounds as j_stage_bounds,
)
from nnacousticmodeling_tpu_torch.models import get_network
from nnacousticmodeling_tpu_torch.parallel import (
    global_batch_array, local_batch_slice, make_mesh, param_shardings,
    parse_mesh_spec, replicated_array, sync,
)
from nnacousticmodeling_tpu_torch.parallel.distributed import _pick_backend
from nnacousticmodeling_tpu_torch.parallel.mesh import Mesh, shard_net
from nnacousticmodeling_tpu_torch.parallel.pipeline import (
    PipelinedMLP, _stage_bounds,
)
from nnacousticmodeling_tpu_torch.train import TrainConfig, TrainStage
from nnacousticmodeling_tpu_torch.train import train_network
from nnacousticmodeling_tpu_torch.train.fold_parallel import (
    train_folds_parallel,
)
from nnacousticmodeling_tpu_torch.utils.profiling import Stopwatch, trace

SPECS = ["data=8", "data=4,model=2", "fold=2, data=4", " data = 2 ,", "data",
         "", ",", "data=x", "a=1,b=2,a=3"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = j_parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(spec)
        assert str(got.value) == str(e)
        return
    got = parse_mesh_spec(spec)
    assert got == want and list(got) == list(want)


def test_stage_bounds_match_jax():
    for n in range(1, 12):
        for s in range(1, n + 1):
            b, m = _stage_bounds(n, s)
            jb, jm = j_stage_bounds(n, s)
            np.testing.assert_array_equal(b, jb)
            assert m == jm


def test_make_mesh_rule():
    with pytest.raises(ValueError, match="need 2 ranks, have 1"):
        make_mesh({"data": 2})
    with pytest.raises(ValueError, match="need 8 ranks, have 1"):
        make_mesh({"data": 4, "model": 2})
    mesh = make_mesh({"data": 1, "model": 1})
    assert mesh.axis_names == ("data", "model") and mesh.shape == (1, 1)
    assert mesh.coords == {"data": 0, "model": 0}
    assert mesh.device_mesh is None and mesh.group("data") is None


@pytest.mark.parametrize("name", ["ff", "tdnn", "lstm", "gru", "mgrurelur",
                                  "peepholelstm"])
def test_param_shardings_match_jax(name):
    """Leaf by leaf at model=2 (12 classes: ``out`` splits; 9 does not);
    the recurrent cells' leaves are replicated in the port."""
    for classes in (12, 9):
        kw = dict(tdnn_ksize=(3, 3)) if name == "tdnn" else {}
        units = [16, 8] if name == "tdnn" else [16]
        jnet = j_get_network(name, 2 if name != "tdnn" else 2, units,
                             classes, **kw)
        jp = jnet.init(jax.random.PRNGKey(0), 10)
        want = j_shardings(j_make_mesh({"data": 4, "model": 2}), jp,
                           model_axis="model")
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): tuple(s.spec) for path, s in flat}
        net = get_network(name, 2, units, classes, in_dim=10, device="cpu",
                          **kw)
        got = param_shardings(Mesh({"model": 2}), net.state_dict(), "model")
        assert sorted(got) == sorted(want)
        for k, spec in want.items():
            if k.startswith("cells."):
                assert got[k] == (), k
            else:
                assert got[k] == spec, k
        assert (got["out.w"] == (None, "model")) == (classes == 12)
        assert param_shardings(Mesh({"model": 2}), net.state_dict()) == {
            k: () for k in want}


def test_shard_net_needs_a_model_axis_above_one():
    net = get_network("ff", 2, [8], 4, in_dim=3, device="cpu")
    before = {k: v.clone() for k, v in net.state_dict().items()}
    assert shard_net(net, Mesh({"data": 1, "model": 1}), "model") == {}
    assert shard_net(net, Mesh({"data": 1}), None) == {}
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k])


def test_pipelined_mlp_restrictions():
    net = get_network("ff", 3, [8], 4, in_dim=3, device="cpu")
    params = net.state_dict()
    x = torch.zeros(8, 3)
    with pytest.raises(ValueError, match="3 layers < 4 stages"):
        PipelinedMLP(net, Mesh({"stage": 4})).apply(params, x)
    with pytest.raises(ValueError, match="batch 8 not divisible by 3"):
        PipelinedMLP(net, Mesh({"stage": 2}), num_micro=3).apply(params, x)
    drop = get_network("ff", 3, [8], 4, dropout=[0.1], in_dim=3,
                       device="cpu")
    with pytest.raises(NotImplementedError, match="pipelined dropout"):
        PipelinedMLP(drop, Mesh({"stage": 2})).apply(params, x, train=True)
    assert PipelinedMLP(net, Mesh({"stage": 2})).stage_layers(0) == [0, 1]
    assert PipelinedMLP(net, Mesh({"stage": 2})).stage_layers(1) == [2]


def test_pipelined_mlp_one_stage_equals_apply():
    net = get_network("ff", 3, [8], 4, in_dim=3, device="cpu")
    x = torch.randn(8, 3, generator=torch.Generator().manual_seed(0))
    got = PipelinedMLP(net, make_mesh({"stage": 1})).apply(
        net.state_dict(), x)
    np.testing.assert_allclose(got.detach().numpy(),
                               net.apply(x).detach().numpy(), atol=1e-6)


def _data(n=400, dim=6, classes=5):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, dim)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32))


@pytest.mark.parametrize("name", ["lstm", "ff", "tdnn"])
def test_one_rank_mesh_train_network_equals_plain(name):
    x, y = _data()
    offsets = np.array([0, 100, 250, 400])
    runs = []
    for mesh in (None, make_mesh({"data": 1, "model": 1})):
        net = get_network(name, 2, [8, 8], 5, tdnn_ksize=(1, 1), in_dim=6,
                          device="cpu")
        cfg = TrainConfig(stages=[TrainStage(2, "adam", 4, 1e-3, False)],
                          bprop_len=5, log=None, mesh=mesh,
                          model_axis="model" if mesh else None)
        runs.append(train_network(net, x, y, cfg, offsets=offsets,
                                  x_dev=x[:50], y_dev=y[:50], device="cpu"))
    a, b = runs
    assert [h["main/loss"] for h in a.history] == \
        [h["main/loss"] for h in b.history]
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def test_one_rank_mesh_snapshot_resume(tmp_path):
    """A one-rank mesh run's snapshot resumes to the uninterrupted
    run's params."""
    x, y = _data()
    offsets = np.array([0, 100, 250, 400])
    stages = [TrainStage(2, "adam", 4, 1e-3, False)]

    def run(snap, resume, epochs):
        net = get_network("lstm", 1, [8], 5, in_dim=6, device="cpu")
        cfg = TrainConfig(stages=[TrainStage(epochs, "adam", 4, 1e-3,
                                             False)],
                          bprop_len=5, log=None, snapshot_path=str(snap),
                          resume_snapshot=resume,
                          mesh=make_mesh({"data": 1}))
        return train_network(net, x, y, cfg, offsets=offsets, device="cpu")

    full = run(tmp_path / "full.npz", False, stages[0].epoch)
    run(tmp_path / "part.npz", False, 1)
    resumed = run(tmp_path / "part.npz", True, stages[0].epoch)
    for k in full.params:
        assert torch.equal(full.params[k], resumed.params[k]), k


@pytest.mark.parametrize("name", ["lstm", "ff"])
def test_one_rank_mesh_fold_training_equals_plain(name):
    x, y = _data(600)
    offsets = np.arange(0, 601, 50)
    utt_folds = np.arange(12) % 3
    runs = []
    for mesh in (None, make_mesh({"fold": 1, "data": 1})):
        net = get_network(name, 1, [8], 5, in_dim=6, device="cpu")
        cfg = TrainConfig(stages=[TrainStage(2, "adam", 4, 1e-3, True)],
                          bprop_len=5, log=None)
        runs.append(train_folds_parallel(
            net, x, y, offsets, utt_folds, 3, cfg, x_dev=x[:40],
            y_dev=y[:40], device="cpu", mesh=mesh))
    for a, b in zip(*runs):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_helpers_without_a_world():
    assert local_batch_slice(16) == slice(0, 16)
    mesh = make_mesh({"data": 1})
    t = torch.arange(6.0)
    assert global_batch_array(mesh, t) is t
    assert replicated_array(mesh, t) is t
    sync("no world")
    assert _pick_backend(1, "cpu") == "gloo"
    if not torch.cuda.is_available():
        assert _pick_backend(2, "cuda") == "gloo"


@pytest.mark.parametrize("env,cards,want", [
    ({"WORLD_SIZE": "16", "LOCAL_WORLD_SIZE": "8"}, 8, "nccl"),
    ({"WORLD_SIZE": "16"}, 8, "gloo"),
    ({"WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2"}, 1, "gloo"),
])
def test_pick_backend_counts_the_ranks_of_this_node(monkeypatch, env, cards,
                                                    want):
    """nccl when the ranks of this node (torchrun's ``LOCAL_WORLD_SIZE``,
    else the world) fit its cards: 2 nodes x 8 cards is an nccl world."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert _pick_backend(int(env["WORLD_SIZE"]), "cuda") == want


def test_stopwatch():
    sw = Stopwatch()
    with sw("a"):
        pass
    with sw("a"):
        pass
    with sw("b"):
        pass
    assert sw.counts["a"] == 2 and sw.counts["b"] == 1
    assert "a:" in sw.report()


def test_trace_writes_a_trace_file(tmp_path):
    net = get_network("ff", 1, [8], 4, in_dim=3, device="cpu")
    with trace(str(tmp_path)) as prof:
        net.apply(torch.zeros(4, 3))
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::matmul" in str(e.get("name")) for e in events)
    assert prof.key_averages()
