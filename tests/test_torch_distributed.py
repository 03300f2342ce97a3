"""The port's parallelism across ranks against the JAX package.

One module-scoped launch of 4 ranks (``gloo`` on the CPU, one process
each): the worker is this file's ``__main__`` block, which imports only
the port. The parent writes the inputs (JAX inits, seeded numpy data, a
corpus tree) to an ``.npz``; rank 0 writes its results to another; the
tests hold them against the JAX package on the same inits, run on the
virtual CPU devices of ``tests/conftest.py``:

* ``make_sharded_train_step`` at ``data=4`` (MLP) and ``data=2,model=2``
  (LSTM 2x16 -> 12 classes, so ``out`` splits over ``model``) against
  JAX's step on the same mesh (atol 1e-5), the first also fed
  row-sharded ``DTensor``s;
* ``train_network`` at ``data=4`` (MLP) and ``data=2,model=2`` (LSTM,
  TDNN) for 2 epochs against JAX ``train_network`` unsharded
  (``tests/test_engine_mesh.py``'s rtol 5e-4 / atol 5e-5);
* the LSTM at ``data=2,model=2`` trained 1 epoch with a snapshot, then
  resumed for the second (momentumsgd and adam: the column-parallel
  ``out`` leaves' optimizer buffers and the data-split stream state go
  through rank 0's whole snapshot), bit-equal to the uninterrupted
  2-epoch mesh run, the adam run also against JAX ``train_network``;
* ``train_folds_parallel`` at ``fold=2,data=2`` (K=4) against JAX
  ``train_folds_parallel`` on JAX's K inits;
* ``make_sharded_ensemble_forward`` at ``fold=4`` against the host sum;
* ``PipelinedMLP`` at ``stage=2`` / 4 microbatches and ``stage=4`` / 3
  (MLP 5x32): logits against JAX ``PipelinedMLP`` and ``net.apply``,
  gradients against ``jax.grad`` of the unpipelined MLP;
* ``local_batch_slice``, ``global_batch_array``, ``replicated_array``,
  ``sync``;
* ``train_cli --mesh data=2,model=2 --coordinator ... --num-processes 4
  --process-id r``: rank 0's ``model.npz`` (JAX ``load_pytree`` reads
  it) and losses against JAX ``train_cli --mesh data=2,model=2`` on the
  same tree, and against the port's one-process run;
* ``master --mesh data=2,model=2 --distributed`` over the 4 ranks (rank
  0 running the host phases): the six PERs and the four models of JAX
  ``master --mesh data=2,model=2``.

The port's CLIs draw their inits from ``torch``; the worker (and the
parent's one-process run) start every network the CLIs build from the
init JAX ``train_network`` draws from the same ``--seed``, so the CLI
runs can be held against the JAX CLIs. The RPL head's init is
deterministic in both packages.

Every rank's process group has a 60 s timeout and the launch one of
``LAUNCH_TIMEOUT_S``, after which every child is killed.
"""

import json
import os
import socket
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
LAUNCH_TIMEOUT_S = 240
CLI_CLASSES = 17
CLI_ARGS = ["-n", "lstm", "-l", "1", "-u", "16", "--num-classes",
            str(CLI_CLASSES), "-b", "4", "--bproplen", "5", "-o",
            "momentumsgd", "--lr", "0.05", "-e", "2", "--early-stopping",
            "false", "--noplot", "--device", "cpu"]


def _cli_args(tree, out):
    return CLI_ARGS + ["--data-dir", f"{tree}/data", "--offset-dir",
                       f"{tree}/data", "--target-dir", f"{tree}/data",
                       "--out", str(out)]


def _master_args(root, out):
    """``tests/test_torch_master.py``'s run (2 folds, FF 2x32 -> 17),
    momentumsgd throughout."""
    return ["--num-folds", "2", "--gen-folds",
            "--data-dir", f"{root}/data", "--offset-dir", f"{root}/data",
            "--target-dir", f"{root}/data", "--utt-list-dir", f"{root}/data",
            "--recog-dir", f"{root}/recog", "--output-dir", str(out),
            "--output-id", "m",
            "--network-spec=-n ff -l 2 -u 32 --splice 2",
            "--rpl-train-setup=-b 256 --epoch 2 -o momentumsgd --lr 0.01 "
            "--early-stopping false",
            "--epoch", "2", "-o", "momentumsgd", "--lr", "0.01", "-b", "128",
            "--early-stopping", "false", "--PIP", "5", "--seed", "0",
            "--num-classes", "17", "--eval-data", "test", "--device", "cpu"]


MASTER_MODELS = ("models/master/2/m/model.npz", "models/folds/2/m/fold_0.npz",
                 "models/folds/2/m/fold_1.npz", "models/rpl/2/m/model.npz")


# ---------------------------------------------------------------------------
# the worker (one rank; imports only the port)
# ---------------------------------------------------------------------------

def _worker(rank: int, work: Path) -> None:
    import functools

    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    torch.set_num_threads(1)
    sys.path.insert(0, str(REPO))
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.models.ensemble import (
        Ensemble, stack_fold_params)
    from nnacousticmodeling_tpu_torch.parallel import (
        global_batch_array, initialize_distributed, local_batch_slice,
        make_mesh, make_sharded_ensemble_forward, make_sharded_train_step,
        replicated_array, sync)
    from nnacousticmodeling_tpu_torch.parallel.comm import all_reduce_
    from nnacousticmodeling_tpu_torch.parallel.pipeline import PipelinedMLP
    from nnacousticmodeling_tpu_torch.pipeline import train_cli
    from nnacousticmodeling_tpu_torch.train import (
        TrainConfig, TrainStage, make_optimizer, train_network)
    from nnacousticmodeling_tpu_torch.train.fold_parallel import (
        train_folds_parallel)

    meta = json.loads((work / "meta.json").read_text())
    with np.load(work / "inputs.npz") as data:
        inp = {k: data[k] for k in data.files}

    def arr(name):
        return inp[name]

    def params(prefix):
        return {k[len(prefix) + 1:]: torch.from_numpy(v)
                for k, v in inp.items() if k.startswith(prefix + ":")}

    out = {}

    def put(prefix, tree):
        for k, v in tree.items():
            out[f"{prefix}:{k}"] = v.detach().cpu().numpy()

    initialize_distributed(f"localhost:{meta['port']}", WORLD, rank,
                           device="cpu")

    # ---- make_sharded_train_step ---------------------------------------
    mesh = make_mesh({"data": 4}, device="cpu")
    net = get_network("ff", 2, [32], 10, in_dim=12, device="cpu")
    opt = functools.partial(make_optimizer, "momentumsgd", 1e-2)
    step = make_sharded_train_step(net, opt, mesh)
    p0 = params("ff")
    xb, yb = torch.from_numpy(arr("ff_x")), torch.from_numpy(arr("ff_y"))
    p1, _, loss = step(p0, None, xb, yb, None)
    put("step_ff", p1)
    out["step_ff_loss"] = loss.numpy()
    rows = local_batch_slice(xb.shape[0])
    p1d, _, loss_d = step(p0, None, global_batch_array(mesh, xb[rows]),
                          global_batch_array(mesh, yb[rows]), None)
    put("step_ff_dtensor", p1d)
    out["step_ff_dtensor_loss"] = loss_d.numpy()

    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    net = get_network("lstm", 2, [16], 12, in_dim=8, device="cpu")
    step = make_sharded_train_step(
        net, functools.partial(make_optimizer, "momentumsgd", 0.1), mesh,
        model_axis="model", bprop_len=10)
    out["step_lstm_out_w_local"] = np.asarray(net.out.w.shape)
    state0 = [tuple(a.clone() for a in layer) for layer in net.init_state(8)]
    p1, _, state, loss = step(params("lstm"), None, state0,
                              torch.from_numpy(arr("lstm_x")),
                              torch.from_numpy(arr("lstm_y")), None)
    put("step_lstm", p1)
    out["step_lstm_loss"] = loss.numpy()
    for l, (c, h) in enumerate(state):
        out[f"step_lstm_state:{l}.c"] = c.numpy()
        out[f"step_lstm_state:{l}.h"] = h.numpy()

    # ---- train_network -------------------------------------------------
    def hist(res):
        return np.array([[h["main/loss"], h.get("validation/main/loss",
                                                np.nan)]
                         for h in res.history])

    def engine(name, spec, model_axis, offsets=None, dev=True, **net_kw):
        net = get_network(name, device="cpu", **net_kw)
        stages = [TrainStage(**s) for s in meta[f"eng_{name}_stages"]]
        cfg = TrainConfig(stages=stages, bprop_len=5, seed=0, log=None,
                          mesh=make_mesh(spec, device="cpu"),
                          model_axis=model_axis)
        res = train_network(
            net, arr(f"eng_{name}_x"), arr(f"eng_{name}_y"), cfg,
            offsets=offsets,
            x_dev=arr(f"eng_{name}_xv") if dev else None,
            y_dev=arr(f"eng_{name}_yv") if dev else None,
            init_params=params(f"eng_{name}"), device="cpu")
        put(f"eng_{name}", res.params)
        out[f"eng_{name}_loss"] = np.array([h["main/loss"]
                                            for h in res.history])
        out[f"eng_{name}_hist"] = hist(res)

    engine("ff", {"data": 4}, None, layers=2, units=[32], num_classes=10,
           in_dim=12)
    engine("lstm", {"data": 2, "model": 2}, "model",
           offsets=arr("eng_lstm_offsets"), layers=2, units=[16],
           num_classes=12, in_dim=8)
    engine("tdnn", {"data": 2, "model": 2}, "model", layers=2,
           units=[16, 16], tdnn_ksize=(3, 3), num_classes=10, in_dim=20)

    # ---- a data=2,model=2 run resumed from rank 0's snapshot -----------
    def lstm_run(stages, epochs, snap, resume):
        net = get_network("lstm", 2, [16], 12, in_dim=8, device="cpu")
        cfg = TrainConfig(
            stages=[TrainStage(**dict(s, epoch=epochs)) for s in stages],
            bprop_len=5, seed=0, log=None,
            mesh=make_mesh({"data": 2, "model": 2}, device="cpu"),
            model_axis="model", snapshot_path=str(snap),
            resume_snapshot=resume)
        return train_network(
            net, arr("eng_lstm_x"), arr("eng_lstm_y"), cfg,
            offsets=arr("eng_lstm_offsets"), x_dev=arr("eng_lstm_xv"),
            y_dev=arr("eng_lstm_yv"), init_params=params("eng_lstm"),
            device="cpu")

    full = lstm_run(meta["resume_adam_stages"], 2, work / "adam_full.npz",
                    False)
    put("resume_adam_full", full.params)
    out["resume_adam_full_hist"] = hist(full)
    for name in ("momentumsgd", "adam"):
        stages = meta["eng_lstm_stages" if name == "momentumsgd"
                      else "resume_adam_stages"]
        lstm_run(stages, 1, work / f"resume_{name}.npz", False)
        resumed = lstm_run(stages, 2, work / f"resume_{name}.npz", True)
        put(f"resume_{name}", resumed.params)
        out[f"resume_{name}_hist"] = hist(resumed)

    # ---- train_folds_parallel ------------------------------------------
    net = get_network("lstm", 1, [16], meta["fold_classes"],
                      in_dim=meta["fold_dim"], device="cpu")
    cfg = TrainConfig(stages=[TrainStage(**s) for s in meta["fold_stages"]],
                      bprop_len=5, seed=0, log=None)
    fold_params = train_folds_parallel(
        net, arr("fold_x"), arr("fold_y"), arr("fold_offsets"),
        arr("fold_utt_folds"), 4, cfg, x_dev=arr("fold_xv"),
        y_dev=arr("fold_yv"),
        init_params=[params(f"fold{k}") for k in range(4)], device="cpu",
        mesh=make_mesh({"fold": 2, "data": 2}, device="cpu"))
    for k, p in enumerate(fold_params):
        put(f"fold{k}_out", p)

    # ---- make_sharded_ensemble_forward ---------------------------------
    mesh = make_mesh({"fold": 4}, device="cpu")
    for tag, name, layers, units in (("ens_ff", "ff", 1, 16),
                                     ("ens_lstm", "lstm", 1, 8)):
        net = get_network(name, layers, [units], 10, in_dim=6, device="cpu")
        ens = Ensemble(network=net, num_folds=4)
        shard_folds, forward = make_sharded_ensemble_forward(ens, mesh)
        folds = shard_folds(stack_fold_params(
            [params(f"{tag}{k}") for k in range(4)]))
        x = torch.from_numpy(arr(f"{tag}_x"))
        with torch.inference_mode():
            out[f"{tag}_folds"] = forward(
                {"master": None, "folds": folds, "rpl": None}, x).numpy()
            out[f"{tag}_master"] = forward(
                {"master": params(f"{tag}0"), "folds": folds, "rpl": None},
                x).numpy()

    # ---- PipelinedMLP --------------------------------------------------
    net = get_network("ff", 5, [32], 10, in_dim=12, device="cpu")
    x = torch.from_numpy(arr("pipe_x"))
    y = torch.from_numpy(arr("pipe_y")).long()
    for tag, spec, micro in (("pipe2", {"data": 2, "stage": 2}, 4),
                             ("pipe4", {"stage": 4}, 3)):
        mesh = make_mesh(spec, device="cpu")
        p = {k: v.clone().requires_grad_(True)
             for k, v in params("pipe").items()}
        logits = PipelinedMLP(net, mesh, num_micro=micro).apply(p, x)
        F.cross_entropy(logits, y).backward()
        grads = {k: all_reduce_(v.grad if v.grad is not None
                                else torch.zeros_like(v), mesh, "stage")
                 for k, v in p.items()}
        out[f"{tag}_logits"] = logits.detach().numpy()
        put(f"{tag}_grad", grads)

    # ---- distributed helpers -------------------------------------------
    mesh = make_mesh({"data": 4}, device="cpu")
    g = torch.arange(32.0).reshape(16, 2)
    s = local_batch_slice(16)
    ga = global_batch_array(mesh, g[s])
    out["misc_slice"] = np.asarray([s.start, s.stop])
    out["misc_global"] = ga.full_tensor().numpy()
    out["misc_local"] = ga.to_local().numpy()
    out["misc_replicated"] = replicated_array(mesh, g).full_tensor().numpy()
    slices = [torch.zeros(2, dtype=torch.int64) for _ in range(WORLD)]
    dist.all_gather(slices, torch.tensor([s.start, s.stop]))
    out["misc_slices"] = torch.stack(slices).numpy()
    sync("before train_cli")
    dist.destroy_process_group()

    # ---- train_cli across the ranks ------------------------------------
    build_network = train_cli.build_network

    def jax_init_network(args, num_classes, in_dim, device):
        net = build_network(args, num_classes, in_dim, device)
        net.load_state_dict(params(f"cli_init{in_dim}"))
        return net
    train_cli.build_network = jax_init_network
    train_cli.main(_cli_args(meta["tree"], work / "cli_mesh") + [
        "--mesh", "data=2,model=2", "--coordinator",
        f"localhost:{meta['port2']}", "--num-processes", WORLD,
        "--process-id", rank])
    dist.destroy_process_group()

    # ---- master --mesh across the ranks --------------------------------
    from nnacousticmodeling_tpu_torch.pipeline import master
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(meta["port3"]),
                      WORLD_SIZE=str(WORLD), RANK=str(rank))
    pers = master.main(_master_args(meta["master_root"],
                                    work / "master_mesh") + [
        "--mesh", "data=2,model=2", "--distributed"])
    dist.destroy_process_group()
    if rank == 0:
        out["master_pers"] = np.array(json.dumps(
            [[split, tag, per] for (split, tag), per in pers.items()]))
        np.savez(work / "results.npz", **out)


if __name__ == "__main__":
    try:
        _worker(int(sys.argv[1]), Path(sys.argv[2]))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    sys.exit(0)


# ---------------------------------------------------------------------------
# the parent (pytest)
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from nnacousticmodeling_tpu.decoder.image import make_synthetic_image  # noqa
from nnacousticmodeling_tpu.models import (  # noqa: E402
    get_network as j_get_network,
)
from nnacousticmodeling_tpu.parallel import (  # noqa: E402
    make_mesh as j_make_mesh,
    make_sharded_train_step as j_make_sharded_train_step,
    param_shardings as j_param_shardings,
    replicate as j_replicate,
    shard_rows as j_shard_rows,
)
from nnacousticmodeling_tpu.parallel.pipeline import (  # noqa: E402
    PipelinedMLP as JPipelinedMLP,
)
from nnacousticmodeling_tpu.pipeline.master import (  # noqa: E402
    main as j_master,
)
from nnacousticmodeling_tpu.pipeline.train_cli import (  # noqa: E402
    main as j_train_cli,
)
from nnacousticmodeling_tpu.pipeline.synth_data import (  # noqa: E402
    main as j_synth,
)
from nnacousticmodeling_tpu.train import (  # noqa: E402
    TrainConfig as JTrainConfig,
    TrainStage as JTrainStage,
    load_pytree as j_load_pytree,
    train_network as j_train_network,
)
from nnacousticmodeling_tpu.train.fold_parallel import (  # noqa: E402
    train_folds_parallel as j_train_folds_parallel,
)
from nnacousticmodeling_tpu.train.optimizers import (  # noqa: E402
    make_optimizer as j_make_optimizer,
)
from nnacousticmodeling_tpu.utils.synthetic import (  # noqa: E402
    make_synthetic_corpus,
    write_corpus_tree,
)
from nnacousticmodeling_tpu_torch.pipeline import train_cli  # noqa: E402

ENG_FF_STAGES = [dict(epoch=2, optimizer="momentumsgd", batch_size=32,
                      lr=1e-2, early_stopping=False)]
ENG_LSTM_STAGES = [dict(epoch=2, optimizer="momentumsgd", batch_size=8,
                        lr=0.05, early_stopping=False)]
ENG_TDNN_STAGES = [dict(epoch=2, optimizer="momentumsgd", batch_size=16,
                        lr=1e-2, early_stopping=False)]
RESUME_ADAM_STAGES = [dict(epoch=2, optimizer="adam", batch_size=8, lr=1e-3,
                           early_stopping=False)]
FOLD_STAGES = [dict(epoch=3, optimizer="sgd", batch_size=8, lr=0.05,
                    early_stopping=True),
               dict(epoch=2, optimizer="momentumsgd", batch_size=8,
                    lr=0.01, early_stopping=False)]
FOLD_DIM, FOLD_CLASSES = 10, 16


def _flat(tree, prefix=""):
    """A JAX params pytree as the port's ``state_dict`` names."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(tree, np.float32)
    return out


def _jax_tdnn():
    return j_get_network("tdnn", 2, [16, 16], 10, tdnn_ksize=(3, 3))


def _jax_argv(argv):
    """A port CLI's argv for the JAX CLI: without ``--device``."""
    i = argv.index("--device")
    return argv[:i] + argv[i + 2:]


def _cli_init(network, layers, units, in_dim):
    """The init JAX ``train_network`` draws for a CLI's network from
    ``--seed 0`` (``key, k0 = split(PRNGKey(0))``)."""
    jnet = j_get_network(network, layers, [units], CLI_CLASSES)
    return jnet.init(jax.random.split(jax.random.PRNGKey(0))[1], in_dim)


def _free_ports(n):
    """``n`` distinct free ports (all bound at once while they are
    picked)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _data(rng, n, dim, classes):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """Inputs (JAX inits, data, a corpus tree), the 4-rank launch, and
    rank 0's results."""
    work = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    inp, ref = {}, {}

    def add(prefix, tree):
        for k, v in _flat(tree).items():
            inp[f"{prefix}:{k}"] = v

    jff = j_get_network("ff", 2, [32], 10)
    ref["ff"] = jff.init(jax.random.PRNGKey(0), 12)
    add("ff", ref["ff"])
    inp["ff_x"], inp["ff_y"] = _data(rng, 16, 12, 10)
    jl = j_get_network("lstm", 2, [16], 12)
    ref["lstm"] = jl.init(jax.random.PRNGKey(1), 8)
    add("lstm", ref["lstm"])
    inp["lstm_x"] = rng.standard_normal((8, 10, 8)).astype(np.float32)
    inp["lstm_y"] = rng.integers(0, 12, (8, 10)).astype(np.int32)

    inp["eng_ff_x"], inp["eng_ff_y"] = _data(rng, 256, 12, 10)
    inp["eng_ff_xv"], inp["eng_ff_yv"] = _data(rng, 64, 12, 10)
    ref["eng_ff"] = jff.init(jax.random.PRNGKey(2), 12)
    add("eng_ff", ref["eng_ff"])
    inp["eng_lstm_x"], inp["eng_lstm_y"] = _data(rng, 320, 8, 12)
    inp["eng_lstm_xv"], inp["eng_lstm_yv"] = _data(rng, 48, 8, 12)
    inp["eng_lstm_offsets"] = np.linspace(0, 320, 9).astype(np.int64)
    ref["eng_lstm"] = jl.init(jax.random.PRNGKey(3), 8)
    add("eng_lstm", ref["eng_lstm"])
    inp["eng_tdnn_x"], inp["eng_tdnn_y"] = _data(rng, 128, 20, 10)
    inp["eng_tdnn_xv"], inp["eng_tdnn_yv"] = _data(rng, 32, 20, 10)
    ref["eng_tdnn"] = _jax_tdnn().init(jax.random.PRNGKey(5), 20)
    add("eng_tdnn", ref["eng_tdnn"])

    inp["fold_x"], inp["fold_y"] = _data(rng, 480, FOLD_DIM, FOLD_CLASSES)
    inp["fold_xv"], inp["fold_yv"] = _data(rng, 40, FOLD_DIM, FOLD_CLASSES)
    inp["fold_offsets"] = np.concatenate(
        [[0], np.cumsum(rng.integers(30, 50, 11))]).astype(np.int64)
    inp["fold_offsets"][-1] = 480
    inp["fold_utt_folds"] = (np.arange(11) % 4).astype(np.int64)
    jfold = j_get_network("lstm", 1, [16], FOLD_CLASSES)
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    for k in range(4):
        add(f"fold{k}", jfold.init(keys[k + 1], FOLD_DIM))

    for tag, name, units in (("ens_ff", "ff", 16), ("ens_lstm", "lstm", 8)):
        jnet = j_get_network(name, 1, [units], 10)
        ref[tag] = [jnet.init(jax.random.PRNGKey(10 + k), 6)
                    for k in range(4)]
        for k, p in enumerate(ref[tag]):
            add(f"{tag}{k}", p)
    inp["ens_ff_x"] = rng.standard_normal((5, 6)).astype(np.float32)
    inp["ens_lstm_x"] = rng.standard_normal((2, 5, 6)).astype(np.float32)

    jpipe = j_get_network("ff", 5, [32], 10)
    ref["pipe"] = jpipe.init(jax.random.PRNGKey(4), 12)
    add("pipe", ref["pipe"])
    inp["pipe_x"], inp["pipe_y"] = _data(rng, 12, 12, 10)

    add("cli_init8", _cli_init("lstm", 1, 16, 8))      # train_cli's LSTM
    add("cli_init80", _cli_init("ff", 2, 32, 16 * 5))  # master's FF nets

    tree = work / "tree"
    img = make_synthetic_image(num_phones=5, seed=1,
                               pdf_tied_transitions=True)
    corpus = make_synthetic_corpus(img, dim=8, num_train=8, num_dev=2,
                                   num_test=2, noise=0.5, seed=1,
                                   max_phones=4)
    write_corpus_tree(corpus, str(tree))

    np.savez(work / "inputs.npz", **inp)
    master_root = work / "master_corpus"
    j_synth(["--root", master_root, "--num-phones", 5, "--dim", 16,
             "--num-train", 40, "--num-dev", 12, "--num-test", 10,
             "--noise", 0.5, "--seed", 1])
    port, port2, port3 = _free_ports(3)
    meta = dict(port=port, port2=port2, port3=port3, tree=str(tree),
                master_root=str(master_root),
                eng_ff_stages=ENG_FF_STAGES, eng_lstm_stages=ENG_LSTM_STAGES,
                eng_tdnn_stages=ENG_TDNN_STAGES,
                resume_adam_stages=RESUME_ADAM_STAGES,
                fold_stages=FOLD_STAGES, fold_dim=FOLD_DIM,
                fold_classes=FOLD_CLASSES)
    (work / "meta.json").write_text(json.dumps(meta))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(work)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"the {WORLD}-rank launch ran out of its "
                    f"{LAUNCH_TIMEOUT_S} s")
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * WORLD, "\n".join(
        f"--- rank {r} (rc {rc}) ---\n{log[-3000:]}"
        for r, (rc, log) in enumerate(zip(rcs, logs)))
    with np.load(work / "results.npz") as data:
        res = {k: data[k] for k in data.files}
    return dict(work=work, inp=inp, ref=ref, res=res, logs=logs, tree=tree)


def _got(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items()
            if k.startswith(prefix + ":")}


def _assert_params(got, want_tree, **tol):
    want = _flat(want_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_launch_reports_backend(launch):
    for r, log in enumerate(launch["logs"]):
        assert f"rank {r} of {WORLD}, backend gloo" in log


def test_sharded_step_ff_data4(launch):
    ref, inp, res = launch["ref"], launch["inp"], launch["res"]
    jnet = j_get_network("ff", 2, [32], 10)
    mesh = j_make_mesh({"data": 4})
    opt = j_make_optimizer("momentumsgd", 1e-2)
    step = j_make_sharded_train_step(jnet, opt, mesh)
    p, _, loss = step(j_replicate(mesh, ref["ff"]),
                      j_replicate(mesh, opt.init(ref["ff"])),
                      j_shard_rows(mesh, jnp.asarray(inp["ff_x"])),
                      j_shard_rows(mesh, jnp.asarray(inp["ff_y"])), None)
    for tag in ("step_ff", "step_ff_dtensor"):
        assert float(res[f"{tag}_loss"]) == pytest.approx(float(loss),
                                                          abs=1e-5)
        _assert_params(_got(res, tag), p, atol=1e-5)


def test_sharded_step_lstm_data2_model2(launch):
    ref, inp, res = launch["ref"], launch["inp"], launch["res"]
    jnet = j_get_network("lstm", 2, [16], 12)
    mesh = j_make_mesh({"data": 2, "model": 2})
    opt = j_make_optimizer("momentumsgd", 0.1)
    params = jax.device_put(ref["lstm"], j_param_shardings(
        mesh, ref["lstm"], model_axis="model"))
    state = jax.tree_util.tree_map(lambda a: j_shard_rows(mesh, a),
                                   jnet.init_state(8))
    step = j_make_sharded_train_step(jnet, opt, mesh, model_axis="model",
                                     bprop_len=10)
    p, _, st, loss = step(params, j_replicate(mesh, opt.init(ref["lstm"])),
                          state, j_shard_rows(mesh, jnp.asarray(
                              inp["lstm_x"])),
                          j_shard_rows(mesh, jnp.asarray(inp["lstm_y"])),
                          jax.random.PRNGKey(1))
    # out (16, 12) really splits: 6 columns a model rank
    np.testing.assert_array_equal(res["step_lstm_out_w_local"], [16, 6])
    assert float(res["step_lstm_loss"]) == pytest.approx(float(loss),
                                                         abs=1e-5)
    _assert_params(_got(res, "step_lstm"), p, atol=1e-5)
    got_state = _got(res, "step_lstm_state")
    for l, (c, h) in enumerate(st):
        np.testing.assert_allclose(got_state[f"{l}.c"], np.asarray(c),
                                   atol=1e-5)
        np.testing.assert_allclose(got_state[f"{l}.h"], np.asarray(h),
                                   atol=1e-5)


@pytest.mark.parametrize("name", ["ff", "lstm", "tdnn"])
def test_train_network_mesh_matches_unsharded_jax(launch, name):
    """MLP at data=4; LSTM (``out`` column-parallel) and TDNN (its
    convolutions and ``out`` column-parallel) at data=2,model=2."""
    ref, inp, res = launch["ref"], launch["inp"], launch["res"]
    stages = {"ff": ENG_FF_STAGES, "lstm": ENG_LSTM_STAGES,
              "tdnn": ENG_TDNN_STAGES}[name]
    jnet = {"ff": lambda: j_get_network("ff", 2, [32], 10),
            "lstm": lambda: j_get_network("lstm", 2, [16], 12),
            "tdnn": _jax_tdnn}[name]()
    cfg = JTrainConfig(stages=[JTrainStage(**s) for s in stages],
                       bprop_len=5, seed=0, log=None)
    want = j_train_network(
        jnet, inp[f"eng_{name}_x"], inp[f"eng_{name}_y"], cfg,
        offsets=inp.get(f"eng_{name}_offsets"),
        x_dev=inp[f"eng_{name}_xv"], y_dev=inp[f"eng_{name}_yv"],
        init_params=ref[f"eng_{name}"])
    np.testing.assert_allclose(
        res[f"eng_{name}_loss"], [h["main/loss"] for h in want.history],
        rtol=1e-3)
    _assert_params(_got(res, f"eng_{name}"), want.params, rtol=5e-4,
                   atol=5e-5)


def test_train_folds_parallel_fold2_data2(launch):
    inp, res = launch["inp"], launch["res"]
    jnet = j_get_network("lstm", 1, [16], FOLD_CLASSES)
    cfg = JTrainConfig(stages=[JTrainStage(**s) for s in FOLD_STAGES],
                       bprop_len=5, seed=0, log=None)
    want = j_train_folds_parallel(
        jnet, inp["fold_x"], inp["fold_y"], inp["fold_offsets"],
        inp["fold_utt_folds"], 4, cfg, x_dev=inp["fold_xv"],
        y_dev=inp["fold_yv"])
    for k in range(4):
        _assert_params(_got(res, f"fold{k}_out"), want[k], atol=1e-5)


@pytest.mark.parametrize("tag", ["ens_ff", "ens_lstm"])
def test_sharded_ensemble_fold4_matches_host_sum(launch, tag):
    ref, inp, res = launch["ref"], launch["inp"], launch["res"]
    name = "ff" if tag == "ens_ff" else "lstm"
    jnet = j_get_network(name, 1, [16 if name == "ff" else 8], 10)
    x = jnp.asarray(inp[f"{tag}_x"])

    def one(p):
        if name == "ff":
            return np.asarray(jnet.apply(p, x))
        return np.asarray(jnet.apply_sequence(p, x)[0])
    logits = [one(p) for p in ref[tag]]
    np.testing.assert_allclose(res[f"{tag}_folds"], sum(logits) / 4,
                               atol=1e-5)
    np.testing.assert_allclose(res[f"{tag}_master"],
                               (logits[0] * 4 + sum(logits)) / 8, atol=1e-5)


@pytest.mark.parametrize("tag,stages,micro", [("pipe2", 2, 4),
                                              ("pipe4", 4, 3)])
def test_pipelined_mlp_logits_and_grads(launch, tag, stages, micro):
    ref, inp, res = launch["ref"], launch["inp"], launch["res"]
    jnet = j_get_network("ff", 5, [32], 10)
    x = jnp.asarray(inp["pipe_x"])
    y = jnp.asarray(inp["pipe_y"])
    want = np.asarray(jnet.apply(ref["pipe"], x))
    jpipe = JPipelinedMLP(jnet, j_make_mesh({"stage": stages}),
                          num_micro=micro)
    np.testing.assert_allclose(np.asarray(jpipe.apply(ref["pipe"], x)),
                               want, atol=1e-6)
    np.testing.assert_allclose(res[f"{tag}_logits"], want, atol=1e-6)
    grads = jax.grad(lambda p: optax.softmax_cross_entropy_with_integer_labels(
        jnet.apply(p, x), y).mean())(ref["pipe"])
    _assert_params(_got(res, f"{tag}_grad"), grads, atol=1e-6)


def test_distributed_helpers(launch):
    res = launch["res"]
    g = np.arange(32.0, dtype=np.float32).reshape(16, 2)
    np.testing.assert_array_equal(res["misc_slice"], [0, 4])
    np.testing.assert_array_equal(res["misc_slices"],
                                  [[4 * r, 4 * r + 4] for r in range(WORLD)])
    np.testing.assert_array_equal(res["misc_local"], g[:4])
    np.testing.assert_array_equal(res["misc_global"], g)
    np.testing.assert_array_equal(res["misc_replicated"], g)


@pytest.mark.parametrize("opt_name", ["momentumsgd", "adam"])
def test_mesh_snapshot_resume_equals_uninterrupted_run(launch, opt_name):
    """1 epoch at data=2,model=2 with rank 0's snapshot, then resumed for
    the second: its epoch's training and validation losses and the final
    params bit-equal to the uninterrupted 2-epoch mesh run's (for
    momentumsgd the engine case above, held against JAX there, whose
    best-validation epoch is the first, so its params come back from the
    snapshot's best params; for adam a run held against JAX
    ``train_network`` here, ending on its second epoch)."""
    ref, inp, res = launch["ref"], launch["inp"], launch["res"]
    tag = "eng_lstm" if opt_name == "momentumsgd" else "resume_adam_full"
    full = _got(res, tag)
    got = _got(res, f"resume_{opt_name}")
    np.testing.assert_array_equal(res[f"resume_{opt_name}_hist"],
                                  res[f"{tag}_hist"][1:])
    assert sorted(got) == sorted(full)
    for k in full:
        np.testing.assert_array_equal(got[k], full[k], err_msg=k)
    if opt_name == "adam":
        cfg = JTrainConfig(
            stages=[JTrainStage(**s) for s in RESUME_ADAM_STAGES],
            bprop_len=5, seed=0, log=None)
        want = j_train_network(
            j_get_network("lstm", 2, [16], 12), inp["eng_lstm_x"],
            inp["eng_lstm_y"], cfg, offsets=inp["eng_lstm_offsets"],
            x_dev=inp["eng_lstm_xv"], y_dev=inp["eng_lstm_yv"],
            init_params=ref["eng_lstm"])
        _assert_params(full, want.params, rtol=5e-4, atol=5e-5)


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _assert_models(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-4, atol=5e-5,
                                   err_msg=f"{what} {k}")


def test_train_cli_mesh_across_ranks(launch, tmp_path, monkeypatch):
    """Rank 0's model from ``--mesh data=2,model=2`` over 4 processes
    against JAX ``train_cli --mesh data=2,model=2`` on the same tree and
    init (``tests/test_engine_mesh.py``'s tolerances); JAX
    ``load_pytree`` reads it. The port's one-process run of the same
    command is an extra check."""
    work, tree, inp = launch["work"], launch["tree"], launch["inp"]
    got = _npz(work / "cli_mesh" / "model.npz")
    hist = json.loads((work / "cli_mesh" / "log.json").read_text())

    j_train_cli(_jax_argv(_cli_args(tree, tmp_path / "jax"))
                + ["--mesh", "data=2,model=2"])
    _assert_models(got, _npz(tmp_path / "jax" / "model.npz"), "jax")
    want = json.loads((tmp_path / "jax" / "log.json").read_text())
    np.testing.assert_allclose([h["main/loss"] for h in hist],
                               [h["main/loss"] for h in want], rtol=1e-4)
    template = j_get_network("lstm", 1, [16], CLI_CLASSES).init(
        jax.random.PRNGKey(0), 8)
    read = j_load_pytree(str(work / "cli_mesh" / "model.npz"), template)
    _assert_models({k.replace(".", "/"): v for k, v in _flat(read).items()},
                   got, "load_pytree")

    build_network = train_cli.build_network

    def jax_init_network(args, num_classes, in_dim, device):
        net = build_network(args, num_classes, in_dim, device)
        net.load_state_dict({k: torch.tensor(v) for k, v in
                             _got(inp, f"cli_init{in_dim}").items()})
        return net
    monkeypatch.setattr(train_cli, "build_network", jax_init_network)
    train_cli.main(_cli_args(tree, tmp_path / "single"))
    _assert_models(got, _npz(tmp_path / "single" / "model.npz"), "single")


def test_master_mesh_across_ranks(launch, tmp_path):
    """``master --mesh data=2,model=2 --distributed`` over 4 ranks gives
    JAX ``master --mesh data=2,model=2``'s six PERs, and its four models
    within ``tests/test_engine_mesh.py``'s tolerances."""
    work = launch["work"]
    root = work / "master_corpus"
    want_pers = j_master(_jax_argv(_master_args(root, tmp_path / "jax"))
                         + ["--mesh", "data=2,model=2"])
    got_pers = {(split, tag): per for split, tag, per in json.loads(
        str(launch["res"]["master_pers"]))}
    assert len(got_pers) == 6
    assert got_pers == want_pers
    for rel in MASTER_MODELS:
        _assert_models(_npz(work / "master_mesh" / rel),
                       _npz(tmp_path / "jax" / rel), rel)
