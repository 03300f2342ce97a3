"""Training CLI: trains one network (the master, one fold, or the RPL
head) through staged (optimizer, batch-size, lr, early-stop) phases and
writes ``model.npz`` (under the JAX package's keys), ``log.json`` and
``args.txt``.

Counterpart of ``nnacousticmodeling_tpu/pipeline/train_cli.py`` with the
same argv surface plus ``--device`` (default ``cuda``; ``--device cpu``
runs without a card): every network of the zoo (feed-forward and
recurrent), the master and ``--train-fold`` data paths, ``--train-rpl``
(RPL4 on the fold outputs, validated on the dev-set fold average),
``--train-all-folds`` (all K fold networks in one update loop,
``train/fold_parallel.py``; each fold's model written to
``--fold-model-dir`` under ``--fold-network-pattern``),
``--shuffle-sequences``, ``--resume``, ``--dtype``, ``--timedelay``,
and the ranks of ``torch.distributed``: ``--distributed`` (the process
group from ``torchrun``'s environment) or ``--coordinator HOST:PORT
--num-processes N --process-id R`` (one process per rank), and
``--mesh`` (``data=2,model=2``, ``fold=2,data=2``: ``parallel.mesh``;
like JAX, a mesh without a ``data`` axis reaches only
``--train-all-folds``). Each rank runs on its ``--device`` (``cuda`` is
``cuda:{LOCAL_RANK % device_count}``); only rank 0 writes the model,
logs and snapshots.

Run: ``python -m nnacousticmodeling_tpu_torch.pipeline.train_cli [args]``.
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np
import torch

from ..models import RPL4, is_recurrent
from ..ops.timedelay import apply_time_delay
from ..train import TrainConfig, build_stages, save_pytree, train_network
from ..train.fold_parallel import train_folds_parallel
from ..utils.device import resolve_device
from .common import (
    add_data_args, add_network_args, build_network, dump_args,
    effective_splice, load_transform, num_classes_for, prepare_features,
    str2bool,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Acoustic model trainer")
    parser.add_argument("--epoch", "-e", type=int, nargs="+", default=[20])
    parser.add_argument("--optimizer", "-o", nargs="+", default=["momentumsgd"])
    parser.add_argument("--batch-size", "-b", type=int, nargs="+", default=[128])
    parser.add_argument("--lr", type=float, nargs="+",
                        default=[1e-2, 1e-3, 1e-4, 1e-5])
    parser.add_argument("--early-stopping", type=str2bool, nargs="+",
                        default=[True])
    parser.add_argument("--bproplen", type=int, default=20)
    parser.add_argument("--shuffle-sequences", action="store_true",
                        help="sentence-level shuffling with stream batch "
                             "layout even for feed-forward nets "
                             "(the reference's flag, train.py:49,307)")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="compute dtype for forward/backward; master "
                             "params and optimizer state stay float32")
    parser.add_argument("--mesh", default="",
                        help="rank mesh spec, e.g. data=4,model=2 or "
                             "fold=2,data=2 (the product is the world size)")
    parser.add_argument("--distributed", action="store_true",
                        help="join the torch.distributed process group "
                             "(env:// as torchrun sets it, or "
                             "--coordinator) before any device use")
    parser.add_argument("--coordinator", default="",
                        help="HOST:PORT of rank 0 for the process group "
                             "(with --num-processes and --process-id)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--out", default="result")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-validation", dest="use_validation",
                        action="store_false")
    parser.add_argument("--no-progress", action="store_true")
    parser.add_argument("--noplot", dest="plot", action="store_false",
                        help="disable loss/accuracy plot PNGs")
    parser.add_argument("--resume", "-r", default="",
                        help="resume from a training snapshot "
                             "(<out>/snapshot.npz written every epoch)")
    # fold / RPL training modes (train.py:59-70)
    parser.add_argument("--train-fold", type=int)
    parser.add_argument("--train-all-folds", action="store_true",
                        help="train ALL K fold networks together in one "
                             "update loop (K passes of one module an "
                             "update) instead of the reference's "
                             "sequential per-fold loop")
    parser.add_argument("--train-rpl", action="store_true")
    parser.add_argument("--fold-data-dir", default="fold_data")
    parser.add_argument("--fold-output-dir", default="fold_data_out")
    parser.add_argument("--fold-model-dir", default="fold_models")
    parser.add_argument("--fold-data-pattern", default="data_{0}.npy")
    parser.add_argument("--fold-offset-pattern", default="offsets_{0}.npy")
    parser.add_argument("--fold-target-pattern", default="targets_{0}.npy")
    parser.add_argument("--fold-ivector-pattern", default="ivectors_{}.npy")
    parser.add_argument("--fold-output-pattern", default="data_{0}.npy")
    parser.add_argument("--fold-network-pattern", default="fold_{0}.npz")
    add_network_args(parser)
    add_data_args(parser)
    return parser


def _build_mesh(spec: str, device):
    """``--mesh`` spec -> (Mesh | None, model_axis | None) (JAX
    ``train_cli.py:181-189``)."""
    if not spec:
        return None, None
    from ..parallel import make_mesh, parse_mesh_spec
    axes = parse_mesh_spec(spec)
    mesh = make_mesh(axes, device=device)
    model_axis = "model" if axes.get("model", 1) > 1 else None
    return mesh, model_axis


class _RplNet(RPL4):
    """RPL4 as a non-recurrent net of the training engine (JAX
    ``train_cli.py:298-312``): its forward takes the engine's ``train``
    and ``generator`` and ignores them (the head has no dropout)."""

    def forward(self, x, train=False, generator=None):
        return RPL4.apply(self, x)

    apply = forward


def _load_rpl_data(args):
    """Fold-output logits and fold targets for RPL training, fold-
    ascending until the first missing fold (train.py:129-157)."""
    xs, ys = [], []
    fold = 0
    while True:
        x_file = Path(args.fold_output_dir,
                      args.fold_output_pattern.format(fold))
        y_file = Path(args.fold_data_dir, args.fold_target_pattern.format(fold))
        if not x_file.is_file() or not y_file.is_file():
            break
        print(f"Loading fold {fold} data")
        xs.append(np.load(str(x_file)))
        ys.append(np.load(str(y_file)))
        fold += 1
    if fold == 0:
        raise FileNotFoundError("No fold data found")
    return np.concatenate(xs, axis=0), np.concatenate(ys, axis=0)


def _load_all_fold_data(args):
    """Every fold's data concatenated fold-ascending, plus each
    utterance's fold: the shared corpus of fold-parallel training
    (``train/fold_parallel.py`` builds each fold's training-set index
    universe from it, as train.py:162-206 concatenates it)."""
    xs, ys, ivs, utt_folds = [], [], [], []
    offsets = [0]
    num = 0
    fold = 0
    while True:
        x_file = Path(args.fold_data_dir, args.fold_data_pattern.format(fold))
        if not x_file.is_file():
            break
        print(f"Loading fold {fold} data")
        x_fold = np.load(str(x_file))
        xs.append(x_fold)
        off = np.load(str(Path(args.fold_data_dir,
                               args.fold_offset_pattern.format(fold))))
        offsets.extend((off[1:] + num).tolist())
        utt_folds.extend([fold] * (len(off) - 1))
        ys.append(np.load(str(Path(args.fold_data_dir,
                                   args.fold_target_pattern.format(fold)))))
        if args.ivector_dir is not None:
            ivs.append(np.load(str(Path(args.fold_data_dir,
                                        args.fold_ivector_pattern.format(fold)))))
        num += x_fold.shape[0]
        fold += 1
    if not xs:
        raise FileNotFoundError("No fold data found")
    return (np.concatenate(xs, axis=0), np.concatenate(ys, axis=0),
            np.asarray(offsets, dtype=np.int64),
            np.concatenate(ivs, axis=0) if ivs else None,
            np.asarray(utt_folds, dtype=np.int64), fold)


def _load_fold_train_data(args, recurrent: bool):
    """Concatenation of all folds except --train-fold (train.py:162-206)."""
    xs, ys, ivs = [], [], []
    offsets = [0]
    num = 0
    fold = 0
    while True:
        if fold == args.train_fold:
            fold += 1
            continue
        x_file = Path(args.fold_data_dir, args.fold_data_pattern.format(fold))
        if not x_file.is_file():
            break
        print(f"Loading fold {fold} data")
        x_fold = np.load(str(x_file))
        xs.append(x_fold)
        if recurrent:
            off = np.load(str(Path(args.fold_data_dir,
                                   args.fold_offset_pattern.format(fold))))
            offsets.extend((off[1:] + num).tolist())
        ys.append(np.load(str(Path(args.fold_data_dir,
                                   args.fold_target_pattern.format(fold)))))
        if args.ivector_dir is not None:
            ivs.append(np.load(str(Path(args.fold_data_dir,
                                        args.fold_ivector_pattern.format(fold)))))
        num += x_fold.shape[0]
        fold += 1
    if not xs:
        raise FileNotFoundError("No fold data found")
    x = np.concatenate(xs, axis=0)
    y = np.concatenate(ys, axis=0)
    iv = np.concatenate(ivs, axis=0) if ivs else None
    off = np.asarray(offsets, dtype=np.int64) if recurrent else None
    return x, y, off, iv


def main(arg_list=None):
    parser = build_parser()
    args = parser.parse_args(list(map(str, arg_list)) if arg_list is not None
                             else None)
    if args.distributed or args.coordinator:
        # the process group before any device use (JAX :196-201)
        from ..parallel import initialize_distributed
        initialize_distributed(args.coordinator or None, args.num_processes,
                               args.process_id, device=args.device)
    from ..parallel.distributed import rank_device
    from ..parallel.mesh import is_primary
    device = rank_device(resolve_device(args.device))
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)      # this rank's card
    primary = is_primary()   # only rank 0 writes artifacts
    mesh, model_axis = _build_mesh(args.mesh, device)
    if primary:
        dump_args(args, args.out)
    num_classes = num_classes_for(args)
    recurrent = is_recurrent(args.network) and not args.train_rpl

    # ---- data ---------------------------------------------------------
    offsets = offsets_dev = None
    ivectors = ivectors_dev = None
    if args.train_rpl:
        x, y = _load_rpl_data(args)
        x_dev = y_dev = None
        if args.use_validation:
            dev_file = Path(args.data_dir, args.data.format("dev"))
            if dev_file.is_file():
                x_dev = np.load(str(dev_file))
                y_dev = np.load(str(Path(args.target_dir,
                                         args.targets.format("dev"))))
    else:
        if args.train_all_folds:
            (x, y, offsets, ivectors, utt_folds,
             num_folds) = _load_all_fold_data(args)
        elif args.train_fold is not None:
            x, y, offsets, ivectors = _load_fold_train_data(args, recurrent)
        else:
            x = np.load(str(Path(args.data_dir, args.data.format("train"))))
            y = np.load(str(Path(args.target_dir,
                                 args.targets.format("train"))))
            if recurrent or args.shuffle_sequences:
                offsets = np.load(str(Path(args.offset_dir,
                                           args.offsets.format("train"))))
            if args.ivector_dir is not None:
                ivectors = np.load(str(Path(args.ivector_dir,
                                            args.ivectors.format("train"))))
        x_dev = y_dev = None
        if args.use_validation:
            x_dev = np.load(str(Path(args.data_dir, args.data.format("dev"))))
            y_dev = np.load(str(Path(args.target_dir,
                                     args.targets.format("dev"))))
            if recurrent:
                offsets_dev = np.load(str(Path(args.offset_dir,
                                               args.offsets.format("dev"))))
            if args.ivector_dir is not None:
                ivectors_dev = np.load(str(Path(args.ivector_dir,
                                                args.ivectors.format("dev"))))

        # splice -> transform -> i-vectors -> time delay (train.py:224-264)
        splice = effective_splice(args)
        ft = load_transform(args, splice)
        x = prepare_features(x, args, splice, ft, ivectors)
        if x_dev is not None:
            x_dev = prepare_features(x_dev, args, splice, ft, ivectors_dev)
        if recurrent and args.timedelay != 0:
            x, y, offsets = apply_time_delay(x, y, offsets, args.timedelay)
            if x_dev is not None:
                x_dev, y_dev, offsets_dev = apply_time_delay(
                    x_dev, y_dev, offsets_dev, args.timedelay)

    # ---- model + stages ----------------------------------------------
    stages = build_stages(args.epoch, args.optimizer, args.batch_size,
                          args.lr, args.early_stopping)
    # the engine takes data/model axes; a mesh without a data axis
    # reaches only --train-all-folds (JAX :264-290)
    engine_mesh = (mesh if mesh is not None
                   and "data" in mesh.axis_names else None)
    config = TrainConfig(stages=stages, bprop_len=args.bproplen,
                         seed=args.seed,
                         use_validation=args.use_validation
                         and x_dev is not None,
                         log=print,
                         snapshot_path=str(Path(args.out) / "snapshot.npz"),
                         resume_snapshot=bool(args.resume),
                         compute_dtype=args.dtype,
                         mesh=engine_mesh,
                         model_axis=model_axis if engine_mesh is not None
                         else None,
                         shuffle_sequences=args.shuffle_sequences)
    if args.train_all_folds:
        # the K fold networks in one update loop, in the place of the
        # reference's sequential loop (master_script.py:134-170)
        net = build_network(args, num_classes, x.shape[1], device)
        fold_mesh = (mesh if mesh is not None
                     and "fold" in mesh.axis_names else None)
        fold_params = train_folds_parallel(
            net, x, y, offsets, utt_folds, num_folds, config, x_dev=x_dev,
            y_dev=y_dev, device=device, mesh=fold_mesh)
        if not primary:
            return fold_params
        Path(args.fold_model_dir).mkdir(exist_ok=True, parents=True)
        for k, p in enumerate(fold_params):
            save_pytree(str(Path(args.fold_model_dir,
                                 args.fold_network_pattern.format(k))), p)
        return fold_params

    if args.train_rpl:
        net = _RplNet(num_classes, device=device, seed=args.seed)
    else:
        net = build_network(args, num_classes, x.shape[1], device)
    if args.resume and args.resume != "auto":
        config.snapshot_path = args.resume

    result = train_network(net, x, y, config, offsets=offsets,
                           x_dev=x_dev, y_dev=y_dev, device=device)

    # ---- save (train.py:393-395) --------------------------------------
    if not primary:
        return result
    Path(args.out).mkdir(exist_ok=True, parents=True)
    save_pytree(str(Path(args.out) / "model"), result.params)
    if args.train_fold is not None:
        fold_file = Path(args.fold_model_dir,
                         args.fold_network_pattern.format(args.train_fold))
        fold_file.parent.mkdir(exist_ok=True, parents=True)
        shutil.copy(Path(args.out) / "model.npz", fold_file)
    with open(Path(args.out) / "log.json", "w") as f:
        json.dump(result.history, f, indent=1)
    if args.plot:
        _write_plots(result.history, args.out)
    return result


def _write_plots(history, out_dir):
    """loss.png / accuracy.png training curves (the reference's
    PlotReport extension, train.py:348-355), when matplotlib imports."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    if not history:
        return
    epochs = range(1, len(history) + 1)
    for metric, fname in [("loss", "loss.png"), ("accuracy", "accuracy.png")]:
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(epochs, [h[f"main/{metric}"] for h in history],
                label=f"main/{metric}")
        if f"validation/main/{metric}" in history[0]:
            ax.plot(epochs, [h.get(f"validation/main/{metric}")
                             for h in history],
                    label=f"validation/main/{metric}")
        ax.set_xlabel("epoch")
        ax.set_ylabel(metric)
        ax.legend()
        fig.tight_layout()
        fig.savefig(str(Path(out_dir) / fname), dpi=80)
        plt.close(fig)


if __name__ == "__main__":
    main()
