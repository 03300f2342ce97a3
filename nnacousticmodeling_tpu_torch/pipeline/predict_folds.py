"""Fold prediction: each fold network's log-softmax posteriors over its
held-out fold (fold mode), or the K fold networks' average over the dev
set (dev mode), saved as ``.npy`` for RPL training.

Counterpart of ``nnacousticmodeling_tpu/pipeline/predict_folds.py`` (the
twin of the reference's ``scripts/common/predict_folds.py``) with the
same argv plus ``--device``. Recurrent nets run through
``rnn_log_posteriors`` (bucketed batches, the reference's timedelay zero
tail), feed-forward nets through ``ff_log_posteriors``. Dev mode sums
the K posteriors in fold order, divides by K and renormalises with
``ref_logsum`` in numpy, whose NaN goes to -1e20, as the JAX package
does.

Run: ``python -m nnacousticmodeling_tpu_torch.pipeline.predict_folds``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..infer import ff_log_posteriors, rnn_log_posteriors
from ..models import is_recurrent
from ..ops.numerics import ref_logsum
from ..train import load_jax_params
from ..utils.device import resolve_device
from .common import (
    add_data_args, add_network_args, build_network, effective_splice,
    load_transform, num_classes_for, prepare_features,
)


def build_parser():
    parser = argparse.ArgumentParser(description="Predict fold outputs")
    add_network_args(parser)
    add_data_args(parser)
    parser.add_argument("--fold-data-dir")
    parser.add_argument("--fold-output-dir", required=True)
    parser.add_argument("--fold-model-dir", required=True)
    parser.add_argument("--fold-output-dev",
                        help="dev mode: average all folds over the dev set")
    parser.add_argument("--fold-data-pattern", default="data_{}.npy")
    parser.add_argument("--fold-offset-pattern", default="offsets_{}.npy")
    parser.add_argument("--fold-ivector-pattern", default="ivectors_{}.npy")
    parser.add_argument("--fold-output-pattern", default="data_{}.npy")
    parser.add_argument("--fold-network-pattern", default="fold_{}.npz")
    parser.add_argument("--no-progress", action="store_true")
    return parser


def _predict(net, x, offsets, args):
    if is_recurrent(args.network):
        return rnn_log_posteriors(net, x, offsets, timedelay=args.timedelay)
    return ff_log_posteriors(net, x)


def _fold_files(args):
    files = []
    while True:
        f = Path(args.fold_model_dir,
                 args.fold_network_pattern.format(len(files)))
        if not f.is_file():
            return files
        files.append(f)


def main(arg_list=None):
    args = build_parser().parse_args(
        list(map(str, arg_list)) if arg_list is not None else None)
    device = resolve_device(args.device)
    num_classes = num_classes_for(args)
    splice = effective_splice(args)
    ft = load_transform(args, splice)
    Path(args.fold_output_dir).mkdir(exist_ok=True, parents=True)
    recurrent = is_recurrent(args.network)
    files = _fold_files(args)
    if not files:
        raise FileNotFoundError("No fold networks found")

    if args.fold_output_dev is not None:
        # dev mode (predict_folds.py:190-220): average fold posteriors
        x = np.load(str(Path(args.data_dir, args.data.format("dev"))))
        offsets = (np.load(str(Path(args.offset_dir,
                                    args.offsets.format("dev"))))
                   if recurrent else None)
        iv = (np.load(str(Path(args.ivector_dir, args.ivectors.format("dev"))))
              if args.ivector_dir else None)
        x = prepare_features(x, args, splice, ft, iv)
        net = build_network(args, num_classes, x.shape[1], device)
        y_out = 0
        for k, f in enumerate(files):
            print(f"Predicting fold {k} data")
            net.load_state_dict(load_jax_params(str(f), device))
            y_out = y_out + _predict(net, x, offsets, args)
        y_out /= len(files)
        y_out = (y_out - ref_logsum(y_out, axis=1)).astype(np.float32)
        np.save(str(Path(args.fold_output_dir, args.fold_output_dev)), y_out)
        return

    # fold mode (predict_folds.py:221-246): each net over its own fold
    for fold, f in enumerate(files):
        print(f"Predicting fold {fold} data")
        x = np.load(str(Path(args.fold_data_dir,
                             args.fold_data_pattern.format(fold))))
        offsets = (np.load(str(Path(args.fold_data_dir,
                                    args.fold_offset_pattern.format(fold))))
                   if recurrent else None)
        iv = (np.load(str(Path(args.fold_data_dir,
                               args.fold_ivector_pattern.format(fold))))
              if args.ivector_dir else None)
        x = prepare_features(x, args, splice, ft, iv)
        net = build_network(args, num_classes, x.shape[1], device)
        net.load_state_dict(load_jax_params(str(f), device))
        y = _predict(net, x, offsets, args)
        np.save(str(Path(args.fold_output_dir,
                         args.fold_output_pattern.format(fold))), y)


if __name__ == "__main__":
    main()
