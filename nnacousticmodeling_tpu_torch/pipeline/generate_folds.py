"""Fold generation: splits the training set into N folds BY SPEAKER
(speaker = the first 5 characters of the utterance name), persists a
reusable ``utt_idx.npz`` index map, and writes each fold's concatenated
data, offsets, targets and i-vectors.

Counterpart of ``nnacousticmodeling_tpu/pipeline/generate_folds.py``
(the twin of the reference's ``scripts/common/generate_folds.py``), with
the same argv, the same numpy draws and the same files: one seed gives
byte-identical ``.npy`` outputs. A fold that draws no speaker is written
as empty arrays (``generate_folds.py:58-70``), where the reference would
crash. Host-only numpy; it runs on no device.

Run: ``python -m nnacousticmodeling_tpu_torch.pipeline.generate_folds``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def build_parser():
    parser = argparse.ArgumentParser(description="Generate speaker folds")
    parser.add_argument("-n", type=int, default=5, help="Number of folds")
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--offset-dir", default="data")
    parser.add_argument("--target-dir", default="data")
    parser.add_argument("--ivector-dir")
    parser.add_argument("--utt-list-dir", default="data")
    parser.add_argument("--fold-data-dir", default="fold_data")
    parser.add_argument("--data", default="data_train.npy")
    parser.add_argument("--offsets", default="offsets_train.npy")
    parser.add_argument("--targets", default="targets_train.npy")
    parser.add_argument("--ivectors", default="ivectors_train.npy")
    parser.add_argument("--fold-data-pattern", default="data_{}.npy")
    parser.add_argument("--fold-offset-pattern", default="offsets_{}.npy")
    parser.add_argument("--fold-target-pattern", default="targets_{}.npy")
    parser.add_argument("--fold-ivector-pattern", default="ivectors_{}.npy")
    parser.add_argument("--train-list", default="train.list")
    parser.add_argument("--utt-idx", default="utt_idx.npz",
                        help="Reused if present (generate_folds.py:56-71)")
    parser.add_argument("--seed", type=int, default=None)
    return parser


def main(arg_list=None):
    args = build_parser().parse_args(
        list(map(str, arg_list)) if arg_list is not None else None)

    Path(args.fold_data_dir).mkdir(exist_ok=True, parents=True)
    data = np.load(str(Path(args.data_dir, args.data)))
    offsets = np.load(str(Path(args.offset_dir, args.offsets)))
    targets = np.load(str(Path(args.target_dir, args.targets)))
    ivectors = (np.load(str(Path(args.ivector_dir, args.ivectors)))
                if args.ivector_dir else None)
    with open(Path(args.utt_list_dir, args.train_list)) as f:
        train_list = [line.strip() for line in f if line.strip()]
    if len(train_list) != len(offsets) - 1:
        raise ValueError("train list / offsets mismatch")

    utt_idx_file = Path(args.fold_data_dir, args.utt_idx)
    if args.utt_idx and utt_idx_file.is_file():
        print("Using existing utterance index file")
        with np.load(str(utt_idx_file)) as loaded:
            utt_idx = [loaded[k] for k in loaded.files]
    else:
        print("No utterance index file found, creating new index map")
        rng = np.random.default_rng(args.seed)
        speakers = sorted({u[:5] for u in train_list})
        rand_idx = rng.integers(0, args.n, len(speakers))
        spk_fold = {s: rand_idx[i] for i, s in enumerate(speakers)}
        utt_idx = [[] for _ in range(args.n)]
        for i, u in enumerate(train_list):
            utt_idx[spk_fold[u[:5]]].append(i)
        utt_idx = [np.asarray(f, dtype=np.int32) for f in utt_idx]
        if args.utt_idx:
            np.savez(str(utt_idx_file), *utt_idx)

    for k in range(args.n):
        # a fold with no speaker is written as empty arrays
        fold_data = [np.zeros((0, data.shape[1]), data.dtype)]
        fold_targets = [np.zeros((0,), targets.dtype)]
        fold_iv = ([np.zeros((0, ivectors.shape[1]), ivectors.dtype)]
                   if ivectors is not None else [])
        fold_offsets = [0]
        count = 0
        for i in utt_idx[k]:
            beg, end = offsets[i], offsets[i + 1]
            count += end - beg
            fold_data.append(data[beg:end])
            fold_offsets.append(count)
            fold_targets.append(targets[beg:end])
            if ivectors is not None:
                fold_iv.append(ivectors[beg:end])
        np.save(Path(args.fold_data_dir, args.fold_data_pattern.format(k)),
                np.concatenate(fold_data, axis=0))
        np.save(Path(args.fold_data_dir, args.fold_offset_pattern.format(k)),
                np.asarray(fold_offsets, dtype=np.int64))
        np.save(Path(args.fold_data_dir, args.fold_target_pattern.format(k)),
                np.concatenate(fold_targets, axis=0))
        if ivectors is not None:
            np.save(Path(args.fold_data_dir,
                         args.fold_ivector_pattern.format(k)),
                    np.concatenate(fold_iv, axis=0))
        print(f"fold {k}: {len(utt_idx[k])} utts, {count} frames")


if __name__ == "__main__":
    main()
