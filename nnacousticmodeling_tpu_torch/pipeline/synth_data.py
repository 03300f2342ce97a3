"""Synthetic dataset tree generator.

Counterpart of ``nnacousticmodeling_tpu/pipeline/synth_data.py``, with
the same argv and the same tree, so the pipeline runs end to end without
the external TIMIT bundle:

    <root>/data/{data,offsets,targets}_{train,dev,test}.npy + *.list
    <root>/recog/{test,dev,train}_ref.mlf, log_ap_Kaldi1909.npy,
                 kaldiTri1909.img

The image is the small synthetic one (``make_synthetic_image(...,
tied=False)``: context-independent pdfs, transitions not tied to them),
which the port decodes through the cube scan twin, or with
``--timit-graph`` the regenerated 1909-pdf TIMIT graph from
``decoder.graph.build_timit_image`` (it reads the Kaldi tree, model and
phone map of the reference TIMIT bundle, as the JAX CLI's does).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..decoder.graph import build_timit_image
from ..decoder.image import make_synthetic_image, save_image
from ..utils.synthetic import make_synthetic_corpus, write_corpus_tree


def build_parser():
    parser = argparse.ArgumentParser(description="Generate synthetic corpus")
    parser.add_argument("--root", required=True)
    parser.add_argument("--timit-graph", action="store_true",
                        help="use the regenerated 1909-pdf TIMIT image")
    parser.add_argument("--num-phones", type=int, default=6)
    parser.add_argument("--dim", type=int, default=40)
    parser.add_argument("--num-train", type=int, default=128)
    parser.add_argument("--num-dev", type=int, default=32)
    parser.add_argument("--num-test", type=int, default=32)
    parser.add_argument("--noise", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ivector-dim", type=int, default=0,
                        help="generate speaker i-vectors of this dim")
    return parser


def main(arg_list=None):
    parser = build_parser()
    args = parser.parse_args(list(map(str, arg_list)) if arg_list is not None
                             else None)
    if args.timit_graph:
        img = build_timit_image()
    else:
        img = make_synthetic_image(num_phones=args.num_phones,
                                   seed=args.seed, tied=False)
    corpus = make_synthetic_corpus(
        img, dim=args.dim, num_train=args.num_train, num_dev=args.num_dev,
        num_test=args.num_test, noise=args.noise, seed=args.seed,
        ivector_dim=args.ivector_dim)
    write_corpus_tree(corpus, args.root)
    recog = Path(args.root) / "recog"
    save_image(str(recog / "kaldiTri1909.img"), img)
    np.save(recog / "log_ap_Kaldi1909.npy", corpus.log_priors)
    print(f"synthetic corpus at {args.root}: "
          f"{corpus.train.num_frames} train frames, "
          f"{img.num_states} pdfs, {img.num_phones} phones")


if __name__ == "__main__":
    main()
