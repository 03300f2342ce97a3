"""Evaluation: assembles the (master + folds + RPL) ensemble, or the
single ``--model``, computes prior-subtracted log posteriors over the
test or dev set, decodes them with the triphone Viterbi on the card,
maps phones 48->39 and prints ``PER: xx.xx %``.

Counterpart of ``nnacousticmodeling_tpu/pipeline/evaluate.py`` with the
same argv surface plus ``--device``: feed-forward nets (frame chunks, no
offsets) and recurrent nets, ``--rpl`` ensembles through
``assemble_params``. As in the JAX package, the posteriors decode with
``timedelay=0`` even for a net trained with ``--timedelay`` (the
reference's eval path does not compensate it). Not ported yet (they
raise): ``--decoder native`` and ``--lm-from-mlf``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..decoder import ViterbiDecoder, compute_per
from ..decoder.corpus_decode import decode_corpus
from ..decoder.image import load_image
from ..infer import ensemble_log_posteriors
from ..io import load_mlf, load_phone_map, load_utt_list, write_mlf
from ..io.mlf import MlfEntry
from ..models import RPL4, Ensemble, stack_fold_params
from ..train import load_jax_params, load_pytree
from ..utils.device import resolve_device
from .common import (
    add_data_args, add_network_args, build_network, effective_splice,
    load_transform, num_classes_for, prepare_features,
)


def build_parser():
    parser = argparse.ArgumentParser(description="Evaluate PER")
    add_network_args(parser)
    add_data_args(parser)
    parser.add_argument("--model", "-m", default="",
                        help="single-model path (without --rpl)")
    parser.add_argument("--recog-dir", required=True)
    parser.add_argument("--utt-list-dir", default="data")
    parser.add_argument("--image", default="kaldiTri1909.img",
                        help="decoding image file inside recog-dir")
    parser.add_argument("--PIP", type=float, default=20)
    parser.add_argument("--LMW", type=float, default=1)
    parser.add_argument("--ap-coef", type=float, default=1)
    parser.add_argument("--ap-file", default="log_ap_Kaldi1909.npy",
                        help="log-priors npy in recog-dir ('-' disables "
                             "prior subtraction)")
    parser.add_argument("--phone-map", default="phones.60-48-39.map",
                        help="48->39 map in recog-dir ('-' = identity)")
    parser.add_argument("--test-or-dev", default="test")
    parser.add_argument("--rpl", action="store_true",
                        help="ensemble mode (master/folds/rpl)")
    parser.add_argument("--rpl-model", default="result_rpl/model")
    parser.add_argument("--fold-model-dir", default="fold_models")
    parser.add_argument("--fold-network-pattern", default="fold_{0}.npz")
    parser.add_argument("--master-network", default="-")
    parser.add_argument("--out-mlf", default=None,
                        help="write the decoded MLF here")
    parser.add_argument("--decoder", default="tpu",
                        choices=["tpu", "native"],
                        help="decode in-process on the device (tpu); the "
                             "C++ host library (native) is not ported yet")
    parser.add_argument("--beam", type=float, default=0,
                        help="beam width: prune biphone scores below "
                             "(frame max - beam) each frame; 0 = exact "
                             "Viterbi")
    parser.add_argument("--lm-from-mlf", nargs="+", default=None,
                        help="not ported yet")
    parser.add_argument("--no-progress", action="store_true")
    return parser


def _model_path(p: str) -> str:
    return p if p.endswith(".npz") else p + ".npz"


def _load_net_params(path, net, device):
    """A checkpoint's params, read through ``net`` (whose
    ``load_state_dict`` also takes the optional converted-checkpoint
    biases of the gated nets) and copied out by name."""
    net.load_state_dict(load_jax_params(path, device))
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def assemble_params(args, net, num_classes: int, device):
    """Load the master / fold / RPL checkpoints into ``Ensemble`` params
    (evaluate.py:105-132): the single ``--model`` without ``--rpl``;
    with it the ``--master-network`` unless ``-``, the folds of
    ``--fold-model-dir`` fold-ascending until the first missing one
    unless the pattern is ``-``, and the RPL4 ``--rpl-model`` unless
    ``-``."""
    params = {"master": None, "folds": None, "rpl": None}
    if not args.rpl:
        params["master"] = _load_net_params(_model_path(args.model), net,
                                            device)
        return Ensemble(network=net, rpl=None, num_folds=0), params

    if args.master_network != "-":
        print("Loading master network")
        params["master"] = _load_net_params(
            _model_path(args.master_network), net, device)
    folds = []
    if args.fold_network_pattern != "-":
        fold = 0
        while True:
            f = Path(args.fold_model_dir,
                     args.fold_network_pattern.format(fold))
            if not f.is_file():
                break
            print(f"Loading fold {fold} network")
            folds.append(_load_net_params(str(f), net, device))
            fold += 1
    if folds:
        params["folds"] = stack_fold_params(folds)
    rpl = None
    if args.rpl_model != "-":
        rpl = RPL4(num_classes, device=device)
        params["rpl"] = load_pytree(_model_path(args.rpl_model), rpl)
    return Ensemble(network=net, rpl=rpl, num_folds=len(folds)), params


def main(arg_list=None):
    parser = build_parser()
    args = parser.parse_args(list(map(str, arg_list)) if arg_list is not None
                             else None)
    if args.decoder == "native":
        raise NotImplementedError("--decoder native is not ported yet "
                                  "(ROADMAP Queue 1, \"The native decoder, "
                                  "the graph helpers and the rest of "
                                  "io/\")")
    if args.lm_from_mlf:
        raise NotImplementedError("--lm-from-mlf needs decoder/graph.py's "
                                  "bigram helpers, not the native decoder; "
                                  "they are not ported yet (ROADMAP Queue "
                                  "1, \"The native decoder, the graph "
                                  "helpers and the rest of io/\")")
    device = resolve_device(args.device)
    num_classes = num_classes_for(args)
    split = args.test_or_dev

    # ---- data (evaluate.py:163-171) -----------------------------------
    x = np.load(str(Path(args.data_dir, args.data.format(split))))
    offsets = np.load(str(Path(args.offset_dir, args.offsets.format(split))))
    iv = (np.load(str(Path(args.ivector_dir, args.ivectors.format(split))))
          if args.ivector_dir else None)
    splice = effective_splice(args)
    ft = load_transform(args, splice)
    x = prepare_features(x, args, splice, ft, iv)

    utt_list = load_utt_list(str(Path(args.utt_list_dir, f"{split}.list")))
    if len(utt_list) != len(offsets) - 1:
        raise ValueError("wrong number of utterances")

    net = build_network(args, num_classes, x.shape[1], device)
    ens, params = assemble_params(args, net, num_classes, device)

    # ---- posteriors with prior subtraction (evaluateModelForTest.py:75-77)
    ap = None
    if args.ap_file != "-":
        ap_file = Path(args.recog_dir, args.ap_file)
        if not ap_file.is_file():
            raise FileNotFoundError(
                f"log-priors file {ap_file} not found (the reference "
                f"requires it under --tri); pass --ap-file - to decode "
                f"without prior subtraction")
        ap = args.ap_coef * np.load(str(ap_file))
    lp = ensemble_log_posteriors(
        ens, params, x, offsets=offsets if net.is_recurrent else None,
        ap=ap, timedelay=0)
    # the reference's eval path does not compensate --timedelay
    # (evaluateModelForTest.py:36), so the unshifted sequence decodes

    # ---- decode on the device -----------------------------------------
    beam = args.beam if args.beam and args.beam > 0 else None
    img = load_image(str(Path(args.recog_dir, args.image)))
    dec = ViterbiDecoder(img, pip=args.PIP, lmw=args.LMW, beam=beam,
                         device=device)
    results = decode_corpus(dec, lp, offsets)

    # ---- 48->39 mapping + scoring (evaluateModelForTest.py:128-133) ---
    pm = None
    if args.phone_map != "-":
        pm_file = Path(args.recog_dir, args.phone_map)
        if pm_file.is_file():
            pm = load_phone_map(str(pm_file))
    test_mlf = {}
    mlf_entries = []
    for i, (utt, res) in enumerate(zip(utt_list, results)):
        words = [pm.get(p, p) if pm else p for p in res.phones]
        test_mlf[utt] = MlfEntry(words=words, orig_id=i)
        mlf_entries.append((utt, [(b, e, w) for (b, e, _), w in
                                  zip(res.segments, words)]))
    if args.out_mlf:
        Path(args.out_mlf).parent.mkdir(exist_ok=True, parents=True)
        write_mlf(args.out_mlf, mlf_entries)

    ref = load_mlf(str(Path(args.recog_dir, f"{split}_ref.mlf")))
    per = compute_per(test_mlf, ref, nist=True)
    print(f"PER: {per:.2f} %")
    return per


if __name__ == "__main__":
    main()
