"""Evaluation: assembles the (master + folds + RPL) ensemble, or the
single ``--model``, computes prior-subtracted log posteriors over the
test or dev set, decodes them with the triphone Viterbi on the card,
maps phones 48->39 and prints ``PER: xx.xx %``.

Counterpart of ``nnacousticmodeling_tpu/pipeline/evaluate.py`` with the
same argv surface plus ``--device``: feed-forward nets (frame chunks, no
offsets) and recurrent nets, ``--rpl`` ensembles through
``assemble_params``. As in the JAX package, the posteriors decode with
``timedelay=0`` even for a net trained with ``--timedelay`` (the
reference's eval path does not compensate it). ``--decoder native``
decodes with the C++ host decoder (``decoder/native.py``) on host
threads, the posteriors still computed on the device; ``--lm-from-mlf``
estimates a phone bigram from transcripts (``decoder/graph.py``) and
decodes with it on either decoder, the native one reading the rebuilt
image from a temporary directory, as in the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile
from pathlib import Path

import numpy as np

from ..decoder import ViterbiDecoder, compute_per
from ..decoder.corpus_decode import decode_corpus
from ..decoder.graph import (cube_phone_names, estimate_bigram_lm,
                             image_with_bigram_lm)
from ..decoder.image import load_image, save_image
from ..decoder.native import NativeDecoder
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
                        help="decode on the device (tpu) or with the C++ "
                             "host library on host threads (native)")
    parser.add_argument("--beam", type=float, default=0,
                        help="beam width: prune biphone scores below "
                             "(frame max - beam) each frame; 0 = exact "
                             "Viterbi")
    parser.add_argument("--lm-from-mlf", nargs="+", default=None,
                        help="estimate a phone-bigram LM from these MLF "
                             "transcript files and decode with it "
                             "instead of the image's stored LM")
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

    # ---- decode --------------------------------------------------------
    beam = args.beam if args.beam and args.beam > 0 else None
    image_path = str(Path(args.recog_dir, args.image))
    # the native decoder reads the image file itself
    img = (load_image(image_path)
           if args.decoder != "native" or args.lm_from_mlf else None)
    if args.lm_from_mlf:
        # a phone bigram from transcripts, counted through the 48->39 map
        # when the recog dir has one (JAX evaluate.py:163-178)
        words = {}
        for f in args.lm_from_mlf:
            words.update({u: e.words for u, e in load_mlf(f).items()})
        pm_path = Path(args.recog_dir, args.phone_map)
        img = image_with_bigram_lm(img, estimate_bigram_lm(
            words, cube_phone_names(img),
            str(pm_path) if args.phone_map != "-" and pm_path.is_file()
            else None))
    if args.decoder == "native":
        with contextlib.ExitStack() as stack:
            if args.lm_from_mlf:
                # the native decoder reads an image file: the rebuilt one
                # lives as long as this block
                tmpd = stack.enter_context(
                    tempfile.TemporaryDirectory(prefix="nnam_lm_"))
                image_path = str(Path(tmpd) / "lm_image.img")
                save_image(image_path, img)
            dec = NativeDecoder(image_path, pip=args.PIP, lmw=args.LMW,
                                beam=beam)
            results = dec.decode_batch(
                [np.ascontiguousarray(lp[offsets[u]:offsets[u + 1]])
                 for u in range(len(utt_list))])
    else:
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
