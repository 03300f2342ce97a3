"""Posterior-parity gate: converts a reference-trained Chainer ``.npz``
checkpoint into this package's parameters and checks framewise
log-posterior agreement between the converted model and
reference-computed outputs.

Counterpart of ``nnacousticmodeling_tpu/pipeline/parity.py`` with the
same arguments, printed lines and True/False result, plus what every
CLI of this package has: ``--device`` (default ``cuda``) and
``--scan-impl``. Without ``--reference-posteriors`` it converts, runs
and writes the posteriors for an outside comparison.

Run: ``python -m nnacousticmodeling_tpu_torch.pipeline.parity
--checkpoint model.npz -n lstm -l 4 -u 1024 --tri
--reference-posteriors ref_posteriors.npy [--device cpu]``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..infer import ff_log_posteriors, rnn_log_posteriors
from ..models import TDNN, is_recurrent
from ..models.convert import convert_checkpoint, to_port_params
from ..utils.device import resolve_device
from .common import (
    add_data_args, add_network_args, build_network, effective_splice,
    load_transform, num_classes_for, prepare_features,
)


def main(arg_list=None):
    parser = argparse.ArgumentParser(description="Chainer parity gate")
    add_network_args(parser)
    add_data_args(parser)
    parser.add_argument("--checkpoint", required=True,
                        help="reference Chainer .npz model")
    parser.add_argument("--split", default="test")
    parser.add_argument("--out", default="parity_posteriors.npy")
    parser.add_argument("--reference-posteriors",
                        help=".npy of reference-computed log posteriors "
                             "for the same split")
    parser.add_argument("--atol", type=float, default=1e-4)
    parser.add_argument("--chainer-prefix", default="predictor")
    args = parser.parse_args(list(map(str, arg_list)) if arg_list is not None
                             else None)
    device = resolve_device(args.device)
    num_classes = num_classes_for(args)

    x = np.load(str(Path(args.data_dir, args.data.format(args.split))))
    offsets = None
    if is_recurrent(args.network):
        offsets = np.load(str(Path(args.offset_dir,
                                   args.offsets.format(args.split))))
    iv = (np.load(str(Path(args.ivector_dir,
                           args.ivectors.format(args.split))))
          if args.ivector_dir else None)
    splice = effective_splice(args)
    ft = load_transform(args, splice)
    x = prepare_features(x, args, splice, ft, iv)

    if args.network == "tdnn":
        # the reference's raw channel reshape (models/convert.py)
        net = TDNN(units=tuple(args.units), num_classes=num_classes,
                   ksize=tuple(args.tdnn_ksize), chainer_layout=True,
                   in_dim=x.shape[1], device=device)
    else:
        net = build_network(args, num_classes, x.shape[1], device)
    tree = convert_checkpoint(args.checkpoint, args.network, args.layers,
                              args.chainer_prefix)
    net.load_state_dict(to_port_params(tree, net))

    if is_recurrent(args.network):
        lp = rnn_log_posteriors(net, x, offsets, timedelay=args.timedelay)
    else:
        lp = ff_log_posteriors(net, x)
    np.save(args.out, lp)
    print(f"wrote {lp.shape} posteriors to {args.out}")

    if args.reference_posteriors:
        ref = np.load(args.reference_posteriors)
        if ref.shape != lp.shape:
            print(f"PARITY FAIL: shape {lp.shape} vs reference {ref.shape}")
            return False
        diff = np.abs(lp - ref)
        ok = bool((diff <= args.atol).all())
        print(f"max abs diff {diff.max():.3e}  mean {diff.mean():.3e}  "
              f"atol {args.atol}: {'PARITY OK' if ok else 'PARITY FAIL'}")
        return ok
    return True


if __name__ == "__main__":
    main()
