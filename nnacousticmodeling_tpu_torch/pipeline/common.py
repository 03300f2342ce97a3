"""Shared pipeline helpers: argparse fragments, data preparation and
model construction (counterpart of the JAX package's
``pipeline/common.py``, the subset the evaluation and training paths
use)."""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np

from ..io.kaldi import (
    FeatureTransform, apply_feature_transform, load_feature_transform,
    specialize_transform_center, specialize_transform_tiled,
)
from ..models import get_network, is_recurrent
from ..ops.splice import splice_flat


def str2bool(v: str) -> bool:
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def add_network_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--network", "-n", default="ff",
                        help='Network type: ff, tdnn, lstm, zoneoutlstm, '
                             'zoneoutdropoutlstm, peepholelstm, gru, '
                             'mgrurelu, mgrurelur')
    parser.add_argument("--units", "-u", type=int, nargs="+", default=[1024])
    parser.add_argument("--layers", "-l", type=int, default=2)
    parser.add_argument("--activation", "-a", default="relu")
    parser.add_argument("--tdnn-ksize", type=int, nargs="+", default=[5])
    parser.add_argument("--dropout", "-d", type=float, nargs="+", default=[0])
    parser.add_argument("--timedelay", type=int, default=0)
    parser.add_argument("--splice", type=int, default=0)
    parser.add_argument("--tri", action="store_true",
                        help="Use 1909 tied-triphone classes (39 mono "
                             "otherwise)")
    parser.add_argument("--num-classes", type=int, default=None,
                        help="explicit output class count (overrides the "
                             "--tri 1909/39 convention, e.g. for synthetic "
                             "corpora)")
    parser.add_argument("--scan-impl", default="auto",
                        choices=("auto", "xla", "pallas"),
                        help="recurrent sequence runner: 'xla' (float32 "
                             "step loop, the lax.scan twin) or 'pallas' "
                             "(the hand-written CUDA recurrence kernels, "
                             "bf16 matmul operands; their plain versions on "
                             "the CPU). 'auto' = pallas on CUDA, xla "
                             "elsewhere")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; pass "
                             "cpu to run without a card)")


def add_data_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--offset-dir", default="data")
    parser.add_argument("--target-dir", default="data")
    parser.add_argument("--ivector-dir")
    parser.add_argument("--data", default="data_{}.npy")
    parser.add_argument("--offsets", default="offsets_{}.npy")
    parser.add_argument("--targets", default="targets_{}.npy")
    parser.add_argument("--ivectors", default="ivectors_{}.npy")
    parser.add_argument("--ft", default="-",
                        help="Kaldi feature transform file in data-dir "
                             "('-' disables)")


def num_classes_for(args) -> int:
    if getattr(args, "num_classes", None):
        return args.num_classes
    return 1909 if args.tri else 39


def build_network(args, num_classes: int, in_dim: int, device):
    """The network named by ``args`` on ``device``, its weights drawn from
    ``args.seed`` where the parser has one; ``--scan-impl auto`` picks
    the kernel path on CUDA and the float32 loop elsewhere."""
    impl = getattr(args, "scan_impl", "auto")
    if impl == "auto":
        impl = "pallas" if device.type == "cuda" else "xla"
    return get_network(args.network, args.layers, args.units, num_classes,
                       args.activation, args.tdnn_ksize,
                       args.dropout if isinstance(args.dropout, list)
                       else [args.dropout],
                       in_dim=in_dim, scan_impl=impl, device=device,
                       seed=getattr(args, "seed", 0))


def effective_splice(args) -> int:
    """TDNN derives its splice from the kernel sizes (train.py:224-227)."""
    if args.network == "tdnn":
        return (sum(args.tdnn_ksize) - len(args.tdnn_ksize)) // 2
    return args.splice


def load_transform(args, splice: int) -> Optional[FeatureTransform]:
    """Load + specialize the feature transform the way the reference
    does per network type (train.py:233-249)."""
    if args.ft is None or args.ft == "-":
        return None
    ft = load_feature_transform(str(Path(args.data_dir, args.ft)))
    if is_recurrent(args.network):
        return specialize_transform_center(ft)
    if args.network == "tdnn":
        return specialize_transform_tiled(ft, splice)
    return ft


def prepare_features(x: np.ndarray, args, splice: int,
                     ft: Optional[FeatureTransform],
                     ivectors: Optional[np.ndarray]) -> np.ndarray:
    """splice -> feature transform -> i-vector concat
    (train.py:224-258)."""
    if splice > 0:
        x = splice_flat(x, range(-splice, splice + 1))
    if ft is not None:
        x = apply_feature_transform(x, ft).astype(np.float32)
    if ivectors is not None:
        x = np.concatenate((x, ivectors), axis=1)
    return x


def dump_args(args, out_dir: str) -> None:
    """Echo all args to <out>/args.txt (train.py:88-98)."""
    Path(out_dir).mkdir(exist_ok=True, parents=True)
    with open(Path(out_dir) / "args.txt", "w") as f:
        for attr in sorted(vars(args)):
            f.write(f"# {attr}: {getattr(args, attr)}\n")
