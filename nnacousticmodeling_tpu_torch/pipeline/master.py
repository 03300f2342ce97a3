"""Master orchestrator: chains the six phases (generate folds, train
the master, train the folds, predict the fold outputs, train the RPL,
evaluate every ensemble combination) in-process by composing argv
lists, with the derived output-directory layout
``results/{fold_data,fold_data_out,models/{folds,master,rpl}}/<K>/<id>``.

Counterpart of ``nnacousticmodeling_tpu/pipeline/master.py`` (the twin
of the reference's ``scripts/common/master_script.py``) with the same
argv, plus what every CLI of this package has: ``--device`` (default
``cuda``) and ``--scan-impl``, forwarded to every phase that runs a
network. ``main`` returns ``{(split, tag): PER}`` of the evaluation
sweep. ``--fold-parallel`` trains the K folds in one ``train_cli
--train-all-folds`` call. ``--mesh`` is forwarded to every training call
(JAX ``master.py:173-174``) and checked against the world first. Across
ranks (``--distributed``: the process group from ``torchrun``'s
environment, or one the caller set up), every rank runs the
training phases (rank 0 writes their models), rank 0 alone runs the
phases that only read and write files and the card (fold generation,
predictions, evaluation), and the other ranks wait for it
(``parallel.distributed.host_phase_barrier``); rank 0 returns the PERs,
the others an empty dict.

Run: ``python -m nnacousticmodeling_tpu_torch.pipeline.master [args]``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..parallel.distributed import host_phase_barrier, initialize_distributed
from ..parallel.mesh import check_world, parse_mesh_spec
from ..utils.device import resolve_device
from .common import str2bool
from .evaluate import main as evaluate_main
from .generate_folds import main as generate_folds_main
from .predict_folds import main as predict_folds_main
from .train_cli import main as train_main


def build_parser():
    parser = argparse.ArgumentParser(description="Master pipeline")
    parser.add_argument("--num-folds", type=int, default=0)
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--offset-dir", default="data")
    parser.add_argument("--target-dir", default="data")
    parser.add_argument("--ivector-dir", nargs=2,
                        help="train and test i-vector directories")
    parser.add_argument("--utt-list-dir", default="data")
    parser.add_argument("--recog-dir", default="recog")
    parser.add_argument("--output-dir", default="results")
    parser.add_argument("--data", default="data_{}.npy")
    parser.add_argument("--offsets", default="offsets_{}.npy")
    parser.add_argument("--targets", default="targets_{}.npy")
    parser.add_argument("--ivectors", default="ivectors_{}.npy")
    parser.add_argument("--ft", default="-")
    parser.add_argument("--image", default="kaldiTri1909.img")
    parser.add_argument("--ap-file", default="log_ap_Kaldi1909.npy")
    parser.add_argument("--phone-map", default="phones.60-48-39.map")
    parser.add_argument("--output-id", default="tmp")
    parser.add_argument("--network-spec",
                        default="-n lstm -l 4 -u 1024 --timedelay 5 -d 0.2")
    parser.add_argument("--rpl-train-setup",
                        default="-b 1024 --epoch 20 -o adam --lr 1e-3")
    parser.add_argument("--epoch", "-e", type=int, nargs="+", default=[20])
    parser.add_argument("--optimizer", "-o", nargs="+",
                        default=["adam", "momentumsgd"])
    parser.add_argument("--batch-size", "-b", type=int, nargs="+",
                        default=[256, 128])
    parser.add_argument("--lr", type=float, nargs="+",
                        default=[1e-2, 1e-3, 1e-4, 1e-5])
    parser.add_argument("--early-stopping", type=str2bool, nargs="+",
                        default=[True])
    parser.add_argument("--fold-data-dir")
    parser.add_argument("--fold-output-dir")
    parser.add_argument("--fold-model-dir")
    parser.add_argument("--fold-output-dev", default="data_dev.npy")
    parser.add_argument("--fold-data-pattern", default="data_{}.npy")
    parser.add_argument("--fold-offset-pattern", default="offsets_{}.npy")
    parser.add_argument("--fold-target-pattern", default="targets_{}.npy")
    parser.add_argument("--fold-ivector-pattern", default="ivectors_{}.npy")
    parser.add_argument("--fold-output-pattern", default="data_{}.npy")
    parser.add_argument("--fold-network-pattern", default="fold_{}.npz")
    parser.add_argument("--master-dir")
    parser.add_argument("--rpl-dir")
    parser.add_argument("--PIP", type=float, default=20)
    parser.add_argument("--LMW", type=float, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gen-folds", action="store_true")
    parser.add_argument("--no-train-master", action="store_true")
    parser.add_argument("--no-train-folds", action="store_true")
    parser.add_argument("--no-predict", action="store_true")
    parser.add_argument("--no-train-rpl", action="store_true")
    parser.add_argument("--no-eval", action="store_true")
    parser.add_argument("--eval-only-master", action="store_true")
    parser.add_argument("--no-progress", action="store_true")
    parser.add_argument("--eval-data", nargs="+", default=["test"])
    parser.add_argument("--num-classes", type=int, default=None,
                        help="explicit class count forwarded to all phases")
    parser.add_argument("--tri", action="store_true",
                        help="accepted for shell-surface compatibility; the "
                             "master pipeline always runs its phases in "
                             "triphone (1909-class) mode, exactly like the "
                             "reference (master_script.py:103,137,177), so "
                             "this flag is implied")
    parser.add_argument("--fold-parallel", action="store_true",
                        help="train all K fold networks together in one "
                             "train_cli --train-all-folds call instead of "
                             "one call a fold")
    parser.add_argument("--mesh", default="",
                        help="rank mesh spec forwarded to training, e.g. "
                             "data=2,model=2 (see train_cli --mesh)")
    parser.add_argument("--distributed", action="store_true",
                        help="join the torch.distributed process group "
                             "(env:// as torchrun sets it) before any "
                             "phase")
    parser.add_argument("--device", default="cuda",
                        help="torch device every phase runs on (default "
                             "cuda; pass cpu to run without a card)")
    parser.add_argument("--scan-impl", default="auto",
                        choices=("auto", "xla", "pallas"),
                        help="recurrent sequence runner forwarded to every "
                             "phase ('auto': the kernels on CUDA)")
    return parser


def main(arg_list=None):
    parser = build_parser()
    args = parser.parse_args(list(map(str, arg_list)) if arg_list is not None
                             else None)
    if args.distributed:
        initialize_distributed(device=args.device)
    resolve_device(args.device)
    if args.mesh:
        # a mesh the world cannot hold fails here, before any phase
        check_world(parse_mesh_spec(args.mesh))
    host, wait = host_phase_barrier()
    run_on = ["--device", args.device, "--scan-impl", args.scan_impl]

    # derived directory layout (master_script.py:62-75)
    if args.fold_data_dir is None:
        base = Path(args.data_dir).name
        if args.ivector_dir:
            base += "+" + Path(args.ivector_dir[0]).name
        args.fold_data_dir = f"{args.output_dir}/fold_data/{args.num_folds}/{base}"
    if args.fold_output_dir is None:
        args.fold_output_dir = (f"{args.output_dir}/fold_data_out/"
                                f"{args.num_folds}/{args.output_id}")
    if args.fold_model_dir is None:
        args.fold_model_dir = (f"{args.output_dir}/models/folds/"
                               f"{args.num_folds}/{args.output_id}")
    if args.master_dir is None:
        args.master_dir = (f"{args.output_dir}/models/master/"
                           f"{args.num_folds}/{args.output_id}")
    if args.rpl_dir is None:
        args.rpl_dir = (f"{args.output_dir}/models/rpl/"
                        f"{args.num_folds}/{args.output_id}")

    net_spec = args.network_spec.split()
    results = {}

    # phase 1: generate folds
    if args.num_folds > 0 and args.gen_folds and host:
        print("==== Generating folds")
        cmd = ["-n", args.num_folds,
               "--data-dir", args.data_dir,
               "--offset-dir", args.offset_dir,
               "--target-dir", args.target_dir,
               "--fold-data-dir", args.fold_data_dir,
               "--utt-list-dir", args.utt_list_dir,
               "--train-list", "train.list",
               "--data", args.data.format("train"),
               "--offsets", args.offsets.format("train"),
               "--targets", args.targets.format("train"),
               "--fold-data-pattern", args.fold_data_pattern,
               "--fold-offset-pattern", args.fold_offset_pattern,
               "--fold-target-pattern", args.fold_target_pattern,
               "--seed", args.seed]
        if args.ivector_dir:
            cmd += ["--ivector-dir", args.ivector_dir[0],
                    "--fold-ivector-pattern", args.fold_ivector_pattern]
        generate_folds_main(cmd)
    elif host:
        print("==== Skipping fold data generation")
    wait()

    def _classes():
        return (["--num-classes", args.num_classes]
                if args.num_classes else [])

    def train_cmd(extra):
        cmd = ["--tri", "--noplot", "--seed", args.seed] + _classes() + ["-b"]
        cmd += args.batch_size
        cmd += ["--epoch"] + args.epoch
        cmd += ["-o"] + args.optimizer
        cmd += ["--lr"] + args.lr
        cmd += ["--early-stopping"] + args.early_stopping
        cmd += ["--data-dir", args.data_dir,
                "--offset-dir", args.offset_dir,
                "--target-dir", args.target_dir,
                "--data", args.data,
                "--offsets", args.offsets,
                "--targets", args.targets,
                "--ivectors", args.ivectors,
                "--ft", args.ft]
        cmd += extra + run_on
        cmd += net_spec
        if args.ivector_dir:
            cmd += ["--ivector-dir", args.ivector_dir[0]]
        if args.no_progress:
            cmd += ["--no-progress"]
        if args.mesh:
            cmd += ["--mesh", args.mesh]
        return cmd

    # phase 2: train master
    if not args.no_train_master:
        print("==== Training master network")
        train_main(train_cmd(["--out", args.master_dir]))
    else:
        print("==== Skipping training master network")

    # phase 3: train folds
    fold_cmd_common = [
        "--fold-data-dir", args.fold_data_dir,
        "--fold-model-dir", args.fold_model_dir,
        "--fold-data-pattern", args.fold_data_pattern,
        "--fold-offset-pattern", args.fold_offset_pattern,
        "--fold-target-pattern", args.fold_target_pattern,
        "--fold-network-pattern", args.fold_network_pattern,
        # fold-training scratch output (args.txt/log/curves) lives in
        # the derived results tree, not CWD
        "--out", str(Path(args.fold_model_dir) / "result_fold_tmp")]
    if args.num_folds > 0 and not args.no_train_folds:
        if args.fold_parallel:
            print(f"==== Training all {args.num_folds} folds in parallel")
            train_main(train_cmd(["--train-all-folds"] + fold_cmd_common))
        else:
            for fold in range(args.num_folds):
                print(f"==== Training fold {fold}")
                train_main(train_cmd(["--train-fold", fold]
                                     + fold_cmd_common))
    else:
        print("==== Skipping training folds")

    # phase 4: predict fold outputs (train folds, then dev)
    if args.num_folds > 0 and not args.no_predict and host:
        print("==== Predicting training data")
        cmd = ["--tri"] + _classes() + ["--ft", args.ft,
               "--data-dir", args.data_dir,
               "--fold-data-dir", args.fold_data_dir,
               "--fold-output-dir", args.fold_output_dir,
               "--fold-model-dir", args.fold_model_dir,
               "--fold-data-pattern", args.fold_data_pattern,
               "--fold-offset-pattern", args.fold_offset_pattern,
               "--fold-network-pattern", args.fold_network_pattern,
               "--fold-output-pattern", args.fold_output_pattern]
        cmd += run_on + net_spec
        if args.ivector_dir:
            cmd += ["--ivector-dir", args.ivector_dir[0],
                    "--fold-ivector-pattern", args.fold_ivector_pattern]
        predict_folds_main(cmd)

        print("==== Predicting development data")
        cmd = ["--tri"] + _classes() + ["--ft", args.ft,
               "--data-dir", args.data_dir,
               "--offset-dir", args.offset_dir,
               "--data", args.data,
               "--offsets", args.offsets,
               "--fold-output-dir", args.fold_output_dir,
               "--fold-model-dir", args.fold_model_dir,
               "--fold-network-pattern", args.fold_network_pattern,
               "--fold-output-dev", args.fold_output_dev]
        cmd += run_on + net_spec
        if args.ivector_dir:
            cmd += ["--ivector-dir", args.ivector_dir[0],
                    "--fold-ivector-pattern", args.fold_ivector_pattern]
        predict_folds_main(cmd)
    elif host:
        print("==== Skipping predicting training and development data")
    wait()

    # phase 5: train RPL
    if args.num_folds > 0 and not args.no_train_rpl:
        print("==== Training RPL layer")
        cmd = ["--train-rpl", "--tri", "--seed", args.seed] + _classes() + [
               "--data-dir", args.fold_output_dir,
               "--target-dir", args.target_dir,
               "--data", args.fold_output_dev,
               "--targets", args.targets,
               "--fold-data-dir", args.fold_data_dir,
               "--fold-output-dir", args.fold_output_dir,
               "--fold-output-pattern", args.fold_output_pattern,
               "--fold-target-pattern", args.fold_target_pattern,
               "--out", args.rpl_dir] + run_on
        cmd += args.rpl_train_setup.split()
        train_main(cmd)
    else:
        print("==== Skipping training RPL layer")

    # phase 6: evaluate the 2^3 ensemble combinations
    if not args.no_eval and host:
        for eval_data in args.eval_data:
            print(f"==== Evaluating {eval_data} data")
            for eval_folds in [False, True]:
                for eval_master in [False, True]:
                    for eval_rpl in [False, True]:
                        if ((args.num_folds == 0 or args.eval_only_master)
                                and (eval_folds or not eval_master or eval_rpl)):
                            continue
                        if not (eval_folds or eval_master):
                            continue
                        tag = "{}folds {}master {}rpl".format(
                            "+" if eval_folds else "-",
                            "+" if eval_master else "-",
                            "+" if eval_rpl else "-")
                        print(f"==== Evaluating {tag}")
                        cmd = ["--tri"] + _classes() + [
                               "--data-dir", args.data_dir,
                               "--offset-dir", args.offset_dir,
                               "--utt-list-dir", args.utt_list_dir,
                               "--data", args.data,
                               "--offsets", args.offsets,
                               "--ivectors", args.ivectors,
                               "--ft", args.ft,
                               "--recog-dir", args.recog_dir,
                               "--image", args.image,
                               "--ap-file", args.ap_file,
                               "--phone-map", args.phone_map,
                               "--rpl",
                               "--rpl-model",
                               f"{args.rpl_dir}/model" if eval_rpl else "-",
                               "--master-network",
                               f"{args.master_dir}/model" if eval_master else "-",
                               "--PIP", args.PIP,
                               "--LMW", args.LMW,
                               "--fold-model-dir", args.fold_model_dir,
                               "--fold-network-pattern",
                               args.fold_network_pattern if eval_folds else "-",
                               "--test-or-dev", eval_data]
                        cmd += run_on + net_spec
                        if args.ivector_dir:
                            cmd += ["--ivector-dir", args.ivector_dir[1]]
                        per = evaluate_main(cmd)
                        results[(eval_data, tag)] = per
    elif host:
        print("==== Skipping evaluation")
    wait()
    return results


if __name__ == "__main__":
    main()
