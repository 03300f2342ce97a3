"""Staged training engine: feed-forward and recurrent (multi-stream
TBPTT) stages.

Counterpart of ``nnacousticmodeling_tpu/train/engine.py`` (``:46-488``,
``:492-757``), with the behaviour that decides parity kept as it is
there:

* feed-forward (``_make_ff_stage``, JAX ``:525-624``): each epoch draws
  ``rng_np.permutation(n)[:steps*bs]`` with ``steps = max(n // bs, 1)``
  (SerialIterator semantics; the final partial batch is dropped), or
  with ``shuffle_sequences`` one frame from each of ``bs`` streams over
  the sentence-shuffled corpus a minibatch; one device gather and one
  update a minibatch; loss the batch-mean softmax cross-entropy;
  validation in ``eval_chunk``-frame chunks, the loss summed over the
  dev frames and divided by their count (eager PyTorch compiles nothing
  per shape, so the tail chunk runs at its own length instead of padded
  and masked); ``apply_fn(params, xb, generator, train) -> logits`` may
  replace the network's own forward (the JAX ``apply_fn``), with
  ``params`` the network's parameters by name;
* multi-stream truncated BPTT: B streams over the sentence-shuffled
  corpus at stride N//B (``train/streams.py``, the same numpy shuffle as
  the JAX package, so one ``seed`` draws the same minibatches), each
  update one device gather and ``bprop_len`` steps; the recurrent state
  is carried across updates and epochs within a stage as a constant
  (detached after every update; JAX differentiates w.r.t. the params
  only) and reset at stage starts; a layer's state is ``(c, h)`` for the
  LSTM and ``(h, fresh)`` for the gated nets, two leaves either way;
* loss: per-frame softmax cross-entropy, mean over the batch, summed
  over the ``bprop_len`` steps (Chainer's BPTTUpdater), reported / L;
* per-stage optimizer rebuild (sgd / momentumsgd / adam), early stopping
  on validation loss (eps -0.001), and the stage-end rule: fixed-epoch
  stages reload the best-validation model, early-stopping stages keep
  the last;
* validation on the dev set in ``bs`` in-order streams over a fresh
  state, without dropout and under ``torch.inference_mode`` (so the
  ``pallas`` route runs the ``lstm_scan`` / ``gated_scan`` inference
  kernels);
* per-epoch snapshots (atomic tmp + rename) and bit-exact resume, mid-
  stage and at a stage boundary.

PyTorch runs eagerly, so the JAX ``dispatch`` modes (``scan``: one
compiled program per epoch; ``per_step``: one per update) have no
counterpart: all three values are accepted and run the same per-update
loop. Dropout masks come from one ``torch.Generator`` seeded with
``seed`` (in the place of the JAX key); the two frameworks draw
different masks.

``compute_dtype="bfloat16"`` casts the params and inputs inside autograd
(``models.precision``) in both kinds of stage: bf16 products, float32
logits, master params and optimizer state (the JAX ``_mixed_apply``).

``mesh`` (a ``parallel.Mesh`` over the ranks of the process group, in
the place of the JAX ``_batch_constrainer`` / ``_mesh_place``): each
``data_axis`` rank takes its rows of every minibatch index block (its
stream states hold only those rows), the gradients are all-reduced over
``data_axis`` and divided by its size before every optimizer step, and
with a ``model_axis`` the dense layers are column-parallel
(``parallel.mesh.shard_net``). Every rank runs the whole dev set, and
rank 0's validation numbers decide early stopping and the best-model
reload on every rank (a rank that decided otherwise would deadlock the
next collective). Only rank 0 logs and writes snapshots; they hold the
whole params, optimizer state and stream state. Every rank returns the
whole params.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.precision import HalfPrecisionNet, cast_params
from ..parallel.mesh import (
    DataSplit, gather_leaves, is_primary, local_leaves, replicate, shard_net,
    unshard_net,
)
from ..utils.device import resolve_device
from .checkpoint import params_from_arrays
from .optimizers import make_optimizer
from .stages import TrainStage
from .streams import sentence_shuffle_indices, stream_batch_indices


@dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig``, same fields and defaults."""

    stages: List[TrainStage]
    bprop_len: int = 20
    seed: int = 0
    use_validation: bool = True
    log: Optional[Callable[[str], None]] = print
    eval_chunk: int = 8192
    snapshot_path: Optional[str] = None
    resume_snapshot: bool = False
    compute_dtype: str = "float32"
    mesh: Any = None
    data_axis: str = "data"
    model_axis: Optional[str] = None
    shuffle_sequences: bool = False
    epoch_hook: Optional[Callable[[int, int], None]] = None
    dispatch: str = "auto"
    defer_metrics: bool = False


@dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]
    history: List[dict] = field(default_factory=list)


_COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _compute_dtype(config):
    name = str(config.compute_dtype).replace("torch.", "")
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"unsupported compute dtype {config.compute_dtype}")
    return _COMPUTE_DTYPES[name]


def _check_dispatch(config) -> None:
    if config.dispatch not in ("auto", "per_step", "scan"):
        raise ValueError(f"dispatch must be auto|per_step|scan, got "
                         f"{config.dispatch}")


def _params_copy(net) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def _flat_state(state) -> List[torch.Tensor]:
    return [a for layer in state for a in layer]


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

def _snapshot_file(path):
    return path if path.endswith(".npz") else path + ".npz"


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _save_snapshot(path, params, opt_sd, stage, epoch, best_val, generator,
                   rng_np, best_params=None, stopped=False, rnn_state=None):
    """Full training state: params (by JAX path keys), the optimizer's
    per-parameter state (``opt_sd``, an optimizer ``state_dict``),
    progress markers, the numpy bit-generator state, the dropout
    generator state, the running best-validation params and the stream
    state, so a resumed run replays the epochs an uninterrupted run would
    have made."""
    path = _snapshot_file(path)
    blob = {k.replace(".", "/"): _np(v) for k, v in params.items()}
    for pi, st in opt_sd["state"].items():
        for name, v in st.items():
            if v is not None:
                blob[f"__opt_{pi}_{name}__"] = (
                    _np(v) if torch.is_tensor(v) else np.asarray(v))
    blob["__stage__"] = np.asarray(stage)
    blob["__epoch__"] = np.asarray(epoch)
    blob["__best_val__"] = np.asarray(
        best_val if best_val is not None else np.nan)
    blob["__stopped__"] = np.asarray(bool(stopped))
    blob["__gen_state__"] = generator.get_state().numpy()
    state = json.dumps(rng_np.bit_generator.state)
    blob["__rng_state__"] = np.frombuffer(state.encode(), dtype=np.uint8)
    if best_params is not None:
        for k, v in best_params.items():
            blob["__best__" + k.replace(".", "/")] = _np(v)
    if rnn_state is not None:
        for i, leaf in enumerate(_flat_state(rnn_state)):
            blob[f"__st_{i}__"] = _np(leaf)
    # crash-safe: write a sibling tmp file and rename it into place
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _load_snapshot(path):
    """The snapshot blob, or None (with a warning) when the file is
    truncated or otherwise unreadable."""
    try:
        with open(path, "rb") as f:
            blob = dict(np.load(f, allow_pickle=False))
        int(blob["__stage__"]), int(blob["__epoch__"])
        return blob
    except Exception as e:  # zipfile.BadZipFile, ValueError, KeyError, ...
        warnings.warn(f"snapshot {path} is unreadable ({e!r}); starting "
                      f"from scratch")
        return None


def _restore_opt_state(blob, opt, cut=None):
    """Load the snapshot's optimizer state into ``opt``; ``cut(pi, t)``
    (a mesh run's) takes this rank's part of parameter ``pi``'s whole
    state tensor ``t``."""
    sd = opt.state_dict()
    params = [p for g in opt.param_groups for p in g["params"]]
    state: Dict[int, dict] = {}
    for key, arr in blob.items():
        if not key.startswith("__opt_"):
            continue
        pi, name = key[len("__opt_"):-2].split("_", 1)
        pi = int(pi)
        t = torch.from_numpy(arr.copy())
        if name != "step" and cut is not None:
            t = cut(pi, t)
        if name != "step" and tuple(t.shape) != tuple(params[pi].shape):
            raise ValueError(f"snapshot optimizer state {key}: shape "
                             f"{tuple(t.shape)} != {tuple(params[pi].shape)}")
        state.setdefault(pi, {})[name] = t
    sd["state"] = state
    opt.load_state_dict(sd)


# ---------------------------------------------------------------------------
# mesh runs
# ---------------------------------------------------------------------------

class _MeshRun:
    """What a ``config.mesh`` changes in a run (the JAX
    ``_batch_constrainer`` and ``_mesh_place``, ``engine.py:223-262``):
    the data axis (``data``, a ``parallel.mesh.DataSplit``), the
    column-parallel layers over the model axis, and the whole params and
    states that rank 0's snapshots and every rank's result hold."""

    def __init__(self, config):
        self.mesh = config.mesh
        self.model_axis = config.model_axis
        self.data = DataSplit(config.mesh, config.data_axis,
                              [s.batch_size for s in config.stages])
        self.primary = is_primary()
        self.sharded = {}
        self.names = []

    def setup(self, net) -> None:
        """Rank 0's params on every rank, then the model-axis split."""
        net.load_state_dict(replicate(self.mesh, net.state_dict()))
        self.sharded = shard_net(net, self.mesh, self.model_axis)
        self.names = [n for n, _ in net.named_parameters()]

    def finish(self, net) -> None:
        unshard_net(net)

    # whole <-> local ------------------------------------------------------
    def whole(self, params: Dict[str, torch.Tensor]):
        return gather_leaves(params, self.sharded, self.mesh,
                             self.model_axis)

    def local(self, params: Dict[str, torch.Tensor]):
        return local_leaves(params, self.sharded, self.mesh,
                            self.model_axis)

    def whole_template(self, net) -> Dict[str, torch.Tensor]:
        m = self.mesh.size(self.model_axis) if self.sharded else 1
        return {n: torch.empty(v.shape[:-1] + (v.shape[-1] * m,)
                               if n in self.sharded else v.shape,
                               dtype=v.dtype, device=v.device)
                for n, v in net.state_dict().items()}

    def whole_opt(self, opt) -> dict:
        sd = opt.state_dict()
        state = {}
        for pi, st in sd["state"].items():
            name = self.names[pi]
            state[pi] = {k: (self.whole({name: v})[name]
                             if torch.is_tensor(v) and v.dim() > 0 else v)
                         for k, v in st.items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def cut_opt(self, pi: int, t: torch.Tensor) -> torch.Tensor:
        name = self.names[pi]
        return self.local({name: t})[name]

    def whole_state(self, state):
        return [tuple(self.data.gather(a) for a in layer) for layer in state]


# ---------------------------------------------------------------------------
# training loop
# ---------------------------------------------------------------------------

def _metric_conv(config):
    """float (blocking fetch) or identity (deferred device scalar)."""
    return (lambda v: v) if config.defer_metrics else float


def _epoch_mean(values, split):
    """The epoch's mean of per-update metrics; a mesh run's averaged over
    the data axis (every rank's updates cover equal rows)."""
    m = torch.stack(values).mean()
    return m if split is None else split.mean(m)


def _finalize_history(history):
    """Turn deferred device-scalar metrics into floats (the one
    blocking fetch of a ``defer_metrics`` run)."""
    for h in history:
        for k, v in h.items():
            if not isinstance(v, (bool, int, float, str)):
                h[k] = float(v)


def train_network(
    net,
    x: np.ndarray,
    y: np.ndarray,
    config: TrainConfig,
    offsets: Optional[np.ndarray] = None,
    x_dev: Optional[np.ndarray] = None,
    y_dev: Optional[np.ndarray] = None,
    init_params: Optional[Mapping[str, Any]] = None,
    apply_fn: Optional[Callable] = None,
    device="cuda",
) -> TrainResult:
    """Train ``net`` (moved to ``device``, trained in place) through the
    configured stages. ``init_params`` (a ``state_dict``-style mapping,
    e.g. from ``load_jax_params``) replaces the network's own init.
    ``apply_fn(params, xb, generator, train) -> logits`` overrides the
    network's forward in a feed-forward stage. Returns the final params
    and the per-epoch history."""
    dev = resolve_device(device)
    _compute_dtype(config)
    _check_dispatch(config)
    par = _MeshRun(config) if config.mesh is not None else None
    split = None if par is None else par.data
    rng_np = np.random.default_rng(config.seed)
    generator = torch.Generator(device=dev).manual_seed(config.seed)
    quiet = config.log is None or (par is not None and not par.primary)
    log = (lambda s: None) if quiet else config.log

    net.to(dev)
    if init_params is not None:
        net.load_state_dict({k: torch.as_tensor(v)
                             for k, v in init_params.items()})
    if par is not None:
        par.setup(net)
    xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    yd = torch.from_numpy(np.asarray(y, np.int64)).to(dev)
    use_val = config.use_validation and x_dev is not None
    val = None
    if use_val:
        val = (torch.from_numpy(np.ascontiguousarray(x_dev, np.float32)
                                ).to(dev),
               torch.from_numpy(np.asarray(y_dev, np.int64)).to(dev))

    recurrent = getattr(net, "is_recurrent", False) and apply_fn is None
    history: List[dict] = []
    eval_cache: dict = {}

    # resume bookkeeping: skip (stage, epoch) pairs already completed
    resume_stage = resume_epoch = -1
    resume_blob = None
    if config.snapshot_path and config.resume_snapshot:
        snap = _snapshot_file(config.snapshot_path)
        if os.path.exists(snap):
            resume_blob = _load_snapshot(snap)
        if resume_blob is not None:
            resume_stage = int(resume_blob["__stage__"])
            resume_epoch = int(resume_blob["__epoch__"])
            log(f"Resuming from snapshot: stage {resume_stage}, "
                f"epoch {resume_epoch}")

    for si, stage in enumerate(config.stages):
        if stage.optimizer == "adam":
            log(f"=== Training stage {si}: epoch = {stage.epoch}, batch size = "
                f"{stage.batch_size}, optimizer = adam, early stopping = "
                f"{stage.early_stopping}")
        else:
            log(f"=== Training stage {si}: epoch = {stage.epoch}, batch size = "
                f"{stage.batch_size}, optimizer = {stage.optimizer}, learning "
                f"rate = {stage.lr}, early stopping = {stage.early_stopping}")
        opt = make_optimizer(stage.optimizer, stage.lr, net.parameters())
        if recurrent:
            run_epoch, evaluate, state = _make_rnn_stage(
                net, opt, xd, yd, offsets, config, stage.batch_size, val,
                eval_cache, generator, split)
        else:
            run_epoch, evaluate = _make_ff_stage(
                net, opt, xd, yd, offsets, config, stage.batch_size, val,
                apply_fn, eval_cache, generator, split)
            state = None

        best_val = None
        best_params = None
        start_epoch = 0
        if resume_blob is not None:
            if si < resume_stage:
                continue  # whole stage already done; params restored below
            # first stage not fully done: restore params always, the
            # optimizer and stream state only mid-stage (a stage boundary
            # rebuilds both). Snapshots hold epoch-end params, so the
            # stage-end best-model rule covers the epochs after the resume
            # point and the best params the snapshot carried.
            if par is None:
                net.load_state_dict(params_from_arrays(resume_blob, net))
            else:
                net.load_state_dict(par.local(params_from_arrays(
                    resume_blob, par.whole_template(net))))
            generator.set_state(torch.from_numpy(
                resume_blob["__gen_state__"].copy()))
            rng_np.bit_generator.state = json.loads(
                resume_blob["__rng_state__"].tobytes().decode())
            template = (net.state_dict() if par is None
                        else par.whole_template(net))
            if all("__best__" + k.replace(".", "/") in resume_blob
                   for k in template):
                best_params = params_from_arrays(resume_blob, template,
                                                 "__best__")
                if par is not None:
                    best_params = par.local(best_params)
            stage_stopped = bool(resume_blob.get("__stopped__",
                                                 np.asarray(False)))
            bv = float(resume_blob["__best_val__"])
            best_val = bv if np.isfinite(bv) else None
            if resume_epoch < stage.epoch and not stage_stopped:
                _restore_opt_state(resume_blob, opt,
                                   None if par is None else par.cut_opt)
                if "__st_0__" in resume_blob:
                    leaves = _flat_state(state)
                    restored = [torch.from_numpy(resume_blob[f"__st_{i}__"]
                                                 ).to(a.device, a.dtype)
                                for i, a in enumerate(leaves)]
                    if par is not None:
                        restored = [split.rows(a) for a in restored]
                    state = [tuple(restored[2 * l:2 * l + 2])
                             for l in range(len(state))]
                start_epoch = resume_epoch
            else:
                # stage fully done before the crash (epoch budget spent or
                # early-stopped: the snapshot records the stop)
                start_epoch = stage.epoch
            resume_blob = None
        for epoch in range(start_epoch, stage.epoch):
            t0 = time.time()
            state, tr_loss, tr_acc = run_epoch(state, rng_np)
            entry = {"stage": si, "epoch": epoch + 1,
                     "main/loss": tr_loss, "main/accuracy": tr_acc,
                     "elapsed_time": time.time() - t0}
            if use_val:
                val_loss, val_acc = evaluate()
                if split is not None:
                    val_loss, val_acc = split.agree(torch.tensor(
                        [val_loss, val_acc], dtype=torch.float64,
                        device=dev)).tolist()
                entry["validation/main/loss"] = val_loss
                entry["validation/main/accuracy"] = val_acc
            history.append(entry)
            if not quiet:
                def _fmt(k, v):
                    if isinstance(v, (bool, int, str)):
                        return f"{k}={v}"
                    if isinstance(v, float):
                        return f"{k}={v:.4f}"
                    # a device scalar under defer_metrics: formatting it
                    # would force the fetch the flag exists to avoid
                    return f"{k}=<deferred>"
                log("  " + "  ".join(_fmt(k, v) for k, v in entry.items()))

            stop = False
            if use_val:
                vloss = entry["validation/main/loss"]
                if not stage.early_stopping:
                    if best_val is None or vloss < best_val:
                        best_val = vloss
                        best_params = _params_copy(net)
                else:
                    # EarlyStoppingTrigger semantics (eps = -0.001): stop
                    # when val exceeds the best seen by more than 1e-3
                    if best_val is None:
                        best_val = vloss
                    else:
                        stop = (best_val - vloss) < -0.001
                        if vloss < best_val:
                            best_val = vloss

            if config.snapshot_path:
                # saved after the best-model update, so a resume replays
                # the uninterrupted trajectory exactly; a mesh run
                # gathers the whole state (collective); in a world of
                # ranks, rank 0 alone writes (JAX engine.py:463-466)
                snap = (net.state_dict(), opt.state_dict(), best_params,
                        state)
                if par is not None:
                    snap = (par.whole(snap[0]), par.whole_opt(opt),
                            None if best_params is None
                            else par.whole(best_params),
                            None if state is None else par.whole_state(state))
                if is_primary():
                    _save_snapshot(config.snapshot_path, snap[0], snap[1], si,
                                   epoch + 1, best_val, generator, rng_np,
                                   best_params=snap[2], stopped=stop,
                                   rnn_state=snap[3])
            if config.epoch_hook is not None:
                config.epoch_hook(si, epoch + 1)
            if stop:
                break

        if not stage.early_stopping and best_params is not None:
            # fixed-epoch stages keep the best-validation model
            # (train.py:386-389); early-stopping stages the last
            net.load_state_dict(best_params)

    _finalize_history(history)
    if par is not None:
        par.finish(net)
    return TrainResult(params=_params_copy(net), history=history)


# ---------------------------------------------------------------------------
# feed-forward stage
# ---------------------------------------------------------------------------

def _make_ff_stage(net, opt, xd, yd, offsets, config, bs, val, apply_fn,
                   eval_cache, generator, split=None):
    """``run_epoch(state, rng_np) -> (None, loss, acc)`` and the stage's
    validation ``evaluate() -> (loss, acc)`` (None without a dev set).
    ``split``: a mesh run's ``DataSplit`` (this rank's rows of every
    minibatch, gradients averaged over the data axis)."""
    dt = _compute_dtype(config)
    if apply_fn is None:
        model = net if dt is None else HalfPrecisionNet(net, dt)

        def apply(xb, train):
            return model.apply(xb, train=train, generator=generator)
    else:
        def apply(xb, train):
            p = dict(net.named_parameters())
            if dt is not None:
                p, xb = cast_params(p, dt), xb.to(dt)
            return apply_fn(p, xb, generator, train).float()
    conv = _metric_conv(config)
    n = int(xd.shape[0])
    steps = max(n // bs, 1)

    def update(idx):
        if split is not None:
            idx = split.rows(idx)
        xb, yb = xd[idx], yd[idx]
        logits = apply(xb, True)
        loss = F.cross_entropy(logits, yb)
        acc = (logits.argmax(-1) == yb).float().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if split is not None:
            split.reduce(net.parameters())
        opt.step()
        return loss.detach(), acc

    def epoch_indices(rng_np):
        if config.shuffle_sequences:
            # the reference's --shuffle-sequences on FF nets: bs streams
            # over the sentence-shuffled corpus, one frame each a batch
            return stream_batch_indices(
                sentence_shuffle_indices(offsets, n, rng_np), bs, 0,
                steps).T                                  # (steps, bs)
        perm = rng_np.permutation(n)
        return perm[:steps * bs].reshape(steps, bs)

    def run_epoch(state, rng_np):
        idx_dev = torch.from_numpy(np.ascontiguousarray(
            epoch_indices(rng_np))).to(xd.device)
        losses, accs = [], []
        for s in range(steps):
            loss, acc = update(idx_dev[s])
            losses.append(loss)
            accs.append(acc)
        return (None, conv(_epoch_mean(losses, split)),
                conv(_epoch_mean(accs, split)))

    if val is None:
        return run_epoch, None
    if "ff" in eval_cache:
        return run_epoch, eval_cache["ff"]
    xv, yv = val

    def evaluate():
        nv = int(xv.shape[0])
        chunk = config.eval_chunk
        tot_l = tot_c = 0.0
        with torch.inference_mode():
            for beg in range(0, nv, chunk):
                logits = apply(xv[beg:beg + chunk], False)
                yb = yv[beg:beg + chunk]
                tot_l += float(F.cross_entropy(logits, yb, reduction="sum"))
                tot_c += float((logits.argmax(-1) == yb).float().sum())
        return tot_l / nv, tot_c / nv

    eval_cache["ff"] = evaluate
    return run_epoch, evaluate


# ---------------------------------------------------------------------------
# recurrent (multi-stream TBPTT) stage
# ---------------------------------------------------------------------------

def _make_rnn_stage(net, opt, xd, yd, offsets, config, bs, val, eval_cache,
                    generator, split=None):
    """``run_epoch(state, rng_np) -> (state, loss, acc)``, the stage's
    validation ``evaluate() -> (loss, acc)`` (None without a dev set) and
    the stage's initial stream state. ``split``: a mesh run's ``DataSplit``
    (this rank's streams: its rows of every (bs, L) index block, a state
    of those rows only)."""
    L = config.bprop_len
    b_loc = bs if split is None else bs // split.d
    n = int(xd.shape[0])
    dt = _compute_dtype(config)
    # bf16 compute: params and inputs cast inside autograd, float32
    # logits, master params and optimizer state; the stream state is
    # kept in bf16 between updates (the JAX state_cast)
    model = net if dt is None else HalfPrecisionNet(net, dt)
    conv = _metric_conv(config)

    def update(state, idx):
        if split is not None:
            idx = split.rows(idx)
        flat = idx.reshape(-1)
        xb = xd[flat].reshape(b_loc, L, -1)
        yb = yd[flat].reshape(b_loc, L)
        logits, new_state = model.apply_sequence(xb, state, train=True,
                                                 generator=generator)
        loss = F.cross_entropy(logits.reshape(b_loc * L, -1),
                               yb.reshape(-1),
                               reduction="none").reshape(b_loc, L)
        # Chainer BPTTUpdater: sum over bprop steps of the batch-mean loss
        total = loss.mean(dim=0).sum()
        acc = (logits.argmax(-1) == yb).float().mean()
        opt.zero_grad(set_to_none=True)
        total.backward()
        if split is not None:
            split.reduce(net.parameters())
        opt.step()
        new_state = [tuple(a.detach() for a in layer) for layer in new_state]
        return new_state, total.detach() / L, acc

    steps = max(n // (bs * L), 1)

    def run_epoch(state, rng_np):
        shuffled = sentence_shuffle_indices(offsets, n, rng_np)
        # [s, b, t] = shuffled[(b*N/B + s*L + t) % N]
        idx_all = stream_batch_indices(shuffled, bs, 0, steps * L
                                       ).T.reshape(steps, L, bs
                                                   ).transpose(0, 2, 1)
        idx_dev = torch.from_numpy(np.ascontiguousarray(idx_all)).to(
            xd.device)
        losses, accs = [], []
        for s in range(steps):
            state, loss, acc = update(state, idx_dev[s])
            losses.append(loss)
            accs.append(acc)
        return (state, conv(_epoch_mean(losses, split)),
                conv(_epoch_mean(accs, split)))

    state0 = model.init_state(b_loc)
    if val is None:
        return run_epoch, None, state0
    if ("rnn", bs) in eval_cache:
        return run_epoch, eval_cache[("rnn", bs)], state0
    xv, yv = val
    nv = int(xv.shape[0])
    vsteps = max(nv // bs, 1)
    # stream layout over the dev set (in order, no shuffle):
    # stream b reads frames [b*nv//bs + t]
    v_offsets = (np.arange(bs, dtype=np.int64) * nv) // bs
    v_idx = (v_offsets[:, None] + np.arange(vsteps)[None, :]) % nv
    vi = torch.from_numpy(v_idx.reshape(-1)).to(xv.device)
    xv_streams = xv[vi].reshape(bs, vsteps, -1)
    yv_streams = yv[vi].reshape(bs, vsteps)

    def evaluate():
        with torch.inference_mode():
            logits, _ = model.apply_sequence(xv_streams, model.init_state(bs))
            loss = F.cross_entropy(logits.reshape(bs * vsteps, -1),
                                   yv_streams.reshape(-1))
            acc = (logits.argmax(-1) == yv_streams).float().mean()
        return float(loss), float(acc)

    eval_cache[("rnn", bs)] = evaluate
    return run_epoch, evaluate, state0
