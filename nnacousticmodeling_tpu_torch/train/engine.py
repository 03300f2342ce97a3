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

One update is one device program, as one update is one compiled program
in the JAX package (``dispatch="per_step"``, ``engine.py:566, :692``):
each stage builds a step function of static buffers (``_Updates``). The
epoch's index block lies in one device buffer, written once an epoch
(the JAX scan's ``idx_all`` upload), and a device step counter picks the
update's row; the stream state lives in static tensors, updated with
``copy_``; each update writes its loss and accuracy into its slot of an
epoch buffer, read once at the epoch's end; params and optimizer state
are updated in place. On CUDA tensors the stage's first update is a
direct call (its warm-up: kernels built, the optimizer's state made),
then the step is captured once into a ``torch.cuda.CUDAGraph`` and every
later update of the stage is one replay; a failed capture or replay
raises, and nothing goes on eagerly in its place. On CPU tensors, in a
``mesh`` run (gloo collectives cannot be captured) and with
``train_network(..., cuda_graph=False)`` every update is a direct call
of the same step: the graph's plain version. All three ``dispatch``
values take this path. The counterpart of ``scan`` (one graph an
epoch) is not built: its node count grows with the epoch (a ZoneoutLSTM
update alone is thousands of nodes, and the TIMIT corpus gives hundreds
of updates an epoch at b128 L20), while one graph an update already
leaves the host out of the update. Validation, snapshots, early stopping
and the stage-end rule run outside the graph, once an epoch; each of
them, the epoch, its host work and every update is a named span
(``utils/profiling.py``) in a profiler session. Dropout
masks come from one ``torch.Generator`` seeded with ``seed`` (in the
place of the JAX key), registered with the graph, so that each replay
draws the masks the direct call would; the two frameworks draw
different masks. Adam is ``capturable`` on the card (its step count on
the device, ``optimizers.py``).

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

from .. import kernels
from ..models.precision import HalfPrecisionNet, cast_params
from ..parallel.mesh import (
    DataSplit, gather_leaves, is_primary, local_leaves, replicate, shard_net,
    unshard_net,
)
from ..utils.device import resolve_device
from ..utils.profiling import span
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
    """The epoch's mean of per-update metrics (a ``(steps,)`` buffer); a
    mesh run's averaged over the data axis (every rank's updates cover
    equal rows)."""
    m = values.mean()
    return m if split is None else split.mean(m)


class _DeviceSeconds:
    """Seconds between two CUDA events, read (``float``) once both have
    completed: the device's own time for the work between them, not the
    host's time to enqueue it."""

    def __init__(self, start, end):
        self.start, self.end = start, end

    def __float__(self) -> float:
        self.end.synchronize()
        return self.start.elapsed_time(self.end) / 1e3


def _epoch_clock(dev):
    """Start an epoch's clock; calling the result stops it and returns
    the seconds between: on the card a ``_DeviceSeconds`` of two CUDA
    events recorded on the current stream (under ``defer_metrics`` an
    update loop only enqueues its work, so the host clock would time the
    enqueueing), elsewhere the host clock's float."""
    if dev.type != "cuda":
        t0 = time.time()
        return lambda: time.time() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()

    def stop():
        end.record()
        return _DeviceSeconds(start, end)
    return stop


def _finalize_history(history):
    """Turn deferred device-scalar metrics and epoch times into floats
    (the one blocking fetch of a ``defer_metrics`` run)."""
    for h in history:
        for k, v in h.items():
            if not isinstance(v, (bool, int, float, str)):
                h[k] = float(v)


def _fmt_metric(k, v) -> str:
    """An epoch log's ``key=value``."""
    if isinstance(v, (bool, int, str)):
        return f"{k}={v}"
    if isinstance(v, float):
        return f"{k}={v:.4f}"
    # a device scalar under defer_metrics: formatting it would force the
    # fetch the flag exists to avoid
    return f"{k}=<deferred>"


def _record(step_no, losses, accs, loss, acc) -> None:
    """Write an update's loss and accuracy into their slots of the
    epoch's ``(steps,)`` buffers and advance the device step counter."""
    losses.index_copy_(0, step_no, loss.reshape(1))
    accs.index_copy_(0, step_no, acc.reshape(1))
    step_no.add_(1)


def _capture_update(step, generator, pool=None):
    """Capture one call of ``step`` into a CUDA graph, with ``generator``
    (the dropout and zoneout masks'; or a sequence of them, one a fold)
    registered, so that each replay draws fresh masks, those the direct
    call would draw. ``pool`` (a ``torch.cuda.graph_pool_handle()``)
    makes the graph take its memory from a pool that other graphs share,
    where they never replay at once and each writes its temporaries
    before reading them; by default the graph has a pool of its own.
    Returns the graph and the kernel launches one replay makes (the
    wrapper calls made under capture launch nothing and leave
    ``kernels.launches`` as it was)."""
    g = torch.cuda.CUDAGraph()
    for gen in ([generator] if isinstance(generator, torch.Generator)
                else generator):
        g.register_generator_state(gen)
    with kernels.capturing() as launched:
        with torch.cuda.graph(g, pool=pool):
            step()
    return g, launched


class _Updates:
    """A stage's updates: ``step`` (a function of the stage's static
    buffers that reads its row of the epoch's index block through the
    device step counter, updates the params, the optimizer state and the
    stream state in place, writes its loss and accuracy into their slots
    and advances the counter) once a call.

    Without ``graph`` each call is a direct call of ``step``. With it the
    first call is a direct call (the warm-up: kernels built and loaded,
    their co-residency queries cached, the optimizer's state made); the
    second captures ``step`` (so a stage of one update captures nothing),
    and it and every later call is one replay, which adds the captured
    launches to ``kernels.launches``. ``tensors()`` lists what
    the graph reads and writes in place (params and optimizer state);
    ``begin_epoch`` raises if one of them was replaced since the capture
    (a ``Parameter`` rebound by ``load_state_dict(assign=True)`` would
    leave the graph training the old tensor). ``caller`` names the
    training function in the errors raised; ``pool`` is
    ``_capture_update``'s (None: the graph's own)."""

    def __init__(self, step, generator, tensors, graph: bool,
                 caller: str = "train_network", pool=None):
        self.step, self.generator, self.tensors = step, generator, tensors
        self.use_graph = graph
        self.caller = caller
        self.pool = pool
        self.warm = False
        self.graph = None
        self.launched = None
        self.ptrs = None

    def begin_epoch(self) -> None:
        if self.ptrs is not None and self.ptrs != [
                t.data_ptr() for t in self.tensors()]:
            raise RuntimeError(
                f"{self.caller}: a parameter or optimizer state tensor was "
                "replaced since the update was captured as a CUDA graph, "
                "which would go on training the old one; load new values "
                "in place")

    def __call__(self) -> None:
        if self.use_graph and self.warm and self.graph is None:
            with span("nnam.train.capture"):
                try:
                    shared = {} if self.pool is None else {"pool": self.pool}
                    self.graph, self.launched = _capture_update(
                        self.step, self.generator, **shared)
                except Exception as e:
                    raise RuntimeError(
                        f"{self.caller}: capturing the update as a CUDA "
                        f"graph failed ({type(e).__name__}: {e}); pass "
                        f"cuda_graph=False to run it by direct call") from e
            self.ptrs = [t.data_ptr() for t in self.tensors()]
        with span("nnam.train.update"):
            if self.graph is None:
                self.step()
                self.warm = True
                return
            try:
                self.graph.replay()
            except RuntimeError as e:
                raise RuntimeError(f"{self.caller}: replaying the captured "
                                   f"update failed: {e}") from e
            kernels.replayed(self.launched)


def _stage_tensors(net, opt):
    """``tensors()`` of a stage's ``_Updates``: the params, then the
    optimizer's state tensors."""
    def tensors():
        return list(net.parameters()) + [
            v for st in opt.state.values() for v in st.values()
            if torch.is_tensor(v)]
    return tensors


def _epoch_buffers(steps, idx_shape, device):
    """The static buffers of a stage: the epoch's index block, the step
    counter, the per-update losses and accuracies."""
    return (torch.zeros((steps,) + idx_shape, dtype=torch.int64,
                        device=device),
            torch.zeros(1, dtype=torch.int64, device=device),
            torch.zeros(steps, device=device),
            torch.zeros(steps, device=device))


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
    cuda_graph: bool = True,
) -> TrainResult:
    """Train ``net`` (moved to ``device``, trained in place) through the
    configured stages. ``init_params`` (a ``state_dict``-style mapping,
    e.g. from ``load_jax_params``) replaces the network's own init.
    ``apply_fn(params, xb, generator, train) -> logits`` overrides the
    network's forward in a feed-forward stage. ``cuda_graph=False``
    makes every update a direct call on the card as well (the plain
    version the captured update is held against). Returns the final
    params and the per-epoch history; an entry's ``elapsed_time`` is
    the seconds of the epoch's updates and metrics, on the card between
    two CUDA events (the device's time, deferred runs' included), else
    on the host clock."""
    dev = resolve_device(device)
    _compute_dtype(config)
    _check_dispatch(config)
    par = _MeshRun(config) if config.mesh is not None else None
    split = None if par is None else par.data
    graph = cuda_graph and dev.type == "cuda" and par is None
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
                eval_cache, generator, split, graph)
        else:
            run_epoch, evaluate = _make_ff_stage(
                net, opt, xd, yd, offsets, config, stage.batch_size, val,
                apply_fn, eval_cache, generator, split, graph)
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
                    # into the stage's static stream state
                    for i, a in enumerate(_flat_state(state)):
                        whole = torch.from_numpy(resume_blob[f"__st_{i}__"])
                        a.copy_(whole if par is None else split.rows(whole))
                start_epoch = resume_epoch
            else:
                # stage fully done before the crash (epoch budget spent or
                # early-stopped: the snapshot records the stop)
                start_epoch = stage.epoch
            resume_blob = None
        for epoch in range(start_epoch, stage.epoch):
            with span("nnam.train.epoch"):
                stop_clock = _epoch_clock(dev)
                state, tr_loss, tr_acc = run_epoch(state, rng_np)
                elapsed = stop_clock()
                if not config.defer_metrics:
                    # run_epoch's fetch has waited for the epoch's work, so
                    # the clock's end is all that is left to wait for
                    elapsed = float(elapsed)
                entry = {"stage": si, "epoch": epoch + 1,
                         "main/loss": tr_loss, "main/accuracy": tr_acc,
                         "elapsed_time": elapsed}
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
                    log("  " + "  ".join(_fmt_metric(k, v)
                                         for k, v in entry.items()))

                stop = False
                if use_val:
                    vloss = entry["validation/main/loss"]
                    if not stage.early_stopping:
                        if best_val is None or vloss < best_val:
                            best_val = vloss
                            with span("nnam.train.best_copy"):
                                best_params = _params_copy(net)
                    else:
                        # EarlyStoppingTrigger semantics (eps = -0.001):
                        # stop when val exceeds the best seen by more
                        # than 1e-3
                        if best_val is None:
                            best_val = vloss
                        else:
                            stop = (best_val - vloss) < -0.001
                            if vloss < best_val:
                                best_val = vloss

                if config.snapshot_path:
                    # saved after the best-model update, so a resume
                    # replays the uninterrupted trajectory exactly; a mesh
                    # run gathers the whole state (collective); in a world
                    # of ranks, rank 0 alone writes (JAX
                    # engine.py:463-466)
                    with span("nnam.train.snapshot"):
                        snap = (net.state_dict(), opt.state_dict(),
                                best_params, state)
                        if par is not None:
                            snap = (par.whole(snap[0]), par.whole_opt(opt),
                                    None if best_params is None
                                    else par.whole(best_params),
                                    None if state is None
                                    else par.whole_state(state))
                        if is_primary():
                            _save_snapshot(
                                config.snapshot_path, snap[0], snap[1], si,
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
                   eval_cache, generator, split=None, graph=False):
    """``run_epoch(state, rng_np) -> (None, loss, acc)`` and the stage's
    validation ``evaluate() -> (loss, acc)`` (None without a dev set).
    ``split``: a mesh run's ``DataSplit`` (this rank's rows of every
    minibatch, gradients averaged over the data axis); ``graph``: each
    update after the first one replay of a CUDA graph (``_Updates``)."""
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

    idx_all, step_no, losses, accs = _epoch_buffers(steps, (bs,), xd.device)

    def step():
        idx = idx_all.index_select(0, step_no)[0]
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
        _record(step_no, losses, accs, loss.detach(), acc)

    updates = _Updates(step, generator, _stage_tensors(net, opt), graph)

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
        updates.begin_epoch()
        with span("nnam.train.shuffle"):
            block = torch.from_numpy(np.ascontiguousarray(
                epoch_indices(rng_np)))
        with span("nnam.train.index_upload"):
            idx_all.copy_(block)
        step_no.zero_()
        for _ in range(steps):
            updates()
        with span("nnam.train.epoch_metrics"):
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
        with span("nnam.train.validate"), torch.inference_mode():
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
                    generator, split=None, graph=False):
    """``run_epoch(state, rng_np) -> (state, loss, acc)``, the stage's
    validation ``evaluate() -> (loss, acc)`` (None without a dev set) and
    the stage's stream state: static tensors, zero at the stage's start,
    which every update overwrites with ``copy_`` (so a resume restores
    into them). ``split``: a mesh run's ``DataSplit`` (this rank's
    streams: its rows of every (bs, L) index block, a state of those rows
    only); ``graph``: each update after the first one replay of a CUDA
    graph (``_Updates``)."""
    L = config.bprop_len
    b_loc = bs if split is None else bs // split.d
    n = int(xd.shape[0])
    dt = _compute_dtype(config)
    # bf16 compute: params and inputs cast inside autograd, float32
    # logits, master params and optimizer state; the stream state is
    # kept in bf16 between updates (the JAX state_cast)
    model = net if dt is None else HalfPrecisionNet(net, dt)
    conv = _metric_conv(config)

    steps = max(n // (bs * L), 1)
    idx_all, step_no, losses, accs = _epoch_buffers(steps, (bs, L),
                                                    xd.device)
    # the state's own tensors (an init may hand out one zero tensor twice)
    state = [tuple(a.clone() for a in layer)
             for layer in model.init_state(b_loc)]

    def step():
        idx = idx_all.index_select(0, step_no)[0]
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
        # carried as a constant into the next update
        with torch.no_grad():
            for a, b in zip(_flat_state(state), _flat_state(new_state)):
                a.copy_(b)
        _record(step_no, losses, accs, total.detach() / L, acc)

    updates = _Updates(step, generator, _stage_tensors(net, opt), graph)

    def run_epoch(state, rng_np):
        updates.begin_epoch()
        with span("nnam.train.shuffle"):
            shuffled = sentence_shuffle_indices(offsets, n, rng_np)
            # [s, b, t] = shuffled[(b*N/B + s*L + t) % N]
            block = torch.from_numpy(np.ascontiguousarray(
                stream_batch_indices(shuffled, bs, 0, steps * L).T.reshape(
                    steps, L, bs).transpose(0, 2, 1)))
        with span("nnam.train.index_upload"):
            idx_all.copy_(block)
        step_no.zero_()
        for _ in range(steps):
            updates()
        with span("nnam.train.epoch_metrics"):
            return (state, conv(_epoch_mean(losses, split)),
                    conv(_epoch_mean(accs, split)))

    if val is None:
        return run_epoch, None, state
    if ("rnn", bs) in eval_cache:
        return run_epoch, eval_cache[("rnn", bs)], state
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
        with span("nnam.train.validate"):
            with torch.inference_mode():
                logits, _ = model.apply_sequence(xv_streams,
                                                 model.init_state(bs))
                loss = F.cross_entropy(logits.reshape(bs * vsteps, -1),
                                       yv_streams.reshape(-1))
                acc = (logits.argmax(-1) == yv_streams).float().mean()
            return float(loss), float(acc)

    eval_cache[("rnn", bs)] = evaluate
    return run_epoch, evaluate, state
