"""Fold-parallel training: the K fold networks of a k-fold ensemble
train together, in one update loop.

Counterpart of ``nnacousticmodeling_tpu/train/fold_parallel.py``. The
reference trains its folds one after another (``master_script.py:134-
170``); the JAX package trains them as one ``vmap`` over a leading fold
axis. Here:

* the corpus lives on the device once; each fold's training set (the
  utterances of every other fold, grouped by fold id ascending, as
  ``train.py:162-206`` concatenates them) is an index universe into it,
  also on the device;
* the K param sets are stacked along a leading fold axis, one leaf
  tensor per parameter, and one optimizer steps them all (its state is
  elementwise, so each fold keeps its own; it is re-made at each stage,
  as JAX re-inits its optimizer states, ``:188``);
* every update gathers one (K, B, L) index block, then runs the K
  forwards as K passes of the one module through
  ``torch.func.functional_call`` on the fold's slices of the stacks,
  each pass on the module's own route (the recurrence kernels on the
  card), and one backward over the sum of the K losses. The JAX vmap
  becomes an extra grid axis of the same Pallas kernel; the persistent
  CUDA kernels cannot take one (an LSTM 4x1024 training launch at
  B=128 already holds 128 of the H100's 132 co-resident blocks,
  ``ops/rnn_cuda.py::lstm_scan_plan``), so K launches of the same
  kernel do that work;
* per-fold early stopping: a fold whose validation loss rises by more
  than 1e-3 over its best stops and leaves the stacks (its params,
  optimizer and stream state are dropped from the leading axis), so it
  gets no more passes. The JAX ``compact=False`` keeps stopped folds in
  the vmap with a masked update instead; the per-fold math is the same
  either way, so that option is not ported;
* dev evaluation runs the recurrent dev set as ``eval_batch`` in-order
  streams over a fresh state, the feed-forward dev set whole.

The numerics that decide parity are the JAX package's: ``rng_np =
default_rng(config.seed)`` shuffles all K universes every epoch in fold
order, stopped folds too; ``n_steps = max(min_k len(universe_k) //
(bs * L), 1)``; feed-forward nets read the same stream layout with L=1;
the recurrent loss is the batch mean summed over the L steps (reported
/ L); fixed-epoch stages keep each fold's best-validation params; the
log lines are the JAX ones. Dropout masks come from one
``torch.Generator`` a fold, seeded from ``config.seed`` and the fold.
Like the JAX function, this one ignores ``compute_dtype``,
``shuffle_sequences``, the snapshot fields and ``mesh`` of the config.

``mesh`` (a ``parallel.Mesh`` with a ``fold_axis`` of size f dividing K;
JAX ``:121-128``): each fold rank trains its own K/f folds (fold rank r
the folds ``r*K/f ..``). Every rank keeps all K index universes and
draws every shuffle in fold order from the one ``rng_np``, so each fold
reads the minibatches of the single-process run. A ``data`` axis of the
mesh splits each fold's batch rows as the engine does (the one
``parallel.mesh.DataSplit``: gradients averaged over it, the fold
group's data rank 0 deciding early stopping and logging). At the end the
params are gathered over the fold axis, so every rank returns the K maps
in fold order (JAX ``:389-397``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..models.networks import redraw_params
from ..parallel.comm import all_gather_cat, all_reduce_
from ..parallel.mesh import DataSplit
from ..utils.device import resolve_device
from .engine import TrainConfig
from .optimizers import make_optimizer
from .streams import sentence_shuffle_indices, stream_batch_indices

Params = Dict[str, torch.Tensor]


def fold_index_universe(offsets: np.ndarray, utt_folds: np.ndarray,
                        fold: int):
    """Frame indices + local offsets of fold ``fold``'s training set
    (= utterances of all OTHER folds, grouped by fold id ascending)."""
    utts = [u for k in range(int(utt_folds.max()) + 1) if k != fold
            for u in np.nonzero(utt_folds == k)[0]]
    frames = []
    local_offsets = [0]
    for u in utts:
        frames.append(np.arange(offsets[u], offsets[u + 1]))
        local_offsets.append(local_offsets[-1] + offsets[u + 1] - offsets[u])
    return np.concatenate(frames), np.asarray(local_offsets, dtype=np.int64)


def _fold_seed(seed: int, fold: int) -> int:
    return int(np.random.SeedSequence([seed, fold]).generate_state(1)[0])


def _compacted_optimizer(stage, opt, old: Params, new: Params,
                         keep: torch.Tensor):
    """A fresh optimizer over the compacted stacks ``new`` carrying the
    kept folds' rows of ``opt``'s state (the JAX ``take`` of opt_state)."""
    n_old = next(iter(old.values())).shape[0]
    new_opt = make_optimizer(stage.optimizer, stage.lr, new.values())
    for name, p_old in old.items():
        st = opt.state.get(p_old)
        if not st:
            continue
        new_opt.state[new[name]] = {
            k: (v[keep].clone() if torch.is_tensor(v) and v.dim() > 0
                and v.shape[0] == n_old else v)
            for k, v in st.items()}
    return new_opt


def _epoch_indices(universes, uni_dev, rng_np, bs: int, n_steps: int,
                   L: int) -> torch.Tensor:
    """(K, n_steps, bs, L) corpus frame indices of one epoch: every
    fold's universe sentence-shuffled by the shared ``rng_np`` in fold
    order, read by ``bs`` streams (JAX ``:274-281``)."""
    blocks = []
    for (frames, local), ud in zip(universes, uni_dev):
        shuffled = sentence_shuffle_indices(local, len(frames), rng_np)
        pos = stream_batch_indices(shuffled, bs, 0, n_steps * L)
        glob = ud[torch.from_numpy(pos).to(ud.device)]
        blocks.append(glob.reshape(bs, n_steps, L).transpose(0, 1))
    return torch.stack(blocks)


def _make_evaluate(net, recurrent, x_dev, y_dev, eval_batch, eval_chunk,
                   dev):
    """``evaluate(params, count) -> (count,) float32`` dev losses of the
    first ``count`` rows of the stacks, built once for every stage (JAX
    ``:150-182``)."""
    xvd = torch.from_numpy(np.ascontiguousarray(x_dev, np.float32)).to(dev)
    yvd = torch.from_numpy(np.asarray(y_dev, np.int64)).to(dev)
    nv = int(xvd.shape[0])
    if recurrent:
        # stream b reads frames [b*nv//B + t], in order, no shuffle
        ebs = min(eval_batch, nv)
        vsteps = max(nv // ebs, 1)
        v_off = (np.arange(ebs, dtype=np.int64) * nv) // ebs
        v_idx = torch.from_numpy(
            (v_off[:, None] + np.arange(vsteps)[None, :]) % nv).to(dev)
        xv, yv = xvd[v_idx], yvd[v_idx]

        def one(p):
            logits, _ = functional_call(net, p, (xv, None))
            return F.cross_entropy(logits.reshape(ebs * vsteps, -1),
                                   yv.reshape(-1))
    else:
        def one(p):
            tot = 0.0
            for beg in range(0, nv, eval_chunk):
                logits = functional_call(net, p, (xvd[beg:beg + eval_chunk],))
                tot = tot + F.cross_entropy(logits, yvd[beg:beg + eval_chunk],
                                            reduction="sum")
            return tot / nv

    def evaluate(params: Params, count: int) -> np.ndarray:
        with torch.inference_mode():
            vals = torch.stack([one({n: v[i] for n, v in params.items()})
                                for i in range(count)])
        return vals.float().cpu().numpy()

    return evaluate


def train_folds_parallel(
    net,
    x: np.ndarray,
    y: np.ndarray,
    offsets: Optional[np.ndarray],
    utt_folds: np.ndarray,
    num_folds: int,
    config: TrainConfig,
    x_dev: Optional[np.ndarray] = None,
    y_dev: Optional[np.ndarray] = None,
    eval_batch: int = 64,
    init_params: Optional[Sequence[Mapping[str, Any]]] = None,
    device=None,
    mesh: Any = None,
    fold_axis: str = "fold",
) -> List[Params]:
    """Train the K fold networks of ``net``'s architecture; returns K
    ``state_dict``-style param maps (the network's names, in its order,
    as ``train_network``'s ``params``).

    ``init_params``: K maps (e.g. from ``load_jax_params``) that replace
    the K inits, which are otherwise K draws of ``redraw_params`` from
    ``config.seed``. ``device``: where to train (default: the device
    ``net`` is on; a network is built on the card unless asked
    otherwise). ``mesh``: see the module docstring."""
    split = None
    if mesh is not None:
        if fold_axis not in mesh.axis_sizes:
            raise ValueError(f"mesh has no {fold_axis!r} axis")
        f, r_f = mesh.size(fold_axis), mesh.rank(fold_axis)
        if num_folds % f != 0:
            raise ValueError(f"num_folds {num_folds} not divisible by "
                             f"fold-axis size {f}")
        # the ranks of a fold group (every axis but fold) train its folds
        split = DataSplit(mesh, "data" if "data" in mesh.axis_sizes
                          else None, [s.batch_size for s in config.stages],
                          [a for a in mesh.axis_names if a != fold_axis])
    own = (np.arange(num_folds) if mesh is None else
           np.arange(r_f * num_folds // f, (r_f + 1) * num_folds // f))
    dev = resolve_device(device) if device is not None else net.device
    log = (config.log if config.log is not None
           and (split is None or split.r == 0) else (lambda s: None))
    recurrent = getattr(net, "is_recurrent", False)
    rng_np = np.random.default_rng(config.seed)
    net.to(dev)

    if offsets is None:
        offsets = np.array([0, x.shape[0]], dtype=np.int64)
    universes = [fold_index_universe(offsets, utt_folds, k)
                 for k in range(num_folds)]
    uni_dev = [torch.from_numpy(u[0]).to(dev) for u in universes]

    names = list(net.state_dict())
    if init_params is None:
        init_params = [redraw_params(net, _fold_seed(config.seed, k))
                       for k in range(num_folds)]
    if len(init_params) != num_folds:
        raise ValueError(f"{len(init_params)} inits for {num_folds} folds")
    stacked = {n: torch.stack([torch.as_tensor(init_params[k][n]).to(
        dev, torch.float32) for k in own]) for n in names}
    gens = [torch.Generator(device=dev).manual_seed(_fold_seed(config.seed,
                                                               k))
            for k in range(num_folds)]

    xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    yd = torch.from_numpy(np.asarray(y, np.int64)).to(dev)
    use_val = config.use_validation and x_dev is not None
    evaluate = (_make_evaluate(net, recurrent, x_dev, y_dev, eval_batch,
                               config.eval_chunk, dev) if use_val else None)
    L = config.bprop_len if recurrent else 1

    for si, stage in enumerate(config.stages):
        log(f"=== Fold-parallel stage {si}: {num_folds} folds, "
            f"epoch = {stage.epoch}, bs = {stage.batch_size}, "
            f"opt = {stage.optimizer}")
        bs = stage.batch_size
        b_loc = bs if split is None else bs // split.d
        params = {n: v.detach().clone().requires_grad_(True)
                  for n, v in stacked.items()}
        opt = make_optimizer(stage.optimizer, stage.lr, params.values())
        states = ({int(k): net.init_state(b_loc) for k in own}
                  if recurrent else None)
        n_steps = max(min(len(u[0]) for u in universes) // (bs * L), 1)
        # fold_ids maps rows of the (compacted) stacks back to
        # fold indices; stopped folds move to ``stash``
        fold_ids = own.copy()
        stash: Dict[int, Params] = {}
        active = np.ones(len(own), dtype=bool)
        best_vals = np.full(num_folds, np.inf)
        best_params: Optional[Params] = None

        def update(idx: torch.Tensor) -> torch.Tensor:
            """One update of the stacked folds on the (k, bs[, L]) index
            block (this data rank's rows of it); returns the k losses (/
            L for recurrent nets)."""
            if split is not None:
                idx = split.rows(idx, 1)
            views = {n: p.unbind(0) for n, p in params.items()}
            xb, yb = xd[idx], yd[idx]
            losses = []
            for i, k in enumerate(fold_ids):
                p = {n: views[n][i] for n in names}
                kw = {"train": True, "generator": gens[k]}
                if recurrent:
                    logits, st = functional_call(net, p, (xb[i], states[k]),
                                                 kw)
                    states[k] = [tuple(a.detach() for a in layer)
                                 for layer in st]
                    ce = F.cross_entropy(logits.reshape(b_loc * L, -1),
                                         yb[i].reshape(-1), reduction="none")
                    # Chainer's BPTTUpdater: the batch mean summed over L
                    losses.append(ce.reshape(b_loc, L).mean(dim=0).sum())
                else:
                    logits = functional_call(net, p, (xb[i],), kw)
                    losses.append(F.cross_entropy(logits, yb[i]))
            loss = torch.stack(losses)
            opt.zero_grad(set_to_none=True)
            loss.sum().backward()
            if split is not None:
                split.reduce(params.values())
            opt.step()
            return loss.detach() / L

        for epoch in range(stage.epoch):
            t0 = time.time()
            # shuffle ALL folds (the shared host rng), so trajectories do
            # not depend on compaction
            glob = _epoch_indices(universes, uni_dev, rng_np, bs, n_steps, L)
            if len(fold_ids):
                rows = glob[torch.from_numpy(fold_ids).to(dev)]
                losses = []
                for s in range(n_steps):
                    idx = rows[:, s]
                    if not recurrent:
                        idx = idx.reshape(len(fold_ids), bs * L)[:, :bs]
                    losses.append(update(idx))
                mean_loss = torch.stack(losses).mean(dim=0)
                if split is not None:
                    mean_loss = split.mean(mean_loss)
                mean_loss = mean_loss.cpu().numpy()
                msg = (f"  stage={si} epoch={epoch + 1} "
                       f"folds={[int(k) for k in fold_ids]} "
                       f"loss={np.array2string(mean_loss, precision=3)} "
                       f"({time.time() - t0:.1f}s)")
                if use_val:
                    vals = evaluate(params, len(fold_ids))
                    if split is not None:
                        # the fold group's data rank 0 decides for all
                        vals = split.agree(torch.from_numpy(vals).to(
                            dev)).cpu().numpy()
                    msg += f" val={np.array2string(vals, precision=3)}"
                    if stage.early_stopping:
                        for i, k in enumerate(fold_ids):
                            v = float(vals[i])
                            if np.isfinite(best_vals[k]) \
                                    and best_vals[k] - v < -0.001:
                                active[i] = False
                            best_vals[k] = min(best_vals[k], v)
                    else:
                        # fixed-epoch stages keep each fold's best-
                        # validation params (the sequential path's rule); no
                        # stop, so no compaction on this path
                        improved = vals < best_vals[fold_ids]
                        best_vals[fold_ids] = np.minimum(
                            best_vals[fold_ids], vals)
                        mask = torch.from_numpy(improved).to(dev)
                        with torch.no_grad():
                            if best_params is None:
                                best_params = {n: p.detach().clone()
                                               for n, p in params.items()}
                            else:
                                best_params = {
                                    n: torch.where(mask.reshape(
                                        (-1,) + (1,) * (p.dim() - 1)),
                                        p.detach(), best_params[n])
                                    for n, p in params.items()}
                log(msg)
                if not active.any():
                    for i, k in enumerate(fold_ids):
                        stash[int(k)] = {n: p.detach()[i] for n, p in
                                         params.items()}
                    fold_ids = fold_ids[:0]
                    active = active[:0]
                if not active.all():
                    keep = torch.from_numpy(np.nonzero(active)[0]).to(dev)
                    for i in np.nonzero(~active)[0]:
                        stash[int(fold_ids[i])] = {
                            n: p.detach()[i] for n, p in params.items()}
                    new = {n: p.detach()[keep].clone().requires_grad_(True)
                           for n, p in params.items()}
                    opt = _compacted_optimizer(stage, opt, params, new,
                                               keep)
                    params = new
                    fold_ids = fold_ids[active]
                    active = active[active]
                    log(f"  compacted to folds "
                        f"{[int(k) for k in fold_ids]}")
            # every fold stopped: the run ends (with a mesh, when every
            # fold rank's folds have; until then a rank whose folds all
            # stopped draws the shuffles only, keeping rng_np in step)
            live = len(fold_ids)
            if mesh is not None:
                live = int(all_reduce_(torch.tensor([live], device=dev),
                                       mesh, fold_axis))
            if not live:
                break

        if not stage.early_stopping and best_params is not None:
            params = best_params
        # the full K-fold stack in fold order for the next stage and the
        # result (stage boundaries reset ``active``)
        per_fold = dict(stash)
        for i, k in enumerate(fold_ids):
            per_fold[int(k)] = {n: p.detach()[i] for n, p in params.items()}
        stacked = {n: torch.stack([per_fold[int(k)][n] for k in own])
                   for n in names}

    if mesh is not None:
        stacked = {n: all_gather_cat(v, mesh, fold_axis, 0)
                   for n, v in stacked.items()}
    return [{n: stacked[n][k].clone() for n in names}
            for k in range(num_folds)]
