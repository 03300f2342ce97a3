"""Master + k-fold + RPL ensemble combination.

Counterpart of ``nnacousticmodeling_tpu/models/ensemble.py``, the twin
of the reference's ``NNWithRPL`` (scripts/common/evaluate.py:19-51), with
its weighting rule kept as written:

* master only:            h = master(x)
* master + K folds:       h = (master(x) * K + sum_k fold_k(x)) / (2K)
* folds only:             h = mean_k fold_k(x)
* then optionally         h = rpl(h)

The fold nets share one architecture, and their params are stacked along
a leading fold axis (``stack_fold_params``) as in the JAX package. The
JAX package evaluates them in one ``vmap``; the CUDA recurrence kernels
take one weight set, so here the K fold nets run as K passes of the same
module through ``torch.func.functional_call``, in fold order, each pass
on the module's own route (the kernel route on the card). Their logits
are stacked and summed along the fold axis, as JAX sums them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
from torch.func import functional_call

Params = Mapping[str, torch.Tensor]


def stack_fold_params(fold_params_list: Sequence[Params]
                      ) -> Dict[str, torch.Tensor]:
    """Stack K per-fold parameter dicts into one dict of (K, ...)
    tensors."""
    return {k: torch.stack([p[k] for p in fold_params_list])
            for k in fold_params_list[0]}


def _fold(folds: Params, k: int) -> Dict[str, torch.Tensor]:
    return {name: v[k] for name, v in folds.items()}


class Ensemble:
    """Combines a master net, stacked fold nets and an RPL head.

    ``network`` is the shared architecture (a module of
    ``models.networks``), ``rpl`` a head of ``models.rpl`` or None.
    ``params`` is ``{"master": dict | None, "folds": stacked dict | None,
    "rpl": dict | None}`` of name -> tensor, on the network's device."""

    def __init__(self, network, rpl=None, num_folds: int = 0):
        self.network = network
        self.rpl = rpl
        self.num_folds = num_folds

    @property
    def is_recurrent(self) -> bool:
        return getattr(self.network, "is_recurrent", False)

    @property
    def device(self) -> torch.device:
        return self.network.device

    @staticmethod
    def _num_folds(folds: Params) -> int:
        return next(iter(folds.values())).shape[0]

    def combine(self, master_logits: Optional[torch.Tensor],
                fold_logits: Optional[torch.Tensor]) -> torch.Tensor:
        """The reference weighting on precomputed logits: master_logits
        (..., C) or None, fold_logits (K, ..., C) or None."""
        if master_logits is not None and fold_logits is None:
            return master_logits
        if master_logits is not None:
            k = fold_logits.shape[0]
            return (master_logits * k + fold_logits.sum(dim=0)) / (2 * k)
        return fold_logits.mean(dim=0)

    def _head(self, params, h: torch.Tensor) -> torch.Tensor:
        if self.rpl is not None and params.get("rpl") is not None:
            h = functional_call(self.rpl, dict(params["rpl"]), (h,))
        return h

    # ---- feed-forward path ------------------------------------------
    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        """(N, D) -> (N, C)."""
        master_logits = (functional_call(self.network,
                                         dict(params["master"]), (x,))
                         if params.get("master") is not None else None)
        fold_logits = None
        folds = params.get("folds")
        if folds is not None:
            fold_logits = torch.stack([
                functional_call(self.network, _fold(folds, k), (x,))
                for k in range(self._num_folds(folds))])
        return self._head(params, self.combine(master_logits, fold_logits))

    # ---- recurrent path ---------------------------------------------
    def apply_sequence(self, params, xs: torch.Tensor, state=None):
        """(B, T, D) -> ((B, T, C), state); the state is
        ``{"master": .., "folds": [one per fold] | None}``."""
        if state is None:
            state = {"master": None, "folds": None}
        new_state: Dict[str, Any] = {"master": None, "folds": None}
        master_logits = None
        if params.get("master") is not None:
            master_logits, new_state["master"] = functional_call(
                self.network, dict(params["master"]),
                (xs, state["master"]))
        fold_logits = None
        folds = params.get("folds")
        if folds is not None:
            outs: List[torch.Tensor] = []
            new_state["folds"] = []
            for k in range(self._num_folds(folds)):
                st = None if state["folds"] is None else state["folds"][k]
                y, st = functional_call(self.network, _fold(folds, k),
                                        (xs, st))
                outs.append(y)
                new_state["folds"].append(st)
            fold_logits = torch.stack(outs)
        h = self._head(params, self.combine(master_logits, fold_logits))
        return h, new_state
