"""Plain PyTorch triphone-HMM Viterbi decode: token passing over an
image's arrays, a batch of utterances at once, one frame a step, then
the backtrace to segments.

The native recognizer's semantics: a phone entry from biphone (a, b)
into triphone (a-b+c) pays the phone insertion penalty ``pip`` (every
entry, the first included); each of the three states keeps the better
of staying (self loop) and entering (from the previous state, or from
the biphone for state 0), strictly better entering only, then adds its
observation (the log posterior of its pdf); each biphone takes the
first best of the triphones leaving into it (in the image's CSR order)
plus its LM score. The start is ``lm[start_p] - log P`` on each phone's
start biphone and -1e20 elsewhere. The decode ends at the end biphone of
the first best phone at the last frame; a segment spans frames
[entry + 1, t + 1) as (begin, end, triphone). Every sum is one float32
addition in the order above, so the scores carry the same bits as any
implementation that adds in that order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

NEG_INF = -1.0e20


def _first_max(x: torch.Tensor, dim: int):
    mx = x.amax(dim=dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    iota = torch.arange(n, device=x.device).reshape(shape)
    return mx.squeeze(dim), torch.where(x == mx, iota, n).amin(dim=dim)


class ReferenceDecoder:
    def __init__(self, image, pip: float = 20.0, lmw: float = 1.0,
                 device="cuda"):
        img = image
        dev = torch.device(device)
        self.num_phones = img.num_phones
        self.pip = -abs(pip)
        as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,  # noqa
                                             device=dev)
        self.bi_in = as_t(img.biphone_in, torch.int64)
        self.states = as_t(img.state_idxs, torch.int64)
        self.self_lp = as_t(img.tp_selfloop, torch.float32)
        self.trans_lp = as_t(img.tp_transition, torch.float32)
        lm = np.asarray(img.lm, np.float32) * np.float32(lmw)
        self.lm = as_t(lm, torch.float32)
        counts = np.diff(img.out_offsets)
        fan = np.full((img.num_biphones, max(1, int(counts.max()))), -1,
                      np.int64)
        for b in range(img.num_biphones):
            fan[b, :counts[b]] = img.out_values[
                img.out_offsets[b]:img.out_offsets[b + 1]]
        self.fanin = as_t(np.maximum(fan, 0), torch.int64)
        self.fanin_ok = as_t(fan >= 0, torch.bool)
        self.end_idxs = as_t(img.end_idxs, torch.int64)
        p0 = np.full(img.num_biphones, NEG_INF, np.float32)
        for p in range(img.num_phones):
            s = img.start_idxs[p]
            p0[s] = lm[s] - np.log(np.float32(img.num_phones))
        self.p0 = as_t(p0, torch.float32)

    @torch.no_grad()
    def decode(self, lp: torch.Tensor, lengths: np.ndarray
               ) -> List[List[Tuple[int, int, int]]]:
        """(U, T, S) float32 log posteriors, U lengths -> each
        utterance's segments (begin, end, triphone id), first to last."""
        U, T, _ = lp.shape
        dev = lp.device
        t3 = self.bi_in.numel()
        neg = torch.full((), NEG_INF, device=dev)
        rows = torch.arange(U, device=dev)
        p = self.p0.expand(U, -1)
        pp = [torch.full((U, t3), NEG_INF, device=dev) for _ in range(3)]
        tt = [torch.zeros((U, t3), dtype=torch.int32, device=dev)
              for _ in range(3)]
        nb = self.fanin.shape[0]
        bp_tri = torch.empty((U, T, nb), dtype=torch.int32, device=dev)
        bp_t = torch.empty((U, T, nb), dtype=torch.int32, device=dev)
        end = torch.empty((U, T, self.end_idxs.numel()), device=dev)
        for k in range(T):
            p_in = p[:, self.bi_in] + self.pip
            obs = lp[:, k][:, self.states]
            go = (p_in, pp[0] + self.trans_lp[:, 0],
                  pp[1] + self.trans_lp[:, 1])
            t_go = (torch.full((U, t3), k - 1, dtype=torch.int32,
                               device=dev), tt[0], tt[1])
            new_pp, new_tt = [], []
            for s in range(3):
                stay = pp[s] + self.self_lp[:, s]
                take = go[s] > stay
                new_pp.append(torch.where(take, go[s], stay) + obs[..., s])
                new_tt.append(torch.where(take, t_go[s], tt[s]))
            pp, tt = new_pp, new_tt
            out = pp[2] + self.trans_lp[:, 2]
            mx, col = _first_max(
                torch.where(self.fanin_ok, out[:, self.fanin], neg), 2)
            tri = self.fanin.expand(U, -1, -1).gather(
                2, col[..., None])[..., 0]
            p = mx + self.lm
            bp_tri[:, k] = tri.to(torch.int32)
            bp_t[:, k] = tt[2][rows[:, None], tri]
            end[:, k] = p[:, self.end_idxs]
        return self._backtrace(bp_tri, bp_t, end, lengths)

    def _backtrace(self, bp_tri, bp_t, end, lengths):
        U, T, _ = bp_tri.shape
        dev = bp_tri.device
        rows = torch.arange(U, device=dev)
        t = torch.as_tensor(np.asarray(lengths), device=dev).long() - 1
        _, best = _first_max(end[rows, t.clamp(min=0)], 1)
        cur = self.end_idxs[best]
        segs = torch.zeros((U, T, 3), dtype=torch.int64, device=dev)
        count = torch.zeros(U, dtype=torch.int64, device=dev)
        for _ in range(T):
            live = t >= 0
            tc = t.clamp(min=0)
            tri = bp_tri[rows, tc, cur].long()
            entry = bp_t[rows, tc, cur].long()
            row = torch.stack([entry + 1, t + 1, tri], dim=1)
            slot = count.clamp(max=T - 1)
            segs[rows, slot] = torch.where(live[:, None], row,
                                           segs[rows, slot])
            count = count + live.long()
            cur = torch.where(live, self.bi_in[tri], cur)
            t = torch.where(live, torch.where(entry >= t, -1, entry), t)
        segs, count = segs.cpu().numpy(), count.cpu().numpy()
        return [[tuple(int(v) for v in segs[u, i])
                 for i in range(count[u] - 1, -1, -1)] for u in range(U)]
