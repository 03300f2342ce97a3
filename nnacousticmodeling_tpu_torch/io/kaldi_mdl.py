"""Kaldi text TransitionModel parser (``final.mdl``).

A copy of the JAX package's ``io/kaldi_mdl.py`` (text parsing and
numpy only). The reference ships the trained transition model as Kaldi
text (``kaldi/final.mdl`` of its bundle): an HMM topology per phone class,
the (phone, hmm-state, pdf) triple table defining transition states,
and the trained per-transition-id log probabilities. Together with the
tree this yields the self-loop / forward log-probs per triphone state
that the decoding image needs.

Transition-id numbering follows Kaldi: transition states are 1-based in
triples order; each owns ``len(topology transitions)`` consecutive
transition ids starting at 1; ``log_probs[0]`` is unused padding.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class TopologyState:
    pdf_class: int                       # -1 for the final non-emitting state
    transitions: List[Tuple[int, float]]  # (dest state, prob)


@dataclass
class TransitionModel:
    topology: Dict[int, List[TopologyState]]   # phone -> states
    triples: List[Tuple[int, int, int]]        # (phone, hmm_state, pdf)
    log_probs: np.ndarray                      # (num_tids + 1,) float32
    # (phone, hmm_state, pdf) -> 1-based transition state
    triple_index: Dict[Tuple[int, int, int], int] = field(default_factory=dict)
    # per transition state: first transition id (1-based)
    state_first_tid: List[int] = field(default_factory=list)

    def __post_init__(self):
        if not self.triple_index:
            self.triple_index = {t: i + 1 for i, t in enumerate(self.triples)}
        if not self.state_first_tid:
            tid = 1
            firsts = []
            for phone, hmm_state, _pdf in self.triples:
                firsts.append(tid)
                tid += len(self.topology[phone][hmm_state].transitions)
            self.state_first_tid = firsts
            self.num_tids = tid - 1

    @property
    def num_pdfs(self) -> int:
        return max(t[2] for t in self.triples) + 1

    @property
    def phones(self) -> List[int]:
        return sorted(self.topology.keys())

    def state_log_probs(self, phone: int, hmm_state: int, pdf: int
                        ) -> Tuple[float, float]:
        """Trained (self_loop_logp, forward_logp) for one triple.

        Self-loop = the topology transition whose destination is the
        state itself; forward = the (single, for Bakis topologies)
        transition to the next state.
        """
        ts = self.triple_index[(phone, hmm_state, pdf)]
        first = self.state_first_tid[ts - 1]
        self_lp = None
        fwd_lp = None
        for k, (dest, _prob) in enumerate(self.topology[phone][hmm_state].transitions):
            lp = float(self.log_probs[first + k])
            if dest == hmm_state:
                self_lp = lp
            else:
                fwd_lp = lp
        if self_lp is None or fwd_lp is None:
            raise ValueError(
                f"triple ({phone},{hmm_state},{pdf}) lacks self/forward arcs")
        return self_lp, fwd_lp


def load_transition_model(filename: str) -> TransitionModel:
    text = open(filename).read()

    # ---- topology -----------------------------------------------------
    topo_text = _between(text, "<Topology>", "</Topology>")
    topology: Dict[int, List[TopologyState]] = {}
    for entry in re.findall(r"<TopologyEntry>(.*?)</TopologyEntry>", topo_text, re.S):
        phones_text = _between(entry, "<ForPhones>", "</ForPhones>")
        phones = [int(v) for v in phones_text.split()]
        states: List[TopologyState] = []
        for state_text in re.findall(r"<State>(.*?)</State>", entry, re.S):
            parts = state_text.split()
            pdf_class = -1
            transitions: List[Tuple[int, float]] = []
            i = 0
            while i < len(parts):
                if parts[i] == "<PdfClass>":
                    pdf_class = int(parts[i + 1])
                    i += 2
                elif parts[i] == "<Transition>":
                    transitions.append((int(parts[i + 1]), float(parts[i + 2])))
                    i += 3
                else:
                    i += 1
            states.append(TopologyState(pdf_class=pdf_class, transitions=transitions))
        for p in phones:
            topology[p] = states

    # ---- triples (newer Kaldi writes <Tuples>) ------------------------
    m = re.search(r"<(Triples|Tuples)>\s+(\d+)(.*?)</(?:Triples|Tuples)>", text, re.S)
    if not m:
        raise ValueError("no <Triples>/<Tuples> section")
    count = int(m.group(2))
    nums = m.group(3).split()
    if len(nums) != 3 * count:
        raise ValueError(f"triples: expected {3*count} ints, got {len(nums)}")
    triples = [(int(nums[3 * i]), int(nums[3 * i + 1]), int(nums[3 * i + 2]))
               for i in range(count)]

    # ---- trained log probs -------------------------------------------
    lp_text = _between(text, "<LogProbs>", "</LogProbs>")
    lp_text = lp_text.replace("[", " ").replace("]", " ")
    log_probs = np.asarray([float(v) for v in lp_text.split()], dtype=np.float32)

    tm = TransitionModel(topology=topology, triples=triples, log_probs=log_probs)
    if len(log_probs) != tm.num_tids + 1:
        raise ValueError(
            f"log probs length {len(log_probs)} != num tids {tm.num_tids} + 1")
    return tm


def _between(text: str, start: str, end: str) -> str:
    i = text.index(start) + len(start)
    j = text.index(end, i)
    return text[i:j]
