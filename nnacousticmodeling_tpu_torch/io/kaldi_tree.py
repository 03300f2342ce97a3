"""Kaldi binary ContextDependency (tree) parser.

A copy of the JAX package's ``io/kaldi_tree.py`` (``struct`` only).
Parses the decision tree that maps a triphone context plus HMM state
(pdf-class) to a tied pdf id — needed to regenerate the decoding image
(``recog/kaldiTri1909.img`` is absent from the reference tree; its byte
format is specified by phone_recog.cpp:93-130 but the *generator* never
existed there).

Binary layout (Kaldi Write/ReadBasicType conventions):

* magic ``\\0B``; tokens are space-terminated ASCII strings
* integers: one marker byte (``0x04`` or ``0xfc`` = ±sizeof(int32)),
  then 4 bytes little-endian
* integer vectors: marker byte, int32 count, then count int32s
* EventMap node types: ``CE <pdf>`` constant; ``TE <key> <size> (
  <child...> )`` table indexed by the key's value (children may be
  ``NULL``); ``SE <key> <yes-set> { <yes> <no> }`` split on set
  membership. Keys: -1 = pdf-class, 0..N-1 = context position.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def expect_binary(self):
        if self.data[:2] != b"\0B":
            raise ValueError("not a Kaldi binary file")
        self.pos = 2

    def token(self) -> str:
        end = self.data.index(b" ", self.pos)
        tok = self.data[self.pos:end].decode("ascii")
        self.pos = end + 1
        return tok

    def int32(self) -> int:
        marker = self.data[self.pos]
        if marker not in (0x04, 0xFC):
            raise ValueError(f"bad int marker {marker:#x} at {self.pos}")
        v = struct.unpack_from("<i", self.data, self.pos + 1)[0]
        self.pos += 5
        return v

    def int32_vector(self) -> List[int]:
        n = self.int32()
        vals = list(struct.unpack_from(f"<{n}i", self.data, self.pos))
        self.pos += 4 * n
        return vals


# Event map nodes ----------------------------------------------------------

@dataclass
class ConstantNode:
    answer: int


@dataclass
class TableNode:
    key: int
    table: List[Optional["EventNode"]]


@dataclass
class SplitNode:
    key: int
    yes_set: frozenset
    yes: Optional["EventNode"]
    no: Optional["EventNode"]


EventNode = Union[ConstantNode, TableNode, SplitNode]


def _read_event_map(r: _Reader) -> Optional[EventNode]:
    tok = r.token()
    if tok == "NULL":
        return None
    if tok == "CE":
        return ConstantNode(answer=r.int32())
    if tok == "TE":
        key = r.int32()
        size = r.int32()
        if r.token() != "(":
            raise ValueError("TE: expected (")
        table = [_read_event_map(r) for _ in range(size)]
        if r.token() != ")":
            raise ValueError("TE: expected )")
        return TableNode(key=key, table=table)
    if tok == "SE":
        key = r.int32()
        yes_set = frozenset(r.int32_vector())
        if r.token() != "{":
            raise ValueError("SE: expected {")
        yes = _read_event_map(r)
        no = _read_event_map(r)
        if r.token() != "}":
            raise ValueError("SE: expected }")
        return SplitNode(key=key, yes_set=yes_set, yes=yes, no=no)
    raise ValueError(f"unknown event map token {tok!r}")


PDF_CLASS_KEY = -1


@dataclass
class ContextDependency:
    context_width: int     # N (3 for triphones)
    central_position: int  # P (1)
    root: Optional[EventNode]

    def map_to_pdf(self, context: Sequence[int], pdf_class: int) -> Optional[int]:
        """(phone context window, pdf-class) -> pdf id, or None if the
        tree leaves it undefined (invalid context)."""
        node = self.root
        while node is not None:
            if isinstance(node, ConstantNode):
                return node.answer
            if isinstance(node, TableNode):
                v = pdf_class if node.key == PDF_CLASS_KEY else context[node.key]
                if v < 0 or v >= len(node.table):
                    return None
                node = node.table[v]
            elif isinstance(node, SplitNode):
                v = pdf_class if node.key == PDF_CLASS_KEY else context[node.key]
                node = node.yes if v in node.yes_set else node.no
            else:  # pragma: no cover
                raise TypeError(type(node))
        return None

    def num_pdfs(self) -> int:
        best = -1
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is None:
                continue
            if isinstance(node, ConstantNode):
                best = max(best, node.answer)
            elif isinstance(node, TableNode):
                stack.extend(node.table)
            else:
                stack.append(node.yes)
                stack.append(node.no)
        return best + 1


def load_tree(filename: str) -> ContextDependency:
    r = _Reader(open(filename, "rb").read())
    r.expect_binary()
    if r.token() != "ContextDependency":
        raise ValueError("expected ContextDependency")
    n = r.int32()
    p = r.int32()
    if r.token() != "ToPdf":
        raise ValueError("expected ToPdf")
    root = _read_event_map(r)
    # trailing token should be EndContextDependency
    return ContextDependency(context_width=n, central_position=p, root=root)
