"""PTO (panotools/hugin script) parser.

Same dialect as the reference (pto.h:70-239): a line starting with a
single letter is split into fields, each field = letters immediately
followed by a value (optionally double-quoted). '=n' back-references
resolve against the n-th i-line. Lines are kept grouped by their head
letter, preserving order.

Consumed clauses (matching envutil_main.cc:522-905):
  i-lines: n f v y p r TrX TrY TrZ Tpy Tpp g t a b c d e S Eev
           + envutil extensions W (input crop window), Pano, Csp
  p-lines: f w h v S (output crop) Eev
  k-lines: i t p (polygonal exclude masks)
  c-lines: control points (n N x y X Y t)
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

_LINE_RE = re.compile(r"([a-zA-Z])\s(.+?)[\n\r]*$")
_ITEM_RE = re.compile(r"([A-Za-z]+)((\"[^\"]+\")|(\S*))")


class PtoLine:
    def __init__(self, head: str, original: str):
        self.head = head
        self.original = original
        self.fields: Dict[str, str] = {}

    def get(self, name: str, default: str = "") -> str:
        return self.fields.get(name, default)


class PtoParser:
    def __init__(self):
        self.groups: Dict[str, List[PtoLine]] = {}

    def parse_line(self, s: str) -> None:
        m = _LINE_RE.match(s)
        if not m:
            return  # comments, empty lines, anything not letter-headed
        line = PtoLine(m.group(1), s)
        for im in _ITEM_RE.finditer(m.group(2)):
            name, value = im.group(1), im.group(2)
            if value.startswith("="):
                # back-reference into the referenced i-line
                ref = int(value[1:])
                if name != "j":
                    value = self.groups["i"][ref].fields.get(name, "")
            line.fields[name] = value
        self.groups.setdefault(line.head, []).append(line)

    def read(self, filename: str = "",
             addenda: Optional[List[str]] = None) -> None:
        if filename:
            with open(filename) as f:
                for raw in f:
                    self.parse_line(raw)
        for extra in addenda or []:
            self.parse_line(extra)

    def lines(self, head: str) -> List[PtoLine]:
        return self.groups.get(head, [])


def unquote(s: str) -> str:
    if s.startswith('"') and s.endswith('"') and len(s) >= 2:
        return s[1:-1]
    return s


def glean_float(s: str) -> float:
    """Missing fields read as 0 (the reference's 'glean' lambda,
    envutil_main.cc:543-548)."""
    return float(s) if s else 0.0


def glean_int(s: str) -> int:
    return int(s) if s else 0


def parse_crop(s: str):
    """'x0,x1,y0,y1' crop clause (S in p-lines, S/W in i-lines)."""
    m = re.match(r"([0-9]+),([0-9]+),([0-9]+),([0-9]+)", s)
    if not m:
        return None
    return tuple(int(m.group(i)) for i in range(1, 5))


MASK_VERTEX_RE = re.compile(r"([+-]?[0-9.]+)\s([+-]?[0-9.]+)")


def parse_mask_vertices(s: str):
    """k-line 'p' field: whitespace-separated vertex pairs."""
    s = unquote(s)
    vx, vy = [], []
    for m in MASK_VERTEX_RE.finditer(s):
        vx.append(float(m.group(1)))
        vy.append(float(m.group(2)))
    return vx, vy
