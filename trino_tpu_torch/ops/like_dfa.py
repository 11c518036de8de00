"""Vectorized LIKE matching: bit-parallel NFA over the whole dictionary.

A copy of the reference ``trino_tpu/ops/like_dfa.py`` (host-only numpy code;
the port keeps its own copy so it imports nothing of the reference).

Strings are dictionary-encoded, so matching runs once per DICTIONARY ENTRY
on the host, and the per-row result is one device gather of the mask
(ops/expr.py).  This matcher is the numpy counterpart of a dense DFA over
bytes (likematcher/DenseDfaMatcher.java:23, makeNfa:141):

- pattern -> NFA with states 0..m (state s = "matched s tokens"); literal
  tokens consume one matching char, ``_`` consumes any char, ``%`` self-
  loops on any char with an epsilon edge to the next state;
- the active-state set is a uint64 BITSET per dictionary entry (pattern
  tokens capped at 63 -- longer patterns fall back to ``re``);
- the dictionary becomes a padded codepoint matrix via a zero-copy numpy
  view, and each character position advances ALL entries' bitsets with a
  table gather + shift + mask -- O(maxlen) vectorized passes, no python
  per-entry loop.

Small dictionaries (< 1024 entries) keep ``re`` (loop overhead is
negligible and it handles every corner).
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

__all__ = ["like_mask", "like_tokens", "like_to_regex"]

VECTOR_THRESHOLD = 1024  # below this, the re loop is cheap enough


def like_tokens(pattern: str, escape: Optional[str] = None):
    """Pattern -> token list: ('%',), ('_',) or ('c', char).  None on an
    invalid escape (caller decides how to error)."""
    toks = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape:
            if i + 1 >= len(pattern):
                return None
            toks.append(("c", pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            if not toks or toks[-1] != ("%",):  # collapse %% runs
                toks.append(("%",))
        elif ch == "_":
            toks.append(("_",))
        else:
            toks.append(("c", ch))
        i += 1
    return toks


def like_to_regex(pattern: str, escape: Optional[str] = None) -> str:
    """LIKE pattern -> an equivalent Python regular expression."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


def _re_fallback(dictionary, pattern: str, escape: Optional[str]):
    rx = re.compile(like_to_regex(pattern, escape), re.DOTALL)
    return np.array([rx.fullmatch(str(v)) is not None for v in dictionary])


def like_mask(dictionary, pattern: str, escape: Optional[str] = None
              ) -> np.ndarray:
    """Boolean match mask over every dictionary entry."""
    toks = like_tokens(pattern, escape)
    if toks is None:
        raise ValueError(f"invalid LIKE escape in pattern {pattern!r}")
    n = len(dictionary)
    m = len(toks)
    if (n < VECTOR_THRESHOLD or m > 63
            or any(t[0] == "c" and ord(t[1]) >= 255 for t in toks)):
        return _re_fallback(dictionary, pattern, escape)

    # padded codepoint matrix: numpy's fixed-width unicode layout IS a
    # codepoint matrix (zero-copy view); padding slots read 0
    arr = np.asarray(dictionary, dtype=np.str_)
    width = arr.dtype.itemsize // 4
    if width == 0:  # every entry is the empty string
        cp = np.zeros((n, 1), np.uint32)
        width = 1
    else:
        cp = arr.view(np.uint32).reshape(n, width)
    lengths = (cp != 0).sum(axis=1)
    # '\x00' detection: numpy's fixed-width storage both pads with and
    # strips trailing NULs, so lengths[i] <= true length always — total
    # equality implies elementwise equality, one scalar vs a per-entry
    # python-length array on this hot path
    if sum(len(str(v)) for v in dictionary) != int(lengths.sum()):
        return _re_fallback(dictionary, pattern, escape)

    pct_bits = np.uint64(0)
    any_bits = np.uint64(0)  # tokens consuming any char: '_' and '%'
    table = np.zeros(256, np.uint64)  # codepoint (clipped) -> matching tokens
    for s, t in enumerate(toks):
        bit = np.uint64(1) << np.uint64(s)
        if t[0] == "%":
            pct_bits |= bit
            any_bits |= bit
        elif t[0] == "_":
            any_bits |= bit
        else:
            table[ord(t[1])] |= bit
    # rows 0..254: literal matches + any-char tokens; row 255 = "other
    # codepoint": only any-char tokens (literals >= 255 were excluded)
    table[1:255] |= any_bits
    table[255] = any_bits
    table[0] = np.uint64(0)  # padding matches nothing

    max_pct_run = 1
    run = 0
    for t in toks:
        run = run + 1 if t[0] == "%" else 0
        max_pct_run = max(max_pct_run, run or 1)

    def eclose(a: np.ndarray) -> np.ndarray:
        # epsilon edges: state s -(e)-> s+1 when token s is '%'
        if not pct_bits:
            return a
        for _ in range(max_pct_run):
            a = a | ((a & pct_bits) << np.uint64(1))
        return a

    one = np.uint64(1)
    active = eclose(np.full(n, one))  # state 0 active (+ epsilon)
    accept_bit = np.uint64(1) << np.uint64(m)
    final = np.where(lengths == 0, active, np.uint64(0))
    for j in range(width):
        c = np.minimum(cp[:, j], 255)
        match = table[c]
        moved = ((active & match) << one) | (active & match & pct_bits)
        active = eclose(moved)
        final = np.where(lengths == j + 1, active, final)
    return (final & accept_bit) != 0
