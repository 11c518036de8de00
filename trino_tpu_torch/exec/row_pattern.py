"""MATCH_RECOGNIZE row-pattern engine.

The port of the reference ``exec/row_pattern.py``, unchanged: it is host
Python and touches no tensor.  Mirrors the reference's row-pattern stack
(sql/planner/rowpattern/ pattern IR + operator/window/pattern/ matcher —
LabelEvaluator.java, MatchAggregation.java; plan node
PatternRecognitionNode.java:47) in a host-side engine: patterns compile
to a Thompson NFA over label predicates and matching runs per partition
with greedy quantifier semantics (backtracking, longest-match-first like
the reference's matcher).

Scope (the widely-used core): concatenation, alternation ``|``, grouping,
quantifiers ``* + ? {n,m}``, ONE ROW PER MATCH, AFTER MATCH SKIP PAST LAST
ROW / TO NEXT ROW, CLASSIFIER()/MATCH_NUMBER(), FIRST/LAST/PREV/NEXT in
DEFINE/MEASURES, and aggregates over matched rows.  Pattern evaluation is
inherently sequential per partition, so it lives on host — partitions
themselves parallelize across tasks like any partitioned operator."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from ..spi.errors import GENERIC_INTERNAL_ERROR, TrinoError

__all__ = ["parse_pattern", "PatternMatcher", "Match",
           "PatternSyntaxError"]


class PatternSyntaxError(ValueError):
    """Malformed MATCH_RECOGNIZE pattern text — the query's own bug.
    Registered in spi.errors._USER_ERROR_CLASS_NAMES so classify() maps it
    to GENERIC_USER_ERROR (never retried), like AnalysisError/ParseError."""


# --------------------------------------------------------------------------
# pattern AST + parser:  A (B|C)+ D?  {n,m} quantifiers


@dataclass(frozen=True)
class PLabel:
    name: str


@dataclass(frozen=True)
class PSeq:
    parts: tuple


@dataclass(frozen=True)
class PAlt:
    options: tuple


@dataclass(frozen=True)
class PQuant:
    inner: object
    low: int
    high: Optional[int]  # None = unbounded
    greedy: bool = True


class _PatternParser:
    def __init__(self, tokens: list[str]):
        self.toks = tokens
        self.i = 0

    @property
    def cur(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def parse(self):
        e = self._alt()
        if self.cur is not None:
            raise PatternSyntaxError(
                f"unexpected pattern token {self.cur!r}")
        return e

    def _alt(self):
        opts = [self._seq()]
        while self.cur == "|":
            self.i += 1
            opts.append(self._seq())
        return opts[0] if len(opts) == 1 else PAlt(tuple(opts))

    def _seq(self):
        parts = []
        while self.cur is not None and self.cur not in ("|", ")"):
            parts.append(self._quant())
        if not parts:
            raise PatternSyntaxError("empty pattern")
        return parts[0] if len(parts) == 1 else PSeq(tuple(parts))

    def _quant(self):
        atom = self._atom()
        c = self.cur
        if c == "*":
            self.i += 1
            return PQuant(atom, 0, None)
        if c == "+":
            self.i += 1
            return PQuant(atom, 1, None)
        if c == "?":
            self.i += 1
            return PQuant(atom, 0, 1)
        if c == "{":
            self.i += 1
            lo = ""
            while self.cur and self.cur.isdigit():
                lo += self.cur
                self.i += 1
            hi: Optional[str] = lo
            if self.cur == ",":
                self.i += 1
                hi = ""
                while self.cur and self.cur.isdigit():
                    hi += self.cur
                    self.i += 1
            if self.cur != "}":
                raise PatternSyntaxError("unterminated {n,m} quantifier")
            self.i += 1
            return PQuant(atom, int(lo or 0),
                          int(hi) if hi else None)
        return atom

    def _atom(self):
        c = self.cur
        if c == "(":
            self.i += 1
            e = self._alt()
            if self.cur != ")":
                raise PatternSyntaxError("unbalanced ( in pattern")
            self.i += 1
            return e
        if c is None or not (c[0].isalpha() or c[0] == "_"):
            raise PatternSyntaxError(f"expected pattern label, got {c!r}")
        self.i += 1
        return PLabel(c.upper())


def _tokenize_pattern(text: str) -> list[str]:
    toks: list[str] = []
    i = 0
    while i < len(text):
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        if ch.isalpha() or ch == "_":
            j = i
            while j < len(text) and (text[j].isalnum() or text[j] == "_"):
                j += 1
            toks.append(text[i:j])
            i = j
            continue
        if ch.isdigit():
            j = i
            while j < len(text) and text[j].isdigit():
                j += 1
            toks.append(text[i:j])
            i = j
            continue
        toks.append(ch)
        i += 1
    return toks


def parse_pattern(text: str):
    return _PatternParser(_tokenize_pattern(text)).parse()


def pattern_labels(p) -> list[str]:
    if isinstance(p, PLabel):
        return [p.name]
    if isinstance(p, PSeq):
        out = []
        for x in p.parts:
            for l in pattern_labels(x):
                if l not in out:
                    out.append(l)
        return out
    if isinstance(p, PAlt):
        out = []
        for x in p.options:
            for l in pattern_labels(x):
                if l not in out:
                    out.append(l)
        return out
    return pattern_labels(p.inner)


# --------------------------------------------------------------------------
# matcher: greedy backtracking over label predicates


@dataclass
class Match:
    start: int  # partition-relative row index
    end: int    # exclusive
    labels: list[str]  # per matched row, the classifier label
    match_number: int = 0


class PatternMatcher:
    """``predicate(label, row_idx, labels_so_far) -> bool`` decides whether
    the DEFINE condition for ``label`` holds on the row given the current
    prefix assignment (supports PREV/FIRST/LAST semantics in the caller).
    Greedy quantifiers with backtracking — the reference matcher's
    preferment order (Matcher.java over the pattern's preferred branches)."""

    def __init__(self, pattern, predicate: Callable[[str, int, list], bool],
                 max_rows_per_match: int = 10_000):
        self.pattern = pattern
        self.predicate = predicate
        self.max_rows = max_rows_per_match
        self.next_match_number = 1

    def _try(self, p, pos: int, n: int, labels: list) -> Optional[int]:
        """Longest (greedy, preferment-ordered) match of ``p`` at pos."""
        return self._match(p, pos, n, labels, lambda end: end)

    def _match(self, p, pos: int, n: int, labels: list,
               cont) -> Optional[int]:
        """Full-backtracking CPS matcher: ``cont(pos')`` tries the REST of
        the pattern; a failing continuation re-enters earlier alternatives
        and shorter quantifier expansions (the reference matcher's
        preferment order over every branch point)."""
        if isinstance(p, PLabel):
            if pos >= n or len(labels) >= self.max_rows:
                return None
            labels.append(p.name)
            if self.predicate(p.name, pos, labels):
                r = cont(pos + 1)
                if r is not None:
                    return r
            labels.pop()
            return None
        if isinstance(p, PSeq):
            def seq_cont(k):
                if k == len(p.parts):
                    return cont
                return lambda pos2: self._match(
                    p.parts[k], pos2, n, labels, seq_cont(k + 1))

            return seq_cont(0)(pos)
        if isinstance(p, PAlt):
            for opt in p.options:
                mark = len(labels)
                r = self._match(opt, pos, n, labels, cont)
                if r is not None:
                    return r
                del labels[mark:]
            return None
        if isinstance(p, PQuant):
            q = p

            def rep(pos2: int, count: int) -> Optional[int]:
                if q.high is None or count < q.high:
                    mark = len(labels)

                    def more(pos3: int) -> Optional[int]:
                        if pos3 == pos2:
                            # zero-width repetition: stop expanding
                            return cont(pos3) if count + 1 >= q.low else None
                        return rep(pos3, count + 1)

                    r = self._match(q.inner, pos2, n, labels, more)
                    if r is not None:
                        return r
                    del labels[mark:]
                if count >= q.low:
                    return cont(pos2)
                return None

            return rep(pos, 0)
        raise TrinoError(GENERIC_INTERNAL_ERROR,
                         f"unhandled pattern node {type(p).__name__}")

    def find_matches(self, n: int, skip_past_last: bool = True) -> list[Match]:
        """Scan a partition of ``n`` rows, emitting non-overlapping matches
        (AFTER MATCH SKIP PAST LAST ROW) or all matches advancing one row
        (SKIP TO NEXT ROW).  ``next_match_number`` is live during the scan
        so DEFINE predicates can evaluate MATCH_NUMBER()."""
        out: list[Match] = []
        pos = 0
        mn = 0
        while pos < n:
            self.next_match_number = mn + 1
            labels: list[str] = []
            end = self._try(self.pattern, pos, n, labels)
            if end is not None and end > pos:
                mn += 1
                out.append(Match(pos, end, list(labels), mn))
                pos = end if skip_past_last else pos + 1
            else:
                pos += 1
        return out
