"""JSON functions as dictionary transforms.

The port's own copy of the reference ``ops/json_fns.py`` (host Python,
no tensors).  Mirrors the SQL/JSON path engine role (reference:
json/JsonPathEvaluator.java, operator/scalar/JsonFunctions —
JSON_EXTRACT/json_extract_scalar with the jayway-style simple paths Trino
supports).  As for every string
function, JSON text lives in the host-side dictionary; the function
evaluates once per distinct value and the device gathers the precomputed
result by code (the device never parses bytes).

Supported path subset: ``$``, ``$.key``, ``$.a.b``, ``$[0]``,
``$.a[2].b`` — member access and array subscripts (the overwhelmingly
common forms; filters/wildcards are a later round)."""

from __future__ import annotations

import json
from typing import Optional

__all__ = ["parse_json_path", "eval_json_path", "json_scalar_text"]


def parse_json_path(path: str) -> list:
    """'$.a[0].b' -> ['a', 0, 'b'].  Raises ValueError on malformed paths."""
    if not path or path[0] != "$":
        raise ValueError(f"JSON path must start with '$': {path!r}")
    steps: list = []
    i = 1
    n = len(path)
    while i < n:
        c = path[i]
        if c == ".":
            j = i + 1
            while j < n and path[j] not in ".[":
                j += 1
            key = path[i + 1:j]
            if not key:
                raise ValueError(f"empty member in JSON path: {path!r}")
            steps.append(key)
            i = j
        elif c == "[":
            j = path.index("]", i)
            body = path[i + 1:j].strip()
            if body.startswith('"') and body.endswith('"'):
                steps.append(body[1:-1])
            else:
                steps.append(int(body))
            i = j + 1
        else:
            raise ValueError(f"bad JSON path at {i}: {path!r}")
    return steps


def eval_json_path(text: str, steps: list):
    """Evaluate a parsed path against a JSON document; None on any miss or
    parse error (SQL NULL-on-error semantics of json_extract*)."""
    try:
        v = json.loads(text)
    except (ValueError, TypeError):
        return None
    for s in steps:
        if isinstance(s, int):
            if not isinstance(v, list) or not -len(v) <= s < len(v):
                return None
            v = v[s]
        else:
            if not isinstance(v, dict) or s not in v:
                return None
            v = v[s]
    return v


def json_scalar_text(v) -> Optional[str]:
    """json_extract_scalar result: scalars as text, NULL for objects/arrays
    (reference: JsonFunctions.varcharJsonExtractScalar)."""
    if v is None or isinstance(v, (dict, list)):
        return None
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)
