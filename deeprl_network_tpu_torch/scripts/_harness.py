"""What the learning and evaluation harnesses share: the jsonl sink every
one of them writes its rows to, and the check that their rows keep the keys
of the JAX repo's ``scripts/``."""

from __future__ import annotations

import ast
import contextlib
import json
import re
import sys
from typing import Callable, Iterator, List, Optional, Tuple


@contextlib.contextmanager
def jsonl_sink(path: Optional[str], mode: str = "w"
               ) -> Iterator[Callable[[dict], None]]:
    """``emit(row)``: one JSON line to ``path`` (opened with ``mode``) and
    to stderr, or to stdout when ``path`` is None."""
    sink = open(path, mode) if path else sys.stdout
    try:
        def emit(row: dict) -> None:
            print(json.dumps(row), file=sink, flush=True)
            if sink is not sys.stdout:
                print(json.dumps(row), file=sys.stderr, flush=True)
        yield emit
    finally:
        if sink is not sys.stdout:
            sink.close()


def source_rows(path: str) -> List[Tuple[Tuple[str, ...], bool]]:
    """The rows a harness script writes, read from its source text (nothing
    is imported): for each dict literal given to ``emit`` or
    ``json.dumps``, the patterns of its keys (an f-string key becomes a
    regex) and whether it splices in more keys; a script that writes
    ``resolved_recipe`` as a row of its own also writes ``{"recipe": ...}``.
    The port's harnesses keep the rows of the JAX repo's ``scripts/``: this
    reads those."""
    with open(path) as f:
        src = f.read()
    schemas = []
    for node in ast.walk(ast.parse(src)):
        if not (isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Dict)):
            continue
        fn = node.func
        if getattr(fn, "id", getattr(fn, "attr", None)) not in ("emit",
                                                                 "dumps"):
            continue
        keys, splat = [], False
        for k in node.args[0].keys:
            if k is None:
                splat = True
            elif isinstance(k, ast.Constant):
                keys.append(re.escape(k.value))
            else:                               # an f-string key
                keys.append("".join(re.escape(v.value)
                                    if isinstance(v, ast.Constant) else ".+"
                                    for v in k.values))
        schemas.append((tuple(keys), splat))
    if re.search(r"(emit|dumps)\(resolved_recipe\(", src):
        schemas.append((("recipe",), False))
    return schemas


def row_fits(row: dict, schema: Tuple[Tuple[str, ...], bool]) -> bool:
    """Whether ``row``'s keys are those of ``schema`` (one of
    ``source_rows``): each pattern matches one key, and keys beyond them
    only where the schema splices some in."""
    keys, splat = schema
    rest = set(row)
    for pat in keys:
        hit = [k for k in rest if re.fullmatch(pat, k)]
        if len(hit) != 1:
            return False
        rest.discard(hit[0])
    return splat or not rest


def check_rows(name: str, rows: List[dict], script: str,
               unreached=()) -> None:
    """Raise unless every row of harness ``name`` fits a row of ``script``
    (a JAX script's path) and every row of the script but the key tuples in
    ``unreached`` was written."""
    want = source_rows(script)
    for row in rows:
        if not any(row_fits(row, s) for s in want):
            raise AssertionError(f"{name}: a row with keys {sorted(row)} "
                                 f"fits no row of {script}")
    for s in want:
        if s[0] not in unreached and not any(row_fits(r, s) for r in rows):
            raise AssertionError(f"{name}: no row with the keys {s} of "
                                 f"{script}")
