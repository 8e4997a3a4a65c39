"""Fail if any ncnet_tpu_torch library module calls a bare ``print()``.

The observability layer (``ncnet_tpu_torch/observability/logging.py``) is
the one console sink: library code logs through ``get_logger(...)``, so
that every rendered line is also teed into the structured event log.  A
bare ``print()`` reopens the side channel that the logger closes.

Exemptions:
  * ``ncnet_tpu_torch/cli/`` and ``ncnet_tpu_torch/tools/``: entry points
    whose printed banners and results are their user interface, not run
    telemetry;
  * docstrings and comments: the scan is AST-based, so ``print()``
    mentioned in prose never trips it;
  * ``sys.stdout.write`` (the logger's own sink) and attribute calls.

Usage::

    python -m ncnet_tpu_torch.tools.check_no_bare_print [package_dir ...]

prints one ``path:line`` per call found and exits 1 if there was any.
Several targets may be given, each walked on its own (a ``.py`` file is
checked directly).  The default target is the ``ncnet_tpu_torch`` package
this module belongs to.  The port of ``tools/check_no_bare_print.py``.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import List, Optional, Tuple

EXEMPT_DIRS = ("cli", "tools")


def _check_file(path: str, hits: List[Tuple[str, int]]) -> None:
    with open(path, "r") as f:
        try:
            tree = ast.parse(f.read(), path)
        except SyntaxError as e:  # a broken module is its own bug
            hits.append((path, e.lineno or 0))
            return
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"):
            hits.append((path, node.lineno))


def find_bare_prints(target: str) -> List[Tuple[str, int]]:
    """``(path, lineno)`` for every ``print(...)`` call in a non-exempt
    module under directory ``target`` (or in the single file ``target``)."""
    hits: List[Tuple[str, int]] = []
    if os.path.isfile(target):
        _check_file(target, hits)
        return hits
    for root, dirs, files in os.walk(target):
        rel = os.path.relpath(root, target)
        parts = [] if rel == "." else rel.split(os.sep)
        if any(p in EXEMPT_DIRS for p in parts):
            continue
        for fname in sorted(files):
            if fname.endswith(".py"):
                _check_file(os.path.join(root, fname), hits)
    return hits


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    targets = args or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    hits: List[Tuple[str, int]] = []
    for target in targets:
        hits.extend(find_bare_prints(target))
    for path, lineno in hits:
        print(f"{path}:{lineno}: bare print() in a library module "
              "(use ncnet_tpu_torch.observability.get_logger)")
    if hits:
        print(f"{len(hits)} bare print call(s) found under "
              f"{', '.join(targets)} (exempt: {', '.join(EXEMPT_DIRS)}/)")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
