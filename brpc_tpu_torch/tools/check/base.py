"""Shared plumbing for the repo's static-analysis suite.

Every analyzer is a function ``(tree: Tree) -> list[Finding]``.  A
:class:`Tree` hands out *source text* (never imports the code under
analysis), and accepts per-path overrides so the suite's own negative
tests can seed a drift into a copy of a file and assert the analyzer
catches it — the linter is itself testable by construction.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Tuple

# repo root: brpc_tpu_torch/tools/check/base.py -> three levels up
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

# suppression marker: a flagged line carrying this comment is skipped
# (the analyzers are heuristic; a reviewed exception states itself in
# the source instead of weakening the rule)
ALLOW_MARK = "static-check: allow"

# the package under analysis
PACKAGE = "brpc_tpu_torch"


class Finding:
    """One analyzer finding: where and what."""

    __slots__ = ("analyzer", "path", "line", "message")

    def __init__(self, analyzer: str, path: str, line: int,
                 message: str):
        self.analyzer = analyzer
        self.path = path
        self.line = line
        self.message = message

    def __repr__(self) -> str:
        return f"{self.path}:{self.line}: [{self.analyzer}] {self.message}"


class Tree:
    """Source access for the analyzers.  ``overrides`` maps repo-relative
    paths to replacement text (the seeded-drift test hook); everything
    else reads from disk under ``root``."""

    def __init__(self, root: Optional[str] = None,
                 overrides: Optional[Dict[str, str]] = None):
        self.root = root or _ROOT
        self.overrides = dict(overrides or {})

    def path(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def exists(self, rel: str) -> bool:
        return rel in self.overrides or os.path.exists(self.path(rel))

    def text(self, rel: str) -> str:
        if rel in self.overrides:
            return self.overrides[rel]
        with open(self.path(rel), "r", encoding="utf-8",
                  errors="replace") as f:
            return f.read()

    def _walk_py(self, base_rel: str) -> Iterable[str]:
        base = self.path(base_rel)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    full = os.path.join(dirpath, fn)
                    yield os.path.relpath(full, self.root)

    def package_files(self) -> List[Tuple[str, str]]:
        """(relpath, text) for every .py under brpc_tpu_torch/ (overrides
        applied; override-only paths under the package are included)."""
        rels = set(self._walk_py(PACKAGE))
        rels.update(r for r in self.overrides
                    if r.startswith(PACKAGE + "/") and r.endswith(".py"))
        return [(r, self.text(r)) for r in sorted(rels)]

    def test_files(self) -> List[Tuple[str, str]]:
        """(relpath, text) for the port's own test files under tests/
        (``test_torch_*.py`` and their ``torch_*.py`` helpers): a JAX
        test pins the JAX package's names, not the port's."""
        rels = set(r for r in self._walk_py("tests") if _is_port_test(r))
        rels.update(r for r in self.overrides
                    if r.startswith("tests") and r.endswith(".py")
                    and _is_port_test(r))
        return [(r, self.text(r)) for r in sorted(rels)]


def _is_port_test(rel: str) -> bool:
    name = os.path.basename(rel)
    return name.startswith("test_torch_") or name.startswith("torch_")


def public_arity(func_def) -> int:
    """Count of a ``def``'s *public* parameters — the call-contract
    arity.  Excludes ``self``/``cls`` and the underscore-prefixed
    default-bound privates the fast paths use to pin globals
    (``_server=server`` closures are implementation, not interface)."""
    args = func_def.args
    names = [a.arg for a in args.posonlyargs + args.args]
    if names and names[0] in ("self", "cls"):
        names = names[1:]
    return sum(1 for n in names if not n.startswith("_"))


def call_name(call: ast.Call) -> Optional[str]:
    """Bare/attr callee name of an ast.Call (``foo(...)`` and
    ``x.foo(...)`` both resolve to ``"foo"``) — the one call-site
    identity every analyzer matches on."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None
