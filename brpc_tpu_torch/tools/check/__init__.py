"""brpc_tpu_torch.tools.check — the port's static-analysis suite.

The port of ``brpc_tpu/tools/check/``, pointed at ``brpc_tpu_torch/``:
every analyzer reads the port's sources (its engine, bridge, lanes and
loop-thread code) and the port's own tests (``tests/test_torch_*.py``
and their ``torch_*.py`` helpers).  Each analyzer's docstring names the
entries the port renamed; none was deleted.

One command::

    python -m brpc_tpu_torch.tools.check            # all four analyzers
    python -m brpc_tpu_torch.tools.check --fail-fast

and one pytest surface (``tests/test_torch_static_checks.py``) run the same
four analyzers:

- **contracts** — C++↔Python contract checker (closed fallback enums vs
  the Python reason-name tables, the TLV tag registry vs the engine's
  meta scans and pre-encoded prefixes, shim/callback call arities);
- **lanes** — five-lane invariant linter (admission first, deadline
  shed before user code, trace extract, MethodStatus settle, shared
  rejection serialization on every dispatch path);
- **enums** — closed-enum / flag / bvar-cardinality lint (every reason
  declared AND test-pinned, every flag string declared, every labeled
  family bounded);
- **blocking** — blocking-call detector over the loop-thread surfaces
  (slim shims, client demux delivery, finalizers).

Exit status of the CLI: 0 = clean tree, 1 = findings, 2 = suite error.
Analyzers read *source text* (no imports of the code under test) and
accept per-path overrides, so drifts can be seeded into copies — the
linter itself is covered by negative tests.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .base import Finding, Tree
from .blocking import check_blocking
from .contracts import check_contracts
from .enums import check_enums
from .lanes import check_lanes

ANALYZERS = (
    ("contracts", check_contracts),
    ("lanes", check_lanes),
    ("enums", check_enums),
    ("blocking", check_blocking),
)


def run_all(overrides: Optional[Dict[str, str]] = None,
            root: Optional[str] = None,
            only: Optional[Tuple[str, ...]] = None,
            fail_fast: bool = False) -> List[Finding]:
    """Run the suite over the tree (with optional source overrides for
    seeded-drift tests).  Returns every finding; ``fail_fast`` stops
    after the first analyzer that reports any."""
    tree = Tree(root=root, overrides=overrides)
    findings: List[Finding] = []
    for name, fn in ANALYZERS:
        if only and name not in only:
            continue
        findings.extend(fn(tree))
        if fail_fast and findings:
            break
    return findings


__all__ = ["ANALYZERS", "Finding", "Tree", "run_all",
           "check_blocking", "check_contracts", "check_enums",
           "check_lanes"]
