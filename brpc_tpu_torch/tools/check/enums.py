"""Analyzer 3 — closed-enum / flag / bvar-cardinality lint.

The telemetry planes promise *closed* reason enums (no "unknown"
bucket) and every flag read promises a declared flag.  Those promises
hold only while three conventions do:

1. every ``FB_*``/``CFB_*``/``RFB_*``/``DP_*`` token referenced in
   engine.cpp (counter bumps, ``route_fb`` sites, module constants) is
   a declared member of its closed enum — and so is every such token
   the Python side references off the native module;
2. every reason NAME the process can export (engine fallback names,
   client-lane names, scatter screening literals, admission verdicts)
   is pinned by at least one test under ``tests/`` — a reason nobody
   asserts on is a reason free to drift;
3. every ``get_flag``/``set_flag``/``watch_flag`` string literal (in
   the package AND the tests — a test flipping a renamed flag silently
   no-ops) resolves to a ``define_flag`` declaration, and every
   ``PassiveDimension`` family declares its label names as literals,
   with tenant-labeled families living next to a cardinality bound.

The port's copy of ``brpc_tpu/tools/check/enums.py``, reading the
port's engine and package.  Its pins are the port's own: a reason name
must appear in one of the port's tests (``tests/test_torch_*.py`` and
their helpers; ``tests/test_torch_reason_pins.py`` anchors the names
with no behavioral test of their own), since a JAX test pins the JAX
package's name, not the port's; and a flag read or set in those tests
must be one the port declares.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .base import ALLOW_MARK, Finding, Tree, call_name
from . import cppscan

ENGINE = "brpc_tpu_torch/native/src/engine.cpp"

_ENUM_PREFIX = {
    "FB_": "FbReason",
    "CFB_": "CliFb",
    "RFB_": "RouteFb",
    "DP_": "DpStage",
    "SFB_": "StreamFb",
}
# python-side identifiers sharing an enum prefix that are NOT engine
# constants (the bridge's name-table mirror)
_SENTINELS = {"FB_REASONS", "CFB_REASONS", "FB_REASON_NAMES"}

_FLAG_READERS = ("get_flag", "set_flag", "watch_flag")


def _fail(findings, path, line, msg):
    findings.append(Finding("enums", path, line, msg))


def _allowed(text_lines: List[str], line: int) -> bool:
    return 0 < line <= len(text_lines) \
        and ALLOW_MARK in text_lines[line - 1]


def _parse_all(tree: Tree, files) -> List[Tuple[str, str, ast.Module]]:
    out = []
    for rel, text in files:
        try:
            out.append((rel, text, ast.parse(text)))
        except SyntaxError:
            pass
    return out


def _str_const(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None




def check_enums(tree: Tree) -> List[Finding]:
    findings: List[Finding] = []
    eng = tree.text(ENGINE)

    declared: Dict[str, List[str]] = {}
    for prefix, enum_name in _ENUM_PREFIX.items():
        declared[prefix] = cppscan.parse_enum(eng, enum_name) or []

    # 1a. engine-side closed-enum usage
    used = cppscan.used_enum_tokens(eng, tuple(_ENUM_PREFIX))
    for tok, line in sorted(used.items()):
        prefix = next(p for p in _ENUM_PREFIX if tok.startswith(p))
        if tok not in declared[prefix]:
            _fail(findings, ENGINE, line,
                  f"'{tok}' is used but not declared in enum "
                  f"{_ENUM_PREFIX[prefix]} — the closed enum is no "
                  "longer closed")

    pkg = _parse_all(tree, tree.package_files())
    tests = tree.test_files()
    tests_blob = "\n".join(t for _r, t in tests)

    # 1b. python-side references to the engine's enum constants
    tok_re = re.compile(r"\b(?:%s)[A-Z0-9_]+\b"
                        % "|".join(re.escape(p) for p in _ENUM_PREFIX))
    for rel, text, _mod in pkg:
        if "tools/check/" in rel.replace("\\", "/"):
            continue          # the analyzers name tokens in messages
        for i, line in enumerate(text.splitlines(), 1):
            if ALLOW_MARK in line:
                continue
            for m in tok_re.finditer(line):
                tok = m.group(0)
                prefix = next(p for p in _ENUM_PREFIX
                              if tok.startswith(p))
                if declared[prefix] and tok not in declared[prefix] \
                        and tok not in _SENTINELS:
                    _fail(findings, rel, i,
                          f"'{tok}' is not a declared {name_of(prefix)}"
                          " member — the native module will not export "
                          "it")

    # 2. every exportable reason name has a test pin
    reason_names: List[Tuple[str, str]] = []      # (name, origin)
    for arr in ("kFbNames", "kCliFbNames", "kStreamFbNames"):
        for n in cppscan.parse_string_array(eng, arr) or []:
            reason_names.append((n, f"{ENGINE} ({arr})"))
    for rel, _text, mod in pkg:
        for node in ast.walk(mod):
            if isinstance(node, ast.Call) \
                    and call_name(node) == "_scatter_fallback" \
                    and node.args:
                s = _str_const(node.args[0])
                if s:
                    reason_names.append((s, f"{rel} (scatter)"))
        if rel.endswith("server/admission.py"):
            for node in ast.walk(mod):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id in (
                            "ADMITTED", "SERVER_CAP", "METHOD_CAP",
                            "CODEL", "TENANT_QUOTA", "LAME_DUCK"):
                    s = _str_const(node.value)
                    if s:
                        reason_names.append((s, f"{rel} (verdict)"))
        if rel.endswith("kv/transport.py"):
            # the KV transfer plane's closed fallback/close enums: every
            # member needs a test pin, like the engine name tables
            for node in ast.walk(mod):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id in (
                            "KV_FALLBACK_REASONS", "KV_CLOSE_REASONS") \
                        and isinstance(node.value, ast.Tuple):
                    for e in node.value.elts:
                        s = _str_const(e)
                        if s:
                            reason_names.append((s, f"{rel} (kv)"))
        if rel.endswith("models/lm_service.py"):
            # the SLO scheduler's closed event enums (chunk-slice /
            # preemption events + spec-decode outcomes): count_sched/
            # count_spec assert membership at runtime, and every member
            # needs a test anchor here — an unpinned scheduler event is
            # free to drift out of the telemetry contract
            for node in ast.walk(mod):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id in (
                            "SLO_SCHED_EVENTS", "SPEC_DECODE_EVENTS") \
                        and isinstance(node.value, ast.Tuple):
                    for e in node.value.elts:
                        s = _str_const(e)
                        if s:
                            reason_names.append((s, f"{rel} (sched)"))
        if rel.endswith("models/lm_telemetry.py"):
            # the serving-observability plane's closed enums (step-loop
            # phase names + SLO attainment verdicts): record_phase
            # indexes the phase table and count_slo asserts verdict
            # membership at runtime; every member needs a test anchor
            # here — an unpinned phase or verdict is free to drift out
            # of the /lm + Prometheus surface
            for node in ast.walk(mod):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id in (
                            "LM_STEP_PHASES", "LM_SLO_VERDICTS") \
                        and isinstance(node.value, ast.Tuple):
                    for e in node.value.elts:
                        s = _str_const(e)
                        if s:
                            reason_names.append((s, f"{rel} (lm_obs)"))
        if rel.endswith("kv/pages.py"):
            # the paged-KV allocator's closed enums (eviction close
            # reasons + prefix-cache events): same pin discipline —
            # count_evict/count_prefix assert membership at runtime,
            # and every member needs a test anchor here
            for node in ast.walk(mod):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id in (
                            "KV_EVICT_REASONS", "PREFIX_CACHE_EVENTS") \
                        and isinstance(node.value, ast.Tuple):
                    for e in node.value.elts:
                        s = _str_const(e)
                        if s:
                            reason_names.append((s, f"{rel} (kv)"))
        if rel.endswith("brpc_tpu_torch/fleet.py"):
            # the fleet flight recorder's closed event enum:
            # record_event asserts membership at runtime, and every
            # member needs a test anchor here — an unpinned event would
            # silently vanish from the /fleet postmortem timeline
            for node in ast.walk(mod):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id in ("FLEET_EVENTS",) \
                        and isinstance(node.value, ast.Tuple):
                    for e in node.value.elts:
                        s = _str_const(e)
                        if s:
                            reason_names.append((s, f"{rel} (fleet)"))
    seen: Set[str] = set()
    for name, origin in reason_names:
        if name in seen:
            continue
        seen.add(name)
        if name not in tests_blob:
            _fail(findings, origin.split(" ")[0], 1,
                  f"reason '{name}' ({origin}) has no test pin under "
                  "tests/ — an unasserted reason is free to drift")

    # 3a. flag references resolve to declarations
    declared_flags: Set[str] = set()
    for _rel, _text, mod in pkg:
        for node in ast.walk(mod):
            if isinstance(node, ast.Call) \
                    and call_name(node) == "define_flag" and node.args:
                s = _str_const(node.args[0])
                if s:
                    declared_flags.add(s)
    for rel, text, mod in pkg + _parse_all(tree, tests):
        lines = text.splitlines()
        for node in ast.walk(mod):
            if isinstance(node, ast.Call) \
                    and call_name(node) in _FLAG_READERS and node.args:
                s = _str_const(node.args[0])
                if s and s not in declared_flags \
                        and not _allowed(lines, node.lineno):
                    _fail(findings, rel, node.lineno,
                          f"flag '{s}' is read/set but never declared "
                          "with define_flag — typo or renamed flag")

    # 3b. PassiveDimension label discipline
    for rel, text, mod in pkg:
        if rel.endswith("bvar/multi_dimension.py"):
            continue      # the class definition itself
        lines = text.splitlines()
        for node in ast.walk(mod):
            if not (isinstance(node, ast.Call)
                    and call_name(node) in ("PassiveDimension",
                                             "_PassiveDim")):
                continue
            if _allowed(lines, node.lineno):
                continue
            if not node.args:
                continue
            labels = node.args[0]
            if not isinstance(labels, (ast.Tuple, ast.List)) or not all(
                    _str_const(e) for e in labels.elts):
                _fail(findings, rel, node.lineno,
                      "PassiveDimension labels must be a literal tuple "
                      "of names (dynamic label sets are unbounded)")
                continue
            names = [_str_const(e) for e in labels.elts]
            if len(names) > 4:
                _fail(findings, rel, node.lineno,
                      f"PassiveDimension declares {len(names)} labels "
                      "— cardinality explodes multiplicatively")
            if "tenant" in names and "_MAX_TENANTS" not in text \
                    and "TENANT_OVERFLOW" not in text:
                _fail(findings, rel, node.lineno,
                      "tenant-labeled family without a visible "
                      "cardinality bound (_MAX_TENANTS/TENANT_OVERFLOW) "
                      "in the module")
    return findings


def name_of(prefix: str) -> str:
    return _ENUM_PREFIX.get(prefix, prefix)
