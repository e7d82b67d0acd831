"""Analyzer 2 — five-lane invariant linter.

Until every lane binds the interceptor pipeline, the
mandatory request stages are hand-replicated across all five server
dispatch paths.  This AST pass asserts, per lane:

1. the SHARED admission stage runs, and runs BEFORE user code;
2. deadline shedding (``maybe_shed``) runs before user code;
3. trace extraction happens (``start_server_span`` family /
   ``parse_traceparent``);
4. the MethodStatus settle (``on_responded``) is present in the lane
   (directly or in its completion closure);
5. rejection serialization goes through the SHARED helpers — both HTTP
   lanes through ``http_reject``, tpu_std lanes through the classic
   error builder with the rejection's code, the gRPC lane through
   grpc-status 8 (RESOURCE_EXHAUSTED) — so a new lane cannot invent a
   private (and drifting) rejection wire shape.

"User code" is the ``entry.fn`` / ``entry.raw_fn`` invocation (the
slim shims call it through their ``_fn`` closure binding).

The port's copy of ``brpc_tpu/tools/check/lanes.py``, every lane
pointed at its twin in ``brpc_tpu_torch/``.  One lane has another
shape: the port's classic tpu_std lane settles in its completion funnel
``rpc_dispatch._send_response`` (the controller's completion, which
every outcome reaches, an async ``finish`` included), not in a send
closure inside ``process_rpc_request``; its spec names that funnel
(``settle_in``), where the lane body's settle call is looked for.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from .base import Finding, Tree, call_name

# per-lane spec: module, path to the lane function, which names count
# as each stage, and how a rejection must serialize
LANES = (
    {
        # full tpu_std lane — the FIFTH (final) interceptor-chain
        # binding: admission → controller/
        # attachment/ici/shm staging → trace extract → deadline
        # arm+shed live in compile_rpc_chain; the lane body keeps only
        # the protocol concerns (find_method, auth, user interceptor,
        # decompress/parse, user code) and funnels every completion
        # through the chain settle inside its send closure
        "lane": "tpu_std",
        "path": "brpc_tpu_torch/server/rpc_dispatch.py",
        "func": ["process_rpc_request"],
        "settle_in": ["_send_response"],
        "reject": {"kind": "call", "names": {"_send_error"}},
        "chain": {
            "path": "brpc_tpu_torch/server/interceptors.py",
            "func": ["compile_rpc_chain", "enter"],
            "settle_func": ["compile_rpc_chain", "settle"],
            "entry_names": {"_enter", "enter"},
            "settle_names": {"_settle", "settle"},
        },
    },
    {
        # kind-3 slim lane — the SECOND interceptor-chain binding
        # (a mechanical port of the first): the cross-cutting
        # stages live in the compiled chain; the lane body calls
        # enter before user code and settle after.  Its precompiled
        # fast template (trivial shapes only — no admission layers,
        # no trace/tenant) is the documented exception and keeps its
        # own shed call, which this spec's chain half does not weaken:
        # the chain is still checked end to end.
        "lane": "slim",
        "path": "brpc_tpu_torch/server/slim_dispatch.py",
        "func": ["make_slim_handler", "slim"],
        "reject": {"kind": "call", "names": {"_send_error"}},
        "chain": {
            "path": "brpc_tpu_torch/server/interceptors.py",
            "func": ["compile_chain", "enter"],
            "settle_func": ["compile_chain", "settle"],
            "entry_names": {"_enter", "enter"},
            "settle_names": {"_settle", "settle"},
        },
    },
    {
        # classic HTTP bridge — the THIRD interceptor-chain binding:
        # admission/trace/deadline live in compile_http_chain; the lane
        # body builds its HTTP send closure, calls enter before user
        # code, and settles every response shape through the chain
        "lane": "http",
        "path": "brpc_tpu_torch/server/http_dispatch.py",
        "func": ["_bridge_rpc"],
        "reject": {"kind": "call", "names": {"http_reject", "_reject"}},
        "chain": {
            "path": "brpc_tpu_torch/server/interceptors.py",
            "func": ["compile_http_chain", "enter"],
            "settle_func": ["compile_http_chain", "settle"],
            "entry_names": {"_enter", "enter"},
            "settle_names": {"_settle", "settle"},
        },
    },
    {
        # kind-4 slim HTTP lane — the FOURTH interceptor-chain binding:
        # admission/trace/deadline-shed live in compile_http_slim_chain
        # (rejections and sheds come back as inline slim tuples); the
        # shim body keeps only the cell/deliver plumbing and settles
        # every response shape through the chain
        "lane": "http_slim",
        "path": "brpc_tpu_torch/server/http_slim.py",
        "func": ["make_http_slim_handler", "slim"],
        "reject": {"kind": "call", "names": {"http_reject", "_reject"}},
        "chain": {
            "path": "brpc_tpu_torch/server/interceptors.py",
            "func": ["compile_http_slim_chain", "enter"],
            "settle_func": ["compile_http_slim_chain", "settle"],
            "entry_names": {"_enter", "enter"},
            "settle_names": {"_settle", "settle"},
        },
    },
    {
        "lane": "grpc",
        "path": "brpc_tpu_torch/protocol/h2_rpc.py",
        "func": ["_process_grpc"],
        "reject": {"kind": "grpc8"},
    },
    {
        # fully-buffered requests on @grpc_streaming methods ride this
        # fiber body instead of _process_grpc's unary path; no span
        # machinery there (streams are not traced), so trace/shed are
        # not required — admission + settle + grpc-status 8 are
        "lane": "grpc_streaming",
        "path": "brpc_tpu_torch/protocol/h2_rpc.py",
        "func": ["_run_streaming_handler"],
        "reject": {"kind": "grpc8"},
        "optional": {"trace", "shed"},
    },
    {
        # kind-5 streaming lane — the FIRST interceptor-chain BINDING:
        # the cross-cutting stages live in the
        # compiled chain (server/interceptors.py), not the lane body.
        # The linter checks the CHAIN for admission→shed ordering,
        # trace extraction and the shared rejection serializer, and
        # the LANE BODY for chain-enter-before-user-code plus the
        # settle call — a binding lane cannot drop or reorder a stage
        # without one of the two halves failing here.
        "lane": "stream_slim",
        "path": "brpc_tpu_torch/server/stream_slim.py",
        "func": ["make_stream_handler", "slim"],
        "reject": {"kind": "call", "names": {"_send_error"}},
        "chain": {
            "path": "brpc_tpu_torch/server/interceptors.py",
            "func": ["compile_chain", "enter"],
            "settle_func": ["compile_chain", "settle"],
            "entry_names": {"_enter", "enter"},
            "settle_names": {"_settle", "settle"},
        },
    },
)

ADMIT_NAMES = {"admit", "_admit", "_admit_rpc", "_admit_stage",
               "_trivial", "trivial_shape"}
SHED_NAMES = {"maybe_shed", "_maybe_shed", "_shed"}
TRACE_NAMES = {"start_server_span", "passive_server_span",
               "parse_traceparent", "_sample", "_pspan"}
SETTLE_NAMES = {"on_responded"}
USER_FN_NAMES = {"fn", "_fn", "raw_fn"}


def _fail(findings, path, line, lane, msg):
    findings.append(Finding("lanes", path, line, f"[{lane}] {msg}"))


def _find_func(mod: ast.Module, qualpath: Sequence[str]
               ) -> Optional[ast.FunctionDef]:
    scope: Sequence[ast.stmt] = mod.body
    node = None
    for name in qualpath:
        node = None
        for n in scope:
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) \
                    and n.name == name:
                node = n
                break
        if node is None:
            return None
        scope = node.body
    return node if isinstance(node, ast.FunctionDef) else None




def _calls(func: ast.FunctionDef) -> List[ast.Call]:
    return [n for n in ast.walk(func) if isinstance(n, ast.Call)]


def _first_line(calls: List[ast.Call], names: Set[str]
                ) -> Optional[int]:
    lines = [c.lineno for c in calls if call_name(c) in names]
    return min(lines) if lines else None


def _rejection_blocks(func: ast.FunctionDef) -> List[ast.If]:
    """``if rej is not None:``-shaped guards (any If whose test reads a
    name ending in ``rej``)."""
    out = []
    for n in ast.walk(func):
        if isinstance(n, ast.If):
            for sub in ast.walk(n.test):
                if isinstance(sub, ast.Name) and sub.id.endswith("rej"):
                    out.append(n)
                    break
    return out


def _block_has_call(block: ast.If, names: Set[str]) -> bool:
    return any(isinstance(n, ast.Call) and call_name(n) in names
               for stmt in block.body for n in ast.walk(stmt))


def _block_has_grpc8(block: ast.If) -> bool:
    """A send_grpc_response(..., 8, ...) / _finish(8, ...) call —
    RESOURCE_EXHAUSTED is the one legal admission-rejection status."""
    for stmt in block.body:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call) \
                    and call_name(n) in ("send_grpc_response",
                                          "_finish"):
                if any(isinstance(a, ast.Constant) and a.value == 8
                       for a in n.args):
                    return True
    return False


def _check_chain_lane(tree: Tree, spec, findings: List[Finding]) -> None:
    """An interceptor-chain BINDING lane: the mandatory stages live in
    the compiled chain, the lane body only calls enter/settle.  Two
    halves, both machine-checked:

    - CHAIN (interceptors.enter): admission present and BEFORE the
      deadline shed; trace extraction present; every ``if rej:`` block
      serializes through the shared helper;
    - LANE BODY: the chain-enter call runs BEFORE user code, and the
      settle half (chain ``settle`` with the MethodStatus
      ``on_responded``) is actually invoked.
    """
    lane, path = spec["lane"], spec["path"]
    chain = spec["chain"]
    cpath = chain["path"]
    try:
        cmod = ast.parse(tree.text(cpath))
    except SyntaxError as e:
        _fail(findings, cpath, e.lineno or 1, lane,
              f"chain syntax error: {e.msg}")
        return
    enter = _find_func(cmod, chain["func"])
    if enter is None:
        _fail(findings, cpath, 1, lane,
              f"chain function {'.'.join(chain['func'])} not found")
        return
    ccalls = _calls(enter)
    admit_at = _first_line(ccalls, ADMIT_NAMES)
    shed_at = _first_line(ccalls, SHED_NAMES)
    trace_at = _first_line(ccalls, TRACE_NAMES)
    if admit_at is None:
        _fail(findings, cpath, enter.lineno, lane,
              "chain enter is missing the mandatory admission stage "
              "(server/admission.admit)")
    if shed_at is None:
        _fail(findings, cpath, enter.lineno, lane,
              "chain enter is missing the deadline shed "
              "(deadline.maybe_shed)")
    if admit_at is not None and shed_at is not None \
            and admit_at > shed_at:
        _fail(findings, cpath, admit_at, lane,
              "chain admission must precede the deadline shed "
              "(rejections are cheaper than armed deadlines)")
    if trace_at is None:
        _fail(findings, cpath, enter.lineno, lane,
              "chain enter is missing trace extraction "
              "(start_server_span family)")
    blocks = _rejection_blocks(enter)
    if admit_at is not None and not blocks:
        _fail(findings, cpath, enter.lineno, lane,
              "no `if rej is not None` rejection guard found in the "
              "chain — admission verdicts are not being honored")
    for block in blocks:
        if not _block_has_call(block, spec["reject"]["names"]):
            _fail(findings, cpath, block.lineno, lane,
                  "chain rejection block does not serialize through "
                  "the shared helper "
                  f"({' / '.join(sorted(spec['reject']['names']))})")
    settle_fn = _find_func(cmod, chain["settle_func"])
    if settle_fn is None or _first_line(_calls(settle_fn),
                                        SETTLE_NAMES) is None:
        _fail(findings, cpath, enter.lineno, lane,
              "chain settle half is missing the MethodStatus settle "
              "(on_responded) — admission in-flight counts would leak")
    # -- the lane body: enter-before-user-code + settle invoked --------
    try:
        mod = ast.parse(tree.text(path))
    except SyntaxError as e:
        _fail(findings, path, e.lineno or 1, lane,
              f"syntax error: {e.msg}")
        return
    func = _find_func(mod, spec["func"])
    if func is None:
        _fail(findings, path, 1, lane,
              f"lane function {'.'.join(spec['func'])} not found")
        return
    calls = _calls(func)
    user_at = _first_line(calls, USER_FN_NAMES)
    enter_at = _first_line(calls, set(chain["entry_names"]))
    settle_scope = func
    if "settle_in" in spec:
        settle_scope = _find_func(mod, spec["settle_in"])
        if settle_scope is None:
            _fail(findings, path, 1, lane,
                  f"completion funnel {'.'.join(spec['settle_in'])} "
                  "not found")
            return
    settle_at = _first_line(_calls(settle_scope),
                            set(chain["settle_names"]))
    if user_at is None:
        _fail(findings, path, func.lineno, lane,
              "no user-code invocation (entry.fn/raw_fn) found — "
              "lane shape changed, update the linter spec")
        return
    if enter_at is None:
        _fail(findings, path, func.lineno, lane,
              "lane body never calls the compiled interceptor chain "
              "(enter) — the binding is gone")
    elif enter_at > user_at:
        _fail(findings, path, enter_at, lane,
              f"chain enter runs at line {enter_at}, AFTER user code "
              f"at line {user_at} — the stages must run first")
    if settle_at is None:
        _fail(findings, path, func.lineno, lane,
              "lane body never calls the chain settle half — "
              "fast completions would skip MethodStatus/rpcz")


def check_lanes(tree: Tree) -> List[Finding]:
    findings: List[Finding] = []
    for spec in LANES:
        lane, path = spec["lane"], spec["path"]
        optional = spec.get("optional", set())
        if "chain" in spec:
            _check_chain_lane(tree, spec, findings)
            continue
        try:
            mod = ast.parse(tree.text(path))
        except SyntaxError as e:
            _fail(findings, path, e.lineno or 1, lane,
                  f"syntax error: {e.msg}")
            continue
        func = _find_func(mod, spec["func"])
        if func is None:
            _fail(findings, path, 1, lane,
                  f"lane function {'.'.join(spec['func'])} not found")
            continue
        calls = _calls(func)
        admit_at = _first_line(calls, ADMIT_NAMES)
        shed_at = _first_line(calls, SHED_NAMES)
        trace_at = _first_line(calls, TRACE_NAMES)
        settle_at = _first_line(calls, SETTLE_NAMES)
        user_at = _first_line(calls, USER_FN_NAMES)

        if user_at is None:
            _fail(findings, path, func.lineno, lane,
                  "no user-code invocation (entry.fn/raw_fn) found — "
                  "lane shape changed, update the linter spec")
            continue
        if admit_at is None:
            _fail(findings, path, func.lineno, lane,
                  "mandatory admission stage (server/admission.admit) "
                  "is missing")
        elif admit_at > user_at:
            _fail(findings, path, admit_at, lane,
                  f"admission runs at line {admit_at}, AFTER user code "
                  f"at line {user_at} — admission must be first")
        if "shed" not in optional:
            if shed_at is None:
                _fail(findings, path, func.lineno, lane,
                      "deadline shed (deadline.maybe_shed) is missing — "
                      "queue-expired requests would reach user code")
            elif shed_at > user_at:
                _fail(findings, path, shed_at, lane,
                      f"deadline shed at line {shed_at} runs after "
                      f"user code at line {user_at}")
            if admit_at is not None and shed_at is not None \
                    and admit_at > shed_at:
                _fail(findings, path, admit_at, lane,
                      "admission must precede the deadline shed "
                      "(rejections are cheaper than armed deadlines)")
        if "trace" not in optional and trace_at is None:
            _fail(findings, path, func.lineno, lane,
                  "trace extraction (start_server_span family) is "
                  "missing — requests on this lane would drop their "
                  "trace context")
        if settle_at is None:
            _fail(findings, path, func.lineno, lane,
                  "MethodStatus settle (on_responded) is missing — "
                  "admission in-flight counts would leak")

        # rejection serialization through the shared helpers
        blocks = _rejection_blocks(func)
        if admit_at is not None and not blocks:
            _fail(findings, path, func.lineno, lane,
                  "no `if rej is not None` rejection guard found — "
                  "admission verdicts are not being honored")
        rj = spec["reject"]
        for block in blocks:
            if rj["kind"] == "grpc8":
                ok = _block_has_grpc8(block)
                want = "grpc-status 8 (RESOURCE_EXHAUSTED)"
            else:
                ok = _block_has_call(block, rj["names"])
                want = " / ".join(sorted(rj["names"]))
            if not ok:
                _fail(findings, path, block.lineno, lane,
                      f"rejection block does not serialize through the "
                      f"shared helper ({want}) — lanes must not invent "
                      "private rejection wire shapes")
    return findings
