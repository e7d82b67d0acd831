"""Analyzer 1 — C++ ↔ Python contract checker.

The native lanes rest on hand-mirrored contracts: engine.cpp's closed
fallback enums vs the Python reason-name tables, the TLV tag registry
vs the engine's meta scans and the pre-encoded ``TLV_*`` prefixes, and
the shim call arities (which "grew one arg" in two separate rounds).
This analyzer reads BOTH sides as source text and cross-checks every
one of them, so a drift fails tier-1 instead of waiting for the exact
runtime shape that exercises it.

The port's copy of ``brpc_tpu/tools/check/contracts.py``, reading the
port's engine (``brpc_tpu_torch/native/src/engine.cpp``), meta codec,
bridge, client lane and slim lanes.  The client demux's burst callback
is ``ClientLane._on_loop_burst`` (the port folded JAX's ``_on_burst``
into it; ``_bind_burst`` hands it to each demux), and a missing
callback is a finding here, where the JAX analyzer skips the check.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional

from .base import Finding, Tree, public_arity
from . import cppscan

ENGINE = "brpc_tpu_torch/native/src/engine.cpp"
META = "brpc_tpu_torch/protocol/meta.py"
BRIDGE = "brpc_tpu_torch/transport/native_bridge.py"
CLIENT_LANE = "brpc_tpu_torch/transport/client_lane.py"
SLIM = "brpc_tpu_torch/server/slim_dispatch.py"
HTTP_SLIM = "brpc_tpu_torch/server/http_slim.py"
STREAM_SLIM = "brpc_tpu_torch/server/stream_slim.py"

# struct format char -> byte width (the meta codec's fixed-size fields)
_WIDTHS = {"Q": 8, "q": 8, "I": 4, "i": 4, "H": 2, "h": 2, "B": 1}


def _fail(findings, path, line, msg):
    findings.append(Finding("contracts", path, line, msg))


# -- python-side extraction --------------------------------------------------

def _module_tuple(tree: Tree, rel: str, name: str) -> Optional[List[str]]:
    """A module-level tuple/list of string constants, by variable name."""
    try:
        mod = ast.parse(tree.text(rel))
    except SyntaxError:
        return None
    for node in mod.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name \
                        and isinstance(node.value, (ast.Tuple, ast.List)):
                    out = []
                    for e in node.value.elts:
                        if isinstance(e, ast.Constant) \
                                and isinstance(e.value, str):
                            out.append(e.value)
                        else:
                            return None
                    return out
    return None


def meta_registry(tree: Tree) -> Dict[str, Dict]:
    """The TLV registry out of protocol/meta.py source:

    - ``tags``: _T_NAME -> int tag
    - ``widths``: tag -> fixed byte width (None = variable length),
      derived from the codec (``struct.unpack("<Q", ...)`` in decode)
    - ``prefixes``: TLV_NAME -> bytes literal
    """
    mod = ast.parse(tree.text(META))
    tags: Dict[str, int] = {}
    prefixes: Dict[str, bytes] = {}
    for node in ast.walk(mod):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name.startswith("_T_") and isinstance(node.value,
                                                     ast.Constant) \
                    and isinstance(node.value.value, int):
                tags[name] = node.value.value
            if name.startswith("TLV_") and isinstance(node.value,
                                                      ast.Constant) \
                    and isinstance(node.value.value, bytes):
                prefixes[name] = node.value.value
    # widths from the decode() unpacks: `struct.unpack("<Q", field)`
    # guarded by `tag == _T_X` — walk the if/elif chain
    widths: Dict[int, Optional[int]] = {t: None for t in tags.values()}
    src = tree.text(META)
    for m in re.finditer(
            r"tag\s*==\s*(_T_\w+)\s*:\s*\n(.*?)(?=\n\s*elif|\n\s*#|\Z)",
            src, re.S):
        tname, body = m.group(1), m.group(2)
        if tname not in tags:
            continue
        wm = re.search(r'struct\.unpack\("<(\w)"', body)
        if wm and wm.group(1) in _WIDTHS:
            widths[tags[tname]] = _WIDTHS[wm.group(1)]
        elif "field[0]" in body:
            widths[tags[tname]] = 1
    return {"tags": tags, "widths": widths, "prefixes": prefixes}


def _public_def_arity(tree: Tree, rel: str, qualpath: List[str]
                      ) -> Optional[int]:
    """Public arity of a (possibly nested) function.  ``qualpath`` is
    e.g. ["make_slim_handler", "slim"] or ["ClientLane", "_on_burst"]."""
    try:
        mod = ast.parse(tree.text(rel))
    except SyntaxError:
        return None
    scope = mod.body
    node = None
    for name in qualpath:
        node = None
        for n in scope:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and n.name == name:
                node = n
                break
        if node is None:
            return None
        scope = node.body
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None
    return public_arity(node)


# -- the checks --------------------------------------------------------------

def _check_reason_tables(tree, eng, findings) -> None:
    # FbReason members vs kFbNames (count), vs the bridge mirror (order)
    fb = cppscan.parse_enum(eng, "FbReason")
    fb_names = cppscan.parse_string_array(eng, "kFbNames")
    if fb is None or fb_names is None:
        _fail(findings, ENGINE, 1,
              "FbReason enum or kFbNames table not found")
        return
    fb_members = [m for m in fb if m != "FB_REASONS"]
    if len(fb_members) != len(fb_names):
        _fail(findings, ENGINE, 1,
              f"FbReason has {len(fb_members)} members but kFbNames "
              f"has {len(fb_names)} strings — the reason-name table "
              "drifted from the enum")
    mirror = _module_tuple(tree, BRIDGE, "FB_REASON_NAMES")
    if mirror is None:
        _fail(findings, BRIDGE, 1,
              "FB_REASON_NAMES mirror missing from the bridge (the "
              "fallback family pre-seed must cover every engine reason)")
    elif list(mirror) != list(fb_names):
        _fail(findings, BRIDGE, 1,
              f"bridge FB_REASON_NAMES != engine kFbNames: "
              f"{sorted(set(mirror) ^ set(fb_names)) or 'order differs'}")

    # RouteFb per-route names must each be one of the global reasons
    rfb = cppscan.parse_enum(eng, "RouteFb")
    rfb_names = cppscan.parse_string_array(eng, "kRouteFbNames")
    if rfb is not None and rfb_names is not None:
        rfb_members = [m for m in rfb if m != "kRouteFb"]
        if len(rfb_members) != len(rfb_names):
            _fail(findings, ENGINE, 1,
                  f"RouteFb has {len(rfb_members)} members but "
                  f"kRouteFbNames has {len(rfb_names)}")
        for n in rfb_names:
            if n not in fb_names:
                _fail(findings, ENGINE, 1,
                      f"kRouteFbNames entry '{n}' is not a kFbNames "
                      "reason — per-route attribution would invent a "
                      "name the global family never exports")

    # kind-5 streaming lane: StreamFb vs kStreamFbNames vs the
    # stream_slim mirror
    sfb = cppscan.parse_enum(eng, "StreamFb")
    sfb_names = cppscan.parse_string_array(eng, "kStreamFbNames")
    if sfb is None or sfb_names is None:
        _fail(findings, ENGINE, 1,
              "StreamFb enum or kStreamFbNames table not found")
    else:
        sfb_members = [m for m in sfb if m != "SFB_REASONS"]
        if len(sfb_members) != len(sfb_names):
            _fail(findings, ENGINE, 1,
                  f"StreamFb has {len(sfb_members)} members but "
                  f"kStreamFbNames has {len(sfb_names)} strings — the "
                  "kind-5 reason-name table drifted from the enum")
        smirror = _module_tuple(tree, STREAM_SLIM, "STREAM_FB_NAMES")
        if smirror is None:
            _fail(findings, STREAM_SLIM, 1,
                  "STREAM_FB_NAMES mirror missing from stream_slim "
                  "(the kind-5 fallback pre-seed must cover every "
                  "engine reason)")
        elif list(smirror) != list(sfb_names):
            _fail(findings, STREAM_SLIM, 1,
                  f"stream_slim STREAM_FB_NAMES != engine "
                  f"kStreamFbNames: "
                  f"{sorted(set(smirror) ^ set(sfb_names)) or 'order differs'}")

    # client lane: CliFb vs kCliFbNames vs the Python REASONS tuple
    cli = cppscan.parse_enum(eng, "CliFb")
    cli_names = cppscan.parse_string_array(eng, "kCliFbNames")
    if cli is None or cli_names is None:
        _fail(findings, ENGINE, 1,
              "CliFb enum or kCliFbNames table not found")
        return
    cli_members = [m for m in cli if m != "CFB_REASONS"]
    if len(cli_members) != len(cli_names):
        _fail(findings, ENGINE, 1,
              f"CliFb has {len(cli_members)} members but kCliFbNames "
              f"has {len(cli_names)} strings")
    reasons = _module_tuple(tree, CLIENT_LANE, "REASONS")
    if reasons is None:
        _fail(findings, CLIENT_LANE, 1, "REASONS tuple not found")
    elif list(reasons) != list(cli_names):
        _fail(findings, CLIENT_LANE, 1,
              f"client_lane.REASONS != engine kCliFbNames: "
              f"{sorted(set(reasons) ^ set(cli_names)) or 'order differs'}")


def _check_tlv_registry(tree, eng, findings) -> None:
    reg = meta_registry(tree)
    tags, widths, prefixes = reg["tags"], reg["widths"], reg["prefixes"]
    if not tags:
        _fail(findings, META, 1, "no _T_* tag registry found")
        return
    by_value: Dict[int, str] = {}
    for name, val in tags.items():
        if val in by_value:
            _fail(findings, META, 1,
                  f"duplicate TLV tag {val}: {by_value[val]} and {name}")
        by_value[val] = name

    # the engine's request meta scan: every case label must be a
    # registered tag, and fixed-length guards must match the codec width
    cases = cppscan.scan_case_tags(eng, "scan_request_meta")
    if not cases:
        _fail(findings, ENGINE, 1, "scan_request_meta case labels not "
                                   "found")
    for tag, need in cases.items():
        if tag not in by_value:
            _fail(findings, ENGINE, 1,
                  f"engine scan_request_meta handles TLV tag {tag} "
                  "which is not in protocol/meta.py's registry "
                  "(renumbered or removed?)")
            continue
        want = widths.get(tag)
        if need is not None and want is not None and need != want:
            _fail(findings, ENGINE, 1,
                  f"engine requires length {need} for TLV tag {tag} "
                  f"({by_value[tag]}) but the Python codec reads "
                  f"{want} bytes")
    # ad-hoc `tag == N` walks (client demux classification, plain-resp
    # scans): every literal tag referenced anywhere must be registered
    for tag in cppscan.literal_tag_checks(eng):
        if tag != 0 and tag not in by_value:
            _fail(findings, ENGINE, 1,
                  f"engine compares against TLV tag {tag} which is not "
                  "in protocol/meta.py's registry")

    # pre-encoded TLV_* prefixes: tag byte + <I length must agree with
    # the registry tag and the codec's fixed width
    alias = {"TLV_CORRELATION": "_T_CORRELATION",
             "TLV_ATTACHMENT": "_T_ATTACHMENT",
             "TLV_TIMEOUT": "_T_TIMEOUT_MS",
             "TLV_TRACE": "_T_TRACE_ID",
             "TLV_SPAN": "_T_SPAN_ID"}
    for pname, blob in prefixes.items():
        tname = alias.get(pname, "_T_" + pname[4:])
        if tname not in tags:
            _fail(findings, META, 1,
                  f"{pname} has no matching registry tag ({tname})")
            continue
        if len(blob) != 5:
            _fail(findings, META, 1,
                  f"{pname} must be 5 bytes (tag + u32 length), got "
                  f"{len(blob)}")
            continue
        if blob[0] != tags[tname]:
            _fail(findings, META, 1,
                  f"{pname} tag byte is {blob[0]} but {tname} is "
                  f"{tags[tname]} — pre-encoded prefix drifted from "
                  "the registry")
        ln = int.from_bytes(blob[1:5], "little")
        want = widths.get(tags[tname])
        if want is not None and ln != want:
            _fail(findings, META, 1,
                  f"{pname} length field says {ln} bytes but the codec "
                  f"reads {want} for {tname}")


def _check_shim_arities(tree, eng, findings) -> None:
    # kind-3 (slim tpu_std) and kind-2 (raw) shim call sites — both go
    # through it.m->handler; the kind-3 site sits inside the
    # `if (it.m->kind == 3)` branch, which precedes the kind-2 else arm
    clean = cppscan.strip_comments(eng)
    sites = cppscan.call_sites(eng, "PyObject_CallFunctionObjArgs",
                               "it.m->handler")
    # sites are in source order: the first sits inside the
    # `if (it.m->kind == 3)` branch (slim), the second in the else arm
    # (kind-2 raw) — raw_slim_item's layout, sanity-checked below
    kind3_off = clean.find("it.m->kind == 3")
    kind3 = sites[0][1] if sites and kind3_off != -1 \
        and sites[0][0] > kind3_off else None
    kind2 = sites[1][1] if len(sites) >= 2 else None
    if kind3 is None:
        _fail(findings, ENGINE, 1, "kind-3 slim shim call site not found")
    else:
        want = _public_def_arity(tree, SLIM, ["make_slim_handler", "slim"])
        if want is None:
            _fail(findings, SLIM, 1,
                  "make_slim_handler's inner slim() def not found")
        elif len(kind3) != want:
            _fail(findings, ENGINE, 1,
                  f"engine calls the kind-3 slim shim with "
                  f"{len(kind3)} args but slim_dispatch's shim "
                  f"takes {want} — the contract grew/shrank on one "
                  "side only")
    if kind2 is not None:
        if len(kind2) != 2:
            _fail(findings, ENGINE, 1,
                  f"engine calls the kind-2 raw handler with "
                  f"{len(kind2)} args; @raw_method's contract is "
                  "(payload, attachment)")

    # kind-5 (stream open) shim
    s5_sites = cppscan.call_sites(eng, "PyObject_CallFunctionObjArgs",
                                  "it.m->stream_handler")
    if not s5_sites:
        _fail(findings, ENGINE, 1,
              "kind-5 stream shim call site not found")
    else:
        want = _public_def_arity(tree, STREAM_SLIM,
                                 ["make_stream_handler", "slim"])
        if want is None:
            _fail(findings, STREAM_SLIM, 1,
                  "make_stream_handler's inner slim() def not found")
        elif len(s5_sites[0][1]) != want:
            _fail(findings, ENGINE, 1,
                  f"engine calls the kind-5 stream shim with "
                  f"{len(s5_sites[0][1])} args but stream_slim's shim "
                  f"takes {want} — the contract grew/shrank on one "
                  "side only")

    # batched stream-chunk delivery: one-list contract
    chunk_sites = cppscan.call_sites(eng, "PyObject_CallFunctionObjArgs",
                                     "lp->eng->stream_chunks")
    if not chunk_sites:
        _fail(findings, ENGINE, 1,
              "stream chunk delivery call site not found")
    else:
        want = _public_def_arity(tree, STREAM_SLIM, ["slim_chunks"])
        if want is not None and len(chunk_sites[0][1]) != want:
            _fail(findings, ENGINE, 1,
                  f"engine calls stream_chunks with "
                  f"{len(chunk_sites[0][1])} args but slim_chunks "
                  f"takes {want}")

    # kind-4 (slim HTTP) shim
    http_sites = cppscan.call_sites(eng, "PyObject_CallFunctionObjArgs",
                                    "it.hroute->handler")
    if not http_sites:
        _fail(findings, ENGINE, 1, "kind-4 http shim call site not found")
    else:
        want = _public_def_arity(tree, HTTP_SLIM,
                                 ["make_http_slim_handler", "slim"])
        if want is None:
            _fail(findings, HTTP_SLIM, 1,
                  "make_http_slim_handler's inner slim() def not found")
        elif len(http_sites[0][1]) != want:
            _fail(findings, ENGINE, 1,
                  f"engine calls the kind-4 http shim with "
                  f"{len(http_sites[0][1])} args but http_slim's shim "
                  f"takes {want}")

    # burst-end hook: CallNoArgs on the C side, zero-arg def on ours
    if "PyObject_CallNoArgs(lp->eng->burst_end)" not in clean:
        _fail(findings, ENGINE, 1,
              "burst_end hook is no longer a CallNoArgs site — "
              "flush_burst_accounting's zero-arg contract drifted")
    want = _public_def_arity(tree, SLIM, ["flush_burst_accounting"])
    if want != 0:
        _fail(findings, SLIM, 1,
              f"flush_burst_accounting takes {want} args; the engine "
              "invokes it with none")

    # format-string entries: the event dispatch callback and the client
    # demux burst callback
    disp_fmts = set(cppscan.callfunction_formats(eng, "eng->dispatch"))
    want = _public_def_arity(tree, BRIDGE, ["NativeBridge", "_dispatch"])
    for fmt in disp_fmts:
        if want is not None and len(fmt) != want:
            _fail(findings, ENGINE, 1,
                  f"engine dispatch call format '{fmt}' passes "
                  f"{len(fmt)} args but NativeBridge._dispatch takes "
                  f"{want}")
    demux_fmts = set(cppscan.callfunction_formats(eng, "d->callback"))
    want = _public_def_arity(tree, CLIENT_LANE,
                             ["ClientLane", "_on_loop_burst"])
    if want is None:
        _fail(findings, CLIENT_LANE, 1,
              "ClientLane._on_loop_burst (the demux's burst callback) "
              "not found")
    for fmt in demux_fmts:
        if want is not None and len(fmt) != want:
            _fail(findings, ENGINE, 1,
                  f"client demux callback format '{fmt}' passes "
                  f"{len(fmt)} args but ClientLane._on_loop_burst takes "
                  f"{want}")


def check_contracts(tree: Tree) -> List[Finding]:
    findings: List[Finding] = []
    eng = tree.text(ENGINE)
    _check_reason_tables(tree, eng, findings)
    _check_tlv_registry(tree, eng, findings)
    _check_shim_arities(tree, eng, findings)
    return findings
