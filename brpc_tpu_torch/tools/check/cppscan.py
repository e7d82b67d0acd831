"""Clang-free C++ scanning for ``native/src/engine.cpp``.

The engine is one hand-written translation unit with a deliberately
regular style (closed ``enum X : int { ... }`` bodies, ``static const
char* kNames[] = {...}`` mirrors, ``PyObject_CallFunction*`` shim
entries), so regex + balanced-paren extraction is enough to read the
contracts out of it — no clang, no compile step, runs in milliseconds
as a tier-1 test.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

_LINE_COMMENT = re.compile(r"//[^\n]*")
_BLOCK_COMMENT = re.compile(r"/\*.*?\*/", re.S)


def strip_comments(text: str) -> str:
    # newline-preserving: line numbers computed on the stripped text
    # still point into the original file
    text = _BLOCK_COMMENT.sub(lambda m: "\n" * m.group(0).count("\n"),
                              text)
    return _LINE_COMMENT.sub("", text)


def parse_enum(text: str, name: str) -> Optional[List[str]]:
    """Member identifiers of ``enum <name> : int { ... }`` in
    declaration order (values/sentinels included — callers drop the
    trailing ``*_REASONS``/``k*`` counter if present)."""
    m = re.search(r"enum\s+%s\s*:\s*int\s*\{" % re.escape(name), text)
    if m is None:
        return None
    body = text[m.end():]
    end = body.find("};")
    if end < 0:
        return None
    body = strip_comments(body[:end])
    members = []
    for item in body.split(","):
        item = item.strip()
        if not item:
            continue
        ident = item.split("=")[0].strip()
        if re.fullmatch(r"[A-Za-z_]\w*", ident):
            members.append(ident)
    return members


def parse_string_array(text: str, name: str) -> Optional[List[str]]:
    """String literals of ``const char* <name>[...] = { "...", ... };``."""
    m = re.search(r"%s\s*\[[^\]]*\]\s*=\s*\{" % re.escape(name), text)
    if m is None:
        return None
    body = text[m.end():]
    end = body.find("};")
    if end < 0:
        return None
    return re.findall(r'"([^"]*)"', strip_comments(body[:end]))


def _balanced(text: str, open_idx: int) -> str:
    """Text of the balanced paren group starting at ``open_idx`` ('(')."""
    depth = 0
    for i in range(open_idx, len(text)):
        c = text[i]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                return text[open_idx + 1:i]
    return text[open_idx + 1:]


def _split_args(argtext: str) -> List[str]:
    """Top-level comma split of a C call's argument text."""
    out, depth, cur = [], 0, []
    for c in argtext:
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        if c == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(c)
    tail = "".join(cur).strip()
    if tail:
        out.append(tail)
    return out


def call_sites(text: str, fn: str, first_arg: str) -> List[Tuple[int, List[str]]]:
    """Every ``fn(first_arg, ...)`` call: (offset, arg list).  The arg
    list excludes ``first_arg`` itself and a trailing ``nullptr``
    varargs sentinel."""
    clean = strip_comments(text)
    out = []
    for m in re.finditer(re.escape(fn) + r"\s*\(", clean):
        args = _split_args(_balanced(clean, m.end() - 1))
        if not args or args[0].replace(" ", "") != first_arg.replace(" ", ""):
            continue
        rest = args[1:]
        if rest and rest[-1] == "nullptr":
            rest = rest[:-1]
        out.append((m.start(), rest))
    return out


def callfunction_formats(text: str, target: str) -> List[str]:
    """Format strings of every ``PyObject_CallFunction(<target>, "fmt",
    ...)`` site (the arity contract of the format-driven entries)."""
    clean = strip_comments(text)
    out = []
    for m in re.finditer(r"PyObject_CallFunction\s*\(", clean):
        args = _split_args(_balanced(clean, m.end() - 1))
        if len(args) < 2:
            continue
        if args[0].replace(" ", "") != target.replace(" ", ""):
            continue
        fm = re.fullmatch(r'"([^"]*)"', args[1])
        if fm:
            out.append(fm.group(1))
    return out


def scan_case_tags(text: str, func_name: str) -> Dict[int, Optional[int]]:
    """TLV ``case N:`` labels inside one function body, mapped to the
    fixed length the engine enforces there (``if (ln != K) return``) or
    None for variable-length fields."""
    m = re.search(r"\b%s\s*\(" % re.escape(func_name), text)
    if m is None:
        return {}
    # function body: first '{' after the signature, balanced to close
    start = text.find("{", m.end())
    depth = 0
    end = start
    for i in range(start, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                end = i
                break
    body = strip_comments(text[start:end])
    tags: Dict[int, Optional[int]] = {}
    # fallthrough case groups share one handler: collect runs
    for m2 in re.finditer(
            r"((?:case\s+\d+\s*:\s*)+)((?:(?!case\s+\d+\s*:|default\s*:).)*)",
            body, re.S):
        labels = [int(x) for x in re.findall(r"case\s+(\d+)\s*:",
                                             m2.group(1))]
        handler = m2.group(2)
        lm = re.search(r"ln\s*!=\s*(\d+)", handler)
        need = int(lm.group(1)) if lm else None
        for t in labels:
            tags[t] = need
    return tags


def literal_tag_checks(text: str) -> List[int]:
    """Every ``tag == N`` / ``tag != N`` literal comparison in the file
    — the ad-hoc TLV walks (client demux meta scan, plain-response
    classification) reference tags this way instead of via case labels."""
    clean = strip_comments(text)
    return sorted({int(n) for n in
                   re.findall(r"\btag\s*[!=]=\s*(\d+)", clean)})


def used_enum_tokens(text: str, prefixes: Tuple[str, ...]) -> Dict[str, int]:
    """Every ``FB_*``-style identifier used anywhere in the file →
    first line number.  Compared against the declared enum bodies to
    catch a counter bumped under a member that was never declared (or
    was deleted while call sites remained)."""
    out: Dict[str, int] = {}
    for i, line in enumerate(strip_comments(text).splitlines(), 1):
        for m in re.finditer(r"\b(%s)[A-Z0-9_]*\b"
                             % "|".join(re.escape(p) for p in prefixes),
                             line):
            tok = m.group(0)
            out.setdefault(tok, i)
    return out
