"""The port's closed reason enums, pinned as literals (the port's twin of
``tests/test_reason_pins.py``).

Every reason name the port can export -- its engine's fallback reasons,
the client lane's demux reasons, the kind-5 lane's reasons, the scatter
screening literals, the prefix-cache events and the serving step phases
-- is pinned here, so a rename, a removal or an addition fails this file
until it is acknowledged on both sides.  ``brpc_tpu_torch.tools.check``'s
enums analyzer requires every such name to appear in one of the port's
tests; this file anchors the names that have no behavioral test of their
own.  Each table is also held equal to the JAX package's, since both
engines export the same names.
"""

import ast
import os

import pytest

_ROOT = os.path.join(os.path.dirname(__file__), "..")

# engine server-lane fallback reasons: engine.cpp kFbNames and the
# bridge's FB_REASON_NAMES mirror, in order
ENGINE_FB_REASONS = (
    "rpc_dispatch_off", "rpc_meta_tag", "rpc_no_method",
    "rpc_att_over_cap", "rpc_large_frame", "rpc_trace_raw_lane",
    "rpc_shm_lane",
    "http_slim_off", "http_malformed_line", "http_version",
    "http_no_route", "http_expect", "http_upgrade", "http_connection",
    "http_transfer_encoding", "http_bad_header", "http_large_body",
    "http_chunk_stream", "http_lame_duck",
)

# client demux lane reasons: engine.cpp kCliFbNames
CLIENT_LANE_REASONS = (
    "cli_unknown_cid", "cli_meta_unparsed", "cli_meta_tags",
    "cli_stream_frame", "cli_unknown_magic",
)

# kind-5 streaming-lane fallback reasons: engine.cpp kStreamFbNames and
# stream_slim's STREAM_FB_NAMES mirror, in order
STREAM_FB_REASONS = (
    "stream_no_shim", "stream_non_inline", "stream_compressed",
    "stream_chunk_oversize", "stream_drain", "stream_unregistered",
)

# scatter_call screening reasons: the closed set of
# _scatter_fallback("...") literals in client/fast_call.py
SCATTER_REASONS = {
    "ineligible_cntl", "load_balancer", "device_attachment",
    "nonbytes_request", "auth_on_first", "oversized_request",
    "mixed_deadlines", "no_single_server", "connect_failed",
    "socket_busy", "repeated_remote",
}

PREFIX_CACHE_EVENTS = ("prefix_hit", "prefix_partial_hit", "prefix_miss",
                       "prefix_insert", "prefix_evict")

LM_STEP_PHASES = ("decode_round", "chunk_slice", "catchup_slice",
                  "spec_draft", "spec_verify", "prefix_lookup",
                  "page_alloc", "host_spill", "host_resume", "stream_emit")


def _read(*parts):
    with open(os.path.join(_ROOT, *parts), "r", encoding="utf-8",
              errors="replace") as f:
        return f.read()


def test_bridge_mirror_matches_pins():
    from brpc_tpu_torch.transport.native_bridge import FB_REASON_NAMES
    assert FB_REASON_NAMES == ENGINE_FB_REASONS


def test_client_lane_reasons_match_pins():
    from brpc_tpu_torch.transport.client_lane import REASONS
    assert REASONS == CLIENT_LANE_REASONS


def test_stream_lane_reasons_match_pins():
    from brpc_tpu_torch.server.stream_slim import STREAM_FB_NAMES
    assert STREAM_FB_NAMES == STREAM_FB_REASONS


@pytest.mark.parametrize("pkg", ["brpc_tpu_torch", "brpc_tpu"])
def test_engine_tables_match_pins(pkg):
    """Both engines' C++ name tables equal the pinned literals (a source
    scan: no toolchain needed)."""
    from brpc_tpu_torch.tools.check import cppscan
    text = _read(pkg, "native", "src", "engine.cpp")
    assert tuple(cppscan.parse_string_array(text, "kFbNames")) \
        == ENGINE_FB_REASONS
    assert tuple(cppscan.parse_string_array(text, "kCliFbNames")) \
        == CLIENT_LANE_REASONS
    assert tuple(cppscan.parse_string_array(text, "kStreamFbNames")) \
        == STREAM_FB_REASONS


@pytest.mark.parametrize("pkg", ["brpc_tpu_torch", "brpc_tpu"])
def test_scatter_screening_set_matches_pins(pkg):
    """The screening literals of each package's fast_call.py are exactly
    the pinned closed set."""
    mod = ast.parse(_read(pkg, "client", "fast_call.py"))
    found = set()
    for node in ast.walk(mod):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None)
            if name == "_scatter_fallback" and node.args \
                    and isinstance(node.args[0], ast.Constant):
                found.add(node.args[0].value)
    assert found == SCATTER_REASONS


def test_prefix_cache_events_and_step_phases_match_pins():
    from brpc_tpu_torch.kv.pages import PREFIX_CACHE_EVENTS as events
    from brpc_tpu_torch.models.lm_telemetry import LM_STEP_PHASES as phases
    assert events == PREFIX_CACHE_EVENTS
    assert phases == LM_STEP_PHASES


def test_engine_telemetry_counts_every_pinned_reason():
    """The built engine reports a fallback count under every pinned
    server-lane and kind-5 name, and nothing else (the engine builds with
    g++ here)."""
    from brpc_tpu_torch import native
    mod = native.load()
    if mod is None:
        pytest.fail("the native engine did not build")
    eng = mod.Engine(lambda *a: None, loops=1, external_loops=True)
    try:
        assert set(eng.telemetry()["fallbacks"]) \
            == set(ENGINE_FB_REASONS) | set(STREAM_FB_REASONS)
    finally:
        eng.stop()
