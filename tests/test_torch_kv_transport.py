"""The port's KV transfer plane against the JAX package's, on the CPU: the
export registry (``kv/pages.py``'s ``KvPageStore``), the transport's wire
(``kv/transport.py``: the manifest, the probe answer, the copy lane's
pages) and the model's page list (``kv_page_specs``,
``export_decode_cache``, ``decode_cache_from_pages``).

- the closed enums equal the JAX package's, and an unnamed reason raises;
- the manifest and the probe answer are the same bytes both ways;
- the store fails loudly (double free, stale generation, second import,
  size mismatch), sweeps a dead owner's pages (also from a closing port
  ``Socket``), leaks nothing over 1000 cycles, and ``drain_settle``
  reports what is left at its deadline;
- copy-lane pages cross between the packages bit-exact, both ways;
- the shm lane stages each page once into the port's ring, demotes under
  ``kv_page_over_slot``, ``kv_ring_exhausted`` and (no ring)
  ``kv_shm_unavailable``, settles every slot, and its pages cross between
  the packages bit-exact both ways (each resolving the other's ring);
- ``model_fingerprint`` is the JAX package's string.

Params: the JAX ``init_params(PRNGKey(0))`` tree through numpy into
``params_from_numpy``.
"""

import functools
import socket
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.kv import pages as jpages
from brpc_tpu.kv import transport as jtr
from brpc_tpu.models import lm_service as jsvc
from brpc_tpu.models import transformer_lm as jlm
from brpc_tpu.transport import shm_ring as jshm
from brpc_tpu_torch.ici.fabric import in_process_fabric, local_domain_id
from brpc_tpu_torch.kv import pages as tpages
from brpc_tpu_torch.kv import transport as ttr
from brpc_tpu_torch.models import lm_service as tsvc
from brpc_tpu_torch.butil.flags import get_flag, set_flag
from brpc_tpu_torch.models import transformer_lm as tlm
from brpc_tpu_torch.transport import shm_ring as tshm
from brpc_tpu_torch.transport.socket import Socket
from brpc_tpu_torch.utils.convert import params_from_numpy

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=32, remat=False)


_SHM_FLAGS = ("rpc_shm_slot_bytes", "rpc_shm_slots")


@pytest.fixture()
def needs_shm():
    """Skip where this host can make no shm ring (decided per test, not
    at import)."""
    if not tshm.shm_supported():
        pytest.skip("no tmpfs/mmap shm ring here")


@pytest.fixture(autouse=True)
def _fresh_kv():
    saved = {k: get_flag(k) for k in _SHM_FLAGS}
    tpages._reset_for_tests()
    ttr._reset_for_tests()
    tshm._reset_for_tests()
    yield
    for k, v in saved.items():
        assert set_flag(k, v)
    tpages._reset_for_tests()
    ttr._reset_for_tests()
    tshm._reset_for_tests()


@pytest.fixture(scope="module")
def params():
    jp = jlm.init_params(jax.random.PRNGKey(0), jlm.LMConfig(**CFG))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def prompt():
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8,), 0,
                                         CFG["vocab"], jnp.int32))


# -- enums and the wire

def test_enums_match_jax():
    assert ttr.KV_FALLBACK_REASONS == jtr.KV_FALLBACK_REASONS
    assert ttr.KV_CLOSE_REASONS == jtr.KV_CLOSE_REASONS
    assert set(ttr.kv_fallback_counters()) == set(jtr.KV_FALLBACK_REASONS)
    assert set(ttr.kv_stats()) == set(jtr.kv_stats())
    assert (ttr.LANE_ICI, ttr.LANE_SHM, ttr.LANE_COPY) \
        == (jtr.LANE_ICI, jtr.LANE_SHM, jtr.LANE_COPY)
    assert tpages.DESC_BYTES == jpages.DESC_BYTES == 16
    # the port's loud convention: ValueError where the JAX package asserts
    with pytest.raises(ValueError, match="unnamed kv fallback"):
        ttr.count_fallback("kv_some_new_reason")
    ttr.count_fallback("kv_disabled")
    assert ttr.kv_fallback_counters()["kv_disabled"] == 1


@pytest.mark.parametrize("descs", [
    [], [b"\x01" * 16, b"\x02" * 16], [struct.pack("<I", 4096)] * 4],
    ids=["none", "ici", "copy"])
def test_manifest_bytes_match_jax(descs):
    fields = (2, 0x1234_5678_9abc, b"A" * 8, 17, 63, 9, b"64:32:4:2:32:1:0",
              descs)
    wire = ttr.encode_manifest(ttr.SessionManifest(*fields))
    assert wire == jtr.encode_manifest(jtr.SessionManifest(*fields))
    for got in (ttr.decode_manifest(wire), jtr.decode_manifest(wire)):
        assert (got.lane, got.stream_id, got.auth, got.ctx_len,
                got.last_token, got.max_new, got.model_fp, got.descs) \
            == fields
    for decode, err in ((ttr.decode_manifest, tpages.KvPageError),
                        (jtr.decode_manifest, jpages.KvPageError)):
        with pytest.raises(err, match="trailing"):
            decode(wire + b"\0")
        with pytest.raises(err, match="magic"):
            decode(b"XXXX" + wire[4:])


def test_stream_auth_is_per_package():
    """Each package keys the adoption tag on its own process secret, so a
    tag never verifies across them: a handoff between the packages ends
    at the auth check (``kv_stream_not_local``)."""
    assert len(ttr.stream_auth(7)) == 8
    assert ttr.stream_auth(7) == ttr.stream_auth(7)
    assert ttr.stream_auth(7) != ttr.stream_auth(8)
    assert ttr.stream_auth(7) != jtr.stream_auth(7)


def test_probe_answer_parses_both_ways():
    ours = ttr.encode_probe_response()
    for decode in (ttr.decode_probe_response, jtr.decode_probe_response):
        dom, host, shm = decode(ours)
        assert dom == local_domain_id()
        assert in_process_fabric().can_reach(dom)
        assert host == ttr._host_token() == jshm._host_token()
        assert shm is tshm.lane_enabled()         # the port's ring
    assert ttr.decode_probe_report(ours) is None
    assert jtr.decode_probe_report(ours) is None
    report = {"slots_free": 3, "tier": "decode"}
    theirs = jtr.encode_probe_response(report=report)
    assert ttr.decode_probe_response(theirs) \
        == jtr.decode_probe_response(theirs)
    assert ttr.decode_probe_report(theirs) == report
    assert ttr.decode_probe_response(theirs[:-3][:6]) is None
    assert ttr.decode_probe_response(b"nope") is None
    assert ttr.decode_probe_report(theirs[:-1]) is None


# -- the export registry

def test_store_fails_loudly():
    """Double free, stale generation (a recycled page id), second import
    and size mismatch all raise; a live page imports as itself."""
    store = tpages.process_kv_store()
    page = torch.ones(8)
    h = store.export_array(page, 32)
    store.release(h.page_id, h.gen)
    with pytest.raises(tpages.KvPageError, match="double/stale"):
        store.release(h.page_id, h.gen)
    with pytest.raises(tpages.KvPageError, match="stale"):
        store.import_page(h.page_id, h.gen, 32)
    h2 = store.export_array(page, 32)
    assert h2.page_id == h.page_id and h2.gen != h.gen
    with pytest.raises(tpages.KvPageError, match="stale"):
        store.import_page(h.page_id, h.gen, 32)
    with pytest.raises(tpages.KvPageError, match="size mismatch"):
        store.import_page(h2.page_id, h2.gen, 64)
    assert store.import_page(h2.page_id, h2.gen, 32) is page
    with pytest.raises(tpages.KvPageError, match="already imported"):
        store.import_page(h2.page_id, h2.gen, 32)
    with pytest.raises(tpages.KvPageError, match="malformed"):
        tpages.decode_desc(h2.describe()[:-1])
    store.release(h2.page_id, h2.gen)
    assert store.outstanding() == 0
    assert tpages.decode_desc(h2.describe()) == (h2.page_id, h2.gen, 32)
    assert h2.describe() == jpages.KvPageHandle(h2.page_id, h2.gen,
                                                32).describe()


def test_export_table_is_bounded_by_the_flag():
    from brpc_tpu_torch.butil.flags import get_flag, set_flag
    old = get_flag("kv_pages")
    assert set_flag("kv_pages", 2)
    tpages._reset_for_tests()
    try:
        store = tpages.process_kv_store()
        hs = [store.export_array(torch.ones(1), 4) for _ in range(2)]
        assert store.export_array(torch.ones(1), 4) is None
        store.settle_handles(hs)
        assert store.outstanding() == 0
    finally:
        set_flag("kv_pages", old)


def test_release_owner_and_socket_close_sweep():
    """A dead owner's pages are reclaimed (its descriptors then refuse to
    import), another owner's stay; a port ``Socket`` sweeps the pages
    exported for it when it closes."""
    store = tpages.process_kv_store()
    fabric = in_process_fabric()
    base = fabric.live_descriptors
    page = torch.ones(16)
    owner = ("kv", 424242)
    handles = [store.export_array(page, 64, owner=owner) for _ in range(3)]
    other = store.export_array(page, 64, owner=("kv", 7))
    assert tpages.outstanding_pages() == 4
    tpages.on_socket_closed(owner)
    assert tpages.outstanding_pages() == 1
    for h in handles:
        with pytest.raises(tpages.KvPageError):
            store.import_page(h.page_id, h.gen, 64)
    store.release(other.page_id, other.gen)
    assert tpages.outstanding_pages() == 0
    assert fabric.live_descriptors == base

    a, b = socket.socketpair()
    try:
        sock = Socket(a, remote_side=None)
        hs = [store.export_array(page, 64, owner=("kv", sock.id))
              for _ in range(2)]
        keep = store.export_array(page, 64, owner=("kv", sock.id + 10**6))
        assert store.outstanding() == 3
        sock.close()
        assert store.outstanding() == 1
        assert store.stats()["swept"] == 3 + len(hs)
        store.release(keep.page_id, keep.gen)
    finally:
        b.close()
    assert fabric.live_descriptors == base


def test_leak_pin_after_1k_cycles():
    """1000 export, describe, import (half the pages) and release cycles
    leave the table and the fabric as they were."""
    store = tpages.process_kv_store()
    fabric = in_process_fabric()
    base = fabric.live_descriptors
    page = torch.arange(1024, dtype=torch.float32)
    for i in range(1000):
        handles = [store.export_array(page, 4096, owner=("kv", i))
                   for _ in range(4)]
        assert all(h is not None for h in handles)
        for h in handles[:2]:
            pid, gen, n = tpages.decode_desc(h.describe())
            assert store.import_page(pid, gen, n) is page
        store.settle_handles(handles)
    assert store.outstanding() == 0
    assert fabric.live_descriptors == base
    st = store.stats()
    assert st["exported"] == 4000 and st["imported"] == 2000


def test_drain_settle():
    """0 when everything settled; at the deadline, the count still out
    (with no hang); a settle landing inside the grace is seen."""
    assert tpages.drain_settle(time.monotonic()) == 0
    store = tpages.process_kv_store()
    h = store.export_array(torch.ones(4), 16)
    t0 = time.monotonic()
    assert tpages.drain_settle(time.monotonic() + 0.1) == 1
    assert time.monotonic() - t0 < 5.0
    timer = threading.Timer(0.05, store.release, (h.page_id, h.gen))
    timer.start()
    try:
        assert tpages.drain_settle(time.monotonic() + 30.0) == 0
    finally:
        timer.join(30.0)
    assert not timer.is_alive()
    # a host-tier spill in flight counts too, and is aborted at the deadline
    pool = tpages.HostPagePool(1, 16)
    assert pool.begin_spill()
    assert tpages.drain_settle(time.monotonic() + 0.05) == 1
    assert pool.abort_reason() == "kv_spill_drain_aborted"
    pool.end_spill()


# -- the copy lane and the page list

def _copy_manifest(tr, descs, ctx_len):
    return tr.SessionManifest(tr.LANE_COPY, 1, b"\0" * 8, ctx_len, 0, 4,
                              b"fp", descs)


def test_copy_lane_import_pages_checks_and_lands_exactly():
    cfg = tlm.LMConfig(**CFG)
    specs = tlm.kv_page_specs(cfg)
    rng = np.random.default_rng(0)
    pages = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             for shape, _, _ in specs]
    lane, descs, att, leases, reason = ttr.KvTransport()._prepare_pages(
        ttr.LANE_COPY, [(p, p.numel() * 4) for p in pages], None)
    assert (lane, leases, reason) == (ttr.LANE_COPY, [], None)
    assert len(att) == sum(n for _, _, n in specs)
    man = _copy_manifest(ttr, descs, 7)
    got = ttr.import_pages(man, att, specs, "cpu")
    for a, b in zip(got, pages):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert torch.equal(a, b)
    with pytest.raises(tpages.KvPageError, match="page count"):
        ttr.import_pages(_copy_manifest(ttr, descs[:-1], 7), att, specs,
                         "cpu")
    with pytest.raises(tpages.KvPageError, match="bounds"):
        ttr.import_pages(man, att[:-1], specs, "cpu")
    bad = list(descs)
    bad[0] = struct.pack("<I", specs[0][2] - 4)
    with pytest.raises(tpages.KvPageError, match="bounds"):
        ttr.import_pages(_copy_manifest(ttr, bad, 7), att, specs, "cpu")
    with pytest.raises(tpages.KvPageError, match="trailing"):
        ttr.import_pages(man, att + b"\0\0\0\0", specs, "cpu")
    # an shm manifest holding copy-lane descriptors, or naming a ring this
    # process never mapped, fails loudly
    shm = ttr.SessionManifest(ttr.LANE_SHM, 1, b"\0" * 8, 7, 0, 4, b"fp",
                              descs)
    with pytest.raises(tpages.KvPageError, match="malformed shm"):
        ttr.import_pages(shm, None, specs, "cpu")
    shm.descs = [tshm.encode_desc(b"\xde" * 8, 0, 0, n) for _, _, n in specs]
    with pytest.raises(tpages.KvPageError, match="unresolvable shm"):
        ttr.import_pages(shm, None, specs, "cpu")


def test_shm_lane_demotes_to_copy(monkeypatch):
    """A handoff pinned to the shm lane stages each page into this
    process's ring (one copy) under a slot lease, and its descriptor
    resolves to the page's bytes; it demotes to the copy lane under
    ``kv_shm_unavailable`` only where no ring can be made here."""
    page = torch.arange(4, dtype=torch.float32)
    tr = ttr.KvTransport()
    if tshm.shm_supported():
        lane, descs, att, leases, reason = tr._prepare_pages(
            ttr.LANE_SHM, [(page, 16)], None)
        assert (lane, reason, att) == (ttr.LANE_SHM, None, None)
        rid, _slot, off, n = tshm.decode_desc(descs[0])
        assert bytes(tshm.resolve(rid, off, n)) == page.numpy().tobytes()
        assert [k for k, _ in leases] == ["slot"]
        assert tshm.outstanding_tx_slots() == 1
        tr._settle(leases)
        assert tshm.outstanding_tx_slots() == 0
    monkeypatch.setattr(tshm, "process_tx_ring", lambda: None)
    lane, descs, att, leases, reason = tr._prepare_pages(
        ttr.LANE_SHM, [(page, 16)], None)
    assert (lane, reason, leases) == (ttr.LANE_COPY, "kv_shm_unavailable", [])
    assert att == page.numpy().tobytes()
    assert descs == [struct.pack("<I", 16)]


def _pages(n, numel=1024):
    rng = np.random.default_rng(n)
    return [(torch.from_numpy(rng.standard_normal(numel).astype(np.float32)),
             numel * 4) for _ in range(n)]


@pytest.mark.parametrize("flag,value,reason", [
    ("rpc_shm_slot_bytes", 4096, "kv_page_over_slot"),
    ("rpc_shm_slots", 2, "kv_ring_exhausted")])
def test_shm_lane_demotions_are_named(needs_shm, flag, value, reason):
    """Pages larger than a slot, or more pages than free slots: the
    handoff demotes to the copy lane under its reason, and the slots
    staged before the demotion are settled."""
    assert set_flag(flag, value)
    pages = _pages(4, numel=2048)                  # 8 KiB pages
    lane, descs, att, leases, why = ttr.KvTransport()._prepare_pages(
        ttr.LANE_SHM, pages, None)
    assert (lane, why, leases) == (ttr.LANE_COPY, reason, [])
    assert att == b"".join(p.numpy().tobytes() for p, _ in pages)
    assert tshm.outstanding_tx_slots() == 0


def test_shm_lane_pages_cross_packages_bit_exact(needs_shm, params, prompt):
    """A port prefill's pages, staged by the port's shm lane, are read by
    the JAX package's ``shm_ring.resolve`` (its import, after mapping the
    port's ring) bit-equal to the port's tensors; a JAX prefill's pages,
    staged in the JAX ring, land in the port bit-equal to the JAX
    arrays."""
    jp, tp = params
    jcfg, tcfg = jlm.LMConfig(**CFG), tlm.LMConfig(**CFG)
    jshm._reset_for_tests()
    try:
        tcache, tctx = _port_prefill(tp, prompt)
        tpg = tlm.export_decode_cache(tcfg, tcache)
        lane, descs, _att, leases, _ = ttr.KvTransport()._prepare_pages(
            ttr.LANE_SHM, tpg, None)
        assert lane == ttr.LANE_SHM
        assert jshm.attach_spec(tshm.process_tx_ring().spec()) \
            == tshm.process_tx_ring().ring_id
        man = ttr.SessionManifest(ttr.LANE_SHM, 1, b"\0" * 8, tctx, 0, 4,
                                  b"fp", descs)
        back = jtr.import_pages(jtr.decode_manifest(ttr.encode_manifest(man)),
                                None, jlm.kv_page_specs(jcfg))
        for arr, (t, _n) in zip(back, tpg):
            assert np.array_equal(np.asarray(arr), t.numpy())
        ttr.KvTransport._settle(leases)
        assert tshm.outstanding_tx_slots() == 0

        jcache, jctx = _jax_prefill(jp, prompt)
        jpg = jlm.export_decode_cache(jcfg, jcache)
        lane, descs, _att, jleases, _ = jtr.KvTransport()._prepare_pages(
            jtr.LANE_SHM, jpg, None)
        assert lane == jtr.LANE_SHM
        assert tshm.attach_spec(jshm.process_tx_ring().spec()) \
            == jshm.process_tx_ring().ring_id
        man = jtr.SessionManifest(jtr.LANE_SHM, 1, b"\0" * 8, jctx, 0, 4,
                                  b"fp", descs)
        got = ttr.import_pages(ttr.decode_manifest(jtr.encode_manifest(man)),
                               None, tlm.kv_page_specs(tcfg), "cpu")
        for t, (arr, _n) in zip(got, jpg):
            assert np.array_equal(t.numpy(), np.asarray(arr))
        jtr.KvTransport._settle(jleases)
    finally:
        jshm._reset_for_tests()


def _jax_prefill(jp, prompt):
    cfg = jlm.LMConfig(**CFG)
    pre = jax.jit(functools.partial(jlm.make_decode(cfg)[0], jp))
    return jsvc.bucketed_prefill(pre, cfg, prompt)


def _port_prefill(tp, prompt):
    cfg = tlm.LMConfig(**CFG)
    pre = functools.partial(tlm.make_decode(cfg, device="cpu")[0], tp)
    with torch.inference_mode():
        return tsvc.bucketed_prefill(pre, cfg, prompt)


def test_copy_lane_pages_cross_packages_bit_exact(params, prompt):
    """A JAX prefill's pages, staged by the JAX copy lane, land in the port
    bit-equal to the JAX arrays; a port prefill's pages, staged by the
    port's copy lane, land in the JAX package bit-equal to the port's
    tensors.  The manifest crosses too."""
    jp, tp = params
    jcfg, tcfg = jlm.LMConfig(**CFG), tlm.LMConfig(**CFG)

    jcache, jctx = _jax_prefill(jp, prompt)
    jpg = jlm.export_decode_cache(jcfg, jcache)
    lane, descs, att, _leases, _ = jtr.KvTransport()._prepare_pages(
        jtr.LANE_COPY, jpg, None)
    wire = jtr.encode_manifest(_copy_manifest(jtr, descs, jctx))
    got = ttr.import_pages(ttr.decode_manifest(wire), att,
                           tlm.kv_page_specs(tcfg), "cpu")
    assert len(got) == len(jpg) == 2 * CFG["depth"]
    for t, (arr, nbytes) in zip(got, jpg):
        assert t.numel() * 4 == nbytes
        assert np.array_equal(t.numpy(), np.asarray(arr))

    tcache, tctx = _port_prefill(tp, prompt)
    assert tctx == jctx
    tpg = tlm.export_decode_cache(tcfg, tcache)
    lane, descs, att, _leases, _ = ttr.KvTransport()._prepare_pages(
        ttr.LANE_COPY, tpg, None)
    wire = ttr.encode_manifest(_copy_manifest(ttr, descs, tctx))
    back = jtr.import_pages(jtr.decode_manifest(wire), att,
                            jlm.kv_page_specs(jcfg))
    for arr, (t, _n) in zip(back, tpg):
        assert np.array_equal(np.asarray(arr), t.numpy())
    # the two prefills agree as the frameworks' arithmetic does
    for (t, _), (arr, _) in zip(tpg, jpg):
        np.testing.assert_allclose(t.numpy(), np.asarray(arr), rtol=0,
                                   atol=2e-5)


def test_page_list_matches_jax(params, prompt):
    """``kv_page_specs`` equals the JAX list; ``export_decode_cache`` hands
    out the live cache tensors (k then v per layer, whole ``max_seq``
    rows, nothing copied) with the JAX sizes; ``decode_cache_from_pages``
    rebuilds the dict from them."""
    jp, tp = params
    jcfg, tcfg = jlm.LMConfig(**CFG), tlm.LMConfig(**CFG)
    assert tlm.kv_page_specs(tcfg) == jlm.kv_page_specs(jcfg)
    assert tlm.kv_page_specs(tcfg, batch=2) == jlm.kv_page_specs(jcfg, 2)
    tcache, _ = _port_prefill(tp, prompt)
    pages = tlm.export_decode_cache(tcfg, tcache)
    jpg = jlm.export_decode_cache(jcfg, _jax_prefill(jp, prompt)[0])
    assert [n for _, n in pages] == [n for _, n in jpg]
    keys = [f"{kind}{i}" for i in range(CFG["depth"]) for kind in "kv"]
    for (t, _), key in zip(pages, keys):
        assert t is tcache[key]
    rebuilt = tlm.decode_cache_from_pages(tcfg, [t for t, _ in pages])
    assert all(rebuilt[key] is tcache[key] for key in keys)
    with pytest.raises(ValueError, match="expected 4 pages"):
        tlm.decode_cache_from_pages(tcfg, [t for t, _ in pages][:3])
    with pytest.raises(NotImplementedError):
        tlm.kv_page_specs(tlm.LMConfig(**{**CFG, "scan_layers": True}))


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_model_fingerprint_matches_jax(params, quantize):
    jp, tp = params
    ours = tsvc.LMService(cfg=tlm.LMConfig(**CFG), params=tp, device="cpu",
                          quantize=quantize).model_fingerprint()
    theirs = jsvc.LMService(cfg=jlm.LMConfig(**CFG), params=jp,
                            quantize=quantize).model_fingerprint()
    assert ours == theirs
    assert ours.endswith(b":1" if quantize else b":0")
