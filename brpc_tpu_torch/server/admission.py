"""The tenant key of ``brpc_tpu/server/admission.py``: one normalization
of the TLV-22 identity (``RpcMeta.tenant``) and the cap on distinct
tenants, so a tenant name means the same in the port's SLO tiers as in
the JAX package's admission plane.  Admission itself (limits, CoDel,
per-tenant quotas) waits for a later slice of the port."""

from __future__ import annotations

# cardinality bound for per-tenant tables: a client stamping a fresh
# tenant per request must not grow server memory without bound
_MAX_TENANTS = 256


def normalize_tenant(raw) -> str:
    """TLV bytes or a str -> the tenant key: anonymous traffic pools under
    '-', values are stripped and capped at 64 characters (a tenant id is
    a label, not a payload)."""
    if not raw:
        return "-"
    if isinstance(raw, (bytes, bytearray, memoryview)):
        raw = bytes(raw).decode("utf-8", "replace")
    raw = raw.strip()
    return raw[:64] if raw else "-"
