"""TransformerLM in eager PyTorch: serving and training.

Counterpart of ``brpc_tpu/models/transformer_lm.py``: ``LMConfig``,
``init_params``, the rmsnorm/rope helpers, ``make_decode`` (prefill +
single-token decode step over an f32 ``max_seq`` KV cache),
``empty_cache`` and the generators for serving; the cache's page list
for the disaggregated handoff (``kv_page_specs``,
``export_decode_cache``, ``decode_cache_from_pages``); the continuous
batcher's programs, contiguous (``make_batch_decode``) and paged
(``make_paged_batch_decode``, ``make_paged_io``,
``make_paged_spec_verify``); ``make_forward`` and
``make_train_step`` (plain SGD, gradient accumulation, remat) for
training, on one device or one rank of a mesh (dp x tp (+ep for MoE),
and sequence parallelism through ring attention: ``param_specs``,
``batch_specs``, ``mesh=``, ``sp_axis=``).  The arithmetic follows the
JAX code: every weight product goes through ``qmatmul`` (bf16 in, f32
out, so autograd runs the backward products in bf16 as JAX does), the
MLP uses the tanh form of gelu
(``jax.nn.gelu``'s default), rmsnorm puts eps 1e-6 inside the square
root, rope splits each head in halves, and attention goes through
``ops.flash_attention.attention`` — the hand-written CUDA kernels, forward
and backward, on the card when ``use_flash`` is set.

MoE blocks (``moe_experts > 0``) swap each block's MLP for
:mod:`.moe`'s FFN in every program, routing each row of the program's
``(rows, tokens, dim)`` activations on its own, as the JAX package does.
``scan_layers`` configs keep their weights stacked under
``params["blocks"]`` (leading depth axis) and their decode caches as
``(depth, b, max_seq, heads, hd)`` tensors; the JAX package scans one
compiled layer over them, the port runs the same layer in a Python loop
over per-layer views, so a stacked tree gives the tokens of its unrolled
twin bit for bit.  What the JAX package refuses, the port refuses with
its words: ``scan_layers`` in the batch, paged and spec programs and the
KV page list, and ``scan_layers`` with MoE in ``make_decode``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import attention
from ..ops.quant import QuantTensor, qmatmul
from ..parallel.mesh_transport import (_all_reduce, all_gather,
                                       all_gather_sum_grad, mesh_axis, psum,
                                       pvary)
from ..parallel.ring_attention import make_ring_attention
from ..utils.device import resolve_device
from . import moe


class LMConfig:
    """Same fields and defaults as the JAX package's ``LMConfig``."""

    def __init__(self, vocab: int = 256, dim: int = 64, heads: int = 4,
                 depth: int = 2, mlp_mult: int = 4, max_seq: int = 256,
                 causal: bool = True, remat: bool = True,
                 lr: float = 0.05, moe_experts: int = 0,
                 moe_capacity: float = 2.0, moe_aux_weight: float = 0.01,
                 moe_top_k: int = 1, use_flash: bool = False,
                 scan_layers: bool = False, attn_impl: str = "auto"):
        if dim % heads != 0:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        if (dim // heads) % 2 != 0:
            raise ValueError("head dim must be even for RoPE")
        self.vocab = vocab
        self.dim = dim
        self.heads = heads
        self.depth = depth
        self.mlp_mult = mlp_mult
        self.max_seq = max_seq
        self.causal = causal
        self.remat = remat
        self.lr = lr
        self.moe_experts = moe_experts
        self.moe_capacity = moe_capacity
        self.moe_aux_weight = moe_aux_weight
        self.moe_top_k = moe_top_k
        self.use_flash = use_flash
        self.attn_impl = attn_impl
        self.scan_layers = scan_layers

    def moe_cfg(self) -> moe.MoEConfig:
        return moe.MoEConfig(dim=self.dim, hidden=self.dim * self.mlp_mult,
                             num_experts=self.moe_experts,
                             capacity_factor=self.moe_capacity,
                             aux_loss_weight=self.moe_aux_weight,
                             top_k=self.moe_top_k)


def _refuse_scan(cfg: LMConfig, what: str) -> None:
    if cfg.scan_layers:
        raise NotImplementedError(what)


def init_params(generator: torch.Generator, cfg: LMConfig,
                device="cuda") -> Dict[str, Any]:
    """Random parameters in the JAX package's layout and scales (normal
    draws times 1/sqrt(dim), ``w2`` further over ``mlp_mult``, unit norm
    gains; an MoE block's ``moe`` subtree from :func:`.moe.init_params`),
    drawn from ``generator`` on ``device`` — the generator must live on
    that device.  ``scan_layers`` stacks the blocks under ``"blocks"``
    along a leading depth axis.  The values differ from the JAX package's
    ``PRNGKey`` draws; parity tests carry the JAX params over with
    :func:`brpc_tpu_torch.utils.convert.params_from_numpy`."""
    dev = resolve_device(device)
    scale = 1.0 / math.sqrt(cfg.dim)

    def normal(*shape, mult=scale):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * mult

    params: Dict[str, Any] = {
        "embed": normal(cfg.vocab, cfg.dim),
        "unembed": normal(cfg.dim, cfg.vocab),
    }
    h = cfg.dim * cfg.mlp_mult
    for i in range(cfg.depth):
        blk = {
            "wqkv": normal(cfg.dim, 3 * cfg.dim),
            "wo": normal(cfg.dim, cfg.dim),
            "ln1": torch.ones(cfg.dim, device=dev),
            "ln2": torch.ones(cfg.dim, device=dev),
        }
        if cfg.moe_experts > 0:
            blk["moe"] = moe.init_params(generator, cfg.moe_cfg(), dev)
        else:
            blk["w1"] = normal(cfg.dim, h)
            blk["w2"] = normal(h, cfg.dim, mult=scale / cfg.mlp_mult)
        params[f"blk{i}"] = blk
    if cfg.scan_layers:
        params["blocks"] = _stack([params.pop(f"blk{i}")
                                   for i in range(cfg.depth)])
    return params


def _stack(blocks: list) -> dict:
    """Per-layer trees -> one tree of stacked (depth, ...) tensors."""
    return {k: _stack([b[k] for b in blocks]) if isinstance(v, dict)
            else torch.stack([b[k] for b in blocks])
            for k, v in blocks[0].items()}


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree: views, no copies (a QuantTensor's
    slice is ``(q[i], s[i])``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _layer(v, i)
        elif isinstance(v, QuantTensor):
            out[k] = QuantTensor(v.q[i], v.s[i])
        else:
            out[k] = v[i]
    return out


def _blocks(cfg: LMConfig, params) -> list:
    """Every block's parameters in order, unrolled or stacked."""
    if cfg.scan_layers:
        return [_layer(params["blocks"], i) for i in range(cfg.depth)]
    return [params[f"blk{i}"] for i in range(cfg.depth)]


def _rmsnorm(x, g):
    return x * g / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)


def _freqs(head_dim: int, device) -> torch.Tensor:
    half = head_dim // 2
    return torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=device) / half)


def _rope_tables(seq: int, head_dim: int, device="cpu", offset: int = 0):
    """sin/cos tables for rotary embedding, shaped (1, s, 1, d/2), for
    positions ``offset`` .. ``offset + seq - 1``."""
    pos = torch.arange(offset, offset + seq, dtype=torch.float32,
                       device=device)[None, :, None, None]
    ang = pos * _freqs(head_dim, device)[None, None, None, :]
    return torch.sin(ang), torch.cos(ang)


def _rope(x, sin, cos):
    """Rotary position embedding on the two halves of each head."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _rope_at(x, pos: int, head_dim: int):
    """Rotary embedding for ONE position."""
    ang = (torch.tensor(float(pos), dtype=torch.float32, device=x.device)
           * _freqs(head_dim, x.device))[None, None, None, :]
    return _rope(x, torch.sin(ang), torch.cos(ang))


def _mlp(bp, h):
    """gelu MLP; ``up`` is bf16 when gelu sees it, as in the JAX block."""
    return qmatmul(F.gelu(qmatmul(h, bp["w1"]), approximate="tanh"),
                   bp["w2"])


def _ffn(cfg: LMConfig):
    """The block's feed-forward, ``(bp, h) -> (out, aux)``: the gelu MLP
    (aux None), or the MoE FFN routing each row of ``h`` (rows, tokens,
    dim) on its own — a decode step's slots, a chunk's whole padded
    slice, a verify's k + 1 candidates, a prefill's whole bucket."""
    if cfg.moe_experts > 0:
        mcfg = cfg.moe_cfg()
        return lambda bp, h: moe.forward_grouped(bp["moe"], h, mcfg)
    return lambda bp, h: (_mlp(bp, h), None)


def _qkv_heads(cfg: LMConfig, bp, h, sin, cos, heads: int = 0):
    """q, k (rope applied) and v, each (b, s, heads, head_dim) f32;
    ``heads`` those of ``bp["wqkv"]`` (a tp rank's share; all by
    default)."""
    b, s = h.shape[0], h.shape[1]
    heads = heads or cfg.heads
    hd = cfg.dim // cfg.heads
    q, k, v = qmatmul(h, bp["wqkv"]).split(heads * hd, dim=-1)
    shp = (b, s, heads, hd)
    q, k = (_rope(t.reshape(shp), sin, cos) for t in (q, k))
    return q, k, v.reshape(shp)


def make_decode(cfg: LMConfig, device="cuda"):
    """Returns ``(prefill, decode_step)``:

    - ``prefill(params, ids[b, s]) -> (cache, logits[b, vocab])`` runs the
      prompt, fills fresh f32 ``(b, max_seq, heads, hd)`` caches and
      returns the last position's logits;
    - ``decode_step(params, cache, token[b]) -> (cache, logits)`` writes
      the token's k/v at ``cache["len"]`` and attends over the prefix.
      The returned dict is new, but the cache tensors are updated IN
      PLACE (the JAX package donates them for the same effect): a caller
      that needs the old cache clones it first.

    ``scan_layers`` configs keep the caches stacked, ``cache["k"]`` and
    ``cache["v"]`` of shape ``(depth, b, max_seq, heads, hd)``; with MoE
    blocks they raise, as in the JAX package.
    """
    if cfg.scan_layers and cfg.moe_experts > 0:
        raise NotImplementedError(
            "scanned decode does not support MoE blocks — use "
            "scan_layers=False for MoE serving")
    dev = resolve_device(device)
    hd = cfg.dim // cfg.heads
    impl = "flash" if cfg.use_flash else cfg.attn_impl
    ffn = _ffn(cfg)

    def prefill_layer(bp, x, sin, cos, kc, vc):
        b, s = x.shape[0], x.shape[1]
        q, k, v = _qkv_heads(cfg, bp, _rmsnorm(x, bp["ln1"]), sin, cos)
        kc[:, :s] = k
        vc[:, :s] = v
        att = attention(q, k, v, causal=cfg.causal, impl=impl)
        x = x + qmatmul(att.reshape(b, s, cfg.dim), bp["wo"])
        return x + ffn(bp, _rmsnorm(x, bp["ln2"]))[0]

    def decode_layer(bp, x, kc, vc, pos: int):
        b = x.shape[0]
        h = _rmsnorm(x, bp["ln1"])
        q, k, v = qmatmul(h, bp["wqkv"]).split(cfg.dim, dim=-1)
        shp = (b, 1, cfg.heads, hd)
        q = _rope_at(q.reshape(shp), pos, hd)
        k = _rope_at(k.reshape(shp), pos, hd)
        kc[:, pos] = k[:, 0]
        vc[:, pos] = v.reshape(shp)[:, 0]
        s_mat = torch.einsum("bqhd,bkhd->bhqk", q, kc) / (hd ** 0.5)
        live = torch.arange(cfg.max_seq, device=dev) <= pos  # prefix + self
        s_mat = torch.where(live[None, None, None, :], s_mat, -1e30)
        p = torch.softmax(s_mat, dim=-1)
        att = torch.einsum("bhqk,bkhd->bqhd", p, vc)
        x = x + qmatmul(att.reshape(b, 1, cfg.dim), bp["wo"])
        return x + ffn(bp, _rmsnorm(x, bp["ln2"]))[0]

    def prefill(params, ids):
        ids = torch.as_tensor(ids, device=dev).long()
        b, s = ids.shape
        if s > cfg.max_seq:
            raise ValueError(f"seq {s} exceeds max_seq {cfg.max_seq}")
        x = params["embed"][ids]
        sin, cos = _rope_tables(s, hd, dev)
        cache = empty_cache(cfg, b, start_len=s, device=dev)
        for i, bp in enumerate(_blocks(cfg, params)):
            kc, vc = _layer_kv(cfg, cache, i)
            x = prefill_layer(bp, x, sin, cos, kc, vc)
        return cache, qmatmul(x[:, -1], params["unembed"])

    def decode_step(params, cache, token):
        cache = dict(cache)
        pos = int(cache["len"])
        token = torch.as_tensor(token, device=dev).long()
        x = params["embed"][token][:, None, :]       # (b, 1, d)
        for i, bp in enumerate(_blocks(cfg, params)):
            x = decode_layer(bp, x, *_layer_kv(cfg, cache, i), pos)
        cache["len"] = pos + 1
        return cache, qmatmul(x[:, 0], params["unembed"])

    return prefill, decode_step


def _layer_kv(cfg: LMConfig, cache, i: int):
    """Layer ``i``'s k and v cache tensors (views of the stacked ones
    under ``scan_layers``)."""
    if cfg.scan_layers:
        return cache["k"][i], cache["v"][i]
    return cache[f"k{i}"], cache[f"v{i}"]


def empty_cache(cfg: LMConfig, batch: int, start_len: int = 1,
                device="cuda"):
    """A fresh KV cache in the layout ``make_decode``'s steps expect:
    ``(batch, max_seq, heads, hd)`` f32 per layer, or for ``scan_layers``
    two stacked ``(depth, batch, max_seq, heads, hd)`` tensors."""
    dev = resolve_device(device)
    hd = cfg.dim // cfg.heads
    cache: Dict[str, Any] = {"len": int(start_len)}
    if cfg.scan_layers:
        shape = (cfg.depth, batch, cfg.max_seq, cfg.heads, hd)
        cache["k"] = torch.zeros(shape, dtype=torch.float32, device=dev)
        cache["v"] = torch.zeros(shape, dtype=torch.float32, device=dev)
        return cache
    for i in range(cfg.depth):
        for kind in ("k", "v"):
            cache[f"{kind}{i}"] = torch.zeros(
                (batch, cfg.max_seq, cfg.heads, hd), dtype=torch.float32,
                device=dev)
    return cache


def kv_page_specs(cfg: LMConfig, batch: int = 1):
    """Ordered ``(shape, dtype, nbytes)`` of a decode cache's transferable
    KV pages: k then v per layer, the order :func:`export_decode_cache`
    emits and the import side rebuilds from.  The layout is the model's
    (like :func:`empty_cache`'s); the wire carries sizes only, to check
    them."""
    _refuse_scan(cfg, "paged KV export supports unrolled layers only (the "
                      "continuous batcher's serving shape)")
    hd = cfg.dim // cfg.heads
    shape = (batch, cfg.max_seq, cfg.heads, hd)
    nbytes = batch * cfg.max_seq * cfg.heads * hd * 4      # float32
    return [(shape, "float32", nbytes) for _ in range(2 * cfg.depth)]


def export_decode_cache(cfg: LMConfig, cache):
    """A prefilled :func:`make_decode` cache (batch 1) as its page list
    ``[(tensor, nbytes), ...]`` in :func:`kv_page_specs` order.  No data
    moves: the pages are the live cache tensors, whole ``max_seq`` rows
    each; the transport decides whether they travel as descriptors or as
    bytes."""
    _refuse_scan(cfg, "paged KV export supports unrolled layers only")
    pages = []
    for i in range(cfg.depth):
        for key in (f"k{i}", f"v{i}"):
            t = cache[key]
            pages.append((t, t.numel() * t.element_size()))
    return pages


def decode_cache_from_pages(cfg: LMConfig, arrays):
    """Imported page tensors (in :func:`kv_page_specs` order) back into
    the per-layer cache dict the batcher's slot insert consumes."""
    if len(arrays) != 2 * cfg.depth:
        raise ValueError(f"expected {2 * cfg.depth} pages, got "
                         f"{len(arrays)}")
    cache = {}
    it = iter(arrays)
    for i in range(cfg.depth):
        cache[f"k{i}"] = next(it)
        cache[f"v{i}"] = next(it)
    return cache


def _rope_at_vec(x, pos, head_dim: int):
    """Rotary embedding at per-slot positions: ``x`` is (b, 1, heads, hd)
    and ``pos`` a (b,) tensor, so every slot of a continuous batch
    rotates at its own depth."""
    ang = (pos.to(torch.float32)[:, None, None, None]
           * _freqs(head_dim, x.device)[None, None, None, :])
    return _rope(x, torch.sin(ang), torch.cos(ang))


def _rope_span_vec(x, pos, head_dim: int):
    """Rotary embedding for a span of positions shared across the batch:
    ``x`` is (b, s, heads, hd) and ``pos`` an (s,) tensor (a chunk's
    ``start + arange(chunk)``); the same angles :func:`_rope_tables`
    gives ``arange(s)``, so a chunk rotates as the whole prompt does."""
    ang = (pos.to(torch.float32)[None, :, None, None]
           * _freqs(head_dim, x.device)[None, None, None, :])
    return _rope(x, torch.sin(ang), torch.cos(ang))


def _masked_attention(q, kc, vc, live, hd: int):
    """``softmax(q kᵀ / sqrt(hd))`` over the rows ``live`` admits, times
    v: the decode step's einsum attention.  ``q`` is (b, w, heads, hd),
    ``kc``/``vc`` (b, max_seq, heads, hd) and ``live`` (b, w, max_seq)."""
    s_mat = torch.einsum("bqhd,bkhd->bhqk", q, kc) / (hd ** 0.5)
    s_mat = torch.where(live[:, None], s_mat, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s_mat, dim=-1), vc)


def make_batch_decode(cfg: LMConfig, chunk: Optional[int] = None,
                      device="cuda"):
    """Continuous-batching decode over a fixed pool of session slots, each
    at its own position (the streaming service's engine).

    Returns ``(prefill, step)``, or ``(prefill, step, chunk_step)`` with
    ``chunk`` set:

    - ``prefill`` is :func:`make_decode`'s prompt pass, run per joining
      session at batch 1; the batcher copies its caches into the slot;
    - ``step(params, cache, token[b], active[b]) -> (cache, logits)``
      advances every active slot one token.  ``cache["len"]`` is a (b,)
      int32 tensor of positions on the device; inactive slots are clamped
      to ``max_seq - 1``, do not advance, and their logits are garbage;
    - ``chunk_step(params, cache, slot, start, n, ids[chunk]) -> cache``
      prefills ``n`` context tokens of one slot at ``start..start+n-1``
      and sets its len to ``start + n``.  Padding rows (``j >= n``) write
      garbage to row ``max_seq - 1``, which every admissible session
      rewrites before the live mask admits it.  The slice attends with
      the decode step's masked softmax, so a chunk-filled slot equals a
      whole-prompt insert.

    Cache tensors are updated in place (the JAX package donates them):
    the returned dict holds the same tensors.  The k/v write of a step is
    one indexed write per layer and the mask is built from the position
    tensor, so a step reads nothing back to the host."""
    _refuse_scan(cfg, "batch decode supports unrolled layers only — "
                      "scan_layers serving uses make_decode per shard")
    dev = resolve_device(device)
    hd = cfg.dim // cfg.heads
    rows_all = torch.arange(cfg.max_seq, device=dev)
    ffn = _ffn(cfg)

    def decode_layer(bp, x, kc, vc, pos, slots):
        b = x.shape[0]
        h = _rmsnorm(x, bp["ln1"])
        q, k, v = qmatmul(h, bp["wqkv"]).split(cfg.dim, dim=-1)
        shp = (b, 1, cfg.heads, hd)
        q = _rope_at_vec(q.reshape(shp), pos, hd)
        k = _rope_at_vec(k.reshape(shp), pos, hd)
        kc[slots, pos] = k[:, 0]
        vc[slots, pos] = v.reshape(shp)[:, 0]
        live = rows_all[None, None, :] <= pos[:, None, None]
        att = _masked_attention(q, kc, vc, live, hd)
        x = x + qmatmul(att.reshape(b, 1, cfg.dim), bp["wo"])
        return x + ffn(bp, _rmsnorm(x, bp["ln2"]))[0]

    def step(params, cache, token, active):
        cache = dict(cache)
        token = torch.as_tensor(token, device=dev).long()
        active = torch.as_tensor(active, device=dev).bool()
        pos = torch.clamp(cache["len"], max=cfg.max_seq - 1).long()
        slots = torch.arange(pos.shape[0], device=dev)
        x = params["embed"][token][:, None, :]
        for i in range(cfg.depth):
            x = decode_layer(params[f"blk{i}"], x, cache[f"k{i}"],
                             cache[f"v{i}"], pos, slots)
        cache["len"].add_(active.to(cache["len"].dtype))
        return cache, qmatmul(x[:, 0], params["unembed"])

    prefill, _ = make_decode(cfg, dev)
    if chunk is None:
        return prefill, step
    cw = int(chunk)
    offsets = torch.arange(cw, device=dev)

    def chunk_layer(bp, x, kc, vc, slot: int, rows, pos):
        h = _rmsnorm(x, bp["ln1"])
        q, k, v = qmatmul(h, bp["wqkv"]).split(cfg.dim, dim=-1)
        shp = (1, cw, cfg.heads, hd)
        q = _rope_span_vec(q.reshape(shp), pos, hd)
        k = _rope_span_vec(k.reshape(shp), pos, hd)
        kc[slot, rows] = k[0]
        vc[slot, rows] = v.reshape(shp)[0]
        live = rows_all[None, None, :] <= pos[None, :, None]
        att = _masked_attention(q, kc[slot][None], vc[slot][None], live, hd)
        x = x + qmatmul(att.reshape(1, cw, cfg.dim), bp["wo"])
        return x + ffn(bp, _rmsnorm(x, bp["ln2"]))[0]

    def chunk_step(params, cache, slot: int, start: int, n: int, ids):
        cache = dict(cache)
        ids = torch.as_tensor(ids, device=dev).long()
        pos = start + offsets
        last = cfg.max_seq - 1
        rows = torch.where(offsets < n, torch.clamp(pos, max=last), last)
        x = params["embed"][ids][None]                 # (1, chunk, dim)
        for i in range(cfg.depth):
            x = chunk_layer(params[f"blk{i}"], x, cache[f"k{i}"],
                            cache[f"v{i}"], int(slot), rows, pos)
        cache["len"][int(slot)] = int(start) + int(n)
        return cache

    return prefill, step, chunk_step


def empty_batch_cache(cfg: LMConfig, slots: int, device="cuda"):
    """A fresh slot-pool cache for :func:`make_batch_decode`: ``len`` is
    the (slots,) int32 position tensor on the device (all zero: every
    slot free); the layers are :func:`empty_cache`'s."""
    cache = empty_cache(cfg, slots, device=device)
    cache["len"] = torch.zeros((slots,), dtype=torch.int32,
                               device=resolve_device(device))
    return cache


def _rope_at_mat(x, pos, head_dim: int):
    """Rotary embedding at per-(slot, offset) positions: ``x`` is (b, w,
    heads, hd) and ``pos`` a (b, w) tensor (each slot's ``len +
    arange(w)``), the speculative verify's rows."""
    ang = (pos.to(torch.float32)[:, :, None, None]
           * _freqs(head_dim, x.device)[None, None, None, :])
    return _rope(x, torch.sin(ang), torch.cos(ang))


def _check_page(cfg: LMConfig, page: int) -> None:
    if cfg.max_seq % page:
        raise ValueError(
            f"page size {page} must divide max_seq {cfg.max_seq}")


def make_paged_batch_decode(cfg: LMConfig, page: int, device="cuda"):
    """Block-paged continuous batching: :func:`make_batch_decode` with
    the per-slot stripes replaced by one shared page pool per layer and a
    per-slot block table, so a session holds only the pages its context
    needs and two sessions may alias a page (the prefix cache).

    Logical page ``p`` is row block ``p`` of every layer's ``(num_pages,
    page, heads, hd)`` k and v pools; page 0 is the garbage page, which
    unallocated block-table entries and inactive slots write and the
    live mask never admits.  Returns ``(prefill, step)``, with
    ``step(params, cache, bt, token[b], active[b]) -> (cache, logits)``
    where ``bt`` is the (slots, max_seq // page) block table, host state
    passed per call.  The step writes each slot's new k/v row at
    ``pool[bt[b, pos // page], pos % page]``, gathers ``pool[bt]`` into
    the (b, max_seq, heads, hd) view the contiguous step attends over,
    and runs the same masked attention: its tokens equal the contiguous
    step's.  Pools and ``len`` are updated in place (the JAX package
    donates them), and the step reads nothing back to the host."""
    _refuse_scan(cfg, "paged batch decode supports unrolled layers only")
    _check_page(cfg, page)
    dev = resolve_device(device)
    hd = cfg.dim // cfg.heads
    rows_all = torch.arange(cfg.max_seq, device=dev)
    ffn = _ffn(cfg)

    def decode_layer(bp, x, pk, pv, bt, pos, slots):
        b = x.shape[0]
        h = _rmsnorm(x, bp["ln1"])
        q, k, v = qmatmul(h, bp["wqkv"]).split(cfg.dim, dim=-1)
        shp = (b, 1, cfg.heads, hd)
        q = _rope_at_vec(q.reshape(shp), pos, hd)
        k = _rope_at_vec(k.reshape(shp), pos, hd)
        page_idx = bt[slots, pos // page]
        row = pos % page
        pk[page_idx, row] = k[:, 0]
        pv[page_idx, row] = v.reshape(shp)[:, 0]
        kc = pk[bt].reshape(b, cfg.max_seq, cfg.heads, hd)
        vc = pv[bt].reshape(b, cfg.max_seq, cfg.heads, hd)
        live = rows_all[None, None, :] <= pos[:, None, None]
        att = _masked_attention(q, kc, vc, live, hd)
        x = x + qmatmul(att.reshape(b, 1, cfg.dim), bp["wo"])
        return x + ffn(bp, _rmsnorm(x, bp["ln2"]))[0]

    def step(params, cache, bt, token, active):
        cache = dict(cache)
        bt = torch.as_tensor(bt, device=dev).long()
        token = torch.as_tensor(token, device=dev).long()
        active = torch.as_tensor(active, device=dev).bool()
        pos = torch.clamp(cache["len"], max=cfg.max_seq - 1).long()
        slots = torch.arange(pos.shape[0], device=dev)
        x = params["embed"][token][:, None, :]
        for i in range(cfg.depth):
            x = decode_layer(params[f"blk{i}"], x, cache[f"pk{i}"],
                             cache[f"pv{i}"], bt, pos, slots)
        cache["len"].add_(active.to(cache["len"].dtype))
        return cache, qmatmul(x[:, 0], params["unembed"])

    prefill, _ = make_decode(cfg, dev)
    return prefill, step


def empty_paged_cache(cfg: LMConfig, num_pages: int, slots: int, page: int,
                      device="cuda"):
    """A fresh page-pool cache for :func:`make_paged_batch_decode`: one
    f32 ``(num_pages, page, heads, hd)`` k and v pool per layer (page 0
    the garbage page) and the (slots,) int32 ``len`` tensor.  The block
    table is host state (``kv.pages.PageAllocator`` decides it), passed
    to each call."""
    _check_page(cfg, page)
    dev = resolve_device(device)
    hd = cfg.dim // cfg.heads
    cache: Dict[str, Any] = {}
    for i in range(cfg.depth):
        for kind in ("pk", "pv"):
            cache[f"{kind}{i}"] = torch.zeros(
                (num_pages, page, cfg.heads, hd), dtype=torch.float32,
                device=dev)
    cache["len"] = torch.zeros((slots,), dtype=torch.int32, device=dev)
    return cache


def paged_page_bytes(cfg: LMConfig, page: int) -> int:
    """Device bytes one logical page pins across every layer's k and v
    pools (the allocator's accounting unit)."""
    hd = cfg.dim // cfg.heads
    return 2 * cfg.depth * page * cfg.heads * hd * 4       # float32


def make_paged_io(cfg: LMConfig, page: int, chunk: Optional[int] = None,
                  device="cuda"):
    """Page-granular data motion of the paged cache, every call at a
    fixed shape (padded to the block-table width with page-0 entries,
    which only ever write garbage there).  Returns ``(gather, scatter,
    insert)``, or with ``chunk`` set ``(gather, scatter, insert,
    chunk_prefill)``:

    - ``gather(cache, page_ids[pps]) -> (pps, 2*depth, page, heads, hd)``:
      a session's pages as one block, k then v per layer on axis 1;
    - ``scatter(cache, page_ids[pps], block) -> cache``: the inverse,
      resume's landing;
    - ``insert(cache, page_ids[pps], src) -> cache``: a batch-1
      :func:`make_decode` prefill cache cut into the session's pages;
    - ``chunk_prefill(params, cache, bt_row[pps], slot, start, n,
      ids[chunk]) -> cache``: ``n`` context tokens of one slot at
      ``start..start+n-1``, each row written at ``bt_row[pos // page]``,
      then the slot's len set to ``start + n``.  Padding entries write
      page 0; a partial prefix hit's catch-up starts at its page-aligned
      ``covered``, so aliased pages are never written.  The slice attends
      over the gathered view under the decode step's mask, so a
      chunk-filled slot equals a whole-prompt insert.

    Writes land in place in the cache's tensors."""
    _check_page(cfg, page)
    dev = resolve_device(device)
    pps = cfg.max_seq // page
    hd = cfg.dim // cfg.heads

    def gather(cache, page_ids):
        ids = torch.as_tensor(page_ids, device=dev).long()
        blocks = []
        for i in range(cfg.depth):
            blocks.append(cache[f"pk{i}"][ids])
            blocks.append(cache[f"pv{i}"][ids])
        return torch.stack(blocks, dim=1)

    def scatter(cache, page_ids, block):
        ids = torch.as_tensor(page_ids, device=dev).long()
        block = torch.as_tensor(block, device=dev)
        for i in range(cfg.depth):
            cache[f"pk{i}"][ids] = block[:, 2 * i]
            cache[f"pv{i}"][ids] = block[:, 2 * i + 1]
        return cache

    def insert(cache, page_ids, src):
        ids = torch.as_tensor(page_ids, device=dev).long()
        for i in range(cfg.depth):
            for kind in ("k", "v"):
                cache[f"p{kind}{i}"][ids] = src[f"{kind}{i}"][0].reshape(
                    pps, page, cfg.heads, hd)
        return cache

    if chunk is None:
        return gather, scatter, insert

    cw = int(chunk)
    offsets = torch.arange(cw, device=dev)
    rows_all = torch.arange(cfg.max_seq, device=dev)
    ffn = _ffn(cfg)

    def chunk_layer(bp, x, pk, pv, bt_row, page_idx, row, pos):
        h = _rmsnorm(x, bp["ln1"])
        q, k, v = qmatmul(h, bp["wqkv"]).split(cfg.dim, dim=-1)
        shp = (1, cw, cfg.heads, hd)
        q = _rope_span_vec(q.reshape(shp), pos, hd)
        k = _rope_span_vec(k.reshape(shp), pos, hd)
        pk[page_idx, row] = k[0]
        pv[page_idx, row] = v.reshape(shp)[0]
        kcs = pk[bt_row].reshape(1, cfg.max_seq, cfg.heads, hd)
        vcs = pv[bt_row].reshape(1, cfg.max_seq, cfg.heads, hd)
        live = rows_all[None, None, :] <= pos[None, :, None]
        att = _masked_attention(q, kcs, vcs, live, hd)
        x = x + qmatmul(att.reshape(1, cw, cfg.dim), bp["wo"])
        return x + ffn(bp, _rmsnorm(x, bp["ln2"]))[0]

    def chunk_prefill(params, cache, bt_row, slot: int, start: int, n: int,
                      ids):
        bt_row = torch.as_tensor(bt_row, device=dev).long()
        ids = torch.as_tensor(ids, device=dev).long()
        pos = int(start) + offsets
        posc = torch.clamp(pos, max=cfg.max_seq - 1)
        page_idx = torch.where(offsets < int(n), bt_row[posc // page], 0)
        row = posc % page
        x = params["embed"][ids][None]                 # (1, chunk, dim)
        for i in range(cfg.depth):
            x = chunk_layer(params[f"blk{i}"], x, cache[f"pk{i}"],
                            cache[f"pv{i}"], bt_row, page_idx, row, pos)
        cache["len"][int(slot)] = int(start) + int(n)
        return cache

    return gather, scatter, insert, chunk_prefill


def make_paged_spec_verify(cfg: LMConfig, page: int, width: int,
                           device="cuda"):
    """Speculative decoding's target verification over the paged cache:
    ``width = k + 1`` candidates ``[x0, d1..dk]`` per slot (its pending
    token and the draft's proposals) written and attended in one call.

    Returns ``verify(params, cache, bt, tokens[b, w], active[b]) ->
    (cache, out[b, w], accepted[b])``: row ``j`` of ``out`` is the argmax
    at position ``len + j`` given rows ``0..len+j``, the token a plain
    step emits after ``tokens[:, :j+1]``; ``accepted`` is the length
    ``m`` of the draft prefix the target confirms (``d_i == out_{i-1}``),
    capped at ``k - 1`` so the draft's cache never runs ahead of a row it
    wrote; active slots' ``len`` advances by ``m + 1``.  Refuted rows keep
    their garbage beyond the new len, where a later write replaces them
    before the mask admits them: rollback is a len rewind.  The caller
    keeps ``len + width <= max_seq`` for every active slot."""
    _refuse_scan(cfg, "spec verify supports unrolled layers only")
    _check_page(cfg, page)
    w = int(width)
    if w < 2:
        raise ValueError("spec verify needs width >= 2 (k >= 1)")
    dev = resolve_device(device)
    hd = cfg.dim // cfg.heads
    rows_all = torch.arange(cfg.max_seq, device=dev)
    offsets = torch.arange(w, device=dev)
    ffn = _ffn(cfg)

    def verify_layer(bp, x, pk, pv, bt, pos):
        b = x.shape[0]
        h = _rmsnorm(x, bp["ln1"])
        q, k, v = qmatmul(h, bp["wqkv"]).split(cfg.dim, dim=-1)
        shp = (b, w, cfg.heads, hd)
        q = _rope_at_mat(q.reshape(shp), pos, hd)
        k = _rope_at_mat(k.reshape(shp), pos, hd)
        page_idx = bt[torch.arange(b, device=dev)[:, None], pos // page]
        row = pos % page
        pk[page_idx, row] = k
        pv[page_idx, row] = v.reshape(shp)
        kc = pk[bt].reshape(b, cfg.max_seq, cfg.heads, hd)
        vc = pv[bt].reshape(b, cfg.max_seq, cfg.heads, hd)
        live = rows_all[None, None, :] <= pos[:, :, None]
        att = _masked_attention(q, kc, vc, live, hd)
        x = x + qmatmul(att.reshape(b, w, cfg.dim), bp["wo"])
        return x + ffn(bp, _rmsnorm(x, bp["ln2"]))[0]

    def verify(params, cache, bt, tokens, active):
        cache = dict(cache)
        bt = torch.as_tensor(bt, device=dev).long()
        tokens = torch.as_tensor(tokens, device=dev).long()
        active = torch.as_tensor(active, device=dev).bool()
        pos = torch.clamp(cache["len"].long()[:, None] + offsets[None, :],
                          max=cfg.max_seq - 1)                  # (b, w)
        x = params["embed"][tokens]                             # (b, w, dim)
        for i in range(cfg.depth):
            x = verify_layer(params[f"blk{i}"], x, cache[f"pk{i}"],
                             cache[f"pv{i}"], bt, pos)
        out = torch.argmax(qmatmul(x, params["unembed"]), dim=-1)
        match = (tokens[:, 1:] == out[:, :w - 1]).to(torch.int32)
        m = torch.clamp(torch.cumprod(match, dim=1).sum(dim=1), max=w - 2)
        cache["len"].add_(torch.where(active, m + 1, 0).to(
            cache["len"].dtype))
        return cache, out.to(torch.int32), m.to(torch.int32)

    return verify


def make_decode_loop(cfg: LMConfig, steps: int, device="cuda"):
    """Greedy generation of ``steps`` tokens from a prefilled cache:
    ``(prefill, loop)`` with ``loop(params, cache, token) -> (cache,
    tokens (steps, b))``, each step feeding the argmax back through
    :func:`make_decode`'s step.  The JAX package scans the steps inside
    one compiled program; eager PyTorch runs them as a Python loop."""
    prefill, decode_step = make_decode(cfg, device)

    def loop(params, cache, token):
        tok = torch.as_tensor(token, device=resolve_device(device)).long()
        toks = []
        for _ in range(steps):
            cache, logits = decode_step(params, cache, tok)
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok.to(torch.int32))
        return cache, torch.stack(toks)

    return prefill, loop


def _validate_gen_args(cfg: LMConfig, prompt_ids, max_new: int,
                       temperature: float, generator) -> None:
    s = prompt_ids.shape[1]
    if s + max_new > cfg.max_seq:
        raise ValueError(
            f"prompt {s} + max_new {max_new} exceeds max_seq "
            f"{cfg.max_seq} (the cache would silently wrap)")
    if temperature > 0.0 and generator is None:
        raise ValueError(
            "temperature > 0 requires a torch.Generator (a silent default "
            "would make every sampled completion identical)")


def make_scan_generator(cfg: LMConfig, params, device="cuda"):
    """``gen(prompt_ids, max_new, temperature=0.0, generator=None) ->
    (b, max_new) int32`` on ``device``: one prefill, then ``max_new - 1``
    decode steps, each picking the next token from the last logits
    (greedy argmax — the first index of the maximum — at temperature 0,
    else a draw from the tempered softmax with ``generator``).  The JAX
    package scans the steps inside one compiled program; eager PyTorch
    runs the same steps as a Python loop."""
    prefill, decode_step = make_decode(cfg, device)

    def pick(logits, temperature: float, generator: Optional[torch.Generator]):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    @torch.inference_mode()
    def gen(prompt_ids, max_new: int, temperature: float = 0.0,
            generator: Optional[torch.Generator] = None):
        _validate_gen_args(cfg, prompt_ids, max_new, temperature, generator)
        cache, logits = prefill(params, prompt_ids)
        token = pick(logits, temperature, generator)
        out = [token]
        for _ in range(max_new - 1):
            cache, logits = decode_step(params, cache, token)
            token = pick(logits, temperature, generator)
            out.append(token)
        return torch.stack(out, dim=1).to(torch.int32)

    return gen


# In eager PyTorch the per-step generator and the scanned one are the same
# loop; the name is kept for callers of the JAX package's API.
make_generator = make_scan_generator


def generate(params, cfg: LMConfig, prompt_ids, max_new: int,
             device="cuda"):
    """One-off greedy decoding convenience."""
    return make_scan_generator(cfg, params, device)(prompt_ids, max_new)


# -- training ---------------------------------------------------------------

def param_specs(cfg: LMConfig) -> Dict[str, Any]:
    """How a ``("dp", "tp")`` mesh shards each parameter, per dim: ``None``
    (whole), an axis name, or ``("tp", 3)`` for ``wqkv``'s fused dim.  As
    in the JAX package, the attention and MLP projections cut their wide
    dim over tp, the embeddings their vocab, and MoE experts go over tp
    (expert parallelism, :func:`.moe.param_specs`).  JAX's ``P(None,
    "tp")`` over the fused ``(dim, 3 * dim)`` ``wqkv`` works because GSPMD
    cuts it globally; a rank's explicit shard is q, k and v *each* cut by
    head group, which ``("tp", 3)`` says: three equal pieces, each cut
    over tp (:func:`~..utils.convert.shard_from_numpy` reads it)."""
    specs: Dict[str, Any] = {"embed": ("tp", None), "unembed": (None, "tp")}
    blk: Dict[str, Any] = {"wqkv": (None, ("tp", 3)), "wo": ("tp", None),
                           "ln1": (None,), "ln2": (None,)}
    if cfg.moe_experts > 0:
        blk["moe"] = moe.param_specs(cfg.moe_cfg(), ep_axis="tp")
    else:
        blk["w1"] = (None, "tp")
        blk["w2"] = ("tp", None)
    if cfg.scan_layers:
        # stacked weights: a whole leading depth dim, then the layer's spec
        specs["blocks"] = _map_specs(blk, lambda sp: (None,) + tuple(sp))
    else:
        for i in range(cfg.depth):
            specs[f"blk{i}"] = blk
    return specs


def _map_specs(tree: dict, fn) -> dict:
    return {k: _map_specs(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def batch_specs():
    """ids and labels: the batch over dp (with ``sp_axis``, the sequence
    over sp as well: each rank passes its block)."""
    return ("dp", None), ("dp", None)


class _Par:
    """The LM's view of a mesh, per rank: ``tp`` cuts heads, the MLP's
    hidden dim, the vocab and (MoE) the experts; ``dp`` the batch; ``sp``
    (``sp_axis``) the sequence, attended by ring attention.  Without a
    mesh every axis is None and each method is the unsharded step
    (``sp_axis`` alone is ignored, as in the JAX package)."""

    def __init__(self, cfg: LMConfig, mesh, sp_axis):
        names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
        extra = set(names) - {"dp", "tp", sp_axis}
        if extra:
            raise ValueError(f"the LM's mesh takes axes dp, tp and the "
                             f"sp_axis, not {sorted(extra)}")
        if mesh is not None and sp_axis is not None and sp_axis not in names:
            raise ValueError(f"mesh has no axis {sp_axis!r}")
        self.tp = mesh_axis(mesh, "tp")
        self.dp = mesh_axis(mesh, "dp")
        self.sp = mesh_axis(mesh, sp_axis)
        n_tp = self.tp.size if self.tp else 1
        if cfg.heads % n_tp or cfg.vocab % n_tp or (
                cfg.moe_experts % n_tp if cfg.moe_experts else 0):
            raise ValueError(f"heads {cfg.heads}, vocab {cfg.vocab} and "
                             f"experts {cfg.moe_experts} must divide by "
                             f"tp {n_tp}")
        self.heads = cfg.heads // n_tp
        # the axes over which the loss is a mean and the gradients sum
        self.batch = [a for a in (self.dp, self.sp) if a is not None]

    def embed(self, table, ids):
        """tp: each rank looks up the vocab rows it holds, zero elsewhere,
        and the rows sum over tp."""
        if self.tp is None:
            return table[ids]
        rows = table.shape[0]
        local = ids - self.tp.rank * rows
        mine = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)] * mine[..., None]
        return psum(x, self.tp)

    def unembed(self, x, w):
        """tp: the logits of this rank's vocab columns, all-gathered
        before the log-softmax (a vocab-parallel loss would not gather)."""
        if self.tp is None:
            return qmatmul(x, w)
        return all_gather(qmatmul(pvary(x, self.tp), w), self.tp, -1)

    def enter(self, h):
        return pvary(h, self.tp) if self.tp is not None else h

    def leave(self, y):
        return psum(y, self.tp) if self.tp is not None else y


def make_forward(cfg: LMConfig, mesh=None, sp_axis=None, device="cuda"):
    """Forward fn: ``(params, ids[b, s], with_aux=False) -> logits[b, s,
    vocab]`` f32, or ``(logits, aux)`` with ``with_aux``: the sum over
    blocks of each MoE block's aux loss (0 for the dense MLP).  Unrolled
    and stacked (``scan_layers``) params both run.  With ``cfg.remat``
    each block runs under ``torch.utils.checkpoint`` and is recomputed in
    the backward pass, as ``jax.checkpoint`` does: the flash forward
    kernel then runs twice per block.

    With ``mesh`` (a DeviceMesh with axes among ``dp``, ``tp`` and
    ``sp_axis``) the function runs on one rank: ``params`` is the rank's
    shard under :func:`param_specs`, ``ids`` its block under
    :func:`batch_specs` (the batch over dp and, with ``sp_axis``, the
    sequence over sp), and the logits are the rank's block, whole over
    the vocab.  Tensor parallelism is Megatron's: a replicated activation
    enters each column-cut product through ``pvary`` and each row-cut
    product's partial sums leave through ``psum``.  With ``sp_axis`` the
    attention is ring attention and rope takes global positions; an MoE
    block gathers the sequence over sp and routes whole rows, as the JAX
    program (one global forward) does.  The JAX package gets the dp and
    tp shardings from where its params live; here ``mesh`` names them."""
    dev = resolve_device(device)
    par = _Par(cfg, mesh, sp_axis)
    hd = cfg.dim // cfg.heads
    width = par.heads * hd
    impl = "flash" if cfg.use_flash else cfg.attn_impl
    mcfg = cfg.moe_cfg() if cfg.moe_experts > 0 else None
    sp = par.sp
    if sp is not None:
        attend = make_ring_attention(mesh, sp_axis, causal=cfg.causal)
    else:
        def attend(q, k, v):
            return attention(q, k, v, causal=cfg.causal, impl=impl)

    def ffn(bp, h):
        if mcfg is None:
            return par.leave(_mlp(bp, par.enter(h))), None
        if sp is None:
            return moe.forward_grouped(bp["moe"], h, mcfg, ep=par.tp)
        # routing takes whole rows: gather the sequence over sp (the
        # backward reduce-scatters, as each rank keeps its own block)
        sl = h.shape[1]
        out, aux = moe.forward_grouped(
            bp["moe"], all_gather_sum_grad(h, sp, 1), mcfg, ep=par.tp)
        return out[:, sp.rank * sl:(sp.rank + 1) * sl], aux

    def block(bp, x, sin, cos):
        b, s, _ = x.shape
        q, k, v = _qkv_heads(cfg, bp, par.enter(_rmsnorm(x, bp["ln1"])),
                             sin, cos, par.heads)
        att = attend(q, k, v)
        x = x + par.leave(qmatmul(att.reshape(b, s, width), bp["wo"]))
        out, aux = ffn(bp, _rmsnorm(x, bp["ln2"]))
        return x + out, aux

    def forward(params, ids, with_aux: bool = False):
        ids = torch.as_tensor(ids, device=dev).long()
        s = ids.shape[-1]
        n_sp, offset = (sp.size, sp.rank * s) if sp is not None else (1, 0)
        if s * n_sp > cfg.max_seq:
            raise ValueError(f"seq {s * n_sp} exceeds max_seq {cfg.max_seq}")
        x = par.embed(params["embed"], ids)
        sin, cos = _rope_tables(s, hd, dev, offset)
        aux_total = torch.zeros((), dtype=torch.float32, device=dev)
        for bp in _blocks(cfg, params):
            x, aux = (checkpoint(block, bp, x, sin, cos, use_reentrant=False)
                      if cfg.remat else block(bp, x, sin, cos))
            if aux is not None:
                aux_total = aux_total + aux
        logits = par.unembed(x, params["unembed"])
        return (logits, aux_total) if with_aux else logits

    return forward


def tree_leaves(tree) -> list:
    """The tensors of a nested parameter dict, in insertion order."""
    out = []
    for val in tree.values():
        out.extend(tree_leaves(val) if isinstance(val, dict) else [val])
    return out


def _rebuild(tree, leaves):
    """``tree``'s nesting with its leaves taken in order from ``leaves``."""
    return {k: _rebuild(v, leaves) if isinstance(v, dict) else next(leaves)
            for k, v in tree.items()}


def make_value_and_grad(cfg: LMConfig, mesh=None, sp_axis=None,
                        accum: int = 1, device="cuda"):
    """``value_and_grad(params, ids, labels) -> (loss, grads)``: the loss
    of :func:`make_train_step` (mean next-token NLL of the f32
    log-softmax, plus aux) and its gradient, a dict shaped like
    ``params``.  ``accum > 1`` runs the batch as ``accum`` microbatches
    one after another and averages their losses and gradients.

    On a mesh, the loss and gradients are this rank's (its shard's
    gradient, under :func:`param_specs`), with the loss the mean over the
    whole batch: each rank's loss and gradients are averaged over dp and
    sp after the backward pass (ranks hold equal token counts)."""
    forward = make_forward(cfg, mesh, sp_axis, device)
    dev = resolve_device(device)
    batch_axes = _Par(cfg, mesh, sp_axis).batch

    def loss_fn(params, ids, labels):
        logits, aux = forward(params, ids, with_aux=True)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None]).squeeze(-1)
        return nll.mean() + aux

    def one(params, ids, labels):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = loss_fn(_rebuild(params, iter(live)), ids, labels)
        return loss.detach(), list(torch.autograd.grad(loss, live))

    def value_and_grad(params, ids, labels):
        ids = torch.as_tensor(ids, device=dev).long()
        labels = torch.as_tensor(labels, device=dev).long()
        if accum <= 1:
            loss, grads = one(params, ids, labels)
        else:
            if ids.shape[0] % accum != 0:
                raise ValueError(
                    f"batch {ids.shape[0]} not divisible by "
                    f"accum={accum} — trailing examples would be "
                    "silently dropped")
            b = ids.shape[0] // accum
            mids = ids.reshape(accum, b, *ids.shape[1:])
            mlbl = labels.reshape(accum, b, *labels.shape[1:])
            loss, grads = one(params, mids[0], mlbl[0])
            for i in range(1, accum):
                l, g = one(params, mids[i], mlbl[i])
                loss = loss + l
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
            loss = loss / accum
            grads = [g / accum for g in grads]
        for ax in batch_axes:
            loss = _all_reduce(ax, loss) / ax.size
            grads = [_all_reduce(ax, g) / ax.size for g in grads]
        return loss, _rebuild(params, iter(grads))

    return value_and_grad


def make_train_step(cfg: LMConfig, mesh=None, sp_axis=None, accum: int = 1,
                    device="cuda"):
    """``train_step(params, ids, labels, lr=cfg.lr) -> (new_params,
    loss)``; plain SGD ``p - lr * g``.

    Pure, like the JAX function: ``params`` is left as it is and the new
    parameters are new tensors.  ``accum > 1`` turns on gradient
    accumulation: the leading batch dim must be ``accum * microbatch``,
    and the microbatches run one after another (the JAX package scans
    them inside one compiled program), so one step holds the activations
    of a single microbatch."""
    value_and_grad = make_value_and_grad(cfg, mesh, sp_axis, accum, device)

    def train_step(params, ids, labels, lr: float = cfg.lr):
        loss, grads = value_and_grad(params, ids, labels)
        with torch.no_grad():
            new = [p - lr * g for p, g in zip(tree_leaves(params),
                                              tree_leaves(grads))]
        return _rebuild(params, iter(new)), loss

    return train_step
