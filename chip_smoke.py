#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc`` (``CUDA_HOME`` or /usr/local/cuda),
imports nothing of JAX or ``brpc_tpu``, and fails (non-zero exit, no
result line) when a phase fails or CUDA is absent.  Phases:

1. the card's name and power limit, torch and CUDA versions;
2. build every kernel from ``brpc_tpu_torch/ops/csrc`` (nvcc, sm_90a),
   and the CUDA IPC interface of the transfer fabric (``ipc.cu``), and
   print ptxas's registers and spill bytes of each kernel function;
3. hold the forward kernel against its plain PyTorch version on the card,
   at every shape the Generate and Decode paths give it and smaller
   ones, hold it at d = 256 through ``flash_attention_fwd``, and show
   that a head dim past its 256 raises there, in the forward and the
   backward, before any launch;
   3b. hold the backward kernels (``flash_dq``, ``flash_dkdv``) against
   the plain backward, f32 and bf16, causal and not, at the training
   shape and smaller ones, and f32 causal past the training length
   ((4, 4096, 16, 128) and (1, 8192, 16, 128));
   3c. hold the checksum kernel bit-exact against its plain version on
   payloads of 0 to 2**20+3 words and 64 MiB, in f32, int32 (sums that
   wrap), bf16, int8 and bool, unaligned and non-contiguous, and show
   that flipping one element changes the sum;
   3w. hold all three flash kernels against their plain versions at head
   dims 136, 192 and 256 (zero-padded to 256), f32 and bf16, causal and
   not, one unaligned (offset) case per width, and the shapes of 4w and
   5w, under the d <= 128 tolerances;
4. time the forward kernel, its plain version and the library call
   (SDPA) at the full-width prefill shape and at the training shape,
   beside the card's bounds for the same work (f32 FMAs, and the tensor
   cores: 3xTF32 for f32) and the kernel's ratio to the library call;
   4b. the same for each backward kernel at the training shape (the
   library yardstick is SDPA's backward, split 6 : 8 between dq and
   dkdv by their FLOPs for the ratio); 4c. the checksum kernel,
   its plain version and ``x.view(torch.int32).sum(dtype=torch.int64)``
   at 64 MiB, beside the bound and the achieved GB/s;
   4w. the same at head dim 256: the forward at (1, 1024, 8, 256), dq
   and dkdv at (4, 2048, 8, 256), f32 and bf16, each beside SDPA (the
   backend that ran named from a profiler trace);
   5w. serve the head-dim-256 LM (``WIDE_CFG``: ``SLICE_CFG`` with 8
   heads, depth 4, ``attn_impl="auto"``) through a Server: three
   Generates with prompts of 128-1024 tokens, ``flash_fwd`` depth a
   request, the tokens beside dense attention's on the same weights and
   the prefill logits held to theirs; then one step's loss and gradient
   with ``use_flash=True`` against dense attention and one train step,
   the launches read around each;
5. serve ``LM.Info`` and three ``LM.Generate`` requests through the
   port's Server, LMService and Channel at the full width of the repo's
   widest LM, with the kernels' launch counts read around that run;
6. show under ``torch.profiler`` that one request launches the flash
   kernel once per layer, and that the prefill logits through the kernel
   agree with those through dense attention;
   6b. serve ``LM.Decode`` through the continuous batcher on the same
   service (8 slots): eight concurrent client streams with prompts of
   256-1500 tokens and 64 new tokens each, joining while others are
   mid-stream; every stream closes ``finished``, each session's tokens
   equal the solo generator's (a token may differ only where the solo
   run's top-1 margin is a near-tie), ``flash_fwd`` launches once per
   layer per join; two more sessions through a service with chunked
   prefill (256-token slices, no flash launch); aggregate tok/s against
   the one-stream rate, TTFT, decode-round ms, and one profiled round at
   8 live slots (kernels per round, device busy share);
   6c. serve ``LM.Decode`` through the paged batcher (16-token pages of
   2 MiB at this width) on the same weights: (a) 16 streams through 16
   slots on the KV bytes of 6b's 8 contiguous slots with a 512 MiB host
   tier (tokens under the near-tie rule, aggregate tok/s, live round ms,
   TTFT, peak pages, spills and resumes, ``flash_fwd`` once per layer
   per whole-prompt join); the paged step against the contiguous step
   on 6b's eight filled contexts (bit-equal logits and k/v over two
   steps, with two slots moved through the host tier to spare pages in
   between); one profiled paged round at 6b's eight positions (the
   block-table gather's share); (b) prefix sharing: four
   1073-token prompts on one 1024-token head, then the first again (one
   prefill, three partial hits caught up by chunk slices, one full hit);
   (c) four 1000-token sessions on 256 usable pages with a host tier
   (spills, resumes, their ms); (d) speculative decoding with k = 3 and
   the target as its own draft against plain paged decoding on the same
   prompts (accept rate, tokens per round, round ms, ``flash_fwd`` twice
   per layer per join: target and draft prefill) and one profiled spec
   round;
   6d. serve ``LM.Decode`` disaggregated on the same weights: prefill
   tiers (``PrefillService``) prefill each session (the flash kernel once
   per layer) and hand its 16 KV pages (256 MiB) to a decode tier
   (``DecodeTierService`` over an ``LMService``) in the same process,
   whose batcher streams the tokens to the original client stream: (a)
   6b's eight prompts over the ici lane (the pages stay where they are)
   into 8 contiguous slots, TTFT beside 6b's, no fallback, no page left
   exported, no prefill on the decode tier; (b) 6b's two chunk prompts
   over the copy lane (the page bytes ride the RPC attachment, the frame
   cap raised to 512 MiB for it), then over the ici lane, the unary
   Decode ms of each and the copy lane's GB/s over the difference; (c)
   the copy lane at the default 64 MiB cap (refused where it is framed:
   ``kv_import_rejected``, decoded on the prefill tier from the same
   cache) and a strict tier (EINTERNAL, the stream closed
   ``kv_handoff_failed``); (d) four of 6b's prompts into 6c (a)'s paged
   decode tier (no prefix events); tokens under the near-tie rule; (e)
   the forced shm lane, in one process, on a ring rebuilt with 16 MiB
   slots: 6b's eight prompts (each page copied once from the card into a
   slot and landed from it; 6b's tokens exactly, no fallback, no slot
   left), then 6b's two chunk prompts over the shm and the ici lane, the
   shm lane's extra ms per session beside (b)'s copy lane, and its
   staging and landing timed apart;
   5s. serve ``scan_layers`` Generate: the same weights stacked on a
   leading depth axis, int8, against the unrolled int8 service (equal
   tokens, the flash kernel once per layer), and ``Decode`` refusing the
   stacked config with EREQUEST;
   12. observability on the serving phases' services and servers: (a)
   three traced Generate calls (a client and a server span each, the
   server span parented to the client span, ``flash_fwd`` depth x 3, the
   medians of the wire, queue and handler legs from the spans' stamps,
   MethodStatus's p50 and p99); (b) a traced Decode on the contiguous
   batcher (its ``LMService.DecodeSession`` span under the Decode server
   span: ``lm_join`` ... ``lm_first_token`` ... ``lm_evict:finished``, the
   first token's offset beside the host TTFT); (c) a traced Decode through
   the ici-lane prefill tier (one trace id over both tiers' server and
   session spans and the handoff's client and server spans, 6b's tokens,
   the stitched tree printed); (d) 6c (c)'s spill setup traced (``lm_spill``
   then ``lm_resume`` on every parked session's span, as often as the
   batcher spilled); (e) MethodStatus counted every Generate, the
   Prometheus families present, 6b's per-tier TTFT and ITL quantiles from
   the histograms; (f) the observer effect, by ``bench.py``'s paired
   A/B methods: ``lm_telemetry`` on against off over decode sessions, and
   traced against untraced 128-byte echoes, each beside its off-against-off
   noise;
   13. the overload and drain planes on the same services: (a) two
   Generate calls from two threads on one connection, the second's budget
   under the first's handler time: held back while the first runs inline
   on the connection's consumer, as on the JAX server, it times out at
   its caller (``ERPCTIMEDOUT``) and is then read with a fresh arrival
   stamp and run, unshed (``flash_fwd`` launched for both, the first's
   tokens phase 5's); then a Generate whose budget is spent at its
   arrival (an explicit on-wire 0) is shed (``ERPCTIMEDOUT``, its handler
   never run, ``deadline_shed_total`` +1, no launch); (b) goodput under
   overload, ``bench.py``'s paired, interleaved A/B: bursts of 4 calls
   on one connection with budgets of 2.5 times a lone request's latency,
   shedding on against off (completed-within-budget calls per second,
   sheds, launches per completed call): every call runs, in both arms,
   since nothing held back on one connection is late when it is read;
   (c) admission on servers of their own: a method
   cap of 2 with 2 calls in flight and 4 more, one after another,
   beside them (4 ``ELIMIT`` in under 5 ms, no launch for them), an "auto" limiter under a 16-call burst, a fair
   capacity of 2 with one tenant flooding; (d) a drain of a server
   carrying 6c (c)'s spill setup and the plain LM during 8 staggered
   Decode streams (6c (c)'s four prompts and four of 256 tokens) and a
   Generate (the Generate finishes, a new one gets
   ``ELAMEDUCK`` with the lame-duck TLV, every stream closes
   ``lame_duck`` with a prefix of its solo tokens, no page held, spilled
   or exported after, ``server_drain_state`` 1 then 0), then a handler
   outlasting a 200 ms grace (-1, one connection force-closed); (e) a
   pooled backup beside its primary (2 x depth launches), a retry after
   the server drops the connection, no backup once the retry budget is
   drained;
   14. the LM across replicas, on the same weights: two paged replicas
   (4 slots each), each an ``LMService`` on a ``Server`` of its own in
   this process: (a) four (1, 1024, 32) Generates through
   ``list://A,B`` with ``"rr"`` (2 and 2, phase 5's tokens, ``flash_fwd``
   4 x depth), then ``"la"`` beside a (1, 1500, 64) loop on A (the share
   sent to B); (b) 6c (b)'s five sessions through ``"c_murmurhash"``
   keyed by their head (all on one replica: 1 miss, 3 partial hits, 1
   hit, one prefill, the other replica none), then five on another head
   through ``"rr"`` (a prefill on each replica); tokens under 6b's
   near-tie rule; (c) a backup across replicas: the primary pinned to A
   (busy with a (1, 1500, 64)), the 50 ms backup won on B, its ms beside
   a lone call's; (d) a ``ParallelChannel`` over A and B (both phase 5's
   tokens) and a ``SelectiveChannel`` with a dead sub-channel; (e)
   ``list://A,<dead port>`` with the circuit breaker (every call
   succeeds, one ``fleet_breaker_trip``, no attempt dials the dead port
   while it is isolated); (f) a fleet registry with both replicas
   reporting every 0.2 s (``ok``, slots and KV in each report), 6d's
   decode tier's ``KV.Probe`` with its load-report tail, federation
   labels; (g) two client threads looping (1, 512, 8) over a ``file://``
   list while A drains with a 2 s grace: no call fails, A's
   ``ELAMEDUCK`` answers retried on B, A unlisted after the naming
   refresh, the registry showing it ``draining`` within one report
   interval;
   15. HTTP/1.1, h2c/gRPC and the builtin portal on phase 5's one port,
   while the LM serves: (a) phase 5's three requests as ``POST
   /LM/Generate`` (the tpu_std request bytes, ``application/octet-stream``)
   and (b) through ``Channel(protocol="http")`` and
   ``Channel(protocol="grpc")``, each lane phase 5's tokens with
   ``flash_fwd`` depth x 3 and each call's ms beside phase 5's; (c) a call
   whose budget ran out (``x-deadline-ms: 0``; a 0.5 µs ``grpc-timeout``)
   on a fresh connection per lane, shed without a launch: HTTP 500 with
   ``x-rpc-error-code`` ERPCTIMEDOUT, gRPC status 4; (d) ``/status``,
   ``/vars`` and ``/metrics`` with phase 12's ``lm_*`` families, ``/lm``,
   ``/rpcz?trace_id=...&format=json`` for a traced HTTP Generate (its
   server span under the caller's span), ``/hotspots/cpu?seconds=1``
   during a (1, 1500, 64) Generate (the generator's frames named),
   ``/flags`` set live and ``internal_port`` gating; (e)
   ``rpcz_stitch.collect_trace`` with no ``fetch=`` on 12 (c)'s traced
   disaggregated Decode (both tiers' ``/rpcz`` over their ports), run
   right after 12 (c) while the span store still holds the trace; (f)
   inside phase 14, after its fleet step: ``federate()`` with no
   ``fetch=`` over the two replicas' ``/metrics`` and
   ``fetch_member_report`` of each;
   16. the classic lane's stages, TLS, async calls and the device block
   pool, on phase 5's service: (a) a GZIP (1, 1024, 32) Generate (phase
   5's tokens and launches) on a server with ``auth``, an interceptor and
   session-local data, a ``@method(response_compress=GZIP)`` echo read
   back, a bad ``auth_data`` answered ``ERPCAUTH`` and an interceptor's
   own code and text, each refusal with no launch, eight calls of one
   connection on one session object; (b) a second server on the same
   service with a self-signed localhost pair made by the ``openssl``
   CLI: phase 5's three requests over TLS (phase 5's tokens), three
   rounds in turns with plaintext, 1 MiB byte echoes per second over TLS
   beside plaintext, and a plaintext client failing against the TLS port;
   (c) four (1, 512, 16) Generates in flight from one thread through
   ``call_method(done=)`` and ``join`` against the same four blocking, a
   ``start_cancel`` ending a call ``ECANCELLED``, and an async handler
   (``begin_async``, finished on another thread) over tpu_std, HTTP and
   gRPC; (d) ``DeviceBlockPool(device="cuda")``: 1 MiB and 64 MiB landed,
   recycled and landed again (``data_ptr`` steady, ``recycled`` 1 per
   size, ``pooled_bytes`` back to 0), every landing's checksum through
   ``checksum.cu`` equal to the host's, a recycle over the cap dropped,
   and land GB/s beside a fresh ``torch.empty(...).copy_``;
   17. the native C++ IO engine (``brpc_tpu_torch/native``, built with
   g++ into ``native/_build/``; the phase fails if it does not load or
   if its bridge owns no connection) serving phase 5's service on
   ``Server(native=True)``: (a) phase 5's three Generates on the engine,
   in turns with the Python server, three rounds, with
   ``usercode_inline`` off (the classic lane on a fiber) and on (the
   kind-3 slim lane): phase 5's tokens, ``flash_fwd`` depth a request,
   host ms per shape for both lanes; (b) 6b's eight Decode streams on
   the kind-5 lane against the Python stream lane of the same server
   (``rpc_native_stream_lane`` flipped between runs, native, Python,
   Python, native): tokens equal between the lanes and to the solo
   generator under the near-tie rule, aggregate tok/s, median and max
   TTFT, the round's emit ms (``PH_STREAM_EMIT``); (c) phase 13 (c)'s
   method cap of 2 on the engine (one loop per connection) and on the
   Python server: four refusals one after another and four at once
   while the two capped Generates run, ``ELIMIT`` ms each, no launch
   for a refused call; (d) two replicas of phase 5's weights, each on a
   server of its own, on the engine and on the Python transport: two
   Generates side by side against the two in turn, over RPC; (e) 1 MiB
   device echoes of the full-width EmbeddingPS on the engine against
   the Python server, in turns: calls/s, two ``checksum.cu`` launches a
   call, every echo zero-copy, no live descriptor left (the TICI acks
   come back through the engine); (f) a drain during four Decode
   streams on the kind-5 lane of a paged service: drain ms, every stream
   closed ``lame_duck``, no page left, and the lame-duck TLV on a
   response the engine built itself (a kind-0 echo) beside the
   ``ELAMEDUCK`` refusal of a new Generate;
   18. the client on the engine: phase 5's Generates on ``"pooled"`` and
   ``"short"`` (the fast lane's ``sync_call``) beside ``"single"`` (the
   client lane), ``call_batch``, a ``scatter_call`` fan-out, 6b's
   streams on one shared connection, device echoes on the fast lane
   against the Controller path, ``call_raw``, a drain and a revival;
   19. the Python transport on the event dispatcher (a default
   ``Server``: an ``Acceptor``, the dispatcher's consumer fibers, one
   ``InputMessenger``; the phase fails if a default server has no
   acceptor or any thread named for one connection exists): (a) phase
   5's Generates on phase 5's default server over ``"single"`` and
   ``"pooled"``, in turns with ``Server(native=True)``: phase 5's
   tokens, ``flash_fwd`` depth a request, host ms per shape; 16 more
   connections add no thread each; (b) 6b's eight Decode streams on one
   shared ``"single"`` connection: the solo generator's tokens under the
   near-tie rule, aggregate tok/s and TTFT beside 6b's and phase 17's
   kind-5 lane; (c) four Generates at once on one connection, each equal
   to its request alone, with the messenger's inline and spawned counts;
   (d) 200 1 MiB device echoes of the full-width EmbeddingPS on a
   default server: two ``checksum.cu`` launches an echo, zero-copy, no
   live descriptor, calls/s beside phase 17's engine; (e) phase 16's TLS
   Generates and 1 MiB TLS echoes from four writer threads on one
   connection, with no SSL error; (f) RESP and thrift on the LM's own
   port, on both transports, while a Generate runs: the answers and the
   Generate's tokens; (g) a drain during four paged Decode streams: no
   connection and no page left, and a connection made during the drain
   served from the backlog once ``start`` ends the drain;
   20. the operability and tooling layer on phase 5's service, on a
   default server and on the engine: (a) ``rpc_press`` drives
   ``LM.Generate`` (1, 512, 16) on pooled connections flat out for 5 s,
   then at half the rate it reached for 5 s (sent, no error, calls/s,
   p50 and p99, every answer the server gave equal to the request
   alone, ``flash_fwd`` depth a call); (b) ``rpc_dump`` on while 16 Generates
   run on the engine (each counted ``rpc_dispatch_off``, the engine's
   native dispatch off), then off (nothing counted, the slim lane
   again), the dump read back by ``DumpReader`` (16 frames) and replayed
   by ``Replayer`` into the default server (no error, each answer the
   captured call's); (c) hot restart in one process, on each transport:
   a client calls Generate on fresh connections without pause while the
   predecessor exports its listeners, a successor starts with
   ``inherit_from=`` on the same port and the predecessor drains and
   stops (no failed call, no refused connect, no call lost; a call the
   predecessor refused before running it -- answered ``ELAMEDUCK`` or
   ``ELOGOFF``, or its connection closed unanswered -- is sent again on
   a new connection, and counted; each attempt carries its own tag, and
   a call sent again that a server ran, or one the predecessor ran and
   never answered, is lost; the ms from the export to the successor's
   first answer, the calls each answered); (d) the same
   across processes: a child process builds ``SLICE_CFG`` from seed 0,
   takes the listener over and serves phase 5's tokens while the parent
   drains and stops; (e) the portal tools against the phase's servers:
   ``parallel_http`` reads ``/vars`` from each, ``rpc_view``'s proxy
   serves ``/status`` with its links rewritten, ``trace_dump`` gets a
   traced Generate's Chrome JSON (a client and a server span), and
   ``start_trackme`` pings ``/trackme`` until ``stop_trackme``;
   6e. serve the MoE LM (``MOE_CFG``: the same widths, 8 top-2 experts,
   2.32 B params): Info and two Generate requests, one profiled request,
   the prefill logits through the kernel against dense attention with
   the share of (token, layer) top-2 sets routed alike (every flip
   printed with its router margin), ``forward_grouped`` on the card
   against the CPU (equal routing, close output), 6b's eight Decode
   streams and one profiled round, four paged sessions with 256-token
   chunks, two sessions over the ici lane with the monolithic tokens;
8. train that LM at full width (``make_train_step``, remat, gradient
   accumulation): one step's loss and gradient through the kernels
   against dense attention, then a falling finite loss over 4 steps with
   the kernels' launch counts read around every step, step time, tokens/s
   and model FLOP/s, and one more step under ``torch.profiler`` (the
   kernels in its trace, the device busy share);
9. round-trip the trained parameters through ``TrainCheckpointer``;
   8m. train the MoE LM (remat, accum 1 x 2 x 2048): the loss through the
   kernels against dense attention, the gradient too with the dense arm
   replaying the kernel arm's expert choices (its distance with its own
   routing reported), a falling loss over 1 + 2 steps with 16 / 8 / 8
   launches a step, step time, tokens/s, peak memory and one profiled
   step;
11. the parallel paths at world size one, one NCCL process group (a
    rendezvous file under the run's temp dir): (a) every MeshTransport
    method on the card against JAX's n = 1 results; (b) the dp x tp train
    step at phase 8's params and batch against the unsharded step (loss,
    new params, bit-equality), 32 / 16 / 16 launches a step, step ms
    beside phase 8's and one profiled step; (c) the sp forward (ring
    attention) at (1, 2048) against dense attention; (d) Ulysses over the
    flash kernel at (4, 2048, 16, 128): one launch a call, the output
    against the plain version, its ms beside a bare flash_attention call;
    (e) one MoE dp x tp (+ep) step against 8m's loss; (f)
    ``dryrun_multichip(world=1, device="cuda")``; (g)
    ``multiproc_dryrun.run``: a gloo PS step across two processes on the
    CPU, then device echoes on the card over ``KIND_TRANSFER``,
    checksummed on both ends; (h) ``profiling.collect_device_trace``
    around (b)'s step (the Chrome trace names the flash kernels); (i)
    dense attention against the flash kernel over s = 128 ... 2048, the
    table that sets ``DENSE_FLASH_CROSSOVER``;
10. serve the full-width EmbeddingPS (``PSConfig()``) through the port's
    Server, PSService and Channel: Stat, a (256, 16) Lookup against
    ``embedding_bag`` on the card, Predict, 20 Train calls (labels as a
    device attachment, then as bytes) with a falling loss, 1 MiB device
    echoes (the first request inline, then zero-copy descriptors; calls
    per second over 200), a 64 MiB zero-copy echo and its inline
    refusal; every echo checksums the payload before the send and after
    the landing; the checksum launch count equals the calls made, one
    profiled echo shows the kernel twice, and the fabric ends empty;
    10x. the same EmbeddingPS in a child process on the same card (it
    imports only ``brpc_tpu_torch``), ``ici_transfer_enabled`` on in both:
    Stat, Lookup, Predict and Train as in 10, 200 1 MiB echoes and one
    of 64 MiB over the CUDA IPC transfer lane (every device leg
    ``KIND_TRANSFER`` with no inline byte; each payload the output of a
    kernel launched just before its call, three of them queued behind a
    ~50 ms spin so that the child's read is right only if it waits on the
    post's event; the checksum kernel on both ends, the sums equal; no
    live descriptor in either process), then the
    same echoes inline between the same processes for comparison;
    10s. 1 MiB byte echoes between the two processes over the shm data
    plane, on and off in turns (the lane engaged, the child's answers
    re-describing our slots, every slot back);
7. print the kernels' JSON line, then the result line.
"""

from __future__ import annotations

import http.client
import itertools
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import io
import tarfile
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from brpc_tpu_torch.butil.flags import get_flag, set_flag  # noqa: E402
from brpc_tpu_torch.butil.status import Errno  # noqa: E402
from brpc_tpu_torch.butil.endpoint import parse_endpoint  # noqa: E402
from brpc_tpu_torch import deadline  # noqa: E402
from brpc_tpu_torch.client import (  # noqa: E402
    Channel, ChannelOptions, Controller, start_cancel)
from brpc_tpu_torch.ici import DeviceBlockPool  # noqa: E402
from brpc_tpu_torch.ici.endpoint import live_endpoints  # noqa: E402
from brpc_tpu_torch.ici import cuda_ipc  # noqa: E402
from brpc_tpu_torch.ici.attachment import (  # noqa: E402
    KIND_INLINE, KIND_TRANSFER)
from brpc_tpu_torch.ici.fabric import (  # noqa: E402
    in_process_fabric, transfer_fabric)
from brpc_tpu_torch.kv import (  # noqa: E402
    DecodeTierService, KvTransport, PrefillService, kv_fallback_counters,
    kv_stats, outstanding_pages)
from brpc_tpu_torch.kv.transport import (  # noqa: E402
    LANE_COPY, LANE_SHM, SessionManifest, decode_manifest, encode_manifest,
    import_pages)
from brpc_tpu_torch.kv.pages import (  # noqa: E402
    HostPagePool, host_inflight_spills, prefix_event_counters)
from brpc_tpu_torch import profiling, rpcz_stitch  # noqa: E402
from brpc_tpu_torch.bvar import find_exposed, render_prometheus  # noqa
from brpc_tpu_torch.models import lm_telemetry, moe  # noqa: E402
from brpc_tpu_torch.models.embedding_ps import EmbeddingPS, PSConfig  # noqa
from brpc_tpu_torch.models.lm_service import (  # noqa: E402
    LMService, bucketed_prefill, pack_generate_request, sched_counters,
    spec_counters, unpack_generated, unpack_token)
from brpc_tpu_torch.models.ps_service import PSService, pack_ids  # noqa
from brpc_tpu_torch.models.transformer_lm import (  # noqa: E402
    LMConfig, empty_batch_cache, empty_paged_cache, export_decode_cache,
    init_params, kv_page_specs, make_batch_decode, make_decode,
    make_forward, make_paged_batch_decode, make_paged_io,
    make_paged_spec_verify, make_train_step, make_value_and_grad,
    paged_page_bytes, tree_leaves)
from brpc_tpu_torch.ops import cuda_build  # noqa: E402
from brpc_tpu_torch.ops.device_ops import (  # noqa: E402
    CHECKSUM, checksum_u32, checksum_u32_plain, checksum_words_plain,
    embedding_bag)
from brpc_tpu_torch.ops.flash_attention import (  # noqa: E402
    DENSE_FLASH_CROSSOVER, FLASH_DKDV, FLASH_DQ, FLASH_FWD, KERNELS,
    attention_delta, dense_attention, flash_attention,
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_plain)
from brpc_tpu_torch.parallel import (  # noqa: E402
    MeshTransport, make_mesh, multiproc_dryrun)
from brpc_tpu_torch.parallel.multiproc_dryrun import (  # noqa: E402
    dryrun_multichip)
from brpc_tpu_torch.parallel.ring_attention import (  # noqa: E402
    make_ulysses_attention)
from brpc_tpu_torch.parallel.spmd import init_world  # noqa: E402
from brpc_tpu_torch.protocol.meta import (  # noqa: E402
    TLV_TIMEOUT, CompressType, RpcMeta)
from brpc_tpu_torch.protocol.tpu_std import (  # noqa: E402
    MAX_BODY_SIZE, AckFrame, max_body_size, pack_frame, read_frame,
    unpack_frame)
from brpc_tpu_torch.rpcz import global_span_store  # noqa: E402
from brpc_tpu_torch.server import (  # noqa: E402
    Server, Service, admission, method, raw_method)
from brpc_tpu_torch.server.server import (  # noqa: E402
    DRAIN_FORCE_CLOSE_REASON, ServerOptions)
from brpc_tpu_torch.streaming import StreamOptions, stream_create  # noqa
from brpc_tpu_torch.transport import shm_ring  # noqa: E402
from brpc_tpu_torch.transport.socket import Socket  # noqa: E402
from brpc_tpu_torch.transport.socket_map import (  # noqa: E402
    global_socket_map, pooled_socket, return_pooled_socket, socket_pool_of)
from brpc_tpu_torch.transport import client_lane, health_check  # noqa
from brpc_tpu_torch.client import fast_call  # noqa: E402
from brpc_tpu_torch.client.redis_client import RedisClient  # noqa: E402
from brpc_tpu_torch.protocol.resp import RedisError  # noqa: E402
from brpc_tpu_torch.protocol.thrift_proto import (  # noqa: E402
    TBinary, ThriftClient)
from brpc_tpu_torch.transport.input_messenger import (  # noqa: E402
    messenger_counters)
from brpc_tpu_torch.tools import rpc_view  # noqa: E402
from brpc_tpu_torch.tools.parallel_http import parallel_fetch  # noqa: E402
from brpc_tpu_torch.tools.rpc_dump import DumpReader, close_dump  # noqa
from brpc_tpu_torch.tools.rpc_press import Press, PressOptions  # noqa: E402
from brpc_tpu_torch.tools.rpc_replay import (  # noqa: E402
    ReplayOptions, Replayer)
from brpc_tpu_torch.tools.rpc_view import (  # noqa: E402
    ViewProxy, fetch_raw)
from brpc_tpu_torch.tools.trace_dump import fetch_trace  # noqa: E402
from brpc_tpu_torch.trackme import start_trackme, stop_trackme  # noqa
from brpc_tpu_torch.utils.checkpoint import (  # noqa: E402
    TrainCheckpointer, abstract_like)

# The widest LM the repo runs (bench.py's training section), served with
# the flash kernel on the prefill path.  Head dim 128, ~436 M parameters.
SLICE_CFG = dict(vocab=8192, dim=2048, heads=16, depth=8, max_seq=2048,
                 mlp_mult=4, use_flash=True, remat=False)
MAIN_SHAPE = (1, 1024, 16, 128)          # full-width prefill, one request
CHECK_SHAPES = [MAIN_SHAPE, (2, 1000, 16, 128), (1, 129, 4, 64),
                (1, 40, 2, 16)]
# kernel vs plain: f32 out and lse within 1e-4 abs and rel (both sum in
# f32, in another order); bf16 within 2e-2 (one bf16 rounding of out).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4
# prefill logits, flash kernel vs dense attention: the attention outputs
# agree to ~1e-6, but each of the 33 bf16 weight products after them can
# round an element the other way (2**-8 of its size), and 8 layers carry
# that on: the logits are held to 2e-2 of the largest |logit|
LOGIT_RTOL = 2e-2
REQUESTS = [(1, 1024, 32), (1, 1500, 64), (2, 512, 16)]
# LM.Decode (phase 6b): the service's 8 slots, eight sessions with prompt
# lengths drawn from [256, 1500] (seed 5) and 64 new tokens each, one
# client thread each, started DECODE_STAGGER_S apart so that they join
# while others are mid-stream; then two sessions through a service with
# 256-token prefill chunks
DECODE_SLOTS = 8
DECODE_PROMPT_LENS = (256, 1500)
DECODE_MAX_NEW = 64
DECODE_STAGGER_S = 0.1
DECODE_TIMEOUT_S = 300.0
CHUNK_TOKENS = 256
CHUNK_PROMPT_LENS = (700, 1300)
# LM.Decode through the paged batcher (phase 6c).  A 16-token page holds
# 2 * 8 layers * 16 * 2048 f32 = 2 MiB of k/v at SLICE_CFG, 128 per slot.
PAGE = 16
# (a) 16 slots on the pool bytes of 6b's 8 contiguous slots (+1: page 0,
# the garbage page), a 512 MiB host tier; 6b's eight prompts and eight
# more drawn the same way from seed 7
PAGED_SLOTS = 16
PAGED_POOL = DECODE_SLOTS * (2048 // PAGE) + 1
HOST_SLOTS = 256
# (b) four prompts of 1073 tokens sharing their first 1024: 67-page
# contexts, 64 pages shared
PREFIX_HEAD, PREFIX_PROMPT = 1024, 1073
# (c) four 1000-token sessions need 4 x 67 pages, the pool has 256 usable
SPILL_SLOTS, SPILL_POOL, SPILL_PROMPT = 4, 2 * (2048 // PAGE) + 1, 1000
# (d) k = 3 proposals a round from the target itself as its draft
SPEC_K, SPEC_SLOTS, SPEC_PROMPT_LENS = 3, 4, (256, 1024)
# the paged step against the contiguous step: slots moved through the host
# tier to spare pages between the two compared steps
EXACT_MOVED = 2
# LM.Decode disaggregated (phase 6d): a session's pages are the k and v of
# 8 layers, (1, 2048, 16, 128) f32 each: 16 x 16 MiB.  The copy lane's
# attachment needs the frame cap raised from its 64 MiB default; the
# paged decode tier takes four of 6b's prompts
DISAGG_SESSION_BYTES = 268_435_456
DISAGG_COPY_CAP = 512 * 1024 * 1024
DISAGG_PAGED_SESSIONS = 4
# 6d (e): the shm lane stages each 16 MiB page in a slot of this process's
# ring, so the ring is rebuilt with 16 MiB slots; 16 hold one session, and
# 6b's staggered sessions overlap their handoffs (with 16, three of eight
# found the ring full in one run: kv_ring_exhausted), so it holds all
# eight at once: 128 slots, 2 GiB
KV_SHM_SLOT_BYTES = 16 * 1024 * 1024
KV_SHM_SLOTS = DECODE_SLOTS * 2 * SLICE_CFG["depth"]
# the prefill tiers of 6d on one Server: lane, strict, and the decode tier
DISAGG_PREFILL = {"Prefill": (None, False, "dec"),
                  "PrefillCopy": ("copy", False, "dec"),
                  "PrefillShm": ("shm", False, "dec"),
                  "PrefillStrict": ("copy", True, "dec"),
                  "PrefillPaged": (None, False, "dec_paged")}
# Phase 12: traced calls on the serving phases' services, and the observer
# effect by bench.py's methods (bench.py:1520-1626: 5 rounds of 6
# sessions x 32 tokens an arm; bench.py:2178-2259: 7 rounds of 0.4 s
# arms), cut to 4 sessions x 16 tokens an arm and 5 rounds of 0.25 s
# echo arms, so that (f) with its third pair takes under 20 s
TRACE_GENERATE = 3                 # traced (1, 1024, 32) Generate calls
TRACE_DECODE_PROMPT = 1024
OBS_ROUNDS = 5
OBS_SESSIONS = 4
OBS_PROMPT = 64
OBS_NEW = 16
ECHO_ROUNDS = 5
ECHO_ARM_S = 0.25
# Phase 13, the overload and drain planes on the same services: (a) the
# queued call's budget, under a (1, 1024, 32) Generate's handler time;
# (b) bench.py:2258-2400's paired A/B, cut from its native slim lane's
# 2 ms handler and bursts of 24 to bursts of 4 Generate (1, 512, 8) on
# one connection with budgets of 2.5 L (at 2 L the second call of a
# burst ends on its deadline), 3 rounds of 1.5 s arms; (c) a
# method cap of 2 under 6 calls, an "auto" burst of 16 small calls, a
# fair capacity of 2 with one tenant flooding 4; (d) 6c (c)'s four
# 1000-token sessions and four of 256 tokens (eight of 1000 spill in
# cascade on the 4-slot pool until a late join finds the 256-page host
# tier full), 128 new tokens each, 20 ms apart, so none ends before the
# drain, drained with a 5 s grace; then a 200 ms grace outlasted; (e) a
# 50 ms backup
SHED_BUDGET_MS = 100
GOODPUT_REQUEST = (1, 512, 8)
GOODPUT_K = 4
GOODPUT_BUDGET_L = 2.5
GOODPUT_ROUNDS = 3
GOODPUT_ARM_S = 1.5
ADMIT_CAP, ADMIT_CALLS = 2, 6
AUTO_BURST, AUTO_REQUEST = 16, (1, 128, 4)
TENANT_CAPACITY, TENANT_FLOOD = 2, 4
DRAIN_STREAMS, DRAIN_GRACE_MS, HOLD_GRACE_MS = 8, 5000, 200
DRAIN_STAGGER_S, DRAIN_MAX_NEW, DRAIN_SHORT_PROMPT = 0.02, 128, 256
BACKUP_MS = 50
# Phase 14, the LM across replicas: two paged replicas of phase 5's
# weights (4 slots each, the default pool: 513 pages of 2 MiB), each on a
# Server of its own, in this process on the one card.  (a) four (1, 1024,
# 32) Generates through "rr", then LA_CALLS of GOODPUT_REQUEST through
# "la" beside a (1, 1500, 64) loop on A; (b) 6c (b)'s five sessions
# through "c_murmurhash" (request code: a hash of the head), then five on
# a second head through "rr"; (c) a (1, 1024, 32) call pinned to A (busy
# with a (1, 1500, 64)) with a 50 ms backup; (d) a ParallelChannel over A
# and B, a SelectiveChannel with a dead sub-channel; (e) "list://A,<dead
# port>" with the breaker; (f) a registry and reporters every 0.2 s; (g)
# two client threads looping GOODPUT_REQUEST over a file:// list while A
# drains with a 2 s grace
CLUSTER_SLOTS = 4
LA_CALLS = 6
BUSY_REQUEST = (1, 1500, 64)
FLEET_INTERVAL_S = 0.2
CLUSTER_DRAIN_GRACE_MS = 2000
CLUSTER_DRAIN_LEAD_S, CLUSTER_DRAIN_TAIL_S = 0.5, 0.5
TIMING_REPS = 20
# the dense/flash crossover (phase 11 (i)): prefill lengths, b = 1
CROSSOVER_SEQS = (128, 256, 512, 768, 1024, 1536, 2048)
# phase 11 (c): the sp forward against dense attention.  Held as phase 6
# holds the kernel's prefill logits against dense attention's (LOGIT_RTOL
# of the largest |logit|): the two attentions agree to ~1e-6, but at this
# width and depth a bf16 product downstream can round the other way.  The
# share of logits outside the JAX ring test's elementwise tolerance
# (tests/test_transformer_lm.py: rtol 3e-2, atol 8e-3, set on a 2-layer,
# dim-32 model) is reported beside it
SP_RTOL, SP_ATOL = 3e-2, 8e-3
# phase 11 (h): the device trace's window
TRACE_SECONDS = 2.0
# profiles of one echo until the trace holds both checksum kernels (the
# trace has dropped the first one's events; the launch counter has not)
ECHO_PROFILE_ATTEMPTS = 3
# short spin kernels that open each profiler trace (trace_preroll): a
# trace's first device records can go missing
PREROLL_SPINS = 64
# calls per CUDA-event pair when timing the forward kernel and SDPA: one
# call per pair let the host's launch cost (the wrapper, ~20-40 us) into a
# ~0.2 ms prefill-shape time, by as much as the host was slow (0.186 and
# 0.214 ms on an H100 for 0.168 ms of device time in the phase 6 profile)
FWD_TIMING_INNER = 10

# Training: bench.py's train-step config (bench.py:3247-3248) letter for
# letter.  Reduced: the batch, from bench.py's ACC=8 x B=32 x S=2048
# (bench.py:3252) to accum=2 x microbatch 4 x 2048 tokens, because the
# first kernels are simple f32 kernels and a bench-sized step would take
# minutes.  Widths, depth and sequence length are whole.
TRAIN_CFG = dict(SLICE_CFG, remat=True)
TRAIN_ACCUM, TRAIN_MICRO, TRAIN_SEQ = 2, 4, 2048
TRAIN_SHAPE = (TRAIN_MICRO, TRAIN_SEQ, 16, 128)   # attention's (b, s, h, d)
TRAIN_STEPS = 3                                   # timed, after 1 warm-up
# Plain SGD from init_params at this width makes the loss rise over the
# first steps at bench.py's lr (LMConfig's default 0.05) and still at 0.01
# on the H100; at 0.002 it falls at every step, which phase 8 checks.
TRAIN_LR = 0.002
# MoE serving and training (phases 6e, 8m): SLICE_CFG with its MLP swapped
# for the repo's MoE FFN (models/moe.py): 8 experts as wide as the dense
# MLP (hidden 8192), top-2 routing as GShard and Mixtral of Experts
# (arXiv:2401.04088: 8 experts, top-2), but with the repo's two-matrix
# GELU experts, not Mixtral's SwiGLU.  About 2.32 B params, 9.3 GB in f32;
# nothing is cut for serving
MOE_CFG = dict(SLICE_CFG, moe_experts=8, moe_top_k=2, moe_capacity=2.0,
               moe_aux_weight=0.01)
MOE_REQUESTS = [(1, 1024, 32), (2, 512, 16)]
# (4) four of 6b's prompts through a paged service with 256-token prefill
# chunks; (5) two of them handed off over the ici lane
MOE_PAGED_SESSIONS = 4
MOE_DISAGG_SESSIONS = 2
# the card's forward_grouped against the CPU's on one layer's weights: a
# (1, 2048, 2048) input drawn until every token's sorted router
# probabilities, down to the third, lie MOE_ROUTE_MARGIN apart (the two
# devices' f32 routers differ by ~1e-7, so no choice can flip); the
# output within MOE_OUT_TOL of its largest |value| (the bf16 expert
# products of the two devices may round an element the other way)
MOE_GROUP_SHAPE = (1, 2048, 2048)
MOE_ROUTE_MARGIN = 1e-5
MOE_OUT_TOL = 1e-2
# training: the batch cut from bench.py's ACC=8 x B=32 x 2048 to accum 1 x
# microbatch 2 x 2048 (9.3 GB of f32 params, as much again in gradients
# and in the new params); widths and depth whole.  The loss through the
# kernels is held to DENSE_LOSS_RTOL of the loss through dense attention,
# and the gradient to DENSE_GRAD_REL_NORM with the dense arm replaying the
# kernel arm's expert choices (moe.pinned_routing); the gradient with the
# dense arm's own routing is reported, not held: a routing choice that
# flips between the two runs moves a token's gradient to another expert
MOE_TRAIN_CFG = dict(MOE_CFG, remat=True)
MOE_TRAIN_ACCUM, MOE_TRAIN_MICRO, MOE_TRAIN_STEPS = 1, 2, 2
# scan_layers (phase 5s): SLICE_CFG's weights stacked, int8, Generate only
SCAN_CFG = dict(SLICE_CFG, scan_layers=True)
SCAN_REQUEST = (1, 1024, 32)
# flash_dkdv has one schedule per dtype (csrc/flash_bwd.cu DkdvCfg), which
# the training shape takes; (1, 77, 2, 20) has bf16 rows that are not
# whole 16-byte pieces (the per-element loads) and a ragged head dim
BWD_CHECK_SHAPES = [TRAIN_SHAPE, MAIN_SHAPE, (2, 1000, 16, 128),
                    (1, 129, 4, 64), (1, 40, 2, 16), (1, 77, 2, 20)]
# the f32 forward picks its schedule by grid size (flash_fwd.cu launch):
# on an H100 the training shape takes Wide, (2, 1000, 16, 128) Narrow and
# the others KSplit, so each is checked
CHECK_SHAPES.append(TRAIN_SHAPE)
# the MoE train step's attention (phase 8m)
MOE_TRAIN_SHAPE = (MOE_TRAIN_MICRO, TRAIN_SEQ, 16, 128)
CHECK_SHAPES.append(MOE_TRAIN_SHAPE)
BWD_CHECK_SHAPES.insert(1, MOE_TRAIN_SHAPE)
# past the training length, f32 causal only, at the unchanged BWD_TOL: the
# 3xTF32 split truncates lo (flash_mma.cuh split_tf32_fast), so dk and dv
# sum more truncated terms as s grows.  b = 1 at 8192 keeps the plain
# version's (b, h, s, s) f32 scores at 4 GiB
BWD_LONG_SHAPES = [(4, 4096, 16, 128), (1, 8192, 16, 128)]
# and every shape the serving paths give it: Generate prefills each
# request's prompt as it is; Decode prefills a join's context (the prompt
# less its last token, 255-1499 here) padded to a power-of-two bucket,
# 256-2048 (lm_service.bucketed_prefill); the paged Decode of phase 6c,
# target and draft alike, prefills its contexts (255-1499) in the same
# buckets
for _b, _s, _ in REQUESTS:
    CHECK_SHAPES.append((_b, _s, 16, 128))
for _k in range((DECODE_PROMPT_LENS[0] - 2).bit_length(),
                (DECODE_PROMPT_LENS[1] - 2).bit_length() + 1):
    CHECK_SHAPES.append((1, 1 << _k, 16, 128))
CHECK_SHAPES = list(dict.fromkeys(CHECK_SHAPES))
# backward kernels vs the plain backward: |err| <= rtol * |ref| + afrac *
# max|ref|.  f32: both sum in f32 in another order (2e-4, 2e-5); bf16: ds
# and p are rounded to bf16 before their products and one rounding can
# flip with the order of dp's sum (3e-2, 3e-2).
BWD_TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (3e-2, 3e-2)}
# one train step through the kernels vs through dense attention, at the
# initial params: the attention outputs agree to ~1e-6, but every weight
# product after them rounds to bf16 and can round an element the other
# way; the loss is held to 1e-3 relative and the whole gradient to
# ||dg|| / ||g|| <= 1e-2 (2.0e-3 measured on the H100)
DENSE_LOSS_RTOL = 1e-3
DENSE_GRAD_REL_NORM = 1e-2
# Head dims past 128 (phases 3w, 4w, 5w).  The kernels pad 129-256 to 256.
# The wide LM is SLICE_CFG with half its heads, so its head dim is 256,
# Gemma 7B's and Gemma 2's head_dim; depth cut from 8 to 4 to keep the
# run's time.  It serves through attn_impl="auto" (use_flash off), which
# takes the kernel from DENSE_FLASH_CROSSOVER tokens on, so every prompt
# is at least that long; it trains with use_flash=True, remat, accum 1 x
# TRAIN_MICRO x TRAIN_SEQ
WIDE_CFG = dict(SLICE_CFG, heads=8, depth=4, use_flash=False,
                attn_impl="auto")
WIDE_TRAIN_CFG = dict(WIDE_CFG, use_flash=True, remat=True)
WIDE_REQUESTS = [(1, 1024, 16), (1, 300, 16), (2, DENSE_FLASH_CROSSOVER, 8)]
# the forward timed at the prefill shape, dq and dkdv at the training
# shape: the same FLOPs as MAIN_SHAPE's and TRAIN_SHAPE's (half the heads,
# twice the head dim), so the bounds are theirs
WIDE_FWD_SHAPE = (1, 1024, 8, 256)
WIDE_TRAIN_SHAPE = (TRAIN_MICRO, TRAIN_SEQ, 8, 256)
# (shape, offset): each width f32 and bf16, causal and not; an offset puts
# q, k, v and do that many elements into a wider projection, so that rows
# are not 16-byte aligned and the kernels take the per-element loads
WIDE_CHECK_CASES = [((1, 129, 4, 136), 0), ((2, 77, 2, 136), 1),
                    ((1, 300, 4, 192), 0), ((1, 100, 3, 192), 1),
                    (WIDE_FWD_SHAPE, 0), (WIDE_TRAIN_SHAPE, 0),
                    ((1, 77, 2, 256), 1)]
for _b, _s, _ in WIDE_REQUESTS:
    WIDE_CHECK_CASES.append(((_b, _s, 8, 256), 0))
WIDE_CHECK_CASES = list(dict.fromkeys(WIDE_CHECK_CASES))
# past the kernels' limit: raises on the card, no fallback
TOO_WIDE = 264
# the large device payload: one f32 (4, 2048, 2048) activation, the size
# of a block's remat input at the training shape (64 MiB, the frame cap:
# it can travel only device-resident)
CHECKSUM_BYTES = TRAIN_MICRO * TRAIN_SEQ * 2048 * 4
# checksum payload sizes in 32-bit words besides the 64 MiB one
CHECKSUM_WORDS = (0, 1, 127, 8 * 128 + 5, 1000, 2**20 + 3)
CHECKSUM_INNER = 20
# the parameter server: the model family's own defaults, full width
PS_CFG = PSConfig()
PS_BATCH = (256, PS_CFG.slots)
PS_TRAIN_CALLS = 20                   # 10 with device labels, 10 as bytes
ECHO_BYTES = 1 << 20                  # bench.py's device echo payload
ECHO_CALLS = 200
# Phases 10x and 10s: the same service in a child process on the same card
# (tests/test_ici_xfer.py's child server, bench.py:557-651's interleaved
# shm/byte echoes).  The child imports only brpc_tpu_torch; its port is
# read on a thread, bounded by CHILD_START_S
CHILD_START_S = 180.0
INLINE_ECHO_CALLS = 50                # the inline lane, for comparison
INLINE_CAP = 160 * 1024 * 1024        # frames for the inline 64 MiB echo
SHM_ROUNDS = 5                        # shm on / off, order alternating
SHM_BLOCK = 40                        # 1 MiB echoes per arm and round
IPC_STEP_REPS = 50                    # each transfer step timed alone
# 10x's held echoes: the payload's kernel is queued behind a spin of
# HOLD_CYCLES (about 50 ms on an H100) on the posting stream, so the child
# reads the right bytes only if it waits on the post's event
HELD_ECHOES = 3
HOLD_CYCLES = 100_000_000
XPROC_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from brpc_tpu_torch.butil.flags import set_flag
from brpc_tpu_torch.butil.status import Errno
from brpc_tpu_torch.ici import cuda_ipc
from brpc_tpu_torch.ici.fabric import in_process_fabric, transfer_fabric
from brpc_tpu_torch.models.embedding_ps import EmbeddingPS, PSConfig
from brpc_tpu_torch.models.ps_service import PSService
from brpc_tpu_torch.ops.device_ops import CHECKSUM, checksum_u32
from brpc_tpu_torch.server import Server, Service
from brpc_tpu_torch.transport import shm_ring

assert set_flag("ici_transfer_enabled", True)


def leg(cntl):
    att = cntl.request_device_attachment
    return {"kind": att.kind if att is not None else None,
            "inline": len(cntl.request_attachment)}


class CheckedPS(PSService):
    # the echo checksums what landed here and reports the request's leg
    def EchoTensor(self, cntl, request):
        if cntl.request_device_attachment is None:
            cntl.set_failed(Errno.EREQUEST, "no device attachment")
            return None
        info = leg(cntl)
        t = cntl.request_device_attachment.tensor(self.model.device)
        cntl.response_device_attachment = t
        info["sum"] = checksum_u32(t)
        return json.dumps(info).encode()

    def Train(self, cntl, request):
        info = leg(cntl)
        out = super().Train(cntl, request)
        if out is None:
            return None
        return json.dumps(dict(json.loads(out), **info)).encode()


class Ctl(Service):
    def Stats(self, cntl, request):
        f = transfer_fabric()
        return json.dumps({
            "live": f.live_descriptors if f is not None else None,
            "address": f.address.decode() if f is not None else None,
            "inproc_live": in_process_fabric().live_descriptors,
            "checksum_launches": CHECKSUM.launches,
            "shm": shm_ring.shm_stats(),
            "shm_fallbacks": {k: v for k, v in
                              shm_ring.shm_fallback_counters().items() if v},
            "tx_outstanding": shm_ring.outstanding_tx_slots(),
            "foreign": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "brpc_tpu"))}
        ).encode()

    def Flag(self, cntl, request):
        name, value = json.loads(request)
        if not set_flag(name, value):
            cntl.set_failed(Errno.EREQUEST, f"flag {name} refused {value!r}")
            return None
        return b"ok"

    def Bytes(self, cntl, request):
        cntl.response_attachment = cntl.request_attachment
        return b"ok"

    def Export(self, cntl, request):
        # a 1 MiB tensor exported by hand, for the parent to time pulls
        self.held = torch.arange(int(request), dtype=torch.float32,
                                 device="cuda")
        self.exp = cuda_ipc.export(self.held)
        return json.dumps({"handle": self.exp.mem_handle.hex(),
                           "offset": self.exp.offset,
                           "event": self.exp.event_handle.hex()}).encode()

    def Release(self, cntl, request):
        cuda_ipc.destroy_event(self.exp)
        self.held = self.exp = None
        return b"ok"


srv = Server()
srv.add_service(CheckedPS(EmbeddingPS(PSConfig(), device="cuda", seed=0)),
                name="PS")
srv.add_service(Ctl(), name="Ctl")
assert srv.start("127.0.0.1:0") == 0
print(f"PORT={srv.listen_endpoint.port}", flush=True)
sys.stdin.readline()            # the parent closes stdin to stop us
srv.stop()
"""

# Published dense peaks (NVIDIA data sheets): f32 outside the tensor
# cores, tf32 and bf16 on the tensor cores, and HBM bandwidth.
PEAKS = {"sxm": {"f32": 67e12, "tf32": 495e12, "bf16": 989e12,
                 "bytes": 3.35e12},
         "pcie": {"f32": 51e12, "tf32": 378e12, "bf16": 756e12,
                  "bytes": 2.0e12}}
# The f32 flash kernels run every product as three tf32 MMAs (3xTF32,
# csrc/flash_mma.cuh): their tensor-core bound is 3 x FLOPs / tf32 peak,
# beside the f32 FMA bound.
TF32_PASSES = 3
# SDPA's backward computes dq, dk and dv in one call; its time is split
# between flash_dq and flash_dkdv by their FLOPs, 6 : 8 per head dim per
# live pair, for each kernel's ratio to the library call.
BWD_LIBRARY_SHARE = {"flash_dq": 6 / 14, "flash_dkdv": 8 / 14}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_report(log: str) -> list:
    """``(kernel, registers, spill store bytes, spill load bytes)`` of
    each function in an ``nvcc -Xptxas -v`` log; the kernel's name is its
    mangled name from the base name on (``flash_dkdv_kernelIfLi128E...``:
    float, d = 128)."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            label = re.search(r"\d+([a-z_]+_kernel\w*)", m.group(1))
            name = label.group(1) if label else m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            name = None
    return rows


def peaks_for(name: str) -> dict:
    return PEAKS["pcie" if "pcie" in name.lower() else "sxm"]


def qkv(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, s, h, d = shape
    # one projection split three ways: v is a strided view, as in prefill
    x = torch.randn((b, s, h, 3 * d), generator=g, device="cuda")
    q, k, v = x.to(dtype).split(d, dim=-1)
    return q.contiguous(), k.contiguous(), v


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def within(a, b, tol) -> bool:
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


def phase_check() -> float:
    """Kernel vs plain at every shape, dtype and mask; returns the max
    abs error of the f32 output at the main-path shape."""
    main_err = 0.0
    for shape in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                q, k, v = qkv(shape, dtype, seed=sum(shape))
                out, lse = FLASH_FWD(q, k, v, causal)
                torch.cuda.synchronize()
                pout, plse = flash_attention_plain(q, k, v, causal)
                e_out, e_lse = max_err(out, pout), max_err(lse, plse)
                ok = (within(out, pout, TOL[dtype])
                      and within(lse, plse, LSE_TOL))
                log(f"  check {shape} {str(dtype)[6:]} causal={causal}: "
                    f"out err {e_out:.3e} lse err {e_lse:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash_fwd disagrees with plain "
                                         f"at {shape} {dtype} {causal}")
                if shape == MAIN_SHAPE and dtype == torch.float32:
                    main_err = max(main_err, e_out)
    # d = 256 through the dispatcher runs the kernel (phase 3w checks
    # every width past 128); past the kernels' 256 it raises, no fallback
    q, k, v = qkv((1, 40, 2, 256), torch.float32, seed=256)
    before = FLASH_FWD.launches
    out, lse = flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    pout, plse = flash_attention_plain(q, k, v, True)
    ok = (FLASH_FWD.launches == before + 1
          and within(out, pout, TOL[torch.float32])
          and within(lse, plse, LSE_TOL))
    log(f"  d=256 through flash_attention_fwd on the card: out err "
        f"{max_err(out, pout):.3e} lse err {max_err(lse, plse):.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_attention_fwd at d=256 did not run the "
                             "kernel or disagrees with plain")
    too_wide_raises()
    return main_err


def too_wide_raises() -> None:
    """Head dims past the kernels' 256 raise on the card in the forward
    and the backward dispatchers, before any launch (the plain versions
    take them only on the CPU)."""
    x = torch.zeros((1, 40, 2, TOO_WIDE), device="cuda")
    lse = torch.zeros((1, 2, 40), device="cuda")
    before = read_launches()
    for label, call in (
            ("flash_attention_fwd",
             lambda: flash_attention_fwd(x, x, x, True)),
            ("flash_attention_bwd",
             lambda: flash_attention_bwd(x, x, x, x, lse, x, True))):
        try:
            call()
        except ValueError as e:
            log(f"  d={TOO_WIDE} through {label} on the card: ValueError "
                f"{e}")
            if "head dims up to 256" not in str(e):
                raise
        else:
            raise AssertionError(f"{label} took d={TOO_WIDE} on the card")
    if read_launches() != before:
        raise AssertionError(f"d={TOO_WIDE} launched a kernel")


def attention_flops(b: int, s: int, h: int, d: int, causal: bool) -> float:
    """Operations (2 per FMA) of both products over the live (q, k)
    pairs only: s² pairs, or s(s+1)/2 when causal."""
    pairs = s * (s + 1) / 2 if causal else float(s) * s
    return 4.0 * b * h * d * pairs


def time_ms(fn, reps: int = TIMING_REPS, inner: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls of ``fn()``, divided by ``inner``, after warm-up.  ``inner`` > 1
    lets the host enqueue ahead of a kernel shorter than its launch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def tc_bound_ms(flops: float, key: str, peaks: dict) -> float:
    """The tensor-core bound: bf16 at its rate, f32 as 3xTF32."""
    if key == "f32":
        return TF32_PASSES * flops / peaks["tf32"] * 1e3
    return flops / peaks[key] * 1e3


def phase_time(peaks: dict, shapes=(MAIN_SHAPE, TRAIN_SHAPE)) -> dict:
    """Kernel, plain and SDPA times, causal, at the main (prefill) shape
    and at the training shape (or ``shapes``), each beside its bounds, its
    ratio to SDPA in the same run and the SDPA backend that ran:
    ``res[shape][dtype]``."""
    res = {}
    for shape in shapes:
        b, s, h, d = shape
        res[shape] = {}
        for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k, v = qkv(shape, dtype, seed=1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            ms = time_ms(lambda: FLASH_FWD(q, k, v, True),
                         inner=FWD_TIMING_INNER)
            plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, True))
            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)

            lib_ms = time_ms(sdpa, inner=FWD_TIMING_INNER)
            backend = sdpa_backend(sdpa)
            es = q.element_size()
            nbytes = 4 * b * s * h * d * es + b * h * s * 4  # q,k,v,out+lse
            flops = attention_flops(b, s, h, d, causal=True)
            by_bytes = nbytes / peaks["bytes"] * 1e3
            by_ops = flops / peaks[key] * 1e3
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       library_backend=backend,
                       ratio_to_library=ms / lib_ms,
                       bound_ms=max(by_bytes, by_ops),
                       bound_by="bytes" if by_bytes > by_ops
                       else "operations",
                       bound_tc_ms=max(by_bytes,
                                       tc_bound_ms(flops, key, peaks)),
                       flops=flops, bytes=nbytes)
            res[shape][key] = row
            log(f"  time {shape} {key} causal: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms [{backend}] "
                f"(kernel / sdpa "
                f"{row['ratio_to_library']:.3f}), bound {row['bound_ms']:.4f}"
                f" ms ({row['bound_by']}; {flops:.4g} FLOP, {nbytes} B), "
                f"tensor-core bound {row['bound_tc_ms']:.4f} ms, "
                f"{flops / ms / 1e9:.2f} TFLOP/s")
    return res


def bwd_inputs(shape, dtype, causal: bool, seed: int):
    """q, k, v (v strided), out and lse from the forward kernel, a random
    cotangent do, and dd = rowsum(do * out)."""
    q, k, v = qkv(shape, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(shape, generator=g, device="cuda").to(dtype)
    out, lse = FLASH_FWD(q, k, v, causal)
    return q, k, v, out, lse, do, attention_delta(out, do)


def bwd_within(a, ref, dtype) -> bool:
    rtol, afrac = BWD_TOL[dtype]
    a, ref = a.float(), ref.float()
    return bool(((a - ref).abs() <= rtol * ref.abs()
                 + afrac * ref.abs().max()).all())


def phase_check_bwd() -> dict:
    """flash_dq / flash_dkdv vs the plain backward at every shape, dtype
    and mask; returns each kernel's max abs error at the training shape,
    f32."""
    errs = {FLASH_DQ.name: 0.0, FLASH_DKDV.name: 0.0}
    for shape in BWD_CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                q, k, v, out, lse, do, dd = bwd_inputs(shape, dtype, causal,
                                                       seed=sum(shape) + 1)
                (dq,) = FLASH_DQ(q, k, v, do, lse, dd, causal)
                dk, dv = FLASH_DKDV(q, k, v, do, lse, dd, causal)
                torch.cuda.synchronize()
                ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
                got = (dq, dk, dv)
                e = [max_err(a, r) for a, r in zip(got, ref)]
                ok = all(bwd_within(a, r, dtype) for a, r in zip(got, ref))
                log(f"  check bwd {shape} {str(dtype)[6:]} causal={causal}: "
                    f"dq err {e[0]:.3e} dk err {e[1]:.3e} dv err {e[2]:.3e} "
                    f"(max |ref| {max(float(r.abs().max()) for r in ref):.3e})"
                    f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash backward disagrees with "
                                         f"plain at {shape} {dtype} {causal}")
                if shape == TRAIN_SHAPE and dtype == torch.float32:
                    errs[FLASH_DQ.name] = max(errs[FLASH_DQ.name], e[0])
                    errs[FLASH_DKDV.name] = max(errs[FLASH_DKDV.name], e[1],
                                                e[2])
    return errs


def phase_check_bwd_long() -> dict:
    """flash_dq / flash_dkdv vs the plain backward past the training
    length (BWD_LONG_SHAPES), f32 causal, at BWD_TOL; returns each shape's
    max abs errors."""
    res = {}
    for shape in BWD_LONG_SHAPES:
        q, k, v, out, lse, do, dd = bwd_inputs(shape, torch.float32, True,
                                               seed=sum(shape) + 1)
        (dq,) = FLASH_DQ(q, k, v, do, lse, dd, True)
        dk, dv = FLASH_DKDV(q, k, v, do, lse, dd, True)
        torch.cuda.synchronize()
        ref = flash_attention_bwd_plain(q, k, v, out, lse, do, True)
        got = (dq, dk, dv)
        e = [max_err(a, r) for a, r in zip(got, ref)]
        top = max(float(r.abs().max()) for r in ref)
        ok = all(bwd_within(a, r, torch.float32) for a, r in zip(got, ref))
        log(f"  check bwd {shape} float32 causal=True: dq err {e[0]:.3e} dk "
            f"err {e[1]:.3e} dv err {e[2]:.3e} (max |ref| {top:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        res[str(shape)] = dict(dq=e[0], dk=e[1], dv=e[2], max_ref=top)
        del q, k, v, out, lse, do, dd, dq, dk, dv, ref, got
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"flash backward disagrees with plain at "
                                 f"{shape} float32 causal (BWD_TOL)")
    return res


def wide_inputs(shape, dtype, seed: int, offset: int) -> list:
    """q, k, v and a cotangent do on the card, each a view into one
    (b, s, h, 4 d + offset) projection, ``offset`` elements in."""
    b, s, h, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, h, 4 * d + offset), generator=g,
                    device="cuda").to(dtype)
    return [x[..., offset + i * d: offset + (i + 1) * d] for i in range(4)]


def phase_check_wide() -> dict:
    """Phase 3w: flash_fwd, flash_dq and flash_dkdv against their plain
    versions at head dims past 128 (WIDE_CHECK_CASES), f32 and bf16,
    causal and not, under TOL / LSE_TOL and BWD_TOL; returns the max abs
    errors of each kernel by head dim and dtype."""
    errs: dict = {}
    for shape, offset in WIDE_CHECK_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                q, k, v, do = wide_inputs(shape, dtype, sum(shape) + offset,
                                          offset)
                out, lse = FLASH_FWD(q, k, v, causal)
                dd = attention_delta(out, do)
                (dq,) = FLASH_DQ(q, k, v, do, lse, dd, causal)
                dk, dv = FLASH_DKDV(q, k, v, do, lse, dd, causal)
                torch.cuda.synchronize()
                pout, plse = flash_attention_plain(q, k, v, causal)
                ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
                got = (dq, dk, dv)
                e = [max_err(out, pout), max_err(lse, plse),
                     *(max_err(a, r) for a, r in zip(got, ref))]
                ok_fwd = (within(out, pout, TOL[dtype])
                          and within(lse, plse, LSE_TOL))
                ok_bwd = all(bwd_within(a, r, dtype)
                             for a, r in zip(got, ref))
                log(f"  check {shape} offset {offset} {str(dtype)[6:]} "
                    f"causal={causal}: out err {e[0]:.3e} lse err "
                    f"{e[1]:.3e}; dq err {e[2]:.3e} dk err {e[3]:.3e} dv "
                    f"err {e[4]:.3e} (max |ref| "
                    f"{max(float(r.abs().max()) for r in ref):.3e}) "
                    f"{'ok' if ok_fwd and ok_bwd else 'FAIL'}")
                if not (ok_fwd and ok_bwd):
                    raise AssertionError(
                        f"flash {'forward' if not ok_fwd else 'backward'} "
                        f"disagrees with plain at {shape} offset {offset} "
                        f"{dtype} causal={causal}")
                key = f"d{shape[3]}_{str(dtype)[6:]}"
                row = errs.setdefault(key, dict.fromkeys(
                    (FLASH_FWD.name, FLASH_DQ.name, FLASH_DKDV.name), 0.0))
                row[FLASH_FWD.name] = max(row[FLASH_FWD.name], e[0])
                row[FLASH_DQ.name] = max(row[FLASH_DQ.name], e[2])
                row[FLASH_DKDV.name] = max(row[FLASH_DKDV.name], e[3], e[4])
                del q, k, v, do, out, lse, dd, dq, dk, dv, pout, plse, ref
    torch.cuda.empty_cache()
    return errs


def sdpa_backend(fn) -> str:
    """The kernels one call of ``fn`` (an SDPA call, or its backward)
    runs on the card, from a profiler trace: the backend's name read from
    the longest kernel's (cudnn, flash, efficient, else math)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trace_preroll()
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and "spin_kernel" not in e.name:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    if not by_name:
        return "not measured (no device events in the trace)"
    top = max(by_name, key=by_name.get).lower()
    backend = ("cudnn" if "cudnn" in top else
               "flash" if "flash" in top else
               "efficient" if "fmha" in top or "efficient" in top else
               "math")
    return f"{backend} ({top[:70]})"


def phase_crossover() -> dict:
    """Dense attention against the flash kernel (``flash_attention``),
    causal f32 at SLICE_CFG's heads and head dim, b = 1, over
    CROSSOVER_SEQS: CUDA-event medians, as phase 4.  ``crossover`` is the
    first s from which flash stays faster (None if it never does)."""
    h = SLICE_CFG["heads"]
    d = SLICE_CFG["dim"] // h
    rows = []
    with torch.inference_mode():
        for s in CROSSOVER_SEQS:
            q, k, v = qkv((1, s, h, d), torch.float32, seed=s)
            dense = time_ms(lambda: dense_attention(q, k, v, True),
                            inner=FWD_TIMING_INNER)
            flash = time_ms(lambda: flash_attention(q, k, v, True),
                            inner=FWD_TIMING_INNER)
            rows.append(dict(s=s, dense_ms=dense, flash_ms=flash))
    crossover = None
    for i, row in enumerate(rows):
        if all(r["flash_ms"] < r["dense_ms"] for r in rows[i:]):
            crossover = row["s"]
            break
    table = " ".join(f"s={r['s']}: dense {r['dense_ms']:.4f} / flash "
                     f"{r['flash_ms']:.4f} ms;" for r in rows)
    log(f"  crossover (1, s, {h}, {d}) f32 causal: {table} flash stays "
        f"faster from s={crossover}; DENSE_FLASH_CROSSOVER = "
        f"{DENSE_FLASH_CROSSOVER}")
    return dict(rows=rows, crossover=crossover,
                constant=DENSE_FLASH_CROSSOVER)


def phase_time_bwd(peaks: dict, shape=TRAIN_SHAPE) -> dict:
    """flash_dq, flash_dkdv, the plain backward and SDPA's backward at the
    training shape (or ``shape``), causal, each beside its bound, and the
    SDPA backend that ran."""
    b, s, h, d = shape
    pairs = s * (s + 1) / 2
    res = {}
    for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q, k, v, out, lse, do, dd = bwd_inputs(shape, dtype, True, seed=2)
        dq_ms = time_ms(lambda: FLASH_DQ(q, k, v, do, lse, dd, True))
        dkdv_ms = time_ms(lambda: FLASH_DKDV(q, k, v, do, lse, dd, True))
        plain_ms = time_ms(lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, do, True))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)

        def sdpa_all():
            return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        sdpa_fwd_ms = time_ms(sdpa)
        sdpa_all_ms = time_ms(sdpa_all)
        backend = sdpa_backend(sdpa_all)
        sdpa_bwd_ms = sdpa_all_ms - sdpa_fwd_ms
        es = q.element_size()
        tensor = b * s * h * d * es
        rows = b * h * s * 4
        res[key] = {}
        for name, ms, flops_per, n_out in (
                (FLASH_DQ.name, dq_ms, 6, 1), (FLASH_DKDV.name, dkdv_ms, 8, 2)):
            flops = flops_per * b * h * d * pairs
            nbytes = 4 * tensor + 2 * rows + n_out * tensor
            by_bytes = nbytes / peaks["bytes"] * 1e3
            by_ops = flops / peaks[key] * 1e3
            share_ms = BWD_LIBRARY_SHARE[name] * sdpa_bwd_ms
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_bwd_ms,
                       library_share_ms=share_ms, library_backend=backend,
                       ratio_to_library=ms / share_ms,
                       bound_ms=max(by_bytes, by_ops),
                       bound_by="bytes" if by_bytes > by_ops
                       else "operations",
                       bound_tc_ms=max(by_bytes,
                                       tc_bound_ms(flops, key, peaks)),
                       flops=flops, bytes=nbytes)
            res[key][name] = row
            log(f"  time {shape} {key} causal {name}: {ms:.4f} ms, "
                f"its share of SDPA's backward {share_ms:.4f} ms (ratio "
                f"{row['ratio_to_library']:.3f}), bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
                f"{flops:.4g} FLOP, {nbytes} B), tensor-core bound "
                f"{row['bound_tc_ms']:.4f} ms, "
                f"{flops / ms / 1e9:.2f} TFLOP/s")
        log(f"  time {shape} {key} causal: plain backward (dq, dk, dv)"
            f" {plain_ms:.4f} ms; library yardstick, SDPA forward+backward "
            f"minus SDPA forward: {sdpa_all_ms:.4f} - {sdpa_fwd_ms:.4f} = "
            f"{sdpa_bwd_ms:.4f} ms [{backend}]")
    return res


def checksum_payloads():
    """(label, tensor) pairs of phase 3c, all on the card."""
    g = torch.Generator(device="cuda").manual_seed(7)

    def ints(n, lo, hi, dtype):
        return torch.randint(lo, hi, (n,), generator=g, device="cuda",
                             dtype=torch.int64).to(dtype)

    out = []
    for n in CHECKSUM_WORDS:
        out.append((f"f32[{n}]", torch.randn(n, generator=g, device="cuda")))
        out.append((f"int32[{n}]", ints(n, -2**31, 2**31, torch.int32)))
    n = CHECKSUM_WORDS[-1]
    out.append((f"bf16[{n}]", torch.randn(n, generator=g, device="cuda")
                .to(torch.bfloat16)))
    out.append((f"int8[{n}]", ints(n, -128, 128, torch.int8)))
    out.append((f"bool[{n}]", ints(n, 0, 2, torch.bool)))
    big = ints(CHECKSUM_BYTES // 4, -2**31, 2**31, torch.int32)
    out.append(("int32 64 MiB", big))
    out.append(("f32 64 MiB", torch.randn(CHECKSUM_BYTES // 4, generator=g,
                                          device="cuda")))
    out.append(("int32[1:] (base not 16-byte aligned)", big[1:n + 1]))
    out.append(("int32 (1024, 2048)[:, ::2] (non-contiguous)",
                big[:2**21].view(1024, 2048)[:, ::2]))
    return out


def flipped(t: torch.Tensor) -> torch.Tensor:
    """A flat copy of ``t`` with one element changed."""
    flat = t.reshape(-1).clone()
    k = flat.numel() // 2
    flat[k] = ~flat[k] if t.dtype == torch.bool else flat[k] + 1
    return flat


def phase_check_checksum() -> tuple:
    """The checksum kernel vs its plain version, bit-exact, on every
    payload; a one-element change must change the sum.  Returns the
    number of payloads and the largest |kernel - plain|."""
    payloads = checksum_payloads()
    err = 0
    for label, t in payloads:
        got = checksum_u32(t)
        want = checksum_u32_plain(t)
        err = max(err, abs(got - want))
        ok = got == want
        if ok and t.numel():
            t2 = flipped(t)
            got2 = checksum_u32(t2)
            ok = got2 != got and got2 == checksum_u32_plain(t2)
        log(f"  checksum {label}: kernel {got:#010x} plain {want:#010x} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"checksum kernel disagrees on {label}")
    torch.cuda.synchronize()
    return len(payloads), err


def phase_time_checksum(peaks: dict) -> dict:
    """The checksum kernel, its plain version and the library call at
    64 MiB (and 1 MiB, the echo payload), beside the bound."""
    g = torch.Generator(device="cuda").manual_seed(8)
    res = {}
    for nbytes in (CHECKSUM_BYTES, ECHO_BYTES):
        words = torch.randint(-2**31, 2**31, (nbytes // 4,), generator=g,
                              device="cuda", dtype=torch.int64).to(
                                  torch.int32)
        # 20 calls per event pair: at 1 MiB a launch takes longer on the
        # host than the kernel on the card
        ms = time_ms(lambda: CHECKSUM(words), inner=CHECKSUM_INNER)
        plain_ms = time_ms(lambda: checksum_words_plain(words),
                           inner=CHECKSUM_INNER)
        lib_ms = time_ms(lambda: words.view(torch.int32).sum(
            dtype=torch.int64), inner=CHECKSUM_INNER)
        bound_ms = nbytes / peaks["bytes"] * 1e3
        # the whole checksum_u32 call as a caller sees it, on the host
        # clock: wrapper, launch, and the sync that reads the word back
        calls = []
        for _ in range(50):
            t0 = time.perf_counter()
            checksum_u32(words)
            calls.append((time.perf_counter() - t0) * 1e3)
        call_ms = statistics.median(calls)
        row = dict(payload_bytes=nbytes, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bound_by="bytes",
                   gb_s=nbytes / ms / 1e6, call_ms=call_ms)
        res[nbytes] = row
        log(f"  checksum over {nbytes} B: kernel {ms:.4f} ms "
            f"({row['gb_s']:.1f} GB/s), plain {plain_ms:.4f} ms, library "
            f"x.view(torch.int32).sum(dtype=torch.int64) {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms (bytes); one checksum_u32 call on "
            f"the host clock {call_ms:.4f} ms")
    return res


class CountedChecksum:
    """``checksum_u32`` on CUDA tensors, counting the calls, so that phase
    10 can hold the kernel's launch count to them."""

    def __init__(self):
        self.calls = 0

    def __call__(self, t: torch.Tensor) -> int:
        if not t.is_cuda:
            raise AssertionError("phase 10 checksums tensors on the card")
        self.calls += 1
        return checksum_u32(t)


def ps_call(ch: Channel, method: str, request: bytes = b"", device_att=None,
            attachment: bytes = b"", legs=None,
            service: str = "PS") -> Controller:
    """One call; ``legs`` (a list) gets each device leg as ``(method,
    "request" or "response", kind, inline bytes)``: the request's as the
    child of phase 10x reports it in its JSON answer."""
    cntl = Controller()
    cntl.timeout_ms = 120_000
    cntl.request_device_attachment = device_att
    cntl.request_attachment = attachment
    c = ch.call_method(f"{service}.{method}", request, cntl=cntl)
    if c.failed:
        raise RuntimeError(f"{service}.{method} failed: [{c.error_code}] "
                           f"{c.error_text}")
    if legs is not None:
        if device_att is not None:
            info = json.loads(c.response)
            legs.append((method, "request", info["kind"], info["inline"]))
        att = c.response_device_attachment
        if att is not None:
            legs.append((method, "response", att.kind,
                         len(c.response_attachment)))
    return c


def echo(ch: Channel, x: torch.Tensor, cs: CountedChecksum):
    """One EchoTensor call: the payload's checksum before the send and
    after the landing must agree.  Returns (request went device-resident
    as seen by the response, response device-resident, landed tensor)."""
    before = cs(x)
    c = ps_call(ch, "EchoTensor", device_att=x)
    att = c.response_device_attachment
    out = att.tensor()
    after = cs(out)
    if before != after or out.shape != x.shape or out.dtype != x.dtype:
        raise AssertionError(f"echo changed the payload: checksum "
                             f"{before:#010x} -> {after:#010x}")
    return att.device_resident, out


def wait_fabric_empty(timeout_s: float = 5.0) -> tuple:
    deadline = time.time() + timeout_s
    while True:
        live = in_process_fabric().live_descriptors
        outstanding = sum(ep.outstanding_bytes for ep in live_endpoints())
        if (live == 0 and outstanding == 0) or time.time() > deadline:
            return live, outstanding
        time.sleep(0.01)


def phase_ps() -> dict:
    """The full-width EmbeddingPS behind the port's RPC, and the device
    lane at 1 MiB and 64 MiB, with the checksum kernel on every echo; the
    checksum's launch count is read around the phase."""
    cs = CountedChecksum()
    t0 = time.perf_counter()
    model = EmbeddingPS(PS_CFG, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"  EmbeddingPS {PS_CFG}: table {PS_CFG.vocab * PS_CFG.dim * 4} B, "
        f"built in {time.perf_counter() - t0:.2f} s")
    srv = Server()
    ch, ch_echo = Channel(), Channel()
    try:
        if srv.add_service(PSService(model), name="PS") != 0 or srv.start(
                "127.0.0.1:0") != 0:
            raise RuntimeError("server did not start")
        ch.init(str(srv.listen_endpoint))
        ch_echo.init(str(srv.listen_endpoint))
        CHECKSUM.launches = 0
        res = ps_model_calls(ch, model, cs)
        res.update(ps_echoes(ch_echo, cs))
        live, outstanding = wait_fabric_empty()
        launches = CHECKSUM.launches
        log(f"  fabric: {live} live descriptors, {outstanding} outstanding "
            f"bytes; checksum launches {launches} for {cs.calls} calls")
        if live or outstanding:
            raise AssertionError("descriptors left in the fabric")
        if launches != cs.calls:
            raise AssertionError(f"checksum launched {launches} times for "
                                 f"{cs.calls} calls")
    finally:
        ch.close()
        ch_echo.close()
        srv.stop()
    res["launches"] = launches
    return res


def ps_model_calls(ch: Channel, model: EmbeddingPS,
                   cs: CountedChecksum, legs=None) -> dict:
    """Stat, Lookup (against embedding_bag on the card, checksummed on
    both sides), Predict, and Train with a falling loss."""
    stat = json.loads(ps_call(ch, "Stat").response)
    log(f"  Stat: {stat}")
    if stat["vocab"] != PS_CFG.vocab or stat["dim"] != PS_CFG.dim:
        raise AssertionError("Stat disagrees with the config")

    ids = np.random.default_rng(0).integers(0, PS_CFG.vocab, PS_BATCH,
                                            dtype=np.int32)
    t0 = time.perf_counter()
    c = ps_call(ch, "Lookup", pack_ids(ids), legs=legs)
    pooled = c.response_device_attachment.tensor()
    lookup_ms = (time.perf_counter() - t0) * 1e3
    want = embedding_bag(model.params["emb"], torch.from_numpy(ids).cuda())
    info = json.loads(c.response)
    sums = (cs(pooled), cs(want))
    ok = (info == {"dtype": "float32", "shape": [PS_BATCH[0], PS_CFG.dim]}
          and torch.equal(pooled, want) and sums[0] == sums[1])
    log(f"  Lookup {PS_BATCH}: {info}, device-resident "
        f"{c.response_device_attachment.device_resident}, {lookup_ms:.2f} "
        f"ms, equal to embedding_bag on the card {torch.equal(pooled, want)},"
        f" checksums {sums[0]:#010x} / {sums[1]:#010x}: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("Lookup disagrees with embedding_bag")
    warm = []
    for _ in range(20):
        t0 = time.perf_counter()
        ps_call(ch, "Lookup", pack_ids(ids),
                legs=legs).response_device_attachment.tensor()
        warm.append((time.perf_counter() - t0) * 1e3)
    lookup_warm_ms = statistics.median(warm)
    log(f"  Lookup {PS_BATCH} warm: median {lookup_warm_ms:.3f} ms of 20 "
        f"calls")

    c = ps_call(ch, "Predict", pack_ids(ids), legs=legs)
    logits = c.response_device_attachment.tensor()
    ok = (logits.shape == (PS_BATCH[0], PS_CFG.classes)
          and bool(torch.isfinite(logits).all())
          and torch.equal(logits, model.predict(ids)))
    log(f"  Predict {PS_BATCH}: logits {tuple(logits.shape)}, finite and "
        f"equal to the model's: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("Predict is wrong")

    labels = torch.from_numpy(ids[:, 0] % PS_CFG.classes).cuda()
    losses, train_ms = [], []
    for i in range(PS_TRAIN_CALLS):
        t0 = time.perf_counter()
        if i < PS_TRAIN_CALLS // 2:
            c = ps_call(ch, "Train", pack_ids(ids), device_att=labels,
                        legs=legs)
        else:
            c = ps_call(ch, "Train", pack_ids(ids), legs=legs,
                        attachment=labels.cpu().numpy().tobytes())
        losses.append(json.loads(c.response)["loss"])
        train_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"  Train x{PS_TRAIN_CALLS} (labels as a device attachment, then as "
        f"bytes): loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
        f"{train_ms[0]:.2f} ms the first call, median "
        f"{statistics.median(train_ms[1:]):.3f} ms after")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"PS loss not finite and falling: {losses}")
    return dict(lookup_ms=lookup_ms, lookup_warm_ms=lookup_warm_ms,
                losses=losses, train_ms=train_ms)


def ps_echoes(ch: Channel, cs: CountedChecksum) -> dict:
    """EchoTensor on a fresh connection: 1 MiB (the first request inline,
    then ECHO_CALLS zero-copy calls, timed), 64 MiB zero-copy, the 64 MiB
    inline refusal, and one profiled echo."""
    x = torch.arange(ECHO_BYTES // 4, dtype=torch.float32, device="cuda")
    dev0, out0 = echo(ch, x, cs)
    log(f"  echo 1 MiB, first call on a new connection: request inline "
        f"(domain exchange), response device-resident {dev0}, equal "
        f"{torch.equal(out0, x)}")
    if not torch.equal(out0, x):
        raise AssertionError("the first echo changed the payload")
    same = 0
    t0 = time.perf_counter()
    for _ in range(ECHO_CALLS):
        dev, out = echo(ch, x, cs)
        same += dev and out.data_ptr() == x.data_ptr()
    echo_s = time.perf_counter() - t0
    rps = ECHO_CALLS / echo_s
    log(f"  echo 1 MiB x{ECHO_CALLS}: {rps:.1f} calls/s "
        f"({echo_s / ECHO_CALLS * 1e3:.3f} ms per call, two checksums "
        f"included), zero-copy {same}/{ECHO_CALLS}")
    if same != ECHO_CALLS:
        raise AssertionError("device echoes were not zero-copy")

    y = torch.randn(CHECKSUM_BYTES // 4, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9))
    t0 = time.perf_counter()
    dev, out = echo(ch, y, cs)
    big_ms = (time.perf_counter() - t0) * 1e3
    log(f"  echo 64 MiB: device-resident {dev}, zero-copy {out is y}, "
        f"{big_ms:.2f} ms with both checksums")
    if not (dev and out is y):
        raise AssertionError("the 64 MiB echo was not zero-copy")
    set_flag("ici_enabled", False)
    try:
        cntl = Controller()
        cntl.timeout_ms = 60_000
        cntl.request_device_attachment = y
        c = ch.call_method("PS.EchoTensor", b"", cntl=cntl)
    finally:
        set_flag("ici_enabled", True)
    log(f"  echo 64 MiB with ici_enabled off (inline, past the frame cap): "
        f"failed={c.failed} [{c.error_code}] {c.error_text[:70]}")
    if c.error_code != Errno.EOVERCROWDED:
        raise AssertionError("the 64 MiB inline echo did not fail cleanly")
    res = dict(echo_rps=rps, echo_ms=echo_s / ECHO_CALLS * 1e3,
               echo_64mib_ms=big_ms)
    res.update(phase_echo_profile(ch, x, cs))
    return res


def spawn_child() -> tuple:
    """The child server of phases 10x and 10s, on this card:
    ``(process, "127.0.0.1:port")``.  Its port is read on a thread,
    bounded by CHILD_START_S; a child that does not come up is killed and
    fails the run."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen([sys.executable, "-c", XPROC_CHILD, root],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)
    got = {}

    def read_port():
        for line in proc.stdout:
            if line.startswith("PORT="):
                got["port"] = int(line.strip().split("=")[1])
                return

    reader = threading.Thread(target=read_port, daemon=True)
    reader.start()
    reader.join(CHILD_START_S)
    if "port" not in got:
        proc.kill()
        proc.wait(10)
        raise AssertionError(f"the child server did not come up (exit "
                             f"{proc.poll()})")
    return proc, f"127.0.0.1:{got['port']}"


def stop_child(proc) -> int:
    """Close the child's stdin (it stops its server and exits); kill it if
    it does not exit in 30 s.  Returns its exit code."""
    try:
        proc.stdin.close()
        return proc.wait(30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(10)
        return -9


def child_stats(ch: Channel) -> dict:
    return json.loads(ps_call(ch, "Stats", service="Ctl").response)


def child_flag(ch: Channel, name: str, value) -> None:
    ps_call(ch, "Flag", json.dumps([name, value]).encode(), service="Ctl")


def phase_xproc(in_proc: dict) -> dict:
    """Phases 10x and 10s: a child process on this card serves the
    full-width EmbeddingPS with ``ici_transfer_enabled`` on in both
    processes (10x), and byte echoes over the shm data plane (10s)."""
    if not set_flag("ici_transfer_enabled", True):
        raise AssertionError("ici_transfer_enabled refused")
    proc, addr = spawn_child()
    ch = Channel()
    try:
        ch.init(addr)
        log("[10x] device tensors between two processes: the CUDA IPC "
            "transfer lane")
        xfer = phase_xfer(ch, addr, in_proc)
        log("[10s] byte attachments between the same two processes: the "
            "shm data plane")
        shm = phase_shm_echo(ch, addr)
        stats = child_stats(ch)
    finally:
        ch.close()
        rc = stop_child(proc)
        set_flag("ici_transfer_enabled", False)
    log(f"  the child exited {rc}; modules of JAX or brpc_tpu it loaded: "
        f"{stats['foreign'] or 'none'}")
    if rc != 0 or stats["foreign"]:
        raise AssertionError("the child failed or imported JAX")
    return dict(xfer=xfer, shm=shm)


def xecho(ch: Channel, x: torch.Tensor, cs: CountedChecksum, legs: list):
    """One EchoTensor to the child.  ``x`` is the output of a kernel
    launched just before the call and not waited for: the post's event
    orders the child's read after it.  Three checksums must agree: ``x``
    here after the call, what landed in the child, what came back."""
    c = ps_call(ch, "EchoTensor", device_att=x, legs=legs)
    out = c.response_device_attachment.tensor()
    sums = (cs(x), json.loads(c.response)["sum"], cs(out))
    if len(set(sums)) != 1 or not torch.equal(out, x):
        raise AssertionError(f"the echo changed the payload: checksums "
                             f"{[hex(v) for v in sums]}")
    return out


def held_echoes(ch: Channel, base: torch.Tensor, cs: CountedChecksum,
                legs: list) -> None:
    """HELD_ECHOES xechoes whose payload still holds -1s when the call
    starts: its kernel waits behind a spin of HOLD_CYCLES on this stream,
    and nothing here waits for it before the post.  The three checksums
    agree only if the child's read waited on the post's event."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(HOLD_CYCLES)
    end.record()
    end.synchronize()
    call_ms = []
    for k in range(HELD_ECHOES):
        x = torch.full_like(base, -1.0)
        torch.cuda.synchronize()
        torch.cuda._sleep(HOLD_CYCLES)
        torch.add(base, 1000.0 + k, out=x)
        t0 = time.perf_counter()
        xecho(ch, x, cs, legs)
        call_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"  {HELD_ECHOES} held echoes (payload written behind a spin of "
        f"{start.elapsed_time(end):.1f} ms, not waited for before the "
        f"post): checksums equal; calls "
        f"{', '.join(f'{ms:.1f}' for ms in call_ms)} ms")


def ipc_steps(ch: Channel) -> dict:
    """Where a transfer leg's time goes, each step timed alone on the host
    clock over IPC_STEP_REPS calls at 1 MiB: an export here (handle,
    offset, an event recorded; its event destroyed), a pull of a tensor
    the child exported (open, wait, D2D copy, sync, close), a plain D2D
    copy with a sync, and a checksum."""
    n = ECHO_BYTES // 4
    info = json.loads(ps_call(ch, "Export", str(n).encode(),
                              service="Ctl").response)
    mh, eh = bytes.fromhex(info["handle"]), bytes.fromhex(info["event"])
    dev = torch.cuda.current_device()
    x = torch.zeros(n, device="cuda")

    def pull():
        return cuda_ipc.pull(dev, mh, info["offset"], eh, ECHO_BYTES,
                             torch.float32, (n,), torch.device("cuda", dev))

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(IPC_STEP_REPS):
            fn()
        return (time.perf_counter() - t0) / IPC_STEP_REPS * 1e3

    try:
        if not torch.equal(pull(), torch.arange(n, dtype=torch.float32,
                                                device="cuda")):
            raise AssertionError("a pull of the child's export differs")
        ms = {"export": timed(lambda: cuda_ipc.destroy_event(
                  cuda_ipc.export(x))),
              "pull": timed(pull),
              "copy": timed(lambda: (x.clone(), torch.cuda.synchronize())),
              "checksum": timed(lambda: checksum_u32(x))}
    finally:
        ps_call(ch, "Release", service="Ctl")
    log("  one transfer leg's steps at 1 MiB, each alone: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in ms.items())
        + " (the pull: open, wait, copy, sync, close)")
    return ms


def check_legs(legs: list, kind: int, label: str) -> None:
    bad = [leg for leg in legs if leg[2] != kind or leg[3] != 0]
    log(f"  {label}: {len(legs)} device legs, {len(bad)} not kind {kind} "
        f"with 0 inline bytes{': ' + str(bad[:4]) if bad else ''}")
    if bad or not legs:
        raise AssertionError(f"{label}: a leg left its lane")


def phase_xfer(ch: Channel, addr: str, in_proc: dict) -> dict:
    """10x: Stat, Lookup, Predict and Train as phase 10 does them (against
    a replica of the child's seed-0 model here), ECHO_CALLS 1 MiB echoes
    and one of 64 MiB over the transfer lane, then the same echoes inline
    (a fresh connection with the device lane off here) beside them."""
    cs = CountedChecksum()
    model = EmbeddingPS(PS_CFG, device="cuda", seed=0)
    legs = []
    CHECKSUM.launches = 0
    res = ps_model_calls(ch, model, cs, legs)
    xfab = transfer_fabric()
    log(f"  this process's transfer address {xfab.address.decode()}; the "
        f"child's {child_stats(ch)['address']}")
    base = torch.arange(ECHO_BYTES // 4, dtype=torch.float32, device="cuda")
    xecho(ch, base + 0.5, cs, legs)
    held_echoes(ch, base, cs, legs)
    t0 = time.perf_counter()
    for i in range(ECHO_CALLS):
        xecho(ch, base + float(i), cs, legs)
    echo_s = time.perf_counter() - t0
    rps = ECHO_CALLS / echo_s
    y0 = torch.randn(CHECKSUM_BYTES // 4, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(9))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c = ps_call(ch, "EchoTensor", device_att=y0 * 2.0, legs=legs)
    big = c.response_device_attachment.tensor()
    torch.cuda.synchronize()
    big_ms = (time.perf_counter() - t0) * 1e3
    sums = (cs(y0 * 2.0), json.loads(c.response)["sum"], cs(big))
    if len(set(sums)) != 1 or not torch.equal(big, y0 * 2.0):
        raise AssertionError("the 64 MiB echo changed the payload")
    launches = CHECKSUM.launches
    stats = child_stats(ch)
    echoes = ECHO_CALLS + HELD_ECHOES + 2
    log(f"  PS over the transfer lane: Lookup warm {res['lookup_warm_ms']:.3f}"
        f" ms (phase 10 in one process: {in_proc['lookup_warm_ms']:.3f}); "
        f"Train loss {res['losses'][0]:.5f} -> {res['losses'][-1]:.5f}")
    log(f"  echo 1 MiB x{ECHO_CALLS} over the transfer lane: {rps:.1f} "
        f"calls/s ({echo_s / ECHO_CALLS * 1e3:.3f} ms per call, three "
        f"checksums included; phase 10 in one process: "
        f"{in_proc['echo_rps']:.1f} calls/s)")
    log(f"  echo 64 MiB over the transfer lane: {big_ms:.2f} ms, "
        f"{2 * CHECKSUM_BYTES / (big_ms / 1e3) / 1e9:.2f} GB/s over both "
        f"legs (phase 10 in one process: {in_proc['echo_64mib_ms']:.2f} ms, "
        f"zero-copy); checksums {sums[0]:#010x} x3")
    check_legs(legs, KIND_TRANSFER, "10x transfer lane")
    live, child_live = xfab.live_descriptors, stats["live"]
    log(f"  live descriptors: {live} here, {child_live} in the child; "
        f"checksum launches {launches} here for {cs.calls} calls, "
        f"{stats['checksum_launches']} in the child for {echoes} echoes")
    if live or child_live or in_process_fabric().live_descriptors \
            or launches != cs.calls \
            or stats["checksum_launches"] != echoes:
        raise AssertionError("descriptors left, or checksums not launched "
                             "as counted")
    res.update(echo_rps=rps, echo_ms=echo_s / ECHO_CALLS * 1e3,
               echo_64mib_ms=big_ms,
               echo_64mib_gb_s=2 * CHECKSUM_BYTES / (big_ms / 1e3) / 1e9,
               legs=len(legs), launches=launches,
               child_launches=stats["checksum_launches"])
    res["steps_ms"] = ipc_steps(ch)
    res.update(phase_xfer_inline(ch, addr, cs, base, y0))
    res["child_launches"] = child_stats(ch)["checksum_launches"]
    return res


def phase_xfer_inline(ch: Channel, addr: str, cs: CountedChecksum,
                      base: torch.Tensor, y0: torch.Tensor) -> dict:
    """The inline lane between the same two processes, for comparison: a
    fresh connection with ``ici_enabled`` off here (so neither side learns
    the other's domain), the frame cap raised on both sides for 64 MiB."""
    cap0 = get_flag("max_body_size")
    legs = []
    # a connection of its own (a pooled one, so the fast lane carries
    # these calls): the "single" one is shared with ``ch``, whose frames
    # taught the child this process's domain
    opts = ChannelOptions()
    opts.connection_type = "pooled"
    ch2 = Channel(opts)
    launches0, calls0 = CHECKSUM.launches, cs.calls
    set_flag("ici_enabled", False)
    set_flag("max_body_size", INLINE_CAP)
    child_flag(ch, "max_body_size", INLINE_CAP)
    try:
        ch2.init(addr)
        xecho(ch2, base + 0.5, cs, legs)
        t0 = time.perf_counter()
        for i in range(INLINE_ECHO_CALLS):
            xecho(ch2, base + float(i), cs, legs)
        rps = INLINE_ECHO_CALLS / (time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xecho(ch2, y0 * 3.0, cs, legs)
        big_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ch2.close()
        set_flag("ici_enabled", True)
        set_flag("max_body_size", cap0)
        child_flag(ch, "max_body_size", cap0)
    launches = CHECKSUM.launches - launches0
    inline = [leg for leg in legs if leg[2] == KIND_INLINE]
    log(f"  inline lane between the same processes: 1 MiB x"
        f"{INLINE_ECHO_CALLS} {rps:.1f} calls/s; 64 MiB {big_ms:.2f} ms, "
        f"{2 * CHECKSUM_BYTES / (big_ms / 1e3) / 1e9:.2f} GB/s over both "
        f"legs (three checksums each included); {len(inline)} of "
        f"{len(legs)} legs inline")
    if len(inline) != len(legs) or launches != cs.calls - calls0:
        raise AssertionError("the inline comparison left the inline lane, "
                             "or its checksums were not launched as counted")
    return dict(launches_inline=launches,
                inline_echo_rps=rps, inline_echo_64mib_ms=big_ms,
                inline_echo_64mib_gb_s=2 * CHECKSUM_BYTES
                / (big_ms / 1e3) / 1e9)


def phase_shm_echo(ch: Channel, addr: str) -> dict:
    """10s: 1 MiB byte echoes between the two processes on one fresh
    connection, the shm data plane on and off in both processes in turns
    (bench.py:557-651's paired rounds, order alternating); the child
    echoes the request's view, so its answer re-describes our slot."""
    att = bytes(range(256)) * (ECHO_BYTES // 256)
    want = np.frombuffer(att, np.uint8)
    st0, fb0 = shm_ring.shm_stats(), shm_ring.shm_fallback_counters()
    ch3 = Channel()
    rates = {True: [], False: []}

    def one() -> None:
        # compared through numpy in both arms: ``memoryview == bytes``
        # goes byte by byte (~4 ms a MiB), ``bytes == bytes`` by memcmp
        c = ps_call(ch3, "Bytes", attachment=att, service="Ctl")
        if not np.array_equal(np.frombuffer(c.response_attachment, np.uint8),
                              want):
            raise AssertionError("a shm echo changed the payload")

    try:
        ch3.init(addr)
        for _ in range(3):
            one()                       # the handshake, both ways
        for r in range(SHM_ROUNDS):
            for on in ((True, False) if r % 2 == 0 else (False, True)):
                set_flag("rpc_shm_data_plane", on)
                child_flag(ch, "rpc_shm_data_plane", on)
                one()
                t0 = time.perf_counter()
                for _ in range(SHM_BLOCK):
                    one()
                dt = time.perf_counter() - t0
                rates[on].append(SHM_BLOCK * 2 * len(att) / dt / 1e9)
        left = shm_ring.outstanding_tx_slots()
    finally:
        set_flag("rpc_shm_data_plane", True)
        child_flag(ch, "rpc_shm_data_plane", True)
        ch3.close()
    st = {k: v - st0[k] for k, v in shm_ring.shm_stats().items()}
    fb = {k: v - fb0[k] for k, v in shm_ring.shm_fallback_counters().items()
          if v != fb0[k]}
    cstats = child_stats(ch)
    ratios = sorted(a / b for a, b in zip(rates[True], rates[False]))
    log(f"  1 MiB echoes, {SHM_ROUNDS} rounds of {SHM_BLOCK} per arm: shm "
        f"lane {', '.join(f'{g:.3f}' for g in rates[True])} GB/s, byte "
        f"lane {', '.join(f'{g:.3f}' for g in rates[False])} GB/s (both "
        f"directions); median ratio {ratios[len(ratios) // 2]:.3f}")
    log(f"  here: {st}, fallbacks {fb}, {left} tx slots outstanding; the "
        f"child: {cstats['shm']}, fallbacks {cstats['shm_fallbacks']}, "
        f"{cstats['tx_outstanding']} tx slots outstanding")
    if not (st["staged"] and st["resolved"]
            and cstats["shm"]["desc_reused"] >= 1) or left \
            or cstats["tx_outstanding"] \
            or not set(fb) <= set(shm_ring.FALLBACK_REASONS):
        raise AssertionError("the shm lane did not engage, or left slots")
    return dict(shm_gb_s=rates[True], byte_gb_s=rates[False],
                ratio_median=ratios[len(ratios) // 2], staged=st["staged"],
                child_desc_reused=cstats["shm"]["desc_reused"],
                fallbacks=fb)


def trace_preroll() -> None:
    """Open a profiler trace with PREROLL_SPINS short spin kernels and a
    pause.  The first device records of a trace can be missing from it
    (after the earlier phases' profiles, once the whole first checksum of
    an echo and the second's memset); the spins take that loss, and the
    callers leave spin kernels out of the events."""
    for _ in range(PREROLL_SPINS):
        torch.cuda._sleep(1_000)
    torch.cuda.synchronize()
    time.sleep(0.05)


def phase_echo_profile(ch: Channel, x: torch.Tensor,
                       cs: CountedChecksum) -> dict:
    """One 1 MiB echo under torch.profiler: the checksum kernel twice,
    and where the call's time goes."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, ECHO_PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        launches0 = CHECKSUM.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trace_preroll()
            t0 = time.perf_counter()
            echo(ch, x, cs)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        events = [e for e in device if "spin_kernel" not in e.name]
        spins = len(device) - len(events)
        kern = [e for e in events if "checksum_u32_kernel" in e.name]
        launched = CHECKSUM.launches - launches0
        if len(kern) == launched or attempt == ECHO_PROFILE_ATTEMPTS:
            break
        # the counter saw the launches the trace lost: profile again
        log(f"  profile attempt {attempt}: the trace shows {len(kern)} of "
            f"the {launched} checksum launches and {spins} of "
            f"{PREROLL_SPINS} pre-roll spins; profiling again")
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    log(f"  profile of one 1 MiB echo (attempt {attempt} of "
        f"{ECHO_PROFILE_ATTEMPTS}; {spins} of {PREROLL_SPINS} pre-roll "
        f"spins in the trace): {len(events)} CUDA events, "
        f"{len(kern)} of checksum_u32_kernel "
        f"({sum(e.time_range.elapsed_us() for e in kern):.1f} us); device "
        f"busy {busy_us:.1f} us of {wall_us:.1f} us wall "
        f"({busy_us / wall_us:.4f})")
    for e in events:
        log(f"    {e.time_range.elapsed_us():8.1f} us  {e.name[:80]}")
    if len(kern) != 2:
        raise AssertionError(f"one echo's trace shows {len(kern)} checksum "
                             f"kernels, want 2")
    return dict(echo_profile_busy_us=busy_us, echo_profile_wall_us=wall_us,
                echo_profile_attempts=attempt, echo_profile_spins=spins)


def reset_launches() -> None:
    for kern in KERNELS:
        kern.launches = 0


def read_launches() -> dict:
    return {kern.name: kern.launches for kern in KERNELS}


def generate(ch: Channel, prompt: np.ndarray, max_new: int,
             service: str = "LM") -> np.ndarray:
    cntl = Controller()
    cntl.timeout_ms = 600_000
    c = ch.call_method(f"{service}.Generate",
                       pack_generate_request(prompt, max_new), cntl=cntl)
    if c.failed:
        raise RuntimeError(f"Generate failed: [{c.error_code}] "
                           f"{c.error_text}")
    return unpack_generated(c.response)


def phase_serve(ch: Channel, cfg: LMConfig) -> list:
    info = json.loads(ch.call("LM.Info", b"", timeout_ms=60_000))
    log(f"  LM.Info: {info}")
    if info["dim"] != cfg.dim or info["depth"] != cfg.depth:
        raise AssertionError(f"Info disagrees with the config: {info}")
    rng = np.random.default_rng(0)
    rows = []
    for i, (b, s, max_new) in enumerate(REQUESTS):
        prompt = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
        t0 = time.perf_counter()
        out = generate(ch, prompt, max_new)
        dt = time.perf_counter() - t0
        if out.shape != (b, max_new) or out.dtype != np.int32:
            raise AssertionError(f"bad Generate shape {out.shape}")
        if out.min() < 0 or out.max() >= cfg.vocab:
            raise AssertionError("Generate ids out of vocab")
        tps = b * max_new / dt
        rows.append(dict(b=b, s=s, max_new=max_new, ms=dt * 1e3,
                         tok_s=tps, warmup=i == 0))
        if i == 0:
            rows[0]["tokens"] = out[0].tolist()     # phase 13's reference
        rows[i]["ids"] = out.tolist()               # phase 15's reference
        log(f"  Generate b={b} s={s} max_new={max_new}: {dt * 1e3:.1f} ms "
            f"end to end, {tps:.1f} generated tok/s (prefill included)"
            f"{' [warm-up]' if i == 0 else ''}; first ids "
            f"{out[0, :6].tolist()}")
    return rows


def phase_profile(ch: Channel, cfg: LMConfig) -> int:
    """Flash kernel launches in one Generate request's CUDA trace."""
    from torch.profiler import ProfilerActivity, profile
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (1, 1024),
                                               dtype=np.int32)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(ch, prompt, 4)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    flash = [e for e in events if "flash_fwd_kernel" in e.name]
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    log(f"  profile (b=1 s=1024 max_new=4): {len(events)} CUDA kernel "
        f"events, {len(flash)} of flash_fwd_kernel; device busy "
        f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
        f"({busy_us / wall_us:.3f})")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {us / 1e3:8.3f} ms  {kname[:90]}")
    if len(flash) != cfg.depth:
        raise AssertionError(f"expected {cfg.depth} flash_fwd launches in "
                             f"one request's trace, saw {len(flash)}")
    return len(flash)


def phase_decode_rate(svc: LMService, cfg: LMConfig) -> dict:
    """Prefill alone and a whole completion, timed straight through the
    service's generator at one request shape: the decode steps' rate is
    the difference."""
    b, s, max_new = REQUESTS[1]
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, s))).cuda()
    prefill = make_decode(cfg, "cuda")[0]

    def run_prefill():
        with torch.inference_mode():
            prefill(svc.params, ids)

    def wall_ms(fn) -> float:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    pre_ms = wall_ms(run_prefill)
    gen_ms = wall_ms(lambda: svc._gen(ids, max_new))
    rate = b * (max_new - 1) / ((gen_ms - pre_ms) / 1e3)
    log(f"  b={b} s={s} max_new={max_new}: prefill {pre_ms:.2f} ms, whole "
        f"completion {gen_ms:.2f} ms, decode {rate:.1f} tok/s "
        f"({(gen_ms - pre_ms) / (max_new - 1):.3f} ms per step)")
    return dict(b=b, s=s, max_new=max_new, prefill_ms=pre_ms,
                completion_ms=gen_ms, decode_tok_s=rate)


class DecodeClient:
    """One LM.Decode session on its own connection: the tokens as they
    arrive, the close reason, and the time to the first token."""

    def __init__(self, ep, service: str, prompt: np.ndarray, max_new: int,
                 trace_id: int = 0, channel: Channel = None,
                 request_code: int = 0):
        self.prompt, self.max_new = prompt, max_new
        self.trace_id = trace_id
        self.tokens, self.reason, self.ttft_s = [], None, None
        self.call_s = None          # the unary call's return
        self.error = None
        self.remote = None          # the server that answered
        self.done = threading.Event()
        self._ep, self._service = ep, service
        # a shared (cluster) channel, and the balancer's hash key
        self._channel, self._code = channel, request_code

    def run(self) -> None:
        ch = self._channel
        if ch is None:
            ch = Channel()
            ch.init(str(self._ep))
        cntl = Controller()
        cntl.timeout_ms = int(DECODE_TIMEOUT_S * 1000)
        cntl.trace_id = self.trace_id
        cntl.request_code = self._code

        def on_received(st, msgs):
            if self.ttft_s is None:
                self.ttft_s = time.perf_counter() - t0
            self.tokens.extend(unpack_token(m) for m in msgs)

        def on_closed(st):
            self.reason = st.close_reason
            self.done.set()

        stream_create(cntl, StreamOptions(on_received=on_received,
                                          on_closed=on_closed))
        t0 = time.perf_counter()
        c = ch.call_method(f"{self._service}.Decode",
                           pack_generate_request(self.prompt[None],
                                                 self.max_new), cntl=cntl)
        self.call_s = time.perf_counter() - t0
        self.remote = c.remote_side
        if c.failed:
            self.error = f"[{c.error_code}] {c.error_text}"
            self.done.set()
        self.done.wait(DECODE_TIMEOUT_S)
        if self._channel is None:
            ch.close()


def run_decode_sessions(ep, service: str, prompts, stagger_s: float,
                        batcher, trace_ids=None, channel: Channel = None,
                        request_code: int = 0) -> tuple:
    """Start one client thread per prompt, ``stagger_s`` apart (each call
    traced under its ``trace_ids`` entry, if given; through ``channel``
    with ``request_code``, if given); wait for every stream to close.
    Returns the clients, the wall time from the first call to the last
    close, and the most slots seen live."""
    clients = [DecodeClient(ep, service, p, DECODE_MAX_NEW, tid, channel,
                            request_code)
               for p, tid in zip(prompts, trace_ids or [0] * len(prompts))]
    threads = [threading.Thread(target=c.run) for c in clients]
    t0 = time.perf_counter()
    most_live = 0
    for i, t in enumerate(threads):
        t.start()
        if i + 1 < len(threads):
            time.sleep(stagger_s)
        most_live = max(most_live, batcher.live_slots())
    while not all(c.done.is_set() for c in clients):
        if time.perf_counter() - t0 > DECODE_TIMEOUT_S:
            raise AssertionError("a decode stream never closed")
        most_live = max(most_live, batcher.live_slots())
        time.sleep(0.02)
    wall_s = time.perf_counter() - t0
    for t in threads:
        t.join(10)
    for i, c in enumerate(clients):
        if c.error or c.reason != "finished" \
                or len(c.tokens) != DECODE_MAX_NEW:
            raise AssertionError(f"decode session {i} (prompt "
                                 f"{len(c.prompt)}): error {c.error}, "
                                 f"close {c.reason!r}, {len(c.tokens)} "
                                 f"tokens")
    return clients, wall_s, most_live


def solo_reference(svc: LMService, cfg: LMConfig, prompt: np.ndarray,
                   max_new: int) -> tuple:
    """The service's solo generator's arithmetic (``make_decode``'s
    prefill of the whole prompt, then one step per token, argmax), with
    each step's top-1 minus top-2 logit over the largest |logit|."""
    prefill, step = make_decode(cfg, "cuda")
    ids = torch.from_numpy(prompt[None].astype(np.int64)).cuda()
    toks, margins = [], []
    with torch.inference_mode():
        cache, logits = prefill(svc.params, ids)
        for i in range(max_new):
            top2 = torch.topk(logits[0], 2).values
            margins.append((top2[0] - top2[1]) / logits[0].abs().max())
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok[0])
            if i + 1 < max_new:
                cache, logits = step(svc.params, cache, tok)
    return (torch.stack(toks).cpu().tolist(),
            torch.stack(margins).cpu().tolist())


def check_tokens(svc: LMService, cfg: LMConfig, clients) -> tuple:
    """Each session's tokens against the solo reference: equal, or unequal
    first at a near-tie (margin below LOGIT_RTOL), after which the session
    is compared no further.  Returns (tokens compared, tokens streamed,
    near-tie stops)."""
    compared = ties = 0
    for i, c in enumerate(clients):
        want, margins = solo_reference(svc, cfg, c.prompt, c.max_new)
        if i == 0:
            gen = svc._gen(torch.from_numpy(c.prompt[None].astype(np.int64))
                           .cuda(), c.max_new)[0].cpu().tolist()
            if gen != want:
                raise AssertionError("the solo reference differs from the "
                                     "service's generator")
        for j, (got, ref) in enumerate(zip(c.tokens, want)):
            if got == ref:
                compared += 1
                continue
            if margins[j] >= LOGIT_RTOL:
                raise AssertionError(
                    f"decode session {i} token {j}: {got} against the solo "
                    f"run's {ref} at a top-1 margin of {margins[j]:.3e} of "
                    f"the largest |logit|")
            log(f"  session {i}: token {j} differs at a near-tie (margin "
                f"{margins[j]:.3e}); compared no further")
            ties += 1
            break
    total = sum(len(c.tokens) for c in clients)
    if compared < total // 2:
        raise AssertionError(f"only {compared} of {total} tokens compared")
    return compared, total, ties


def decode_prompts(cfg: LMConfig, seed: int, n: int,
                   lens_range=DECODE_PROMPT_LENS) -> list:
    """``n`` prompts of lengths drawn from ``lens_range`` and tokens drawn
    after them, from one seed."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lens_range[0], lens_range[1] + 1, n)
    return [rng.integers(0, cfg.vocab, k, dtype=np.int32) for k in lens]


def phase_decode(ep, svc: LMService, chunked: LMService, cfg: LMConfig,
                 one_stream_tok_s: float) -> dict:
    """LM.Decode through the continuous batcher (phase 6b)."""
    prompts = decode_prompts(cfg, 5, DECODE_SLOTS)
    lens = np.asarray([len(p) for p in prompts])
    batcher = svc.batcher()
    rounds0 = lm_telemetry.phase_counters()["decode_round"]
    round_ns0 = lm_telemetry.phase_total_ns()["decode_round"]
    hists0 = tier_hists()
    FLASH_FWD.launches = 0
    clients, wall_s, most_live = run_decode_sessions(
        ep, "LM", prompts, DECODE_STAGGER_S, batcher)
    launches = FLASH_FWD.launches
    hists1 = tier_hists()
    rounds = lm_telemetry.phase_counters()["decode_round"] - rounds0
    round_ms = (lm_telemetry.phase_total_ns()["decode_round"]
                - round_ns0) / 1e6 / rounds
    joins = batcher.prefills_run
    tokens = sum(len(c.tokens) for c in clients)
    agg = tokens / wall_s
    ttfts = sorted(c.ttft_s * 1e3 for c in clients)
    log(f"  {len(clients)} sessions, prompts {sorted(lens.tolist())}, "
        f"{DECODE_MAX_NEW} new tokens each, all closed 'finished'; up to "
        f"{most_live} slots live at once; {tokens} tokens in {wall_s:.3f} s "
        f"= {agg:.1f} tok/s aggregate ({agg / one_stream_tok_s:.2f}x the "
        f"one-stream decode rate {one_stream_tok_s:.1f} tok/s, prefills "
        f"included)")
    log(f"  TTFT median {statistics.median(ttfts):.1f} ms, max "
        f"{ttfts[-1]:.1f} ms; {rounds} decode rounds, {round_ms:.3f} ms "
        f"each (step and token read-back), "
        f"{tokens / rounds:.2f} tokens per round")
    want = cfg.depth * joins
    log(f"  flash_fwd launches over the run: {launches} (depth "
        f"{cfg.depth} x {joins} whole-prompt joins = {want})")
    if launches != want or joins != len(clients):
        raise AssertionError("the Decode path did not run the kernel once "
                             "per layer per join")
    compared, total, ties = check_tokens(svc, cfg, clients)
    log(f"  tokens vs the solo generator: {compared} of {total} compared "
        f"equal, {ties} sessions stopped at a near-tie")
    batcher.shutdown()
    res = dict(sessions=len(clients), prompt_lens=lens.tolist(),
               max_new=DECODE_MAX_NEW, tokens=tokens, wall_s=wall_s,
               aggregate_tok_s=agg, one_stream_tok_s=one_stream_tok_s,
               speedup=agg / one_stream_tok_s, most_live=most_live,
               ttft_ms=ttfts, ttft_median_ms=statistics.median(ttfts),
               ttft_max_ms=ttfts[-1], rounds=rounds, round_ms=round_ms,
               launches=launches, compared=compared, near_ties=ties,
               session_tokens=[c.tokens for c in clients],
               tier_ttft_ms=hist_rows(hists0[0], hists1[0]),
               tier_itl_ms=hist_rows(hists0[1], hists1[1]))
    res.update(phase_decode_chunked(ep, svc, chunked, cfg))
    res.update(phase_decode_profile(svc, cfg))
    return res


def phase_decode_chunked(ep, svc: LMService, chunked: LMService,
                         cfg: LMConfig) -> dict:
    """Two sessions through the service with 256-token prefill chunks:
    the same token rule, the slices counted, no flash_fwd launch."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in CHUNK_PROMPT_LENS]
    slices0 = sched_counters()["sched_chunk_slice"]
    FLASH_FWD.launches = 0
    clients, wall_s, _ = run_decode_sessions(ep, "LMChunked", prompts, 0.0,
                                             chunked.batcher())
    launches = FLASH_FWD.launches
    slices = sched_counters()["sched_chunk_slice"] - slices0
    want_slices = sum(-(-(n - 1) // CHUNK_TOKENS) for n in CHUNK_PROMPT_LENS)
    log(f"  chunked ({CHUNK_TOKENS}-token slices), prompts "
        f"{list(CHUNK_PROMPT_LENS)}: closed 'finished' in {wall_s:.3f} s, "
        f"{slices} chunk slices (expected {want_slices}), flash_fwd "
        f"launches {launches} (expected 0)")
    if slices != want_slices or launches != 0:
        raise AssertionError("the chunked sessions did not run as sliced")
    compared, total, ties = check_tokens(svc, cfg, clients)
    log(f"  chunked tokens vs the solo generator: {compared} of {total} "
        f"compared equal, {ties} sessions stopped at a near-tie")
    chunked.batcher().shutdown()
    return dict(chunk_slices=slices, chunk_compared=compared,
                chunk_tokens=total, chunk_wall_s=wall_s)


def phase_decode_profile(svc: LMService, cfg: LMConfig) -> dict:
    """One decode round at 8 live slots under torch.profiler, as the
    batcher runs it (tokens up, the batch step, argmax, tokens back), on
    a pool whose slots sit at the sessions' end positions."""
    from torch.profiler import ProfilerActivity, profile
    _, step = make_batch_decode(cfg, device="cuda")
    cache = empty_batch_cache(cfg, DECODE_SLOTS, device="cuda")
    cache["len"].copy_(torch.from_numpy(np.linspace(
        DECODE_PROMPT_LENS[0], DECODE_PROMPT_LENS[1],
        DECODE_SLOTS).astype(np.int32) + DECODE_MAX_NEW))
    tokens = np.arange(DECODE_SLOTS, dtype=np.int32)
    active = np.ones(DECODE_SLOTS, dtype=bool)

    def round_():
        nonlocal cache
        cache, logits = step(svc.params, cache,
                             torch.from_numpy(tokens).cuda(),
                             torch.from_numpy(active).cuda())
        return torch.argmax(logits, dim=-1).cpu()

    prof = profile_round(f"one decode round at {DECODE_SLOTS} live slots",
                         round_, top=6)
    del cache
    return dict(round_kernels=prof["kernels"], round_busy_ms=prof["busy_ms"],
                round_wall_ms=prof["wall_ms"],
                round_busy_share=prof["busy_share"])


def profile_round(label: str, round_, top: int = 8) -> dict:
    """One call of ``round_`` under torch.profiler after 3 warm-ups: CUDA
    events, device busy share, the top kernels, and the share of the
    gather and indexed-write kernels (the block-table gathers of the
    paged pools, the k/v row writes)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        for _ in range(3):
            round_()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trace_preroll()
            t0 = time.perf_counter()
            round_()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "spin_kernel" not in e.name]
    by_name: dict = {}
    for e in events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_name.values())
    gather_us = sum(us for name, (_, us) in by_name.items()
                    if "gather" in name.lower())
    index_us = gather_us + sum(us for name, (_, us) in by_name.items()
                               if "index" in name.lower())
    log(f"  profile of {label}: {len(events)} CUDA events; device busy "
        f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
        f"({busy_us / wall_us:.4f}); gathers {gather_us / 1e3:.3f} ms "
        f"({gather_us / max(busy_us, 1e-9):.4f} of busy), with the indexed "
        f"writes {index_us / 1e3:.3f} ms "
        f"({index_us / max(busy_us, 1e-9):.4f})")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    for kname, (n, us) in ranked:
        log(f"    {us / 1e3:8.3f} ms  {n:4d}x  {kname[:90]}")
    if not events:
        raise AssertionError(f"the profiled {label} shows no device work")
    return dict(kernels=len(events), busy_ms=busy_us / 1e3,
                wall_ms=wall_us / 1e3, busy_share=busy_us / wall_us,
                gather_ms=gather_us / 1e3, gather_share=gather_us / busy_us,
                index_ms=index_us / 1e3, index_share=index_us / busy_us,
                top_kernels=[(k[:90], n, us / 1e3) for k, (n, us) in ranked])


def phase_snapshot() -> tuple:
    return lm_telemetry.phase_counters(), lm_telemetry.phase_total_ns()


def phase_deltas(snap: tuple) -> dict:
    """Per step phase since ``snap``: (samples, total ms, ms each)."""
    counts, totals = phase_snapshot()
    out = {}
    for name in counts:
        n = counts[name] - snap[0][name]
        ms = (totals[name] - snap[1][name]) / 1e6
        out[name] = (n, ms, ms / n if n else 0.0)
    return out


def run_counted(ep, service: str, prompts, stagger_s: float, batcher):
    """``run_decode_sessions`` with the forward kernel's count set to 0
    just before and read just after: (clients, wall s, most live,
    launches)."""
    FLASH_FWD.launches = 0
    clients, wall_s, most_live = run_decode_sessions(
        ep, service, prompts, stagger_s, batcher)
    return clients, wall_s, most_live, FLASH_FWD.launches


def hold_tokens(label: str, svc: LMService, cfg: LMConfig, clients) -> dict:
    compared, total, ties = check_tokens(svc, cfg, clients)
    log(f"  {label} tokens vs the solo generator: {compared} of {total} "
        f"compared equal, {ties} sessions stopped at a near-tie")
    return dict(compared=compared, tokens=total, near_ties=ties)


def phase_paged(ep, svc: LMService, paged: dict, cfg: LMConfig) -> dict:
    """LM.Decode through the paged batcher (phase 6c): its four
    sub-phases, each on a service of its own, shut down after it.  Returns
    their results and the forward kernel's launches over them."""
    res = {"paged_many": phase_paged_many(ep, svc, paged["LMPaged"], cfg),
           "exact": phase_paged_exact(cfg, svc.params),
           "prefix": phase_paged_prefix(ep, svc, paged["LMPrefix"], cfg),
           "spill": phase_paged_spill(ep, svc, paged["LMSpill"], cfg)}
    res["spec"] = phase_spec(ep, svc, paged["LMSpec"], paged["LMSpecPlain"],
                             cfg)
    res["launches_paged"] = sum(res[k]["launches"] for k in (
        "paged_many", "prefix", "spill")) + res["spec"]["plain_launches"]
    res["launches_spec"] = res["spec"]["launches"]
    return res


def phase_paged_many(ep, svc: LMService, paged: LMService,
                     cfg: LMConfig) -> dict:
    """(a) 16 streams through 16 slots on the pool bytes of 8 contiguous
    slots, a host tier taking the overflow."""
    prompts = decode_prompts(cfg, 5, DECODE_SLOTS) \
        + decode_prompts(cfg, 7, DECODE_SLOTS)
    batcher = paged.batcher()
    snap = phase_snapshot()
    clients, wall_s, most_live, launches = run_counted(
        ep, "LMPaged", prompts, DECODE_STAGGER_S, batcher)
    d = phase_deltas(snap)
    stats = batcher.kv_stats()
    joins = batcher.prefills_run
    tokens = sum(len(c.tokens) for c in clients)
    ttfts = sorted(c.ttft_s * 1e3 for c in clients)
    rounds, _, round_ms = d["decode_round"]
    log(f"  (a) {len(clients)} sessions through {PAGED_SLOTS} slots on "
        f"{PAGED_POOL} pages of {PAGE} tokens ({PAGED_POOL - 1} usable = "
        f"the bytes of {DECODE_SLOTS} contiguous slots) and {HOST_SLOTS} "
        f"host slots: all closed 'finished', up to {most_live} live; "
        f"{tokens} tokens in {wall_s:.3f} s = {tokens / wall_s:.1f} tok/s "
        f"aggregate; {rounds} rounds, {round_ms:.3f} ms each, "
        f"{tokens / rounds:.2f} tokens per round")
    log(f"  TTFT median {statistics.median(ttfts):.1f} ms, max "
        f"{ttfts[-1]:.1f} ms; peak pages in use "
        f"{stats['alloc']['peak_in_use']} of {PAGED_POOL - 1}; spills "
        f"{batcher.spills}, resumes {batcher.resumes}; flash_fwd launches "
        f"{launches} (depth {cfg.depth} x {joins} whole-prompt joins = "
        f"{cfg.depth * joins})")
    if launches != cfg.depth * joins or joins != len(clients):
        raise AssertionError("the paged Decode path did not run the kernel "
                             "once per layer per join")
    if batcher.resumes != batcher.spills:
        raise AssertionError("a spilled session never resumed")
    res = dict(sessions=len(clients), tokens=tokens, wall_s=wall_s,
               aggregate_tok_s=tokens / wall_s, most_live=most_live,
               rounds=rounds, round_ms=round_ms, ttft_ms=ttfts,
               ttft_median_ms=statistics.median(ttfts),
               ttft_max_ms=ttfts[-1],
               pages_peak=stats["alloc"]["peak_in_use"],
               spills=batcher.spills, resumes=batcher.resumes,
               host_spill_ms=d["host_spill"][2],
               host_resume_ms=d["host_resume"][2], launches=launches,
               joins=joins)
    res.update(hold_tokens("(a)", svc, cfg, clients))
    if not batcher.shutdown():
        raise AssertionError("the paged batcher did not stop")
    res["round_profile"] = profile_paged_round(cfg, svc.params)
    return res


def striped_pool(cfg: LMConfig, lens, spare: int = 0) -> tuple:
    """A full-width page pool whose slot ``s`` holds the whole stripe of
    pages ``1 + s * pps ...`` at position ``lens[s]``, with ``spare``
    stripes of free pages after them: the (cache, host block table) a
    round of the paged batcher meets at those positions."""
    pps = cfg.max_seq // PAGE
    slots = len(lens)
    cache = empty_paged_cache(cfg, 1 + (slots + spare) * pps, slots, PAGE,
                              device="cuda")
    cache["len"].copy_(torch.from_numpy(np.asarray(lens, np.int32)))
    bt = (1 + np.arange(slots * pps, dtype=np.int32)).reshape(slots, pps)
    return cache, bt


def profile_paged_rounds(cfg: LMConfig, params, lens, spec: bool) -> dict:
    """One round of the paged batcher's programs at ``lens`` under the
    profiler, as ``_plain_round`` or ``_spec_round`` runs them: the block
    table and tokens copied up, then one paged step and its argmax read
    back; or k draft steps on the contiguous draft pool (each proposal
    read back), one width-(k+1) verify, the draft's len rewound."""
    n = len(lens)
    _, step = make_paged_batch_decode(cfg, PAGE, device="cuda")
    cache, bt = striped_pool(cfg, lens)
    tokens = np.arange(n, dtype=np.int32)
    active = torch.ones(n, dtype=torch.bool, device="cuda")

    def plain_round():
        nonlocal cache
        cache, logits = step(params, cache, torch.from_numpy(bt).cuda(),
                             torch.from_numpy(tokens).cuda(), active)
        return torch.argmax(logits, dim=-1).cpu()

    if not spec:
        prof = profile_round(f"one paged round at {n} live slots",
                             plain_round)
        del cache
        return prof
    _, d_step = make_batch_decode(cfg, device="cuda")
    verify = make_paged_spec_verify(cfg, PAGE, SPEC_K + 1, device="cuda")
    d_cache = empty_batch_cache(cfg, n, device="cuda")
    d_cache["len"].copy_(cache["len"])

    def spec_round():
        nonlocal cache, d_cache
        cur, drafts = tokens, []
        for _ in range(SPEC_K):
            d_cache, dl = d_step(params, d_cache,
                                 torch.from_numpy(cur).cuda(), active)
            cur = torch.argmax(dl, dim=-1).to(torch.int32).cpu().numpy()
            drafts.append(cur)
        u = np.stack([tokens] + drafts, axis=1).astype(np.int32)
        cache, out, m = verify(params, cache, torch.from_numpy(bt).cuda(),
                               torch.from_numpy(u).cuda(), active)
        d_cache["len"].sub_((SPEC_K - 1 - m).to(d_cache["len"].dtype))
        return out.cpu(), m.cpu()

    prof = profile_round(f"one spec round at {n} live slots", spec_round)
    del cache, d_cache
    return prof


def profile_paged_round(cfg: LMConfig, params) -> dict:
    """The paged programs' plain round at 6b's eight profiled positions,
    for its device time beside 6b's contiguous round."""
    lens = np.linspace(DECODE_PROMPT_LENS[0], DECODE_PROMPT_LENS[1],
                       DECODE_SLOTS).astype(np.int32) + DECODE_MAX_NEW
    return profile_paged_rounds(cfg, params, lens, spec=False)


def phase_paged_exact(cfg: LMConfig, params) -> dict:
    """The paged step against the contiguous step on one filled context at
    full width.  6b's eight prompts (seed 5) are prefilled once each, and
    every cache goes both into a contiguous slot and into that slot's
    pages (``insert``).  Two steps of each program with the same tokens
    must give bit-equal logits and leave bit-equal k/v.  Between the two
    steps, ``EXACT_MOVED`` slots move as spill and resume move a session
    (``gather``, one host-tier slot per page, ``fetch``, one ``scatter``
    into spare pages, the block table pointed there); their old pages are
    then filled with NaN.  So where a 6c session's token differs from the
    solo run, the page motion is not the cause."""
    prompts = decode_prompts(cfg, 5, DECODE_SLOTS)
    ctx = [p[:-1] for p in prompts]
    pps = cfg.max_seq // PAGE
    prefill, c_step = make_batch_decode(cfg, device="cuda")
    _, p_step = make_paged_batch_decode(cfg, PAGE, device="cuda")
    gather, scatter, insert = make_paged_io(cfg, PAGE, device="cuda")
    ccache = empty_batch_cache(cfg, DECODE_SLOTS, device="cuda")
    pcache, bt = striped_pool(cfg, [len(c) for c in ctx], spare=EXACT_MOVED)
    host = HostPagePool(EXACT_MOVED * pps, paged_page_bytes(cfg, PAGE))
    tokens = torch.tensor([int(p[-1]) for p in prompts], device="cuda")
    active = torch.ones(DECODE_SLOTS, dtype=torch.bool, device="cuda")
    errs = []
    with torch.inference_mode():
        for slot, c in enumerate(ctx):
            src, _ = prefill(params, torch.from_numpy(
                c[None].astype(np.int64)).cuda())
            for i in range(cfg.depth):
                ccache[f"k{i}"][slot] = src[f"k{i}"][0]
                ccache[f"v{i}"][slot] = src[f"v{i}"][0]
            insert(pcache, bt[slot], src)
        ccache["len"].copy_(pcache["len"])
        for n_step in range(2):
            ccache, c_logits = c_step(params, ccache, tokens, active)
            bt_dev = torch.from_numpy(bt).cuda().long()
            pcache, p_logits = p_step(params, pcache, bt_dev, tokens, active)
            kv_equal = all(torch.equal(
                pcache[f"p{kind}{i}"][bt_dev].reshape(
                    ccache[f"{kind}{i}"].shape), ccache[f"{kind}{i}"])
                for i in range(cfg.depth) for kind in ("k", "v"))
            errs.append(max_err(p_logits, c_logits))
            log(f"  paged vs contiguous step {n_step} at {DECODE_SLOTS} "
                f"slots: logits max |diff| {errs[-1]:.3e}, bit-equal "
                f"{torch.equal(p_logits, c_logits)}; k/v bit-equal "
                f"{kv_equal}; len equal "
                f"{torch.equal(pcache['len'], ccache['len'])}")
            if not (torch.equal(p_logits, c_logits) and kv_equal
                    and torch.equal(pcache["len"], ccache["len"])):
                raise AssertionError("the paged step differs from the "
                                     "contiguous step on the same context")
            tokens = torch.argmax(c_logits, dim=-1)
            if n_step:
                break
            for slot in range(EXACT_MOVED):
                old = torch.from_numpy(bt[slot]).cuda().long()
                blk = gather(pcache, old)
                handles = [host.stage(blk[j]) for j in range(pps)]
                if any(h is None for h in handles):
                    raise AssertionError("the host tier ran out of slots")
                back = torch.empty_like(blk)
                for j, h in enumerate(handles):
                    back[j].view(-1).view(torch.uint8).copy_(host.fetch(h))
                    host.free(h)
                new = 1 + (DECODE_SLOTS + slot) * pps + np.arange(
                    pps, dtype=np.int32)
                scatter(pcache, torch.from_numpy(new).cuda().long(), back)
                for i in range(cfg.depth):
                    pcache[f"pk{i}"][old] = float("nan")
                    pcache[f"pv{i}"][old] = float("nan")
                bt[slot] = new
    staged = host.stats()["staged"]
    del ccache, pcache, host
    return dict(logits_max_abs_diff=errs, moved_slots=EXACT_MOVED,
                pages_staged=staged)


def phase_paged_prefix(ep, svc: LMService, paged: LMService,
                       cfg: LMConfig) -> dict:
    """(b) prefix sharing: a miss, three partial hits, one full hit."""
    rng = np.random.default_rng(11)
    head = rng.integers(0, cfg.vocab, PREFIX_HEAD, dtype=np.int32)
    prompts = [np.concatenate([head, rng.integers(
        0, cfg.vocab, PREFIX_PROMPT - PREFIX_HEAD, dtype=np.int32)])
        for _ in range(4)]
    batcher = paged.batcher()
    ev0 = prefix_event_counters()
    catchup0 = sched_counters()["sched_catchup_slice"]
    FLASH_FWD.launches = 0
    clients = []
    for group, stagger in ((prompts[:1], 0.0), (prompts[1:], DECODE_STAGGER_S),
                           (prompts[:1], 0.0)):
        got, _, _ = run_decode_sessions(ep, "LMPrefix", group, stagger,
                                        batcher)
        clients += got
    launches = FLASH_FWD.launches
    ev = {k: v - ev0[k] for k, v in prefix_event_counters().items()}
    catchup = sched_counters()["sched_catchup_slice"] - catchup0
    ttfts = [c.ttft_s * 1e3 for c in clients]
    log(f"  (b) prompts of {PREFIX_PROMPT} tokens on one {PREFIX_HEAD}-token "
        f"head: prefix events {ev}, {catchup} catch-up slices, prefills "
        f"{batcher.prefills_run}, flash_fwd launches {launches} (expected "
        f"{cfg.depth}); TTFT ms miss {ttfts[0]:.1f}, partial hits "
        f"{', '.join(f'{t:.1f}' for t in ttfts[1:4])}, full hit "
        f"{ttfts[4]:.1f}")
    if (ev["prefix_miss"], ev["prefix_partial_hit"], ev["prefix_hit"]) \
            != (1, 3, 1) or launches != cfg.depth \
            or batcher.prefills_run != 1 or catchup < 3:
        raise AssertionError("the prefix cache did not alias as expected")
    res = dict(events=ev, catchup_slices=catchup, launches=launches,
               ttft_ms=ttfts)
    res.update(hold_tokens("(b)", svc, cfg, clients))
    if not batcher.shutdown():
        raise AssertionError("the paged batcher did not stop")
    return res


def phase_paged_spill(ep, svc: LMService, paged: LMService,
                      cfg: LMConfig) -> dict:
    """(c) four sessions that need more pages than the pool holds: spills
    to the host tier and resumes."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, SPILL_PROMPT, dtype=np.int32)
               for _ in range(SPILL_SLOTS)]
    batcher = paged.batcher()
    snap = phase_snapshot()
    clients, wall_s, _, launches = run_counted(
        ep, "LMSpill", prompts, DECODE_STAGGER_S, batcher)
    d = phase_deltas(snap)
    joins = batcher.prefills_run
    log(f"  (c) {SPILL_SLOTS} sessions of {SPILL_PROMPT} tokens on "
        f"{SPILL_POOL - 1} usable pages with {HOST_SLOTS} host slots: all "
        f"'finished' in {wall_s:.3f} s; spills {batcher.spills}, resumes "
        f"{batcher.resumes}; host_spill {d['host_spill'][2]:.3f} ms and "
        f"host_resume {d['host_resume'][2]:.3f} ms each "
        f"({d['host_spill'][0]} / {d['host_resume'][0]} samples); "
        f"flash_fwd launches {launches} (expected {cfg.depth * joins})")
    if batcher.spills < 1 or batcher.resumes != batcher.spills \
            or launches != cfg.depth * joins or joins != SPILL_SLOTS:
        raise AssertionError("the sessions did not spill and resume")
    res = dict(wall_s=wall_s, spills=batcher.spills,
               resumes=batcher.resumes, host_spill_ms=d["host_spill"][2],
               host_resume_ms=d["host_resume"][2], launches=launches)
    res.update(hold_tokens("(c)", svc, cfg, clients))
    if not batcher.shutdown():
        raise AssertionError("the paged batcher did not stop")
    return res


def phase_spec(ep, svc: LMService, spec: LMService, plain: LMService,
               cfg: LMConfig) -> dict:
    """(d) speculative decoding against plain paged decoding on the same
    prompts, then one profiled spec round and one plain round at the
    same positions."""
    prompts = decode_prompts(cfg, 8, SPEC_SLOTS, SPEC_PROMPT_LENS)
    res = {}
    for name, service in (("plain", plain), ("spec", spec)):
        batcher = service.batcher()
        snap = phase_snapshot()
        spec0 = spec_counters()
        clients, wall_s, _, launches = run_counted(
            ep, "LMSpecPlain" if name == "plain" else "LMSpec", prompts,
            DECODE_STAGGER_S, batcher)
        d = phase_deltas(snap)
        sp = {k: v - spec0[k] for k, v in spec_counters().items()}
        joins = batcher.prefills_run
        tokens = sum(len(c.tokens) for c in clients)
        rounds, _, round_ms = d["decode_round"]
        want = cfg.depth * joins * (2 if name == "spec" else 1)
        log(f"  (d) {name}: {tokens} tokens in {wall_s:.3f} s = "
            f"{tokens / wall_s:.1f} tok/s; {rounds} rounds, {round_ms:.3f} "
            f"ms each, {tokens / rounds:.2f} tokens per round; flash_fwd "
            f"launches {launches} (expected {want})")
        if launches != want or joins != len(clients):
            raise AssertionError(f"the {name} path did not run the kernel "
                                 f"as expected")
        row = dict(tokens=tokens, wall_s=wall_s, tok_s=tokens / wall_s,
                   rounds=rounds, round_ms=round_ms, launches=launches)
        if name == "spec":
            proposed = sp["spec_accept"] + sp["spec_reject"]
            row.update(spec_rounds=sp["spec_round"],
                       fallbacks=sp["spec_fallback_plain"],
                       accept_rate=sp["spec_accept"] / max(proposed, 1),
                       draft_ms=d["spec_draft"][2],
                       verify_ms=d["spec_verify"][2])
            log(f"  spec rounds {sp['spec_round']}, fallbacks "
                f"{sp['spec_fallback_plain']}, accepted {sp['spec_accept']} "
                f"of {proposed} proposals ({row['accept_rate']:.3f}); draft "
                f"{row['draft_ms']:.3f} ms and verify {row['verify_ms']:.3f} "
                f"ms per round")
            if sp["spec_round"] < 1:
                raise AssertionError("no spec round ran")
        row.update(hold_tokens(f"(d) {name}", svc, cfg, clients))
        if not batcher.shutdown():
            raise AssertionError("the paged batcher did not stop")
        res[name] = row
    lens = np.asarray([len(p) for p in prompts], np.int32) \
        + DECODE_MAX_NEW // 2
    for name in ("spec", "plain"):
        res[name]["round_profile"] = profile_paged_rounds(
            cfg, svc.params, lens, spec=name == "spec")
    out = res["spec"]
    out.update(plain=res["plain"], plain_launches=res["plain"]["launches"])
    return out


def kv_deltas(kv0: dict, fb0: dict) -> tuple:
    """The handoff stats since ``kv0`` and the fallback reasons counted
    since ``fb0`` (only those that moved)."""
    kv = {k: v - kv0[k] for k, v in kv_stats().items()}
    fb = {k: v - fb0[k] for k, v in kv_fallback_counters().items()
          if v != fb0[k]}
    return kv, fb


def phase_disagg(ep, svc: LMService, tiers: dict, cfg: LMConfig,
                 six_b: dict) -> dict:
    """LM.Decode through prefill tiers handing sessions to a decode tier
    (phase 6d): four sub-phases, each decode tier's and prefill tier's
    batcher shut down after its own.  Returns their results and the
    forward kernel's launches over them (all on the prefill tiers)."""
    total = sum(n for _, _, n in kv_page_specs(cfg))
    if total != DISAGG_SESSION_BYTES:
        raise AssertionError(f"a session's pages hold {total} bytes")
    mem0 = torch.cuda.memory_allocated()
    res = {"ici": phase_disagg_ici(ep, svc, tiers, cfg, six_b),
           "copy": phase_disagg_copy(ep, svc, tiers, cfg)}
    shm = phase_disagg_shm(ep, svc, tiers, cfg, six_b, res["copy"])
    res["over_cap"] = phase_disagg_over_cap(ep, svc, tiers, cfg)
    res["paged"] = phase_disagg_paged(ep, svc, tiers, cfg)
    res["launches"] = sum(r["launches"] for r in res.values())
    res["shm"] = shm
    mem1 = torch.cuda.memory_allocated()
    log(f"  allocated on the card before 6d {mem0 / 1e9:.3f} GB, after "
        f"{mem1 / 1e9:.3f} GB")
    res["allocated_gb"] = [mem0 / 1e9, mem1 / 1e9]
    return res


def phase_disagg_ici(ep, svc: LMService, tiers: dict, cfg: LMConfig,
                     six_b: dict) -> dict:
    """(a) 6b's eight prompts over the ici lane into 8 contiguous decode
    slots."""
    prompts = decode_prompts(cfg, 5, DECODE_SLOTS)
    dec = tiers["dec"].batcher()
    kv0, fb0 = kv_stats(), kv_fallback_counters()
    snap = phase_snapshot()
    clients, wall_s, most_live, launches = run_counted(
        ep, "Prefill", prompts, DECODE_STAGGER_S, dec)
    d = phase_deltas(snap)
    kv, fb = kv_deltas(kv0, fb0)
    tokens = sum(len(c.tokens) for c in clients)
    ttfts = sorted(c.ttft_s * 1e3 for c in clients)
    calls = sorted(c.call_s * 1e3 for c in clients)
    rounds, _, round_ms = d["decode_round"]
    left = outstanding_pages()
    same = sum(c.tokens == t for c, t in zip(clients,
                                             six_b["session_tokens"]))
    log(f"  (a) {len(clients)} sessions over the ici lane into "
        f"{DECODE_SLOTS} decode slots: all closed 'finished', up to "
        f"{most_live} live; {tokens} tokens in {wall_s:.3f} s = "
        f"{tokens / wall_s:.1f} tok/s aggregate; {rounds} rounds, "
        f"{round_ms:.3f} ms each; {same} of {len(clients)} sessions "
        f"streamed 6b's tokens exactly")
    log(f"  TTFT median {statistics.median(ttfts):.1f} ms, max "
        f"{ttfts[-1]:.1f} ms (6b, monolithic, same prompts: "
        f"{six_b['ttft_median_ms']:.1f}, {six_b['ttft_max_ms']:.1f}); unary "
        f"Decode (prefill and handoff) median "
        f"{statistics.median(calls):.1f} ms, max {calls[-1]:.1f} ms")
    log(f"  handoffs {kv}; fallbacks {fb or 'none'}; flash_fwd launches "
        f"{launches} (depth {cfg.depth} x {len(prompts)} = "
        f"{cfg.depth * len(prompts)}); decode tier prefills "
        f"{dec.prefills_run}; pages left exported {left}")
    if kv["ici_sessions"] != len(prompts) or kv["sessions"] != len(prompts) \
            or kv["local_fallbacks"] or fb or dec.prefills_run or left \
            or launches != cfg.depth * len(prompts):
        raise AssertionError("the ici handoffs did not run as expected")
    res = dict(sessions=len(clients), tokens=tokens, wall_s=wall_s,
               aggregate_tok_s=tokens / wall_s, most_live=most_live,
               rounds=rounds, round_ms=round_ms, ttft_ms=ttfts,
               ttft_median_ms=statistics.median(ttfts),
               ttft_max_ms=ttfts[-1], call_ms=calls,
               call_median_ms=statistics.median(calls), handoffs=kv,
               same_as_6b=same, launches=launches)
    res.update(hold_tokens("(a)", svc, cfg, clients))
    if not dec.shutdown():
        raise AssertionError("the decode tier's batcher did not stop")
    return res


def phase_disagg_copy(ep, svc: LMService, tiers: dict,
                      cfg: LMConfig) -> dict:
    """(b) 6b's two chunk prompts over the copy lane, one session at a
    time, with the frame cap at DISAGG_COPY_CAP for the 256 MiB
    attachment; then the same two over the ici lane."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in CHUNK_PROMPT_LENS]
    dec = tiers["dec"].batcher()
    cap0 = get_flag("max_body_size")
    if not set_flag("max_body_size", DISAGG_COPY_CAP):
        raise AssertionError("max_body_size refused the copy lane's cap")
    rows = {}
    try:
        for lane, service in (("copy", "PrefillCopy"), ("ici", "Prefill")):
            kv0, fb0 = kv_stats(), kv_fallback_counters()
            FLASH_FWD.launches = 0
            clients = []
            for p in prompts:
                clients += run_decode_sessions(ep, service, [p], 0.0, dec)[0]
            launches = FLASH_FWD.launches
            kv, fb = kv_deltas(kv0, fb0)
            calls = [c.call_s * 1e3 for c in clients]
            log(f"  (b) {lane} lane, prompts {list(CHUNK_PROMPT_LENS)} one "
                f"after the other: unary Decode "
                f"{', '.join(f'{ms:.1f}' for ms in calls)} ms, TTFT "
                f"{', '.join(f'{c.ttft_s * 1e3:.1f}' for c in clients)} ms; "
                f"{kv[f'{lane}_sessions']} {lane} sessions, "
                f"{kv['bytes_moved']} bytes moved; fallbacks "
                f"{fb or 'none'}; flash_fwd launches {launches}")
            if kv[f"{lane}_sessions"] != len(prompts) or fb \
                    or kv["bytes_moved"] != len(prompts) \
                    * DISAGG_SESSION_BYTES or kv["local_fallbacks"] \
                    or launches != cfg.depth * len(prompts):
                raise AssertionError(f"the {lane}-lane handoffs did not run "
                                     f"as expected")
            row = dict(call_ms=calls,
                       ttft_ms=[c.ttft_s * 1e3 for c in clients],
                       bytes_moved=kv["bytes_moved"], launches=launches)
            row.update(hold_tokens(f"(b) {lane}", svc, cfg, clients))
            rows[lane] = row
        steps = copy_lane_steps(tiers["PrefillCopy"], cfg, prompts[0])
    finally:
        set_flag("max_body_size", cap0)
    extra = [c - i for c, i in zip(rows["copy"]["call_ms"],
                                   rows["ici"]["call_ms"])]
    gb_s = [DISAGG_SESSION_BYTES / (ms / 1e3) / 1e9 if ms > 0 else None
            for ms in extra]
    log(f"  (b) the copy lane costs {', '.join(f'{ms:.1f}' for ms in extra)} "
        f"ms more per session than the ici lane: "
        f"{', '.join(f'{g:.2f}' if g else '-' for g in gb_s)} GB/s over "
        f"{DISAGG_SESSION_BYTES} bytes (device to host, two host copies "
        f"to frame it, the loopback, two on receipt, host to device)")
    if not dec.shutdown():
        raise AssertionError("the decode tier's batcher did not stop")
    return dict(copy=rows["copy"], ici=rows["ici"], copy_extra_ms=extra,
                copy_gb_s=gb_s, copy_steps_ms=steps,
                launches=rows["copy"]["launches"] + rows["ici"]["launches"])


def shm_dir_line(path: str) -> str:
    st = os.statvfs(path)
    return (f"{path}: {st.f_blocks * st.f_frsize} bytes, "
            f"{st.f_bavail * st.f_frsize} free")


def phase_disagg_shm(ep, svc: LMService, tiers: dict, cfg: LMConfig,
                     six_b: dict, copy: dict) -> dict:
    """(e) the KV handoff on the forced shm lane, in one process: 6b's eight
    prompts through ``PrefillShm`` into 8 contiguous decode slots (each
    page copied once from the card into a slot of this process's ring and
    landed from it on the decode tier), every session 6b's tokens exactly,
    no fallback, no slot left; then 6b's two chunk prompts one at a time
    over the shm lane and over the ici lane, and the shm lane's steps
    outside the RPC.  The ring is rebuilt with KV_SHM_SLOTS slots of
    KV_SHM_SLOT_BYTES for the phase, for this process alone (so under
    ``tempfile.gettempdir()``, not /dev/shm), and rebuilt from the flags
    as they were after it."""
    log(f"  (e) {shm_dir_line(tempfile.gettempdir())}")
    saved = {k: get_flag(k) for k in ("rpc_shm_slot_bytes", "rpc_shm_slots")}
    if not shm_ring.reset_tx_ring(local_only=True):
        raise AssertionError("shm ring slots outstanding before 6d (e)")
    if not (set_flag("rpc_shm_slot_bytes", KV_SHM_SLOT_BYTES)
            and set_flag("rpc_shm_slots", KV_SHM_SLOTS)):
        raise AssertionError("the shm ring flags refused 6d (e)'s sizes")
    dec = tiers["dec"].batcher()
    try:
        t0 = time.perf_counter()
        ring = shm_ring.process_tx_ring()
        if ring is None:
            raise AssertionError("no shm ring could be made for 6d (e)")
        log(f"  (e) ring of {ring.nslots} x {ring.slot_bytes} bytes in "
            f"{os.path.dirname(ring.path)}, made in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        prompts = decode_prompts(cfg, 5, DECODE_SLOTS)
        kv0, fb0 = kv_stats(), kv_fallback_counters()
        st0 = shm_ring.shm_stats()
        clients, wall_s, most_live, launches = run_counted(
            ep, "PrefillShm", prompts, DECODE_STAGGER_S, dec)
        kv, fb = kv_deltas(kv0, fb0)
        staged = shm_ring.shm_stats()["staged"] - st0["staged"]
        left = shm_ring.outstanding_tx_slots()
        same = sum(c.tokens == t for c, t in zip(clients,
                                                 six_b["session_tokens"]))
        tokens = sum(len(c.tokens) for c in clients)
        ttfts = sorted(c.ttft_s * 1e3 for c in clients)
        log(f"  (e) {len(clients)} sessions over the shm lane into "
            f"{DECODE_SLOTS} decode slots: all closed 'finished', up to "
            f"{most_live} live; {tokens} tokens in {wall_s:.3f} s; "
            f"{same} of {len(clients)} sessions streamed 6b's tokens "
            f"exactly; TTFT median {statistics.median(ttfts):.1f} ms, max "
            f"{ttfts[-1]:.1f} ms; handoffs {kv}; fallbacks {fb or 'none'}; "
            f"{staged} pages staged, {left} slots outstanding; flash_fwd "
            f"launches {launches}; decode tier prefills {dec.prefills_run}")
        n_pages = len(kv_page_specs(cfg))
        if kv["shm_sessions"] != len(prompts) or kv["sessions"] \
                != len(prompts) or kv["local_fallbacks"] or fb or left \
                or staged != n_pages * len(prompts) or dec.prefills_run \
                or same != len(prompts) \
                or launches != cfg.depth * len(prompts):
            raise AssertionError("the shm handoffs did not run as expected")
        rng = np.random.default_rng(6)
        pair = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
                for n in CHUNK_PROMPT_LENS]
        rows = {}
        for lane, service in (("shm", "PrefillShm"), ("ici", "Prefill")):
            kv0, fb0 = kv_stats(), kv_fallback_counters()
            FLASH_FWD.launches = 0
            clients2 = []
            for p in pair:
                clients2 += run_decode_sessions(ep, service, [p], 0.0,
                                                dec)[0]
            pair_launches = FLASH_FWD.launches
            kv, fb = kv_deltas(kv0, fb0)
            rows[lane] = [c.call_s * 1e3 for c in clients2]
            log(f"  (e) {lane} lane, prompts {list(CHUNK_PROMPT_LENS)} one "
                f"after the other: unary Decode "
                f"{', '.join(f'{ms:.1f}' for ms in rows[lane])} ms; "
                f"{kv[f'{lane}_sessions']} {lane} sessions; fallbacks "
                f"{fb or 'none'}; flash_fwd launches {pair_launches}")
            if kv[f"{lane}_sessions"] != len(pair) or fb \
                    or pair_launches != cfg.depth * len(pair):
                raise AssertionError(f"the {lane}-lane handoffs of 6d (e) "
                                     f"did not run as expected")
            if lane == "shm":
                launches += pair_launches
        steps = shm_lane_steps(tiers["PrefillShm"], cfg, pair[0])
    finally:
        if not dec.shutdown():
            raise AssertionError("the decode tier's batcher did not stop")
        reset = shm_ring.reset_tx_ring()
        for k, v in saved.items():
            set_flag(k, v)
        if not reset:
            raise AssertionError("shm ring slots outstanding after 6d (e)")
    extra = [a - b for a, b in zip(rows["shm"], rows["ici"])]
    log(f"  (e) the shm lane costs {', '.join(f'{ms:.1f}' for ms in extra)} "
        f"ms more per session than the ici lane (6d (b)'s copy lane: "
        f"{', '.join(f'{ms:.1f}' for ms in copy['copy_extra_ms'])} ms); "
        f"{DISAGG_SESSION_BYTES} bytes a session, one device-to-host copy "
        f"into the ring and one host-to-device copy out of it")
    return dict(sessions=len(prompts), same_as_6b=same, ttft_ms=ttfts,
                wall_s=wall_s, shm_ms=rows["shm"], ici_ms=rows["ici"],
                shm_extra_ms=extra, shm_steps_ms=steps,
                copy_extra_ms=copy["copy_extra_ms"], launches=launches)


def shm_lane_steps(tier: PrefillService, cfg: LMConfig,
                   prompt: np.ndarray) -> dict:
    """One session's shm-lane work outside the RPC, on the host clock:
    staging (16 copies from the card into ring slots) and landing (16
    copies from the slots onto the card).  The landed pages must equal
    the exported ones; the slots are settled after."""
    with torch.inference_mode():
        cache1, ctx_len = bucketed_prefill(tier._ensure_prefill(), cfg,
                                           prompt)
    pages = export_decode_cache(cfg, cache1)
    torch.cuda.synchronize()
    ms = {}
    t0 = time.perf_counter()
    lane, descs, _, leases, why = KvTransport()._prepare_pages(LANE_SHM,
                                                              pages, None)
    ms["stage"] = (time.perf_counter() - t0) * 1e3
    if lane != LANE_SHM or why is not None:
        raise AssertionError(f"the shm lane demoted to {lane} under {why}")
    try:
        t0 = time.perf_counter()
        landed = import_pages(SessionManifest(
            LANE_SHM, 1, b"\0" * 8, ctx_len, 0, 1, b"", descs), None,
            kv_page_specs(cfg), "cuda")
        torch.cuda.synchronize()
        ms["land"] = (time.perf_counter() - t0) * 1e3
    finally:
        KvTransport._settle(leases)
    if not all(torch.equal(a, b) for a, (b, _) in zip(landed, pages)):
        raise AssertionError("the shm lane's pages did not land exactly")
    log(f"  (e) one session's shm-lane steps outside the RPC: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
        + f" ({DISAGG_SESSION_BYTES} bytes, "
        f"{DISAGG_SESSION_BYTES / (ms['stage'] / 1e3) / 1e9:.2f} GB/s "
        f"staged, {DISAGG_SESSION_BYTES / (ms['land'] / 1e3) / 1e9:.2f} "
        f"GB/s landed; pages bit-equal)")
    return ms


def copy_lane_steps(tier: PrefillService, cfg: LMConfig,
                    prompt: np.ndarray) -> dict:
    """One session's copy-lane work outside the RPC, each step timed on
    the host clock: staging (16 device-to-host copies and the join into
    one attachment), framing, unframing, and landing (a private copy of
    the attachment and 16 host-to-device copies).  What the copy lane
    costs beyond these is the loopback and the reads around it.  The
    landed pages must equal the exported ones."""
    with torch.inference_mode():
        cache1, ctx_len = bucketed_prefill(tier._ensure_prefill(), cfg,
                                           prompt)
    pages = export_decode_cache(cfg, cache1)
    torch.cuda.synchronize()
    ms = {}
    t0 = time.perf_counter()
    _, descs, att, _, _ = KvTransport()._prepare_pages(LANE_COPY, pages,
                                                       None)
    ms["stage"] = (time.perf_counter() - t0) * 1e3
    manifest = encode_manifest(SessionManifest(
        LANE_COPY, 1, b"\0" * 8, ctx_len, 0, 1, b"", descs))
    t0 = time.perf_counter()
    frame = pack_frame(RpcMeta(), manifest, att)
    ms["frame"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _, payload, got_att = unpack_frame(frame)
    ms["unframe"] = (time.perf_counter() - t0) * 1e3
    del frame
    t0 = time.perf_counter()
    landed = import_pages(decode_manifest(payload), got_att,
                          kv_page_specs(cfg), "cuda")
    torch.cuda.synchronize()
    ms["land"] = (time.perf_counter() - t0) * 1e3
    if not all(torch.equal(a, b) for a, (b, _) in zip(landed, pages)):
        raise AssertionError("the copy lane's pages did not land exactly")
    log(f"  (b) one session's copy-lane steps outside the RPC: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
        + f" ({DISAGG_SESSION_BYTES} bytes, pages landed bit-equal)")
    return ms


def failing_session(ep, service: str, prompt: np.ndarray) -> tuple:
    """One Decode call expected to fail: (error code, error text, the
    stream's close reason, tokens received), once its stream closed."""
    ch = Channel()
    ch.init(str(ep))
    cntl = Controller()
    cntl.timeout_ms = int(DECODE_TIMEOUT_S * 1000)
    toks, why, closed = [], [], threading.Event()

    def on_closed(st):
        why.append(st.close_reason)
        closed.set()

    stream_create(cntl, StreamOptions(
        on_received=lambda st, msgs: toks.extend(unpack_token(m)
                                                 for m in msgs),
        on_closed=on_closed))
    c = ch.call_method(f"{service}.Decode",
                       pack_generate_request(prompt[None], DECODE_MAX_NEW),
                       cntl=cntl)
    ok = closed.wait(DECODE_TIMEOUT_S)
    ch.close()
    if not ok:
        raise AssertionError(f"{service}'s stream never closed")
    return c.error_code, c.error_text, why[0], toks


def phase_disagg_over_cap(ep, svc: LMService, tiers: dict,
                          cfg: LMConfig) -> dict:
    """(c) the copy lane at the default frame cap: the 256 MiB handoff is
    refused where it is framed (``kv_import_rejected``, provably before
    the decode tier saw it), so the session decodes on the prefill tier
    from the same cache; then a strict tier closes its stream
    ``kv_handoff_failed``."""
    if max_body_size() != MAX_BODY_SIZE:
        raise AssertionError("the frame cap is not at its default")
    prompt = np.random.default_rng(6).integers(
        0, cfg.vocab, CHUNK_PROMPT_LENS[0], dtype=np.int32)
    local = tiers["PrefillCopy"].batcher()
    kv0, fb0 = kv_stats(), kv_fallback_counters()
    clients, _, _, launches = run_counted(ep, "PrefillCopy", [prompt], 0.0,
                                          local)
    kv, fb = kv_deltas(kv0, fb0)
    log(f"  (c) copy lane at the {MAX_BODY_SIZE}-byte cap: closed "
        f"'finished' after a local fallback; fallbacks {fb}, local "
        f"fallbacks {kv['local_fallbacks']}, handoffs {kv['sessions']}; "
        f"flash_fwd launches {launches}, prefills on the prefill tier's "
        f"batcher {local.prefills_run}")
    if fb != {"kv_import_rejected": 1} or kv["local_fallbacks"] != 1 \
            or kv["sessions"] or launches != cfg.depth or local.prefills_run:
        raise AssertionError("the over-cap session did not fall back as "
                             "named")
    res = dict(fallbacks=fb, local_fallbacks=kv["local_fallbacks"],
               call_ms=clients[0].call_s * 1e3)
    res.update(hold_tokens("(c)", svc, cfg, clients))
    if not local.shutdown():
        raise AssertionError("the prefill tier's batcher did not stop")
    kv0, fb0 = kv_stats(), kv_fallback_counters()
    FLASH_FWD.launches = 0
    code, text, reason, toks = failing_session(ep, "PrefillStrict", prompt)
    strict_launches = FLASH_FWD.launches
    kv, fb = kv_deltas(kv0, fb0)
    log(f"  (c) strict tier: [{code}] {text!r}, stream closed {reason!r} "
        f"after {len(toks)} tokens; fallbacks {fb}; flash_fwd launches "
        f"{strict_launches}")
    if code != int(Errno.EINTERNAL) or reason != "kv_handoff_failed" \
            or toks or fb != {"kv_import_rejected": 1} \
            or strict_launches != cfg.depth:
        raise AssertionError("the strict tier did not close as named")
    res.update(strict_error=[code, text], strict_close=reason,
               launches=launches + strict_launches)
    return res


def phase_disagg_paged(ep, svc: LMService, tiers: dict,
                       cfg: LMConfig) -> dict:
    """(d) four of 6b's prompts over the ici lane into 6c (a)'s paged
    decode tier: the imported caches land in pages, with no prefix
    lookup, no prefix insert and no prefill there."""
    prompts = decode_prompts(cfg, 5, DECODE_SLOTS)[:DISAGG_PAGED_SESSIONS]
    dec = tiers["dec_paged"].batcher()
    kv0, fb0 = kv_stats(), kv_fallback_counters()
    ev0 = prefix_event_counters()
    clients, wall_s, most_live, launches = run_counted(
        ep, "PrefillPaged", prompts, DECODE_STAGGER_S, dec)
    kv, fb = kv_deltas(kv0, fb0)
    ev = {k: v - ev0[k] for k, v in prefix_event_counters().items()
          if v != ev0[k]}
    alloc = dec.kv_stats()["alloc"]
    need = [-(-(len(p) - 1 + DECODE_MAX_NEW) // PAGE) for p in prompts]
    log(f"  (d) {len(clients)} sessions over the ici lane into {PAGED_SLOTS} "
        f"paged slots on {PAGED_POOL} pages: all closed 'finished' in "
        f"{wall_s:.3f} s, up to {most_live} live; peak pages "
        f"{alloc['peak_in_use']} (the sessions need {need}, {sum(need)} "
        f"together), {alloc['in_use']} in use after; prefix events "
        f"{ev or 'none'}; decode tier prefills {dec.prefills_run}; "
        f"handoffs {kv['ici_sessions']} ici, fallbacks {fb or 'none'}; "
        f"flash_fwd launches {launches}")
    if kv["ici_sessions"] != len(prompts) or fb or kv["local_fallbacks"] \
            or ev or dec.prefills_run or alloc["in_use"] \
            or not max(need) <= alloc["peak_in_use"] <= sum(need) \
            or launches != cfg.depth * len(prompts):
        raise AssertionError("the paged decode tier did not take the "
                             "handoffs as expected")
    res = dict(sessions=len(clients), wall_s=wall_s, most_live=most_live,
               pages_peak=alloc["peak_in_use"], pages_needed=need,
               launches=launches)
    res.update(hold_tokens("(d)", svc, cfg, clients))
    if not dec.shutdown():
        raise AssertionError("the paged decode tier's batcher did not stop")
    return res


def phase_logits(svc: LMService, cfg: LMConfig) -> float:
    """Prefill logits through the kernel vs through dense attention."""
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, 1024))).cuda()
    dense_cfg = LMConfig(**{**SLICE_CFG, "use_flash": False,
                            "attn_impl": "dense"})
    with torch.inference_mode():
        _, flash_logits = make_decode(cfg, "cuda")[0](svc.params, ids)
        _, dense_logits = make_decode(dense_cfg, "cuda")[0](svc.params, ids)
    err = max_err(flash_logits, dense_logits)
    top = float(dense_logits.abs().max())
    ok = err <= LOGIT_RTOL * top
    same_top = bool((flash_logits.argmax(-1) == dense_logits.argmax(-1)).all())
    log(f"  prefill logits, kernel vs dense attention: max abs err "
        f"{err:.3e}, max |logit| {top:.3f}, ratio {err / top:.3e} "
        f"(tolerance {LOGIT_RTOL}: {'ok' if ok else 'FAIL'}), same argmax "
        f"{same_top}")
    if not ok or not torch.isfinite(flash_logits).all():
        raise AssertionError("prefill logits through the kernel disagree")
    return err


def train_launches(cfg: LMConfig, accum: int = TRAIN_ACCUM) -> dict:
    """Kernel launches one train step must make: the forward kernel twice
    per block and microbatch (remat recomputes it), each backward kernel
    once."""
    n = cfg.depth * accum
    return {FLASH_FWD.name: 2 * n if cfg.remat else n,
            FLASH_DQ.name: n, FLASH_DKDV.name: n}


def phase_train(peaks: dict, base: dict = TRAIN_CFG,
                accum: int = TRAIN_ACCUM, micro: int = TRAIN_MICRO,
                steps: int = TRAIN_STEPS) -> dict:
    """Train an LM at full width: one step's loss and gradient at the
    initial params through the kernels against dense attention; then 1
    warm-up and ``steps`` timed steps on one fixed batch, the launch
    counts read around every step; one more step under the profiler.  The
    model FLOPs count each token's active params (an MoE token visits
    top_k of the experts)."""
    cfg = LMConfig(**base)
    params, ids, labels = train_batch(cfg, accum, micro)
    nparams = sum(p.numel() for p in tree_leaves(params))
    experts = sum(p.numel() for i in range(cfg.depth)
                  for p in params[f"blk{i}"].get("moe", {}).values()
                  if p.dim() == 3)
    active = nparams - experts + experts * cfg.moe_top_k // max(
        cfg.moe_experts, 1)
    tokens = ids.numel()
    log(f"  {nparams / 1e6:.1f} M params ({active / 1e6:.1f} M active per "
        f"token), batch {tuple(ids.shape)} as accum={accum} x {micro}, lr "
        f"{TRAIN_LR}")
    res = phase_train_vs_dense(params, ids, labels, base, accum)
    train_step = make_train_step(cfg, accum=accum)

    def step(params, ids, labels):
        return train_step(params, ids, labels, TRAIN_LR)

    want = train_launches(cfg, accum)
    log(f"  launches per step expected {want}")
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    total = dict.fromkeys(want, 0)
    for i in range(1 + steps):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        params, loss = step(params, ids, labels)
        loss = float(loss)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = read_launches()
        losses.append(loss)
        log(f"  step {i}{' [warm-up]' if i == 0 else ''}: loss {loss:.6f}, "
            f"{secs[-1] * 1e3:.1f} ms, launches {got}")
        if got != want:
            raise AssertionError(f"train step launched {got}, want {want}")
        for name in total:
            total[name] += got[name]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = statistics.median(secs[1:])
    model_flops = 6.0 * active * tokens
    res.update(params_m=nparams / 1e6, active_params_m=active / 1e6,
               tokens_per_step=tokens,
               losses=losses, step_s=secs, step_ms=step_s * 1e3,
               tokens_per_s=tokens / step_s,
               model_tflops=model_flops / step_s / 1e12,
               share_of_bf16_peak=model_flops / step_s / peaks["bf16"],
               peak_mem_gb=peak_gb, launches=total)
    log(f"  step {step_s * 1e3:.1f} ms (median of {steps}), "
        f"{res['tokens_per_s']:.0f} tokens/s, 6*N*T/time "
        f"{res['model_tflops']:.2f} TFLOP/s = {res['share_of_bf16_peak']:.4f}"
        f" of the {peaks['bf16'] / 1e12:.0f} TFLOP/s bf16 peak; peak memory "
        f"{peak_gb:.2f} GB")
    res.update(phase_train_profile(step, params, ids, labels, cfg, accum))
    res["params"] = params
    return res


def phase_train_profile(step, params, ids, labels, cfg: LMConfig,
                        accum: int) -> dict:
    """One step under torch.profiler: the backward kernels in its CUDA
    trace, the device busy share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, loss = step(params, ids, labels)
        float(loss)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_name.values())
    seen = {kern: sum(n for name, (n, _) in by_name.items()
                      if f"{kern}_kernel" in name)
            for kern in (FLASH_FWD.name, FLASH_DQ.name, FLASH_DKDV.name)}
    log(f"  profile of one step: {len(events)} CUDA events, kernels seen "
        f"{seen}; device busy {busy_us / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms wall ({busy_us / wall_us:.4f})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for kname, (n, us) in top:
        log(f"    {us / 1e3:9.3f} ms  {n:5d}x  {kname[:90]}")
    if seen != train_launches(cfg, accum):
        raise AssertionError(f"one step's trace shows {seen}, want "
                             f"{train_launches(cfg, accum)}")
    return dict(profile_busy_ms=busy_us / 1e3, profile_wall_ms=wall_us / 1e3,
                busy_share=busy_us / wall_us,
                top_kernels=[(k[:90], n, us / 1e3) for k, (n, us) in top])


def phase_train_vs_dense(params, ids, labels, base: dict, accum: int
                         ) -> dict:
    """One step's loss and gradient through the kernels vs through dense
    attention, on the same params and batch.  An MoE config routes each
    arm from its own attention's output, and a near-tie can route a token
    another way: its dense arm runs twice, with its own routing (the
    gradient's distance reported) and with the kernel arm's expert
    choices replayed (``moe.pinned_routing``; that gradient held)."""
    moe_cfg = base.get("moe_experts", 0) > 0

    def run(impl, pinned=None):
        cfg = LMConfig(**{**base, "use_flash": impl == "flash",
                          "attn_impl": impl})
        vg = make_value_and_grad(cfg, accum=accum)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if pinned is None:
            loss, grads = vg(params, ids, labels)
        else:
            with moe.pinned_routing(pinned):
                loss, grads = vg(params, ids, labels)
        loss = float(loss)
        torch.cuda.synchronize()
        return loss, tree_leaves(grads), time.perf_counter() - t0

    def rel_norm(g, ref):
        diff = sum(float((a - b).double().pow(2).sum())
                   for a, b in zip(g, ref))
        norm = sum(float(b.double().pow(2).sum()) for b in ref)
        return (diff / norm) ** 0.5

    with RouteLog() as routes:
        fl, fg, fs = run("flash")
    dl, dg, ds = run("dense")
    rel = rel_norm(fg, dg)
    del dg
    loss_rel = abs(fl - dl) / abs(dl)
    out = dict(dense_loss_rel=loss_rel, dense_grad_rel_norm=rel,
               vg_flash_ms=fs * 1e3, vg_dense_ms=ds * 1e3)
    held = rel
    if moe_cfg:
        pl, pg, _ = run("dense", [experts for experts, _ in routes.calls])
        held = rel_norm(fg, pg)
        del pg
        out.update(pinned_loss_rel=abs(fl - pl) / abs(pl),
                   pinned_grad_rel_norm=held)
        log(f"  the dense arm with the kernel arm's routing "
            f"({len(routes.calls)} route calls replayed): loss {pl:.6f} (rel "
            f"{out['pinned_loss_rel']:.3e}), gradient ||dg||/||g|| "
            f"{held:.3e}; with its own routing {rel:.3e} (reported)")
    del fg
    ok = loss_rel <= DENSE_LOSS_RTOL and held <= DENSE_GRAD_REL_NORM
    log(f"  one step, kernels vs dense attention: loss {fl:.6f} vs {dl:.6f}"
        f" (rel {loss_rel:.3e}, tolerance {DENSE_LOSS_RTOL}), gradient "
        f"||dg||/||g|| {held:.3e}{' (routing pinned)' if moe_cfg else ''} "
        f"(tolerance {DENSE_GRAD_REL_NORM}): {'ok' if ok else 'FAIL'}; "
        f"value_and_grad {fs * 1e3:.1f} ms flash, {ds * 1e3:.1f} ms dense "
        f"(one call each)")
    if not ok:
        raise AssertionError("the step through the kernels disagrees with "
                             "dense attention")
    return out


def phase_wide_lm() -> dict:
    """Phase 5w: the head-dim-256 LM (WIDE_CFG) on the card.  Served
    through a Server with attn_impl="auto": WIDE_REQUESTS' Generates,
    ``flash_fwd`` depth times a request and no backward launch; the same
    prompts through the same weights under dense attention (no launch);
    the tokens compared, and each prompt's prefill logits held to
    LOGIT_RTOL of the largest |logit| against dense attention's.  Then
    one step's loss and gradient with use_flash=True against dense
    attention (DENSE_LOSS_RTOL, DENSE_GRAD_REL_NORM) and one train step,
    the launch counts read around each."""
    cfg = LMConfig(**WIDE_CFG)
    dense_cfg = LMConfig(**{**WIDE_CFG, "attn_impl": "dense"})
    svc = LMService(cfg=cfg, device="cuda", seed=0, decode_slots=1)
    dense = LMService(cfg=dense_cfg, params=svc.params, device="cuda",
                      decode_slots=1)
    srv = Server()
    ch = Channel()
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
               for b, s, _ in WIDE_REQUESTS]
    res = dict(head_dim=cfg.dim // cfg.heads, depth=cfg.depth)
    # names of their own: the first server to register a method name
    # exposes its recorder, and phase 12 (e) reads phase 5's LM.Generate
    try:
        if srv.add_service(svc, name="LMWide") != 0 or srv.add_service(
                dense, name="LMWideDense") != 0 \
                or srv.start("127.0.0.1:0") != 0:
            raise RuntimeError("the wide LM's server did not start")
        ch.init(str(srv.listen_endpoint))
        info = json.loads(ch.call("LMWide.Info", b"", timeout_ms=60_000))
        if info["dim"] != cfg.dim or info["heads"] != cfg.heads:
            raise AssertionError(f"Info disagrees with WIDE_CFG: {info}")
        runs = {}
        for service in ("LMWide", "LMWideDense"):
            reset_launches()
            outs, ms = [], []
            for prompt, (b, s, max_new) in zip(prompts, WIDE_REQUESTS):
                t0 = time.perf_counter()
                out = generate(ch, prompt, max_new, service=service)
                ms.append((time.perf_counter() - t0) * 1e3)
                if out.shape != (b, max_new) or out.min() < 0 \
                        or out.max() >= cfg.vocab:
                    raise AssertionError(f"bad {service}.Generate output "
                                         f"{out.shape}")
                outs.append(out)
            runs[service] = (outs, ms, read_launches())
            log(f"  {service}.Generate {WIDE_REQUESTS}: "
                f"{' / '.join(f'{m:.1f}' for m in ms)} ms, launches "
                f"{runs[service][2]}")
    finally:
        ch.close()
        srv.stop()
        for service in (svc, dense):
            if service._batcher is not None:
                service._batcher.shutdown()
    want = {FLASH_FWD.name: cfg.depth * len(WIDE_REQUESTS),
            FLASH_DQ.name: 0, FLASH_DKDV.name: 0}
    if runs["LMWide"][2] != want:
        raise AssertionError(f"the wide LM's Generates launched "
                             f"{runs['LMWide'][2]}, want {want}")
    if any(runs["LMWideDense"][2].values()):
        raise AssertionError("dense attention launched a flash kernel")
    same = [bool(np.array_equal(a, b))
            for a, b in zip(runs["LMWide"][0], runs["LMWideDense"][0])]
    rel = []
    with torch.inference_mode():
        for prompt in prompts:
            ids = torch.from_numpy(prompt).long().cuda()
            _, fl = make_decode(cfg, "cuda")[0](svc.params, ids)
            _, dl = make_decode(dense_cfg, "cuda")[0](svc.params, ids)
            if not torch.isfinite(fl).all():
                raise AssertionError("wide LM logits not finite")
            rel.append(max_err(fl, dl) / float(dl.abs().max()))
    log(f"  tokens equal to dense attention's per request: {same}; prefill "
        f"logits max err / max |logit| {[f'{r:.3e}' for r in rel]} "
        f"(tolerance {LOGIT_RTOL})")
    if max(rel) > LOGIT_RTOL:
        raise AssertionError("the wide LM's prefill logits through the "
                             "kernel disagree with dense attention's")
    res.update(generate_ms=runs["LMWide"][1],
               dense_generate_ms=runs["LMWideDense"][1],
               launches_generate=runs["LMWide"][2][FLASH_FWD.name],
               tokens_equal=same, logits_rel_err=rel)
    del svc, dense
    torch.cuda.empty_cache()

    tcfg = LMConfig(**WIDE_TRAIN_CFG)
    params, ids, labels = train_batch(tcfg, 1, TRAIN_MICRO)
    want = train_launches(tcfg, 1)
    reset_launches()
    res.update(phase_train_vs_dense(params, ids, labels, WIDE_TRAIN_CFG, 1))
    vg_launches = read_launches()
    step = make_train_step(tcfg, accum=1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    _, loss = step(params, ids, labels, TRAIN_LR)
    loss = float(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    step_launches = read_launches()
    log(f"  train step (use_flash, remat, 1 x {TRAIN_MICRO} x {TRAIN_SEQ}): "
        f"loss {loss:.6f}, {step_ms:.1f} ms (first step, not warmed), "
        f"launches {step_launches}; value_and_grad launches {vg_launches} "
        f"(expected {want} each)")
    if vg_launches != want or step_launches != want:
        raise AssertionError("the wide LM's training did not launch the "
                             "kernels once per layer")
    if not np.isfinite(loss):
        raise AssertionError("the wide LM's train step loss is not finite")
    res.update(train_loss=loss, train_step_ms=step_ms,
               launches_train=step_launches, launches_vg=vg_launches)
    del params, ids, labels, step
    torch.cuda.empty_cache()
    return res


# -- phase 11: the parallel paths at world size one ------------------------

def phase_parallel(train: dict, moe_train: dict) -> dict:
    """Phase 11, in one process group of world size one over NCCL (a
    rendezvous file under the run's temp dir): (a) the collectives, (b)
    the dp x tp step at TRAIN_CFG, (c) the sp forward, (d) Ulysses over
    the flash kernel, (e) the MoE dp x tp (+ep) step, (f) the tiny dry run
    of every parallel path, (g) two processes (gloo step, device echo),
    (h) a device trace of a (b) step, (i) the dense/flash crossover."""
    res = {}
    with tempfile.TemporaryDirectory() as d:
        init_world(0, 1, "cuda", os.path.join(d, "rendezvous"))
        try:
            log("[11a] collectives at world size one")
            res["collectives"] = phase_collectives()
            log(f"[11b] dp x tp train step at {TRAIN_CFG}")
            res["dp_tp"] = phase_dp_tp_step(train)
            log("[11c] sequence-parallel forward (ring attention)")
            res["sp_forward"] = phase_sp_forward()
            log(f"[11d] Ulysses over the flash kernel at {TRAIN_SHAPE}")
            res["ulysses"] = phase_ulysses()
            torch.cuda.empty_cache()
            log(f"[11e] MoE dp x tp (+ep) train step at {MOE_TRAIN_CFG}")
            res["moe_dp_tp"] = phase_moe_dp_tp_step(moe_train)
            torch.cuda.empty_cache()
        finally:
            torch.distributed.destroy_process_group()
    log("[11f] dryrun_multichip(world=1, device='cuda')")
    t0 = time.perf_counter()
    lines = dryrun_multichip(1, "cuda")
    for line in lines:
        log(f"  {line}")
    res["dryrun_multichip"] = dict(lines=lines,
                                   s=time.perf_counter() - t0)
    log("[11g] two processes: a gloo PS step on the CPU, a device echo")
    t0 = time.perf_counter()
    lines = multiproc_dryrun.run(2, 2, echo_device="cuda")
    for line in lines:
        log(f"  {line}")
    echo_launches = sum(int(m.group(1)) for m in (
        re.search(r"checksum launches (\d+)", line) for line in lines) if m)
    if echo_launches != 3 * multiproc_dryrun.ECHOES:
        raise AssertionError(f"the echoes' checksums launched "
                             f"{echo_launches} kernels, want "
                             f"{3 * multiproc_dryrun.ECHOES}")
    res["two_processes"] = dict(lines=lines, s=time.perf_counter() - t0,
                                checksum_launches=echo_launches)
    log("[11i] dense attention against the flash kernel")
    res["crossover"] = phase_crossover()
    return res


def phase_collectives() -> dict:
    """(a) every MeshTransport method on a cuda tensor at world size one:
    JAX's n = 1 results (each the input itself), on the card, through
    NCCL; a CPU tensor on the cuda mesh raises."""
    backend = torch.distributed.get_backend()
    tr = MeshTransport(make_mesh((1,), ("ici",), "cuda"), "ici")
    x = torch.arange(4 * 8, dtype=torch.float32, device="cuda").reshape(4, 8)
    got = {"scatter": tr.scatter(x.cpu().numpy(), 0),
           "gather": torch.from_numpy(tr.gather(x)).cuda(),
           "replicate": tr.replicate(x.cpu().numpy()),
           "ring_shift": tr.ring_shift(x, 1), "all_gather": tr.all_gather(x),
           "psum": tr.psum(x), "reduce_scatter": tr.reduce_scatter(x),
           "all_to_all": tr.all_to_all(x, 1, 0)}
    torch.cuda.synchronize()
    bad = [k for k, v in got.items() if not (v.is_cuda and torch.equal(v, x))]
    try:
        tr.psum(x.cpu())
        refused = False
    except ValueError:
        refused = True
    log(f"  backend {backend}; {len(got)} methods equal to JAX's n = 1 "
        f"results on the card: {'ok' if not bad else bad}; a CPU tensor "
        f"refused: {refused}; {tr.endpoint(0)}")
    if backend != "nccl" or bad or not refused:
        raise AssertionError("a collective disagrees at world size one")
    return dict(backend=backend, methods=sorted(got))


def train_batch(cfg: LMConfig, accum: int, micro: int) -> tuple:
    """Phase 8's params (seed 0) and batch (seed 1)."""
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         "cuda")
    ids = torch.randint(0, cfg.vocab, (accum * micro, TRAIN_SEQ),
                        generator=torch.Generator(device="cuda")
                        .manual_seed(1), device="cuda")
    return params, ids, ids.roll(-1, -1)


def update_distance(old: dict, new_a: dict, new_b: dict) -> tuple:
    """||new_a - new_b|| / ||new_b - old|| over every leaf (the distance
    of the two updates, relative to the update), and whether the new
    params are bit-equal."""
    diff = norm = 0.0
    equal = True
    for o, a, b in zip(tree_leaves(old), tree_leaves(new_a),
                       tree_leaves(new_b)):
        diff += float((a - b).double().pow(2).sum())
        norm += float((b - o).double().pow(2).sum())
        equal = equal and torch.equal(a, b)
    return (diff / norm) ** 0.5, equal


def phase_dp_tp_step(train: dict) -> dict:
    """(b) make_train_step(mesh=dp x tp) at TRAIN_CFG on phase 8's params
    and batch: loss and new params against the unsharded step, launches
    per step, step ms beside phase 8's, one profiled step."""
    cfg = LMConfig(**TRAIN_CFG)
    mesh = make_mesh((1, 1), ("dp", "tp"), "cuda")
    params, ids, labels = train_batch(cfg, TRAIN_ACCUM, TRAIN_MICRO)
    plain = make_train_step(cfg, accum=TRAIN_ACCUM)
    sharded = make_train_step(cfg, mesh=mesh, accum=TRAIN_ACCUM)
    want_new, want_loss = plain(params, ids, labels, TRAIN_LR)
    want_loss = float(want_loss)
    want = train_launches(cfg)
    reset_launches()
    new, loss = sharded(params, ids, labels, TRAIN_LR)
    loss = float(loss)
    got = read_launches()
    dist_rel, equal = update_distance(params, new, want_new)
    del new, want_new
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    ok = (loss_rel <= DENSE_LOSS_RTOL and dist_rel <= DENSE_GRAD_REL_NORM
          and got == want)
    log(f"  loss {loss:.6f} vs the unsharded step's {want_loss:.6f} (rel "
        f"{loss_rel:.3e}, tolerance {DENSE_LOSS_RTOL}); new params "
        f"||d new|| / ||update|| {dist_rel:.3e} (tolerance "
        f"{DENSE_GRAD_REL_NORM}); bit-equal: {equal}; launches {got} "
        f"(expected {want}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the dp x tp step disagrees with the unsharded "
                             "step")

    def step(params, ids, labels):
        return sharded(params, ids, labels, TRAIN_LR)

    secs = []
    for i in range(3):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        _, l_i = step(params, ids, labels)
        float(l_i)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if read_launches() != want:
            raise AssertionError("a dp x tp step launched other counts")
    step_ms = statistics.median(secs[1:]) * 1e3
    log(f"  step {step_ms:.1f} ms (median of 2 after a warm-up; phase 8's "
        f"unsharded step {train['step_ms']:.1f} ms)")
    res = dict(loss=loss, unsharded_loss=want_loss, loss_rel=loss_rel,
               update_rel=dist_rel, bit_equal=equal, launches=got,
               step_ms=step_ms, step_s=secs, phase8_step_ms=train["step_ms"])
    res.update(phase_train_profile(step, params, ids, labels, cfg,
                                   TRAIN_ACCUM))
    log("[11h] profiling.collect_device_trace around (b)'s step")
    res["trace"] = phase_device_trace(step, params, ids, labels)
    return res


def phase_device_trace(step, params, ids, labels) -> dict:
    """(h) profiling.collect_device_trace over a window in which another
    thread runs (b)'s step again and again: the archive holds a Chrome
    trace that names the flash kernels."""
    stop = threading.Event()
    errors, steps = [], [0]

    def loop():
        try:
            while not stop.is_set():
                float(step(params, ids, labels)[1])
                steps[0] += 1
        except Exception as e:  # re-raised on the main thread below
            errors.append(e)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    try:
        data, name = profiling.collect_device_trace(TRACE_SECONDS)
    finally:
        stop.set()
        t.join(timeout=60)
    if errors or t.is_alive():
        raise AssertionError(f"the traced steps failed: {errors}")
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        member = tar.getmember("device_trace/trace.json")
        trace = json.load(tar.extractfile(member))
    names = [e.get("name", "") for e in trace.get("traceEvents", [])]
    seen = {kern.name: sum(f"{kern.name}_kernel" in n for n in names)
            for kern in (FLASH_FWD, FLASH_DQ, FLASH_DKDV)}
    log(f"  device trace {name}: {len(data)} bytes gzipped, {len(names)} "
        f"events over {TRACE_SECONDS} s, {steps[0]} steps run meanwhile; "
        f"kernel events {seen}")
    if not data or not seen[FLASH_FWD.name]:
        raise AssertionError("the device trace does not name flash_fwd")
    return dict(bytes=len(data), events=len(names), steps=steps[0],
                kernel_events=seen)


def phase_sp_forward() -> dict:
    """(c) make_forward(mesh=sp, sp_axis="sp") at TRAIN_CFG on (1, 2048)
    against the unsharded forward with dense attention."""
    cfg = LMConfig(**TRAIN_CFG)
    dense_cfg = LMConfig(**{**TRAIN_CFG, "use_flash": False,
                            "attn_impl": "dense"})
    mesh = make_mesh((1,), ("sp",), "cuda")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         "cuda")
    ids = torch.randint(0, cfg.vocab, (1, TRAIN_SEQ),
                        generator=torch.Generator(device="cuda")
                        .manual_seed(2), device="cuda")
    with torch.no_grad():
        got = make_forward(cfg, mesh=mesh, sp_axis="sp")(params, ids)
        want = make_forward(dense_cfg)(params, ids)
    err = max_err(got, want)
    top = float(want.abs().max())
    outside = float((~torch.isclose(got, want, rtol=SP_RTOL, atol=SP_ATOL))
                    .float().mean())
    ok = err <= LOGIT_RTOL * top and bool(torch.isfinite(got).all())
    log(f"  logits {tuple(got.shape)}: max abs err {err:.3e} against dense "
        f"attention, max |logit| {top:.3f}, ratio {err / top:.3e} "
        f"(tolerance {LOGIT_RTOL}): {'ok' if ok else 'FAIL'}; share outside "
        f"rtol {SP_RTOL} / atol {SP_ATOL}: {outside:.3e}")
    if not ok:
        raise AssertionError("the sp forward disagrees")
    return dict(max_abs_err=err, max_logit=top, share_outside_jax_tol=outside,
                shape=list(got.shape))


def phase_ulysses() -> dict:
    """(d) Ulysses with use_flash at (4, 2048, 16, 128) f32 causal: one
    flash_fwd launch a call, the output against the plain version, its
    ms beside a bare flash_attention call."""
    mesh = make_mesh((1,), ("sp",), "cuda")
    uly = make_ulysses_attention(mesh, "sp", causal=True, use_flash=True)
    q, k, v = qkv(TRAIN_SHAPE, torch.float32, seed=11)
    with torch.inference_mode():
        reset_launches()
        out = uly(q, k, v)
        torch.cuda.synchronize()
        launches = read_launches()
        plain, _ = flash_attention_plain(q, k, v, True)
        err = max_err(out, plain)
        ok = within(out, plain, TOL[torch.float32]) and launches == {
            FLASH_FWD.name: 1, FLASH_DQ.name: 0, FLASH_DKDV.name: 0}
        ms = time_ms(lambda: uly(q, k, v))
        bare_ms = time_ms(lambda: flash_attention(q, k, v, True))
    log(f"  launches {launches}; out err {err:.3e} against the plain version "
        f"(tolerance {TOL[torch.float32]}): {'ok' if ok else 'FAIL'}; "
        f"{ms:.4f} ms a call against {bare_ms:.4f} ms for flash_attention "
        f"alone (the two all_to_alls at n = 1: {ms - bare_ms:+.4f} ms)")
    if not ok:
        raise AssertionError("Ulysses over the flash kernel disagrees")
    return dict(launches=launches[FLASH_FWD.name], max_abs_err=err, ms=ms,
                flash_ms=bare_ms, all_to_all_ms=ms - bare_ms)


def phase_moe_dp_tp_step(moe_train: dict) -> dict:
    """(e) one MoE dp x tp (+ep) step at MOE_TRAIN_CFG on 8m's params and
    batch: its loss against 8m's unsharded loss at the same params."""
    cfg = LMConfig(**MOE_TRAIN_CFG)
    mesh = make_mesh((1, 1), ("dp", "tp"), "cuda")
    params, ids, labels = train_batch(cfg, MOE_TRAIN_ACCUM, MOE_TRAIN_MICRO)
    want = train_launches(cfg, MOE_TRAIN_ACCUM)
    step = make_train_step(cfg, mesh=mesh, accum=MOE_TRAIN_ACCUM)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    _, loss = step(params, ids, labels, TRAIN_LR)
    loss = float(loss)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = read_launches()
    ref = moe_train["losses"][0]
    rel = abs(loss - ref) / abs(ref)
    ok = rel <= DENSE_LOSS_RTOL and got == want
    log(f"  loss {loss:.6f} vs 8m's unsharded {ref:.6f} (rel {rel:.3e}, "
        f"tolerance {DENSE_LOSS_RTOL}; equal: {loss == ref}); launches {got} "
        f"(expected {want}); {secs * 1e3:.1f} ms (first call): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the MoE dp x tp step disagrees")
    return dict(loss=loss, unsharded_loss=ref, loss_rel=rel,
                equal=loss == ref, launches=got, ms=secs * 1e3)


def phase_checkpoint(params: dict) -> float:
    """Save the trained params and restore them onto the card: bit
    identical.  Returns the save + restore wall time in seconds."""
    state = {"params": params, "step": 1 + TRAIN_STEPS}
    with tempfile.TemporaryDirectory() as d:
        ckpt = TrainCheckpointer(d, max_to_keep=2)
        t0 = time.perf_counter()
        ckpt.save(1 + TRAIN_STEPS, state)
        got = ckpt.restore(like=abstract_like(state))
        ckpt.close()
        dt = time.perf_counter() - t0
    want = tree_leaves(params)
    pairs = list(zip(tree_leaves(got["params"]), want))
    ok = (got["step"] == state["step"] and len(pairs) == len(want)
          and all(a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
                  for a, b in pairs))
    nbytes = sum(b.numel() * b.element_size() for _, b in pairs)
    log(f"  checkpoint of {nbytes / 1e9:.3f} GB saved and restored onto "
        f"the card in {dt:.1f} s: {'bit-identical' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the restored params differ")
    return dt


class RouteLog:
    """While active, keeps ``(experts, probs)`` of every ``moe.route``
    call: the routing of each MoE block the programs run."""

    def __enter__(self):
        self.calls = []
        self._route = moe.route

        def route(params, x, cfg):
            out = self._route(params, x, cfg)
            self.calls.append((out[2].detach(), out[0].detach()))
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self._route


def router_margin(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Per token, the smallest gap between its sorted router
    probabilities down to the (k+1)-th: how far each choice is from
    flipping."""
    top = torch.sort(probs, dim=-1, descending=True).values[..., :k + 1]
    return (top[..., :-1] - top[..., 1:]).amin(dim=-1)


def phase_scan(svc: LMService, cfg: LMConfig) -> dict:
    """Phase 5s: ``scan_layers`` Generate.  The serving weights stacked
    along a leading depth axis, int8, behind one LMService; the same
    weights unrolled, int8, behind another.  One Generate each: equal
    tokens, ``flash_fwd`` once per layer on the stacked path; Decode on
    the stacked service answers EREQUEST with the JAX package's text."""
    scan_cfg = LMConfig(**SCAN_CFG)
    p = svc.params
    stacked = {"embed": p["embed"], "unembed": p["unembed"],
               "blocks": {k: torch.stack([p[f"blk{i}"][k]
                                          for i in range(cfg.depth)])
                          for k in p["blk0"]}}
    scan = LMService(cfg=scan_cfg, params=stacked, device="cuda",
                     quantize=True)
    flat = LMService(cfg=cfg, params=p, device="cuda", quantize=True)
    srv, ch = Server(), Channel()
    try:
        if srv.add_service(scan, name="LMScan") != 0 or srv.add_service(
                flat, name="LMInt8") != 0 or srv.start("127.0.0.1:0") != 0:
            raise RuntimeError("the scan services did not start")
        ch.init(str(srv.listen_endpoint))
        b, s, max_new = SCAN_REQUEST
        prompt = np.random.default_rng(9).integers(0, cfg.vocab, (b, s),
                                                   dtype=np.int32)
        FLASH_FWD.launches = 0
        t0 = time.perf_counter()
        got = generate(ch, prompt, max_new, "LMScan")
        dt = time.perf_counter() - t0
        launches = FLASH_FWD.launches
        want = generate(ch, prompt, max_new, "LMInt8")
        same = bool(np.array_equal(got, want))
        code, text = refused_decode(ch, "LMScan", prompt[:, :8])
        log(f"  scan_layers int8 Generate b={b} s={s} max_new={max_new}: "
            f"{dt * 1e3:.1f} ms end to end (first call); tokens equal to "
            f"the unrolled int8 service's on the same weights: {same}; "
            f"flash_fwd launches {launches} (expected {cfg.depth}); Decode "
            f"answered [{code}] {text!r}")
        if not same or launches != cfg.depth \
                or (code, text) != (int(Errno.EREQUEST),
                                    "Decode serves unrolled configs only"):
            raise AssertionError("the scan_layers path did not serve as "
                                 "the unrolled one")
        return dict(ms=dt * 1e3, launches=launches, same_tokens=same,
                    param_bytes=scan._param_bytes,
                    decode_refusal=[code, text])
    finally:
        ch.close()
        srv.stop()


# ---------------------------------------------------------------------------
# Phase 12: observability at full width (rpcz spans, MethodStatus, bvar,
# lm_telemetry)
# ---------------------------------------------------------------------------

_trace_ids = itertools.count(0x12A0_0001)     # a fresh id for each trace


def trace_spans(trace_id: int, want: set, timeout_s: float = 30.0) -> list:
    """The spans of ``trace_id`` in this process's store once it holds a
    span of every ``(method, is_server)`` in ``want`` (a session span
    finishes on its batcher's thread, after the stream has closed)."""
    deadline = time.monotonic() + timeout_s
    while True:
        spans = global_span_store().by_trace(trace_id)
        have = {(s.full_method, s.is_server) for s in spans}
        if want <= have:
            return spans
        if time.monotonic() > deadline:
            raise AssertionError(f"trace {trace_id:x} holds {sorted(have)}; "
                                 f"missing {sorted(want - have)}")
        time.sleep(0.01)


def one_span(spans: list, method: str, server: bool = True):
    found = [s for s in spans
             if s.full_method == method and s.is_server == server]
    if len(found) != 1:
        raise AssertionError(f"{len(found)} {method} spans "
                             f"({'server' if server else 'client'})")
    return found[0]


def notes(span) -> list:
    return [text for _, text in span.annotations]


def hold_session_notes(span, label: str, middle: tuple = (),
                       last: str = "lm_evict:finished") -> list:
    """A session span's annotations start with ``lm_join``, hold each of
    ``middle`` in that order, and end with ``last``."""
    n = notes(span)
    at = [n.index(t) if t in n else -1 for t in middle]
    if not n or n[0] != "lm_join" or n[-1] != last or -1 in at \
            or at != sorted(at):
        raise AssertionError(f"{label} session span notes {n}")
    return n


def phase_obs_generate(ch: Channel, cfg: LMConfig, srv: Server) -> dict:
    """(a) Traced Generate: a client and a server span per call, the
    server span parented to the client span; the legs of a call split by
    the spans' stamps; MethodStatus's percentiles over the calls."""
    rng = np.random.default_rng(12)
    b, s, max_new = REQUESTS[0]
    rows = []
    FLASH_FWD.launches = 0
    for _ in range(TRACE_GENERATE):
        tid = next(_trace_ids)
        prompt = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
        cntl = Controller()
        cntl.timeout_ms = 600_000
        cntl.trace_id = tid
        t0 = time.perf_counter()
        c = ch.call_method("LM.Generate", pack_generate_request(prompt,
                                                                max_new),
                           cntl=cntl)
        host_ms = (time.perf_counter() - t0) * 1e3
        if c.failed:
            raise RuntimeError(f"traced Generate failed: [{c.error_code}] "
                               f"{c.error_text}")
        if unpack_generated(c.response).shape != (b, max_new):
            raise AssertionError("bad traced Generate shape")
        spans = trace_spans(tid, {("LM.Generate", True),
                                  ("LM.Generate", False)})
        client = one_span(spans, "LM.Generate", server=False)
        server = one_span(spans, "LM.Generate")
        if len(spans) != 2 or server.parent_span_id != client.span_id \
                or server.error_code or client.error_code \
                or client.span_id != cntl.span_id:
            raise AssertionError(
                f"trace {tid:x}: {[x.describe() for x in spans]}")
        rows.append(dict(
            host_ms=host_ms, client_us=client.latency_us,
            wire_us=client.latency_us - (server.end_us - server.received_us),
            queue_us=server.start_us - server.received_us,
            handler_us=server.end_us - server.start_us,
            request_size=server.request_size,
            response_size=server.response_size))
    launches = FLASH_FWD.launches
    # the sampler folds the calls' latencies into its window once a second
    time.sleep(1.1)
    st = srv.method_status("LM.Generate")
    p50_ms, p99_ms = st.latency.p50() / 1e3, st.latency.p99() / 1e3
    med = {k: statistics.median(r[k] for r in rows)
           for k in ("host_ms", "client_us", "wire_us", "queue_us",
                     "handler_us")}
    log(f"  (a) {TRACE_GENERATE} traced Generate b={b} s={s} "
        f"max_new={max_new}: each a client span and a server span parented "
        f"to it, error 0; medians: host {med['host_ms']:.2f} ms, client "
        f"span {med['client_us'] / 1e3:.3f} ms = wire "
        f"{med['wire_us'] / 1e3:.3f} + queue {med['queue_us'] / 1e3:.3f} + "
        f"handler {med['handler_us'] / 1e3:.3f} ms; request "
        f"{rows[0]['request_size']} B, response {rows[0]['response_size']} "
        f"B; MethodStatus p50 {p50_ms:.2f} ms, p99 {p99_ms:.2f} ms over "
        f"its window; flash_fwd launches {launches} (depth {cfg.depth} x "
        f"{TRACE_GENERATE})")
    if launches != cfg.depth * TRACE_GENERATE:
        raise AssertionError("a traced Generate did not run the kernel once "
                             "per layer")
    return dict(rows=rows, medians=med, launches=launches,
                status_p50_ms=p50_ms, status_p99_ms=p99_ms)


def phase_obs_decode(ep, svc: LMService, cfg: LMConfig) -> dict:
    """(b) One traced Decode through the contiguous batcher: its session
    span under the Decode server span, join ... first token ... evict."""
    tid = next(_trace_ids)
    prompt = np.random.default_rng(13).integers(0, cfg.vocab,
                                                TRACE_DECODE_PROMPT,
                                                dtype=np.int32)
    FLASH_FWD.launches = 0
    client = DecodeClient(ep, "LM", prompt, DECODE_MAX_NEW, trace_id=tid)
    client.run()
    launches = FLASH_FWD.launches
    if client.error or client.reason != "finished" \
            or len(client.tokens) != DECODE_MAX_NEW:
        raise AssertionError(f"traced Decode: error {client.error}, close "
                             f"{client.reason!r}, {len(client.tokens)} "
                             f"tokens")
    spans = trace_spans(tid, {("LM.Decode", True), ("LM.Decode", False),
                              ("LMService.DecodeSession", True)})
    server = one_span(spans, "LM.Decode")
    sess = one_span(spans, "LMService.DecodeSession")
    if sess.parent_span_id != server.span_id \
            or one_span(spans, "LM.Decode", False).span_id \
            != server.parent_span_id:
        raise AssertionError("the session span is not under the Decode "
                             "server span")
    n = hold_session_notes(sess, "(b)", ("lm_first_token",))
    first_us = [us for us, t in sess.annotations
                if t == "lm_first_token"][0]
    span_ttft_ms = (first_us - sess.received_us) / 1e3
    host_ttft_ms = client.ttft_s * 1e3
    log(f"  (b) traced Decode, prompt {TRACE_DECODE_PROMPT}, "
        f"{DECODE_MAX_NEW} new tokens: session span notes {n}; "
        f"lm_first_token {span_ttft_ms:.1f} ms after the session span's "
        f"start, host-clock TTFT {host_ttft_ms:.1f} ms; session span "
        f"{sess.latency_us / 1e3:.1f} ms; flash_fwd launches {launches}")
    if launches != cfg.depth:
        raise AssertionError("the traced Decode's join did not run the "
                             "kernel once per layer")
    return dict(notes=n, span_ttft_ms=span_ttft_ms,
                host_ttft_ms=host_ttft_ms,
                session_ms=sess.latency_us / 1e3, launches=launches)


def phase_obs_disagg(pre_ep, tiers: dict, cfg: LMConfig,
                     six_b: dict) -> dict:
    """(c) One traced Decode through the ici-lane prefill tier: one trace
    id from the client through both tiers, each session span under its
    tier's server span; 6b's tokens for the same prompt."""
    tid = next(_trace_ids)
    prompt = decode_prompts(cfg, 5, DECODE_SLOTS)[0]
    kv0, fb0 = kv_stats(), kv_fallback_counters()
    FLASH_FWD.launches = 0
    client = DecodeClient(pre_ep, "Prefill", prompt, DECODE_MAX_NEW,
                          trace_id=tid)
    client.run()
    launches = FLASH_FWD.launches
    kv, fb = kv_deltas(kv0, fb0)
    if client.error or client.reason != "finished":
        raise AssertionError(f"traced handoff: error {client.error}, close "
                             f"{client.reason!r}")
    spans = trace_spans(tid, {("Prefill.Decode", True),
                              ("LMService.DecodeSession", True),
                              ("KV.ImportSession", False),
                              ("KV.ImportSession", True),
                              ("KV.DecodeTierSession", True)})
    decode = one_span(spans, "Prefill.Decode")
    pre = one_span(spans, "LMService.DecodeSession")
    imp_c = one_span(spans, "KV.ImportSession", server=False)
    imp_s = one_span(spans, "KV.ImportSession")
    dec = one_span(spans, "KV.DecodeTierSession")
    pre_n = hold_session_notes(pre, "(c) prefill", ("lm_chunk_slice",),
                               last="lm_handoff")
    dec_n = hold_session_notes(dec, "(c) decode tier", ("lm_first_token",))
    if pre.parent_span_id != decode.span_id \
            or imp_c.parent_span_id != pre.span_id \
            or imp_s.parent_span_id != imp_c.span_id \
            or dec.parent_span_id != imp_s.span_id \
            or len(spans) != 6 or {s.trace_id for s in spans} != {tid}:
        raise AssertionError("the handoff's spans are not one tree")
    same = client.tokens == six_b["session_tokens"][0]
    records = [s.describe() for s in spans]
    roots = rpcz_stitch.build_tree(records)
    tree = rpcz_stitch.render_tree_text(records)
    log(f"  (c) traced Decode over the ici lane: prefill session notes "
        f"{pre_n}, decode-tier session notes {dec_n[:2]} ... "
        f"{dec_n[-1:]}; {len(roots)} root; tokens equal to 6b's for the "
        f"same prompt: {same}; handoffs {kv}, fallbacks {fb or 'none'}; "
        f"flash_fwd launches {launches}")
    for line in tree.rstrip().splitlines():
        log(f"    {line}")
    if not same or len(roots) != 1 or kv["ici_sessions"] != 1 or fb \
            or launches != cfg.depth:
        raise AssertionError("the traced handoff did not run as 6d (a)")
    tiers["dec"].batcher().shutdown()
    return dict(prefill_notes=pre_n, decode_notes=dec_n, tree=tree,
                launches=launches, trace_id=tid, spans=len(spans),
                import_ms=(imp_s.end_us - imp_s.received_us) / 1e3)


def phase_obs_spill(ep, paged: LMService, cfg: LMConfig) -> dict:
    """(d) 6c (c)'s spill setup with every session traced: the parked
    sessions' spans carry lm_spill, then lm_resume, as often as the
    batcher spilled and resumed."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, SPILL_PROMPT, dtype=np.int32)
               for _ in range(SPILL_SLOTS)]
    tids = [next(_trace_ids) for _ in prompts]
    batcher = paged.batcher()
    spills0, resumes0 = batcher.spills, batcher.resumes
    FLASH_FWD.launches = 0
    run_decode_sessions(ep, "LMSpill", prompts, DECODE_STAGGER_S, batcher,
                        trace_ids=tids)
    launches = FLASH_FWD.launches
    spills = batcher.spills - spills0
    resumes = batcher.resumes - resumes0
    sessions = [one_span(trace_spans(t, {("LMService.DecodeSession",
                                          True)}),
                         "LMService.DecodeSession") for t in tids]
    parked = []
    for sess in sessions:
        n = hold_session_notes(sess, "(d)", ("lm_first_token",))
        if "lm_spill" in n:
            hold_session_notes(sess, "(d) parked", ("lm_spill",
                                                    "lm_resume"))
            parked.append(n)
    n_spill = sum(notes(s).count("lm_spill") for s in sessions)
    n_resume = sum(notes(s).count("lm_resume") for s in sessions)
    log(f"  (d) {SPILL_SLOTS} traced sessions on LMSpill: spills {spills}, "
        f"resumes {resumes}; lm_spill {n_spill} and lm_resume {n_resume} "
        f"annotations; a parked session's notes "
        f"{parked[0] if parked else None}; "
        f"flash_fwd launches {launches}")
    if not spills or n_spill != spills or n_resume != resumes \
            or resumes != spills or launches != cfg.depth * SPILL_SLOTS:
        raise AssertionError("the parked sessions' spans do not carry "
                             "their spills and resumes")
    if not batcher.shutdown():
        raise AssertionError("the paged batcher did not stop")
    return dict(spills=spills, resumes=resumes, parked_notes=parked,
                launches=launches)


def tier_hists() -> tuple:
    """Copies of lm_telemetry's per-tier TTFT and ITL log2 histograms."""
    return ({t: list(h) for t, h in lm_telemetry._tier_ttft.items()},
            {t: list(h) for t, h in lm_telemetry._tier_itl.items()})


def hist_rows(before: dict, after: dict) -> dict:
    """p50/p95/p99 (ms, the bucket's upper bound) per tier of what the
    histograms gained between two copies."""
    out = {}
    for tier, h in after.items():
        d = [a - b for a, b in zip(h, before.get(tier, [0] * len(h)))]
        if sum(d):
            out[tier] = {q: lm_telemetry._hist_quantile_ms(d, f)
                         for q, f in (("p50", 0.5), ("p95", 0.95),
                                      ("p99", 0.99))}
    return out


def phase_obs_counters(srv: Server, six_b: dict) -> dict:
    """(e) MethodStatus counted every Generate made on this server, the
    exposition holds the families, and 6b's TTFT and ITL quantiles from
    the tier histograms."""
    st = srv.method_status("LM.Generate")
    want = len(REQUESTS) + 1 + TRACE_GENERATE   # phases 5, 6 and 12 (a)
    count, errors = st.latency.count(), st.errors.get_value()
    text = render_prometheus()
    families = ("rpc_server_lm_generate_latency",
                "rpc_server_lm_generate_count", "lm_step_phase_ns",
                "lm_ttft_ms", "lm_itl_ms")
    missing = [f for f in families if f"# TYPE {f} " not in text]
    # the first server to register LM.Generate exposes its recorder: ours
    exposed = find_exposed("rpc_server_lm_generate") is st.latency
    ttft, itl = six_b["tier_ttft_ms"], six_b["tier_itl_ms"]
    log(f"  (e) LM.Generate MethodStatus: {count} calls (expected {want}: "
        f"phase 5, the profiled request, (a)), {errors} errors; exposition "
        f"{len(text.splitlines())} lines, families "
        f"{'all present' if not missing else f'missing {missing}'}")
    log(f"  6b's tier histograms: TTFT {ttft} ms, ITL {itl} ms (log2 "
        f"buckets' upper bounds); 6b's host-clock TTFT median "
        f"{six_b['ttft_median_ms']:.1f} ms")
    if count != want or errors or missing or not exposed \
            or f"rpc_server_lm_generate_count {want}\n" not in text:
        raise AssertionError("the counters did not count what was served")
    return dict(generate_count=count, errors=errors,
                exposition_lines=len(text.splitlines()),
                tier_ttft_ms=ttft, tier_itl_ms=itl)


class TokenSink:
    """A stream as the batcher sees one (``bench.py``'s ``Rec``): counts
    the tokens written and keeps the close reason."""

    def __init__(self):
        self.closed = False
        self.close_reason = None
        self.n = 0
        self.id = 0
        self.options = StreamOptions()

    def write(self, data) -> int:
        self.n += 1
        return 0

    def close(self, reason=None) -> None:
        self.closed = True
        self.close_reason = reason


def paired_ab(arm, a, b, rounds: int) -> tuple:
    """``bench.py``'s paired A/B: ``arm(a)`` against ``arm(b)`` (rates)
    in alternating order; the median per-round (B - A) / B in percent,
    and every round's."""
    pcts = []
    for r in range(rounds):
        if r % 2 == 0:
            qa, qb = arm(a), arm(b)
        else:
            qb = arm(b)
            qa = arm(a)
        pcts.append((qb - qa) / qb * 100)
    return statistics.median(pcts), pcts


class Echo(Service):
    def Echo(self, cntl, request):
        return request


def phase_obs_overhead(svc: LMService, cfg: LMConfig) -> dict:
    """(f) The observer effect, by ``bench.py``'s methods: lm_telemetry on
    against off over decode sessions on the contiguous batcher, and
    traced against untraced 128-byte echoes over tpu_std, each beside
    its A-against-A control; and untraced echoes with rpcz on (passive
    sampling, what every earlier phase paid) against rpcz off."""
    t_start = time.perf_counter()
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab, OBS_PROMPT, dtype=np.int32)
               for _ in range(OBS_SESSIONS)]
    bat = svc.batcher()
    FLASH_FWD.launches = 0

    def telemetry_arm(on: bool) -> float:
        set_flag("lm_telemetry", on)
        sinks = [TokenSink() for _ in prompts]
        t0 = time.perf_counter()
        for sink, p in zip(sinks, prompts):
            bat.join(sink, p, OBS_NEW)
        while not all(s.closed for s in sinks):
            if time.perf_counter() - t0 > DECODE_TIMEOUT_S:
                raise AssertionError("an observer-effect session never "
                                     "closed")
            time.sleep(0.001)
        dt = time.perf_counter() - t0
        if any(s.close_reason != "finished" or s.n != OBS_NEW
               for s in sinks):
            raise AssertionError("an observer-effect session did not "
                                 "finish")
        return sum(s.n for s in sinks) / dt

    try:
        telemetry_arm(True)
        telemetry_arm(False)
        tel_pct, tel_rounds = paired_ab(telemetry_arm, True, False,
                                        OBS_ROUNDS)
        tel_noise, tel_noise_rounds = paired_ab(telemetry_arm, False, False,
                                                OBS_ROUNDS)
    finally:
        set_flag("lm_telemetry", True)
    launches = FLASH_FWD.launches
    bat.shutdown()
    t_mid = time.perf_counter()
    srv, ch = Server(), Channel()
    payload = bytes(128)
    try:
        if srv.add_service(Echo(), name="TR") != 0 \
                or srv.start("127.0.0.1:0") != 0:
            raise RuntimeError("the echo server did not start")
        ch.init(str(srv.listen_endpoint))

        def echo_arm(mode: str, secs: float = ECHO_ARM_S) -> float:
            """Echo calls a second: ``traced`` (a fresh trace id each),
            ``passive`` (untraced, rpcz on) or ``off`` (rpcz off)."""
            set_flag("enable_rpcz", mode != "off")
            n = 0
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < secs:
                cntl = Controller()
                cntl.timeout_ms = 10_000
                if mode == "traced":
                    cntl.trace_id = next(_trace_ids)
                c = ch.call_method("TR.Echo", payload, cntl=cntl)
                if c.failed or c.response != payload:
                    raise RuntimeError(f"echo failed: {c.error_text}")
                n += 1
            return n / (time.perf_counter() - t0)

        for mode in ("traced", "passive", "off"):
            echo_arm(mode, 0.2)
        echo_pct, echo_rounds = paired_ab(echo_arm, "traced", "passive",
                                          ECHO_ROUNDS)
        passive_pct, passive_rounds = paired_ab(echo_arm, "passive", "off",
                                                ECHO_ROUNDS)
        echo_noise, echo_noise_rounds = paired_ab(echo_arm, "passive",
                                                  "passive", ECHO_ROUNDS)
        traced_qps, plain_qps = echo_arm("traced"), echo_arm("passive")
    finally:
        set_flag("enable_rpcz", True)
        ch.close()
        srv.stop()
    global_span_store().clear()         # the echoes recorded ~1e4 spans
    t_end = time.perf_counter()
    log(f"  (f) lm_telemetry on vs off, {OBS_SESSIONS} sessions x "
        f"{OBS_NEW} tokens (prompt {OBS_PROMPT}) a arm, {OBS_ROUNDS} "
        f"rounds: overhead_pct {tel_pct:.2f} (rounds "
        f"{[round(x, 2) for x in tel_rounds]}), noise_pct {tel_noise:.2f} "
        f"(rounds {[round(x, 2) for x in tel_noise_rounds]}); "
        f"{t_mid - t_start:.1f} s; flash_fwd launches {launches}")
    log(f"  (f) traced vs untraced 128-byte echoes, {ECHO_ROUNDS} rounds "
        f"of {ECHO_ARM_S} s arms: overhead_pct {echo_pct:.2f} (rounds "
        f"{[round(x, 2) for x in echo_rounds]}), noise_pct "
        f"{echo_noise:.2f} (rounds "
        f"{[round(x, 2) for x in echo_noise_rounds]}); untraced with rpcz "
        f"on vs off: overhead_pct {passive_pct:.2f} (rounds "
        f"{[round(x, 2) for x in passive_rounds]}); traced "
        f"{traced_qps:.0f} calls/s, untraced {plain_qps:.0f}; "
        f"{t_end - t_mid:.1f} s")
    return dict(telemetry_overhead_pct=tel_pct, telemetry_rounds=tel_rounds,
                telemetry_noise_pct=tel_noise,
                telemetry_noise_rounds=tel_noise_rounds,
                trace_overhead_pct=echo_pct, trace_rounds=echo_rounds,
                trace_noise_pct=echo_noise,
                trace_noise_rounds=echo_noise_rounds,
                passive_overhead_pct=passive_pct,
                passive_rounds=passive_rounds,
                traced_qps=traced_qps, untraced_qps=plain_qps,
                launches=launches, seconds=t_end - t_start)


def phase_observability(ep, pre_ep, ch: Channel, srv: Server,
                        svc: LMService, paged: dict, tiers: dict,
                        cfg: LMConfig, six_b: dict, stitch=None) -> dict:
    """Phase 12, on the serving phases' services and servers.
    ``stitch(disagg)`` (phase 15 (e)) runs right after (c), while the
    span store still holds its trace, timed apart from phase 12."""
    t0 = time.perf_counter()
    res = {"generate": phase_obs_generate(ch, cfg, srv),
           "decode": phase_obs_decode(ep, svc, cfg),
           "disagg": phase_obs_disagg(pre_ep, tiers, cfg, six_b)}
    stitch_s = 0.0
    if stitch is not None:
        t1 = time.perf_counter()
        res["stitch"] = stitch(res["disagg"])
        stitch_s = time.perf_counter() - t1
    res["spill"] = phase_obs_spill(ep, paged["LMSpill"], cfg)
    res["counters"] = phase_obs_counters(srv, six_b)
    res["overhead"] = phase_obs_overhead(svc, cfg)
    res["launches"] = sum(r["launches"] for r in res.values()
                          if isinstance(r, dict) and "launches" in r)
    res["seconds"] = time.perf_counter() - t0 - stitch_s
    log(f"  phase 12: {res['seconds']:.1f} s; flash_fwd launches "
        f"{res['launches']}")
    return res


# -- phase 13: the overload and drain planes ----------------------------------

def gen_call(ch: Channel, prompt: np.ndarray, max_new: int, timeout_ms: int,
             service: str = "LM", cntl: Controller = None) -> Controller:
    """One Generate, its outcome in the returned controller."""
    cntl = cntl or Controller()
    cntl.timeout_ms = timeout_ms
    return ch.call_method(f"{service}.Generate",
                          pack_generate_request(prompt, max_new), cntl=cntl)


def wait_until(pred, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def shed_count(method: str) -> int:
    return deadline.shed_counters().get(("tpu_std", method), 0)


def admission_delta(before: dict) -> dict:
    after = admission.admission_counters()
    return {f"{t}/{v}": n - before.get((t, v), 0)
            for (t, v), n in sorted(after.items()) if n != before.get((t, v),
                                                                      0)}


def serve_lm(services: dict, options: ServerOptions = None) -> Server:
    server = Server(options)
    for name, service in services.items():
        if server.add_service(service, name=name) != 0:
            raise RuntimeError(f"{name} did not register")
    if server.start("127.0.0.1:0") != 0:
        raise RuntimeError("a phase 13 server did not start")
    return server


def phase_rob_shed(ch: Channel, srv: Server, cfg: LMConfig,
                   ref: tuple) -> dict:
    """(a) Two Generate calls from two threads on one connection: the
    second, whose budget is shorter than the first's handler time, is
    held back in the kernel while the first runs inline on the
    connection's consumer (the JAX server's rule), so it times out at its
    caller, and is then read with a fresh arrival stamp and run, unshed.
    Then a Generate whose budget is spent at its arrival is shed without
    running."""
    import socket as pysock
    prompt, want = ref
    out = {}
    sheds0 = shed_count("LM.Generate")
    FLASH_FWD.launches = 0
    first = threading.Thread(target=lambda: out.__setitem__(
        "first", gen_call(ch, prompt, len(want), 600_000)))
    first.start()
    wait_until(lambda: srv.inflight == 1, 30, "the first Generate")
    t0 = time.perf_counter()
    second = gen_call(ch, prompt, len(want), SHED_BUDGET_MS)
    second_ms = (time.perf_counter() - t0) * 1e3
    first.join(600)
    c = out["first"]
    if c.failed:
        raise RuntimeError(f"(a)'s first Generate failed: {c.error_text}")
    wait_until(lambda: FLASH_FWD.launches >= 2 * cfg.depth
               and srv.inflight == 0, 60, "the held-back Generate's run")
    launches = FLASH_FWD.launches
    held_sheds = shed_count("LM.Generate") - sheds0
    toks = unpack_generated(c.response)[0].tolist()
    # a budget spent at arrival: an explicit on-wire 0
    meta = RpcMeta()
    meta.correlation_id = 13
    meta.service_name, meta.method_name = "LM", "Generate"
    with pysock.create_connection(("127.0.0.1",
                                   srv.listen_endpoint.port)) as conn:
        conn.sendall(pack_frame(meta, pack_generate_request(prompt,
                                                            len(want)),
                                extra_meta=TLV_TIMEOUT + bytes(4)))
        doomed = read_frame(conn)[0]
    doomed_launches = FLASH_FWD.launches - launches
    doomed_sheds = shed_count("LM.Generate") - sheds0 - held_sheds
    log(f"  (a) two Generate {prompt.shape} x {len(want)} on one "
        f"connection: the first answered with phase 5's tokens "
        f"{toks == want}; the second ({SHED_BUDGET_MS} ms budget) "
        f"[{second.error_code}] after {second_ms:.1f} ms, then run, "
        f"deadline_shed_total{{lane=\"tpu_std\",method=\"LM.Generate\"}} "
        f"+{held_sheds}; flash_fwd launches {launches} (depth "
        f"{cfg.depth}); one spent at arrival [{doomed.error_code}], shed "
        f"+{doomed_sheds}, flash_fwd +{doomed_launches}; {card_line()}")
    if second.error_code != int(Errno.ERPCTIMEDOUT) or toks != want \
            or launches != 2 * cfg.depth or held_sheds:
        raise AssertionError("(a): the held-back Generate did not time out "
                             "at its caller and run after the first")
    if doomed.error_code != int(Errno.ERPCTIMEDOUT) or doomed_sheds != 1 \
            or doomed_launches:
        raise AssertionError("(a): the doomed Generate was not shed")
    return dict(second_ms=second_ms, sheds=doomed_sheds,
                launches=launches + doomed_launches)


def goodput_arm(ch: Channel, prompt: np.ndarray, max_new: int,
                budget_ms: int, seconds: float) -> tuple:
    """Bursts of GOODPUT_K Generates from as many threads on ``ch``'s one
    connection, each burst closed by an ``LM.Info`` after it, for
    ``seconds``: (completed within the budget per second, completed,
    failed)."""
    done = [0, 0]
    lock = threading.Lock()

    def client():
        c = gen_call(ch, prompt, max_new, budget_ms)
        with lock:
            done[1 if c.failed else 0] += 1

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        threads = [threading.Thread(target=client)
                   for _ in range(GOODPUT_K)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        ch.call("LM.Info", b"", timeout_ms=600_000)
    wall = time.perf_counter() - t0
    return done[0] / wall, done[0], done[1]


def phase_rob_goodput(ch: Channel, srv: Server, cfg: LMConfig) -> dict:
    """(b) Goodput under overload, after bench.py:2258-2400's paired,
    interleaved A/B of closed-loop bursts: GOODPUT_K calls at once on one
    connection, each budget GOODPUT_BUDGET_L x L (L: one warm request
    alone), so a burst offers twice what a budget holds; shedding on
    against off.  On the JAX server's transport the connection holds
    back what arrives while a call runs inline, and reads it with a fresh
    arrival stamp: nothing is shed, and every call runs."""
    b, s, max_new = GOODPUT_REQUEST
    prompt = np.random.default_rng(13).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)
    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        gen_call(ch, prompt, max_new, 600_000)
        lat.append((time.perf_counter() - t0) * 1e3)
    L = statistics.median(lat[1:])
    budget = max(1, int(GOODPUT_BUDGET_L * L))
    rows = {True: [], False: []}
    try:
        for r in range(GOODPUT_ROUNDS):
            for on in ([True, False] if r % 2 == 0 else [False, True]):
                set_flag("enable_deadline_shed", on)
                sheds0 = shed_count("LM.Generate")
                FLASH_FWD.launches = 0
                qps, good, bad = goodput_arm(ch, prompt, max_new, budget,
                                             GOODPUT_ARM_S)
                # calls whose callers timed out still run on the server
                # (the closing LM.Info was read after every one of them)
                for _ in range(2):
                    wait_until(lambda: srv.inflight == 0, 60,
                               "the arm's calls")
                    time.sleep(0.05)
                launches = FLASH_FWD.launches
                rows[on].append(dict(
                    goodput_per_s=qps, completed=good, failed=bad,
                    sheds=shed_count("LM.Generate") - sheds0,
                    launches=launches,
                    launches_per_completed=launches / max(good, 1)))
    finally:
        set_flag("enable_deadline_shed", True)
    med = {on: statistics.median(x["goodput_per_s"] for x in rows[on])
           for on in rows}
    log(f"  (b) L = {L:.1f} ms for Generate {GOODPUT_REQUEST} alone, "
        f"budget {budget} ms, bursts of {GOODPUT_K} on one connection, "
        f"{GOODPUT_ROUNDS} rounds of {GOODPUT_ARM_S} s arms; {card_line()}")
    for on in (True, False):
        log(f"      shedding {'on ' if on else 'off'}: goodput "
            + ", ".join(f"{x['goodput_per_s']:.2f}/s ({x['completed']} ok, "
                        f"{x['failed']} failed, {x['sheds']} shed, "
                        f"{x['launches_per_completed']:.1f} launches per "
                        f"completed)" for x in rows[on])
            + f"; median {med[on]:.2f}/s")
    # a call held back on the connection is read with a fresh arrival
    # stamp: none is late at dispatch, so every one runs, in both arms
    if not all(x["completed"] for on in rows for x in rows[on]) \
            or any(x["sheds"] for on in rows for x in rows[on]) \
            or any(x["launches"] != cfg.depth * (x["completed"]
                                                 + x["failed"])
                   for on in rows for x in rows[on]):
        raise AssertionError("(b): a call was shed, or one did not run")
    return dict(L_ms=L, budget_ms=budget, on=rows[True], off=rows[False],
                median_on=med[True], median_off=med[False],
                launches=sum(x["launches"] for on in rows
                             for x in rows[on]))


def connected_channels(ep, n: int, tenants=None) -> list:
    """``n`` channels without retries, each connected by an ``LM.Info``.
    A ``"single"`` connection is one per peer and signature, shared by
    every channel with it, so these ride pooled connections (their
    blocking calls take the fast lane's ``sync_call``): ``n`` more of them
    are made before the start, and ``n`` calls at once each take one."""
    ep = parse_endpoint(str(ep))
    pool = socket_pool_of(ep)
    warm = [pooled_socket(ep)[0] for _ in range(pool.free_count() + n)]
    for sid in warm:
        return_pooled_socket(sid)
    chans = []
    for i in range(n):
        opts = ChannelOptions()
        opts.tenant = tenants[i] if tenants else ""
        opts.max_retry = 0
        opts.connection_type = "pooled"
        c = Channel(opts)
        c.init(str(ep))
        c.call("LM.Info", b"", timeout_ms=60_000)
        chans.append(c)
    return chans


def concurrent_generates(ep, n: int, prompt: np.ndarray, max_new: int,
                         tenants=None) -> list:
    """``n`` Generates at once, each on a connection of its own (made
    before the start): ``(error code, host ms, tokens or None)`` each."""
    chans = connected_channels(ep, n, tenants)
    gate = threading.Barrier(n)
    out = [None] * n

    def run(i):
        gate.wait()
        t0 = time.perf_counter()
        c = gen_call(chans[i], prompt, max_new, 600_000)
        ms = (time.perf_counter() - t0) * 1e3
        out[i] = (c.error_code, ms, None if c.failed
                  else unpack_generated(c.response)[0].tolist())

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    for c in chans:
        c.close()
    return out


def phase_rob_admission(svc: LMService, cfg: LMConfig, ref: tuple) -> dict:
    """(c) A method cap of ADMIT_CAP with ADMIT_CALLS Generates in
    flight together; an "auto" limiter under an AUTO_BURST burst; two
    tenants under a fair capacity, one flooding."""
    prompt, want = ref
    elimit = int(Errno.ELIMIT)
    opts = ServerOptions()
    opts.method_max_concurrency = {"LM.Generate": ADMIT_CAP}
    stamps = ServerStamps()                 # traces a refusal that trips
    stamps.install()
    server = serve_lm({"LM": svc}, opts)
    traces = []
    try:
        before = admission.admission_counters()
        extra = connected_channels(server.listen_endpoint,
                                   ADMIT_CALLS - ADMIT_CAP)
        FLASH_FWD.launches = 0
        capped = {}
        t = threading.Thread(target=lambda: capped.__setitem__(
            "res", concurrent_generates(server.listen_endpoint, ADMIT_CAP,
                                        prompt, len(want))))
        t.start()
        st = server.method_status("LM.Generate")
        wait_until(lambda: st.inflight == ADMIT_CAP, 60, "the capped calls")
        # the calls over the cap, one after another while both capped
        # calls are in flight: each refusal timed alone beside the
        # running Generate, not among a burst of client threads
        rejected = []
        for c in extra:
            del stamps.stamps[:]
            t0 = time.monotonic_ns()
            code = gen_call(c, prompt, len(want), 600_000).error_code
            t1 = time.monotonic_ns()
            rejected.append(((t1 - t0) / 1e6, code))
            traces.append(stamps.call(t0, t1))
            c.close()
        t.join(600)
        launches = FLASH_FWD.launches
        verdicts = admission_delta(before)
    finally:
        stamps.remove()
        server.stop()
    served = [tok for code, _, tok in capped["res"] if code == 0]
    log(f"  (c) method cap {ADMIT_CAP} on LM.Generate: {len(served)} "
        f"served (phase 5's tokens: {all(x == want for x in served)}), "
        f"then {len(rejected)} calls over the cap answered "
        + ", ".join(f"[{code}] in {ms:.2f}" for ms, code in rejected)
        + f" ms; flash_fwd launches {launches}; overload_admission_total "
        f"+{verdicts}; {card_line()}")
    for (ms, _), tr in zip(rejected, traces):
        if ms >= 5.0:
            log(f"      a refusal over 5 ms, its server side (ms after the "
                f"call began): {tr}")
    if len(served) != ADMIT_CAP \
            or any(code != elimit or ms >= 5.0 for ms, code in rejected) \
            or launches != cfg.depth * ADMIT_CAP \
            or any(x != want for x in served) \
            or verdicts.get("-/method_cap") != len(rejected):
        raise AssertionError("(c): the method cap did not hold")
    cap = dict(served=len(served), elimit=len(rejected),
               elimit_ms=[ms for ms, _ in rejected], launches=launches,
               verdicts=verdicts)

    opts = ServerOptions()
    opts.method_max_concurrency = {"LM.Generate": "auto"}
    server = serve_lm({"LM": svc}, opts)
    try:
        st = server.method_status("LM.Generate")
        limit0 = st.live_max_concurrency()
        b, s, n_new = AUTO_REQUEST
        small = np.random.default_rng(14).integers(0, cfg.vocab, (b, s),
                                                   dtype=np.int32)
        FLASH_FWD.launches = 0
        res = concurrent_generates(server.listen_endpoint, AUTO_BURST,
                                   small, n_new)
        auto_launches = FLASH_FWD.launches
        limit1 = st.live_max_concurrency()
    finally:
        server.stop()
    codes = [code for code, _, _ in res]
    log(f"  (c) \"auto\" limiter ({st.limiter_kind()}) on LM.Generate, a "
        f"{AUTO_BURST}-call burst of {AUTO_REQUEST}: live limit {limit0} "
        f"before, {limit1} after; {codes.count(0)} served, "
        f"{codes.count(elimit)} ELIMIT; flash_fwd launches {auto_launches}")
    if st.limiter_kind() != "auto" or codes.count(0) + codes.count(elimit) \
            != AUTO_BURST or auto_launches != cfg.depth * codes.count(0):
        raise AssertionError("(c): the auto limiter's burst went wrong")
    auto = dict(limit_before=limit0, limit_after=limit1,
                served=codes.count(0), elimit=codes.count(elimit),
                launches=auto_launches)

    opts = ServerOptions()
    opts.tenant_fair_capacity = TENANT_CAPACITY
    server = serve_lm({"LM": svc}, opts)
    try:
        before = admission.admission_counters()
        FLASH_FWD.launches = 0
        flood = {}
        hot = threading.Thread(target=lambda: flood.__setitem__(
            "res", concurrent_generates(server.listen_endpoint,
                                        TENANT_FLOOD, prompt, len(want),
                                        ["hot"] * TENANT_FLOOD)))
        hot.start()
        wait_until(lambda: server.inflight >= TENANT_CAPACITY, 60,
                   "the hot tenant's calls")
        victim = concurrent_generates(server.listen_endpoint, 1, prompt,
                                      len(want), ["victim"])[0]
        hot.join(600)
        launches = FLASH_FWD.launches
        verdicts = admission_delta(before)
    finally:
        server.stop()
    hot_codes = [code for code, _, _ in flood["res"]]
    log(f"  (c) tenant_fair_capacity {TENANT_CAPACITY}: 'hot' floods "
        f"{TENANT_FLOOD} calls -> {hot_codes.count(0)} served, "
        f"{hot_codes.count(elimit)} ELIMIT; 'victim' [{victim[0]}] in "
        f"{victim[1]:.1f} ms; flash_fwd launches {launches}; "
        f"overload_admission_total +{verdicts}")
    if hot_codes.count(0) != TENANT_CAPACITY or victim[0] != 0 \
            or verdicts.get("hot/tenant_quota") \
            != TENANT_FLOOD - TENANT_CAPACITY \
            or launches != cfg.depth * (TENANT_CAPACITY + 1):
        raise AssertionError("(c): fair admission did not protect the "
                             "victim")
    fair = dict(hot_served=hot_codes.count(0),
                hot_elimit=hot_codes.count(elimit), victim_code=victim[0],
                victim_ms=victim[1], launches=launches, verdicts=verdicts)
    return dict(method_cap=cap, auto=auto, fair=fair,
                launches=cap["launches"] + auto_launches + launches)


class HoldSvc:
    """``Hold`` blocks its connection's worker until released."""

    def __init__(self):
        self.release = threading.Event()
        self.holding = 0

    def Hold(self, cntl, request):
        self.holding += 1
        self.release.wait(60)
        return b"released"


class CloseOnce:
    """``Generate`` closes its connection unanswered the first time, then
    serves through ``lm`` (a server that loses a connection mid-call)."""

    def __init__(self, lm: LMService):
        self.lm = lm
        self.closed = 0

    def Generate(self, cntl, request):
        if not self.closed:
            self.closed += 1
            Socket.address(cntl.socket_id).close()
            return b""
        return self.lm.Generate(cntl, request)


def session_pages(batcher) -> tuple:
    """Pages the batcher's sessions hold (the allocator's in use less the
    prefix cache's), host spills in flight, pages left exported."""
    st = batcher.kv_stats()
    held = st["alloc"]["in_use"] - st.get("prefix", {}).get("nodes", 0) \
        if "alloc" in st else 0
    return held, host_inflight_spills(), outstanding_pages()


def solo_prefix(svc: LMService, cfg: LMConfig, prompt: np.ndarray,
                tokens: list) -> bool:
    """``tokens`` are the solo generator's first ones, under check_tokens'
    near-tie rule (unequal first where the solo run's top-1 margin is
    below LOGIT_RTOL, and compared no further)."""
    if not tokens:
        return True
    want, margins = solo_reference(svc, cfg, prompt, len(tokens))
    for got, ref, margin in zip(tokens, want, margins):
        if got != ref:
            return margin < LOGIT_RTOL
    return True


def raw_generate(conn, cid: int, prompt: np.ndarray, max_new: int) -> RpcMeta:
    meta = RpcMeta()
    meta.correlation_id = cid
    meta.service_name, meta.method_name = "LM", "Generate"
    meta.timeout_ms = 60_000
    conn.sendall(pack_frame(meta, pack_generate_request(prompt, max_new)))
    while True:
        msg = read_frame(conn)
        if not isinstance(msg, AckFrame):
            return msg[0]


def phase_rob_drain(svc: LMService, spill: LMService, cfg: LMConfig,
                    ref: tuple) -> dict:
    """(d) Drain a server of its own carrying 6c (c)'s spill setup and the
    plain LM during DRAIN_STREAMS staggered Decode streams (at least one
    parked in the host tier) and one Generate in flight; then a second
    drain whose grace a held handler outlasts."""
    import socket as pysock
    prompt, want = ref
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, SPILL_PROMPT, dtype=np.int32)
               for _ in range(SPILL_SLOTS)]
    prompts += [rng.integers(0, cfg.vocab, DRAIN_SHORT_PROMPT,
                             dtype=np.int32)
                for _ in range(DRAIN_STREAMS - SPILL_SLOTS)]
    server = serve_lm({"LMSpill": spill, "LM": svc})
    batcher = spill.batcher()
    spills0 = batcher.spills
    probe = pysock.create_connection(("127.0.0.1",
                                      server.listen_endpoint.port))
    try:
        clients = [DecodeClient(server.listen_endpoint, "LMSpill", p,
                                DRAIN_MAX_NEW) for p in prompts]
        threads = [threading.Thread(target=c.run) for c in clients]
        FLASH_FWD.launches = 0
        for t in threads:
            t.start()
            time.sleep(DRAIN_STAGGER_S)
        wait_until(lambda: batcher.spills > spills0
                   and any(c.tokens for c in clients), 120,
                   "a spill and a first token")
        gen = {}
        gen_channel = Channel()
        gen_channel.init(str(server.listen_endpoint))
        g = threading.Thread(target=lambda: gen.__setitem__(
            "c", gen_call(gen_channel, prompt, len(want), 600_000)))
        g.start()
        gen_status = server.method_status("LM.Generate")
        wait_until(lambda: gen_status.inflight >= 1, 60, "the Generate")
        drained = {}
        t0 = time.perf_counter()
        d = threading.Thread(target=lambda: drained.__setitem__(
            "rc", server.drain(DRAIN_GRACE_MS)))
        d.start()
        wait_until(lambda: server.draining, 10, "the drain")
        state_during = find_exposed("server_drain_state").get_value()
        lame = raw_generate(probe, 7, prompt, len(want))
        d.join(60)
        drain_ms = (time.perf_counter() - t0) * 1e3
        g.join(600)
        for c in clients:
            if not c.done.wait(60):
                raise AssertionError("(d): a stream never closed")
        for t in threads:
            t.join(10)
        wait_until(lambda: session_pages(batcher) == (0, 0, 0), 60,
                   "the drained sessions' pages")
        left = session_pages(batcher)
        launches = FLASH_FWD.launches
        spills = batcher.spills - spills0
        gen_channel.close()
    finally:
        probe.close()
        server.stop()
    state_after = find_exposed("server_drain_state").get_value()
    gc = gen["c"]
    gen_ok = not gc.failed \
        and unpack_generated(gc.response)[0].tolist() == want
    reasons = [c.reason for c in clients]
    prefix_ok = [solo_prefix(svc, cfg, c.prompt, c.tokens) for c in clients]
    log(f"  (d) drain of a server carrying LMSpill and LM, "
        f"{DRAIN_STREAMS} Decode streams ({spills} spills) and a Generate "
        f"in flight: drain rc {drained.get('rc')} in {drain_ms:.1f} ms; the "
        f"Generate finished with phase 5's tokens {gen_ok}; a new Generate "
        f"[{lame.error_code}] lame_duck TLV {lame.lame_duck}; stream "
        f"reasons {reasons}, tokens delivered "
        f"{[len(c.tokens) for c in clients]}, prefixes of their solo runs "
        f"{all(prefix_ok)}; pages held by sessions, host spills in flight, "
        f"pages exported {left}; server_drain_state {state_during} during, "
        f"{state_after} after stop; flash_fwd launches {launches}; "
        f"{card_line()}")
    if drained.get("rc") != 0 or not gen_ok \
            or lame.error_code != int(Errno.ELAMEDUCK) or lame.lame_duck != 1 \
            or set(reasons) != {"lame_duck"} or not all(prefix_ok) \
            or left != (0, 0, 0) or spills < 1 or state_during != 1 \
            or state_after != 0:
        raise AssertionError("(d): the drain did not settle as it should")
    res = dict(rc=drained["rc"], drain_ms=drain_ms, spills=spills,
               tokens=[len(c.tokens) for c in clients], left=left,
               launches=launches)

    hold = HoldSvc()
    server = serve_lm({"Hold": hold})
    try:
        opts = ChannelOptions()
        opts.max_retry = 0
        opts.timeout_ms = 30_000
        ch = Channel(opts)
        ch.init(str(server.listen_endpoint))
        out = {}
        t = threading.Thread(target=lambda: out.__setitem__(
            "c", ch.call_method("Hold.Hold", b"")))
        t.start()
        wait_until(lambda: hold.holding == 1, 10, "the held handler")
        t0 = time.perf_counter()
        rc = server.drain(HOLD_GRACE_MS)
        grace_ms = (time.perf_counter() - t0) * 1e3
        t.join(10)
        forced = server.drain_force_closed
        hold.release.set()
        ch.close()
    finally:
        hold.release.set()
        server.stop()
    code = out["c"].error_code if "c" in out else None
    log(f"  (d) a handler held past a {HOLD_GRACE_MS} ms grace: drain rc "
        f"{rc} after {grace_ms:.1f} ms, force-closed {forced} connection "
        f"({DRAIN_FORCE_CLOSE_REASON}); the held call [{code}]")
    if rc != -1 or forced != 1 or code != int(Errno.EFAILEDSOCKET):
        raise AssertionError("(d): the grace did not force-close the "
                             "straggler")
    res.update(grace_rc=rc, grace_ms=grace_ms, force_closed=forced)
    return res


def phase_rob_retries(svc: LMService, cfg: LMConfig, ref: tuple) -> dict:
    """(e) A pooled backup that runs beside its primary; a retry after
    the server drops the connection; no backup once the budget is
    drained."""
    prompt, want = ref
    flaky = CloseOnce(svc)
    server = serve_lm({"LM": svc, "LMFlaky": flaky})
    try:
        opts = ChannelOptions()
        opts.connection_type = "pooled"
        opts.backup_request_ms = BACKUP_MS
        ch = Channel(opts)
        ch.init(str(server.listen_endpoint))
        FLASH_FWD.launches = 0
        t0 = time.perf_counter()
        c = gen_call(ch, prompt, len(want), 600_000)
        hedge_ms = (time.perf_counter() - t0) * 1e3
        wait_until(lambda: FLASH_FWD.launches >= 2 * cfg.depth, 60,
                   "the backup's run")
        hedge_launches = FLASH_FWD.launches
        hedge_ok = not c.failed \
            and unpack_generated(c.response)[0].tolist() == want
        hedge = dict(ms=hedge_ms, has_backup=c.has_backup_request,
                     retried=c.retried_count, launches=hedge_launches)
        ch.close()

        ch = Channel()
        ch.init(str(server.listen_endpoint))
        FLASH_FWD.launches = 0
        c = gen_call(ch, prompt, len(want), 600_000, service="LMFlaky")
        retry_launches = FLASH_FWD.launches
        retry_ok = not c.failed \
            and unpack_generated(c.response)[0].tolist() == want
        retry = dict(retried=c.retried_count, launches=retry_launches,
                     closed=flaky.closed)
        ch.close()

        opts = ChannelOptions()
        opts.connection_type = "pooled"
        opts.backup_request_ms = BACKUP_MS
        opts.retry_budget_max = 4
        ch = Channel(opts)
        ch.init(str(server.listen_endpoint))
        budget = ch.retry_budget()
        while budget.acquire():
            pass
        FLASH_FWD.launches = 0
        c = gen_call(ch, prompt, len(want), 600_000)
        time.sleep(0.2)
        drained_launches = FLASH_FWD.launches
        drained = dict(has_backup=c.has_backup_request,
                       launches=drained_launches,
                       denied=budget.denied_count)
        drained_ok = not c.failed
        ch.close()
    finally:
        server.stop()
    log(f"  (e) pooled backup at {BACKUP_MS} ms: has_backup_request "
        f"{hedge['has_backup']}, retried_count {hedge['retried']}, tokens "
        f"equal {hedge_ok}, {hedge_ms:.1f} ms, flash_fwd launches "
        f"{hedge_launches} (2 x depth); a dropped connection: "
        f"retried_count {retry['retried']}, tokens equal {retry_ok}, "
        f"launches {retry_launches}; budget drained: has_backup_request "
        f"{drained['has_backup']}, launches {drained_launches}, denied "
        f"{drained['denied']}; {card_line()}")
    if not hedge_ok or not hedge["has_backup"] or hedge["retried"] != 1 \
            or hedge_launches != 2 * cfg.depth or not retry_ok \
            or retry["retried"] != 1 or retry_launches != cfg.depth \
            or not drained_ok or drained["has_backup"] \
            or drained_launches != cfg.depth:
        raise AssertionError("(e): retries and backups went wrong")
    return dict(hedge=hedge, retry=retry, budget_drained=drained,
                launches=hedge_launches + retry_launches + drained_launches)


def phase_robustness(ch: Channel, srv: Server, svc: LMService,
                     paged: dict, cfg: LMConfig, rows: list) -> dict:
    """Phase 13, on the serving phases' services: the shed, goodput under
    overload, admission, the drain, retries and backups."""
    t0 = time.perf_counter()
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab, REQUESTS[0][:2], dtype=np.int32)
    ref = (prompt, rows[0]["tokens"])
    res = {"shed": phase_rob_shed(ch, srv, cfg, ref),
           "goodput": phase_rob_goodput(ch, srv, cfg),
           "admission": phase_rob_admission(svc, cfg, ref),
           "drain": phase_rob_drain(svc, paged["LMSpill"], cfg, ref),
           "retries": phase_rob_retries(svc, cfg, ref)}
    if not paged["LMSpill"].batcher().shutdown():
        raise AssertionError("the drained batcher did not stop")
    res["launches"] = sum(r["launches"] for r in res.values()
                          if isinstance(r, dict) and "launches" in r)
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 13: {res['seconds']:.1f} s; flash_fwd launches "
        f"{res['launches']}")
    return res


def refused_decode(ch: Channel, service: str, prompt: np.ndarray) -> tuple:
    """A Decode call with a stream attached that the service must refuse:
    ``(error code, error text)``."""
    cntl = Controller()
    cntl.timeout_ms = 60_000
    stream_create(cntl, StreamOptions())
    c = ch.call_method(f"{service}.Decode",
                       pack_generate_request(prompt, 4), cntl=cntl)
    return (c.error_code, c.error_text) if c.failed else (0, "")


# -- phase 14: the LM across replicas ------------------------------------


class Replicas:
    """Two paged replicas of phase 5's weights, each an LMService on a
    Server of its own (its own device lock, batcher and KV pool)."""

    def __init__(self, cfg: LMConfig, params, names=("A", "B")):
        self.names = names
        self.svcs = [LMService(cfg=cfg, params=params, device="cuda",
                               decode_slots=CLUSTER_SLOTS, paged=True,
                               page=PAGE) for _ in names]
        self.srvs = [serve_lm({"LM": svc}) for svc in self.svcs]

    @property
    def eps(self) -> list:
        return [srv.listen_endpoint for srv in self.srvs]

    def url(self) -> str:
        return "list://" + ",".join(str(ep) for ep in self.eps)

    def name_of(self, ep) -> str:
        return self.names[self.eps.index(ep)] if ep in self.eps else str(ep)

    def counts(self, method: str = "LM.Generate") -> list:
        return [srv.method_status(method).latency.count()
                for srv in self.srvs]

    def live_slots(self) -> int:
        return sum(svc.batcher().live_slots() for svc in self.svcs)

    def close(self) -> None:
        for srv in self.srvs:
            srv.stop()
        for svc in self.svcs:
            if svc._batcher is not None and not svc._batcher.shutdown():
                raise AssertionError("a replica's batcher did not stop")


def cluster_channel(url: str, lb: str, **opts) -> Channel:
    options = ChannelOptions()
    for key, value in opts.items():
        setattr(options, key, value)
    ch = Channel(options)
    if ch.init(url, lb) != 0:
        raise RuntimeError(f"cluster channel {url} {lb} did not init")
    return ch


def code_for(eps: list, target, lb: str = "c_murmurhash") -> int:
    """The smallest request code ``lb`` maps to ``target`` over ``eps``."""
    from brpc_tpu_torch.client.load_balancer import create_load_balancer
    from brpc_tpu_torch.client.naming_service import parse_server_line
    from brpc_tpu_torch.policy import load_balancers  # noqa: F401
    balancer = create_load_balancer(lb)
    balancer.reset_servers([parse_server_line(str(ep)) for ep in eps])
    cntl = Controller()
    for code in range(10_000):
        cntl.request_code = code
        if balancer.select_server(cntl) == target:
            return code
    raise AssertionError(f"no request code maps to {target}")


def head_code(head: np.ndarray) -> int:
    """A request code from a prompt head: the affinity key of its
    sessions."""
    import hashlib
    return int.from_bytes(hashlib.md5(head.tobytes()).digest()[:8],
                          "little")


class BusyLoop:
    """Generate calls of BUSY_REQUEST, one after another, on one replica
    until stopped (or ``n`` of them): that replica's device lock stays
    taken."""

    def __init__(self, ep, cfg: LMConfig, n: int = 0):
        self.ch = Channel()
        self.ch.init(str(ep))
        b, s, self.max_new = BUSY_REQUEST
        self.prompt = np.random.default_rng(3).integers(
            0, cfg.vocab, (b, s), dtype=np.int32)
        self.n, self.calls, self.failed = n, 0, 0
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run)
        self.thread.start()

    def _run(self) -> None:
        while not self.stop.is_set():
            c = gen_call(self.ch, self.prompt, self.max_new, 600_000)
            self.calls += 1
            self.failed += c.failed
            if self.n and self.calls >= self.n:
                return

    def join(self) -> None:
        self.stop.set()
        self.thread.join(600)
        self.ch.close()
        if self.thread.is_alive() or self.failed:
            raise AssertionError("the busy loop failed")


def phase_cl_spread(reps: Replicas, cfg: LMConfig, ref: tuple) -> dict:
    """(a) Four Generates through "rr": two on each replica, phase 5's
    tokens; then "la" with A kept busy."""
    prompt, want = ref
    ch = cluster_channel(reps.url(), "rr")
    n0 = reps.counts()
    l0 = FLASH_FWD.launches
    sides, ms = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        c = gen_call(ch, prompt, len(want), 600_000)
        ms.append((time.perf_counter() - t0) * 1e3)
        if c.failed or unpack_generated(c.response)[0].tolist() != want:
            raise AssertionError(f"(a) rr Generate: [{c.error_code}] "
                                 f"{c.error_text}, or other tokens")
        sides.append(reps.name_of(c.remote_side))
    ch.close()
    rr_launches = FLASH_FWD.launches - l0
    split = [n - m for n, m in zip(reps.counts(), n0)]
    busy = BusyLoop(reps.eps[0], cfg)
    ch = cluster_channel(reps.url(), "la")
    la_prompt = np.random.default_rng(4).integers(
        0, cfg.vocab, GOODPUT_REQUEST[:2], dtype=np.int32)
    la_sides, la_ms = [], []
    try:
        wait_until(lambda: reps.svcs[0]._device_lock.locked(), 60,
                   "A's busy loop")
        for _ in range(LA_CALLS):
            t0 = time.perf_counter()
            c = gen_call(ch, la_prompt, GOODPUT_REQUEST[2], 600_000)
            la_ms.append((time.perf_counter() - t0) * 1e3)
            if c.failed:
                raise AssertionError(f"(a) la Generate: [{c.error_code}] "
                                     f"{c.error_text}")
            la_sides.append(reps.name_of(c.remote_side))
    finally:
        ch.close()
        busy.join()
    share_b = la_sides.count("B") / len(la_sides)
    log(f"  (a) rr: 4 x {REQUESTS[0]} on {sides} (MethodStatus +{split}), "
        f"phase 5's tokens, {[round(m, 1) for m in ms]} ms, flash_fwd "
        f"{rr_launches} (expected {4 * cfg.depth}); la beside A's "
        f"{BUSY_REQUEST} loop ({busy.calls} calls): {LA_CALLS} x "
        f"{GOODPUT_REQUEST} on {''.join(la_sides)}, share to B "
        f"{share_b:.3f}, median {statistics.median(la_ms):.1f} ms; "
        f"{card_line()}")
    if split != [2, 2] or sorted(sides) != ["A", "A", "B", "B"] \
            or rr_launches != 4 * cfg.depth:
        raise AssertionError("(a): rr did not spread 2 and 2")
    return dict(rr_sides=sides, rr_split=split, rr_ms=ms,
                rr_launches=rr_launches, la_sides="".join(la_sides),
                la_share_b=share_b, la_ms=la_ms, busy_calls=busy.calls)


def prefix_stats(service: LMService) -> dict:
    """The replica's prefix-cache counters (zeros before its first join
    builds the cache)."""
    zero = dict(hits=0, partial_hits=0, misses=0)
    return service.batcher().kv_stats().get("prefix", zero)


def cluster_prefix_run(reps: Replicas, cfg: LMConfig, svc: LMService,
                       seed: int, lb: str) -> dict:
    """6c (b)'s five sessions (four prompts on one head, then the first
    again) through one cluster channel: ``c_murmurhash`` keyed by the
    head, or ``rr``."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab, PREFIX_HEAD, dtype=np.int32)
    prompts = [np.concatenate([head, rng.integers(
        0, cfg.vocab, PREFIX_PROMPT - PREFIX_HEAD, dtype=np.int32)])
        for _ in range(4)]
    code = head_code(head) if lb == "c_murmurhash" else 0
    ch = cluster_channel(reps.url(), lb)
    stats0 = [prefix_stats(svc_) for svc_ in reps.svcs]
    pre0 = [svc_.batcher().prefills_run for svc_ in reps.svcs]
    dec0 = reps.counts("LM.Decode")
    ev0 = prefix_event_counters()
    l0 = FLASH_FWD.launches
    clients = []
    try:
        for group, stagger in ((prompts[:1], 0.0),
                               (prompts[1:], DECODE_STAGGER_S),
                               (prompts[:1], 0.0)):
            got, _, _ = run_decode_sessions(None, "LM", group, stagger, reps,
                                            channel=ch, request_code=code)
            clients += got
    finally:
        ch.close()
    launches = FLASH_FWD.launches - l0
    ev = {k: v - ev0[k] for k, v in prefix_event_counters().items()}
    per = []
    for svc_, st0, p0, d0, d1 in zip(reps.svcs, stats0, pre0, dec0,
                                     reps.counts("LM.Decode")):
        st = prefix_stats(svc_)
        per.append(dict(sessions=d1 - d0,
                        prefills=svc_.batcher().prefills_run - p0,
                        miss=st["misses"] - st0["misses"],
                        partial=st["partial_hits"] - st0["partial_hits"],
                        hit=st["hits"] - st0["hits"]))
    sides = [reps.name_of(c.remote) for c in clients]
    res = dict(lb=lb, sides="".join(sides), per_replica=per,
               events=ev, launches=launches,
               ttft_ms=[c.ttft_s * 1e3 for c in clients])
    res.update(hold_tokens(f"(b) {lb}", svc, cfg, clients))
    # the solo references' prefills are a check, not the path
    res["check_launches"] = FLASH_FWD.launches - l0 - launches
    return res


def phase_cl_affinity(reps: Replicas, cfg: LMConfig, svc: LMService) -> dict:
    """(b) Prefix affinity: through ``c_murmurhash`` every session of a
    head lands on one replica (one prefill); through ``rr`` both
    replicas prefill."""
    hashed = cluster_prefix_run(reps, cfg, svc, 11, "c_murmurhash")
    spread = cluster_prefix_run(reps, cfg, svc, 12, "rr")
    for label, res in (("c_murmurhash", hashed), ("rr", spread)):
        log(f"  (b) {label}: sessions on {res['sides']}, per replica "
            f"{res['per_replica']}, flash_fwd {res['launches']}, TTFT ms "
            f"{[round(t, 1) for t in res['ttft_ms']]}")
    home = [p for p in hashed["per_replica"] if p["sessions"]]
    other = [p for p in hashed["per_replica"] if not p["sessions"]]
    if len(home) != 1 or home[0]["sessions"] != 5 \
            or (home[0]["miss"], home[0]["partial"], home[0]["hit"]) \
            != (1, 3, 1) or home[0]["prefills"] != 1 \
            or other[0]["miss"] + other[0]["partial"] + other[0]["hit"] \
            or hashed["launches"] != cfg.depth:
        raise AssertionError("(b): c_murmurhash did not keep a head's "
                             "sessions on one replica")
    if [p["prefills"] for p in spread["per_replica"]] != [1, 1] \
            or spread["launches"] != 2 * cfg.depth:
        raise AssertionError("(b): rr did not prefill on both replicas")
    return dict(c_murmurhash=hashed, rr=spread,
                launches=hashed["launches"] + spread["launches"],
                check_launches=hashed["check_launches"]
                + spread["check_launches"])


def phase_cl_hedge(reps: Replicas, cfg: LMConfig, ref: tuple) -> dict:
    """(c) A backup across replicas: the primary pinned to A, busy with a
    BUSY_REQUEST; the 50 ms backup goes to B and wins."""
    prompt, want = ref
    a, b = reps.eps
    lone_ch = Channel()
    lone_ch.init(str(b))
    t0 = time.perf_counter()
    c = gen_call(lone_ch, prompt, len(want), 600_000)
    lone_ms = (time.perf_counter() - t0) * 1e3
    lone_ch.close()
    if c.failed:
        raise AssertionError("(c): the lone call failed")
    ch = cluster_channel(reps.url(), "c_murmurhash", connection_type="pooled",
                         backup_request_ms=BACKUP_MS)
    n0 = reps.counts()
    l0 = FLASH_FWD.launches
    busy = BusyLoop(a, cfg, n=1)
    try:
        wait_until(lambda: reps.svcs[0]._device_lock.locked(), 60,
                   "A's busy call")
        cntl = Controller()
        cntl.request_code = code_for(reps.eps, a)
        t0 = time.perf_counter()
        c = gen_call(ch, prompt, len(want), 600_000, cntl=cntl)
        hedge_ms = (time.perf_counter() - t0) * 1e3
        # A answers the busy call, then the hedge's primary (dropped)
        wait_until(lambda: reps.counts()[0] >= n0[0] + 2, 120,
                   "the primary on A")
    finally:
        busy.join()
        ch.close()
    call_launches = FLASH_FWD.launches - l0 - cfg.depth
    ok = not c.failed and unpack_generated(c.response)[0].tolist() == want
    # the same pinned call beside the same busy call, with no backup
    ch = cluster_channel(reps.url(), "c_murmurhash")
    busy = BusyLoop(a, cfg, n=1)
    try:
        wait_until(lambda: reps.svcs[0]._device_lock.locked(), 60,
                   "A's busy call")
        cntl = Controller()
        cntl.request_code = code_for(reps.eps, a)
        t0 = time.perf_counter()
        u = gen_call(ch, prompt, len(want), 600_000, cntl=cntl)
        unhedged_ms = (time.perf_counter() - t0) * 1e3
    finally:
        busy.join()
        ch.close()
    if u.failed or reps.name_of(u.remote_side) != "A":
        raise AssertionError("(c): the unhedged call")
    sides = side_by_side(reps, ref)
    res = dict(ms=hedge_ms, lone_ms=lone_ms, unhedged_ms=unhedged_ms,
               side_by_side=sides, has_backup=c.has_backup_request,
               primary=reps.name_of(c.attempt_remotes.get(0)),
               winner=reps.name_of(c.remote_side), retried=c.retried_count,
               launches=FLASH_FWD.launches - l0 - sides["launches"],
               call_launches=call_launches)
    log(f"  (c) hedge across replicas: primary on {res['primary']} (busy "
        f"with {BUSY_REQUEST}), backup at {BACKUP_MS} ms won on "
        f"{res['winner']}: {hedge_ms:.1f} ms against {unhedged_ms:.1f} ms "
        f"for the same call unhedged beside the same busy call, and a "
        f"lone call's {lone_ms:.1f} ms; has_backup_request "
        f"{c.has_backup_request}, tokens "
        f"equal {ok}, flash_fwd once both attempts ended "
        f"{res['call_launches']} (+{cfg.depth} the busy call); two "
        f"generators called directly: one {sides['lone_ms']:.1f} ms, one "
        f"after the other {sides['serial_ms']:.1f}, side by side on the "
        f"default stream {sides['default_stream_ms']:.1f}, each on a "
        f"stream of its own {sides['own_streams_ms']:.1f}; {card_line()}")
    if not ok or not c.has_backup_request or res["primary"] != "A" \
            or res["winner"] != "B" \
            or res["call_launches"] != 2 * cfg.depth:
        raise AssertionError("(c): the backup did not win on B")
    return res


def side_by_side(reps: Replicas, ref: tuple) -> dict:
    """Where two replicas in one process lose their concurrency: A's and
    B's generators called directly (no RPC, no device lock), one after
    the other, then together from two threads on the default stream,
    then together each on a CUDA stream of its own; host ms of each
    arrangement, tokens checked."""
    prompt, want = ref
    ids = torch.from_numpy(prompt.astype(np.int64)).cuda()

    def run(svc_, stream=None):
        with torch.inference_mode(), torch.cuda.stream(stream):
            out = svc_._gen(ids, len(want))[0].cpu().tolist()
        if out != want:
            raise AssertionError("(c) a side-by-side run's tokens")

    def together(streams) -> float:
        threads = [threading.Thread(target=run, args=(svc_, st))
                   for svc_, st in zip(reps.svcs, streams)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    l0 = FLASH_FWD.launches
    t0 = time.perf_counter()
    run(reps.svcs[0])
    lone = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for svc_ in reps.svcs:
        run(svc_)
    serial = (time.perf_counter() - t0) * 1e3
    shared = together([None, None])
    own = together([torch.cuda.Stream(), torch.cuda.Stream()])
    return dict(lone_ms=lone, serial_ms=serial, default_stream_ms=shared,
                own_streams_ms=own, launches=FLASH_FWD.launches - l0)


def dead_port() -> int:
    """A loopback port nothing listens on."""
    import socket as pysocket
    with pysocket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_cl_fanout(reps: Replicas, cfg: LMConfig, ref: tuple) -> dict:
    """(d) A ParallelChannel over A and B; a SelectiveChannel with a dead
    sub-channel answering from the live one."""
    from brpc_tpu_torch.client import ParallelChannel, SelectiveChannel
    prompt, want = ref
    req = pack_generate_request(prompt, len(want))
    subs = []
    for ep in reps.eps:
        ch = Channel()
        ch.init(str(ep))
        subs.append(ch)
    l0 = FLASH_FWD.launches
    pc = ParallelChannel()
    for ch in subs:
        pc.add_channel(ch)
    cntl = Controller()
    cntl.timeout_ms = 600_000
    t0 = time.perf_counter()
    c = pc.call_method("LM.Generate", req, cntl=cntl)
    fan_ms = (time.perf_counter() - t0) * 1e3
    fan_ok = not c.failed and all(
        unpack_generated(r)[0].tolist() == want for r in c.response)
    fan_launches = FLASH_FWD.launches - l0
    dead = Channel()
    dead.init(f"127.0.0.1:{dead_port()}")
    sc = SelectiveChannel()
    sc.add_channel(dead)
    sc.add_channel(subs[1])
    cntl = Controller()
    cntl.timeout_ms = 600_000
    c2 = sc.call_method("LM.Generate", req, cntl=cntl)
    sel_ok = not c2.failed and \
        unpack_generated(c2.response)[0].tolist() == want
    launches = FLASH_FWD.launches - l0
    for ch in subs + [dead]:
        ch.close()
    log(f"  (d) ParallelChannel over A and B: both phase 5's tokens "
        f"{fan_ok}, {fan_ms:.1f} ms, flash_fwd {fan_launches} (expected "
        f"{2 * cfg.depth}); SelectiveChannel with a dead sub-channel: "
        f"answered {sel_ok} from {reps.name_of(c2.remote_side)}")
    if not fan_ok or fan_launches != 2 * cfg.depth or not sel_ok \
            or launches != 3 * cfg.depth:
        raise AssertionError("(d): the fan-out went wrong")
    return dict(fan_ms=fan_ms, fan_launches=fan_launches,
                selective_from=reps.name_of(c2.remote_side),
                launches=launches)


def phase_cl_breaker(reps: Replicas) -> dict:
    """(e) ``list://A,<dead port>`` with the breaker: every call succeeds,
    the dead port trips, and no attempt dials it while it is isolated."""
    from brpc_tpu_torch import fleet
    from brpc_tpu_torch.client.circuit_breaker import \
        global_circuit_breaker_map
    dead_ep = f"127.0.0.1:{dead_port()}"
    ch = cluster_channel(f"list://{reps.eps[0]},{dead_ep}", "rr",
                         enable_circuit_breaker=True)
    breakers = global_circuit_breaker_map()
    dead = [ep for ep in ch.load_balancer.servers
            if str(ep.endpoint) == dead_ep][0].endpoint
    trips0 = fleet.event_counters()["fleet_breaker_trip"]
    calls = retried = 0
    try:
        while not breakers.isolated(dead):
            c = ch.call_method("LM.Info", b"")
            calls += 1
            retried += c.retried_count
            if c.failed or calls > 64:
                raise AssertionError(f"(e) call {calls}: [{c.error_code}] "
                                     f"{c.error_text}")
        t_trip = time.perf_counter()
        isolated_calls = dialed = 0
        while breakers.isolated(dead):
            c = ch.call_method("LM.Info", b"")
            if c.failed:
                raise AssertionError("(e) a call failed while isolated")
            if breakers.isolated(dead):
                isolated_calls += 1
                dialed += dead in c.attempt_remotes.values()
        isolation_ms = (time.perf_counter() - t_trip) * 1e3
        after = ch.call_method("LM.Info", b"")
    finally:
        ch.close()
    trips = fleet.event_counters()["fleet_breaker_trip"] - trips0
    log(f"  (e) breaker: {calls} calls to trip (retried {retried}), "
        f"fleet_breaker_trip +{trips}; {isolated_calls} calls in "
        f"{isolation_ms:.1f} ms of isolation, {dialed} dialed the dead "
        f"port; after: ok {not after.failed}")
    if trips != 1 or dialed or not isolated_calls or after.failed:
        raise AssertionError("(e): the breaker did not isolate the dead "
                             "port")
    return dict(calls_to_trip=calls, retried=retried, trips=trips,
                isolated_calls=isolated_calls, isolation_ms=isolation_ms,
                dialed=dialed)


def phase_cl_fleet(reps: Replicas, registry, reg_srv: Server,
                   dec_ep) -> dict:
    """(f) Fleet: both replicas report to a registry; a KV.Probe's tail;
    federation."""
    from brpc_tpu_torch import fleet
    from brpc_tpu_torch.kv.transport import decode_probe_report
    t0 = time.perf_counter()
    for srv in reps.srvs:
        fleet.attach_reporter(srv, str(reg_srv.listen_endpoint),
                              interval_s=FLEET_INTERVAL_S)
    want = {str(ep) for ep in reps.eps}

    def ok_members():
        return {m["instance"] for m in registry.members()
                if m["state"] == "ok"}

    wait_until(lambda: want <= ok_members(), 1.0, "both replicas ok")
    ok_s = time.perf_counter() - t0
    rows = {m["instance"]: m for m in registry.members()}
    for srv, svc_ in zip(reps.srvs, reps.svcs):
        rep = rows[str(srv.listen_endpoint)]["report"]
        if rep["v"] != fleet.LOAD_REPORT_VERSION \
                or rep["slots"]["total"] != CLUSTER_SLOTS \
                or not rep["kv"] or "alloc" not in rep["kv"]:
            raise AssertionError(f"(f) a replica's report: {rep}")
    ch = Channel()
    ch.init(str(dec_ep))
    c = ch.call_method("KV.Probe", b"")
    ch.close()
    tail = decode_probe_report(c.response) if not c.failed else None
    if tail is None or tail["instance"] != str(dec_ep) \
            or tail["v"] != fleet.LOAD_REPORT_VERSION:
        raise AssertionError(f"(f) the probe's tail: {tail}")
    fed = registry.federate(fetch=lambda inst, timeout_s=1.0:
                            render_prometheus())
    labelled = [inst for inst in sorted(want)
                if f'instance="{inst}"' in fed]
    if labelled != sorted(want):
        raise AssertionError("(f) federation lacks a replica's label")
    counts = fleet.event_counters()
    log(f"  (f) fleet: both replicas ok in {ok_s * 1e3:.1f} ms (interval "
        f"{FLEET_INTERVAL_S} s); slots "
        f"{[rows[str(ep)]['report']['slots'] for ep in reps.eps]}; the "
        f"probe's tail from {tail['instance']} (slots {tail['slots']}); "
        f"federation {len(fed.splitlines())} lines; events {counts}")
    return dict(ok_ms=ok_s * 1e3, probe_instance=tail["instance"],
                federate_lines=len(fed.splitlines()), events=counts)


def fmt_ms(ms) -> str:
    return "none" if ms is None else f"{ms:.1f}"


def phase_cl_drain(reps: Replicas, registry, cfg: LMConfig,
                   naming: str) -> dict:
    """(g) Drain with failover: two client threads loop Generate over a
    ``file://`` list while A drains."""
    from brpc_tpu_torch import fleet
    a, b = reps.eps
    for srv in reps.srvs:
        if srv.publish(f"file://{naming}") != 0:
            raise AssertionError("(g) publish failed")
    ch = cluster_channel(f"file://{naming}", "rr")
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab, GOODPUT_REQUEST[:2], dtype=np.int32)
    stop = threading.Event()
    calls, lock = [], threading.Lock()

    def loop():
        while not stop.is_set():
            c = gen_call(ch, prompt, GOODPUT_REQUEST[2], 600_000)
            with lock:
                calls.append((time.perf_counter(), c.error_code,
                              c.retried_count, c.remote_side,
                              dict(c.attempt_remotes)))

    ev0 = fleet.event_counters()
    threads = [threading.Thread(target=loop) for _ in range(2)]
    for t in threads:
        t.start()
    draining_at = [None]

    def watch(t_start):
        while draining_at[0] is None and not stop.is_set():
            rows = {m["instance"]: m["state"] for m in registry.members()}
            if rows.get(str(a)) == "draining":
                draining_at[0] = time.perf_counter() - t_start
            time.sleep(0.002)

    try:
        time.sleep(CLUSTER_DRAIN_LEAD_S)
        t_drain = time.perf_counter()
        watcher = threading.Thread(target=watch, args=(t_drain,))
        watcher.start()
        rc = reps.srvs[0].drain(grace_ms=CLUSTER_DRAIN_GRACE_MS)
        drain_ms = (time.perf_counter() - t_drain) * 1e3
        time.sleep(CLUSTER_DRAIN_TAIL_S)
    finally:
        stop.set()
        for t in threads:
            t.join(600)
    watcher.join(10)
    ch.load_balancer._ns.run_once()     # the naming refresh
    listed = [str(n.endpoint) for n in ch.load_balancer.servers]
    after = [gen_call(ch, prompt, GOODPUT_REQUEST[2], 600_000)
             for _ in range(4)]
    ch.close()
    ev = {k: v - ev0[k] for k, v in fleet.event_counters().items() if v
          != ev0[k]}
    failed = [x for x in calls if x[1]]
    on_a = [x[0] for x in calls if x[3] == a]
    lame = [x for x in calls if a in x[4].values() and x[3] == b
            and x[2] >= 1]
    last_a_ms = (max(on_a) - t_drain) * 1e3 if on_a else None
    after_on_a = sum(a in c.attempt_remotes.values() for c in after)
    res = dict(calls=len(calls), failed=len(failed),
               retried=sum(x[2] for x in calls),
               retried_off_a=len(lame), drain_rc=rc, drain_ms=drain_ms,
               last_a_ms=last_a_ms, draining_after_ms=None
               if draining_at[0] is None else draining_at[0] * 1e3,
               listed=listed, after_on_a=after_on_a, events=ev)
    log(f"  (g) drain of A under 2 client threads: {len(calls)} calls, "
        f"{res['retried']} retries ({len(lame)} moved from A to B), "
        f"{len(failed)} failed; drain rc {rc} in {drain_ms:.1f} ms, A's "
        f"last answer {fmt_ms(last_a_ms)} ms after the drain began, the "
        f"registry showed A draining after "
        f"{fmt_ms(res['draining_after_ms'])} ms; listed "
        f"after the refresh {listed}; {after_on_a} of 4 later calls "
        f"picked A; events {ev}; {card_line()}")
    if failed or listed != [str(b)] or after_on_a \
            or any(c.failed for c in after) \
            or res["draining_after_ms"] is None \
            or res["draining_after_ms"] > FLEET_INTERVAL_S * 1e3 \
            or not all(ev.get(k) for k in ("fleet_drain", "fleet_lame_duck",
                                           "fleet_deregister")):
        raise AssertionError(f"(g): the drain failed over badly: "
                             f"{failed[:2]}")
    return res


def phase_cluster(svc: LMService, cfg: LMConfig, rows: list,
                  dec_ep, portal=None) -> dict:
    """Phase 14: the LM across two replicas on the card, through the
    cluster Channel, the combo channels, the breaker and the fleet.
    ``portal(reps, registry)`` (phase 15 (f)) runs after the fleet step,
    while both replicas report, timed apart from phase 14."""
    from brpc_tpu_torch import fleet
    t0 = time.perf_counter()
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab, REQUESTS[0][:2], dtype=np.int32)
    ref = (prompt, rows[0]["tokens"])
    reps = Replicas(cfg, svc.params)
    reg_srv = Server()
    registry = fleet.host_registry(reg_srv, ttl_s=5.0)
    if reg_srv.start("127.0.0.1:0") != 0:
        raise RuntimeError("the registry did not start")
    naming = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    steps = (("spread", lambda: phase_cl_spread(reps, cfg, ref)),
             ("affinity", lambda: phase_cl_affinity(reps, cfg, svc)),
             ("hedge", lambda: phase_cl_hedge(reps, cfg, ref)),
             ("fanout", lambda: phase_cl_fanout(reps, cfg, ref)),
             ("breaker", lambda: phase_cl_breaker(reps)),
             ("fleet", lambda: phase_cl_fleet(reps, registry, reg_srv,
                                              dec_ep)),
             ("drain", lambda: phase_cl_drain(
                 reps, registry, cfg, os.path.join(naming, "lm.naming"))))
    res, sub_s, sub_launches = {}, {}, {}
    portal_s = 0.0
    FLASH_FWD.launches = 0
    try:
        for name, step in steps:
            t1, l1 = time.perf_counter(), FLASH_FWD.launches
            res[name] = step()
            sub_s[name] = time.perf_counter() - t1
            sub_launches[name] = FLASH_FWD.launches - l1
            if name == "fleet" and portal is not None:
                t1 = time.perf_counter()
                res["portal"] = portal(reps, registry)
                portal_s = time.perf_counter() - t1
    finally:
        reps.close()
        reg_srv.stop()
        import shutil
        shutil.rmtree(naming, ignore_errors=True)
    # through the entry points; the token checks' solo prefills and the
    # side-by-side generator calls apart
    res["check_launches"] = res["affinity"]["check_launches"] \
        + res["hedge"]["side_by_side"]["launches"]
    res["launches"] = FLASH_FWD.launches - res["check_launches"]
    res["seconds"] = time.perf_counter() - t0 - portal_s
    res["sub_seconds"] = sub_s
    res["sub_launches"] = sub_launches
    log(f"  phase 14: {res['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in sub_s.items())
        + f"); flash_fwd launches {res['launches']} through the entry "
        f"points, {res['check_launches']} in checks (per sub-phase, all: "
        f"{sub_launches}); no number here is "
        f"across cards or processes (both replicas share this process and "
        f"card)")
    return res


# -- phase 15: HTTP/1.1, h2/gRPC and the portal on the one port -------------

PROTO_TIMEOUT_MS = 600_000
HOTSPOT_REQUEST = BUSY_REQUEST          # (1, 1500, 64), profiled for 1 s
HOTSPOT_FRAMES = ("Generate", "decode_step")
LM_FAMILIES = ("lm_step_phase_total", "lm_step_phase_ns", "lm_ttft_ms",
               "lm_itl_ms", "lm_slo_attained_total", "rpc_server_lm_generate")


def phase5_prompts(cfg: LMConfig) -> list:
    """Phase 5's prompts, drawn as ``phase_serve`` draws them."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
            for b, s, _ in REQUESTS]


def http_call(ep, method: str, path: str, body: bytes = None,
              headers: dict = None, timeout_s: float = 600.0) -> tuple:
    """One HTTP/1.1 exchange on a connection of its own: ``(status,
    headers, body, ms)``."""
    import http.client
    conn = http.client.HTTPConnection(ep.host, ep.port, timeout=timeout_s)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        data = r.read()
        ms = (time.perf_counter() - t0) * 1e3
        return r.status, {k.lower(): v for k, v in r.getheaders()}, data, ms
    finally:
        conn.close()


def grpc_raw_call(ep, path: str, payload: bytes,
                  grpc_timeout: str) -> tuple:
    """One unary gRPC call over a fresh h2c connection with the port's
    own h2 session, whose only ``grpc-timeout`` is ``grpc_timeout``:
    ``(grpc-status, grpc-message, ms)``."""
    import socket
    from brpc_tpu_torch.protocol.h2_rpc import GRPC_CT, pack_grpc_message
    from brpc_tpu_torch.protocol.h2_session import H2Session
    sess = H2Session(is_server=False)
    sess.start()
    sid = sess.next_stream_id()
    sess.send_headers(sid, [(":method", "POST"), (":scheme", "http"),
                            (":path", path), (":authority", str(ep)),
                            ("content-type", GRPC_CT), ("te", "trailers"),
                            ("grpc-timeout", grpc_timeout)])
    sess.send_data(sid, pack_grpc_message(payload), end_stream=True)
    headers = []
    with socket.create_connection((ep.host, ep.port), timeout=60) as conn:
        t0 = time.perf_counter()
        conn.sendall(sess.take_output())
        done = False
        while not done:
            data = conn.recv(65536)
            if not data:
                raise AssertionError("h2 connection closed early")
            for ev in sess.feed(data):
                if ev[0] in ("headers", "data") and ev[1] == sid:
                    if ev[0] == "headers":
                        headers += ev[2]
                    done = done or ev[3]
            out = sess.take_output()
            if out:
                conn.sendall(out)
        ms = (time.perf_counter() - t0) * 1e3
    h = dict(headers)
    return int(h.get("grpc-status", "2")), h.get("grpc-message", ""), ms


def proto_generate(ch: Channel, prompt: np.ndarray, max_new: int) -> tuple:
    """One Generate through ``ch`` (any protocol): ``(ids, ms)``."""
    cntl = Controller()
    cntl.timeout_ms = PROTO_TIMEOUT_MS
    t0 = time.perf_counter()
    c = ch.call_method("LM.Generate", pack_generate_request(prompt, max_new),
                       cntl=cntl)
    ms = (time.perf_counter() - t0) * 1e3
    if c.failed:
        raise AssertionError(f"Generate over {ch.options.protocol} failed: "
                             f"[{c.error_code}] {c.error_text}")
    return unpack_generated(c.response), ms


def check_lane(label: str, outs: list, rows: list, launches: int,
               cfg: LMConfig) -> None:
    for (ids, ms), row in zip(outs, rows):
        log(f"  {label} b={row['b']} s={row['s']} max_new="
            f"{row['max_new']}: {ms:.1f} ms (tpu_std in phase 5: "
            f"{row['ms']:.1f} ms); tokens equal to phase 5's: "
            f"{ids.tolist() == row['ids']}")
    want = cfg.depth * len(REQUESTS)
    if any(ids.tolist() != row["ids"] for (ids, _), row in zip(outs, rows)) \
            or launches != want:
        raise AssertionError(f"{label}: tokens or flash_fwd launches "
                             f"({launches}, expected {want}) off")


def phase_proto_generate(ep, cfg: LMConfig, rows: list) -> dict:
    """(a) ``POST /LM/Generate`` (the tpu_std request bytes as
    ``application/octet-stream``) on phase 5's port; (b) the same
    requests through ``Channel(protocol="http")`` and
    ``Channel(protocol="grpc")``.  Each lane: phase 5's tokens,
    ``flash_fwd`` depth x 3."""
    prompts = phase5_prompts(cfg)
    res = {}
    FLASH_FWD.launches = 0
    outs = []
    for prompt, (_, _, max_new) in zip(prompts, REQUESTS):
        status, hdrs, body, ms = http_call(
            ep, "POST", "/LM/Generate", pack_generate_request(prompt, max_new),
            {"Content-Type": "application/octet-stream"})
        if status != 200 or hdrs.get("content-type") != \
                "application/octet-stream":
            raise AssertionError(f"(a) POST /LM/Generate: {status} "
                                 f"{body[:200]!r}")
        outs.append((unpack_generated(body), ms))
    launches = FLASH_FWD.launches
    check_lane("(a) POST /LM/Generate", outs, rows, launches, cfg)
    res["raw_http"] = dict(ms=[ms for _, ms in outs], launches=launches)
    for proto in ("http", "grpc"):
        ch = Channel(protocol=proto)
        ch.init(str(ep))
        FLASH_FWD.launches = 0
        try:
            outs = [proto_generate(ch, prompt, max_new)
                    for prompt, (_, _, max_new) in zip(prompts, REQUESTS)]
        finally:
            ch.close()
        launches = FLASH_FWD.launches
        check_lane(f"(b) Channel(protocol={proto!r})", outs, rows, launches,
                   cfg)
        res[proto] = dict(ms=[ms for _, ms in outs], launches=launches)
    res["launches"] = sum(r["launches"] for r in res.values())
    return res


def phase_proto_shed(ep, cfg: LMConfig) -> dict:
    """(c) A call whose budget ran out before it is served, on a
    connection of its own over each lane: shed without a launch, HTTP
    500 with ``x-rpc-error-code`` ERPCTIMEDOUT, gRPC status 4."""
    prompt = phase5_prompts(cfg)[0]
    req = pack_generate_request(prompt, REQUESTS[0][2])
    before = deadline.shed_counters()
    FLASH_FWD.launches = 0
    status, hdrs, body, http_ms = http_call(
        ep, "POST", "/LM/Generate", req,
        {"Content-Type": "application/octet-stream", "x-deadline-ms": "0"})
    gstatus, gmsg, grpc_ms = grpc_raw_call(ep, "/LM/Generate", req, "500u")
    launches = FLASH_FWD.launches
    after = deadline.shed_counters()
    sheds = {lane: after.get((lane, "LM.Generate"), 0)
             - before.get((lane, "LM.Generate"), 0)
             for lane in ("http", "grpc")}
    log(f"  (c) expired budgets: HTTP {status} x-rpc-error-code "
        f"{hdrs.get('x-rpc-error-code')} in {http_ms:.2f} ms; gRPC status "
        f"{gstatus} ({gmsg!r}) in {grpc_ms:.2f} ms; sheds {sheds}; "
        f"flash_fwd launches {launches}")
    if status != 500 or hdrs.get("x-rpc-error-code") != \
            str(int(Errno.ERPCTIMEDOUT)) or gstatus != 4 or launches \
            or sheds != {"http": 1, "grpc": 1}:
        raise AssertionError("(c) an expired budget was not shed as the "
                             "JAX lanes shed it")
    return dict(http_ms=http_ms, grpc_ms=grpc_ms, launches=launches)


def portal_get(ep, path: str, want: int = 200) -> bytes:
    status, _, body, _ = http_call(ep, "GET", path, timeout_s=120.0)
    if status != want:
        raise AssertionError(f"GET {path}: {status} (expected {want}) "
                             f"{body[:200]!r}")
    return body


class Ping(Service):
    def Ping(self, cntl, request):
        return request


def phase_portal(ep, cfg: LMConfig) -> dict:
    """(d) The portal on phase 5's server while the LM serves."""
    t0 = time.perf_counter()
    status = json.loads(portal_get(ep, "/status"))
    if status["services"]["LM.Generate"]["count"] < len(REQUESTS):
        raise AssertionError(f"/status: {status['services']}")
    for page in ("/vars", "/metrics"):
        body = portal_get(ep, page).decode()
        missing = [f for f in LM_FAMILIES if f not in body]
        if missing:
            raise AssertionError(f"{page} lacks {missing}")
    lm = json.loads(portal_get(ep, "/lm"))
    if not lm["enabled"] or "ttft_ms" not in lm or "phases" not in lm:
        raise AssertionError(f"/lm: {sorted(lm)}")
    # a traced HTTP Generate: its server span under the caller's span
    tid = next(_trace_ids)
    ch = Channel(protocol="http")
    ch.init(str(ep))
    cntl = Controller()
    cntl.trace_id = tid
    cntl.timeout_ms = PROTO_TIMEOUT_MS
    FLASH_FWD.launches = 0
    prompt = phase5_prompts(cfg)[0]
    c = ch.call_method("LM.Generate",
                       pack_generate_request(prompt, REQUESTS[0][2]),
                       cntl=cntl)
    ch.close()
    launches = FLASH_FWD.launches
    if c.failed:
        raise AssertionError(f"traced HTTP Generate: {c.error_text}")
    trace_spans(tid, {("LM.Generate", True), ("LM.Generate", False)})
    page = json.loads(portal_get(ep, f"/rpcz?trace_id={tid:x}&format=json"))
    spans = page["spans"]
    server = [sp for sp in spans if sp["side"] == "server"]
    client = [sp for sp in spans if sp["side"] == "client"]
    if len(server) != 1 or len(client) != 1 \
            or server[0]["parent_span_id"] != client[0]["span_id"] \
            or len(page["tree"]) != 1:
        raise AssertionError(f"/rpcz for the traced HTTP Generate: {page}")
    legs = dict(handler_ms=(server[0]["end_us"] - server[0]["start_us"])
                / 1e3, queue_us=server[0]["start_us"]
                - server[0]["received_us"])
    # the CPU profile during a (1, 1500, 64) Generate names its frames
    b, s, max_new = HOTSPOT_REQUEST
    busy = np.random.default_rng(15).integers(0, cfg.vocab, (b, s),
                                              dtype=np.int32)
    ch = Channel()
    ch.init(str(ep))
    box = {}

    def run():
        box["out"] = proto_generate(ch, busy, max_new)

    th = threading.Thread(target=run)
    th.start()
    folded = portal_get(ep, "/hotspots/cpu?seconds=1&view=folded").decode()
    th.join(600)
    ch.close()
    launches = FLASH_FWD.launches
    named = [f for f in HOTSPOT_FRAMES if f in folded]
    samples = sum(int(line.rsplit(" ", 1)[1])
                  for line in folded.splitlines() if line.strip())
    # /flags set live, then put back
    old = get_flag("rpcz_max_samples_per_second")
    portal_get(ep, f"/flags/rpcz_max_samples_per_second?setvalue={old + 1}")
    live = get_flag("rpcz_max_samples_per_second") == old + 1
    set_flag("rpcz_max_samples_per_second", old)
    # internal_port gating, on a server of its own
    opts = ServerOptions()
    opts.internal_port = 0
    gated = serve_lm({"Ping": Ping()}, opts)
    try:
        portal_get(gated.listen_endpoint, "/flags", 403)
        portal_get(gated.listen_endpoint, "/health")
        portal_get(gated.internal_endpoint, "/flags")
    finally:
        gated.stop()
    log(f"  (d) portal: /status ({len(status['services'])} methods, "
        f"{status['connections']} connections), /vars and /metrics with "
        f"{list(LM_FAMILIES)}, /lm keys {len(lm)}; a traced HTTP Generate's "
        f"server span under its client span (handler "
        f"{legs['handler_ms']:.1f} ms, queue {legs['queue_us']} us); "
        f"/hotspots/cpu over a {HOTSPOT_REQUEST} Generate: {samples} "
        f"samples, frames named {named}; /flags set live {live}; "
        f"internal_port gating held; flash_fwd launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    if named != list(HOTSPOT_FRAMES) or not live or "out" not in box \
            or launches != 2 * cfg.depth:
        raise AssertionError("(d) the portal did not read the live server")
    return dict(hotspot_samples=samples, launches=launches, **legs)


def phase_portal_stitch(disagg: dict) -> dict:
    """(e) Phase 12 (c)'s traced disaggregated Decode stitched with no
    ``fetch=``: the walk GETs each tier's ``/rpcz`` over its port."""
    tid = disagg["trace_id"]
    t0 = time.perf_counter()
    out = rpcz_stitch.collect_trace(tid)
    ms = (time.perf_counter() - t0) * 1e3
    roots = rpcz_stitch.build_tree(out["spans"])
    log(f"  (e) rpcz_stitch.collect_trace({tid:x}) over the portals: "
        f"{len(out['spans'])} spans, remotes {out['remotes']}, "
        f"{len(roots)} root, {ms:.1f} ms")
    for line in rpcz_stitch.render_tree_text(out["spans"]).rstrip() \
            .splitlines():
        log(f"    {line}")
    if len(out["spans"]) != disagg["spans"] or len(roots) != 1 \
            or len(out["remotes"]) < 2 or out["truncated"] \
            or set(out["remotes"].values()) != {"ok"}:
        raise AssertionError("(e) the stitch over the portals failed")
    return dict(spans=len(out["spans"]), remotes=len(out["remotes"]),
                ms=ms, seconds=ms / 1e3)


def phase_portal_fleet(reps, registry) -> dict:
    """(f) Federation with no ``fetch=`` over phase 14's two replicas,
    and ``fetch_member_report`` of each."""
    from brpc_tpu_torch import fleet
    t0 = time.perf_counter()
    builds = registry.fed_builds
    wait_until(lambda: time.perf_counter() - t0 > 2.1, 3.0,
               "the federation cache to age out")
    fed = registry.federate()
    want = sorted(str(ep) for ep in reps.eps)
    labelled = [inst for inst in want if f'instance="{inst}"' in fed]
    reports = {inst: fleet.fetch_member_report(inst) for inst in want}
    log(f"  (f) federate() over the replicas' /metrics: "
        f"{len(fed.splitlines())} lines, labels {labelled}; "
        f"fetch_member_report: "
        f"{ {i: (r['instance'], r['slots']) for i, r in reports.items()} }")
    if labelled != want or registry.fed_builds != builds + 1 \
            or any(r["instance"] != i or r["slots"]["total"] != CLUSTER_SLOTS
                   for i, r in reports.items()):
        raise AssertionError("(f) federation or a member report failed")
    return dict(federate_lines=len(fed.splitlines()),
                seconds=time.perf_counter() - t0)


def phase_protocols(ep, cfg: LMConfig, rows: list, stitch_part: dict,
                    fleet_part: dict) -> dict:
    """Phase 15, on phase 5's server after phase 14 ((e) ran inside
    phase 12, right after 12 (c); (f) inside phase 14, while its
    replicas reported)."""
    t0 = time.perf_counter()
    res = {"generate": phase_proto_generate(ep, cfg, rows),
           "shed": phase_proto_shed(ep, cfg),
           "portal": phase_portal(ep, cfg),
           "stitch": stitch_part,
           "fleet": fleet_part}
    res["launches"] = res["generate"]["launches"] \
        + res["portal"]["launches"]
    res["seconds"] = time.perf_counter() - t0 + stitch_part["seconds"] \
        + fleet_part["seconds"]
    log(f"  phase 15: {res['seconds']:.1f} s ((e) {stitch_part['seconds']:.2f}"
        f" s and (f) {fleet_part['seconds']:.1f} s of it, run inside "
        f"phases 12 and 14); flash_fwd launches {res['launches']}")
    return res


# -- phase 16: the classic lane's stages, TLS, async calls, block pool ----

GZIP = CompressType.GZIP
P16_AUTH = b"phase16-secret"
P16_BLOCKED_TENANT = "blocked"
P16_SESSION_CALLS = 8
P16_ROUNDS = 3
P16_ECHO_BYTES = 1 << 20
P16_ECHO_CALLS = 50                       # per lane and round
P16_ASYNC_REQUEST = (1, 512, 16)
P16_ASYNC_N = 4
P16_CANCEL_REQUEST = (1, 1500, 64)
P16_POOL_SIZES = (1 << 20, 64 << 20)
P16_POOL_REPS = 20
P16_POOL_WARMUP = 3
P17_ROUNDS = 3
P17_DECODE_ORDER = ("native", "python", "python", "native")
P17_ECHO_CALLS = 100                      # per lane and turn
P17_ECHO_ORDER = ("python", "native", "native", "python")
P17_LOOPS = 8                             # (c): one engine loop a connection
P17_DRAIN_STREAMS = 4
P17_DRAIN_PROMPT = 256


class Auth16:
    def verify(self, auth_data, cntl) -> bool:
        return auth_data == P16_AUTH


def intercept16(cntl):
    """Refuse the blocked tenant with a verdict of the interceptor's
    own."""
    if cntl.request_meta.tenant == P16_BLOCKED_TENANT.encode():
        return (False, int(Errno.ELIMIT), "tenant blocked by phase 16")
    return True


class Stages16(Service):
    def Echo(self, cntl, request):
        return request

    @method(response_compress=GZIP)
    def GzEcho(self, cntl, request):
        return request

    def Use(self, cntl, request):
        d = cntl.session_local_data()
        d["hits"] = d.get("hits", 0) + 1
        return b"%d:%d" % (d["hits"], id(d))


class AsyncLM(Service):
    """Phase 5's Generate behind a handler that calls ``begin_async``
    and finishes on a thread of its own."""

    def __init__(self, svc: LMService):
        self._svc = svc

    def Generate(self, cntl, request):
        cntl.begin_async()

        def run():
            try:
                out = self._svc.Generate(cntl, request)
            except Exception as e:      # the client sees EINTERNAL
                cntl.set_failed(Errno.EINTERNAL, f"{type(e).__name__}: {e}")
                out = None
            cntl.finish(out)
        threading.Thread(target=run, name="async-generate",
                         daemon=True).start()
        return None


def p16_channel(ep, **opts) -> Channel:
    co = ChannelOptions()
    co.timeout_ms = PROTO_TIMEOUT_MS
    for key, value in opts.items():
        setattr(co, key, value)
    ch = Channel(co)
    if ch.init(str(ep)) != 0:
        raise RuntimeError(f"channel to {ep} did not init")
    return ch


def p16_generate(ch: Channel, prompt: np.ndarray, max_new: int,
                 **cntl_opts) -> tuple:
    """One Generate: ``(ids or None, controller, ms)``."""
    cntl = Controller()
    cntl.timeout_ms = PROTO_TIMEOUT_MS
    for key, value in cntl_opts.items():
        setattr(cntl, key, value)
    t0 = time.perf_counter()
    c = ch.call_method("LM.Generate", pack_generate_request(prompt, max_new),
                       cntl=cntl)
    ms = (time.perf_counter() - t0) * 1e3
    return (None if c.failed else unpack_generated(c.response)), c, ms


def phase_p16_stages(svc: LMService, cfg: LMConfig, rows: list) -> dict:
    """(a) C13's stages on a server with ``auth``, an interceptor and
    session-local data."""
    prompt = phase5_prompts(cfg)[0]
    max_new = REQUESTS[0][2]
    opts = ServerOptions()
    opts.auth = Auth16()
    opts.interceptor = intercept16
    opts.session_local_data_factory = dict
    srv = serve_lm({"LM": svc, "S": Stages16()}, opts)
    good = p16_channel(srv.listen_endpoint, auth_data=P16_AUTH)
    # beside the live ``good``: other credentials never share its
    # "single" connection (the socket map keys a connection by them)
    bad = p16_channel(srv.listen_endpoint, auth_data=b"wrong", max_retry=0)
    blocked = p16_channel(srv.listen_endpoint, auth_data=P16_AUTH,
                          tenant=P16_BLOCKED_TENANT, max_retry=0)
    res = {}
    try:
        FLASH_FWD.launches = 0
        ids, c, ms = p16_generate(good, prompt, max_new,
                                  request_compress_type=GZIP)
        launches = FLASH_FWD.launches
        log(f"  (a) GZIP Generate {REQUESTS[0]}: {ms:.1f} ms "
            f"(phase 5: {rows[0]['ms']:.1f} ms); tokens equal to phase 5's: "
            f"{ids is not None and ids.tolist() == rows[0]['ids']}; "
            f"flash_fwd launches {launches}")
        if ids is None or ids.tolist() != rows[0]["ids"] \
                or launches != cfg.depth:
            raise AssertionError(f"(a) the GZIP Generate: {c.error_text} "
                                 f"or tokens or launches ({launches}) off")
        res["gzip"] = dict(ms=ms, launches=launches)
        payload = bytes(range(256)) * 4096            # 1 MiB, compressible
        import socket
        ep = srv.listen_endpoint
        conn = socket.create_connection((ep.host, ep.port), timeout=60)
        try:
            meta = RpcMeta()
            meta.correlation_id, meta.auth_data = 1, P16_AUTH
            meta.service_name, meta.method_name = "S", "GzEcho"
            t0 = time.perf_counter()
            conn.sendall(pack_frame(meta, payload))
            rmeta, body, _ = read_frame(conn)
            raw_ms = (time.perf_counter() - t0) * 1e3
        finally:
            conn.close()
        cntl = Controller()
        cntl.timeout_ms = PROTO_TIMEOUT_MS
        t0 = time.perf_counter()
        c = good.call_method("S.GzEcho", payload, cntl=cntl)
        gz_ms = (time.perf_counter() - t0) * 1e3
        log(f"  (a) @method(response_compress=GZIP): compress_type "
            f"{rmeta.compress_type}, {len(payload)} -> {len(body)} bytes on "
            f"the wire in {raw_ms:.2f} ms; read back through the channel "
            f"{'equal' if c.response == payload else 'DIFFERENT'} in "
            f"{gz_ms:.2f} ms")
        if rmeta.compress_type != GZIP or len(body) >= len(payload) \
                or c.failed or c.response != payload:
            raise AssertionError("(a) the compressed response was not "
                                 "answered or read back")
        res["response_compress"] = dict(ms=gz_ms, wire_bytes=len(body))
        FLASH_FWD.launches = 0
        _, c_auth, auth_ms = p16_generate(bad, prompt, max_new)
        _, c_int, int_ms = p16_generate(blocked, prompt, max_new)
        launches = FLASH_FWD.launches
        log(f"  (a) bad auth_data: [{c_auth.error_code}] "
            f"{c_auth.error_text!r} in {auth_ms:.2f} ms; the interceptor: "
            f"[{c_int.error_code}] {c_int.error_text!r} in {int_ms:.2f} ms; "
            f"flash_fwd launches {launches}")
        if (c_auth.error_code, c_auth.error_text) != (
                int(Errno.ERPCAUTH), "authentication failed") \
                or (c_int.error_code, c_int.error_text) != (
                    int(Errno.ELIMIT), "tenant blocked by phase 16") \
                or launches:
            raise AssertionError("(a) a refusal was not answered as the "
                                 "JAX lane answers it, or it launched")
        res["refusals"] = dict(auth_ms=auth_ms, interceptor_ms=int_ms,
                               launches=launches)
        outs = [good.call("S.Use", b"", timeout_ms=60_000)
                for _ in range(P16_SESSION_CALLS)]
        hits = [int(o.split(b":")[0]) for o in outs]
        objs = {o.split(b":")[1] for o in outs}
        created = srv._session_pool.created
        log(f"  (a) {P16_SESSION_CALLS} calls on one connection: session "
            f"hits {hits}, {len(objs)} object(s), {created} created")
        if hits[-1] - hits[0] != P16_SESSION_CALLS - 1 or len(objs) != 1 \
                or created != 1:
            raise AssertionError("(a) session-local data was not reused")
        res["session"] = dict(objects=len(objs), created=created)
    finally:
        for ch in (good, bad, blocked):
            ch.close()
        srv.stop()
    return res


def make_cert_pair(directory: str) -> tuple:
    """A self-signed localhost certificate and key, made by the openssl
    CLI (a test certificate, as ``tests/test_ssl.py`` makes it)."""
    cert = os.path.join(directory, "cert.pem")
    key = os.path.join(directory, "key.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-nodes", "-keyout", key, "-out", cert, "-days", "1",
                    "-subj", "/CN=localhost", "-addext",
                    "subjectAltName=IP:127.0.0.1,DNS:localhost"],
                   check=True, capture_output=True, timeout=60)
    return cert, key


def echo_rate(ch: Channel, payload: bytes, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        if ch.call("S.Echo", payload, timeout_ms=60_000) != payload:
            raise AssertionError("(b) a byte echo came back different")
    return n / (time.perf_counter() - t0)


def phase_p16_tls(svc: LMService, cfg: LMConfig, rows: list,
                  plain_ch: Channel) -> dict:
    """(b) A TLS server on phase 5's service against the plaintext
    lane."""
    prompts = phase5_prompts(cfg)
    tmp = tempfile.mkdtemp(prefix="p16-certs-")
    cert, key = make_cert_pair(tmp)
    opts = ServerOptions()
    opts.ssl_cert, opts.ssl_key = cert, key
    srv = serve_lm({"LM": svc, "S": Stages16()}, opts)
    plain_srv = serve_lm({"S": Stages16()})
    tls = p16_channel(srv.listen_endpoint, ssl=True, ssl_ca=cert,
                      ssl_verify=True)
    res = {"tls_ms": [], "plain_ms": []}
    try:
        launches = 0
        for r in range(P16_ROUNDS):
            tls_ms, plain_ms = [], []
            lanes = (("tls", tls, tls_ms), ("plain", plain_ch, plain_ms))
            for lane, ch, out in (lanes if r % 2 == 0 else lanes[::-1]):
                FLASH_FWD.launches = 0
                for prompt, (_, _, max_new), row in zip(prompts, REQUESTS,
                                                         rows):
                    ids, c, ms = p16_generate(ch, prompt, max_new)
                    if ids is None or ids.tolist() != row["ids"]:
                        raise AssertionError(f"(b) {lane} round {r}: "
                                             f"{c.error_text} or tokens off")
                    out.append(ms)
                if FLASH_FWD.launches != cfg.depth * len(REQUESTS):
                    raise AssertionError(f"(b) {lane}: flash_fwd launches "
                                         f"{FLASH_FWD.launches}")
                if lane == "tls":
                    launches += FLASH_FWD.launches
            res["tls_ms"].append(tls_ms)
            res["plain_ms"].append(plain_ms)
            log(f"  (b) round {r}: TLS {[round(m, 1) for m in tls_ms]} ms, "
                f"plaintext {[round(m, 1) for m in plain_ms]} ms "
                f"(phase 5's shapes; tokens equal to phase 5's)")
        res["launches"] = launches
        payload = np.random.default_rng(16).integers(
            0, 256, P16_ECHO_BYTES, dtype=np.uint8).tobytes()
        tls_echo = p16_channel(srv.listen_endpoint, ssl=True)
        plain_echo = p16_channel(plain_srv.listen_endpoint)
        rates = {"tls": [], "plain": []}
        try:
            for r in range(P16_ROUNDS):
                order = ("tls", "plain") if r % 2 == 0 else ("plain", "tls")
                for lane in order:
                    ch = tls_echo if lane == "tls" else plain_echo
                    rates[lane].append(echo_rate(ch, payload,
                                                 P16_ECHO_CALLS))
        finally:
            tls_echo.close()
            plain_echo.close()
        res["echo_calls_s"] = rates
        log(f"  (b) 1 MiB byte echoes: TLS {[round(x, 1) for x in rates['tls']]}"
            f" calls/s, plaintext {[round(x, 1) for x in rates['plain']]} "
            f"calls/s ({P16_ECHO_CALLS} a round)")
        bare = p16_channel(srv.listen_endpoint, max_retry=0,
                           timeout_ms=5000)
        try:
            cntl = Controller()
            t0 = time.perf_counter()
            c = bare.call_method("S.Echo", b"plaintext", cntl=cntl)
            fail_ms = (time.perf_counter() - t0) * 1e3
        finally:
            bare.close()
        log(f"  (b) a plaintext client on the TLS port: "
            f"[{c.error_code}] {c.error_text!r} in {fail_ms:.1f} ms")
        if not c.failed or fail_ms > 4000:
            raise AssertionError("(b) a plaintext client was not refused "
                                 "at once by the TLS port")
        res["plaintext_refused_ms"] = fail_ms
    finally:
        tls.close()
        srv.stop()
        plain_srv.stop()
    return res


def phase_p16_async(svc: LMService, srv: Server, cfg: LMConfig,
                    rows: list) -> dict:
    """(c) Four Generates in flight from one thread, a cancel, and an
    async handler over the three lanes."""
    b, s, max_new = P16_ASYNC_REQUEST
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
               for _ in range(P16_ASYNC_N)]
    ep = srv.listen_endpoint
    ch = p16_channel(ep)
    res = {}
    try:
        FLASH_FWD.launches = 0
        t0 = time.perf_counter()
        blocking = [p16_generate(ch, p, max_new)[0] for p in prompts]
        blocking_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        cntls = [ch.call_method("LM.Generate",
                                pack_generate_request(p, max_new),
                                done=lambda c: None,
                                cntl=p16_cntl()) for p in prompts]
        joined = all(c.join(600.0) for c in cntls)
        async_ms = (time.perf_counter() - t0) * 1e3
        launches = FLASH_FWD.launches
        same = joined and all(
            not c.failed and unpack_generated(c.response).tolist()
            == want.tolist() for c, want in zip(cntls, blocking))
        log(f"  (c) {P16_ASYNC_N} x {P16_ASYNC_REQUEST} Generates: in flight "
            f"through call_method(done=) {async_ms:.1f} ms, in turn "
            f"{blocking_ms:.1f} ms; tokens equal: {same}; flash_fwd "
            f"launches {launches}")
        if not same or launches != 2 * P16_ASYNC_N * cfg.depth:
            raise AssertionError("(c) the async Generates disagree with "
                                 "the blocking ones")
        res.update(async_ms=async_ms, blocking_ms=blocking_ms,
                   launches=launches)
        cb, cs, cn = P16_CANCEL_REQUEST
        prompt = rng.integers(0, cfg.vocab, (cb, cs), dtype=np.int32)
        ended = threading.Event()
        cntl = p16_cntl()
        FLASH_FWD.launches = 0
        ch.call_method("LM.Generate", pack_generate_request(prompt, cn),
                       done=lambda c: ended.set(), cntl=cntl)
        # cancelled once the server is serving it, before its response
        wait_until(lambda: srv.inflight >= 1, 60.0, "the call to reach "
                   "the server")
        t0 = time.perf_counter()
        start_cancel(cntl.call_id)
        if not ended.wait(60.0):
            raise AssertionError("(c) the cancelled call never ended")
        cancel_ms = (time.perf_counter() - t0) * 1e3
        # the handler runs on (a cancel does not stop it); its response
        # is dropped when it comes
        wait_until(lambda: srv.inflight == 0, 120.0, "the cancelled "
                   "Generate's handler")
        log(f"  (c) start_cancel during a {P16_CANCEL_REQUEST} Generate: "
            f"[{cntl.error_code}] {cntl.error_text!r} {cancel_ms:.2f} ms "
            f"after the cancel; the handler ran on "
            f"({FLASH_FWD.launches} flash_fwd launches)")
        if cntl.error_code != int(Errno.ECANCELLED) \
                or cntl.response is not None \
                or FLASH_FWD.launches != cfg.depth:
            raise AssertionError("(c) the cancel did not end the call")
        res["cancel_ms"] = cancel_ms
        res["launches"] += FLASH_FWD.launches
        FLASH_FWD.launches = 0
        ids, c, _ = p16_generate(ch, phase5_prompts(cfg)[0],
                                 REQUESTS[0][2])
        if ids is None or ids.tolist() != rows[0]["ids"]:
            raise AssertionError("(c) the channel after the cancel "
                                 "answered wrong")
        res["launches"] += FLASH_FWD.launches
    finally:
        ch.close()
    async_srv = serve_lm({"LM": AsyncLM(svc)})
    try:
        prompt, max_new = phase5_prompts(cfg)[0], REQUESTS[0][2]
        res["begin_async_ms"] = {}
        for proto in ("tpu_std", "http", "grpc"):
            pch = p16_channel(async_srv.listen_endpoint, protocol=proto)
            try:
                FLASH_FWD.launches = 0
                ids, c, ms = p16_generate(pch, prompt, max_new)
            finally:
                pch.close()
            res["launches"] += FLASH_FWD.launches
            log(f"  (c) begin_async handler over {proto}: {ms:.1f} ms; "
                f"tokens equal to phase 5's: "
                f"{ids is not None and ids.tolist() == rows[0]['ids']}; "
                f"flash_fwd launches {FLASH_FWD.launches}")
            if ids is None or ids.tolist() != rows[0]["ids"] \
                    or FLASH_FWD.launches != cfg.depth:
                raise AssertionError(f"(c) the async handler over {proto}: "
                                     f"{c.error_text}")
            res["begin_async_ms"][proto] = ms
    finally:
        async_srv.stop()
    return res


def p16_cntl() -> Controller:
    cntl = Controller()
    cntl.timeout_ms = PROTO_TIMEOUT_MS
    return cntl


def host_sum(data: bytes) -> int:
    """The wrapping 32-bit sum of a payload's int32 words, on the host."""
    return int(np.frombuffer(data, dtype=np.int32).sum(dtype=np.int64)) \
        & 0xFFFFFFFF


def event_ms(fn, reps: int = P16_POOL_REPS,
             warmup: int = P16_POOL_WARMUP) -> float:
    """Median CUDA-event time of ``fn()``, one call per pair of events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_p16_pool() -> dict:
    """(d) The device block pool on the card, a pool per size."""
    rng = np.random.default_rng(16)
    res = {"sizes": {}}
    CHECKSUM.launches = 0
    for n in P16_POOL_SIZES:
        pool = DeviceBlockPool(device="cuda")
        first = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        second = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        recycled0 = pool.recycled
        a = pool.land(first)
        ptr = a.data_ptr()
        sum_a = checksum_u32(a.view(torch.int32))
        pool.recycle(a)
        pooled = pool.pooled_bytes
        del a
        b = pool.land(second)
        sum_b = checksum_u32(b.view(torch.int32))
        ok = (b.data_ptr() == ptr and pool.recycled - recycled0 == 1
              and pooled == n and pool.pooled_bytes == 0
              and sum_a == host_sum(first) and sum_b == host_sum(second)
              and b.is_cuda and b.numel() == n)
        log(f"  (d) {n >> 20} MiB: data_ptr steady across the recycle: "
            f"{b.data_ptr() == ptr}; recycled +{pool.recycled - recycled0}; "
            f"pooled {pooled} then {pool.pooled_bytes} bytes; checksum.cu "
            f"{sum_a:#010x} / {sum_b:#010x} against the host's "
            f"{host_sum(first):#010x} / {host_sum(second):#010x}")
        if not ok:
            raise AssertionError(f"(d) the {n} byte landing was not "
                                 "recycled or checksummed right")
        pool.recycle(b)
        del b
        src = torch.frombuffer(bytearray(second), dtype=torch.uint8)

        def land_recycle():
            pool.recycle(pool.land(second))

        land = event_ms(land_recycle)
        fresh = event_ms(lambda: torch.empty(
            n, dtype=torch.uint8, device="cuda").copy_(src))
        res["sizes"][n] = dict(land_ms=land, land_gb_s=n / land / 1e6,
                               fresh_copy_ms=fresh,
                               fresh_copy_gb_s=n / fresh / 1e6)
        log(f"  (d) {n >> 20} MiB land {land:.4f} ms ({n / land / 1e6:.2f} "
            f"GB/s) against a fresh torch.empty().copy_ {fresh:.4f} ms "
            f"({n / fresh / 1e6:.2f} GB/s), CUDA-event medians of "
            f"{P16_POOL_REPS} after {P16_POOL_WARMUP} warm-ups")
    res["checksum_launches"] = CHECKSUM.launches
    if CHECKSUM.launches != 2 * len(P16_POOL_SIZES):
        raise AssertionError(f"(d) checksum launches {CHECKSUM.launches}")
    capped = DeviceBlockPool(max_bytes=1 << 20, device="cuda")
    big = capped.land(b"\x01" * (P16_POOL_SIZES[1]))
    capped.recycle(big)
    again = capped.land(b"\x02" * (P16_POOL_SIZES[1]))
    log(f"  (d) over the 1 MiB cap: pooled {capped.pooled_bytes} bytes, "
        f"recycled {capped.recycled}")
    if capped.pooled_bytes or capped.recycled or again.numel() != \
            P16_POOL_SIZES[1]:
        raise AssertionError("(d) a recycle over the cap was kept")
    del big, again, capped, pool
    torch.cuda.empty_cache()
    return res


def phase_slice16(svc: LMService, srv: Server, ch: Channel, cfg: LMConfig,
                  rows: list) -> dict:
    """Phase 16 on phase 5's service and server."""
    t0 = time.perf_counter()
    res = {"stages": phase_p16_stages(svc, cfg, rows),
           "tls": phase_p16_tls(svc, cfg, rows, ch),
           "async": phase_p16_async(svc, srv, cfg, rows),
           "pool": phase_p16_pool()}
    res["launches"] = (res["stages"]["gzip"]["launches"]
                       + res["tls"]["launches"] + res["async"]["launches"])
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 16: {res['seconds']:.1f} s; flash_fwd launches "
        f"{res['launches']}, checksum launches "
        f"{res['pool']['checksum_launches']} ({card_line()})")
    return res


def native_server(services: dict, inline: bool = True,
                  options: ServerOptions = None) -> Server:
    """A port Server on the native engine; fails when the engine does not
    load (the Python transport is not an answer here)."""
    from brpc_tpu_torch import native
    if native.load() is None:
        raise AssertionError("phase 17: the native engine did not load")
    opts = options or ServerOptions()
    opts.native = True
    opts.usercode_inline = inline
    server = serve_lm(services, opts)
    if server._native_bridge is None:
        server.stop()
        raise AssertionError("phase 17: the server is not on the engine")
    return server


def engine_lanes(server: Server) -> dict:
    """The engine's handled counts per lane, read fresh."""
    t = server._native_bridge.engine.telemetry()
    return {lane: d["handled"] for lane, d in t["lanes"].items()}


def engine_streams(server: Server) -> dict:
    return dict(server._native_bridge.engine.telemetry()["streams"])


def owns_connections(server: Server, what: str) -> None:
    """Fail unless the engine accepted the part's connections (their
    clients may have closed them by now)."""
    loops = server._native_bridge.engine.telemetry()["loops"]
    if server._native_bridge.connection_count() < 1 \
            and sum(lo["accepts"] for lo in loops) < 1:
        raise AssertionError(f"phase 17 {what}: the bridge owns no "
                             f"connection")


def timed_generates(ch: Channel, prompts: list, rows: list) -> list:
    """Phase 5's requests, one after another: (ids, host ms) each."""
    outs = []
    for prompt, row in zip(prompts, rows):
        t0 = time.perf_counter()
        ids = generate(ch, prompt, row["max_new"])
        outs.append((ids, (time.perf_counter() - t0) * 1e3))
    return outs


def phase_p17_generate(svc: LMService, ch: Channel, cfg: LMConfig,
                       rows: list) -> dict:
    """(a) Phase 5's Generates on the engine, in turns with the Python
    server (phase 5's, through ``ch``), with usercode_inline off and on."""
    prompts = phase5_prompts(cfg)
    res, launches = {}, 0
    for inline in (False, True):
        label = "inline" if inline else "fiber"
        server = native_server({"LM": svc}, inline)
        nch = Channel()
        try:
            nch.init(str(server.listen_endpoint))
            lanes0 = engine_lanes(server)
            ms = {"python": [], "native": []}
            for r in range(P17_ROUNDS):
                order = ("python", "native") if r % 2 == 0 \
                    else ("native", "python")
                for lane in order:
                    FLASH_FWD.launches = 0
                    outs = timed_generates(
                        nch if lane == "native" else ch, prompts, rows)
                    n = FLASH_FWD.launches
                    launches += n
                    check_lane(f"(a) {label} {lane} round {r}", outs, rows,
                               n, cfg)
                    ms[lane].append([t for _, t in outs])
            owns_connections(server, "(a)")
            lanes = {k: v - lanes0[k] for k, v in engine_lanes(server).items()}
        finally:
            nch.close()
            server.stop()
        want_slim = P17_ROUNDS * len(REQUESTS) if inline else 0
        rounded = {lane: [[round(t, 1) for t in r] for r in v]
                   for lane, v in ms.items()}
        log(f"  (a) usercode_inline {inline}: the engine's lanes "
            f"+{lanes}; host ms per shape and round, Python server "
            f"{rounded['python']}, native {rounded['native']} "
            f"({card_line()})")
        if lanes["slim"] != want_slim:
            raise AssertionError(f"(a) {label}: {lanes['slim']} Generates "
                                 f"on the kind-3 lane, expected {want_slim}")
        res[label] = dict(python_ms=ms["python"], native_ms=ms["native"],
                          lanes=lanes)
    res["launches"] = launches
    return res


def lane_compare(a: list, b: list, solo: list) -> tuple:
    """Two runs' session tokens: (sessions equal, sessions that differ
    first at a near-tie of the solo run).  Any other difference fails."""
    equal = ties = 0
    for i, (x, y, (want, margins)) in enumerate(zip(a, b, solo)):
        if x == y:
            equal += 1
            continue
        j = next(k for k, (p, q) in enumerate(zip(x, y)) if p != q) \
            if any(p != q for p, q in zip(x, y)) else min(len(x), len(y))
        if j >= len(margins) or margins[j] >= LOGIT_RTOL:
            raise AssertionError(f"(b) session {i}: the lanes' tokens "
                                 f"differ at {j}, not at a near-tie")
        ties += 1
    return equal, ties


def phase_p17_decode(svc: LMService, cfg: LMConfig, six_b: dict) -> dict:
    """(b) 6b's eight Decode streams on the kind-5 lane against the Python
    stream lane of the same native server."""
    prompts = decode_prompts(cfg, 5, DECODE_SLOTS)
    solo = [solo_reference(svc, cfg, p, DECODE_MAX_NEW) for p in prompts]
    server = native_server({"LM": svc})
    batcher = svc.batcher()
    runs, launches = [], 0
    try:
        for lane in P17_DECODE_ORDER:
            set_flag("rpc_native_stream_lane", lane == "native")
            lanes0, st0 = engine_lanes(server), engine_streams(server)
            emit0 = lm_telemetry.phase_total_ns()["stream_emit"]
            nemit0 = lm_telemetry.phase_counters()["stream_emit"]
            FLASH_FWD.launches = 0
            clients, wall_s, most_live = run_decode_sessions(
                server.listen_endpoint, "LM", prompts, DECODE_STAGGER_S,
                batcher)
            n = FLASH_FWD.launches
            launches += n
            owns_connections(server, "(b)")
            nemit = lm_telemetry.phase_counters()["stream_emit"] - nemit0
            emit_ms = (lm_telemetry.phase_total_ns()["stream_emit"]
                       - emit0) / 1e6 / max(nemit, 1)
            lanes1, st1 = engine_lanes(server), engine_streams(server)
            opened = lanes1["stream"] - lanes0["stream"]
            chunks = st1["chunks_out"] - st0["chunks_out"]
            tokens = sum(len(c.tokens) for c in clients)
            ttfts = sorted(c.ttft_s * 1e3 for c in clients)
            for i, (c, (want, margins)) in enumerate(zip(clients, solo)):
                for j, (got, ref) in enumerate(zip(c.tokens, want)):
                    if got != ref:
                        if margins[j] >= LOGIT_RTOL:
                            raise AssertionError(
                                f"(b) {lane} session {i} token {j}: {got} "
                                f"against the solo run's {ref}")
                        break
            run = dict(lane=lane, tokens=tokens, wall_s=wall_s,
                       tok_s=tokens / wall_s, most_live=most_live,
                       ttft_median_ms=statistics.median(ttfts),
                       ttft_max_ms=ttfts[-1], emit_ms=emit_ms,
                       emit_rounds=nemit, stream_opens=opened,
                       native_chunks=chunks, launches=n,
                       session_tokens=[c.tokens for c in clients])
            runs.append(run)
            log(f"  (b) {lane} stream lane: {tokens} tokens in "
                f"{wall_s:.3f} s = {run['tok_s']:.1f} tok/s aggregate, TTFT "
                f"median {run['ttft_median_ms']:.1f} ms, max "
                f"{run['ttft_max_ms']:.1f} ms; {nemit} emit rounds, "
                f"{emit_ms:.4f} ms each; kind-5 opens {opened}, chunks "
                f"written by the engine {chunks}; flash_fwd {n}")
            want_opens = len(prompts) if lane == "native" else 0
            if opened != want_opens or (chunks > 0) != (lane == "native") \
                    or n != cfg.depth * len(prompts):
                raise AssertionError(f"(b) {lane}: the streams did not "
                                     f"ride the lane asked for")
    finally:
        set_flag("rpc_native_stream_lane", True)
        server.stop()
        batcher.shutdown()
    native = [r for r in runs if r["lane"] == "native"]
    python = [r for r in runs if r["lane"] == "python"]
    equal, ties = lane_compare(native[0]["session_tokens"],
                               python[0]["session_tokens"], solo)
    equal_6b, ties_6b = lane_compare(native[0]["session_tokens"],
                                     six_b["session_tokens"], solo)
    log(f"  (b) sessions with equal tokens on both lanes: {equal} of "
        f"{len(prompts)} ({ties} apart after a near-tie); equal to 6b's: "
        f"{equal_6b} ({ties_6b} after a near-tie); {card_line()}")
    for r in runs:
        del r["session_tokens"]
    return dict(runs=runs, equal=equal, near_ties=ties, equal_6b=equal_6b,
                launches=launches)


def refusals(chans: list, prompt: np.ndarray, max_new: int,
             together: bool) -> list:
    """One Generate on each channel, all refused: one after another, or
    all at once from a thread each; (host ms, code) each."""
    out = [None] * len(chans)

    def one(i):
        t0 = time.perf_counter()
        code = gen_call(chans[i], prompt, max_new, 600_000).error_code
        out[i] = ((time.perf_counter() - t0) * 1e3, code)

    if not together:
        for i in range(len(chans)):
            one(i)
        return out
    gate = threading.Barrier(len(chans))
    threads = [threading.Thread(target=lambda i=i: (gate.wait(), one(i)))
               for i in range(len(chans))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return out


def phase_p17_admission(svc: LMService, cfg: LMConfig, ref: tuple) -> dict:
    """(c) Phase 13 (c)'s method cap, on the engine and on the Python
    transport: the refusals alone and at once, beside two capped calls."""
    prompt, want = ref
    elimit = int(Errno.ELIMIT)
    res = {}
    for lane in ("python", "native"):
        opts = ServerOptions()
        opts.method_max_concurrency = {"LM.Generate": ADMIT_CAP}
        if lane == "native":
            # one loop a connection: the single listener hands each new
            # connection to the next loop, so the refusals never queue
            # behind a capped Generate running on its loop
            opts.native_loops = P17_LOOPS
            set_flag("engine_reuseport", False)
            server = native_server({"LM": svc}, True, opts)
        else:
            server = serve_lm({"LM": svc}, opts)
        try:
            extra = connected_channels(server.listen_endpoint,
                                       ADMIT_CALLS - ADMIT_CAP)
            before = admission.admission_counters()
            FLASH_FWD.launches = 0
            capped = {}
            t = threading.Thread(target=lambda: capped.__setitem__(
                "res", concurrent_generates(server.listen_endpoint,
                                            ADMIT_CAP, prompt, len(want))))
            t.start()
            st = server.method_status("LM.Generate")
            wait_until(lambda: st.inflight == ADMIT_CAP, 60,
                       "the capped calls")
            alone = refusals(extra, prompt, len(want), False)
            burst = refusals(extra, prompt, len(want), True)
            busy = st.inflight == ADMIT_CAP
            t.join(600)
            launches = FLASH_FWD.launches
            verdicts = admission_delta(before)
            if lane == "native":
                owns_connections(server, "(c)")
            for c in extra:
                c.close()
        finally:
            server.stop()
            set_flag("engine_reuseport", True)
        served = [tok for code, _, tok in capped["res"] if code == 0]
        log(f"  (c) {lane}: method cap {ADMIT_CAP}, {len(served)} served "
            f"(phase 5's tokens {all(x == want for x in served)}); refusals "
            f"one after another " + ", ".join(f"[{c}] {ms:.2f}"
                                             for ms, c in alone)
            + " ms; all at once " + ", ".join(f"[{c}] {ms:.2f}"
                                             for ms, c in burst)
            + f" ms; capped calls still running after both {busy}; "
            f"flash_fwd {launches}; overload_admission_total +{verdicts}")
        if len(served) != ADMIT_CAP or any(x != want for x in served) \
                or any(code != elimit for _, code in alone + burst) \
                or launches != cfg.depth * ADMIT_CAP \
                or verdicts.get("-/method_cap") != len(alone) + len(burst):
            raise AssertionError(f"(c) {lane}: the cap did not hold")
        res[lane] = dict(alone_ms=[ms for ms, _ in alone],
                         burst_ms=[ms for ms, _ in burst],
                         capped_running=busy, launches=launches)
    res["launches"] = res["python"]["launches"] + res["native"]["launches"]
    log(f"  (c) ELIMIT median ms alone / at once: Python "
        f"{statistics.median(res['python']['alone_ms']):.2f} / "
        f"{statistics.median(res['python']['burst_ms']):.2f}, native "
        f"{statistics.median(res['native']['alone_ms']):.2f} / "
        f"{statistics.median(res['native']['burst_ms']):.2f}; "
        f"{card_line()}")
    return res


def phase_p17_replicas(svc: LMService, cfg: LMConfig, ref: tuple) -> dict:
    """(d) Two replicas of phase 5's weights, each an LMService (its own
    device lock) on a server of its own: two Generates side by side
    against the two in turn, over RPC, on the engine and in Python."""
    prompt, want = ref
    reps = [LMService(cfg=cfg, params=svc.params, device="cuda",
                      decode_slots=1) for _ in range(2)]
    res, launches = {}, 0
    for lane in ("python", "native", "native", "python"):
        servers = [native_server({"LM": r}) if lane == "native"
                   else serve_lm({"LM": r}) for r in reps]
        chans = []
        try:
            for server in servers:
                c = Channel()
                c.init(str(server.listen_endpoint))
                chans.append(c)
            outs = []

            def one(c):
                out = gen_call(c, prompt, len(want), 600_000)
                outs.append(not out.failed and unpack_generated(
                    out.response)[0].tolist() == want)

            FLASH_FWD.launches = 0
            t0 = time.perf_counter()
            for c in chans:
                one(c)
            turn_ms = (time.perf_counter() - t0) * 1e3
            threads = [threading.Thread(target=one, args=(c,))
                       for c in chans]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            side_ms = (time.perf_counter() - t0) * 1e3
            n = FLASH_FWD.launches
            launches += n
            if lane == "native":
                for server in servers:
                    owns_connections(server, "(d)")
        finally:
            for c in chans:
                c.close()
            for server in servers:
                server.stop()
        log(f"  (d) {lane}: two replicas, in turn {turn_ms:.1f} ms, side by "
            f"side {side_ms:.1f} ms ({side_ms / turn_ms:.2f}x); tokens "
            f"{all(outs)}; flash_fwd {n}")
        if len(outs) != 4 or not all(outs) or n != 4 * cfg.depth:
            raise AssertionError(f"(d) {lane}: a replica's Generate failed")
        res.setdefault(lane, []).append(dict(turn_ms=turn_ms,
                                             side_ms=side_ms))
    res["launches"] = launches
    log(f"  (d) {card_line()}")
    return res


def phase_p17_echo() -> dict:
    """(e) 1 MiB device echoes of the full-width EmbeddingPS on the
    engine against the Python server, in turns."""
    cs = CountedChecksum()
    model = EmbeddingPS(PS_CFG, device="cuda", seed=0)
    servers = {"python": serve_lm({"PS": PSService(model)}),
               "native": native_server({"PS": PSService(model)})}
    chans = {}
    x = torch.arange(ECHO_BYTES // 4, dtype=torch.float32, device="cuda")
    res = {lane: [] for lane in servers}
    try:
        for lane, server in servers.items():
            chans[lane] = Channel()
            chans[lane].init(str(server.listen_endpoint))
            echo(chans[lane], x, cs)        # the domain exchange
        CHECKSUM.launches = 0
        calls0 = cs.calls
        for lane in P17_ECHO_ORDER:
            same = 0
            t0 = time.perf_counter()
            for _ in range(P17_ECHO_CALLS):
                dev, out = echo(chans[lane], x, cs)
                same += dev and out.data_ptr() == x.data_ptr()
            rps = P17_ECHO_CALLS / (time.perf_counter() - t0)
            res[lane].append(dict(rps=rps, zero_copy=same))
            log(f"  (e) {lane}: 1 MiB echo x{P17_ECHO_CALLS}: {rps:.1f} "
                f"calls/s, zero-copy {same}/{P17_ECHO_CALLS}")
            if same != P17_ECHO_CALLS:
                raise AssertionError(f"(e) {lane}: echoes not zero-copy")
        owns_connections(servers["native"], "(e)")
        live, outstanding = wait_fabric_empty()
        launches = CHECKSUM.launches
        calls = cs.calls - calls0
    finally:
        for c in chans.values():
            c.close()
        for server in servers.values():
            server.stop()
    per_call = launches / (len(P17_ECHO_ORDER) * P17_ECHO_CALLS)
    log(f"  (e) checksum.cu launches {launches} for {calls} checksums "
        f"({per_call:.0f} a call); {live} live descriptors, {outstanding} "
        f"outstanding bytes; {card_line()}")
    if launches != calls or per_call != 2 or live or outstanding:
        raise AssertionError("(e): launches or descriptors off")
    res.update(checksum_launches=launches, live_descriptors=live)
    return res


class NativeEcho(Service):
    """``Echo`` answered by the engine with no Python (kind 0)."""

    @raw_method(native="echo")
    def Echo(self, payload, attachment):
        return payload, attachment


def phase_p17_drain(paged: LMService, cfg: LMConfig, ref: tuple) -> dict:
    """(f) A drain during four Decode streams on the kind-5 lane of a
    paged service on the engine."""
    import socket as pysock
    prompt, want = ref
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab, P17_DRAIN_PROMPT, dtype=np.int32)
               for _ in range(P17_DRAIN_STREAMS)]
    server = native_server({"LMPaged": paged, "LM": paged,
                            "Echo": NativeEcho()})
    batcher = paged.batcher()
    probe = pysock.create_connection(("127.0.0.1",
                                      server.listen_endpoint.port))
    try:
        lanes0 = engine_lanes(server)
        clients = [DecodeClient(server.listen_endpoint, "LMPaged", p,
                                DRAIN_MAX_NEW) for p in prompts]
        threads = [threading.Thread(target=c.run) for c in clients]
        FLASH_FWD.launches = 0
        for t in threads:
            t.start()
        wait_until(lambda: all(c.tokens for c in clients), 120,
                   "every stream's first token")
        opened = engine_lanes(server)["stream"] - lanes0["stream"]
        owns_connections(server, "(f)")
        drained = {}
        t0 = time.perf_counter()
        d = threading.Thread(target=lambda: drained.__setitem__(
            "rc", server.drain(DRAIN_GRACE_MS)))
        d.start()
        wait_until(lambda: server.draining, 10, "the drain")
        meta = RpcMeta()
        meta.correlation_id = 5
        meta.service_name, meta.method_name = "Echo", "Echo"
        probe.sendall(pack_frame(meta, b"drain-probe"))
        echo_meta, echo_body, _ = read_frame(probe)
        lame = raw_generate(probe, 7, prompt, len(want))
        d.join(60)
        drain_ms = (time.perf_counter() - t0) * 1e3
        for c in clients:
            if not c.done.wait(60):
                raise AssertionError("(f): a stream never closed")
        for t in threads:
            t.join(10)
        wait_until(lambda: session_pages(batcher) == (0, 0, 0), 60,
                   "the drained sessions' pages")
        left = session_pages(batcher)
        launches = FLASH_FWD.launches
    finally:
        probe.close()
        server.stop()
        batcher.shutdown()
    reasons = [c.reason for c in clients]
    log(f"  (f) drain of a native server during {P17_DRAIN_STREAMS} kind-5 "
        f"Decode streams ({opened} opened on the lane): rc "
        f"{drained.get('rc')} in {drain_ms:.1f} ms; stream reasons "
        f"{reasons}, tokens {[len(c.tokens) for c in clients]}; pages "
        f"held, spills in flight, exported {left}; the engine's own echo "
        f"during the drain: lame_duck TLV {echo_meta.lame_duck}, payload "
        f"intact {echo_body == b'drain-probe'}; a new Generate "
        f"[{lame.error_code}] lame_duck {lame.lame_duck}; flash_fwd "
        f"{launches}; {card_line()}")
    if drained.get("rc") != 0 or set(reasons) != {"lame_duck"} \
            or left != (0, 0, 0) or opened != P17_DRAIN_STREAMS \
            or echo_meta.lame_duck != 1 or echo_body != b"drain-probe" \
            or lame.error_code != int(Errno.ELAMEDUCK) \
            or lame.lame_duck != 1 \
            or launches != cfg.depth * P17_DRAIN_STREAMS:
        raise AssertionError("(f): the native drain did not settle")
    return dict(rc=drained["rc"], drain_ms=drain_ms, left=left,
                tokens=[len(c.tokens) for c in clients], launches=launches)


def phase_slice17(svc: LMService, ch: Channel, cfg: LMConfig, rows: list,
                  six_b: dict, paged: dict) -> dict:
    """Phase 17 on phase 5's service: the native engine."""
    t0 = time.perf_counter()
    ref = (phase5_prompts(cfg)[0], rows[0]["tokens"])
    res = {"generate": phase_p17_generate(svc, ch, cfg, rows),
           "decode": phase_p17_decode(svc, cfg, six_b),
           "admission": phase_p17_admission(svc, cfg, ref),
           "replicas": phase_p17_replicas(svc, cfg, ref),
           "echo": phase_p17_echo(),
           "drain": phase_p17_drain(paged["LMPaged"], cfg, ref)}
    res["launches"] = sum(res[k]["launches"] for k in (
        "generate", "decode", "admission", "replicas", "drain"))
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 17: {res['seconds']:.1f} s; flash_fwd launches "
        f"{res['launches']}, checksum launches "
        f"{res['echo']['checksum_launches']} ({card_line()})")
    return res

P18_ROUNDS = 2                            # (a): turns of the two servers
P18_BATCH = 4                             # (b): Generates in one batch
P18_BATCH_REQUEST = (1, 512, 16)
P18_ECHO_CALLS = 200                      # (e): per arm
P18_ECHO_ORDER = ("single", "pooled", "pooled", "single")
P18_RAW_CALLS = 200


def route_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in fast_call.lane_counters().items()
            if v != before[k]}


def lane_view() -> tuple:
    """The client lane's completions and named fallbacks now."""
    t = client_lane.client_lane_telemetry()
    return t.get("completions", 0), dict(t.get("fallbacks", {}))


def lane_delta(before: tuple) -> tuple:
    comp, fb = lane_view()
    return comp - before[0], {k: v - before[1].get(k, 0)
                              for k, v in fb.items()
                              if v != before[1].get(k, 0)}


def typed_channel(ep, ctype: str) -> Channel:
    opts = ChannelOptions()
    opts.connection_type = ctype
    opts.timeout_ms = PROTO_TIMEOUT_MS
    ch = Channel(opts)
    if ch.init(str(ep)) != 0:
        raise RuntimeError(f"channel to {ep} did not init")
    return ch


def phase_p18_generate(svc: LMService, srv: Server, cfg: LMConfig,
                       rows: list) -> dict:
    """(a) Phase 5's Generates on "pooled" and "short" (the fast lane,
    the engine's ``sync_call``) beside "single" (the client lane), on the
    engine and on the Python server in turns."""
    prompts = phase5_prompts(cfg)
    native = native_server({"LM": svc})
    servers = {"python": srv, "native": native}
    res, launches = {}, 0
    try:
        for r in range(P18_ROUNDS):
            order = ("python", "native") if r % 2 == 0 \
                else ("native", "python")
            for where in order:
                ep = servers[where].listen_endpoint
                for ctype in ("pooled", "short", "single"):
                    ch = typed_channel(ep, ctype)
                    routes0 = fast_call.lane_counters()
                    FLASH_FWD.launches = 0
                    outs = timed_generates(ch, prompts, rows)
                    n = FLASH_FWD.launches
                    routes = route_delta(routes0)
                    ch.close()
                    launches += n
                    check_lane(f"(a) {where} {ctype} round {r}", outs, rows,
                               n, cfg)
                    want = {"sync_call": len(REQUESTS)} \
                        if ctype != "single" else {}
                    if routes != want:
                        raise AssertionError(
                            f"(a) {where} {ctype}: routes {routes}, "
                            f"expected {want}")
                    res.setdefault(f"{where}_{ctype}_ms", []).append(
                        [t for _, t in outs])
        owns_connections(native, "(a)")
    finally:
        native.stop()
    for where in ("python", "native"):
        per = {ctype: [[round(t, 1) for t in x]
                       for x in res[f"{where}_{ctype}_ms"]]
               for ctype in ("pooled", "short", "single")}
        log(f"  (a) {where} server, host ms per shape and round: "
            + "; ".join(f"{ctype} {v}" for ctype, v in per.items())
            + f" ({card_line()})")
    res["launches"] = launches
    return res


def phase_p18_batch(svc: LMService, srv: Server, ch: Channel,
                    cfg: LMConfig) -> dict:
    """(b) ``call_batch`` of four (1, 512, 16) Generates on one pooled
    connection, each response against the same request alone."""
    b, s, max_new = P18_BATCH_REQUEST
    rng = np.random.default_rng(18)
    prompts = [rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
               for _ in range(P18_BATCH)]
    reqs = [pack_generate_request(p, max_new) for p in prompts]
    solo = [generate(ch, p, max_new).tolist() for p in prompts]
    native = native_server({"LM": svc})
    res, launches = {}, 0
    try:
        for where, server in (("python", srv), ("native", native)):
            bch = typed_channel(server.listen_endpoint, "pooled")
            routes0 = fast_call.lane_counters()
            FLASH_FWD.launches = 0
            t0 = time.perf_counter()
            outs = bch.call_batch("LM.Generate", reqs,
                                  timeout_ms=PROTO_TIMEOUT_MS)
            ms = (time.perf_counter() - t0) * 1e3
            n = FLASH_FWD.launches
            routes = route_delta(routes0)
            bch.close()
            launches += n
            same = [unpack_generated(o).tolist() == want
                    for o, want in zip(outs, solo)]
            log(f"  (b) {where}: call_batch of {P18_BATCH} x "
                f"{P18_BATCH_REQUEST} in {ms:.1f} ms, each equal to its "
                f"request alone {same}; flash_fwd {n}; routes {routes}")
            if not all(same) or n != P18_BATCH * cfg.depth \
                    or routes != {"call_batch": 1}:
                raise AssertionError(f"(b) {where}: the batch went wrong")
            res[where] = dict(ms=ms, launches=n)
        owns_connections(native, "(b)")
    finally:
        native.stop()
    res["launches"] = launches
    return res


def phase_p18_scatter(svc: LMService, cfg: LMConfig, ref: tuple,
                      fan_14d_ms: float) -> dict:
    """(c) Phase 14 (d)'s ParallelChannel over two replicas of phase 5's
    weights, fanned out by the engine's ``scatter_call``; then one branch
    behind a balancer, which the scatter lane declines by name."""
    from brpc_tpu_torch.client import ParallelChannel
    prompt, want = ref
    req = pack_generate_request(prompt, len(want))
    reps = [LMService(cfg=cfg, params=svc.params, device="cuda",
                      decode_slots=1) for _ in range(2)]
    res, launches = {}, 0
    for where in ("native", "python"):
        servers = [native_server({"LM": r}) if where == "native"
                   else serve_lm({"LM": r}) for r in reps]
        subs = []
        try:
            pc = ParallelChannel()
            for server in servers:
                sub = Channel()
                sub.init(str(server.listen_endpoint))
                subs.append(sub)
                pc.add_channel(sub)
            fb0, routes0 = fast_call.scatter_fallback_counters(), \
                fast_call.lane_counters()
            FLASH_FWD.launches = 0
            outs = []
            for _ in range(2):          # a warm-up, then the timed one
                cntl = Controller()
                cntl.timeout_ms = PROTO_TIMEOUT_MS
                t0 = time.perf_counter()
                c = pc.call_method("LM.Generate", req, cntl=cntl)
                outs.append((c, (time.perf_counter() - t0) * 1e3))
            (c0, warm_ms), (c, ms) = outs
            n = FLASH_FWD.launches
            routes = route_delta(routes0)
            ok = all(not x.failed and all(
                unpack_generated(r)[0].tolist() == want for r in x.response)
                for x in (c0, c))
            fallbacks = fast_call.scatter_fallback_counters() != fb0
            launches += n
            log(f"  (c) {where}: ParallelChannel over two replicas by "
                f"scatter_call in {ms:.1f} ms after a {warm_ms:.1f} ms "
                f"warm-up (phase 14 (d)'s branch threads: "
                f"{fan_14d_ms:.1f} ms); both phase 5's tokens {ok}; routes "
                f"{routes}; a scatter fallback {fallbacks}; flash_fwd {n}")
            if not ok or fallbacks or routes != {"scatter_call": 2} \
                    or n != 4 * cfg.depth:
                raise AssertionError(f"(c) {where}: the fan-out did not "
                                     f"ride scatter_call")
            res[where] = dict(ms=ms, warm_ms=warm_ms, launches=n)
            if where == "native":
                for server in servers:
                    owns_connections(server, "(c)")
                continue
            # a branch behind a balancer: declined under its name, the
            # branch threads answer
            cluster = Channel()
            cluster.init("list://" + ",".join(
                str(x.listen_endpoint) for x in servers), "rr")
            pc2 = ParallelChannel()
            pc2.add_channel(cluster)
            fb0 = fast_call.scatter_fallback_counters()
            cntl = Controller()
            cntl.timeout_ms = PROTO_TIMEOUT_MS
            FLASH_FWD.launches = 0
            c = pc2.call_method("LM.Generate", req, cntl=cntl)
            n = FLASH_FWD.launches
            cluster.close()
            launches += n
            fb = {k: v - fb0.get(k, 0) for k, v in
                  fast_call.scatter_fallback_counters().items()
                  if v != fb0.get(k, 0)}
            ok = not c.failed and \
                unpack_generated(c.response[0])[0].tolist() == want
            log(f"  (c) a cluster branch: scatter fallbacks {fb}, phase "
                f"5's tokens {ok}; flash_fwd {n}")
            if fb != {"load_balancer": 1} or not ok or n != cfg.depth:
                raise AssertionError("(c): the named fallback went wrong")
            res["fallback"] = fb
        finally:
            for sub in subs:
                sub.close()
            for server in servers:
                server.stop()
    res["launches"] = launches
    log(f"  (c) {card_line()}")
    return res


def phase_p18_decode(svc: LMService, srv: Server, cfg: LMConfig,
                     six_b: dict) -> dict:
    """(d) 6b's eight Decode streams on one shared "single" connection on
    the client lane, ``LM.Info`` calls multiplexed among them, on the
    Python server and on the engine."""
    prompts = decode_prompts(cfg, 5, DECODE_SLOTS)
    solo = [solo_reference(svc, cfg, p, DECODE_MAX_NEW) for p in prompts]
    native = native_server({"LM": svc})
    batcher = svc.batcher()
    runs, launches = [], 0
    try:
        for where, server in (("python", srv), ("native", native)):
            ep = server.listen_endpoint
            shared = typed_channel(ep, "single")
            shared.call("LM.Info", b"", timeout_ms=60_000)
            sock = shared._sock
            if not sock.lane_token:
                raise AssertionError(f"(d) {where}: the shared connection "
                                     f"is not on the client lane")
            lane0 = lane_view()
            infos = []
            stop = threading.Event()
            FLASH_FWD.launches = 0

            def info_during():
                while not stop.wait(DECODE_STAGGER_S):
                    infos.append(shared.call("LM.Info", b"",
                                             timeout_ms=60_000))

            g = threading.Thread(target=info_during)
            g.start()
            try:
                clients, wall_s, most_live = run_decode_sessions(
                    ep, "LM", prompts, DECODE_STAGGER_S, batcher,
                    channel=shared)
            finally:
                stop.set()
                g.join(60)
            n = FLASH_FWD.launches
            comps, fb = lane_delta(lane0)
            same_conn = shared._sock is sock and not sock.failed
            shared.close()
            launches += n
            info_ok = bool(infos) and all(
                json.loads(x)["depth"] == cfg.depth for x in infos)
            for i, (cl, (toks, margins)) in enumerate(zip(clients, solo)):
                for j, (got, r) in enumerate(zip(cl.tokens, toks)):
                    if got != r:
                        if margins[j] >= LOGIT_RTOL:
                            raise AssertionError(
                                f"(d) {where} session {i} token {j}: {got} "
                                f"against the solo run's {r}")
                        break
            tokens = sum(len(cl.tokens) for cl in clients)
            equal_6b, ties_6b = lane_compare(
                [cl.tokens for cl in clients], six_b["session_tokens"],
                solo)
            ttfts = sorted(cl.ttft_s * 1e3 for cl in clients)
            run = dict(where=where, tokens=tokens, wall_s=wall_s,
                       tok_s=tokens / wall_s, most_live=most_live,
                       ttft_median_ms=statistics.median(ttfts),
                       ttft_max_ms=ttfts[-1], lane_completions=comps,
                       lane_fallbacks=fb, equal_6b=equal_6b,
                       near_ties_6b=ties_6b, launches=n)
            runs.append(run)
            log(f"  (d) {where}: {len(clients)} Decode streams and "
                f"{len(infos)} LM.Info calls on one shared connection: "
                f"{tokens} tokens in {wall_s:.3f} s = {run['tok_s']:.1f} "
                f"tok/s aggregate (6b: {six_b['aggregate_tok_s']:.1f}), "
                f"TTFT median {run['ttft_median_ms']:.1f} ms; the Infos "
                f"right {info_ok}; lane completions {comps}, fallbacks {fb}; "
                f"sessions equal to 6b's {equal_6b} ({ties_6b} after a "
                f"near-tie); flash_fwd {n}")
            if not info_ok or not same_conn or comps < len(infos) \
                    or fb.get("cli_stream_frame", 0) < 1 \
                    or fb.get("cli_meta_tags", 0) < len(prompts) \
                    or set(fb) - {"cli_stream_frame", "cli_meta_tags",
                                  "cli_unknown_cid"} \
                    or n != cfg.depth * len(prompts):
                raise AssertionError(f"(d) {where}: the shared connection "
                                     f"or the lane's counts are off")
        owns_connections(native, "(d)")
    finally:
        native.stop()
        batcher.shutdown()
    log(f"  (d) {card_line()}")
    return dict(runs=runs, launches=launches)


def phase_p18_echo() -> dict:
    """(e) 1 MiB device echoes of the full-width EmbeddingPS on the fast
    lane against the Controller path ("single"), in turns, on the engine
    and on the Python server; then 1 MiB ``call_raw`` byte echoes on the
    engine's native echo."""
    cs = CountedChecksum()
    model = EmbeddingPS(PS_CFG, device="cuda", seed=0)
    servers = {"python": serve_lm({"PS": PSService(model)}),
               "native": native_server({"PS": PSService(model),
                                        "Echo": NativeEcho()})}
    x = torch.arange(ECHO_BYTES // 4, dtype=torch.float32, device="cuda")
    res = {}
    chans = []
    try:
        for where, server in servers.items():
            by = {}
            for ctype in ("single", "pooled"):
                c = typed_channel(server.listen_endpoint, ctype)
                chans.append(c)
                echo(c, x, cs)              # the domain exchange
                by[ctype] = c
            CHECKSUM.launches = 0
            calls0 = cs.calls
            routes0 = fast_call.lane_counters()
            rows = {k: [] for k in by}
            for ctype in P18_ECHO_ORDER:
                same = 0
                t0 = time.perf_counter()
                for _ in range(P18_ECHO_CALLS):
                    dev, out = echo(by[ctype], x, cs)
                    same += dev and out.data_ptr() == x.data_ptr()
                rps = P18_ECHO_CALLS / (time.perf_counter() - t0)
                rows[ctype].append(dict(rps=rps, zero_copy=same))
                if same != P18_ECHO_CALLS:
                    raise AssertionError(f"(e) {where} {ctype}: echoes not "
                                         f"zero-copy")
            live, outstanding = wait_fabric_empty()
            launches = CHECKSUM.launches
            calls = cs.calls - calls0
            routes = route_delta(routes0)
            n_fast = P18_ECHO_CALLS * P18_ECHO_ORDER.count("pooled")
            rps = {k: [round(r["rps"], 1) for r in v]
                   for k, v in rows.items()}
            log(f"  (e) {where}: 1 MiB device echo calls/s, fast lane "
                f"{rps['pooled']}, Controller path {rps['single']}; "
                f"checksum.cu {launches} for {calls} checksums; routes "
                f"{routes}; {live} live descriptors, {outstanding} "
                f"outstanding bytes")
            if launches != calls or launches != 2 * P18_ECHO_CALLS * len(
                    P18_ECHO_ORDER) or live or outstanding \
                    or routes != {"sync_call": n_fast}:
                raise AssertionError(f"(e) {where}: launches, routes or "
                                     f"descriptors off")
            res[where] = dict(rows=rows, checksum_launches=launches)
        owns_connections(servers["native"], "(e)")
        raw = typed_channel(servers["native"].listen_endpoint, "pooled")
        chans.append(raw)
        payload = bytes(range(256)) * (ECHO_BYTES // 256)
        def echo_handled():
            t = servers["native"]._native_bridge.engine.telemetry()
            return t["methods"]["Echo.Echo"]["handled"]

        handled0 = echo_handled()
        routes0 = fast_call.lane_counters()
        t0 = time.perf_counter()
        for _ in range(P18_RAW_CALLS):
            body, att = raw.call_raw("Echo.Echo", payload, b"",
                                     timeout_ms=60_000)
            if len(body) != len(payload):
                raise AssertionError("(e) a raw echo came back short")
        raw_rps = P18_RAW_CALLS / (time.perf_counter() - t0)
        ok = bytes(body) == payload
        routes = route_delta(routes0)
        answered = echo_handled() - handled0
        log(f"  (e) call_raw 1 MiB byte echoes on the engine's native "
            f"echo: {raw_rps:.1f} calls/s, payload intact {ok}; routes "
            f"{routes}; answered by the engine's kind-0 echo +{answered}; "
            f"{card_line()}")
        if not ok or routes != {"raw_call": P18_RAW_CALLS} \
                or answered != P18_RAW_CALLS:
            raise AssertionError("(e): the raw echoes went wrong")
        res["raw_rps"] = raw_rps
    finally:
        for c in chans:
            c.close()
        for server in servers.values():
            server.stop()
    res["checksum_launches"] = sum(res[w]["checksum_launches"]
                                   for w in ("python", "native"))
    return res


def phase_p18_drain(svc: LMService, cfg: LMConfig, ref: tuple) -> dict:
    """(f) A drain while a Generate waits on the client lane: no demux
    entry is left; a server stopped and started again on its port: the
    shared connection is revived in place by the health check; /native's
    client_lane and scatter_fallbacks sections."""
    prompt, want = ref
    server = native_server({"LM": svc})
    port = server.listen_endpoint.port
    ch = typed_channel(server.listen_endpoint, "single")
    restarted = None
    try:
        ch.call("LM.Info", b"", timeout_ms=60_000)
        # the sections are process-wide: (a)-(e) filled them
        native_page = json.loads(portal_get(server.listen_endpoint,
                                            "/native"))
        done = threading.Event()
        out = {}

        def finished(c):
            out["c"] = c
            done.set()

        cntl = Controller()
        cntl.timeout_ms = 600_000
        FLASH_FWD.launches = 0
        ch.call_method("LM.Generate", pack_generate_request(
            prompt, len(want)), cntl=cntl, done=finished)
        # the Generate waits on the lane and runs on the card (its first
        # launch), not only written: the drain is then settled by its
        # answer, never by a lame-duck refusal of a request still in
        # flight to the server
        wait_until(lambda: client_lane.pending_inflight() >= 1
                   and FLASH_FWD.launches >= 1, 30,
                   "the Generate's lane entry and its first launch")
        pending = client_lane.pending_inflight()
        t0 = time.perf_counter()
        rc = server.drain(DRAIN_GRACE_MS)
        drain_ms = (time.perf_counter() - t0) * 1e3
        left = client_lane.pending_inflight()
        if not done.wait(60):
            raise AssertionError("(f): the Generate never finished")
        gen_ok = not out["c"].failed and unpack_generated(
            out["c"].response)[0].tolist() == want
        n = FLASH_FWD.launches
        sock = ch._sock
        sid = sock.id
        revived0 = health_check.revive_count()
        server.stop()
        wait_until(lambda: sock.failed or health_check.revive_count()
                   > revived0, 30, "the shared connection's failure")
        opts = ServerOptions()
        opts.native = True
        opts.usercode_inline = True
        restarted = Server(opts)
        if restarted.add_service(svc, name="LM") != 0 \
                or restarted.start(f"127.0.0.1:{port}") != 0:
            raise AssertionError("(f): the server did not restart on its "
                                 "port")
        interval = float(get_flag("health_check_interval_s"))
        t0 = time.perf_counter()
        wait_until(lambda: health_check.revive_count() > revived0
                   and not sock.failed, interval + 10,
                   "the health check's revival")
        revive_s = time.perf_counter() - t0
        after = ch.call("LM.Info", b"", timeout_ms=60_000)
        same = ch._sock is sock and sock.id == sid
    finally:
        ch.close()
        server.stop()
        if restarted is not None:
            restarted.stop()
    cl, sf = native_page["client_lane"], native_page["scatter_fallbacks"]
    log(f"  (f) drain with a Generate out on the lane ({pending} demux "
        f"entries): rc {rc} in {drain_ms:.1f} ms, {left} entries left, "
        f"the Generate's tokens {gen_ok}; restarted on port {port}: "
        f"revived in place {same} after {revive_s:.2f} s "
        f"(health_check_interval_s {interval}), socket_revive_count "
        f"+{health_check.revive_count() - revived0}, a call after "
        f"{bool(after)}; /native client_lane completions "
        f"{cl.get('completions')}, fallbacks {cl.get('fallbacks')}, "
        f"scatter_fallbacks {sf}; flash_fwd {n}")
    if rc != 0 or left or not gen_ok or not same \
            or health_check.revive_count() - revived0 < 1 \
            or revive_s > interval + 1.0 or not cl.get("completions") \
            or not sf or n != cfg.depth:
        raise AssertionError("(f): the drain, the revival or /native off")
    return dict(rc=rc, drain_ms=drain_ms, left=left, revive_s=revive_s,
                launches=n)


def phase_slice18(svc: LMService, srv: Server, ch: Channel, cfg: LMConfig,
                  rows: list, six_b: dict, cluster: dict) -> dict:
    """Phase 18 on phase 5's service: the client on the native engine."""
    from brpc_tpu_torch import native
    if native.load() is None:
        raise AssertionError("phase 18: the native engine did not load")
    t0 = time.perf_counter()
    ref = (phase5_prompts(cfg)[0], rows[0]["tokens"])
    res = {"generate": phase_p18_generate(svc, srv, cfg, rows),
           "batch": phase_p18_batch(svc, srv, ch, cfg),
           "scatter": phase_p18_scatter(svc, cfg, ref,
                                        cluster["fanout"]["fan_ms"]),
           "decode": phase_p18_decode(svc, srv, cfg, six_b),
           "echo": phase_p18_echo(),
           "drain": phase_p18_drain(svc, cfg, ref)}
    if fast_call.lane_counters()["py_sync_call"]:
        raise AssertionError("phase 18: a call fell to the Python round "
                             "trip")
    res["launches"] = sum(res[k]["launches"] for k in (
        "generate", "batch", "scatter", "decode", "drain"))
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 18: {res['seconds']:.1f} s; flash_fwd launches "
        f"{res['launches']}, checksum launches "
        f"{res['echo']['checksum_launches']}; the fast lane's routes "
        f"{fast_call.lane_counters()} ({card_line()})")
    return res


P19_ROUNDS = 2                            # (a): turns of the two servers
P19_CONCURRENT = 4                        # (c): Generates on one connection
P19_CONCURRENT_REQUEST = (1, 512, 16)
P19_IDLE_CONNECTIONS = 16                 # (a): connections for the census
P19_ECHO_CALLS = 200                      # (d)
P19_TRACED_ECHOES = 50                    # (d): echoes traced on the server
P19_TLS_WRITERS = 4                       # (e): threads on one connection
P19_TLS_ECHOES = 25                       # (e): 1 MiB echoes per writer
P19_DRAIN_STREAMS = 4                     # (g)
# threads that would serve one connection each: the Python transport's
# names before this slice (the accept, reader, worker and client reader
# threads); none may exist while phase 19 runs
P19_CONN_THREAD_NAMES = ("tpu_std-accept", "internal-accept",
                         "tpu_std-conn", "tpu_std-work", "tpu_std-reader")


class P19Redis:
    """A "redis" service on the LM's port: SET, GET, INCR, PING."""

    def __init__(self):
        self.store = {}
        self.lock = threading.Lock()

    def on_command(self, args):
        cmd = args[0].upper()
        with self.lock:
            if cmd == b"PING":
                return "PONG"
            if cmd == b"SET":
                self.store[args[1]] = args[2]
                return "OK"
            if cmd == b"GET":
                return self.store.get(args[1])
            if cmd == b"INCR":
                v = int(self.store.get(args[1], b"0")) + 1
                self.store[args[1]] = str(v).encode()
                return v
        raise RedisError(f"unknown command {cmd.decode()}")


class P19Thrift:
    """A "thrift" service on the LM's port: ``greet`` and ``echo``."""

    def handle(self, method, body):
        if method == "echo":
            return body
        if method == "greet":
            name, _ = TBinary.read_string(body, 0)
            return TBinary.write_string(b"hello " + name)
        raise KeyError(method)


def conn_threads() -> list:
    """Threads named as the old transport named its per-connection ones."""
    return [t.name for t in threading.enumerate()
            if t.name.startswith(P19_CONN_THREAD_NAMES)]


def on_dispatcher(server: Server, what: str) -> None:
    """Fail unless ``server`` is a default Server on the acceptor and the
    dispatcher, with no thread serving one connection."""
    if server._native_bridge is not None or not server.acceptors:
        raise AssertionError(f"phase 19 {what}: the server is not on the "
                             f"Python transport's acceptor")
    names = conn_threads()
    if names:
        raise AssertionError(f"phase 19 {what}: per-connection threads "
                             f"{names}")


class ServerStamps:
    """Stamps of the Python transport's server side, on
    ``time.monotonic_ns``, for a traced run: the dispatcher's wake-up of
    a connection (``Socket.start_input_event``), its consumer fiber's
    start (``Socket._process_events``), a tpu_std request's cut (its
    ``recv_ns``) and each write (``Socket.write``).  The four are wrapped
    inside the ``with`` block only; a connection registered before it is
    woken through the bound method it registered, so a traced run opens
    its connections inside the block."""

    def __init__(self):
        self.stamps = []

    def __enter__(self):
        self.install()
        return self

    def __exit__(self, *exc):
        self.remove()

    def install(self) -> None:
        from brpc_tpu_torch.protocol.tpu_std import TPU_STD
        stamps = self.stamps
        self._saved = (Socket.start_input_event, Socket._process_events,
                       Socket.write, TPU_STD.parse)
        wake, consume, write, cut = self._saved

        def t_wake(sock):
            stamps.append(("wake", sock.id, time.monotonic_ns()))
            return wake(sock)

        def t_consume(sock):
            stamps.append(("consumer", sock.id, time.monotonic_ns()))
            return consume(sock)

        def t_write(sock, data):
            stamps.append(("write", sock.id, time.monotonic_ns()))
            return write(sock, data)

        def t_cut(source, sock, read_eof, arg):
            r = cut(source, sock, read_eof, arg)
            if r.ok and arg is not None:
                stamps.append(("cut", sock.id, r.message.recv_ns))
            return r

        Socket.start_input_event = t_wake
        Socket._process_events = t_consume
        Socket.write = t_write
        TPU_STD.parse = t_cut

    def remove(self) -> None:
        from brpc_tpu_torch.protocol.tpu_std import TPU_STD
        (Socket.start_input_event, Socket._process_events, Socket.write,
         TPU_STD.parse) = self._saved

    def call(self, t0: int, t1: int) -> dict:
        """One call's server side, between ``t0`` and ``t1``: ms after
        ``t0`` of its request's cut, the wake-up and consumer start on
        that connection before it, and the first write after it."""
        cuts = [(sid, ns) for k, sid, ns in self.stamps
                if k == "cut" and t0 <= ns <= t1]
        if not cuts:
            return {}
        sid, cut = cuts[0]

        def last(kind):
            v = [ns for k, i, ns in self.stamps
                 if k == kind and i == sid and t0 <= ns <= cut]
            return v[-1] if v else None

        wake, consumer = last("wake"), last("consumer")
        writes = [ns for k, i, ns in self.stamps
                  if k == "write" and i == sid and cut <= ns <= t1]
        ms = lambda ns: None if ns is None else (ns - t0) / 1e6  # noqa
        return dict(wake=ms(wake), consumer=ms(consumer), cut=ms(cut),
                    write=ms(writes[0] if writes else None),
                    end=ms(t1))


def stamp_segments(traces: list) -> dict:
    """Median ms of each step of traced calls: the client's send to the
    dispatcher's wake-up, the wake-up to the consumer fiber, the consumer
    to the cut, the cut to the response's write (the handler), and the
    write to the call's return on the client.  A request the consumer
    read on its way to EAGAIN, after the last answer, had no wake-up of
    its own: counted apart."""
    steps = (("send_to_wake", None, "wake"),
             ("wake_to_consumer", "wake", "consumer"),
             ("consumer_to_cut", "consumer", "cut"),
             ("cut_to_write", "cut", "write"),
             ("write_to_return", "write", "end"))
    out = {}
    for name, a, b in steps:
        v = [t[b] - (t[a] if a else 0.0) for t in traces
             if t.get(b) is not None and (a is None or t.get(a) is not None)]
        out[name] = round(statistics.median(v), 4) if v else None
    out["calls"] = len(traces)
    out["read_without_wake"] = sum(t.get("cut") is not None
                                   and t.get("wake") is None for t in traces)
    return out


def info_frame(cid: int) -> bytes:
    meta = RpcMeta()
    meta.correlation_id = cid
    meta.service_name, meta.method_name = "LM", "Info"
    return pack_frame(meta, b"")


def phase_p19_generate(svc: LMService, srv: Server, cfg: LMConfig,
                       rows: list) -> dict:
    """(a) Phase 5's Generates on phase 5's default Server over "single"
    and "pooled", in turns with the same calls to ``Server(native=True)``;
    then a census: idle connections add no thread."""
    import socket as pysock
    prompts = phase5_prompts(cfg)
    native = native_server({"LM": svc})
    servers = {"python": srv, "native": native}
    res, launches = {}, 0
    try:
        for r in range(P19_ROUNDS):
            order = ("python", "native") if r % 2 == 0 \
                else ("native", "python")
            for where in order:
                ep = servers[where].listen_endpoint
                for ctype in ("single", "pooled"):
                    ch = typed_channel(ep, ctype)
                    FLASH_FWD.launches = 0
                    outs = timed_generates(ch, prompts, rows)
                    n = FLASH_FWD.launches
                    ch.close()
                    launches += n
                    check_lane(f"(a) {where} {ctype} round {r}", outs, rows,
                               n, cfg)
                    res.setdefault(f"{where}_{ctype}_ms", []).append(
                        [t for _, t in outs])
        on_dispatcher(srv, "(a)")
        owns_connections(native, "(a)")
    finally:
        native.stop()
    for where in ("python", "native"):
        per = {ctype: [[round(t, 1) for t in x]
                       for x in res[f"{where}_{ctype}_ms"]]
               for ctype in ("single", "pooled")}
        log(f"  (a) {where} server, host ms per shape and round: "
            + "; ".join(f"{ctype} {v}" for ctype, v in per.items())
            + f" ({card_line()})")
    ep = srv.listen_endpoint
    before = threading.active_count()
    conns0 = srv.connection_count()
    socks = [pysock.create_connection((ep.host, ep.port), timeout=60)
             for _ in range(P19_IDLE_CONNECTIONS)]
    try:
        for i, s in enumerate(socks):
            s.sendall(info_frame(100 + i))
        answered = sum(read_frame(s)[0].error_code == 0 for s in socks)
        wait_until(lambda: srv.connection_count()
                   >= conns0 + P19_IDLE_CONNECTIONS, 30, "the census")
        grown = threading.active_count() - before
        on_dispatcher(srv, "(a) census")
    finally:
        for s in socks:
            s.close()
    log(f"  (a) {P19_IDLE_CONNECTIONS} more connections to the default "
        f"server, an LM.Info on each ({answered} answered): threads "
        f"{before} -> {before + grown}; connection_count "
        f"{conns0 + P19_IDLE_CONNECTIONS}+")
    if answered != P19_IDLE_CONNECTIONS or grown >= P19_IDLE_CONNECTIONS // 2:
        raise AssertionError("(a): the connections grew the threads")
    res.update(launches=launches, census_threads_grown=grown)
    return res


def phase_p19_decode(svc: LMService, srv: Server, cfg: LMConfig,
                     six_b: dict, slice17: dict) -> dict:
    """(b) 6b's eight Decode streams on one shared "single" connection to
    phase 5's default Server: the tokens of the solo generator (6b's
    near-tie rule), aggregate tok/s and TTFT beside 6b's and phase 17's
    engine figures."""
    prompts = decode_prompts(cfg, 5, DECODE_SLOTS)
    solo = [solo_reference(svc, cfg, p, DECODE_MAX_NEW) for p in prompts]
    batcher = svc.batcher()
    ep = srv.listen_endpoint
    shared = typed_channel(ep, "single")
    shared.call("LM.Info", b"", timeout_ms=60_000)
    sock = shared._sock
    msgs0 = messenger_counters()
    FLASH_FWD.launches = 0
    try:
        clients, wall_s, most_live = run_decode_sessions(
            ep, "LM", prompts, DECODE_STAGGER_S, batcher, channel=shared)
    finally:
        same_conn = shared._sock is sock and not sock.failed
        shared.close()
    n = FLASH_FWD.launches
    for i, (cl, (toks, margins)) in enumerate(zip(clients, solo)):
        for j, (got, want) in enumerate(zip(cl.tokens, toks)):
            if got != want:
                if margins[j] >= LOGIT_RTOL:
                    raise AssertionError(f"(b) session {i} token {j}: {got}"
                                         f" against the solo run's {want}")
                break
    tokens = sum(len(cl.tokens) for cl in clients)
    equal_6b, ties_6b = lane_compare([cl.tokens for cl in clients],
                                     six_b["session_tokens"], solo)
    ttfts = sorted(cl.ttft_s * 1e3 for cl in clients)
    msgs = {k: v - msgs0[k] for k, v in messenger_counters().items()}
    engine = [r for r in slice17["decode"]["runs"] if r["lane"] == "native"]
    run = dict(tokens=tokens, wall_s=wall_s, tok_s=tokens / wall_s,
               most_live=most_live, ttft_median_ms=statistics.median(ttfts),
               ttft_max_ms=ttfts[-1], equal_6b=equal_6b,
               near_ties_6b=ties_6b, launches=n, messages=msgs)
    log(f"  (b) {len(clients)} Decode streams on one shared connection to "
        f"the default server: {tokens} tokens in {wall_s:.3f} s = "
        f"{run['tok_s']:.1f} tok/s aggregate (6b: "
        f"{six_b['aggregate_tok_s']:.1f}; phase 17's engine, kind-5 lane: "
        f"{[round(r['tok_s'], 1) for r in engine]}), TTFT median "
        f"{run['ttft_median_ms']:.1f} ms, max {run['ttft_max_ms']:.1f} ms "
        f"(6b: {six_b['ttft_median_ms']:.1f} ms; engine: "
        f"{[round(r['ttft_median_ms'], 1) for r in engine]}); sessions "
        f"equal to 6b's {equal_6b} ({ties_6b} after a near-tie); messenger "
        f"{msgs}; flash_fwd {n}; {card_line()}")
    if not same_conn or n != cfg.depth * len(prompts) \
            or any(cl.reason != "finished" for cl in clients):
        raise AssertionError("(b): the shared connection, the streams or "
                             "the launches are off")
    on_dispatcher(srv, "(b)")
    return run


def phase_p19_concurrent(svc: LMService, srv: Server,
                         cfg: LMConfig) -> dict:
    """(c) Four Generates at once on one "single" connection, each
    against the same request alone; the messenger's spawned and inline
    counts."""
    b, s, max_new = P19_CONCURRENT_REQUEST
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
               for _ in range(P19_CONCURRENT)]
    ch = typed_channel(srv.listen_endpoint, "single")
    try:
        solo = [generate(ch, p, max_new).tolist() for p in prompts]
        out = [None] * len(prompts)
        msgs0 = messenger_counters()
        FLASH_FWD.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, generate(ch, prompts[i], max_new).tolist()))
            for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall_ms = (time.perf_counter() - t0) * 1e3
        n = FLASH_FWD.launches
        msgs = {k: v - msgs0[k] for k, v in messenger_counters().items()}
    finally:
        ch.close()
    same = sum(o == w for o, w in zip(out, solo))
    log(f"  (c) {len(prompts)} Generates {P19_CONCURRENT_REQUEST} at once "
        f"on one connection: {same} equal to the request alone, "
        f"{wall_ms:.1f} ms for all; the messenger ran {msgs['inline']} "
        f"inline and spawned {msgs['spawned']} (server and client "
        f"messengers of this process); flash_fwd {n}; {card_line()}")
    if same != len(prompts) or n != cfg.depth * len(prompts):
        raise AssertionError("(c): an answer or the launches are off")
    on_dispatcher(srv, "(c)")
    return dict(equal=same, wall_ms=wall_ms, messages=msgs, launches=n)


def phase_p19_echo(slice17: dict) -> dict:
    """(d) 1 MiB device echoes of the full-width EmbeddingPS on a default
    Server: checksum.cu twice an echo, zero-copy, no live descriptor
    after; calls/s beside phase 17's engine figure."""
    cs = CountedChecksum()
    model = EmbeddingPS(PS_CFG, device="cuda", seed=0)
    server = serve_lm({"PS": PSService(model)})
    x = torch.arange(ECHO_BYTES // 4, dtype=torch.float32, device="cuda")
    ch = typed_channel(server.listen_endpoint, "single")
    try:
        echo(ch, x, cs)                 # the domain exchange
        on_dispatcher(server, "(d)")
        CHECKSUM.launches = 0
        calls0 = cs.calls
        same = 0
        t0 = time.perf_counter()
        for _ in range(P19_ECHO_CALLS):
            dev, out = echo(ch, x, cs)
            same += dev and out.data_ptr() == x.data_ptr()
        rps = P19_ECHO_CALLS / (time.perf_counter() - t0)
        live, outstanding = wait_fabric_empty()
        launches = CHECKSUM.launches
        calls = cs.calls - calls0
    finally:
        ch.close()
        server.stop()
    traced = traced_echoes(model, x, cs)
    engine = [round(r["rps"], 1) for r in slice17["echo"]["native"]]
    log(f"  (d) 1 MiB device echo x{P19_ECHO_CALLS} on the default server: "
        f"{rps:.1f} calls/s (phase 17's engine: {engine}), zero-copy "
        f"{same}/{P19_ECHO_CALLS}; checksum.cu {launches} for {calls} "
        f"checksums; {live} live descriptors, {outstanding} outstanding "
        f"bytes; {card_line()}")
    log(f"      traced apart, {P19_TRACED_ECHOES} more echoes a server, "
        f"median ms of each step: {traced}")
    if same != P19_ECHO_CALLS or launches != calls \
            or launches != 2 * P19_ECHO_CALLS or live or outstanding:
        raise AssertionError("(d): zero-copy, launches or descriptors off")
    return dict(rps=rps, zero_copy=same, checksum_launches=launches,
                live_descriptors=live, traced=traced)


def traced_echoes(model, x: torch.Tensor, cs) -> dict:
    """(d)'s echo, each step timed on the host clock (the checksum
    before, the call, the landing's redeem, the checksum after), on a
    default server and connection of their own with the call's server
    side stamped (``ServerStamps``), and on the engine beside it; after
    the timed run, so that the stamps cost it nothing: the median ms of
    each step, per server."""
    out = {}
    for kind in ("python", "native"):
        with ServerStamps() as st:
            services = {"PS": PSService(model)}
            server = serve_lm(services) if kind == "python" \
                else native_server(services)
            ch = typed_channel(server.listen_endpoint, "single")
            try:
                echo(ch, x, cs)
                traces, host = [], []
                for _ in range(P19_TRACED_ECHOES):
                    del st.stamps[:]
                    t = [time.monotonic_ns()]
                    cs(x)
                    t.append(time.monotonic_ns())
                    c = ps_call(ch, "EchoTensor", device_att=x)
                    t.append(time.monotonic_ns())
                    landed = c.response_device_attachment.tensor()
                    t.append(time.monotonic_ns())
                    cs(landed)
                    t.append(time.monotonic_ns())
                    traces.append(st.call(t[1], t[2]))
                    host.append([(b - a) / 1e6 for a, b in zip(t, t[1:])])
            finally:
                ch.close()
                server.stop()
        steps = stamp_segments(traces) if kind == "python" else {}
        for i, name in enumerate(("checksum_before", "call", "redeem",
                                  "checksum_after")):
            steps[name] = round(statistics.median(h[i] for h in host), 4)
        out[kind] = steps
    wait_fabric_empty()
    return out


def phase_p19_tls(svc: LMService, cfg: LMConfig, rows: list) -> dict:
    """(e) Phase 16's TLS Generates on a default TLS Server, then 1 MiB
    TLS echoes from four writer threads on one connection."""
    prompts = phase5_prompts(cfg)
    tmp = tempfile.mkdtemp(prefix="p19-certs-")
    cert, key = make_cert_pair(tmp)
    opts = ServerOptions()
    opts.ssl_cert, opts.ssl_key = cert, key
    srv = serve_lm({"LM": svc, "S": Stages16()}, opts)
    tls = p16_channel(srv.listen_endpoint, ssl=True, ssl_ca=cert,
                      ssl_verify=True)
    try:
        FLASH_FWD.launches = 0
        gen_ms = []
        for prompt, (_, _, max_new), row in zip(prompts, REQUESTS, rows):
            ids, c, ms = p16_generate(tls, prompt, max_new)
            if ids is None or ids.tolist() != row["ids"]:
                raise AssertionError(f"(e) TLS Generate: {c.error_text} or "
                                     f"tokens off")
            gen_ms.append(ms)
        n = FLASH_FWD.launches
        payloads = [np.random.default_rng(190 + i).integers(
            0, 256, ECHO_BYTES, dtype=np.uint8).tobytes()
            for i in range(P19_TLS_WRITERS)]
        errors = []

        def writer(i):
            for _ in range(P19_TLS_ECHOES):
                c = tls.call_method("S.Echo", payloads[i],
                                    cntl=p16_cntl())
                if c.failed or c.response != payloads[i]:
                    errors.append(f"[{c.error_code}] {c.error_text}"
                                  if c.failed else "a corrupted echo")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(P19_TLS_WRITERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        rps = P19_TLS_WRITERS * P19_TLS_ECHOES / (time.perf_counter() - t0)
        conns = srv.connection_count()
        on_dispatcher(srv, "(e)")
    finally:
        tls.close()
        srv.stop()
    log(f"  (e) TLS on a default server: phase 5's Generates "
        f"{[round(m, 1) for m in gen_ms]} ms, tokens equal, flash_fwd {n}; "
        f"{P19_TLS_WRITERS} writers x {P19_TLS_ECHOES} 1 MiB echoes on one "
        f"connection: {rps:.1f} calls/s, errors {errors[:3] or 'none'}; "
        f"{conns} server connection(s); {card_line()}")
    if errors or n != cfg.depth * len(REQUESTS) or conns != 1:
        raise AssertionError("(e): a TLS call failed or the launches are "
                             "off")
    return dict(generate_ms=gen_ms, echo_calls_s=rps, launches=n)


def phase_p19_ecosystem(svc: LMService, cfg: LMConfig, ref: tuple) -> dict:
    """(f) RESP and thrift on the LM server's own port, on both
    transports, while a Generate runs on another connection."""
    prompt, want = ref
    res, launches = {}, 0
    for where in ("python", "native"):
        services = {"LM": svc, "redis": P19Redis(), "thrift": P19Thrift()}
        server = native_server(services) if where == "native" \
            else serve_lm(services)
        ep = str(server.listen_endpoint)
        ch = typed_channel(server.listen_endpoint, "single")
        r = RedisClient(ep, timeout_s=60.0)
        tc = ThriftClient(ep, timeout_s=60.0)
        try:
            out = {}
            FLASH_FWD.launches = 0
            g = threading.Thread(target=lambda: out.__setitem__(
                "gen", gen_call(ch, prompt, len(want), 600_000)))
            g.start()
            if where == "python":
                wait_until(lambda: server.inflight == 1, 60,
                           "the Generate in flight")
            t0 = time.perf_counter()
            answers = [r.ping(), r.set("k19", b"v19"), r.get("k19"),
                       r.incr("n19"),
                       r.pipeline([("SET", "p%d" % i, "x%d" % i)
                                   for i in range(8)] + [("GET", "p5")]),
                       tc.call("greet", TBinary.write_string(b"tpu")),
                       tc.call("echo", b"\x0b\x00\x01abc\x00")]
            side_ms = (time.perf_counter() - t0) * 1e3
            during = g.is_alive()
            g.join(600)
            c = out["gen"]
            n = FLASH_FWD.launches
            if where == "python":
                on_dispatcher(server, "(f)")
        finally:
            r.close()
            tc.close()
            ch.close()
            server.stop()
        ok = answers[:4] == ["PONG", "OK", b"v19", 1] \
            and answers[4] == ["OK"] * 8 + [b"x5"] \
            and TBinary.read_string(answers[5], 0)[0] == b"hello tpu" \
            and answers[6] == b"\x0b\x00\x01abc\x00"
        toks = None if c.failed else unpack_generated(c.response)[0].tolist()
        log(f"  (f) {where}: redis PING/SET/GET/INCR/9-command pipeline and "
            f"two thrift calls on the LM's port in {side_ms:.1f} ms "
            f"(the Generate still running at the end: {during}); answers "
            f"right {ok}; the Generate's tokens equal phase 5's "
            f"{toks == want}; flash_fwd {n}")
        if not ok or toks != want or n != cfg.depth:
            raise AssertionError(f"(f) {where}: an answer or the Generate "
                                 f"is off")
        res[where] = dict(side_ms=side_ms, during=during)
        launches += n
    res["launches"] = launches
    return res


def phase_p19_drain(paged: LMService, cfg: LMConfig) -> dict:
    """(g) A drain of a default server during four Decode streams of a
    paged service: no connection and no page left; a connection made
    during the drain waits in the backlog and is served once ``start``
    ends the drain."""
    import socket as pysock
    rng = np.random.default_rng(190)
    prompts = [rng.integers(0, cfg.vocab, P17_DRAIN_PROMPT, dtype=np.int32)
               for _ in range(P19_DRAIN_STREAMS)]
    server = serve_lm({"LMPaged": paged, "LM": paged})
    batcher = paged.batcher()
    late = None
    try:
        clients = [DecodeClient(server.listen_endpoint, "LMPaged", p,
                                DRAIN_MAX_NEW) for p in prompts]
        threads = [threading.Thread(target=c.run) for c in clients]
        FLASH_FWD.launches = 0
        for t in threads:
            t.start()
        wait_until(lambda: all(c.tokens for c in clients), 120,
                   "every stream's first token")
        on_dispatcher(server, "(g)")
        drained = {}
        t0 = time.perf_counter()
        d = threading.Thread(target=lambda: drained.__setitem__(
            "rc", server.drain(DRAIN_GRACE_MS)))
        d.start()
        wait_until(lambda: server.draining, 10, "the drain")
        ep = server.listen_endpoint
        late = pysock.create_connection((ep.host, ep.port), timeout=60)
        late.sendall(info_frame(77))
        d.join(60)
        drain_ms = (time.perf_counter() - t0) * 1e3
        for c in clients:
            if not c.done.wait(60):
                raise AssertionError("(g): a stream never closed")
        for t in threads:
            t.join(10)
        wait_until(lambda: session_pages(batcher) == (0, 0, 0), 60,
                   "the drained sessions' pages")
        left = session_pages(batcher)
        wait_until(lambda: server.connection_count() == 0, 30,
                   "the drained connections")
        conns = server.connection_count()
        late.settimeout(0.2)
        try:
            early = late.recv(1)
        except pysock.timeout:
            early = None            # nothing: it waits in the backlog
        late.settimeout(60)
        t1 = time.perf_counter()
        rc_start = server.start()
        meta, body, _ = read_frame(late)
        served_ms = (time.perf_counter() - t1) * 1e3
        launches = FLASH_FWD.launches
    finally:
        if late is not None:
            late.close()
        server.stop()
        batcher.shutdown()
    reasons = [c.reason for c in clients]
    info_ok = meta.error_code == 0 and json.loads(body)["depth"] == cfg.depth
    log(f"  (g) drain of a default server during {P19_DRAIN_STREAMS} paged "
        f"Decode streams: rc {drained.get('rc')} in {drain_ms:.1f} ms; "
        f"stream reasons {reasons}, tokens "
        f"{[len(c.tokens) for c in clients]}; pages held, spills in "
        f"flight, exported {left}; connection_count {conns}; a connection "
        f"made during the drain answered before start: {early is not None}"
        f", its LM.Info answered {served_ms:.1f} ms after start (rc "
        f"{rc_start}): {info_ok}; flash_fwd {launches}; {card_line()}")
    if drained.get("rc") != 0 or set(reasons) != {"lame_duck"} \
            or left != (0, 0, 0) or conns != 0 or early is not None \
            or rc_start != 0 or not info_ok:
        raise AssertionError("(g): the drain did not settle or the backlog "
                             "was not served after start")
    return dict(rc=drained["rc"], drain_ms=drain_ms, left=left,
                served_ms=served_ms, launches=launches)


def phase_slice19(svc: LMService, srv: Server, cfg: LMConfig, rows: list,
                  six_b: dict, slice17: dict, paged: dict) -> dict:
    """Phase 19 on phase 5's service: the Python transport on the event
    dispatcher."""
    t0 = time.perf_counter()
    ref = (phase5_prompts(cfg)[0], rows[0]["tokens"])
    on_dispatcher(srv, "start")
    res = {"generate": phase_p19_generate(svc, srv, cfg, rows),
           "decode": phase_p19_decode(svc, srv, cfg, six_b, slice17),
           "concurrent": phase_p19_concurrent(svc, srv, cfg),
           "echo": phase_p19_echo(slice17),
           "tls": phase_p19_tls(svc, cfg, rows),
           "ecosystem": phase_p19_ecosystem(svc, cfg, ref),
           "drain": phase_p19_drain(paged["LMPaged"], cfg)}
    res["launches"] = sum(res[k]["launches"] for k in (
        "generate", "decode", "concurrent", "tls", "ecosystem", "drain"))
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 19: {res['seconds']:.1f} s; flash_fwd launches "
        f"{res['launches']}, checksum launches "
        f"{res['echo']['checksum_launches']}; messenger "
        f"{messenger_counters()} ({card_line()})")
    return res


# Phase 20: the operability and tooling layer on phase 5's service, on a
# default server and on the engine
P20_REQUEST = (1, 512, 16)        # the press's and the swaps' Generate
P20_PRESS_S = 5.0                 # (a): flat out, then at half its rate
P20_PRESS_THREADS = 2
P20_CAPTURE = 16                  # (b): Generates captured on the engine
P20_CAPTURE_THREADS = 4
P20_SWAP_CALLS = 3                # (c), (d): calls on the successor alone
P20_RESENDS = 3                   # (c), (d): a call's sends after its first
P20_CHILD_START_S = 300.0         # (d): the child builds the LM first
P20_TRACKME_S = 20.0
P20_DEVICE = "cuda"
# (d)'s successor: a new process that builds SLICE_CFG from seed 0, takes
# the parent's listener over the handoff socket and serves the LM on it
P20_CHILD = r"""
import json, sys, threading, time
sys.path.insert(0, sys.argv[1])
path, cfg_json, device = sys.argv[2], sys.argv[3], sys.argv[4]
from brpc_tpu_torch.models.lm_service import LMService
from brpc_tpu_torch.models.transformer_lm import LMConfig
from brpc_tpu_torch.ops.flash_attention import FLASH_FWD
from brpc_tpu_torch.server import Server, Service


class CountedLM(Service):
    def __init__(self, svc):
        self.svc, self.answered, self.first_wall = svc, 0, None
        self.lock = threading.Lock()

    def Generate(self, cntl, request):
        out = self.svc.Generate(cntl, request)
        with self.lock:
            self.answered += 1
            if self.first_wall is None:
                self.first_wall = time.time()
        return out


class Ctl(Service):
    def __init__(self, lm):
        self.lm = lm

    def Stats(self, cntl, request):
        return json.dumps({
            "answered": self.lm.answered, "first_wall": self.lm.first_wall,
            "launches": FLASH_FWD.launches,
            "foreign": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "brpc_tpu"))}
        ).encode()


lm = CountedLM(LMService(cfg=LMConfig(**json.loads(cfg_json)),
                         device=device, seed=0))
srv = Server()
srv.add_service(lm, name="LM")
srv.add_service(Ctl(lm), name="Ctl")
print("BUILT", flush=True)
rc = srv.start("127.0.0.1:0", inherit_from=path)
port = srv.listen_endpoint.port if rc == 0 else 0
print(f"STARTED={rc} PORT={port} WALL={time.time()}", flush=True)
if rc != 0:
    sys.exit(3)
sys.stdin.readline()            # the parent closes stdin to stop us
srv.stop()
"""


class CountedLM(Service):
    """Phase 5's service behind a server of phase 20: ``Generate`` only,
    counting the calls this server answered and when it answered first
    (the wall clock, which (d)'s child shares), keeping each answer under
    its request (``answers``, for (a) and (b)), and the tag of every call
    it ran (the request attachment, ``ran``, for (c) and (d))."""

    def __init__(self, svc: LMService):
        self.svc, self.answered, self.first_wall = svc, 0, None
        self.answers: dict = {}
        self.ran: set = set()
        self._lock = threading.Lock()

    def Generate(self, cntl, request):
        tag = bytes(cntl.request_attachment or b"")
        if tag:
            with self._lock:
                self.ran.add(tag)
        out = self.svc.Generate(cntl, request)
        with self._lock:
            self.answered += 1
            if self.first_wall is None:
                self.first_wall = time.time()
            if out is not None:
                self.answers.setdefault(bytes(request), []).append(out)
        return out

    def take_answers(self, request: bytes) -> list:
        """The tokens of every answer to ``request`` since the last take."""
        with self._lock:
            got = self.answers.pop(request, [])
        return [unpack_generated(r)[0].tolist() for r in got]


def p20_server(svc: LMService, where: str) -> tuple:
    """``(server, counted)``: phase 5's service on a default server
    (``"python"``) or on the engine (``"native"``)."""
    lm = CountedLM(svc)
    services = {"LM": lm}
    server = native_server(services) if where == "native" \
        else serve_lm(services)
    if where == "python" and not server.acceptors:
        server.stop()
        raise AssertionError("phase 20: the default server has no acceptor")
    return server, lm


def press_arm(ep, lm: CountedLM, prompt: np.ndarray, max_new: int,
              qps: int) -> tuple:
    """One ``Press`` of ``LM.Generate`` for P20_PRESS_S (``qps`` 0: flat
    out) on pooled connections: ``(summary, the tokens of every answer
    the server gave, launches)``."""
    request = pack_generate_request(prompt, max_new)
    opts = PressOptions()
    opts.server = str(ep)
    opts.method = "LM.Generate"
    opts.input = request
    opts.duration_s = P20_PRESS_S
    opts.threads = P20_PRESS_THREADS
    opts.qps = qps
    opts.timeout_ms = 600_000
    opts.connection_type = "pooled"
    opts.report_interval_s = 3600.0
    opts.report = lambda line: None
    lm.take_answers(request)
    FLASH_FWD.launches = 0
    summary = Press(opts).run()
    return summary, lm.take_answers(request), FLASH_FWD.launches


def phase_p20_press(servers: dict, cfg: LMConfig, ref: tuple) -> dict:
    """(a) ``rpc_press`` drives ``LM.Generate`` flat out and then at half
    the rate it reached, on each server: no error, every answer the
    server gave the request's tokens, ``flash_fwd`` depth a call."""
    prompt, want = ref
    res, launches = {}, 0
    for where, (server, lm) in servers.items():
        arms = {}
        for arm in ("flat", "half"):
            qps = 0 if arm == "flat" else max(
                1, int(arms["flat"]["qps"] / 2))
            s, toks, n = press_arm(server.listen_endpoint, lm, prompt,
                                   P20_REQUEST[2], qps)
            same = sum(t == want for t in toks)
            s = dict(s, target_qps=qps, answers=len(toks), equal=same,
                     launches=n)
            log(f"  (a) {where} {arm} (target {qps or 'none'} calls/s): "
                f"sent {s['sent']}, errors {s['errors']}, "
                f"{s['qps']} calls/s, p50 {s['latency_us_p50'] / 1e3:.1f} "
                f"ms, p99 {s['latency_us_p99'] / 1e3:.1f} ms; {same} of "
                f"the server's {len(toks)} answers equal to the request "
                f"alone; flash_fwd {n}; {card_line()}")
            if s["errors"] or len(toks) != s["sent"] \
                    or same != len(toks) or n != cfg.depth * s["sent"]:
                raise AssertionError(f"(a) {where} {arm}: an error, an "
                                     f"answer or the launches are off")
            arms[arm] = s
            launches += n
        res[where] = arms
    res["launches"] = launches
    return res


def fallback_rows(server: Server) -> dict:
    return dict(server._native_bridge.engine.telemetry()["fallbacks"])


def phase_p20_capture(svc: LMService, servers: dict, cfg: LMConfig) -> dict:
    """(b) ``rpc_dump`` turned on while P20_CAPTURE Generates run on the
    engine (its native dispatch off, each counted ``rpc_dispatch_off``),
    then off (the slim lane again, nothing counted); the dump read back
    by ``DumpReader`` and replayed by ``Replayer`` into the default
    server: every replayed answer the captured call's."""
    engine, _ = servers["native"]
    python, python_lm = servers["python"]
    b, s, max_new = P20_REQUEST
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
               for _ in range(P20_CAPTURE)]
    captured = [None] * len(prompts)
    dump_dir = tempfile.mkdtemp(prefix="rpc_dump_")
    close_dump()
    if not set_flag("rpc_dump_dir", dump_dir):
        raise AssertionError("(b): rpc_dump_dir refused")
    ch = typed_channel(engine.listen_endpoint, "pooled")
    try:
        fb0 = fallback_rows(engine)
        lanes0 = engine_lanes(engine)
        FLASH_FWD.launches = 0
        if not set_flag("rpc_dump", True):
            raise AssertionError("(b): rpc_dump refused")
        try:
            def caller(k):
                for i in range(k, len(prompts), P20_CAPTURE_THREADS):
                    captured[i] = generate(ch, prompts[i],
                                           max_new)[0].tolist()
            threads = [threading.Thread(target=caller, args=(k,))
                       for k in range(P20_CAPTURE_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
        finally:
            set_flag("rpc_dump", False)
        on = fallback_rows(engine)["rpc_dispatch_off"] \
            - fb0["rpc_dispatch_off"]
        n_on = FLASH_FWD.launches
        path = close_dump()
        mid = fallback_rows(engine)["rpc_dispatch_off"]
        slim0 = engine_lanes(engine)["slim"]
        after = [generate(ch, p, max_new)[0].tolist() for p in prompts[:2]]
        off = fallback_rows(engine)["rpc_dispatch_off"] - mid
        slim = engine_lanes(engine)["slim"] - slim0
    finally:
        ch.close()
    frames = DumpReader(path).frames() if path else []
    by_payload = {}
    for i, p in enumerate(prompts):
        by_payload[pack_generate_request(p, max_new)] = captured[i]
    ropts = ReplayOptions()
    ropts.server = str(python.listen_endpoint)
    ropts.dump_files = [path] if path else []
    ropts.timeout_ms = 600_000
    for request in by_payload:
        python_lm.take_answers(request)
    FLASH_FWD.launches = 0
    summary = Replayer(ropts).run()
    n_replay = FLASH_FWD.launches
    # each captured call replayed once: the default server answered its
    # request once, with the captured call's tokens
    same = sum(python_lm.take_answers(request) == [toks]
               for request, toks in by_payload.items())
    log(f"  (b) capture on the engine: {len(frames)} frames in "
        f"{os.path.basename(path or '-')}; rpc_dispatch_off +{on} while "
        f"on, +{off} after (the slim lane +{slim}); the two after equal "
        f"to their captured calls {after == captured[:2]}; replayed into "
        f"the default server: sent {summary['sent']}, errors "
        f"{summary['errors']}, {same} answers equal to the captured "
        f"calls', p50 {summary['latency_us_p50'] / 1e3:.1f} ms; flash_fwd "
        f"{n_on} + {n_replay}; {card_line()}")
    if len(frames) != len(prompts) or on != len(prompts) or off != 0 \
            or slim < 2 or summary["errors"] or same != len(prompts) \
            or after != captured[:2] \
            or n_on != cfg.depth * len(prompts) \
            or n_replay != cfg.depth * len(prompts):
        raise AssertionError("(b): the capture, the gating or the replay "
                             "is off")
    shutil.rmtree(dump_dir, ignore_errors=True)
    return dict(frames=len(frames), dispatch_off_on=on,
                dispatch_off_after=off, replay=summary, equal=same,
                launches=n_on + n_replay + cfg.depth * 2)


def swap_caller(ep, prompt: np.ndarray, max_new: int, want: list,
                stop: threading.Event, out: dict) -> None:
    """Generate after Generate on fresh ("short") connections until
    ``stop``, each attempt tagged by its own request attachment.  A call
    the predecessor refused before running it (answered ``ELAMEDUCK`` on
    a connection it accepted before its drain, or ``ELOGOFF`` once
    stopped, or its connection closed unanswered: brpc's client retries
    all three) is sent again on a new connection, up to P20_RESENDS
    times, its tag kept in ``resent`` (the servers' ``ran`` must not hold
    it); the tags answered right go to ``answered`` (every tag the
    predecessor ran must be there).  A failed connect counts under
    ``refused``, any other failure under ``failed``."""
    opts = ChannelOptions()
    opts.connection_type = "short"
    opts.timeout_ms = 600_000
    ch = Channel(opts)
    ch.init(str(ep))
    request = pack_generate_request(prompt, max_new)
    seq = 0
    while not stop.is_set():
        out["calls"] += 1
        for attempt in range(P20_RESENDS + 1):
            seq += 1
            tag = b"%d" % seq
            c = Controller()
            c.timeout_ms = 600_000
            c.max_retry = 0
            c.request_attachment = tag
            ch.call_method("LM.Generate", request, cntl=c)
            why = p20_resend_reason(c)
            if why is None or attempt == P20_RESENDS:
                break
            out[why] += 1
            out["resent"].add(tag)
        if not c.failed:
            if unpack_generated(c.response)[0].tolist() != want:
                out["wrong"] += 1
            else:
                out["answered"].add(tag)
            continue
        key = "refused" if c.error_code == int(Errno.EFAILEDSOCKET) \
            and c.error_text.startswith("connect to ") else "failed"
        out[key] += 1
        out["errors"].append(f"[{c.error_code}] {c.error_text}")
    ch.close()


def p20_resend_reason(c: Controller):
    """Why a swap's call goes out again: ``"lame_duck"`` (answered
    ``ELAMEDUCK`` or ``ELOGOFF``), ``"closed"`` (its connection closed
    before the answer; not a failed connect), or None."""
    if not c.failed:
        return None
    if c.error_code in (int(Errno.ELAMEDUCK), int(Errno.ELOGOFF)):
        return "lame_duck"
    if c.error_code in (int(Errno.EFAILEDSOCKET), int(Errno.EEOF)) \
            and not c.error_text.startswith("connect to "):
        return "closed"
    return None


def p20_lost(out: dict, *lms) -> int:
    """Calls the swap lost: a call sent again after one of ``lms`` had run
    it, or one the predecessor (``lms[0]``) ran and never answered."""
    ran = set().union(*(lm.ran for lm in lms))
    return len(ran & out["resent"]) + len(lms[0].ran - out["answered"])


def start_swap_caller(ep, ref: tuple) -> tuple:
    out = dict(calls=0, lame_duck=0, closed=0, failed=0, refused=0,
               wrong=0, errors=[], resent=set(), answered=set())
    stop = threading.Event()
    t = threading.Thread(target=swap_caller, args=(
        ep, ref[0], P20_REQUEST[2], ref[1], stop, out))
    t.start()
    return t, stop, out


def export_on_thread(server: Server, path: str, timeout_s: float) -> tuple:
    got = {}
    t = threading.Thread(target=lambda: got.__setitem__(
        "rc", server.export_listeners(path, timeout_s)))
    t.start()
    # the handoff socket is bound, then listens: a successor may connect
    # once it exists and a moment has passed
    wait_until(lambda: os.path.exists(path), 30, "the handoff socket")
    time.sleep(0.05)
    return t, got


def phase_p20_swap(svc: LMService, cfg: LMConfig, ref: tuple) -> dict:
    """(c) Hot restart in one process, on each transport: a client calls
    Generate without pause while the predecessor exports its listeners, a
    successor starts with ``inherit_from=`` on the same port, and the
    predecessor drains and stops."""
    res, launches = {}, 0
    for where in ("python", "native"):
        old, old_lm = p20_server(svc, where)
        ep = old.listen_endpoint
        handoff = os.path.join(tempfile.mkdtemp(prefix="hr_"), "handoff")
        FLASH_FWD.launches = 0
        caller, stop, out = start_swap_caller(ep, ref)
        new = new_lm = None
        try:
            wait_until(lambda: old_lm.answered >= 1, 600,
                       "a first answer from the predecessor")
            t_export = time.time()
            t, got = export_on_thread(old, handoff, 30.0)
            new_lm = CountedLM(svc)
            opts = ServerOptions()
            if where == "native":
                opts.native = True
                opts.usercode_inline = True
            new = Server(opts)
            new.add_service(new_lm, name="LM")
            rc = new.start(f"127.0.0.1:{ep.port}", inherit_from=handoff)
            t.join(60)
            if rc != 0 or got.get("rc") != 0:
                raise AssertionError(f"(c) {where}: the handoff failed "
                                     f"(start {rc}, export {got})")
            if where == "native" and new._native_bridge is None:
                raise AssertionError("(c): the successor is not on the "
                                     "engine")
            t0 = time.perf_counter()
            drain_rc = old.drain(10_000)
            drain_ms = (time.perf_counter() - t0) * 1e3
            old.stop()
            wait_until(lambda: new_lm.answered >= 1, 600,
                       "a first answer from the successor")
            first_ms = (new_lm.first_wall - t_export) * 1e3
            base = new_lm.answered
            wait_until(lambda: new_lm.answered >= base + P20_SWAP_CALLS,
                       600, "calls on the successor alone")
        finally:
            stop.set()
            caller.join(600)
            old.stop()
            if new is not None:
                new.stop()
        n = FLASH_FWD.launches
        answered = old_lm.answered + (new_lm.answered if new_lm else 0)
        lost = p20_lost(out, old_lm, new_lm)
        log(f"  (c) {where}: {out['calls']} calls through the swap, "
            f"{out['failed']} failed, {out['refused']} refused connects, "
            f"{out['wrong']} wrong tokens, re-sent {out['lame_duck']} after "
            f"ELAMEDUCK/ELOGOFF and {out['closed']} after a closed "
            f"connection, {lost} lost (run, then sent again or not "
            f"answered); {first_ms:.1f} ms from the export to the "
            f"successor's first answer; answered: predecessor "
            f"{old_lm.answered}, successor {new_lm.answered}; drain rc "
            f"{drain_rc} in {drain_ms:.1f} ms; flash_fwd {n}; {card_line()}")
        if out["failed"] or out["refused"] or out["wrong"] or lost \
                or drain_rc or old_lm.answered < 1 or new_lm.answered < 1 \
                or n != cfg.depth * answered:
            raise AssertionError(f"(c) {where}: a call failed or the "
                                 f"swap is off: {out['errors'][:3]}")
        res[where] = dict(calls=out["calls"], failed=out["failed"],
                          refused=out["refused"],
                          resent_lame_duck=out["lame_duck"],
                          resent_closed=out["closed"], lost=lost,
                          first_answer_ms=first_ms,
                          predecessor=old_lm.answered,
                          successor=new_lm.answered, drain_ms=drain_ms)
        launches += n
    res["launches"] = launches
    return res


def spawn_successor(handoff: str, cfg: LMConfig) -> tuple:
    """(d)'s child, started on the handoff at ``handoff``: ``(process,
    port, wall time of its start)``, read on a thread bounded by
    P20_CHILD_START_S; a child that does not start fails the phase."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-c", P20_CHILD, root, handoff,
         json.dumps(vars(cfg)), P20_DEVICE],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    got = {}

    def read_start():
        for line in proc.stdout:
            if line.startswith("STARTED="):
                fields = dict(f.split("=") for f in line.split())
                got.update(rc=int(fields["STARTED"]),
                           port=int(fields["PORT"]),
                           wall=float(fields["WALL"]))
                return

    reader = threading.Thread(target=read_start, daemon=True)
    reader.start()
    reader.join(P20_CHILD_START_S)
    if got.get("rc") != 0:
        proc.kill()
        proc.wait(10)
        raise AssertionError(f"(d): the successor did not start ({got}, "
                             f"exit {proc.poll()})")
    return proc, got["port"], got["wall"]


def phase_p20_xproc(svc: LMService, cfg: LMConfig, rows: list,
                    ref: tuple) -> dict:
    """(d) Hot restart across processes: a child (a new binary) builds
    SLICE_CFG from seed 0 and starts with ``inherit_from=`` on the
    parent's listener while the parent keeps calling; the parent drains
    and stops; the child serves phase 5's tokens."""
    old, old_lm = p20_server(svc, "python")
    ep = old.listen_endpoint
    handoff = os.path.join(tempfile.mkdtemp(prefix="hr_"), "handoff")
    FLASH_FWD.launches = 0
    caller, stop, out = start_swap_caller(ep, ref)
    proc = None
    stats = {}
    try:
        wait_until(lambda: old_lm.answered >= 1, 600,
                   "a first answer from the predecessor")
        t, got = export_on_thread(old, handoff, P20_CHILD_START_S)
        t_export = time.time()
        proc, port, started_wall = spawn_successor(handoff, cfg)
        t.join(60)
        if got.get("rc") != 0 or port != ep.port:
            raise AssertionError(f"(d): the handoff failed (export {got}, "
                                 f"child port {port})")
        ctl = typed_channel(ep, "pooled")
        try:
            t0 = time.perf_counter()
            drain_rc = old.drain(10_000)
            drain_ms = (time.perf_counter() - t0) * 1e3
            old.stop()
            deadline_s = time.monotonic() + 600
            while True:
                stats = json.loads(ctl.call("Ctl.Stats", b"",
                                            timeout_ms=60_000))
                if stats["answered"] >= P20_SWAP_CALLS \
                        or time.monotonic() > deadline_s:
                    break
                time.sleep(0.05)
            stop.set()
            caller.join(600)
            full = generate(ctl, phase5_prompts(cfg)[0],
                            REQUESTS[0][2])[0].tolist()
            stats = json.loads(ctl.call("Ctl.Stats", b"",
                                        timeout_ms=60_000))
        finally:
            ctl.close()
    finally:
        stop.set()
        caller.join(600)
        old.stop()
        rc = stop_child(proc) if proc is not None else None
    n = FLASH_FWD.launches
    lost = p20_lost(out, old_lm)
    first_ms = (stats["first_wall"] - started_wall) * 1e3 \
        if stats.get("first_wall") else float("nan")
    log(f"  (d) a child process took the listener over: {out['calls']} "
        f"calls through the swap, {out['failed']} failed, "
        f"{out['refused']} refused connects, {out['wrong']} wrong tokens, "
        f"re-sent {out['lame_duck']} after ELAMEDUCK/ELOGOFF and "
        f"{out['closed']} after a closed connection, {lost} lost; the "
        f"child started "
        f"{(started_wall - t_export) * 1e3:.1f} ms after the export began "
        f"(building the LM) and answered first {first_ms:.1f} ms after its "
        f"start; answered: parent {old_lm.answered}, child "
        f"{stats.get('answered')}; phase 5's (1, 1024, 32) on the child "
        f"equal to phase 5's {full == rows[0]['tokens']}; drain rc "
        f"{drain_rc} in {drain_ms:.1f} ms; the child exited {rc}, imported "
        f"{stats.get('foreign') or 'nothing'} of JAX; flash_fwd here {n}, "
        f"in the child {stats.get('launches')}; {card_line()}")
    if out["failed"] or out["refused"] or out["wrong"] or lost \
            or drain_rc or rc \
            or stats.get("foreign") or full != rows[0]["tokens"] \
            or stats.get("answered", 0) < P20_SWAP_CALLS \
            or n != cfg.depth * old_lm.answered \
            or stats.get("launches") != cfg.depth * (stats["answered"]):
        raise AssertionError(f"(d): a call failed or the swap is off: "
                             f"{out['errors'][:3]}")
    return dict(calls=out["calls"], failed=out["failed"],
                refused=out["refused"], resent_lame_duck=out["lame_duck"],
                resent_closed=out["closed"], lost=lost,
                child_start_ms=(started_wall - t_export) * 1e3,
                child_first_answer_ms=first_ms,
                parent=old_lm.answered, child=stats["answered"],
                drain_ms=drain_ms, launches=n,
                child_launches=stats["launches"])


def phase_p20_portal(servers: dict, srv: Server, cfg: LMConfig,
                     ref: tuple) -> dict:
    """(e) The portal tools against the phase's servers:
    ``parallel_http`` reads ``/vars`` from every one, ``rpc_view``'s
    proxy serves ``/status`` with its links rewritten, ``trace_dump``
    gets a traced Generate's Chrome JSON (a client and a server span),
    and ``start_trackme`` pings ``/trackme`` until ``stop_trackme``."""
    eps = [str(s.listen_endpoint) for s, _ in servers.values()] \
        + [str(srv.listen_endpoint)]
    t0 = time.perf_counter()
    fetched = parallel_fetch(eps, "/vars", concurrency=8, timeout=30.0)
    vars_ms = (time.perf_counter() - t0) * 1e3
    vars_ok = sum(r.ok and b"rpc_server_" in r.body
                  for r in fetched.values())
    target = eps[0]
    proxy = ViewProxy(timeout=30.0)
    port = proxy.start()
    pages = {}
    try:
        for path in ("status", "vars?expand=drain_inflight_remaining"):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("GET", f"/{target}/{path}")
            resp = conn.getresponse()
            pages[path] = (resp.status, resp.read())
            conn.close()
    finally:
        proxy.stop()
    status_code, status_page = pages["status"]
    direct = json.loads(fetch_raw(target, "status", timeout=30.0)[2])
    trend_code, trend = pages["vars?expand=drain_inflight_remaining"]
    # /status is JSON (nothing to rewrite); the trend page's link back to
    # /vars is re-rooted under the proxy's /<target>/
    rewritten = status_code == 200 and trend_code == 200 \
        and json.loads(status_page).keys() == direct.keys() \
        and f"href='/{target}/vars'".encode() in trend \
        and b"href='/vars'" not in trend
    prompt, want = ref
    trace_id = 0x2020_0000 + os.getpid()
    ch = typed_channel(servers["python"][0].listen_endpoint, "single")
    try:
        cntl = Controller()
        cntl.trace_id = trace_id
        FLASH_FWD.launches = 0
        c = gen_call(ch, prompt, P20_REQUEST[2], 600_000, cntl=cntl)
        n = FLASH_FWD.launches
        traced_ok = not c.failed \
            and unpack_generated(c.response)[0].tolist() == want
    finally:
        ch.close()
    wait_until(lambda: len(global_span_store().by_trace(trace_id)) >= 2,
               30, "the traced Generate's spans")
    doc = json.loads(fetch_trace(target, trace_id, timeout=30.0))
    spans = [ev for ev in doc.get("traceEvents", ()) if ev.get("ph") == "X"]
    kinds = {str(ev.get("cat", "")) for ev in spans}
    pings = {"answered": 0}
    real_fetch = rpc_view.fetch

    def counted(*a, **kw):
        body = real_fetch(*a, **kw)
        pings["answered"] += 1
        return body

    rpc_view.fetch = counted
    try:
        if not start_trackme(target, interval_s=0.2):
            raise AssertionError("(e): start_trackme refused its server")
        wait_until(lambda: pings["answered"] >= 1, P20_TRACKME_S,
                   "a trackme ping answered")
        stop_trackme()
        stopped_at = pings["answered"]
        time.sleep(0.6)
        after_stop = pings["answered"] - stopped_at
    finally:
        stop_trackme()
        rpc_view.fetch = real_fetch
    log(f"  (e) parallel_http /vars from {len(eps)} servers: {vars_ok} "
        f"answered in {vars_ms:.1f} ms; rpc_view's proxy /status "
        f"{status_code}, a trend page's links rewritten {rewritten}; "
        f"trace_dump of a "
        f"traced Generate (its tokens right {traced_ok}, flash_fwd {n}): "
        f"{len(spans)} spans, kinds {sorted(kinds)}; trackme pings "
        f"answered {stopped_at}, {after_stop} after stop_trackme; "
        f"{card_line()}")
    if vars_ok != len(eps) or not rewritten or not traced_ok \
            or n != cfg.depth or not {"client", "server"} <= kinds \
            or stopped_at < 1 or after_stop:
        raise AssertionError("(e): a tool did not answer")
    return dict(vars_ok=vars_ok, vars_ms=vars_ms, spans=len(spans),
                trackme_pings=stopped_at, launches=n)


def phase_slice20(svc: LMService, srv: Server, ch: Channel, cfg: LMConfig,
                  rows: list) -> dict:
    """Phase 20 on phase 5's service: the press, traffic capture and
    replay, hot restart in one process and across processes, and the
    portal tools, on a default server and on the engine."""
    t0 = time.perf_counter()
    b, s, max_new = P20_REQUEST
    prompt = phase5_prompts(cfg)[2][:b]
    want = generate(ch, prompt, max_new)[0].tolist()
    log(f"  (1, 512, 16) on phase 5's server: {want[:6]}... (phase 5's "
        f"(2, 512, 16) row 0 equal: {want == rows[2]['ids'][0]})")
    ref = (prompt, want)
    servers = {where: p20_server(svc, where)
               for where in ("python", "native")}
    try:
        res = {"press": phase_p20_press(servers, cfg, ref),
               "capture": phase_p20_capture(svc, servers, cfg),
               "portal": phase_p20_portal(servers, srv, cfg, ref)}
    finally:
        for server, _ in servers.values():
            server.stop()
    res["swap"] = phase_p20_swap(svc, cfg, ref)
    res["xproc"] = phase_p20_xproc(svc, cfg, rows, ref)
    res["launches"] = sum(res[k]["launches"] for k in (
        "press", "capture", "portal", "swap", "xproc"))
    res["child_launches"] = res["xproc"]["child_launches"]
    res["seconds"] = time.perf_counter() - t0
    log(f"  phase 20: {res['seconds']:.1f} s; flash_fwd launches "
        f"{res['launches']} here and {res['child_launches']} in (d)'s "
        f"child ({card_line()})")
    return res


def phase_moe() -> dict:
    """Phase 6e: the MoE LM at MOE_CFG, full width and depth, through
    Generate, Decode (contiguous, paged with chunked prefill) and the
    disaggregated handoff; each service and the weights freed after."""
    cfg = LMConfig(**MOE_CFG)
    t0 = time.perf_counter()
    svc = LMService(cfg=cfg, device="cuda", seed=0,
                    decode_slots=DECODE_SLOTS)
    paged = LMService(cfg=cfg, params=svc.params, device="cuda",
                      decode_slots=DECODE_SLOTS, paged=True, page=PAGE,
                      prefill_chunk_tokens=CHUNK_TOKENS)
    dec = LMService(cfg=cfg, params=svc.params, device="cuda",
                    decode_slots=DECODE_SLOTS)
    dec_ch = Channel()
    pre = PrefillService(cfg=cfg, params=svc.params, device="cuda",
                         decode_slots=1, decode_channel=dec_ch,
                         transport=KvTransport(), fallback_local=False)
    log(f"  params: {svc._param_bytes / 1e9:.3f} GB "
        f"({sum(x.numel() for x in tree_leaves(svc.params)) / 1e9:.3f} B), "
        f"built in {time.perf_counter() - t0:.1f} s")
    srv, dec_srv, pre_srv, ch = Server(), Server(), Server(), Channel()
    res = {}
    try:
        if srv.add_service(svc, name="LM") != 0 or srv.add_service(
                paged, name="LMPaged") != 0 \
                or dec_srv.add_service(dec, name="LM") != 0 \
                or dec_srv.add_service(DecodeTierService(dec),
                                       name="KV") != 0 \
                or pre_srv.add_service(pre, name="Prefill") != 0 \
                or any(x.start("127.0.0.1:0") != 0
                       for x in (srv, dec_srv, pre_srv)):
            raise RuntimeError("the MoE services did not start")
        ch.init(str(srv.listen_endpoint))
        dec_ch.init(str(dec_srv.listen_endpoint))
        FLASH_FWD.launches = 0
        res["generate"] = phase_moe_generate(ch, cfg)
        res["launches_generate"] = FLASH_FWD.launches
        want = cfg.depth * len(MOE_REQUESTS)
        log(f"  flash_fwd launches over the Generate requests: "
            f"{res['launches_generate']} (expected {want})")
        if res["launches_generate"] != want:
            raise AssertionError("the MoE Generate path did not run the "
                                 "kernel once per layer per request")
        phase_profile(ch, cfg)
        res["logits"] = phase_moe_logits(svc.params, cfg)
        res["group"] = phase_moe_group(svc.params["blk0"]["moe"], cfg)
        res["decode"] = phase_moe_decode(srv.listen_endpoint, svc, cfg)
        res["round_profile"] = phase_decode_profile(svc, cfg)
        res["paged"] = phase_moe_paged(srv.listen_endpoint, paged, cfg)
        res["disagg"] = phase_moe_disagg(pre_srv.listen_endpoint, dec, cfg,
                                         res["decode"])
        log(f"  flash_fwd launches by MoE path: generate "
            f"{res['launches_generate']}, decode "
            f"{res['decode']['launches']}, paged "
            f"{res['paged']['launches']}, disagg "
            f"{res['disagg']['launches']}")
    finally:
        ch.close()
        dec_ch.close()
        for x in (srv, dec_srv, pre_srv):
            x.stop()
        for service in (svc, paged, dec, pre):
            if service._batcher is not None:
                service._batcher.shutdown()
    return res


def phase_moe_generate(ch: Channel, cfg: LMConfig) -> list:
    info = json.loads(ch.call("LM.Info", b"", timeout_ms=60_000))
    log(f"  LM.Info: {info}")
    if info["dim"] != cfg.dim or info["depth"] != cfg.depth:
        raise AssertionError(f"Info disagrees with the config: {info}")
    rng = np.random.default_rng(0)
    rows = []
    for i, (b, s, max_new) in enumerate(MOE_REQUESTS):
        prompt = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
        t0 = time.perf_counter()
        out = generate(ch, prompt, max_new)
        dt = time.perf_counter() - t0
        if out.shape != (b, max_new) or out.min() < 0 \
                or out.max() >= cfg.vocab:
            raise AssertionError(f"bad MoE Generate answer {out.shape}")
        rows.append(dict(b=b, s=s, max_new=max_new, ms=dt * 1e3,
                         tok_s=b * max_new / dt, warmup=i == 0))
        log(f"  Generate b={b} s={s} max_new={max_new}: {dt * 1e3:.1f} ms "
            f"end to end, {b * max_new / dt:.1f} generated tok/s"
            f"{' [warm-up]' if i == 0 else ''}; first ids "
            f"{out[0, :6].tolist()}")
    return rows


def phase_moe_logits(params: dict, cfg: LMConfig) -> dict:
    """Prefill logits through the kernel vs through dense attention, and
    the share of (token, layer) top-2 sets the two runs route alike;
    every flip printed with its router margin."""
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, 1024))).cuda()
    dense_cfg = LMConfig(**{**MOE_CFG, "use_flash": False,
                            "attn_impl": "dense"})
    with torch.inference_mode():
        with RouteLog() as fl:
            _, flash_logits = make_decode(cfg, "cuda")[0](params, ids)
        with RouteLog() as dn:
            _, dense_logits = make_decode(dense_cfg, "cuda")[0](params, ids)
    k, n = cfg.moe_top_k, ids.shape[1]
    same = flips = 0
    for layer, ((ef, pf), (ed, _)) in enumerate(zip(fl.calls, dn.calls)):
        sf = ef.reshape(k, n).T.sort(dim=-1).values
        sd = ed.reshape(k, n).T.sort(dim=-1).values
        agree = (sf == sd).all(dim=-1)
        same += int(agree.sum())
        margin = router_margin(pf[0], k)
        for t in torch.nonzero(~agree).flatten().tolist():
            flips += 1
            log(f"  routing flip: layer {layer} token {t}: "
                f"{sf[t].tolist()} through the kernel, {sd[t].tolist()} "
                f"through dense attention, router margin "
                f"{float(margin[t]):.3e}")
    share = same / (len(fl.calls) * n)
    err = max_err(flash_logits, dense_logits)
    top = float(dense_logits.abs().max())
    ok = err <= LOGIT_RTOL * top and len(fl.calls) == cfg.depth
    log(f"  prefill logits, kernel vs dense attention: max abs err "
        f"{err:.3e}, max |logit| {top:.3f}, ratio {err / top:.3e} "
        f"(tolerance {LOGIT_RTOL}: {'ok' if ok else 'FAIL'}); top-2 sets "
        f"equal for {same} of {len(fl.calls) * n} (token, layer) pairs "
        f"({share:.6f}), {flips} flips")
    if not ok or not torch.isfinite(flash_logits).all():
        raise AssertionError("MoE prefill logits through the kernel "
                             "disagree")
    return dict(max_abs_err=err, ratio=err / top, route_share=share,
                flips=flips)


def phase_moe_group(lp: dict, cfg: LMConfig) -> dict:
    """``forward_grouped`` on the card against the same function on the
    CPU, one layer's weights: equal routing, close output; and its time
    on the card."""
    mcfg = cfg.moe_cfg()
    cpu = {k: v.cpu() for k, v in lp.items()}
    with torch.inference_mode():
        for seed in range(20):
            x = torch.randn(MOE_GROUP_SHAPE,
                            generator=torch.Generator().manual_seed(seed))
            margin = float(router_margin(moe.route(cpu, x, mcfg)[0],
                                         mcfg.top_k).min())
            if margin >= MOE_ROUTE_MARGIN:
                break
        else:
            raise AssertionError("no input clears the router margin")
        t0 = time.perf_counter()
        want, want_aux = moe.forward_grouped(cpu, x, mcfg)
        cpu_s = time.perf_counter() - t0
        _, _, we, _, wk = moe.route(cpu, x, mcfg)
        xc = x.cuda()
        got, aux = moe.forward_grouped(lp, xc, mcfg)
        _, _, ge, _, gk = moe.route(lp, xc, mcfg)
        ms = time_ms(lambda: moe.forward_grouped(lp, xc, mcfg), reps=5)
    same = bool(torch.equal(ge.cpu(), we) and torch.equal(gk.cpu(), wk))
    err = max_err(got.cpu(), want)
    top = float(want.abs().max())
    aux_rel = abs(float(aux) - float(want_aux)) / float(want_aux)
    ok = same and err <= MOE_OUT_TOL * top and aux_rel <= 1e-5
    log(f"  forward_grouped {MOE_GROUP_SHAPE}, layer 0's experts, card vs "
        f"CPU (input seed {seed}, router margin {margin:.3e}): routing "
        f"equal {same} ({int((~wk).sum())} of {wk.numel()} slots dropped), "
        f"out max abs err {err:.3e} of max |out| {top:.3f} (tolerance "
        f"{MOE_OUT_TOL} of it), aux rel err {aux_rel:.3e}: "
        f"{'ok' if ok else 'FAIL'}; {ms:.3f} ms on the card, "
        f"{cpu_s * 1e3:.0f} ms on the CPU")
    if not ok:
        raise AssertionError("forward_grouped on the card disagrees with "
                             "the CPU")
    return dict(route_equal=same, max_abs_err=err, ratio=err / top,
                aux_rel=aux_rel, ms=ms, margin=margin, seed=seed)


def phase_moe_decode(ep, svc: LMService, cfg: LMConfig) -> dict:
    """(3) 6b's eight prompts through 8 contiguous slots."""
    prompts = decode_prompts(cfg, 5, DECODE_SLOTS)
    batcher = svc.batcher()
    snap = phase_snapshot()
    clients, wall_s, most_live, launches = run_counted(
        ep, "LM", prompts, DECODE_STAGGER_S, batcher)
    rounds, _, round_ms = phase_deltas(snap)["decode_round"]
    tokens = sum(len(c.tokens) for c in clients)
    ttfts = sorted(c.ttft_s * 1e3 for c in clients)
    joins = batcher.prefills_run
    log(f"  (3) {len(clients)} sessions, prompts "
        f"{sorted(len(p) for p in prompts)}: all closed 'finished', up to "
        f"{most_live} live; {tokens} tokens in {wall_s:.3f} s = "
        f"{tokens / wall_s:.1f} tok/s aggregate; {rounds} rounds, "
        f"{round_ms:.3f} ms each; TTFT median "
        f"{statistics.median(ttfts):.1f} ms, max {ttfts[-1]:.1f} ms; "
        f"flash_fwd launches {launches} (depth {cfg.depth} x {joins} joins)")
    if launches != cfg.depth * joins or joins != len(clients) \
            or any(not 0 <= t < cfg.vocab for c in clients for t in c.tokens):
        raise AssertionError("the MoE Decode path did not run as expected")
    batcher.shutdown()
    return dict(sessions=len(clients), tokens=tokens, wall_s=wall_s,
                aggregate_tok_s=tokens / wall_s, rounds=rounds,
                round_ms=round_ms, ttft_ms=ttfts,
                ttft_median_ms=statistics.median(ttfts), launches=launches,
                session_tokens=[c.tokens for c in clients])


def phase_moe_paged(ep, paged: LMService, cfg: LMConfig) -> dict:
    """(4) four of (3)'s prompts through a paged service with 256-token
    prefill chunks: every context filled by chunk slices, each routed as
    one (1, 256) row with its padding."""
    prompts = decode_prompts(cfg, 5, DECODE_SLOTS)[:MOE_PAGED_SESSIONS]
    slices0 = sched_counters()["sched_chunk_slice"]
    snap = phase_snapshot()
    clients, wall_s, most_live, launches = run_counted(
        ep, "LMPaged", prompts, DECODE_STAGGER_S, paged.batcher())
    rounds, _, round_ms = phase_deltas(snap)["decode_round"]
    slices = sched_counters()["sched_chunk_slice"] - slices0
    least = sum(-(-(len(p) - 1) // CHUNK_TOKENS) for p in prompts)
    tokens = sum(len(c.tokens) for c in clients)
    log(f"  (4) {len(clients)} paged sessions, {CHUNK_TOKENS}-token "
        f"chunks: all closed 'finished' in {wall_s:.3f} s, "
        f"{tokens / wall_s:.1f} tok/s, {rounds} rounds of {round_ms:.3f} "
        f"ms; {slices} chunk "
        f"slices (at least {least}), flash_fwd launches {launches} "
        f"(expected 0)")
    if launches or slices < least:
        raise AssertionError("the paged MoE sessions did not run as sliced")
    paged.batcher().shutdown()
    return dict(sessions=len(clients), wall_s=wall_s,
                aggregate_tok_s=tokens / wall_s, rounds=rounds,
                round_ms=round_ms, chunk_slices=slices, launches=launches)


def phase_moe_disagg(pre_ep, dec: LMService, cfg: LMConfig,
                     mono: dict) -> dict:
    """(5) two of (3)'s prompts prefilled on a prefill tier and handed off
    over the ici lane: their tokens equal (3)'s exactly."""
    prompts = decode_prompts(cfg, 5, DECODE_SLOTS)[:MOE_DISAGG_SESSIONS]
    kv0, fb0 = kv_stats(), kv_fallback_counters()
    clients, wall_s, _, launches = run_counted(
        pre_ep, "Prefill", prompts, DECODE_STAGGER_S, dec.batcher())
    kv, fb = kv_deltas(kv0, fb0)
    same = sum(c.tokens == t for c, t in zip(clients,
                                             mono["session_tokens"]))
    log(f"  (5) {len(clients)} sessions over the ici lane: handoffs {kv}, "
        f"fallbacks {fb or 'none'}; {same} of {len(clients)} streamed (3)'s "
        f"tokens exactly; flash_fwd launches {launches} on the prefill "
        f"tier, decode tier prefills {dec.batcher().prefills_run}")
    if kv["ici_sessions"] != len(prompts) or fb or same != len(clients) \
            or dec.batcher().prefills_run \
            or launches != cfg.depth * len(prompts):
        raise AssertionError("the MoE handoffs did not stream (3)'s tokens")
    dec.batcher().shutdown()
    return dict(sessions=len(clients), wall_s=wall_s, handoffs=kv,
                same_as_monolithic=same, launches=launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    device_name = torch.cuda.get_device_name(0)
    peaks = peaks_for(device_name)
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    paths = cuda_build.build_all()
    log(f"[2] built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for src, text in cuda_build.build_logs.items():
        for kernel, regs, st, ld in ptxas_report(text):
            log(f"  {src} {kernel}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B")

    log("[3] kernel vs plain")
    main_err = phase_check()
    log("[3b] backward kernels vs plain")
    bwd_err = phase_check_bwd()
    bwd_long = phase_check_bwd_long()
    torch.cuda.empty_cache()
    log("[3w] the three flash kernels vs plain at head dims past 128 "
        "(zero-padded to 256)")
    wide_err = phase_check_wide()
    log("[3c] checksum kernel vs plain")
    n_payloads, cs_err = phase_check_checksum()
    log("[4] timing")
    times = phase_time(peaks)
    log("[4b] backward timing")
    bwd_times = phase_time_bwd(peaks)
    log("[4c] checksum timing")
    cs_times = phase_time_checksum(peaks)
    log(f"[4w] timing at head dim 256: the forward at {WIDE_FWD_SHAPE}, the "
        f"backward at {WIDE_TRAIN_SHAPE}")
    wide_times = phase_time(peaks, (WIDE_FWD_SHAPE,))[WIDE_FWD_SHAPE]
    wide_bwd_times = phase_time_bwd(peaks, WIDE_TRAIN_SHAPE)
    torch.cuda.empty_cache()
    log(f"[5w] the head-dim-256 LM at {WIDE_CFG}, trained at "
        f"{WIDE_TRAIN_CFG}")
    wide_lm = phase_wide_lm()

    cfg = LMConfig(**SLICE_CFG)
    log(f"[5] serving LM at {SLICE_CFG}")
    t0 = time.perf_counter()
    svc = LMService(cfg=cfg, device="cuda", seed=0,
                    decode_slots=DECODE_SLOTS)
    # the same weights behind a second name, with chunked prefill (6b)
    chunked = LMService(cfg=cfg, params=svc.params, device="cuda",
                        decode_slots=2, prefill_chunk_tokens=CHUNK_TOKENS)
    # and behind the paged batchers of 6c, each built at its first Decode
    paged = {
        "LMPaged": LMService(cfg=cfg, params=svc.params, device="cuda",
                             decode_slots=PAGED_SLOTS, paged=True, page=PAGE,
                             kv_pages=PAGED_POOL, kv_host_slots=HOST_SLOTS),
        "LMPrefix": LMService(cfg=cfg, params=svc.params, device="cuda",
                              decode_slots=DECODE_SLOTS, paged=True,
                              page=PAGE),
        "LMSpill": LMService(cfg=cfg, params=svc.params, device="cuda",
                             decode_slots=SPILL_SLOTS, paged=True, page=PAGE,
                             kv_pages=SPILL_POOL, kv_host_slots=HOST_SLOTS),
        "LMSpec": LMService(cfg=cfg, params=svc.params, device="cuda",
                            decode_slots=SPEC_SLOTS, paged=True, page=PAGE,
                            spec_decode_k=SPEC_K, draft_params=svc.params),
        "LMSpecPlain": LMService(cfg=cfg, params=svc.params, device="cuda",
                                 decode_slots=SPEC_SLOTS, paged=True,
                                 page=PAGE)}
    # and the tiers of 6d: two decode tiers (contiguous, and 6c (a)'s
    # paged one), each on a Server of its own, and the prefill tiers
    # pointed at them (one local slot each, for a fallback)
    tiers = {
        "dec": LMService(cfg=cfg, params=svc.params, device="cuda",
                         decode_slots=DECODE_SLOTS),
        "dec_paged": LMService(cfg=cfg, params=svc.params, device="cuda",
                               decode_slots=PAGED_SLOTS, paged=True,
                               page=PAGE, kv_pages=PAGED_POOL,
                               kv_host_slots=HOST_SLOTS)}
    dec_srv = {name: Server() for name in ("dec", "dec_paged")}
    dec_ch = {name: Channel() for name in dec_srv}
    for tier, (lane, strict, dec) in DISAGG_PREFILL.items():
        tiers[tier] = PrefillService(
            cfg=cfg, params=svc.params, device="cuda", decode_slots=1,
            decode_channel=dec_ch[dec], transport=KvTransport(
                force_lane=lane), fallback_local=not strict)
    pre_srv = Server()
    log(f"  params: {svc._param_bytes / 1e9:.3f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    srv = Server()
    ch = Channel()
    try:
        if srv.add_service(svc, name="LM") != 0 or srv.add_service(
                chunked, name="LMChunked") != 0 or any(
                srv.add_service(service, name=name) != 0
                for name, service in paged.items()) or srv.start(
                "127.0.0.1:0") != 0:
            raise RuntimeError("server did not start")
        ch.init(str(srv.listen_endpoint))
        FLASH_FWD.launches = 0
        rows = phase_serve(ch, cfg)
        launches = FLASH_FWD.launches
        want = cfg.depth * len(REQUESTS)
        log(f"  flash_fwd launches on the main path: {launches} "
            f"(expected {want})")
        if launches != want:
            raise AssertionError("the main path did not run the kernel "
                                 "once per layer per request")
        log("[6] kernel on the path")
        phase_profile(ch, cfg)
        phase_logits(svc, cfg)
        decode = phase_decode_rate(svc, cfg)
        log(f"[6b] LM.Decode through the continuous batcher, "
            f"{DECODE_SLOTS} slots")
        streams = phase_decode(srv.listen_endpoint, svc, chunked, cfg,
                               decode["decode_tok_s"])
        log(f"[6c] LM.Decode through the paged batcher, {PAGE}-token pages")
        paged_res = phase_paged(srv.listen_endpoint, svc, paged, cfg)
        log("[6d] LM.Decode disaggregated: prefill tiers hand each session's "
            "KV pages to a decode tier")
        for tier, server in dec_srv.items():
            if server.add_service(tiers[tier], name="LM") != 0 \
                    or server.add_service(DecodeTierService(tiers[tier]),
                                          name="KV") != 0 \
                    or server.start("127.0.0.1:0") != 0:
                raise RuntimeError("a decode tier did not start")
            dec_ch[tier].init(str(server.listen_endpoint))
        if any(pre_srv.add_service(tiers[tier], name=tier) != 0
               for tier in DISAGG_PREFILL) \
                or pre_srv.start("127.0.0.1:0") != 0:
            raise RuntimeError("the prefill tiers did not start")
        disagg = phase_disagg(pre_srv.listen_endpoint, svc, tiers, cfg,
                              streams)
        log(f"[5s] scan_layers Generate at {SCAN_CFG}, int8")
        scan = phase_scan(svc, cfg)
        log("[12] observability: rpcz spans, MethodStatus, bvar, "
            "lm_telemetry")
        obs = phase_observability(srv.listen_endpoint,
                                  pre_srv.listen_endpoint, ch, srv, svc,
                                  paged, tiers, cfg, streams,
                                  stitch=phase_portal_stitch)
        log("[13] overload and drain: the shed, goodput under overload, "
            "admission, the drain, retries and backups")
        rob = phase_robustness(ch, srv, svc, paged, cfg, rows)
        log("[14] the LM across replicas: naming, balancers, a hedge "
            "across replicas, fan-out, the breaker, fleet, a drain with "
            "failover")
        cluster = phase_cluster(svc, cfg, rows,
                                dec_srv["dec"].listen_endpoint,
                                portal=phase_portal_fleet)
        log("[15] HTTP/1.1, h2/gRPC and the builtin portal on phase 5's "
            "port")
        proto = phase_protocols(srv.listen_endpoint, cfg, rows,
                                obs["stitch"], cluster["portal"])
        log("[16] the classic lane's stages (compression, auth, the "
            "interceptor, session data), TLS, async calls and the device "
            "block pool")
        slice16 = phase_slice16(svc, srv, ch, cfg, rows)
        log("[17] the native C++ IO engine: Generate on the kind-3 lane, "
            "Decode on the kind-5 lane, the method cap's refusals, two "
            "replicas, device echoes and a drain")
        slice17 = phase_slice17(svc, ch, cfg, rows, streams, paged)
        log("[18] the client on the native engine: the fast lane "
            "(pooled, short, call_batch, call_raw), the scatter fan-out, "
            "the client lane under Decode streams, device echoes, a drain "
            "and a revival")
        slice18 = phase_slice18(svc, srv, ch, cfg, rows, streams, cluster)
        log("[19] the Python transport on the event dispatcher: Generate "
            "and Decode on a default Server, four Generates on one "
            "connection, device echoes, TLS, RESP and thrift on the LM's "
            "port, a drain with a connection in the backlog")
        slice19 = phase_slice19(svc, srv, cfg, rows, streams, slice17, paged)
        log("[20] operability and tools: rpc_press, rpc_dump capture and "
            "rpc_replay, hot restart in one process and across processes, "
            "and the portal tools (parallel_http, rpc_view, trace_dump, "
            "trackme)")
        slice20 = phase_slice20(svc, srv, ch, cfg, rows)
    finally:
        ch.close()
        srv.stop()
        pre_srv.stop()
        for tier, server in dec_srv.items():
            server.stop()
            dec_ch[tier].close()
        for service in (svc, chunked, *paged.values(), *tiers.values()):
            if service._batcher is not None:
                service._batcher.shutdown()
    torch.cuda.empty_cache()
    log(f"  allocated on the card after the serving phases: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    # cuBLAS keeps a workspace on the card for every handle, that is for
    # every thread that has run a GEMM at the same time as others: 6d's
    # prefill tiers run one thread per connection.  Dropped here, so
    # phase 8 measures training alone
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
        log(f"  allocated after dropping the cuBLAS workspaces: "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")

    del svc, chunked, paged, tiers
    torch.cuda.empty_cache()
    log(f"[6e] MoE LM at {MOE_CFG}")
    moe_res = phase_moe()
    torch.cuda.empty_cache()
    if clear is not None:
        clear()
    log(f"  allocated on the card after 6e: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")

    log(f"[8] training LM at {TRAIN_CFG}, accum={TRAIN_ACCUM} x microbatch "
        f"{TRAIN_MICRO} x {TRAIN_SEQ} tokens (reduced from bench.py's 8 x "
        f"32 x 2048)")
    train = phase_train(peaks)
    log("[9] checkpoint round trip")
    ckpt_s = phase_checkpoint(train.pop("params"))
    torch.cuda.empty_cache()
    log(f"[8m] training the MoE LM at {MOE_TRAIN_CFG}, accum="
        f"{MOE_TRAIN_ACCUM} x microbatch {MOE_TRAIN_MICRO} x {TRAIN_SEQ} "
        f"tokens (reduced from bench.py's 8 x 32 x 2048)")
    moe_train = phase_train(peaks, MOE_TRAIN_CFG, MOE_TRAIN_ACCUM,
                            MOE_TRAIN_MICRO, MOE_TRAIN_STEPS)
    del moe_train["params"]
    torch.cuda.empty_cache()
    log("[11] the parallel paths at world size one (NCCL)")
    par = phase_parallel(train, moe_train)
    torch.cuda.empty_cache()
    log(f"[10] parameter server at {PS_CFG} and the device lane")
    ps = phase_ps()
    xproc = phase_xproc(ps)

    f32 = times[MAIN_SHAPE]["f32"]
    f32_train = times[TRAIN_SHAPE]["f32"]
    fwd_paths = {"generate": launches,
                 "decode": streams["launches"],
                 "paged_decode": paged_res["launches_paged"],
                 "spec_decode": paged_res["launches_spec"],
                 "disagg": disagg["launches"],
                 "disagg_shm": disagg["shm"]["launches"],
                 "scan_generate": scan["launches"],
                 "observability": obs["launches"],
                 "robustness": rob["launches"],
                 "cluster": cluster["launches"],
                 "http_grpc": proto["launches"],
                 "stages_tls_async": slice16["launches"],
                 "native_engine": slice17["launches"],
                 "native_client": slice18["launches"],
                 "dispatcher": slice19["launches"],
                 "tools_restart": slice20["launches"],
                 "restart_child": slice20["child_launches"],
                 "moe_generate": moe_res["launches_generate"],
                 "moe_decode": moe_res["decode"]["launches"],
                 "moe_paged_decode": moe_res["paged"]["launches"],
                 "moe_disagg": moe_res["disagg"]["launches"],
                 "train": train["launches"][FLASH_FWD.name],
                 "moe_train": moe_train["launches"][FLASH_FWD.name],
                 "parallel_train": par["dp_tp"]["launches"][FLASH_FWD.name],
                 "ulysses": par["ulysses"]["launches"],
                 "moe_parallel_train":
                     par["moe_dp_tp"]["launches"][FLASH_FWD.name],
                 "wide_generate": wide_lm["launches_generate"],
                 "wide_train": (wide_lm["launches_vg"][FLASH_FWD.name]
                                + wide_lm["launches_train"][FLASH_FWD.name])}
    kernels = [{
        "name": FLASH_FWD.name, "route": "cuda",
        "source": "brpc_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "brpc_tpu/ops/flash_attention.py:46",
        "launches": sum(fwd_paths.values()),
        "launches_by_path": fwd_paths,
        "max_abs_err": main_err,
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "ratio_to_library": f32["ratio_to_library"],
        "bound_tc_ms": f32["bound_tc_ms"],
        "at_train_shape": {key: f32_train[key] for key in (
            "ms", "plain_ms", "library_ms", "ratio_to_library", "bound_ms",
            "bound_tc_ms")},
        "at_head_dim_256": wide_times,
        "max_abs_err_wide": {k: v[FLASH_FWD.name]
                             for k, v in wide_err.items()}}]
    for kern, line in ((FLASH_DQ, 313), (FLASH_DKDV, 361)):
        row = bwd_times["f32"][kern.name]
        kernels.append({
            "name": kern.name, "route": "cuda",
            "source": "brpc_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"brpc_tpu/ops/flash_attention.py:{line}",
            "launches": (train["launches"][kern.name]
                         + moe_train["launches"][kern.name]
                         + par["dp_tp"]["launches"][kern.name]
                         + par["moe_dp_tp"]["launches"][kern.name]
                         + wide_lm["launches_vg"][kern.name]
                         + wide_lm["launches_train"][kern.name]),
            "launches_by_path": {
                "train": train["launches"][kern.name],
                "moe_train": moe_train["launches"][kern.name],
                "parallel_train": par["dp_tp"]["launches"][kern.name],
                "moe_parallel_train":
                    par["moe_dp_tp"]["launches"][kern.name],
                "wide_train": (wide_lm["launches_vg"][kern.name]
                               + wide_lm["launches_train"][kern.name])},
            "max_abs_err": bwd_err[kern.name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_share_ms": row["library_share_ms"],
            "ratio_to_library": row["ratio_to_library"],
            "bound_tc_ms": row["bound_tc_ms"],
            "at_head_dim_256": {key: wide_bwd_times[key][kern.name]
                                for key in wide_bwd_times},
            "max_abs_err_wide": {k: v[kern.name]
                                 for k, v in wide_err.items()}})
    cs_row = cs_times[CHECKSUM_BYTES]
    kernels.append({
        "name": CHECKSUM.name, "route": "cuda",
        "source": "brpc_tpu_torch/ops/csrc/checksum.cu",
        "replaces": "brpc_tpu/ops/device_ops.py:50",
        "launches": (ps["launches"] + xproc["xfer"]["launches"]
                     + xproc["xfer"]["launches_inline"]
                     + xproc["xfer"]["child_launches"]
                     + par["two_processes"]["checksum_launches"]
                     + slice16["pool"]["checksum_launches"]
                     + slice17["echo"]["checksum_launches"]
                     + slice18["echo"]["checksum_launches"]
                     + slice19["echo"]["checksum_launches"]),
        "launches_by_path": {
            "ps": ps["launches"], "xproc": xproc["xfer"]["launches"],
            "xproc_inline": xproc["xfer"]["launches_inline"],
            "xproc_child": xproc["xfer"]["child_launches"],
            "dryrun_echo": par["two_processes"]["checksum_launches"],
            "block_pool": slice16["pool"]["checksum_launches"],
            "native_echo": slice17["echo"]["checksum_launches"],
            "fast_lane_echo": slice18["echo"]["checksum_launches"],
            "dispatcher_echo": slice19["echo"]["checksum_launches"]},
        "max_abs_err": cs_err,
        "ms": cs_row["ms"], "plain_ms": cs_row["plain_ms"],
        "bound_ms": cs_row["bound_ms"], "bound_by": cs_row["bound_by"],
        "library_ms": cs_row["library_ms"],
        "ratio_to_library": cs_row["ms"] / cs_row["library_ms"]})
    log("[7] forward causal: " + json.dumps(
        {str(shape): row for shape, row in times.items()}))
    log(f"  backward at {TRAIN_SHAPE} causal: {json.dumps(bwd_times)}; "
        f"past the training length: {json.dumps(bwd_long)}")
    log(f"  head dim 256: forward {json.dumps(wide_times)}; backward at "
        f"{WIDE_TRAIN_SHAPE} {json.dumps(wide_bwd_times)}; errors "
        f"{json.dumps(wide_err)}; the LM {json.dumps(wide_lm)}")
    log(f"  requests: {json.dumps(rows)}")
    log(f"  decode: {json.dumps(decode)}")
    log(f"  streams: {json.dumps(streams)}")
    log(f"  paged: {json.dumps(paged_res)}")
    log(f"  disagg: {json.dumps(disagg)}")
    log(f"  scan: {json.dumps(scan)}")
    log(f"  observability: {json.dumps(obs)}")
    log(f"  robustness: {json.dumps(rob)}")
    log(f"  cluster: {json.dumps(cluster, default=str)}")
    log(f"  protocols: {json.dumps(proto)}")
    log(f"  slice16: {json.dumps(slice16)}")
    log(f"  slice17: {json.dumps(slice17)}")
    log(f"  slice18: {json.dumps(slice18, default=str)}; phase 10's "
        f"Controller-path echo {ps['echo_rps']:.1f} calls/s")
    log(f"  slice19: {json.dumps(slice19, default=str)}")
    log(f"  slice20: {json.dumps(slice20, default=str)}")
    log(f"  moe: {json.dumps(moe_res)}")
    log(f"  train: {json.dumps(train)}; checkpoint {ckpt_s:.2f} s")
    log(f"  moe_train: {json.dumps(moe_train)}")
    log(f"  checksum: {n_payloads} payloads bit-exact; timing "
        f"{json.dumps(cs_times)}")
    log(f"  ps: {json.dumps(ps)}")
    log(f"  xproc: {json.dumps(xproc)}")
    log(f"  parallel: {json.dumps(par)}")
    log("  crossover: " + " ".join(
        f"s={r['s']} dense {r['dense_ms']:.4f} flash {r['flash_ms']:.4f} ms;"
        for r in par["crossover"]["rows"])
        + f" flash faster from s={par['crossover']['crossover']} "
        f"(DENSE_FLASH_CROSSOVER = {DENSE_FLASH_CROSSOVER}; {card})")
    log(f"  all phases: {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


def exit_on_sigterm(signum, frame) -> None:
    """A run ended by SIGTERM (a time limit) unwinds like an error: the
    child is stopped and the shm rings (6d (e)'s is 2 GiB of tmpfs) are
    unlinked by their ``finally`` and ``atexit`` hooks."""
    raise SystemExit(128 + signum)


if __name__ == "__main__":
    signal.signal(signal.SIGTERM, exit_on_sigterm)
    sys.exit(main())
