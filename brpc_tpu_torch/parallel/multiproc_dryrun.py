"""Dry runs across processes: a sharded train step, a psum barrier and a
device-tensor echo between two processes; and every parallel path of the
port on tiny shapes.

Counterpart of ``brpc_tpu/parallel/multiproc_dryrun.py``.  :func:`run`
spawns ``processes`` workers (one rank each) that join one gloo process
group through a rendezvous file, run one dp x tp EmbeddingPS train step
(vocab rows and the tower cut over tp across the processes), meet at a
psum barrier, and then process 1 echoes a tensor off process 0's
``PS.EchoTensor`` as a device attachment, checksummed before the send,
where it lands and where it comes back.  With ``echo_device="cuda"`` the
tensor lies on the card and rides ``KIND_TRANSFER`` (CUDA IPC between the
processes, ``ici_transfer_enabled`` on in both); on the CPU it goes
inline.  The collectives of the train step stay on gloo and the CPU.

Run as a module (one worker per process):

    python -m brpc_tpu_torch.parallel.multiproc_dryrun <pid> <nproc> \\
        <init_file> <rpc_port> <echo_device>

:func:`dryrun_multichip` is the counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``: at world n it runs that function's sequence on
tiny shapes, one rank per process (:mod:`.spmd`): the PS step, the
collectives, the MoE LM dp x tp (+ep) step and the same with accum=2,
ring attention, the pipeline, pipeline training and dp x pp.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..utils.device import resolve_device

DONE = "2-proc step ok"
# the first echo carries the domain exchange (its request goes inline);
# the last one is held to the lane: each echo checksums three times
ECHOES = 2


def _checked_ps(base):
    """PSService whose echo reports the request's attachment kind and the
    checksum of what landed."""
    from ..butil.status import Errno
    from ..ops.device_ops import checksum_u32

    class CheckedPS(base):
        def EchoTensor(self, cntl, request):
            att = cntl.request_device_attachment
            if att is None:
                cntl.set_failed(Errno.EREQUEST, "no device attachment")
                return None
            t = att.tensor(self.model.device)
            cntl.response_device_attachment = t
            return json.dumps({"kind": att.kind,
                               "sum": checksum_u32(t)}).encode()

    return CheckedPS


def _worker(pid: int, nproc: int, init_file: str, rpc_port: int,
            echo_device: str) -> None:
    from ..butil.flags import set_flag
    from ..models.embedding_ps import EmbeddingPS, PSConfig
    from .mesh_transport import MeshTransport, make_mesh
    from .spmd import init_world

    init_world(pid, nproc, "cpu", init_file)
    tp = 2 if nproc % 2 == 0 else 1
    mesh = make_mesh((nproc // tp, tp), ("dp", "tp"), "cpu")
    cfg = PSConfig(vocab=64 * tp, dim=32, slots=4, hidden=16 * tp,
                   classes=8, lr=0.1)
    # the same seed on every process: identical whole params, each process
    # keeps its shard
    model = EmbeddingPS(cfg, device="cpu", seed=0, mesh=mesh)
    rng = np.random.default_rng(1)
    batch = 4 * nproc
    ids_h = rng.integers(0, cfg.vocab, (batch, cfg.slots), dtype=np.int32)
    lbl_h = rng.integers(0, cfg.classes, (batch,), dtype=np.int32)
    loss = model.train_step(*model.shard_batch(ids_h, lbl_h))
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    print(f"[p{pid}] cross-process SPMD train step ok: loss={loss:.4f} over "
          f"{nproc} ranks (dp x tp = {nproc // tp} x {tp}; gloo, cpu; emb "
          f"shard {tuple(model.params['emb'].shape)} of ({cfg.vocab}, "
          f"{cfg.dim}))", flush=True)

    # barrier before the RPC stage so the server exists before the client
    # dials: a psum over every rank
    ici = MeshTransport(make_mesh((nproc,), ("ici",), "cpu"), "ici")
    tok = torch.ones(1)

    def sync():
        got = float(ici.psum(tok))
        if got != nproc:
            raise AssertionError(f"barrier psum {got}, want {nproc}")

    sync()
    if echo_device == "cuda":
        from ..ici import fabric  # noqa: F401  (defines the flag)
        if not set_flag("ici_transfer_enabled", True):
            raise RuntimeError("ici_transfer_enabled refused")
    from ..models.ps_service import PSService
    from ..ops.device_ops import checksum_u32
    if pid == 0:
        from ..server import Server

        srv = Server()
        echo_model = EmbeddingPS(PSConfig(vocab=64, dim=16, slots=4,
                                          hidden=32, classes=4),
                                 device=echo_device)
        srv.add_service(_checked_ps(PSService)(echo_model), name="PS")
        if srv.start(f"127.0.0.1:{rpc_port}") != 0:
            raise RuntimeError("the echo server did not start")
        try:
            sync()                # the server is up, p1 may dial
            sync()                # p1 finished its calls
        finally:
            srv.stop()
        print(f"[p{pid}] echo server stage done", flush=True)
    elif pid == 1:
        from ..client import Channel, Controller
        from ..ici.attachment import KIND_INLINE, KIND_TRANSFER

        sync()                    # p0's server is up
        try:
            want_kind = KIND_TRANSFER if echo_device == "cuda" \
                else KIND_INLINE
            ch = Channel()
            if ch.init(f"127.0.0.1:{rpc_port}") != 0:
                raise RuntimeError("client channel init failed")
            x = torch.arange(4096, dtype=torch.float32, device=echo_device)
            for _ in range(ECHOES):
                sent = checksum_u32(x)
                cntl = Controller()
                cntl.timeout_ms = 30_000
                cntl.request_device_attachment = x
                c = ch.call_method("PS.EchoTensor", b"", cntl=cntl)
                if c.failed or c.response_device_attachment is None:
                    raise AssertionError(f"the echo failed: {c.error_text}")
                info = json.loads(c.response)
                back_att = c.response_device_attachment
                back = back_att.tensor(echo_device)
                back_sum = checksum_u32(back)
                if not (info["sum"] == sent == back_sum
                        and torch.equal(back, x)):
                    raise AssertionError(f"echo sums {sent}/{info['sum']}/"
                                         f"{back_sum}")
            ch.close()
            if not info["kind"] == back_att.kind == want_kind:
                raise AssertionError(
                    f"echo legs {info['kind']}/{back_att.kind} (want "
                    f"{want_kind})")
            print(f"[p{pid}] cross-process device echo ok: {ECHOES} x "
                  f"{x.nbytes} bytes on {echo_device}, the last kind "
                  f"{want_kind} both ways, checksum {sent:#010x} on both "
                  f"ends", flush=True)
        finally:
            sync()                # release p0 even after a failure
    else:
        sync()
        sync()
    from ..ops.device_ops import CHECKSUM
    print(f"[p{pid}] {DONE} (checksum launches {CHECKSUM.launches})",
          flush=True)
    torch.distributed.destroy_process_group()


def run(world: int = 2, processes: int = 2, timeout_s: float = 300.0,
        echo_device: str = "cuda") -> list:
    """Spawn the workers and raise unless every one reports ok; returns
    their ``[p<i>]`` lines.  One rank per process: ``world`` must equal
    ``processes``.  The echo's tensor lies on ``echo_device``."""
    echo_device = resolve_device(echo_device).type
    if world != processes:
        raise ValueError(f"one rank per process: world {world} != "
                         f"processes {processes}")
    if processes < 2:
        raise ValueError("the dry run crosses processes: 2 or more")
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    rpc_port = probe.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    tmp = tempfile.mkdtemp(prefix="multiproc_dryrun_")
    init_file = os.path.join(tmp, "rendezvous")
    procs, logs = [], []
    probe.close()
    try:
        for pid in range(processes):
            # worker output goes to FILES: workers coupled through
            # collectives and a parent draining pipes one after another
            # can deadlock (a chatty worker fills its pipe while the parent
            # blocks on its sibling)
            lf = open(os.path.join(tmp, f"p{pid}.log"), "w+")
            logs.append(lf)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, str(pid), str(processes),
                 init_file, str(rpc_port), echo_device],
                cwd=repo, env=env, stdout=lf, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)
        outs = []
        for lf in logs:
            lf.seek(0)
            outs.append(lf.read())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for lf in logs:
            lf.close()
            os.unlink(lf.name)
        for name in os.listdir(tmp):
            os.unlink(os.path.join(tmp, name))
        os.rmdir(tmp)
    ok = all(p.returncode == 0 for p in procs) and all(
        f"] {DONE}" in o for o in outs)
    lines = [line for o in outs for line in o.splitlines()
             if line.startswith("[p")]
    if not ok:
        tails = "\n".join(f"--- worker {i} (rc {procs[i].returncode}) ---\n"
                          + "\n".join(o.splitlines()[-20:])
                          for i, o in enumerate(outs))
        raise RuntimeError(f"multi-process dry run failed\n{tails}")
    return lines


# -- the in-mesh dry run (world n, tiny shapes) -------------------------------

def _close(got, want, rtol, atol, what: str) -> None:
    got = got.detach().float().cpu()
    want = want.detach().float().cpu()
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: max abs err "
                             f"{float((got - want).abs().max()):.3e}")


def _dryrun_rank(device: str) -> list:
    """One rank's share of :func:`dryrun_multichip`; its log lines."""
    import torch.distributed as dist

    from ..models import transformer_lm as tlm
    from ..models.embedding_ps import EmbeddingPS, PSConfig
    from ..utils.convert import params_to_numpy, shard_from_numpy
    from .mesh_transport import MeshTransport, make_mesh, mesh_axis
    from .pipeline import make_pipeline, make_pipeline_train
    from .ring_attention import make_ring_attention, reference_attention

    n = dist.get_world_size()
    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    lines = []
    tp = 1
    for cand in (2, 4):
        if n % cand == 0:
            tp = cand
    dp = n // tp
    mesh = make_mesh((dp, tp), ("dp", "tp"), device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # the sharded PS step
    cfg = PSConfig(vocab=64 * tp, dim=32, slots=4, hidden=16 * tp,
                   classes=8, lr=0.1)
    model = EmbeddingPS(cfg, device=dev, seed=0, mesh=mesh)
    ids = torch.randint(0, cfg.vocab, (4 * dp, cfg.slots), generator=gen(1),
                        device=dev)
    labels = torch.randint(0, cfg.classes, (4 * dp,), generator=gen(2),
                           device=dev)
    loss = model.train_step(*model.shard_batch(ids, labels))
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite PS loss {loss}")
    if tuple(model.params["emb"].shape) != (cfg.vocab // tp, cfg.dim):
        raise AssertionError("the table is not cut over tp")
    lines.append(f"dryrun_multichip ok: mesh dp={dp} tp={tp} "
                 f"loss={loss:.4f}")

    # the mesh-transport collectives
    mt = MeshTransport(make_mesh((n,), ("ici",), device), "ici")
    x = np.arange(n * 8, dtype=np.float32).reshape(n, 8)
    xs = mt.scatter(x, axis=0)
    total = mt.gather(mt.psum(xs))[0]
    shifted = mt.gather(mt.ring_shift(xs, 1))
    if not (np.allclose(total, x.sum(axis=0))
            and np.allclose(shifted, np.roll(x, 1, axis=0))):
        raise AssertionError("mesh transport collectives disagree")
    lines.append("mesh transport collectives ok")

    # the MoE LM dp x tp (+ep) step, then with accum=2
    lm_cfg = tlm.LMConfig(vocab=64, dim=32, heads=4, depth=2, max_seq=64,
                          moe_experts=2 * tp)
    whole = params_to_numpy(tlm.init_params(gen(7), lm_cfg, dev))
    coords = {a.name: (a.rank, a.size)
              for a in (mesh_axis(mesh, "dp"), mesh_axis(mesh, "tp"))}
    lm_params = shard_from_numpy(whole, tlm.param_specs(lm_cfg), coords, dev)
    lm_ids = torch.randint(0, lm_cfg.vocab, (2 * dp, 16), generator=gen(8),
                           device=dev)
    lm_labels = lm_ids.roll(-1, -1)
    mine = slice(coords["dp"][0] * 2, coords["dp"][0] * 2 + 2)
    for accum in (1, 2):
        step = tlm.make_train_step(lm_cfg, mesh=mesh, accum=accum,
                                   device=dev)
        _, lm_loss = step(lm_params, lm_ids[mine], lm_labels[mine])
        if not torch.isfinite(lm_loss):
            raise AssertionError(f"non-finite LM loss (accum {accum})")
        lines.append(f"MoE transformer LM dp x tp(+ep) train step ok "
                     f"(accum={accum}): loss={float(lm_loss):.4f}")

    # sequence parallelism: ring attention over every rank
    sp_mesh = make_mesh((n,), ("sp",), device)
    g = gen(3)
    q, k, v = (torch.randn((1, 8 * n, 2, 8), generator=g, device=dev) * 0.5
               for _ in range(3))
    r = dist.get_rank()
    blk = slice(8 * r, 8 * r + 8)
    got = make_ring_attention(sp_mesh, "sp", causal=True)(
        q[:, blk], k[:, blk], v[:, blk])
    _close(got, reference_attention(q, k, v, causal=True)[:, blk],
           2e-4, 2e-5, "ring attention")
    lines.append("ring attention (sp) ok")

    # pipeline parallelism: the microbatch conveyor over every rank
    pp_mesh = make_mesh((n,), ("pp",), device)
    width = 8
    pw = torch.randn((n, width, width), generator=gen(4), device=dev) * 0.3

    def stage(p, h):
        return torch.tanh(h @ p["w"])

    xs_in = torch.randn((3, 2, width), generator=gen(5), device=dev)
    ys_in = torch.randn((3, 2, width), generator=gen(6), device=dev)
    out = make_pipeline(pp_mesh, stage, "pp")({"w": pw[r:r + 1]}, xs_in)
    want = xs_in
    for i in range(n):
        want = torch.tanh(want @ pw[i])
    _close(out, want, 1e-5, 1e-6, "pipeline")
    lines.append("pipeline (pp) ok")

    def pp_loss(outs, ys):
        return torch.mean((outs - ys) ** 2)

    def unpipelined(w, xs, ys, stages):
        w = w.detach().requires_grad_(True)
        h = xs
        for i in range(stages):
            h = torch.tanh(h @ w[i])
        loss = pp_loss(h, ys)
        return loss.detach(), torch.autograd.grad(loss, [w])[0]

    pp_l, pp_g = make_pipeline_train(pp_mesh, stage, pp_loss, "pp")(
        {"w": pw[r:r + 1]}, xs_in, ys_in)
    want_l, want_g = unpipelined(pw, xs_in, ys_in, n)
    _close(pp_l, want_l, 1e-5, 1e-6, "pipeline train loss")
    _close(pp_g["w"], want_g[r:r + 1], 1e-4, 1e-6, "pipeline train grads")
    lines.append(f"pipeline train step ok (loss matches: {float(pp_l):.6f})")

    # dp x pp: each dp group runs the conveyor on its batch share
    if n % 2 == 0 and n >= 4:
        n2 = n // 2
        mesh2 = make_mesh((2, n2), ("dp", "pp"), device)
        d_i, p_i = mesh2.get_local_rank("dp"), mesh2.get_local_rank("pp")
        pw2 = torch.randn((n2, width, width), generator=gen(14),
                          device=dev) * 0.3
        xs2 = torch.randn((3, 4, width), generator=gen(15), device=dev)
        ys2 = torch.randn((3, 4, width), generator=gen(16), device=dev)
        share = slice(2 * d_i, 2 * d_i + 2)
        l2, g2 = make_pipeline_train(mesh2, stage, pp_loss, "pp",
                                     dp_axis="dp")(
            {"w": pw2[p_i:p_i + 1]}, xs2[:, share], ys2[:, share])
        wl2, wg2 = unpipelined(pw2, xs2, ys2, n2)
        _close(l2, wl2, 1e-5, 1e-6, "dp x pp loss")
        _close(g2["w"], wg2[p_i:p_i + 1], 1e-4, 1e-6, "dp x pp grads")
        lines.append(f"dp x pp pipeline train step ok (loss "
                     f"{float(l2):.6f})")
    return lines


def dryrun_multichip(world: int, device: str = "cuda",
                     timeout_s: float = 300.0) -> list:
    """The counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``:
    its sequence at world ``world`` on tiny shapes, one rank per process
    (NCCL on cuda, gloo on cpu; on cuda one card per rank).  Raises on a
    failure; returns rank 0's log lines."""
    from .spmd import run_spmd

    tmp = tempfile.mkdtemp(prefix="dryrun_multichip_")
    try:
        results = run_spmd(_dryrun_rank, world, device, tmp, (device,),
                           timeout_s)
    finally:
        for name in os.listdir(tmp):
            os.unlink(os.path.join(tmp, name))
        os.rmdir(tmp)
    return results[0]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
            int(sys.argv[4]), sys.argv[5])
