"""The ranks' side of a sharded run: ``run_jobs`` is what
``sharding.spawn`` runs in each rank for the tests and chip_smoke.py.

A run is described by plain data (u64 words as numpy arrays and small
dicts), so any caller can feed it state made elsewhere, by the JAX package
or by the port on another device:

    spec = {"contexts": {name: {"scheme": "bfv", "n": 64, "q": [...],
                                "t": 65537}},
            "keys": {name: {power or Galois element: words}},
            "jobs": [{"name": ..., "regime": ..., "context": ...,
                      "key": ..., "inputs": [words, ...], ...}],
            "reps": 0}

Each job's inputs are whole (unsharded); every rank cuts its own shards,
runs the port's runner of the regime (parallel/sharding.py), and gathers
the output. The regimes and their extra fields:

  * ``dp_multiply_relin``: inputs two (B, 2, k, n) batches;
  * ``limb_multiply_relin``, ``coeff_multiply_relin``: two (2, k, n);
  * ``dp_limb_multiply_relin``: two (B, 2, k, n), ``mesh`` [dp, tp];
  * ``limb_rotate``: one (2, k, n), ``steps``, a Galois ``key``;
  * ``limb_mod_switch``: one (size, k, n), ``level``;
  * ``dp_limb_rotate_mod_switch``: one (B, 2, k, n), ``steps``, ``mesh``
    [dp, tp]: the rotation then the mod switch, chained on the shards;
  * ``app_matmul``: ciphertext tiles (X, I, 2, k, n) and mod-t weight
    tiles (I, Y, n), ``level`` and ``ntt_form`` of the ciphertexts.

Every job runs on the 1-D mesh of all ranks unless it names a 2-D one.
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Dict

import torch
import torch.distributed as dist

from .. import _kernels
from ..context import HeContext
from ..evaluator import Evaluator
from ..he_types import GaloisKeys, RelinKeys
from ..interop import ciphertext, plaintext, to_numpy, to_torch
from ..modulus import Modulus, SecurityLevel
from ..params import EncryptionParameters, SchemeType
from . import sharding as sh


def _context(spec: dict, device) -> HeContext:
    parms = EncryptionParameters(
        scheme=SchemeType[spec["scheme"]], poly_modulus_degree=spec["n"],
        coeff_modulus=tuple(Modulus(int(q)) for q in spec["q"]),
        plain_modulus=Modulus(int(spec.get("t") or 0)))
    return HeContext(parms, sec_level=SecurityLevel.none, device=device)


def _regime(job: dict, ctx: HeContext, keys: dict, mesh2d):
    """(the run, how to shard each input, how to gather the output)."""
    regime, mesh = job["regime"], job["mesh1d"]
    key = keys.get(job.get("key"))
    if regime == "dp_multiply_relin":
        run = sh.batched_multiply_relin(ctx, RelinKeys(keys=key), mesh)
        return run, [("batch", "dp")], [("dp", 0)]
    if regime == "limb_multiply_relin":
        run = sh.limb_sharded_multiply_relin(ctx, RelinKeys(keys=key), mesh)
        return run, [("limbs", "dp")], [("dp", -2)]
    if regime == "coeff_multiply_relin":
        run = sh.coeff_sharded_multiply_relin(ctx, RelinKeys(keys=key), mesh)
        return run, [("coeffs", "dp")], [("dp", -1)]
    if regime == "dp_limb_multiply_relin":
        run = sh.dp_limb_sharded_multiply_relin(ctx, RelinKeys(keys=key),
                                                mesh2d)
        return run, [("batch", "dp"), ("limbs", "tp")], [("tp", -2),
                                                          ("dp", 0)]
    if regime == "limb_rotate":
        run = sh.limb_sharded_rotate(ctx, GaloisKeys(keys=key),
                                     job["steps"], mesh)
        return run, [("limbs", "dp")], [("dp", -2)]
    if regime == "limb_mod_switch":
        run = sh.limb_sharded_mod_switch(ctx, mesh, level=job.get("level"))
        return run, [("limbs", "dp")], [("dp", -2)]
    if regime == "dp_limb_rotate_mod_switch":
        rot = sh.dp_limb_sharded_rotate(ctx, GaloisKeys(keys=key),
                                        job["steps"], mesh2d)
        ms = sh.dp_limb_sharded_mod_switch(ctx, mesh2d)

        def chain(x):
            return ms(rot(x))
        chain.keys = rot.keys
        return chain, [("batch", "dp"), ("limbs", "tp")], [("tp", -2),
                                                           ("dp", 0)]
    raise ValueError(f"unknown regime {regime!r}")


def _shard(mesh, x: torch.Tensor, how, ctx: HeContext) -> torch.Tensor:
    for kind, axis in how:
        if kind == "limbs":
            x = sh.shard_limbs(mesh, x, axis,
                               first=ctx.first_context_data.limbs)
        else:
            x = {"batch": sh.shard_batch,
                 "coeffs": sh.shard_coeffs}[kind](mesh, x, axis)
    return x


def _gather(mesh, x: torch.Tensor, how) -> torch.Tensor:
    for axis, dim in how:
        x = sh.gather(mesh, x, dim, axis)
    return x


def _app(job: dict, ctx: HeContext, mesh):
    """The app matmul's run on the rank's rows, and its output as a tensor
    (rows, Y, 2, k, n)."""
    from ..app.linear import Cipher2d, Plain2d
    cts, pts = job["inputs"]
    dev = ctx.device
    a2d = Cipher2d([[ciphertext(c, job["level"], job["ntt_form"], dev)
                     for c in row] for row in cts])
    w2d = Plain2d([[plaintext(p, dev) for p in row] for row in pts])
    ev = Evaluator(ctx)
    shape = (0, pts.shape[1]) + cts.shape[2:]

    def run():
        out = sh.sharded_app_matmul(ev, mesh, a2d, w2d)
        if not out.data:
            return torch.empty(shape, dtype=torch.int64, device=dev)
        return torch.stack([torch.stack([c.data for c in row])
                            for row in out.data])

    return run


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _median_ms(run, reps: int, device: torch.device) -> float:
    """Median of reps runs in ms: CUDA events on a card, the host clock on
    the CPU; the ranks start each run together."""
    times = []
    for _ in range(reps):
        dist.barrier()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_jobs(spec: dict) -> dict:
    """One rank's part of every job of ``spec`` (module docstring): rank 0
    returns each job's gathered output words (``out``, a list); every rank
    returns each job's collectives of one run (``collectives``), the
    shape of its output shard and the bytes of its input, key and output
    shards (``shard_bytes``), its
    median time over ``spec["reps"]`` runs after a warm-up (``ms``, None
    when reps is 0), the kernel launches of the whole call (``launches``),
    its device and whether JAX was imported in it (it never is)."""
    _kernels.reset_launch_counts()
    mesh = sh.make_mesh()
    device = mesh.device
    rank = dist.get_rank()
    contexts: Dict[str, HeContext] = {}
    key_words: Dict[str, dict] = {}
    meshes2d = {}
    reps = int(spec.get("reps", 0))
    results = {}
    for job in spec["jobs"]:
        cname = job["context"]
        if cname not in contexts:
            contexts[cname] = _context(spec["contexts"][cname], device)
        ctx = contexts[cname]
        kname = job.get("key")
        if kname and kname not in key_words:
            key_words[kname] = {int(e): to_torch(w, device)
                                for e, w in spec["keys"][kname].items()}
        mesh2d = None
        if job.get("mesh"):
            dims = tuple(job["mesh"])
            if dims not in meshes2d:
                meshes2d[dims] = sh.make_mesh_2d(*dims)
            mesh2d = meshes2d[dims]
        job = dict(job, mesh1d=mesh)
        if job["regime"] == "app_matmul":
            call, active, gather_how = _app(job, ctx, mesh), mesh, \
                [("dp", 0)]
            held = 0
        else:
            run, shard_how, gather_how = _regime(job, ctx, key_words, mesh2d)
            active = mesh2d or mesh
            shards = [_shard(active, to_torch(x, device), shard_how, ctx)
                      for x in job["inputs"]]
            call = (lambda run=run, shards=shards: run(*shards))
            held = sum(_nbytes(x) for x in shards) + sum(
                _nbytes(k) for k in getattr(run, "keys", ()))
        active.stats.reset()
        out = call()
        if device.type == "cuda":
            torch.cuda.synchronize()
        collectives = active.stats.snapshot()
        full = _gather(active, out, gather_how)
        ms = None
        if reps:
            call()
            ms = _median_ms(call, reps, device)
        results[job["name"]] = {
            "out": to_numpy(full) if rank == 0 else None,
            "collectives": collectives, "ms": ms,
            "shard_shape": tuple(out.shape),
            "shard_bytes": held + _nbytes(out)}
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"results": results, "launches": _kernels.launch_counts(),
            "device": str(device), "jax_loaded": "jax" in sys.modules}
