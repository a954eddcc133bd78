"""Multi-device execution on torch.distributed: meshes of ranks and the
sharded ciphertext regimes (R).

The port of troy_tpu/parallel/sharding.py, with its function names and
arguments. JAX holds global arrays on one controller and lets GSPMD place
the collectives; here every rank runs the same code on its own shard
(SPMD) and the collectives are placed by hand, with the words of the
unsharded op in every regime (integer arithmetic is exact):

  * data parallel (``batched_multiply_relin``): a batch of ciphertexts
    split over the ranks, each running the evaluator's batched cores on
    its part; no collective;
  * RNS-limb sharded (``limb_sharded_multiply_relin``, ``_galois``,
    ``_rotate``, ``_mod_switch``): contiguous runs of limbs as GSPMD cuts
    them (``interop.shard_range``: ceil(k / w) each, the last ranks fewer
    or none, and a rank with none still joins every collective); the key
    cut on its decomposition axis. The key switch takes each rank's digits
    through AF (F's digits in A's first pass) and B into a partial inner product over its own digits,
    all-gathers the partials and sums them with kernel R1
    (ops/shard.py), then divides its own limbs by the special prime. The
    BFV multiply all-gathers the input limbs before the BEHZ lift (E),
    splits the rows of q u Bsk over the ranks for the transforms and the
    convolution (A, B), and all-gathers the product rows before E's tail.
    The mod switch broadcasts the dropped limb from its owner; each rank's
    output keeps its own limbs but that one. Galois permutes each limb
    locally (M) before the key switch;
  * the 2-D mesh (``dp_limb_*``): batches over the dp axis, limbs over tp;
    the limb collectives stay inside a tp group;
  * coefficient sharded (``coeff_sharded_multiply_relin``): each rank holds
    n / w consecutive coefficients (or NTT-domain words) of every limb.
    Everything but the transforms is per coefficient and runs on the
    shards as it is; the transforms run on kernel J's 4-step structure with
    per-shard twiddle tables (ops/ntt_mxu.py ``make_shard_tables``): an
    all-to-all from row blocks (A / w, B) to column blocks (A, B / w), J's
    left stage, an all-to-all back, J's right stage (the inverse mirrors
    it);
  * ``sharded_app_matmul``: the app layer's ct x pt tile contraction (P1)
    over a rank's batch-block rows; no collective.

Collectives go through one helper per kind on ``Mesh`` (``all_gather``,
``all_to_all``, ``broadcast``), which counts calls and bytes. The backend
is the caller's choice and nothing falls back: NCCL runs on CUDA tensors
(one card per rank); gloo runs on the CPU, so with gloo the helpers stage a
CUDA tensor through host memory explicitly (a device-to-host copy, the
collective, a host-to-device copy) — every collective of gloo on the card
is staged. ``spawn`` starts the ranks of one host (the tests and
chip_smoke.py use it).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import _kernels, native
from .. import evaluator as ev_mod
from ..context import ContextData, HeContext
from ..he_types import GaloisKeys, RelinKeys
from ..interop import shard_range
from ..ops import galois as dgalois
from ..ops import keyswitch as dks
from ..ops import ntt as dntt
from ..ops import ntt_mxu
from ..ops import rns as drns
from ..ops import shard as dshard
from ..params import SchemeType
from ..utils import galois as galois_util

BACKENDS = ("nccl", "gloo")
# A collective or the parent's wait that takes longer fails the call.
DEFAULT_TIMEOUT_S = 300.0

# The device this process's rank runs on (init_mesh_process).
_process_device: Optional[torch.device] = None


# --------------------------------------------------------------------------
# meshes and collectives
# --------------------------------------------------------------------------

@dataclass(eq=False)
class Axis:
    """One mesh axis as this rank sees it: its process group, the global
    ranks of the group in order, and this rank's place among them."""

    group: Any
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclass
class CollectiveStats:
    """Calls and bytes of each kind of collective since the last
    ``reset``: the bytes this rank received from other ranks."""

    calls: Dict[str, int] = field(default_factory=dict)
    bytes: Dict[str, int] = field(default_factory=dict)

    def add(self, kind: str, nbytes: int) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes)}


@dataclass(eq=False)
class Mesh:
    """Named axes of ranks (``make_mesh``, ``make_mesh_2d``), this rank's
    device and the backend, with the collective helpers."""

    axes: Dict[str, Axis]
    device: torch.device
    backend: str
    stats: CollectiveStats = field(default_factory=CollectiveStats)

    def size(self, axis: str) -> int:
        return self.axes[axis].size

    def index(self, axis: str) -> int:
        return self.axes[axis].index

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor the backend runs on: gloo's host copy of a CUDA
        tensor (the explicit staging of the module docstring), else x."""
        if self.backend == "gloo" and x.is_cuda:
            return x.to("cpu")
        return x.contiguous()

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(w, *x.shape): every rank's x along ``axis``, in rank order."""
        a = self.axes[axis]
        src = self._host(x)
        out = torch.empty((a.size,) + tuple(x.shape), dtype=x.dtype,
                          device=src.device)
        dist.all_gather(list(out.unbind(0)), src, group=a.group)
        self.stats.add("all_gather", (a.size - 1) * _nbytes(x))
        return out.to(x.device)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """x (w, ...): block j goes to rank j; the result's block i came
        from rank i."""
        a = self.axes[axis]
        if x.shape[0] != a.size:
            raise ValueError(f"all_to_all: {x.shape[0]} blocks for "
                             f"{a.size} ranks")
        src = self._host(x)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=a.group)
        self.stats.add("all_to_all", (a.size - 1) * _nbytes(x) // a.size)
        return out.to(x.device)

    def broadcast(self, x: torch.Tensor, axis: str,
                  root: int) -> torch.Tensor:
        """The x of the rank at place ``root`` of the axis, on every rank
        (x gives the shape elsewhere)."""
        a = self.axes[axis]
        buf = self._host(x)
        dist.broadcast(buf, src=a.ranks[root], group=a.group)
        self.stats.add("broadcast", 0 if a.index == root else _nbytes(x))
        return buf.to(x.device)

    def gather_cut(self, x: torch.Tensor, axis: str, dim: int,
                   runs: Sequence[range]) -> torch.Tensor:
        """Every rank's run ``runs[i]`` of an axis of the data, held along
        ``dim`` of x, joined in order: one all-gather of the shards padded
        to the longest run."""
        dim = dim % x.dim()
        pad = max(len(r) for r in runs) - x.shape[dim]
        if pad:
            shape = list(x.shape)
            shape[dim] = pad
            x = torch.cat([x, x.new_zeros(shape)], dim=dim)
        parts = self.all_gather(x, axis)
        return torch.cat([parts[i].narrow(dim, 0, len(r))
                          for i, r in enumerate(runs)], dim=dim)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def init_mesh_process(rank: int, world: int, backend: str, device,
                      store_path: str,
                      timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to a group of ``world`` ranks as ``rank``: the
    ``backend`` ("nccl" or "gloo") and the ``device`` are the caller's
    choice, the rendezvous a FileStore at ``store_path`` (a file of a
    directory every rank sees), and every collective fails after
    ``timeout_s``."""
    global _process_device
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError(f"the nccl backend runs on a card, not {device}")
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _process_device = device


def _mesh_device() -> torch.device:
    if _process_device is None:
        raise RuntimeError("no mesh process: call init_mesh_process first")
    return _process_device


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "dp", *,
              group=None) -> Optional[Mesh]:
    """A 1-D mesh over the first n_devices ranks (all of them by default),
    or over ``group``. Every rank calls it; a rank outside the mesh gets
    None."""
    world = dist.get_world_size()
    rank = dist.get_rank()
    if group is None:
        n = world if n_devices is None else n_devices
        if not 1 <= n <= world:
            raise ValueError(f"mesh of {n} over {world} ranks")
        ranks = tuple(range(n))
        group = dist.group.WORLD if n == world else dist.new_group(
            list(ranks))
    else:
        ranks = tuple(dist.get_process_group_ranks(group))
    if rank not in ranks:
        return None
    return Mesh({axis_name: Axis(group, ranks, ranks.index(rank))},
                _mesh_device(), dist.get_backend())


def make_mesh_2d(dp: int, tp: int,
                 axis_names: Sequence[str] = ("dp", "tp")) -> Optional[Mesh]:
    """A (dp, tp) mesh over the first dp * tp ranks: rank d * tp + t sits
    at (d, t); batches split over the outer axis, limbs over the inner.
    Every rank makes every group, in the same order."""
    world = dist.get_world_size()
    if dp * tp > world:
        raise ValueError(f"mesh {dp}x{tp} exceeds {world} ranks")
    rank = dist.get_rank()
    rows = [tuple(d * tp + t for t in range(tp)) for d in range(dp)]
    cols = [tuple(d * tp + t for d in range(dp)) for t in range(tp)]
    tp_groups = [dist.new_group(list(r)) for r in rows]
    dp_groups = [dist.new_group(list(c)) for c in cols]
    if rank >= dp * tp:
        return None
    d, t = divmod(rank, tp)
    return Mesh({axis_names[0]: Axis(dp_groups[t], cols[t], d),
                 axis_names[1]: Axis(tp_groups[d], rows[d], t)},
                _mesh_device(), dist.get_backend())


# --------------------------------------------------------------------------
# shards
# --------------------------------------------------------------------------

def _cut(mesh: Mesh, data: torch.Tensor, axis_name: str,
         dim: int) -> torch.Tensor:
    r = shard_range(data.shape[dim], mesh.size(axis_name),
                    mesh.index(axis_name))
    return data.narrow(dim, r.start, len(r)).contiguous()


def shard_batch(mesh: Mesh, data: torch.Tensor,
                axis_name: str = "dp") -> torch.Tensor:
    """This rank's part of a (B, ...) batch, its leading axis split over
    ``axis_name``."""
    return _cut(mesh, data, axis_name, 0)


def limb_runs(first: int, k: int, w: int) -> Tuple[range, ...]:
    """The limbs each of w ranks holds at a level of k limbs: the first
    level's ``first`` limbs cut as GSPMD cuts them (``interop.shard_range``,
    ceil(first / w) each), less the limbs the level has dropped. One cut
    for every level, so a mod switch leaves each rank's other limbs where
    they were and the runners of the next level take them as they are."""
    return tuple(range(min(r.start, k), min(r.stop, k))
                 for r in (shard_range(first, w, i) for i in range(w)))


def shard_limbs(mesh: Mesh, data: torch.Tensor, axis_name: str = "dp",
                dim: int = -2, first: Optional[int] = None) -> torch.Tensor:
    """This rank's limbs of (..., k, n) data (or of the key's decomposition
    axis, ``dim=0``), cut as ``limb_runs``: ``first`` is the limb count of
    the context's first level, where the data is at a lower one (the
    runners' ``level``)."""
    k = data.shape[dim]
    r = limb_runs(k if first is None else first, k,
                  mesh.size(axis_name))[mesh.index(axis_name)]
    return data.narrow(dim, r.start, len(r)).contiguous()


def shard_coeffs(mesh: Mesh, data: torch.Tensor,
                 axis_name: str = "dp") -> torch.Tensor:
    """This rank's n / w consecutive words of every row of (..., n)."""
    w = mesh.size(axis_name)
    if data.shape[-1] % w:
        raise ValueError(f"{data.shape[-1]} coefficients over {w} ranks")
    return _cut(mesh, data, axis_name, -1)


def gather(mesh: Mesh, shard: torch.Tensor, dim: int,
           axis_name: str = "dp") -> torch.Tensor:
    """The whole tensor from every rank's shard along ``dim`` (shards of
    any lengths, in rank order), on every rank: for checks."""
    dim = dim % shard.dim()
    sizes = mesh.all_gather(torch.tensor([shard.shape[dim]],
                                         device=shard.device), axis_name)
    starts = [0]
    for s in sizes.reshape(-1).tolist():
        starts.append(starts[-1] + int(s))
    runs = [range(a, b) for a, b in zip(starts, starts[1:])]
    return mesh.gather_cut(shard, axis_name, dim, runs)


# --------------------------------------------------------------------------
# one rank's limbs
# --------------------------------------------------------------------------

@dataclass(eq=False)
class _Limbs:
    """The limbs of one level that each rank of a mesh axis holds
    (``limb_runs``) and this rank's tables."""

    cd: ContextData
    key_cd: ContextData
    runs: Tuple[range, ...]
    index: int

    @classmethod
    def of(cls, context: HeContext, level: int, mesh: Mesh,
           axis: str) -> "_Limbs":
        cd = context.get_context_data(level)
        runs = limb_runs(context.first_context_data.limbs, cd.limbs,
                         mesh.size(axis))
        return cls(cd, context.key_context_data, runs, mesh.index(axis))

    @property
    def own(self) -> range:
        return self.runs[self.index]

    @property
    def tables(self) -> dntt.RnsNttTables:
        return self.cd.ntt.slice(self.own.start, self.own.stop)

    @property
    def used(self) -> dntt.RnsNttTables:
        return ev_mod._used_tables(self.cd, self.key_cd)


def _own_key(key: torch.Tensor, limbs: _Limbs) -> torch.Tensor:
    """This rank's rows of a switching key (decomp, 2, kf, n): its own
    digits, restricted to the level's limbs and the special prime; a copy,
    so the rank holds only these."""
    k, kf = limbs.cd.limbs, limbs.key_cd.limbs
    return ev_mod._key_rows(key, k, kf)[limbs.own.start:limbs.own.stop] \
        .clone()


def _limb_switch_key(target: torch.Tensor, key: torch.Tensor,
                     limbs: _Limbs, mesh: Mesh, axis: str, ntt_form: bool,
                     acc: torch.Tensor) -> torch.Tensor:
    """The key switch of targets (m, k_r, n), this rank's limbs, under its
    key rows (k_r, 2, k+1, n), with acc (m, a, k_r, n) added onto the first
    a components: (m, 2, k_r, n) in the target's domain. Each rank's inner
    product over its own digits (AF, B), all-gathered and summed (R1),
    then the divide of its own limbs by the special prime (the
    evaluator's, troy_tpu/evaluator.py:290)."""
    cd, used, own = limbs.cd, limbs.used, limbs.own
    m, n, k = target.shape[0], target.shape[-1], cd.limbs
    if len(own):
        t_hat = ev_mod._switch_key_decompose(target, cd, limbs.key_cd,
                                             ntt_form, limbs=own)
        partial = dntt.dyadic_mac_batched(key, t_hat, used)
    else:
        partial = target.new_zeros((m, 2, used.k, n))
    total = dshard.shard_modsum(mesh.all_gather(partial, axis), used)
    if not len(own):
        return target.new_zeros((m, 2, 0, n))
    rows = list(own) + [k]
    x = total[:, :, rows].reshape(2 * m, len(rows), n)
    out = ev_mod._divide_by_special(x, cd, limbs.key_cd, ntt_form, acc, 2,
                                    limbs=own)
    return out.reshape(m, 2, len(own), n)


def _limb_multiply(d1: torch.Tensor, d2: torch.Tensor, limbs: _Limbs,
                   mesh: Mesh, axis: str) -> torch.Tensor:
    """The ciphertext product of (m, 2, k_r, n) shards: (m, 3, k_r, n).
    CKKS and BGV: the NTT-domain convolution of the rank's limbs (B), no
    collective. BFV: the input limbs all-gathered, the BEHZ lift (E), this
    rank's rows of q u Bsk transformed, convolved and transformed back (A,
    B, A), the product rows all-gathered, E's tail, the rank's limbs."""
    cd = limbs.cd
    if cd.scheme != SchemeType.bfv:
        if not len(limbs.own):
            return d1.new_zeros(d1.shape[:1] + (3,) + d1.shape[2:])
        return ev_mod._dyadic_convolution(d1, d2, limbs.tables)
    tool = cd.rns
    both = mesh.gather_cut(torch.cat([d1, d2], dim=1), axis, -2, limbs.runs)
    rows = torch.cat([both, drns.behz_lift(both, tool)], dim=-2)
    w = mesh.size(axis)
    row_runs = [shard_range(rows.shape[-2], w, i) for i in range(w)]
    mine = row_runs[mesh.index(axis)]
    m, n = rows.shape[0], rows.shape[-1]
    if len(mine):
        tabs = tool.q_bsk.slice(mine.start, mine.stop)
        x = dntt.rns_ntt_forward(rows[..., mine.start:mine.stop, :], tabs,
                                 lazy=True)
        prod = dntt.rns_ntt_inverse(
            ev_mod._dyadic_convolution(x[:, :2], x[:, 2:], tabs), tabs)
    else:
        prod = rows.new_zeros((m, 3, 0, n))
    full = mesh.gather_cut(prod, axis, -2, row_runs)
    out = drns.behz_tail(full, tool)
    return out[..., limbs.own.start:limbs.own.stop, :].contiguous()


def _limb_mult_relin(d1: torch.Tensor, d2: torch.Tensor, key: torch.Tensor,
                     limbs: _Limbs, mesh: Mesh, axis: str) -> torch.Tensor:
    prod = _limb_multiply(d1, d2, limbs, mesh, axis)
    return _limb_switch_key(prod[:, 2], key, limbs, mesh, axis,
                            limbs.cd.scheme != SchemeType.bfv, prod[:, :2])


def _limb_galois(data: torch.Tensor, table: torch.Tensor, key: torch.Tensor,
                 limbs: _Limbs, mesh: Mesh, axis: str,
                 ntt_form: bool) -> torch.Tensor:
    """Galois of (m, 2, k_r, n) shards: each limb permuted (M, by kernel
    M's packed table), c1 key-switched and added onto the permuted c0
    (troy_tpu/parallel/sharding.py:90 _galois_step)."""
    if len(limbs.own):
        data = dgalois.permute(data, table,
                               None if ntt_form else limbs.tables)
    return _limb_switch_key(data[:, 1], key, limbs, mesh, axis, ntt_form,
                            data[:, :1])


def _limb_mod_switch(data: torch.Tensor, limbs: _Limbs, mesh: Mesh,
                     axis: str) -> torch.Tensor:
    """Drop the level's last limb from (m, s, k_r, n) shards: the limb
    broadcast from its owner, then on each rank's other limbs BFV's divide
    (K), CKKS's rescale (K') or BGV's mod-t-and-divide (K'-BGV):
    (m, s, k_r', n), the rank's limbs less the dropped one
    (troy_tpu/parallel/sharding.py:113 _mod_switch_step)."""
    cd = limbs.cd
    k = cd.limbs
    if k < 2:
        raise ValueError("already at the last level")
    owner = next(i for i, r in enumerate(limbs.runs) if k - 1 in r)
    own = limbs.own
    m, s, n = data.shape[0], data.shape[1], data.shape[-1]
    last = data[:, :, -1:] if limbs.index == owner \
        else data.new_empty((m, s, 1, n))
    last = mesh.broadcast(last.contiguous(), axis, owner)
    keep = range(own.start, min(own.stop, k - 1))
    if not len(keep):
        return data.new_zeros((m, s, 0, n))
    x = torch.cat([data[:, :, :len(keep)], last], dim=2).reshape(
        m * s, len(keep) + 1, n)
    tabs = cd.ntt.select(list(keep) + [k - 1])
    head = tabs.slice(0, len(keep))
    q_last = cd.coeff_values[-1]
    if cd.scheme == SchemeType.bfv:
        out = dks.divide_and_round_q_last(x, tabs)
    elif cd.scheme == SchemeType.ckks:
        out = drns.divide_and_round_q_last_ntt(
            x, tabs, dks.divide_round_consts(head, q_last))
    else:
        out = drns.mod_t_and_divide_q_last_ntt(x, tabs, dks.bgv_divide_consts(
            head, q_last, int(cd.plain_modulus)))
    return out.reshape(m, s, len(keep), n)


def _runner(fn, keys: tuple = ()):
    """A rank's op on its shards, with ``keys``, the key rows it holds, as
    an attribute."""
    fn.keys = keys
    return fn


# --------------------------------------------------------------------------
# multiply + relinearize regimes
# --------------------------------------------------------------------------

def _batched_mult_relin(d1: torch.Tensor, d2: torch.Tensor,
                        key: torch.Tensor, cd: ContextData,
                        key_cd: ContextData) -> torch.Tensor:
    """(m, 2, k, n) x2 -> (m, 2, k, n) on one rank, the evaluator's cores
    over the batch: the product (BFV: one lift and one transform of every
    component, E and A; the convolution, B, one launch per output
    component; A and E's tail), then one batched key switch of the m c2s
    (AF, B, the divide) adding (c0, c1)."""
    ntt_form = cd.scheme != SchemeType.bfv
    if cd.scheme == SchemeType.bfv:
        tool = cd.rns
        rows = ev_mod._bfv_lift_ntt(torch.cat([d1, d2], dim=1), cd)
        prod = drns.behz_tail(dntt.rns_ntt_inverse(ev_mod._dyadic_convolution(
            rows[:, :2], rows[:, 2:], tool.q_bsk), tool.q_bsk), tool)
    else:
        prod = ev_mod._dyadic_convolution(d1, d2, cd.ntt)
    return ev_mod._switch_key_core(prod[:, 2], key, cd, key_cd,
                                   acc=prod[:, :2], ntt_form=ntt_form,
                                   group=2, caller="batched_mult_relin")


def batched_multiply_relin(context: HeContext, relin_keys: RelinKeys,
                           mesh: Mesh, axis_name: str = "dp"):
    """Data-parallel multiply+relinearize: the runner takes this rank's
    part of a (B, 2, k, n) batch pair (``shard_batch``) and returns its
    (B_r, 2, k, n) products; the ranks never communicate."""
    cd, key_cd = context.first_context_data, context.key_context_data
    key = relin_keys.keys[2]

    def run(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
        if not d1.shape[0]:
            return d1.clone()
        return _batched_mult_relin(d1, d2, key, cd, key_cd)

    return _runner(run, (key,))


def limb_sharded_multiply_relin(context: HeContext, relin_keys: RelinKeys,
                                mesh: Mesh, axis_name: str = "dp"):
    """Multiply+relinearize of one ciphertext pair with the RNS-limb axis
    split over the mesh: the runner takes this rank's (2, k_r, n) limbs of
    each (``shard_limbs``) and returns its (2, k_r, n) limbs of the result.
    The key is cut on its decomposition axis: the runner keeps this rank's
    digits' rows only (``run.keys``)."""
    limbs = _Limbs.of(context, context.first_level, mesh, axis_name)
    key = _own_key(relin_keys.keys[2], limbs)

    def run(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
        return _limb_mult_relin(d1[None], d2[None], key, limbs, mesh,
                                axis_name)[0]

    return _runner(run, (key,))


def dp_limb_sharded_multiply_relin(context: HeContext,
                                   relin_keys: RelinKeys, mesh: Mesh,
                                   dp_axis: str = "dp",
                                   tp_axis: str = "tp"):
    """The 2-D regime: the runner takes this rank's (B_d, 2, k_t, n) part
    of a batch pair (its dp batch, its tp limbs) and returns its part of
    the products; the limb collectives run inside its tp group."""
    limbs = _Limbs.of(context, context.first_level, mesh, tp_axis)
    key = _own_key(relin_keys.keys[2], limbs)

    def run(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
        return _limb_mult_relin(d1, d2, key, limbs, mesh, tp_axis)

    return _runner(run, (key,))


class _CoeffNtt:
    """Kernel J's transforms on coefficient shards, called as ops/ntt.py's
    (x, tables): each rank holds words [i n / w, (i + 1) n / w) of every
    row, a row block (A / w, B) of the 4-step array. A base's per-shard
    tables are made at its first transform."""

    def __init__(self, n: int, mesh: Mesh, axis: str, device):
        self.mesh, self.axis, self.device = mesh, axis, device
        self.w, self.i = mesh.size(axis), mesh.index(axis)
        self.n = n
        self.a, self.b = ntt_mxu._split_factors(n)
        self.bases: Dict[tuple, tuple] = {}

    def _base(self, tables: dntt.RnsNttTables) -> tuple:
        """(J's shard tables of each limb, their pointer table)."""
        key = tuple(tables.values)
        if key not in self.bases:
            mxu = tuple(ntt_mxu.make_shard_tables(self.n, q, self.device,
                                                  self.w, self.i)
                        for q in key)
            self.bases[key] = mxu, ntt_mxu.pointer_table(mxu, self.device)
        return self.bases[key]

    def _to_columns(self, y: torch.Tensor) -> torch.Tensor:
        """Row blocks (..., A / w, B) -> column blocks (..., A, B / w)."""
        w, lead = self.w, y.shape[:-2]
        blocks = y.reshape(lead + (self.a // w, w, self.b // w)).movedim(-2,
                                                                         0)
        got = self.mesh.all_to_all(blocks.contiguous(), self.axis)
        return got.movedim(0, -3).reshape(lead + (self.a, self.b // w))

    def _to_rows(self, y: torch.Tensor) -> torch.Tensor:
        """Column blocks (..., A, B / w) -> row blocks (..., A / w, B)."""
        w, lead = self.w, y.shape[:-2]
        blocks = y.reshape(lead + (w, self.a // w, self.b // w)).movedim(-3,
                                                                         0)
        got = self.mesh.all_to_all(blocks.contiguous(), self.axis)
        return got.movedim(0, -2).reshape(lead + (self.a // self.w, self.b))

    def forward(self, x: torch.Tensor, tables: dntt.RnsNttTables,
                lazy: bool = False) -> torch.Tensor:
        """(..., k, n / w) shards over ``tables``' primes -> the shards of
        the forward NTT, fully reduced (the words of
        ops/ntt.rns_ntt_forward, which every ``lazy`` caller takes)."""
        mxu, pointers = self._base(tables)
        y = x.reshape(x.shape[:-1] + (self.a // self.w, self.b))
        y = ntt_mxu.rns_mxu_stage(self._to_columns(y), mxu, pointers,
                                  "forward_left")
        return ntt_mxu.rns_mxu_stage(self._to_rows(y), mxu, pointers,
                                     "forward_right").reshape(x.shape)

    def inverse(self, x: torch.Tensor,
                tables: dntt.RnsNttTables) -> torch.Tensor:
        """The inverse transform of (..., k, n / w) shards, n^-1
        included, fully reduced."""
        mxu, pointers = self._base(tables)
        y = x.reshape(x.shape[:-1] + (self.a // self.w, self.b))
        y = ntt_mxu.rns_mxu_stage(y, mxu, pointers, "inverse_right")
        y = ntt_mxu.rns_mxu_stage(self._to_columns(y), mxu, pointers,
                                  "inverse_left")
        return self._to_rows(y).reshape(x.shape)


def coeff_sharded_multiply_relin(context: HeContext, relin_keys: RelinKeys,
                                 mesh: Mesh, axis_name: str = "dp"):
    """Multiply+relinearize of one ciphertext pair with the coefficient
    axis split over the mesh: the runner takes this rank's (2, k, n / w)
    words of each (``shard_coeffs``) and returns its words of the result.
    The per-coefficient kernels (E, B, F, K', the divides) run on the
    shards; every transform is J's 4-step over the mesh (``_CoeffNtt``),
    also where the unsharded op runs A: the words are the same. The key
    (NTT form) is cut the same way."""
    cd, key_cd = context.first_context_data, context.key_context_data
    n_loc = cd.n // mesh.size(axis_name)
    key = shard_coeffs(mesh, relin_keys.keys[2], axis_name).clone()
    ntt_form = cd.scheme != SchemeType.bfv
    used = ev_mod._used_tables(cd, key_cd)
    ntt = _CoeffNtt(cd.n, mesh, axis_name, cd.device)

    def run(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
        if cd.scheme == SchemeType.bfv:
            tool = cd.rns
            both = torch.cat([d1, d2])
            rows = torch.cat([both, drns.behz_lift(both, tool)], dim=-2)
            x = ntt.forward(rows, tool.q_bsk)
            prod = ntt.inverse(ev_mod._dyadic_convolution(
                x[:2], x[2:], tool.q_bsk.pointwise(n_loc)), tool.q_bsk)
            prod = drns.behz_tail(prod, tool)
        else:
            prod = ev_mod._dyadic_convolution(d1, d2,
                                              cd.ntt.pointwise(n_loc))
        target = prod[2]
        if ntt_form:
            target = ntt.inverse(target, cd.ntt)
        used_pw = used.pointwise(n_loc)
        t_hat = ntt.forward(dks.keyswitch_digits(target, used_pw), used)
        prods = dntt.dyadic_mac(t_hat, key, used_pw)       # (2, k + 1, n/w)
        return ev_mod._divide_by_special(prods, cd, key_cd, ntt_form,
                                         prod[:2], forward=ntt.forward,
                                         inverse=ntt.inverse)

    return _runner(run, (key,))


# --------------------------------------------------------------------------
# Galois / rotation regimes
# --------------------------------------------------------------------------

def _galois_table(context: HeContext, elt: int, is_ntt: bool
                  ) -> torch.Tensor:
    n, device = context.n, context.device
    if is_ntt:
        return dgalois.ntt_table(n, elt, device)
    return dgalois.coeff_table(n, elt, device)


def limb_sharded_galois(context: HeContext, galois_keys: GaloisKeys,
                        elt: int, mesh: Mesh, axis_name: str = "dp"):
    """Galois automorphism + key switch with the RNS-limb axis split: the
    runner takes this rank's (2, k_r, n) limbs (CKKS and BGV in NTT form,
    BFV in coefficient form) and returns its limbs of the result."""
    is_ntt = context.scheme in (SchemeType.ckks, SchemeType.bgv)
    limbs = _Limbs.of(context, context.first_level, mesh, axis_name)
    key = _own_key(galois_keys.keys[elt], limbs)
    table = _galois_table(context, elt, is_ntt)

    def run(data: torch.Tensor) -> torch.Tensor:
        return _limb_galois(data[None], table, key, limbs, mesh, axis_name,
                            is_ntt)[0]

    return _runner(run, (key,))


def dp_limb_sharded_galois(context: HeContext, galois_keys: GaloisKeys,
                           elt: int, mesh: Mesh, dp_axis: str = "dp",
                           tp_axis: str = "tp"):
    """Batched Galois on the 2-D mesh: (B_d, 2, k_t, n) shards, the layout
    of the 2-D multiply and mod switch, so the three chain with no
    re-layout."""
    is_ntt = context.scheme in (SchemeType.ckks, SchemeType.bgv)
    limbs = _Limbs.of(context, context.first_level, mesh, tp_axis)
    key = _own_key(galois_keys.keys[elt], limbs)
    table = _galois_table(context, elt, is_ntt)

    def run(data: torch.Tensor) -> torch.Tensor:
        return _limb_galois(data, table, key, limbs, mesh, tp_axis, is_ntt)

    return _runner(run, (key,))


def limb_sharded_rotate(context: HeContext, galois_keys: GaloisKeys,
                        steps: int, mesh: Mesh, axis_name: str = "dp"):
    """rotate_rows / rotate_vector by ``steps`` under the limb regime (the
    Galois element 3^steps mod 2n, galois.h:68)."""
    elt = galois_util.get_elt_from_step(context.n, steps)
    return limb_sharded_galois(context, galois_keys, elt, mesh, axis_name)


def dp_limb_sharded_rotate(context: HeContext, galois_keys: GaloisKeys,
                           steps: int, mesh: Mesh, dp_axis: str = "dp",
                           tp_axis: str = "tp"):
    elt = galois_util.get_elt_from_step(context.n, steps)
    return dp_limb_sharded_galois(context, galois_keys, elt, mesh, dp_axis,
                                  tp_axis)


# --------------------------------------------------------------------------
# mod-switch / rescale regimes
# --------------------------------------------------------------------------

def limb_sharded_mod_switch(context: HeContext, mesh: Mesh,
                            axis_name: str = "dp",
                            level: Optional[int] = None):
    """Drop-one-prime mod switch (BFV divide-and-round, CKKS rescale, BGV
    mod-t-and-divide) with the limb axis split: the runner takes this
    rank's (size, k_r, n) limbs at ``level`` (the first by default) and
    returns (size, k_r', n), its limbs but the dropped one."""
    limbs = _Limbs.of(context, context.first_level if level is None
                      else level, mesh, axis_name)

    def run(data: torch.Tensor) -> torch.Tensor:
        return _limb_mod_switch(data[None], limbs, mesh, axis_name)[0]

    return _runner(run)


def dp_limb_sharded_mod_switch(context: HeContext, mesh: Mesh,
                               dp_axis: str = "dp", tp_axis: str = "tp",
                               level: Optional[int] = None):
    """Batched mod switch on the 2-D mesh: (B_d, size, k_t, n) ->
    (B_d, size, k_t', n)."""
    limbs = _Limbs.of(context, context.first_level if level is None
                      else level, mesh, tp_axis)

    def run(data: torch.Tensor) -> torch.Tensor:
        return _limb_mod_switch(data, limbs, mesh, tp_axis)

    return _runner(run)


# --------------------------------------------------------------------------
# app layer
# --------------------------------------------------------------------------

def sharded_app_matmul(ev, mesh: Mesh, a2d, w2d, axis_name: str = "dp"):
    """The app layer's coefficient-packed ct x pt matmul with its
    batch-block tile axis split over the mesh: from the whole input grid
    ``a2d`` (helper.encrypt_inputs) and the weights ``w2d``
    (helper.encode_weights), this rank contracts its own batch-block rows
    (P1, app/linear.py ``_run_tile_contraction``) and returns their output
    rows as a Cipher2d (empty where it holds none); no collective."""
    from ..app import linear as lin

    rows = shard_range(len(a2d.data), mesh.size(axis_name),
                       mesh.index(axis_name))
    if not len(rows):
        return lin.Cipher2d([])
    return lin._run_tile_contraction(ev, a2d, w2d, transpose_ct=False,
                                     transpose_pt=False, transpose_out=False,
                                     rows=rows)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def _rank_main(fn: Callable, rank: int, world: int, backend: str,
               device: str, store_path: str, args: tuple, timeout_s: float,
               results) -> None:
    """A spawned rank: join the group, run fn(*args), report its value or
    its traceback; a failed rank exits non-zero."""
    try:
        torch.set_num_threads(1)
        init_mesh_process(rank, world, backend, device, store_path,
                          timeout_s)
        try:
            value = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:                       # reported, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, backend: str, device,
          args: Sequence = (), timeout_s: float = DEFAULT_TIMEOUT_S
          ) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` new processes of this host (the
    ``spawn`` start method: nothing is forked), as the ranks of one group
    on ``backend`` and ``device`` (every rank on the same one), and return
    their values in rank order. fn must be importable by name (a spawned
    rank imports it afresh; the package's are in parallel/spmd.py). The
    rendezvous is a FileStore in a new temporary directory, not a port.
    The kernels and the native runtime are built here first, so the ranks
    only load them. Any rank's exception is raised here with its
    traceback, after the other ranks are stopped; so is a rank that dies
    or a run that outlasts ``timeout_s`` (the ranks' collectives time out
    after it too)."""
    if torch.device(device).type == "cuda":
        native.get_lib()
        _kernels.library()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="troy_mesh_") as tmp:
        store = os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, rank, world, backend, str(device),
                                   store, tuple(args), timeout_s, results),
                             daemon=True)
                 for rank in range(world)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)


def _collect(procs, results, timeout_s: float) -> List[Any]:
    """Every rank's value, read while the ranks run (a queue is drained
    before its writers are joined)."""
    out: List[Any] = [None] * len(procs)
    pending = set(range(len(procs)))
    deadline = time.monotonic() + timeout_s
    while pending:
        try:
            rank, ok, value = results.get(timeout=1.0)
        except queue.Empty:
            dead = [r for r in sorted(pending)
                    if procs[r].exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no report")
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks {sorted(pending)} did not finish "
                                   f"within {timeout_s} s")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{value}")
        out[rank] = value
        pending.discard(rank)
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    return out
