"""Device sampling: threefry2x32 streams into RNS residues (kernel I).

The samplers of troy_tpu/rlwe.py:52-98 (``sample_uniform_rns_dev``,
``sample_cbd_dev``, ``sample_ternary_dev``, ``_lift_centered_i64``), which
draw from ``jax.random.bits(jax.random.PRNGKey(seed), shape, uint64)``.
With ``jax_threefry_partitionable`` (JAX's default) that draw is plain
threefry2x32 in a fixed layout, so this module gives the same words from
the same seed:

  * the key is (seed >> 32, seed mod 2^32) (``key_from_seed``, the
    counterpart of ``_key_from_seed``);
  * flat element idx of the draw's shape has the counter
    (idx >> 32, idx mod 2^32);
  * the word is (y0 << 32) | y1 for (y0, y1) = threefry2x32(key, counter)
    (20 rounds, JAX's rotations and key schedule).

Three samplers, each for one seed (a host integer: (k, n) out) or for a
device array of B seeds (the batched zero encryptions: (B, k, n) out):

  * ``sample_uniform_rns``: uniform residues over the tables' base, the
    Barrett reduction of 128 random bits (draw (2, k, n));
  * ``sample_cbd_rns``: centred binomial noise, the difference of two
    21-bit popcounts (draw (n,)), lifted into every limb, times t mod q_i
    for BGV;
  * ``sample_ternary_rns``: (w mod 3) - 1 (draw (n,)), lifted.

And all the randomness of one zero encryption in one launch, the same
words as those draws one by one from the same seeds:

  * ``sample_zero_sym_rns``: e (CBD, times t for BGV) from the e-seed and a
    (uniform) from the a-seed, for one seed pair or B of them, written
    into the caller's tensors (where its ciphertext wants them);
  * ``sample_zero_asym_rns``: u (ternary) and e_0 .. e_{size-1} (CBD,
    times t for BGV) from host seeds, (1 + size, k, n).

Each launches kernel I (csrc/sampling.cu) for CUDA tables and runs its
plain version, an int64 twin on masked 32-bit halves, for CPU tables. Torch
has no popcount, so the plain CBD counts bits with the SWAR steps, and
unsigned mod 3 is (hi32 + lo32) mod 3, since 2^32 = 1 mod 3.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from . import u64ops as u
from .. import _kernels
from .ntt import RnsNttTables, _col

CBD_BITS = 21
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Seeds = Union[int, torch.Tensor]


# --------------------------------------------------------------------------
# plain versions (the CPU path; on the card, the kernel's comparison)
# --------------------------------------------------------------------------

def key_from_seed(seeds: Seeds):
    """The threefry key words (seed >> 32, seed mod 2^32) of a u64 seed, or
    of an int64 tensor of seeds (u64 bit patterns) as (B, 1) columns."""
    if isinstance(seeds, int):
        return (seeds >> 32) & _M32, seeds & _M32
    s = seeds.reshape(-1, 1)
    return (s >> 32) & _M32, s & _M32


def threefry2x32_plain(k0, k1, x0: torch.Tensor, x1: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 with 20 rounds on int64 tensors holding 32-bit words;
    key words k0, k1 (ints or tensors that broadcast against x)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def random_bits_plain(seeds: Seeds, count: int, device) -> torch.Tensor:
    """The words of jax.random.bits(PRNGKey(seed), (count,), uint64):
    (count,) for one seed, (B, count) for a tensor of B seeds."""
    k0, k1 = key_from_seed(seeds)
    idx = torch.arange(count, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32_plain(k0, k1, idx >> 32, idx & _M32)
    return (y0 << 32) | y1


def _popcount21(x: torch.Tensor) -> torch.Tensor:
    """Set bits of values below 2^32 (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def cbd_plain(bits: torch.Tensor) -> torch.Tensor:
    """Centred binomial values from words: popcount of the low 21 bits
    minus popcount of the next 21 (troy_tpu/rlwe.py:71)."""
    mask = (1 << CBD_BITS) - 1
    return _popcount21(bits & mask) - _popcount21(u.shr(bits, CBD_BITS) & mask)


def ternary_plain(bits: torch.Tensor) -> torch.Tensor:
    """(w mod 3) - 1 with w unsigned (troy_tpu/rlwe.py:83)."""
    return (u.shr(bits, 32) + (bits & _M32)) % 3 - 1


def lift_centered_plain(e: torch.Tensor, t: RnsNttTables) -> torch.Tensor:
    """Small signed values (..., n) -> (..., k, n) residues (Python's floor
    mod; troy_tpu/rlwe.py:90 _lift_centered_i64)."""
    e = e.unsqueeze(-2)
    return torch.remainder(e, _col(t.q, e.dim() - 2, 1))


def _draw_shape(seeds: Seeds, t: RnsNttTables, rows: int) -> tuple:
    lead = () if isinstance(seeds, int) else (seeds.numel(),)
    return lead + (rows, t.n)


def sample_uniform_rns_plain(seeds: Seeds, t: RnsNttTables) -> torch.Tensor:
    """Plain version of kernel I1 (troy_tpu/rlwe.py:57)."""
    k, n = t.k, t.n
    bits = random_bits_plain(seeds, 2 * k * n, t.device)
    bits = bits.reshape(_draw_shape(seeds, t, 2 * k))
    L = bits.dim() - 2
    return u.barrett_reduce_128(bits[..., :k, :], bits[..., k:, :],
                                _col(t.q, L, 1), _col(t.cr_lo, L, 1),
                                _col(t.cr_hi, L, 1))


def sample_cbd_rns_plain(seeds: Seeds, t: RnsNttTables,
                         scale: Optional[int] = None) -> torch.Tensor:
    """Plain version of kernel I2 (troy_tpu/rlwe.py:71 and :90; BGV's
    noise times t, :121-122, when ``scale`` is given)."""
    e = lift_centered_plain(cbd_plain(random_bits_plain(seeds, t.n,
                                                        t.device)), t)
    if scale is None:
        return e
    w, wq = t.scalar_operand([scale] * t.k)
    L = e.dim() - 2
    return u.mul_mod_shoup(e, _col(w, L, 1), _col(wq, L, 1), _col(t.q, L, 1))


def sample_ternary_rns_plain(seeds: Seeds, t: RnsNttTables) -> torch.Tensor:
    """Plain version of kernel I3 (troy_tpu/rlwe.py:83 and :90)."""
    return lift_centered_plain(
        ternary_plain(random_bits_plain(seeds, t.n, t.device)), t)


def sample_zero_sym_plain(a_seeds: Seeds, e_seeds: Seeds, t: RnsNttTables,
                          scale: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel I's symmetric zero-encryption draw: (e, a),
    the CBD draw of the e-seeds (times ``scale``) and the uniform draw of
    the a-seeds (troy_tpu/rlwe.py:119-122)."""
    return (sample_cbd_rns_plain(e_seeds, t, scale),
            sample_uniform_rns_plain(a_seeds, t))


def sample_zero_asym_plain(u_seed: int, e_seeds: Sequence[int],
                           t: RnsNttTables, scale: Optional[int] = None
                           ) -> torch.Tensor:
    """Plain version of kernel I's public-key zero-encryption draw: u's
    ternary draw, then each e_j's CBD draw (times ``scale``), (1 + size, k,
    n) (troy_tpu/rlwe.py:316-324)."""
    return torch.stack([sample_ternary_rns_plain(u_seed, t)]
                       + [sample_cbd_rns_plain(s, t, scale) for s in e_seeds])


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

MAX_BATCH = 65535                    # the launch grid's z extent
MAX_ASYM_ROWS = 16                   # u and 15 components' e (by value)


def _seed_args(seeds: Seeds, entry: str) -> tuple:
    """(device seeds or None, host seed, batch) of one launch."""
    if isinstance(seeds, int):
        return None, seeds, 1
    _kernels.check_operand(seeds, f"{entry} seeds")
    if seeds.numel() > MAX_BATCH:
        raise ValueError(f"{entry}: {seeds.numel()} seeds, at most "
                         f"{MAX_BATCH} a launch")
    return seeds, 0, seeds.numel()


def _launch(entry: str, seeds: Seeds, t: RnsNttTables, *consts
            ) -> torch.Tensor:
    """One kernel-I launch: (k, n) for a seed, (B, k, n) for B seeds."""
    ptr, seed, batch = _seed_args(seeds, entry)
    out = torch.empty(_draw_shape(seeds, t, t.k), dtype=torch.int64,
                      device=t.device)
    _kernels.launch(entry, out.get_device(), out, ptr, seed, batch, t.k,
                    t.log_n, t.q, *consts)
    return out


def _check_seed(seed: int) -> None:
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"sampling: seed {seed} is not a u64 word")


def _on_cuda(seeds: Seeds, t: RnsNttTables) -> bool:
    """Whether to launch the kernel; the seeds checked (a draw of 2 k n
    words must count below 2^32, the threefry counter's low word)."""
    if 2 * t.k * t.n >= 1 << 32:
        raise ValueError(f"sampling: a draw of 2 x {t.k} x {t.n} words")
    if isinstance(seeds, int):
        _check_seed(seeds)
        return _kernels.on_cuda(t.q)
    if seeds.dim() != 1:
        raise ValueError(f"sampling: expected (B,) seeds, got "
                         f"{tuple(seeds.shape)}")
    return _kernels.on_cuda(seeds, t.q)


def sample_uniform_rns(seeds: Seeds, t: RnsNttTables) -> torch.Tensor:
    """Uniform residues over the tables' base from the threefry stream of
    each seed: (k, n) for one u64 seed, (B, k, n) for B seeds (kernel I1)."""
    if not _on_cuda(seeds, t):
        return sample_uniform_rns_plain(seeds, t)
    return _launch("troy_sample_uniform_rns", seeds, t, t.cr_lo, t.cr_hi)


def sample_cbd_rns(seeds: Seeds, t: RnsNttTables,
                   scale: Optional[int] = None) -> torch.Tensor:
    """Centred binomial noise lifted into every limb, times ``scale`` mod
    q_i if given (BGV's t): (k, n) or (B, k, n) (kernel I2)."""
    if not _on_cuda(seeds, t):
        return sample_cbd_rns_plain(seeds, t, scale)
    w, wq = (None, None) if scale is None else t.scalar_operand([scale] * t.k)
    return _launch("troy_sample_cbd_rns", seeds, t, w, wq)


def sample_ternary_rns(seeds: Seeds, t: RnsNttTables) -> torch.Tensor:
    """Uniform ternary {-1, 0, 1} lifted into every limb: (k, n) or
    (B, k, n) (kernel I3)."""
    if not _on_cuda(seeds, t):
        return sample_ternary_rns_plain(seeds, t)
    return _launch("troy_sample_ternary_rns", seeds, t)


def sample_zero_sym_rns(a_seeds: Seeds, e_seeds: Seeds, t: RnsNttTables,
                        scale: Optional[int], e_out: torch.Tensor,
                        a_out: torch.Tensor) -> None:
    """All the randomness of a symmetric zero encryption in one kernel-I
    launch: e (CBD from the e-seed, times ``scale`` mod q_i if given) into
    ``e_out`` and a (uniform from the a-seed) into ``a_out``, each (k, n)
    for one seed pair or (B, k, n) for device arrays of B seeds, contiguous
    (slices of the caller's ciphertext buffer); the words of
    ``sample_cbd_rns`` and ``sample_uniform_rns``."""
    if isinstance(a_seeds, int) != isinstance(e_seeds, int):
        raise ValueError("sample_zero_sym_rns: a host seed with a device "
                         "array of seeds")
    shape = _draw_shape(a_seeds, t, t.k)
    if tuple(e_out.shape) != shape or tuple(a_out.shape) != shape or (
            not isinstance(e_seeds, int)
            and e_seeds.shape != a_seeds.shape):
        raise ValueError(f"sample_zero_sym_rns: outputs {tuple(e_out.shape)}"
                         f" and {tuple(a_out.shape)} for draws {shape}")
    on_cuda = _on_cuda(a_seeds, t)
    if on_cuda != _on_cuda(e_seeds, t) or on_cuda != _kernels.on_cuda(
            e_out, a_out, t.q):
        raise ValueError("sample_zero_sym_rns: seeds, outputs and tables "
                         "on different devices")
    if not on_cuda:
        e, a = sample_zero_sym_plain(a_seeds, e_seeds, t, scale)
        e_out.copy_(e)
        a_out.copy_(a)
        return
    _kernels.check_operand(e_out, "sample_zero_sym_rns e_out")
    _kernels.check_operand(a_out, "sample_zero_sym_rns a_out")
    a_ptr, a_seed, batch = _seed_args(a_seeds, "troy_sample_zero_sym")
    e_ptr, e_seed, _ = _seed_args(e_seeds, "troy_sample_zero_sym")
    w, wq = (None, None) if scale is None else t.scalar_operand([scale] * t.k)
    _kernels.launch("troy_sample_zero_sym", e_out.get_device(), e_out, a_out,
                    a_ptr, a_seed, e_ptr, e_seed, batch, t.k, t.log_n, t.q,
                    t.cr_lo, t.cr_hi, w, wq)


def sample_zero_asym_rns(u_seed: int, e_seeds: Sequence[int],
                         t: RnsNttTables, scale: Optional[int] = None
                         ) -> torch.Tensor:
    """All the randomness of a public-key zero encryption in one kernel-I
    launch: (1 + size, k, n), u (ternary, from u_seed) then e_j (CBD, from
    e_seeds[j], times ``scale`` mod q_i if given); the words of
    ``sample_ternary_rns`` and ``sample_cbd_rns``. The seeds are host
    words, passed in the launch's parameters (at most 16 rows)."""
    seeds = [int(u_seed)] + [int(s) for s in e_seeds]
    for s in seeds:
        _check_seed(s)
    if not 2 <= len(seeds) <= MAX_ASYM_ROWS:
        raise ValueError(f"sample_zero_asym_rns: {len(seeds) - 1} "
                         f"components, 1 to {MAX_ASYM_ROWS - 1}")
    if not _on_cuda(seeds[0], t):
        return sample_zero_asym_plain(seeds[0], seeds[1:], t, scale)
    out = torch.empty((len(seeds), t.k, t.n), dtype=torch.int64,
                      device=t.device)
    w, wq = (None, None) if scale is None else t.scalar_operand([scale] * t.k)
    _kernels.launch("troy_sample_zero_asym", out.get_device(), out,
                    (ctypes.c_ulonglong * len(seeds))(*seeds), len(seeds),
                    t.k, t.log_n, t.q, w, wq)
    return out
