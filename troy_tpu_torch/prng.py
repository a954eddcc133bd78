"""Deterministic seeded PRNG streams and RLWE noise samplers (host side).

Semantics-compatible with the reference's randomness layer
(reference: src/randomgen.h:24-617 blake2xb/shake256 buffered streams;
src/utils/rlwe.h:25-58 samplers). Unlike the reference's GPU path — which
uses curand and therefore cannot reproduce its own host path
(rlwe_cuda.cu:34-151) — every sampler here is a pure function of a 512-bit
seed + counter, so keygen/encryption are bit-reproducible everywhere.

blake2xb is implemented exactly per the BLAKE2X specification on top of
hashlib.blake2b; shake256 uses hashlib's native SHAKE-256 XOF. Buffers are
produced in 4 KiB refills keyed by a block counter, mirroring the
reference's buffered generator (randomgen.h:309-388).
"""

from __future__ import annotations

import enum
import hashlib
import secrets
import struct as _struct
from typing import Optional, Sequence, Tuple

import numpy as np

from . import native

PRNG_SEED_BYTES = 64          # 512-bit seeds (randomgen.h prng_seed_uint64_count=8)
_BUFFER_SIZE = 4096


class PrngType(enum.IntEnum):
    """(randomgen.h:24-31)"""
    unknown = 0
    blake2xb = 1
    shake256 = 2


# --------------------------------------------------------------------------
# BLAKE2Xb, bit-exact with the reference's blake2xb.c (the upstream BLAKE2X
# reference implementation). The root hash is expressible through hashlib
# (fanout=1/depth=1 with xof_length packed into node_offset's high word);
# the expansion blocks use BLAKE2X's fanout=0/depth=0 leaf parameters,
# which hashlib rejects, so they run through a single-shot pure-Python
# blake2b compression, or through the native runtime's xof_fill
# (native/src/troy_native.cpp), which gives the same bytes.
# --------------------------------------------------------------------------

_B2B_IV = (
    0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
    0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
    0x1f83d9abfb41bd6b, 0x5be0cd19137e2179)

_B2B_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3))

_M64 = (1 << 64) - 1


def _b2b_expand_block(root: bytes, digest_len: int, index: int,
                      xof_len: int) -> bytes:
    """One BLAKE2X expansion block: blake2b of the 64-byte root with the
    leaf parameter block (digest=digest_len, fanout=0, depth=0,
    leaf_length=64, node_offset=index, xof_length=xof_len, inner=64) —
    a single compression, computed in pure Python."""
    param = bytearray(64)
    param[0] = digest_len
    param[2] = 0                           # fanout
    param[3] = 0                           # depth
    param[4:8] = (64).to_bytes(4, "little")        # leaf_length
    param[8:12] = index.to_bytes(4, "little")      # node_offset
    param[12:16] = xof_len.to_bytes(4, "little")   # xof_length
    param[17] = 64                         # inner_length
    pw = _struct.unpack("<8Q", bytes(param))
    h = [_B2B_IV[j] ^ pw[j] for j in range(8)]

    block = root + bytes(64)               # 64-byte message, zero-padded
    m = _struct.unpack("<16Q", block)
    v = h + list(_B2B_IV)
    v[12] ^= 64                            # t0 = message length
    v[14] = ~v[14] & _M64                  # last block
    for r in range(12):
        g = _B2B_SIGMA[r]
        for gi, (a, b, c, d) in enumerate(((0, 4, 8, 12), (1, 5, 9, 13),
                                           (2, 6, 10, 14), (3, 7, 11, 15),
                                           (0, 5, 10, 15), (1, 6, 11, 12),
                                           (2, 7, 8, 13), (3, 4, 9, 14))):
            x, y = m[g[2 * gi]], m[g[2 * gi + 1]]
            v[a] = (v[a] + v[b] + x) & _M64
            v[d] = ((v[d] ^ v[a]) >> 32 | (v[d] ^ v[a]) << 32) & _M64
            v[c] = (v[c] + v[d]) & _M64
            v[b] = ((v[b] ^ v[c]) >> 24 | (v[b] ^ v[c]) << 40) & _M64
            v[a] = (v[a] + v[b] + y) & _M64
            v[d] = ((v[d] ^ v[a]) >> 16 | (v[d] ^ v[a]) << 48) & _M64
            v[c] = (v[c] + v[d]) & _M64
            v[b] = ((v[b] ^ v[c]) >> 63 | (v[b] ^ v[c]) << 1) & _M64
    out = _struct.pack("<8Q", *[(h[j] ^ v[j] ^ v[j + 8]) & _M64
                                for j in range(8)])
    return out[:digest_len]


def _blake2xb(data: bytes, out_len: int, key: bytes = b"") -> bytes:
    """BLAKE2Xb exactly per the reference implementation
    (src/utils/blake2xb.c): root = keyed blake2b-512 with
    xof_length=out_len in the parameter block, then per-block leaf
    finalizations. Bit-identical to the reference's host PRNG stream —
    unlike its GPU path, which is curand (rlwe_cuda.cu:34-151)."""
    if not 0 < out_len < (1 << 32):
        raise ValueError("out_len out of range")
    h0 = hashlib.blake2b(data, digest_size=64, key=key, fanout=1, depth=1,
                         leaf_size=0, node_offset=out_len << 32,
                         node_depth=0, inner_size=0).digest()
    out = bytearray()
    i = 0
    remaining = out_len
    while remaining > 0:
        block_len = min(64, remaining)
        out += _b2b_expand_block(h0, block_len, i, out_len)
        remaining -= block_len
        i += 1
    return bytes(out)


class UniformRandomGenerator:
    """Buffered XOF stream: refill(counter) -> 4096 bytes
    (randomgen.h:309-388 / blake2xb PRNG :483-545, shake256 :553-611)."""

    def __init__(self, seed: bytes, prng_type: PrngType = PrngType.blake2xb):
        if len(seed) != PRNG_SEED_BYTES:
            raise ValueError(f"seed must be {PRNG_SEED_BYTES} bytes")
        self._seed = seed
        self._type = prng_type
        self._counter = 0
        self._buffer = b""
        self._offset = 0

    @property
    def seed(self) -> bytes:
        return self._seed

    @property
    def prng_type(self) -> PrngType:
        return self._type

    def _refill_block(self, counter: int) -> bytes:
        if self._type == PrngType.blake2xb:
            return _blake2xb(_struct.pack("<Q", counter), _BUFFER_SIZE,
                             key=self._seed)
        elif self._type == PrngType.shake256:
            return hashlib.shake_256(
                self._seed + _struct.pack("<Q", counter)).digest(_BUFFER_SIZE)
        raise ValueError("unknown PRNG type")

    def _blocks(self, count: int) -> bytes:
        """``count`` refills from the current counter on: BLAKE2Xb through
        the native runtime's ``xof_fill`` in one call when it loads (the
        same bytes), else block by block."""
        if self._type == PrngType.blake2xb:
            chunk = native.xof_fill(self._seed, self._counter,
                                    count * _BUFFER_SIZE)
            if chunk is not None:
                return chunk
        return b"".join(self._refill_block(self._counter + i)
                        for i in range(count))

    def generate(self, byte_count: int) -> bytes:
        out = bytearray()
        while byte_count > 0:
            if self._offset >= len(self._buffer):
                whole = byte_count // _BUFFER_SIZE
                if whole:
                    # whole blocks go straight out, in one native call
                    out += self._blocks(whole)
                    self._counter += whole
                    byte_count -= whole * _BUFFER_SIZE
                    continue
                self._buffer = self._blocks(1)
                self._counter += 1
                self._offset = 0
            take = min(byte_count, len(self._buffer) - self._offset)
            out += self._buffer[self._offset:self._offset + take]
            self._offset += take
            byte_count -= take
        return bytes(out)

    def next_uint64(self) -> int:
        return _struct.unpack("<Q", self.generate(8))[0]

    def uint64_array(self, count: int) -> np.ndarray:
        return np.frombuffer(self.generate(8 * count), dtype="<u8").copy()


class RandomGeneratorFactory:
    """Factory with an optional fixed default seed (randomgen.h:390-478)."""

    def __init__(self, prng_type: PrngType = PrngType.blake2xb,
                 default_seed: Optional[bytes] = None):
        self._type = prng_type
        self._default_seed = default_seed

    @classmethod
    def default_factory(cls) -> "RandomGeneratorFactory":
        return cls(PrngType.blake2xb)

    def use_random_seed(self) -> bool:
        return self._default_seed is None

    def create(self, seed: Optional[bytes] = None) -> UniformRandomGenerator:
        if seed is None:
            seed = self._default_seed
        if seed is None:
            seed = secrets.token_bytes(PRNG_SEED_BYTES)
        return UniformRandomGenerator(seed, self._type)


def seed_from_uint64(*words: int) -> bytes:
    """Build a 512-bit seed from up to 8 uint64 words (zero-padded)."""
    if len(words) > 8:
        raise ValueError("at most 8 seed words")
    padded = list(words) + [0] * (8 - len(words))
    return _struct.pack("<8Q", *padded)


# --------------------------------------------------------------------------
# RLWE samplers (host oracles; reference src/utils/rlwe.h:25-58).
# All return numpy int64 arrays of *centered* values; the device lift to RNS
# residues happens in the callers.
# --------------------------------------------------------------------------

NOISE_STANDARD_DEVIATION = 3.2          # globals.h:31-37
NOISE_MAX_DEVIATION = 6 * 3.2
_CBD_BITS = 21                          # per side; Var = 2*21/4 -> sigma 3.24


def sample_poly_ternary(prng: UniformRandomGenerator, n: int) -> np.ndarray:
    """Uniform ternary {-1, 0, 1} secret/encapsulation polynomial with the
    reference's exact draw order (rlwe.cpp:21-41 samplePolyTernary):
    std::uniform_int_distribution<uint64_t>(0, 2) over the 32-bit
    RandomToStandardAdapter — one u32 per coefficient, 0xFFFFFFFF
    rejected, result = draw / 0x55555555 (the libstdc++ downscaling)."""
    scaling = 0xFFFFFFFF // 3                 # 1431655765
    past = 3 * scaling                        # 4294967295: only max rejected
    draws = np.frombuffer(prng.generate(4 * n), dtype="<u4")
    if not (draws == np.uint32(past)).any():
        # vectorized fast path (rejection probability is n * 2^-32)
        return (draws // np.uint32(scaling)).astype(np.int64) - 1
    # exact sequential replay: on a rejection the reference takes the NEXT
    # u32 for the same coefficient, shifting every later draw by one. The
    # byte stream is chunking-invariant, so treat the prefetched block as
    # a FIFO and extend it one u32 at a time as the reference would.
    queue = list(draws)
    out = np.empty(n, dtype=np.int64)
    for i in range(n):
        while True:
            r = queue.pop(0) if queue \
                else _struct.unpack("<I", prng.generate(4))[0]
            if r < past:
                break
        out[i] = r // scaling
    return out - 1   # {0,1,2} -> {-1,0,1}


def sample_poly_cbd(prng: UniformRandomGenerator, n: int) -> np.ndarray:
    """Centered binomial noise, sigma ~= 3.2, with the reference's exact
    byte draws (rlwe.cpp:70-106 samplePolyCbd): 6 bytes per coefficient,
    value = wt(x0)+wt(x1)+wt(x2 & 0x1F) - wt(x3)-wt(x4)-wt(x5 & 0x1F)."""
    raw = np.frombuffer(prng.generate(6 * n), dtype=np.uint8).reshape(n, 6)
    raw = raw.copy()
    raw[:, 2] &= 0x1F
    raw[:, 5] &= 0x1F
    w = np.bitwise_count(raw).astype(np.int64)
    return w[:, 0] + w[:, 1] + w[:, 2] - w[:, 3] - w[:, 4] - w[:, 5]


def sample_poly_normal(prng: UniformRandomGenerator, n: int) -> np.ndarray:
    """Clipped discrete Gaussian, sigma = 3.2, |x| <= 6 sigma
    (clipnormal.h semantics, Box-Muller on XOF uniforms)."""
    out = np.zeros(n, dtype=np.int64)
    filled = 0
    while filled < n:
        m = n - filled
        u1 = prng.uint64_array(m).astype(np.float64) / 2.0 ** 64
        u2 = prng.uint64_array(m).astype(np.float64) / 2.0 ** 64
        u1 = np.maximum(u1, 1e-300)
        g = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
        v = g * NOISE_STANDARD_DEVIATION
        ok = np.abs(v) <= NOISE_MAX_DEVIATION
        vals = np.rint(v[ok]).astype(np.int64)
        take = min(len(vals), m)
        out[filled:filled + take] = vals[:take]
        filled += take
    return out


def sample_poly_uniform(prng: UniformRandomGenerator, n: int,
                        moduli: Sequence[int]) -> np.ndarray:
    """Uniform element of R_q with the reference's exact draw order
    (rlwe.cpp:122-151 samplePolyUniform): one bulk k*n*8-byte fill, then
    per limb, coefficient-order rejection (redraw 8 bytes while
    v >= 2^64-1 - ((2^64-1) mod q) - 1) and a Barrett reduction mod q.
    Returns (k, n) uint64 residues."""
    k = len(moduli)
    vals = np.frombuffer(prng.generate(8 * k * n), dtype="<u8").reshape(k, n)
    out = np.zeros((k, n), dtype=np.uint64)
    max_random = (1 << 64) - 1
    for j, q in enumerate(moduli):
        max_multiple = max_random - (max_random % q) - 1
        row = vals[j]
        rejected = np.flatnonzero(row >= np.uint64(max_multiple))
        if len(rejected):
            row = row.copy()
            for i in rejected:
                r = int(row[i])
                while r >= max_multiple:
                    r = _struct.unpack("<Q", prng.generate(8))[0]
                row[i] = r
        out[j] = row % np.uint64(q)
    return out


def centered_to_rns(values: np.ndarray, moduli: Sequence[int]) -> np.ndarray:
    """Lift a centered int64 polynomial to RNS residues: (n,) -> (k, n)."""
    k = len(moduli)
    out = np.zeros((k, len(values)), dtype=np.uint64)
    for i, q in enumerate(moduli):
        # numpy % follows Python sign semantics: negative inputs map to [0, q)
        out[i] = (values % q).astype(np.uint64)
    return out
