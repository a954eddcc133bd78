// Native host runtime of troy_tpu_torch: XOF expansion, CRT composition
// and the NTT table precompute. A copy of troy_tpu/native/src/
// troy_native.cpp, kept in the port so that the port needs nothing of the
// JAX package; the two must stay word-for-word equal in what they compute
// (tests/test_torch_native.py holds them to each other).
//
// The reference keeps its host runtime in C++ (memory pools, serialization,
// PRNG buffering — src/randomgen.cpp, src/utils/rns.cpp compose); this is
// the port's equivalent for the host-side hot paths:
//   * blake2xb-style XOF stream expansion (bit-exact with
//     troy_tpu_torch.prng, which builds on hashlib's RFC 7693 blake2b),
//     feeding the RLWE samplers of host keygen;
//   * multiword CRT composition (residues -> centered big integers ->
//     doubles), the CKKS host decode (reference rns.cpp composeArray);
//   * the NTT root tables and the 4-step factor matrices of kernel J.
//
// Built on demand with g++ (troy_tpu_torch/native/__init__.py); the Python
// layer falls back to pure-Python implementations when no toolchain is
// present.

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

// ---------------------------------------------------------------------------
// blake2b (RFC 7693), sequential mode, with key and node_offset support.
// ---------------------------------------------------------------------------

static const uint64_t B2B_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
    0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

static const uint8_t B2B_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

static inline uint64_t rotr64(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

struct B2BState {
    uint64_t h[8];
    uint64_t t0, t1;
    uint8_t buf[128];
    size_t buflen;
};

static void b2b_compress(B2BState* s, const uint8_t* block, int last) {
    uint64_t v[16], m[16];
    for (int i = 0; i < 8; i++) v[i] = s->h[i];
    for (int i = 0; i < 8; i++) v[i + 8] = B2B_IV[i];
    v[12] ^= s->t0;
    v[13] ^= s->t1;
    if (last) v[14] = ~v[14];
    for (int i = 0; i < 16; i++) {
        uint64_t w = 0;
        memcpy(&w, block + 8 * i, 8);     // little-endian host assumed
        m[i] = w;
    }
#define B2B_G(a, b, c, d, x, y)                      \
    v[a] = v[a] + v[b] + (x); v[d] = rotr64(v[d] ^ v[a], 32); \
    v[c] = v[c] + v[d];       v[b] = rotr64(v[b] ^ v[c], 24); \
    v[a] = v[a] + v[b] + (y); v[d] = rotr64(v[d] ^ v[a], 16); \
    v[c] = v[c] + v[d];       v[b] = rotr64(v[b] ^ v[c], 63)
    for (int r = 0; r < 12; r++) {
        const uint8_t* g = B2B_SIGMA[r];
        B2B_G(0, 4, 8, 12, m[g[0]], m[g[1]]);
        B2B_G(1, 5, 9, 13, m[g[2]], m[g[3]]);
        B2B_G(2, 6, 10, 14, m[g[4]], m[g[5]]);
        B2B_G(3, 7, 11, 15, m[g[6]], m[g[7]]);
        B2B_G(0, 5, 10, 15, m[g[8]], m[g[9]]);
        B2B_G(1, 6, 11, 12, m[g[10]], m[g[11]]);
        B2B_G(2, 7, 8, 13, m[g[12]], m[g[13]]);
        B2B_G(3, 4, 9, 14, m[g[14]], m[g[15]]);
    }
#undef B2B_G
    for (int i = 0; i < 8; i++) s->h[i] ^= v[i] ^ v[i + 8];
}

// Full BLAKE2b parameter-block init (RFC 7693 / BLAKE2X layout:
// node_offset is 4 bytes with xof_length in the following 4).
static void b2b_init_param(B2BState* s, size_t digest_len, const uint8_t* key,
                           size_t key_len, uint8_t fanout, uint8_t depth,
                           uint32_t leaf_len, uint32_t node_offset,
                           uint32_t xof_len, uint8_t node_depth,
                           uint8_t inner_len) {
    uint8_t p[64];
    memset(p, 0, sizeof(p));
    p[0] = (uint8_t)digest_len;
    p[1] = (uint8_t)key_len;
    p[2] = fanout;
    p[3] = depth;
    memcpy(p + 4, &leaf_len, 4);
    memcpy(p + 8, &node_offset, 4);
    memcpy(p + 12, &xof_len, 4);
    p[16] = node_depth;
    p[17] = inner_len;
    for (int i = 0; i < 8; i++) {
        uint64_t w = 0;
        memcpy(&w, p + 8 * i, 8);
        s->h[i] = B2B_IV[i] ^ w;
    }
    s->t0 = s->t1 = 0;
    s->buflen = 0;
    if (key_len > 0) {
        uint8_t kb[128];
        memset(kb, 0, sizeof(kb));
        memcpy(kb, key, key_len);
        memcpy(s->buf, kb, 128);
        s->buflen = 128;
    }
}

static void b2b_update(B2BState* s, const uint8_t* in, size_t len) {
    while (len > 0) {
        if (s->buflen == 128) {
            s->t0 += 128;
            if (s->t0 < 128) s->t1++;
            b2b_compress(s, s->buf, 0);
            s->buflen = 0;
        }
        size_t take = 128 - s->buflen;
        if (take > len) take = len;
        memcpy(s->buf + s->buflen, in, take);
        s->buflen += take;
        in += take;
        len -= take;
    }
}

static void b2b_final(B2BState* s, uint8_t* out, size_t digest_len) {
    s->t0 += (uint64_t)s->buflen;
    if (s->t0 < (uint64_t)s->buflen) s->t1++;
    memset(s->buf + s->buflen, 0, 128 - s->buflen);
    b2b_compress(s, s->buf, 1);
    uint8_t full[64];
    memcpy(full, s->h, 64);
    memcpy(out, full, digest_len);
}

// BLAKE2Xb exactly per the upstream BLAKE2X reference (and therefore
// bit-identical to the reference library's host PRNG, blake2xb.c):
//   root: keyed blake2b-512, fanout=1 depth=1, xof_length=out_len
//   block i: blake2b(root), digest=min(64, rem), fanout=0 depth=0,
//            leaf_length=64, node_offset=i, xof_length=out_len, inner=64
static void blake2xb(const uint8_t* data, size_t data_len, const uint8_t* key,
                     size_t key_len, uint8_t* out, uint64_t out_len) {
    uint8_t h0[64];
    B2BState s;
    b2b_init_param(&s, 64, key, key_len, 1, 1, 0, 0, (uint32_t)out_len, 0, 0);
    b2b_update(&s, data, data_len);
    b2b_final(&s, h0, 64);
    uint64_t i = 0;
    uint64_t rem = out_len;
    while (rem > 0) {
        size_t blk = rem < 64 ? (size_t)rem : 64;
        B2BState bs;
        b2b_init_param(&bs, blk, nullptr, 0, 0, 0, 64, (uint32_t)i,
                       (uint32_t)out_len, 0, 64);
        b2b_update(&bs, h0, 64);
        b2b_final(&bs, out, blk);
        out += blk;
        rem -= blk;
        i++;
    }
}

// The buffered stream: 4096-byte refills keyed by a block counter
// (troy_tpu.prng.UniformRandomGenerator._refill_block). Fills `nbytes`
// starting at stream block `counter0` (byte offset counter0*4096).
void xof_fill(const uint8_t* seed64, uint64_t counter0, uint8_t* out,
              uint64_t nbytes) {
    uint64_t counter = counter0;
    while (nbytes > 0) {
        uint8_t ctr_le[8];
        memcpy(ctr_le, &counter, 8);
        uint64_t take = nbytes < 4096 ? nbytes : 4096;
        if (take == 4096) {
            blake2xb(ctr_le, 8, seed64, 64, out, 4096);
        } else {
            uint8_t tmp[4096];
            blake2xb(ctr_le, 8, seed64, 64, tmp, 4096);
            memcpy(out, tmp, take);
        }
        out += take;
        nbytes -= take;
        counter++;
    }
}

// ---------------------------------------------------------------------------
// Multiword CRT composition (reference rns.cpp composeArray analogue).
// ---------------------------------------------------------------------------

typedef unsigned __int128 u128;

// acc (w+1 words) += a * b (b: w words), little-endian u64 words
static inline void mul_acc_word(uint64_t* acc, const uint64_t* b, uint64_t a,
                                size_t w) {
    uint64_t carry = 0;
    for (size_t i = 0; i < w; i++) {
        u128 p = (u128)a * b[i] + acc[i] + carry;
        acc[i] = (uint64_t)p;
        carry = (uint64_t)(p >> 64);
    }
    acc[w] += carry;
}

static inline int cmp_words(const uint64_t* a, const uint64_t* b, size_t w) {
    for (size_t i = w; i-- > 0;) {
        if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    }
    return 0;
}

static inline void sub_words(uint64_t* a, const uint64_t* b, size_t w) {
    uint64_t borrow = 0;
    for (size_t i = 0; i < w; i++) {
        uint64_t bi = b[i] + borrow;
        borrow = (bi < borrow) || (a[i] < bi);
        a[i] = a[i] - bi;
    }
}

static inline uint64_t mulmod_shoup(uint64_t x, uint64_t y, uint64_t y_shoup,
                                    uint64_t q) {
    uint64_t hi = (uint64_t)(((u128)x * y_shoup) >> 64);
    uint64_t r = x * y - hi * q;
    return r >= q ? r - q : r;
}

// residues: (k, n) row-major; punctured: (k, w); Q: (w); out: (n) doubles,
// centered mod Q and multiplied by inv_scale.
void crt_compose_centered_double(
        const uint64_t* residues, uint64_t k, uint64_t n,
        const uint64_t* moduli, const uint64_t* inv_punctured,
        const uint64_t* inv_punctured_shoup, const uint64_t* punctured,
        const uint64_t* Q, uint64_t w, double inv_scale, double* out) {
    uint64_t* acc = new uint64_t[w + 1];
    uint64_t* half = new uint64_t[w + 1];
    // half = Q / 2 (Q occupies w words; acc uses w+1 to absorb the k sums)
    uint64_t carry = 0;
    for (size_t i = w; i-- > 0;) {
        uint64_t cur = Q[i];
        half[i] = (cur >> 1) | (carry << 63);
        carry = cur & 1;
    }
    half[w] = 0;
    uint64_t* Qw = new uint64_t[w + 1];
    memcpy(Qw, Q, w * 8);
    Qw[w] = 0;

    for (uint64_t c = 0; c < n; c++) {
        memset(acc, 0, (w + 1) * 8);
        for (uint64_t i = 0; i < k; i++) {
            uint64_t r = residues[i * n + c];
            uint64_t t = mulmod_shoup(r, inv_punctured[i],
                                      inv_punctured_shoup[i], moduli[i]);
            mul_acc_word(acc, punctured + i * w, t, w);
        }
        // reduce mod Q by repeated subtraction (acc < k*Q, k small)
        while (cmp_words(acc, Qw, w + 1) >= 0) sub_words(acc, Qw, w + 1);
        int negative = cmp_words(acc, half, w + 1) > 0;
        if (negative) {
            // value - Q  (compute Q - acc, then negate the double)
            uint64_t* tmp = new uint64_t[w + 1];
            memcpy(tmp, Qw, (w + 1) * 8);
            sub_words(tmp, acc, w + 1);
            double v = 0.0, p = 1.0;
            for (size_t i = 0; i < w + 1; i++) {
                v += (double)tmp[i] * p;
                p *= 18446744073709551616.0;
            }
            out[c] = -v * inv_scale;
            delete[] tmp;
        } else {
            double v = 0.0, p = 1.0;
            for (size_t i = 0; i < w + 1; i++) {
                v += (double)acc[i] * p;
                p *= 18446744073709551616.0;
            }
            out[c] = v * inv_scale;
        }
    }
    delete[] acc;
    delete[] half;
    delete[] Qw;
}

// mul_acc_word overflows into the top word only while accumulating; the
// caller guarantees k*Q < 2^(64*(w+1)).

// ---------------------------------------------------------------------------
// Table precompute engine (reference ntt.cpp CreateNTTTables / our MXU
// 4-step factor matrices). The Python paths in utils/ntt_tables.py and
// ops/ntt_mxu.py stay as the bit-exact oracles; these fill the same
// tables ~100x faster at context-construction time.
// ---------------------------------------------------------------------------

static inline uint64_t mulmod_q(uint64_t a, uint64_t b, uint64_t q) {
    return (uint64_t)(((u128)a * b) % q);
}

static inline uint64_t shoup_q(uint64_t w, uint64_t q) {
    return (uint64_t)((((u128)w) << 64) / q);
}

static inline uint64_t powmod_q(uint64_t base, uint64_t e, uint64_t q) {
    uint64_t r = 1 % q;
    base %= q;
    while (e) {
        if (e & 1) r = mulmod_q(r, base, q);
        base = mulmod_q(base, base, q);
        e >>= 1;
    }
    return r;
}

static inline uint64_t brv_u64(uint64_t x, int bits) {
    uint64_t r = 0;
    for (int i = 0; i < bits; i++) {
        r = (r << 1) | (x & 1);
        x >>= 1;
    }
    return r;
}

// Bit-reversed-scatter power tables + Shoup quotients
// (utils/ntt_tables.py make_ntt_tables loop; reference ntt.cpp layout
// root_powers[brv(k)] = root^k).
void ntt_tables_fill(uint64_t n, uint64_t q, uint64_t root,
                     uint64_t inv_root, uint64_t* powers,
                     uint64_t* powers_shoup, uint64_t* inv_powers,
                     uint64_t* inv_powers_shoup) {
    int log_n = 0;
    while ((1ULL << log_n) < n) log_n++;
    uint64_t acc = 1, iacc = 1;
    for (uint64_t k = 0; k < n; k++) {
        uint64_t b = brv_u64(k, log_n);
        powers[b] = acc;
        inv_powers[b] = iacc;
        acc = mulmod_q(acc, root, q);
        iacc = mulmod_q(iacc, inv_root, q);
    }
    for (uint64_t i = 0; i < n; i++) {
        powers_shoup[i] = shoup_q(powers[i], q);
        inv_powers_shoup[i] = shoup_q(inv_powers[i], q);
    }
}

// 4-step factor matrices for n = A*B (ops/ntt_mxu.py make_mxu_tables_host):
//   w1 (A,A), tw (A,B), w2 (B,B), v1 (A,A), itw (A,B), v2 (B,B), plus
//   Shoup quotients for the twiddle grids. psi = minimal 2n-th root.
void mxu_tables_fill(uint64_t n, uint64_t A, uint64_t B, uint64_t q,
                     uint64_t psi,
                     uint64_t* w1, uint64_t* tw, uint64_t* w2,
                     uint64_t* v1, uint64_t* itw, uint64_t* v2,
                     uint64_t* tw_shoup, uint64_t* itw_shoup) {
    int log_a = 0, log_b = 0;
    while ((1ULL << log_a) < A) log_a++;
    while ((1ULL << log_b) < B) log_b++;
    uint64_t omega = mulmod_q(psi, psi, q);
    uint64_t inv_psi = powmod_q(psi, q - 2, q);
    uint64_t inv_omega = powmod_q(omega, q - 2, q);
    uint64_t inv_a = powmod_q(A % q, q - 2, q);
    uint64_t inv_b = powmod_q(B % q, q - 2, q);

    uint64_t* om = new uint64_t[n];
    uint64_t* iom = new uint64_t[n];
    uint64_t* ps = new uint64_t[2 * n];
    uint64_t* ips = new uint64_t[2 * n];
    om[0] = iom[0] = ps[0] = ips[0] = 1;
    for (uint64_t i = 1; i < n; i++) {
        om[i] = mulmod_q(om[i - 1], omega, q);
        iom[i] = mulmod_q(iom[i - 1], inv_omega, q);
    }
    for (uint64_t i = 1; i < 2 * n; i++) {
        ps[i] = mulmod_q(ps[i - 1], psi, q);
        ips[i] = mulmod_q(ips[i - 1], inv_psi, q);
    }

    for (uint64_t p1 = 0; p1 < A; p1++) {
        uint64_t r = brv_u64(p1, log_a);
        for (uint64_t a = 0; a < A; a++)
            w1[p1 * A + a] = mulmod_q(om[(B * a % n) * r % n],
                                      ps[a * B % (2 * n)], q);
        for (uint64_t b = 0; b < B; b++) {
            tw[p1 * B + b] = mulmod_q(ps[b], om[b * r % n], q);
            itw[p1 * B + b] = mulmod_q(ips[b], iom[b * r % n], q);
            tw_shoup[p1 * B + b] = shoup_q(tw[p1 * B + b], q);
            itw_shoup[p1 * B + b] = shoup_q(itw[p1 * B + b], q);
        }
    }
    for (uint64_t p2 = 0; p2 < B; p2++) {
        uint64_t r = brv_u64(p2, log_b);
        for (uint64_t b = 0; b < B; b++) {
            w2[b * B + p2] = om[(A * b % n) * r % n];
            v2[p2 * B + b] = mulmod_q(inv_b, iom[(A * b % n) * r % n], q);
        }
    }
    for (uint64_t a = 0; a < A; a++) {
        uint64_t row = mulmod_q(inv_a, ips[a * B % (2 * n)], q);
        for (uint64_t p1 = 0; p1 < A; p1++) {
            uint64_t r = brv_u64(p1, log_a);
            v1[a * A + p1] = mulmod_q(row, iom[(B * a % n) * r % n], q);
        }
    }
    delete[] om;
    delete[] iom;
    delete[] ps;
    delete[] ips;
}

// Signed radix-256 digit planes (ops/ntt_mxu.py _signed_digits_host):
// out[d*count + i] = digit d of mat[i], digits in [-128, 127].
// Returns 0 on success, 1 if any value needs a 9th digit (a final carry
// out of digit 7, i.e. value >= 0x7F80...80 territory) — mirroring the
// Python oracle's assertion instead of silently corrupting planes.
int signed_digits_fill(const uint64_t* mat, uint64_t count, int8_t* out) {
    int overflow = 0;
    for (uint64_t i = 0; i < count; i++) {
        uint64_t rem = mat[i];
        int carry = 0;
        for (int d = 0; d < 8; d++) {
            int v = (int)(rem & 0xFF) + carry;
            carry = v >= 128;
            if (carry) v -= 256;
            out[(uint64_t)d * count + i] = (int8_t)v;
            rem >>= 8;
        }
        overflow |= carry;
    }
    return overflow;
}

}  // extern "C"
