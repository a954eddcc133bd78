#!/usr/bin/env python3
"""Drive troy_tpu_torch's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Three configurations of troy's own timing test (test/timetest.cu),
128-bit security, n = 16384, q = {60,40,40,40,40,60}: BFV with
t = PlainModulus.batching(n, 20), CKKS at scale 2^40, and BGV with the
same t; troy's app benchmark (test/app/linear.cu:575-584), BFV and BGV
at n = 16384, q = {60,60,60}, t = 2^41; and the large rings (kernel A up
to n = 131072, kernel J above, ops/ntt.py MAX_KERNEL_N): SEAL's n = 32768
BFV chain, a 16-prime CKKS chain at n = 32768, and BFV
at n = 131072 and 262144; troy's own Python entry point, its pybind11
binder's scripts (binder/test.py, binder/timetest.py) through the port's
binder API, with its raw wire; and the multi-device regimes on
torch.distributed in ranks sharing the card; and the port's oracle suites
(troy's C++ fixtures, the fuzz sequences, the narrow BEHZ base, CKKS
precision against depth). Phases, in order (36, then 35, run between 32
and 33); any failure raises and the script exits non-zero without a
result line:

1. device: require CUDA; print the card, its power limit, torch and CUDA;
2. build the native host runtime (troy_tpu_torch/native, g++; the run
   fails if it does not load) and the CUDA kernels from
   troy_tpu_torch/csrc with nvcc (sm_90a), one nvcc per source, all at
   once, and print the build seconds and each kernel's registers and
   spills (-Xptxas -v);
3. each BFV-path kernel (A NTT, B dyadic MAC (also its convolution over
   q u Bsk and q, a square, the decrypt's sum with c0 and the powers' level
   rows in place, decrypt_many's, and the key switch one level down with
   the key's rows in place), C base conversion, D RNS
   elementwise, E BEHZ lift/tail/decrypt rounding, F key-switch digits and
   divide-round, AF the digits folded into A's first pass (A's route runs
   it where F's digits and A ran), AFi F's divide folded into A's last
   inverse pass (A's route runs it where A's inverse and F's divide ran),
   ACi C's conversion and E's decrypt rounding folded into A's last
   inverse pass (A's route decrypts with it), K mod-switch divide-round
   (also at k = 1, odd component counts, 16 and 17 limbs and the rounding's
   turning words, and F's divide on K's kernel in every accumulator layout
   of its J route), G the plain embedding on D's grid (m (n) onto c0
   (5, n), a batch of 8, add_plain's and sub_plain's new ciphertext with
   c1 copied), DG D's zero-encryption finish with it (BFV's: symmetric
   into c0, a batch of 8 into c0 with c1 copied, public key), both also on
   the edge words (m at 0, t - 1, (t - 1)/2, (t + 1)/2), M Galois
   gather on its packed tables, signed and unsigned, and M as the batch
   encoder's slot gather; D's fused forms, the zero encryptions' finishes
   in place and into a batch with c1 copied, the switching-key rows and
   the balanced add and sub, on random words and on the edge words 0 and
   q - 1) against its plain PyTorch version on the card,
   at the main path's shapes, word for word (tolerance 0), with both times
   (CUDA events around one call, median of 20: at these sizes mostly the
   host's launch cost), the least time the card could take (bound) and,
   where one PyTorch call computes the same function, that call's time;
4. the BFV n = 16384 fixture chain from troy's C++ code, word for word:
   keygen (sk, relin key row 0, Galois key row 0), encrypt, multiply,
   relinearize, rotate_rows(1), mod_switch_to_next, decrypt, and the
   invariant noise budget;
5. round trips on fresh random slot vectors, encrypted by the default
   path (device sampling, kernel I): each decrypts to a*b mod t,
   and its rotations (rows by 1, rows by 3 through the NAF as 4 - 1, the
   column swap) and its mod switch decrypt to the expected slots; then the
   median times of multiply+relinearize, rotate_rows(1) and
   mod_switch_to_next (CUDA events);
6. every BFV-path kernel was launched by phases 4-5 (launch counters), and
   F's separate digits entry (troy_keyswitch_digits) and its divide
   (troy_keyswitch_divide_round) never, nor C (troy_base_convert) or E's
   decrypt rounding (troy_behz_decrypt_round): on A's route AF, AFi and
   ACi do their work (so in every window on A's route below, and X's
   troy_exact_convert, which AXi replaces), one ACi or AXi call a decrypt
   or decrypt_many (the windows of phases 4-5, 12-13, 14, 18 and 21); no
   plain version and no u64ops arithmetic ran on a CUDA tensor in phases
   4-5 (call counters); per op (mult+relin, rotate_rows(1), mod switch,
   encrypt, decrypt, encode, decode), the device kernels and the device
   time of each from the torch profiler, one trace per op, and kernel A's
   share of mult+relin's device time;
7. the CKKS kernels (O1 the FP64 embedding transform, both directions; O2
   the exact rounding into RNS, and AO2p, O2's rounding folded into A's
   first forward pass, which A's route encodes with: the slot encode's
   (n) -> (5,n) at scales 2^40 and 2^100, the polynomial encode's real
   words, n = 1024 and 512, and against O2 + A; then the slot encode and
   encode_polynomial on the card word-equal to the port's CPU run, one
   AO2p call and no O2 each; O3 the CRT composition; K' the NTT-domain
   divide by the last prime, for the rescale and for the key switch: its
   own temps and finish, which J's route runs, and AKp, its temps and
   finish in A's forward passes, alone and after A's inverse, which A's
   route runs) against their plain versions at the CKKS shapes: O1 within
   2^-44 max|x| (two FP64 summation orders), O2 and K' word for word, O3
   bit for bit (also at the CRT values around 0 and Q/2 and where its
   rounded multiple of Q needs the tie correction, and one level down);
   the same times, bounds and library times as phase 3, and
   the library call's device time (profiler);
8. the CKKS n = 16384 records chain from troy's C++ code
   (tests/data/ref_ckks_n16384_headline.bin): keygen (sk, relin key row 0,
   Galois key row 0), encode within the tie bound (|diff| <= 1 at <= 4
   coefficients), encrypt of the records' own plaintexts, multiply,
   relinearize, rescale_to_next (and its scale), rotate_vector(1) word for
   word, and decrypt + decode of the relinearized product to v1 v2;
9. three requests on fresh random complex slot vectors, encrypted by the
   default path: mult, relin and
   rescale decode to a b, its rotate_vector(1) to the rotated slots, its
   complex_conjugate to the conjugates; then the medians of mult+relin,
   rescale_to_next, rotate_vector(1), complex_conjugate, encode and decode;
10. every CKKS-path kernel was launched by phases 8-9, K''s own temps and
   finish never (on A's route AKp does their work, so in every window on
   A's route below), no plain version or
   u64ops arithmetic ran on a CUDA tensor there, and the per-op device
   kernels and device time from the profiler;
11. the BGV kernels (X the exact conversion q -> t with the inverse
   correction factor 1 and another, and AXi, X in A's last inverse pass,
   from the NTT-form phase; K'-BGV the t-corrected NTT-domain
   divides, the mod switch's temps and finish and the key switch's temps,
   and AKp's BGV entries, alone and after A's inverse;
   G' the plain lift with threshold (t+1)/2, with threshold t and times a
   correction factor, and AGp, G''s lift in A's first forward pass, the
   same three and against G' then A) against their plain versions at the
   BGV shapes, word for word, with the times and bounds of phase 3;
12. the BGV n = 16384 records chain from troy's C++ code
   (tests/data/ref_bgv_n16384_headline.bin, seed 2027): keygen (sk, relin
   key row 0, Galois key row 0), the encryptions of the records' slot
   vectors, multiply, relinearize, mod_switch_to_next (and its correction
   factor), rotate_rows(1), and decrypt + decode of the switched product,
   word for word (the records are in coefficient form: transform_to_ntt /
   transform_from_ntt at the boundary);
13. three BGV requests on fresh random slot vectors a, b, c, encrypted by
   the default path: mult + relin
   and its mod switch (correction factor != 1) decrypt to a b, its
   rotate_rows(1) and rotate_columns to the rotated slots, the product of
   two switched ciphertexts (cf^2) plus a switched c (cf) to a b + c, and
   multiply_plain, add_plain and sub_plain at cf != 1 to a b c, a b + c
   and a b - c; the medians of BGV mult+relin, mod_switch_to_next,
   rotate_rows(1), multiply_plain, encrypt (and, for comparison, the
   host-sampled encrypt over 3 runs: seconds each) and decrypt;
14. every BGV-path kernel was launched by phases 12-13, no plain version or
   u64ops arithmetic ran on a CUDA tensor there, and the per-op device
   kernels and device time from the profiler; then, with the counts from 0
   again, one plain-op request on each of the BFV and CKKS paths
   (multiply_plain then add_plain, decrypting to a b + c, CKKS within
   1e-4), the same checks for their kernels, and the medians of their
   multiply_plain;
15. kernel I (device sampling: I1 uniform residues, I2 CBD noise, also
   times t, I3 ternary, from threefry streams, and the one-launch draws of
   a symmetric zero encryption, e then a, and of a public-key one, u then
   each e_j) against its plain versions at the default path's shapes (6
   and 5 limbs, one seed and device arrays of 8 and of 5 seeds), word for
   word, with the times and bounds of phase 3;
16. the default encryption path of each scheme at n = 16384, in a count
   window of its own that must launch I, A, B, D, DG and AGp and run no
   plain torch on the card: keygen, the public key with its seed, encrypt,
   encrypt_symmetric, save_seed and expand_seed, encrypt_symmetric_many(8),
   and an external secret key's public key, relin key and key-switching
   key made on the device (kernel Q); every result word-equal to the
   port's own CPU run from the same seeds and plaintext words, every
   ciphertext decrypting to its slots, the public key's seed regenerating
   its c1, the device keys relinearizing and switching right
   (apply_keyswitching); the medians and the profile of each op; each
   encryption, public key and device key launching I and its finish once
   a call (D; for a BFV encryption DG, and no G) (counters) and no device
   kernel but the port's (no stack, cat or copy; profiler), no single CBD
   or ternary draw in the window;
17. kernel N1 (the negacyclic shift by one amount and by one per row, the
   LWE extract of 256 terms, the assemble times n^-1), N2 (the pack-tree
   prepare), kernel M's batched gathers (16 tables, signed and unsigned;
   one table written component-major), kernel B's batched key-switch
   product and K'' (the coefficient-domain BGV divide by the special
   prime onto an accumulator, and by q_last) against their plain versions
   at the shapes of phase 18, word for word, with the times and bounds of
   phase 3 (library: torch.gather for the unsigned batched gather);
18. on each scheme, 21 Galois keys made on the card from a secret key
   (kernel Q: the elements 2^i + 1, eight rotation steps and 2n - 1),
   then: rotate_many over [1, 2, 3, 4, 8, 16, -1, -2] (one hoist) and each
   sequential rotation decode to the rotated slots; apply_galois_many over
   four elements (BGV: also in coefficient form, with rotate_rows(1)
   there) decodes as apply_galois; negacyclic_shift by 1, n - 1, n + 5
   decrypts to x^s m; extract_lwe_many of 256 terms and
   pack_lwe_ciphertexts decrypt to the terms at stride n/256 and 0
   elsewhere (BFV, BGV exactly; CKKS coefficients within 2^-16 scale);
   field_trace(logn=0) to n m_0 and 0 elsewhere; one hoisted call (m = 4)
   and one pack of 8 word-equal to the port's own CPU run on the same
   words; the medians of the hoisted path (forced at every m) against m
   sequential apply_galois calls at m = 1, 2, 4, 8, 16, of
   extract_lwe_many(256), packs of 16 and 256, field_trace and
   negacyclic_shift;
19. phase 18's checks in a count window of their own: N1, N2, K'', M, A,
   B, D and F launched, no plain version or u64ops on a CUDA tensor; and
   the per-op device kernels and time from the profiler;
20. the app layer's kernels (P1 the ct x pt tile contraction at conv2d's
   (1,64,2,2,n) x (64,52,2,n), matmul's (1,8,2,2,n) x (8,16,2,n), the BIG
   matmul's (1,32,2,2,n) x (32,126,2,n) and a ragged (3,5,2,2,n) x
   (5,13,2,n); P2
   the ciphertext pair grid at X = 1, Yc = 16 over q u Bsk with lazy words
   and over q; P3 the group fold at m = 16 and a ragged m = 20, P = 16;
   AP2i, P2 in A's first inverse pass, at P2's q u Bsk shape, also against
   P2 then A's inverse, and at X = 2, Yc = 5 with sizes 3 x 2; AGp at the
   matmul's (8,16,n) and the conv2d's (64,52,n) weight tiles)
   against their plain versions, word for word, with the times and bounds
   of phase 3 (no PyTorch call computes them: no library time);
21. troy's app protocol at full width (test/app/linear.cu:575-584, as
   benchmarks/linear_bench.py sets it up: BFV, n = 16384, q = {60,60,60},
   t = 2^41; inputs and weights below 2^8 from a seed; the relin key and
   the pack's automorphism keys made on the card from a seeded secret
   key): matmul 64x128x256 with pack_lwe through pack, serialize,
   deserialize and decrypt; the same with encrypted weights, relinearized
   and packed; matmul 128x500x1001 with saveTerms; conv2d 1x64x256 56x56
   3x3; each decrypts exactly to the integer oracle mod t, each ciphertext
   grid round-trips Cipher2d.save/load; a packed BGV matmul 64x128x256
   (t = 2^41, the inputs in coefficient form) and a BGV ct x ct matmul
   64x128x256 (relinearized, on P2's own kernel) exactly, and a CKKS matmul
   64x128x256 (the CKKS configuration above, scale 2^40) within
   CKKS_APP_BOUND; then the medians of each protocol phase in
   linear_bench.py's order, the BIG matmul's and the conv2d's (CUDA
   events, APP_REPS runs after a warm-up; the host's encode loops and the
   decryption apart from the output gathers);
22. phase 21's checks in a count window of their own: P1, P2, P3, A, B,
   ACi, D, E, AF, AFi, AGp, AP2i, AKp, I, M, N1, K'', AXi, O2 and O3
   launched, no standalone C, X, E rounding or G' launch, no plain version
   or u64ops on a CUDA tensor; BFV's matmul_cipher launching AP2i and not
   P2, BGV's P2 and not AP2i (counters); and the device kernels and time
   of matmul, matmul_cipher (BFV and BGV), pack_outputs, conv2d,
   decrypt_many of the conv's 52
   outputs and fetch_ciphertexts_host(to_coeff=True) from the profiler.
23. kernel J (the 4-step NTT's stages as butterflies in shared memory,
   csrc/ntt_mxu.cu) against its plain version (the exact int8 matrix
   algebra), forward and inverse, word for word, on a (2, k, n)
   batch of any u64 words at n = 4096 and 16384 with q =
   {60,40,40,40,40,60}, n = 32768 with SEAL's bfv_default(32768), and
   n = 65536, 131072 and 262144 with q = {55,55,60}; at n = 16384 also with
   a 40-bit X-plane bound (5 planes on the 60-bit primes); J against A on
   reduced words at every n; at each shape J's time,
   device time per launch, bound, plain time, the torch._int_mm time of
   the plain version's plane products alone (the library yardstick, never
   used by the port) and A's time;
24. troy's timetest BFV mult+relin and CKKS mult+relin+rescale at
   n = 16384 with use_mxu=True, a BFV multiply_plain and a CKKS encode,
   encode_polynomial and encode_with_stats, word-equal to the A route on
   the same ciphertexts, keys and values (the statistic bit-equal), in a
   count window that must launch J (for CKKS K''s own temps and finish, O2
   and O4, for BFV F and G') and not A, AKp, AGp, AO2p or AO4p; both
   routes timed, alternately;
25. SEAL's 128-bit n = 32768 BFV chain at full width (bfv_default(32768):
   16 primes, 881 bits; t = PlainModulus.batching(32768, 20)), every NTT
   on the default route (A): native host keygen (secret, public, relin,
   the Galois keys of rotate_rows(1) and rotate_columns; seconds per
   key), encode, encrypt and encrypt_symmetric on the default device
   path, multiply,
   relinearize, rotate_rows(1), rotate_columns, mod_switch_to_next,
   decrypt with the noise budget (positive) and decode, exact to the
   numpy oracle mod t; medians per op (CUDA events, LARGE_REPS runs) and
   max_memory_allocated; in a count window of its own;
26. a 16-prime CKKS chain at n = 32768 (q = {60, 40 x 14, 60}, scale
   2^40): encode, encrypt, encrypt_symmetric, multiply, relinearize,
   rescale_to_next within CKKS_LARGE_BOUND of the numpy product, its
   rotate_vector(1) within CKKS_ROTATION_BOUND (its key switch's noise is
   above 1e-6), decode; the same medians, in a count window of its own;
27. troy's ceiling n = 131072 and the JAX package's single-chip ring
   n = 262144, q = {55,55,60}, t = batching(n, 30): BFV encrypt,
   multiply, relinearize and decrypt, exact to the product mod t; host
   keygen seconds and the medians, in a count window of its own;
28. the device kernels and time of phases 25-27's ops from the profiler,
   the NTT kernels' (A's and J's) share of each op's device time, and no
   plain torch on the card;
29. the CKKS statistics against their plain versions at n = 16384 (q =
   {60,40,40,40,40,60}, scales 2^40 and 2^55) and n = 32768 (the 16-prime
   chain, 2^40), at the first data level: O4 (the encode statistic, max
   |rint(c s)|) writes O2's words and a statistic bit-equal to the plain
   version's; AO4p (O4's statistic in A's forward passes, AO2p's rounding:
   the encode_with_stats of A's route) writes AO2p's words and O4's
   statistic, bit for bit, and its plain version's; O5 (the decode
   residual, max(|Re V[j] - Re V[n-1-j]|, |Im
   V[j] + Im V[n-1-j]|)) writes O1's slots bit for bit, both residuals in
   [0, 1e-8] and the kernel's within 2^-44 max|v| of the plain version's;
   with phase 3's times, device us a launch and bound, and torch.fft.fft's
   time (CUDA events) and device time (profiler) as the transform's
   yardstick;
30. troy's binder scripts through troy_tpu_torch.compat (``import
   troy_tpu_torch.compat as pytroy``) on the card, in a count window of
   their own: binder/test.py's Alice/Bob protocol (CKKS n = 16384, six
   40-bit primes, keys and ciphertexts as save() bytes) decoding to
   [0.5, 1.2, 2.1, 3.2] within 1e-3; binder/timetest.py's op surface,
   repeat = 2, BFV and BGV at (8192, t = 2^41, (60,50,60)) and CKKS at
   (8192, (60,40,40,60), 2^40), every result decrypted and checked; a
   borderline CKKS encode at scale 2^45 (one slot at 4Q/scale: accepted by
   the exact check on O4's statistic) and one too large (raises); and
   decode_max_error (O5) of a fresh product; the window must launch
   BINDER_PATH's kernels (O1, AO2p, O3, AO4p for the encode statistic,
   O5, A, G for BFV's add_plain, DG for its encryptions, ...), with no
   plain torch on the card;
   the shim ops' device kernels and time from the profiler;
31. troy's raw-struct wire (refwire.py) at n = 16384 (BFV): the bytes of
   seeded keys, a public-key ciphertext, a seed-compressed one (saved
   expanded) and a product equal to the port's CPU run from the same
   seeds; saveTerms/loadTerms round trip; each stream loads and decrypts;
32. medians (CUDA events) of encode, encode_with_stats, encode_device,
   decode, decode_device and decode_device_with_stats at n = 16384 and
   32768, and of mult+relin through the shim against Evaluator, in 8
   alternating rounds: the shim's cost per op beside the spread;
33. kernel R1 (csrc/sharding.cu, the cross-shard modular sum of the
   limb-sharded key switch's partials) against its plain version at
   phase 34's shapes, word for word, with phase 3's times, its device us
   a launch and its bound; kernel J's four stages on per-shard tables
   (ops/ntt_mxu.make_shard_tables) against their plain version at
   n = 16384 over 2 and 4 ranks and n = 131072 over 2;
34. every regime of troy_tpu_torch.parallel.sharding on the card, in
   spawned ranks that share it (gloo in 2 and 4 ranks, its collectives
   staged through host memory; NCCL in one rank): data parallel, limb-
   and coefficient-sharded mult+relin, the limb-sharded rotation and mod
   switch of BFV, CKKS and BGV at n = 16384, the (2, 2) mesh's mult+relin
   and rotation chained into the mod switch, the coefficient regime at
   troy's ceiling n = 131072 and the app matmul over the batch-block
   rows; every gathered output word-equal to the port's unsharded op on
   the card and decrypting right; per rank the medians (CUDA events), the
   collectives' calls and bytes and its shards' bytes; no plain torch on
   the card in any rank, and every kernel of the sharded path launched in
   the window of every rank of every run. These numbers are ranks sharing
   one H100 over gloo's host staging, not multi-card scaling;
35. kernels A, M, J, E, O1, O5, P1, F, K', D, I, O3, X, C, G', P2, O2,
   K, B, K'', G (and DG) and O4 (AO4p) as redesigned
   for the H100: A against its plain version, word for word, at n = 256
   to 16384 (one pass below 1024, two from it up) and a row mod t, three
   rows mod t, (5, 6, n) and (4, 11, n), forward and inverse, lazy and not; A's device us a call and a
   launch and its blocks per launch at those rows (n = 16384) and at
   (5, 6, n) at every n; M's wrapper ms signed, unsigned and batched
   beside index_select / gather, timed in turns in this process, and its
   device us a launch and a call beside the library call's; the host us to
   enqueue one call of D, M, A and index_select (the launch path); J's
   four stages and both transforms at (2,6,16384), SEAL's (2,16,32768)
   and (2,3,n) for n = 65536, 131072 and 262144, word-equal to its plain
   version and to A, its device us a launch beside its bound, and A and
   J in turns at each n (the n up to which A was the faster); J on the
   shard blocks of n = 16384 over 2 and 4 ranks, every rank's stages
   against the plain version and the sharded transforms against A; E's
   lift and tail at the headline's and SEAL's first data levels against
   their plain versions, with device us a launch and a call and the
   bound; O1 (both directions) and O5 as shared-memory FFTs at n = 1024
   to 262144 within 2^-44 max|x| of their plain versions (O5 as phase 29
   holds it), with their device us a call in turns with torch.fft.fft and
   torch.fft.ifft of the same vectors, a launch, their blocks and threads a
   launch and the bound, and the device time of phase 10's CKKS encode
   and decode with O1's part of it; P1 at the conv2d, BIG matmul and
   matmul shapes, its device us a launch and a call beside its bound; AF
   (F's digits in A's first pass) word-equal to F's digits + A at
   (5,6,16384), (15,16,32768) and (2,3,131072), both timed
   in turns; AKp (K''s
   and K'-BGV's temps and finish in A's forward) at every shape of one
   run of the CKKS and BGV headline's mult+relin, rescale or mod switch
   and rotation, word-equal to K''s temps + A + K''s finish, the two
   timed in turns, a launch of each beside the bound; D and I around the
   zero encryptions (redesign_zero): each scheme's symmetric, public-key
   and batched (MANY) encryption, a device switching-key row set, BGV's
   balanced add and sub and the bare draws of one and of MANY seed pairs,
   each word-equal to the composition of single D steps, single draws and
   stacks it replaced, the two timed in turns, with their kernels, copies
   and I and D launches a call; O3 at every data level of the CKKS
   headline chain, at n = 32768 with 15 and 16 limbs and at n = 262144,
   bit-equal to its plain version on random residues and the values
   around 0, Q/2 and the ties, its device us a call and a launch beside
   the bound (redesign_o3); AFi (F's divide in A's last inverse pass) at
   every shape of one run of the BFV headline's mult+relin,
   rotate_rows(1) and apply_galois_many, each op launching AFi once a key
   switch and F's divide never, at the batched folds of 8 and 128, SEAL's
   (2,16,32768) and (2,6,512) (one pass), word-equal to A's inverse + F's
   divide, the two timed in turns, a launch of each beside the bound
   (redesign_afi); AXi and ACi (X, and C with E's rounding, in A's last
   inverse pass) at every shape of the decrypts of the BFV, BGV, plain-op,
   LWE and app windows, at SEAL's (1,15,32768) and at the ceiling's
   (1,2,131072) and (1,2,262144), word-equal to A's inverse then X, or C
   and E's rounding, the two timed in turns, a launch of each beside the
   bound, a decrypt and a decrypt_many of each scheme launching the fused
   entry once and X, C and E's rounding never, and one- against
   two-column blocks at a single decrypt (redesign_decrypt); the
   standalone X, C and E's rounding at the J-route shapes (1,5,16384) and
   (1,2,262144) (standalone_decrypt); AGp at the headline's (n) -> (5,n)
   and the app's weight tiles (8,16,n) and (64,52,n), word-equal to G' then
   A, timed in turns with that composition and with A alone on the lifted
   rows (redesign_agp); AP2i at the app's pair grid and at (2,3,6,n) x
   (5,2,6,n), word-equal to P2 then A's inverse, timed in turns with it
   and with P2 alone (redesign_ap2i); P2's own kernel at the app's q u Bsk
   and over-q grids, its device us a call and a launch and its bound's
   share (standalone_p2, on the wrappers the earlier trees have too); AO2p
   at the headline's (n) -> (5,n), word-equal to O2 then A (the slot
   encode) and to the complex copy, O2 and A (the polynomial encode),
   timed in turns with each and with A alone (redesign_ao2p); K's own
   kernel at (2,5,n), (2,2,n), SEAL's (2,15,32768) and (2,3,262144),
   word-equal to its plain version, its device us a call and a launch
   beside the bound (standalone_k, on the wrappers the earlier trees have
   too); DG's symmetric finish at (5,n), into a batch of MANY and its
   public-key finish, word-equal to D's finish then G, the two timed in
   turns, and G on D's grid at (n) onto (5,n), a batch of MANY and
   add_plain's ciphertext, in turns with D's add (redesign_embed); AO4p at
   the headline's (n) -> (5,n), word-equal (the statistic bit for bit) to
   O4 then A's forward, timed in turns with it and with AO2p
   (redesign_ao4p); B at every shape of the three schemes' mult+relin, the
   BFV and BGV decrypt and decrypt_many, the BFV encrypts, BGV's multiply_plain and
   a BGV LWE pack of 16, on contexts of its own, each call's device us a
   launch beside its words' bound, and B's launches and device us in each
   op (redesign_b, written on the wrappers and ops the earlier trees have
   too), B at 2 launches a mult+relin and 1, with no D, a decrypt
   (check_b_launches); K'''s own kernel at the LWE window's folds of 8, 4
   and 1 pairs and the BGV mod switch's (2,5,n), word-equal to its plain
   version, its device us beside the bound (standalone_kpp, as
   standalone_k); and the spread of one CKKS and one BGV
   rotation's profiled device time over 8 traces in this process
   (op_spread). Device us
   a call come from CUDA events
   around a CUDA graph of 20 calls (the host's enqueue is longer than
   these kernels), a launch from the profiler;
36. the oracle suites on the card, each part in a count window of its
   own with one line of its cases and launches: a. every case of
   tools/troy_vectors_torch.py that runs ops (troy's C++ fixtures at
   n = 64 and 4096: BFV, BGV and CKKS ops on troy's keys and
   ciphertexts, the encoders, seeded keys and host-sampled encryptions,
   the noise budget, the CKKS rotation and conjugation, BFV at t = 2^41,
   the RNS tool's composites: E's lift, ACi, the decrypt scaling and K),
   word for word against troy's words; b. tools/fuzz_torch.py's BFV, BGV
   and CKKS sequences at n = 64 and BFV on J's route at n = 2048 (seed
   0), the polynomial sequences at t = 2^41 and a non-batching t, and the
   other ops, against their plaintext models and decrypt_many after every
   step; c. BFV at n = 16384 with Bsk primes of 40 and 48 bits: multiply,
   relinearize, decrypt and decrypt_many word-equal to the port's CPU run
   from the same seeds and decrypting to a b, with E's and ACi's
   launches; d. tools/ckks_precision_torch.py's chain at the headline:
   fed the CPU run's plaintext words, every stage's ciphertext equal to
   the CPU run's, and with the card's own encode every row's precision
   within 0.1 bit of the CPU's (the rows printed); no plain torch on the
   card in any part, every kernel of SUITES_PATH launched; then each
   part's card work once more in a profiler trace: its device seconds.

The line before last is a JSON object with one entry per kernel (its
launches: phases 4-5, phases 8-9, phases 12-13, the plain-op requests of
phase 14, the default path of phase 16, the LWE path of phase 18, the
app protocol of phase 21, the J route of phase 24, phases 25, 26 and
27, the binder window of phase 30, the sharded window of phase 34
(summed over its ranks and runs) and the suites of phase 36 (summed over
its parts), each counted from 0, also given
apart; J's numbers are those of its n = 16384 shape, every shape under
"J_shapes" and its per-shard stages under "J_shard_shapes"; O4's, AO4p's
and O5's those of n = 16384 at 2^40, every shape under "stats_shapes"; R1's
those of its (4, 1, 2, 6, n) shape; phase 34's regimes under "sharded";
phase 35's under "redesign", A's share of mult+relin under
"mult_relin_a", and the kernels of RANKED (those not yet redesigned, and
D and I) ranked by launches times their device us a launch over their
bound a launch, both means over the headline windows' profiled ops, each
launch's bound from its own arguments, under "unredesigned_losses")
and the
bounds of the composite ops (M' the NTT-form rotation and the hoisted path
over 8 elements, L the plain products, Q a device switching key; N the
pack of 16 and the trace, the batched decrypt of 52 outputs, O's
polynomial encode and decode); a line before it gives the
whole run's wall seconds; the last line is
{"ok": true, "device": {...}}.

Bounds: the larger of the bytes each call must move (every data input read
once and every output written once, with the NTT's twiddles and the small
per-limb constants of C-G; not what the function could compute on the
fly, such as O1's twiddles and slot map, O2's untwist and the permutations
of H and M, nor what passes between its own launches, such as K' temps)
over 3.35 TB/s, and its operations over the H100's data-sheet rate for their
type: 64-bit multiplies, each taken as four 32-bit operations, and I's
32-bit additions, rotations and xors (80 per threefry block), over the
67 T/s float32 rate (the card has no faster path for 64-bit integer
products; it issues 64 32-bit integer operations a clock an SM, about a
quarter of that rate, so I's operation bound is optimistic by about 4);
for O1, the 5 n log2 n f64 operations of an FFT over the
67 TFLOP/s FP64 tensor-core peak; for J, as for A, its butterflies' 64-bit
products (3 each), with the entry reduction and the grid product (5 a
word); for R1, its w - 1 modular adds a word, each taken as four 32-bit
operations.
Phase 34's per-rank bound counts the bytes of a rank's own shards (its
inputs, the key rows it holds, its output) only.
"""

import contextlib
import json
import math
import pathlib
import re
import statistics
import struct
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

import troy_tpu_torch as P
import troy_tpu_torch.compat as pytroy
from troy_tpu_torch import (_kernels, decryptor, encryptor, interop, keygen,
                            native, prng as rnd, refwire, rlwe,
                            serialization, to_numpy, to_torch)
from troy_tpu_torch.app import linear
from troy_tpu_torch.ops import (embedding, galois, keyswitch, ntt, ntt_mxu,
                                poly, rns,
                                sampling, shard, tiles)
from troy_tpu_torch.parallel import sharding, spmd
from troy_tpu_torch.utils import galois as galois_util
from troy_tpu_torch.utils import rns as rns_util

N = 16384
Q_BITS = [60, 40, 40, 40, 40, 60]
SEED = 2024
DATA = pathlib.Path(__file__).resolve().parent / "tests" / "data"
FIXTURE = DATA / "ref_bfv_n16384_headline.bin"
CKKS_FIXTURE = DATA / "ref_ckks_n16384_headline.bin"
CKKS_SEED = 2025                     # the seed of troy's CKKS records
CKKS_SCALE = 2.0 ** 40
BGV_FIXTURE = DATA / "ref_bgv_n16384_headline.bin"
BGV_SEED = 2027                      # the seed of troy's BGV records
REQUESTS = 3
TIMING_REPS = 20
SLOW_REPS = 3                        # host-sampled encryption: seconds each
ROTATION_STEPS = [1, -1, 4, 0]       # 0: the column swap, element 2n - 1
MEM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
OPS_PER_S = 67e12                    # H100 SXM float32, non-tensor
OPS_PER_MUL64 = 4
F64_OPS_PER_S = 67e12                # H100 SXM FP64 tensor-core peak
O1_TOLERANCE = 2.0 ** -44            # times max|x|
THREEFRY_OPS = 80                    # 32-bit operations of one block
DEFAULT_SEED = 2030                  # the default-path phase's seeds
MANY = 8                             # encrypt_symmetric_many's batch
LWE_SEED = 2031                      # phase 18's keys and messages
LWE_TERMS = 256                      # extract_lwe_many and the big pack
ROTATE_STEPS = [1, 2, 3, 4, 8, 16, -1, -2]
HOIST_MS = (1, 2, 4, 8, 16)          # apply_galois_many against sequential
# CKKS packing and trace: the key switches' noise, doubled by every later
# layer and trace step (up to n times in all), reaches 2^22 at n = 16384
# (4.5e6 on the H100 for a pack of 256); the port is word-equal to
# troy_tpu on the CPU, so this is the algorithm's, not the port's
CKKS_LWE_BOUND = 2.0 ** -16 * CKKS_SCALE
APP_Q_BITS = [60, 60, 60]            # troy's app benchmark,
APP_T = 1 << 41                      # test/app/linear.cu:575-584
APP_SEED = 2032                      # phases 21-22's keys and inputs
APP_INPUT_BOUND = 1 << 8             # inputs and weights below 2^8
APP_REPS = 5                         # protocol-phase medians
# CKKS matmul 64 x 128 x 256 at scale 2^40: |decrypted - x w|; the
# encryption noise over scale^2 and the encodes' rounding are near 2^-30
CKKS_APP_BOUND = 1e-6
# phase 23's shapes: (tag, n, q bits or SEAL's default chain)
MXU_SHAPES = (("n4096", 4096, Q_BITS), ("n16384", 16384, Q_BITS),
              ("n32768", 32768, "bfv_default"),
              ("n65536", 65536, [55, 55, 60]),
              ("n131072", 131072, [55, 55, 60]),
              ("n262144", 262144, [55, 55, 60]))
MXU_X_BITS = 40                      # the X-plane bound: 5 planes
SEAL_SEED = 2033                     # phases 25-26's keys and inputs
LARGE_REPS = 10                      # phases 25-27's medians
CKKS_LARGE_BITS = [60] + [40] * 14 + [60]   # phase 26, scale 2^40
CKKS_LARGE_BOUND = 1e-6              # phase 26's rescaled product
# phase 26's rotation: its key switch adds the noise of the 60-bit first
# prime over the 60-bit special prime, above 1e-6 (9.7e-6 on an H100 80GB
# HBM3; phase 9 sees 3e-6 at n = 16384 and holds its rotations to 1e-4)
CKKS_ROTATION_BOUND = 1e-4
CEILING_NS = (131072, 262144)        # troy's ceiling, the JAX package's
CEILING_Q_BITS = [55, 55, 60]        # single-chip ring
CEILING_T_BITS = 30                  # (benchmarks/nceiling_tpu.py:31-32)
# phase 29's shapes: (tag, n, q bits, scale); O4 and O5 at the first data
# level
STATS_SHAPES = (("n16384_2^40", 16384, Q_BITS, 2.0 ** 40),
                ("n16384_2^55", 16384, Q_BITS, 2.0 ** 55),
                ("n32768_2^40", 32768, CKKS_LARGE_BITS, 2.0 ** 40))
RESIDUAL_BOUND = 1e-8                # O5's residual in slot units
O5_INPUTS = 4                        # coefficient vectors O5 is held on
# phase 30: troy's binder/test.py and binder/timetest.py main()
BINDER_N = 16384
BINDER_BITS = [40] * 6
BINDER_SCALE = 2.0 ** 40
BINDER_WANT = np.array([0.5, 1.2, 2.1, 3.2])
BINDER_BOUND = 1e-3                  # as tests/test_binder_parity.py:120
BORDER_SCALE = 2.0 ** 45             # tests/test_ckks_stats.py:72-97
TIMETEST_N = 8192
TIMETEST_T_BITS = 41
TIMETEST_BFV_Q = [60, 50, 60]
TIMETEST_CKKS_Q = [60, 40, 40, 60]
TIMETEST_DELTA = 2.0 ** 40
DATA_BOUND = 1 << 6                  # timetest.py's dataBound
# the CKKS ops' error over the larger of 1 and the slots' magnitude (up to
# 64^2 for a product at scale 2^40)
TIMETEST_CKKS_BOUND = 1e-5
WIRE_SEED = 2034                     # phase 31's keys and encryptions
WIRE_TERMS = [0, 3, 17, 40, 1000, 8191, 16383]
SHIM_ROUNDS = 8                      # phase 32: rounds of 4 alternating medians
SHARD_SEED = 2035                    # phase 34's keys and encryptions
SHARD_REPS = 10                      # phase 34's medians, per rank
SHARD_TIMEOUT_S = 400.0              # each spawned run of phase 34
SHARD_BATCH = 8                      # the data-parallel batch of pairs
SHARD_BATCH_2D = 4                   # the (2, 2) mesh's batch
# the spawned runs of phase 34: (backend, ranks), every rank on cuda:0
SHARD_RUNS = (("gloo", 2), ("gloo", 4), ("nccl", 1))
SHARD_WORLDS = (2, 4)                # R1's and J's per-shard checks
# phase 35: kernel A's rings and rows (k limbs, leading count): a row and
# three rows mod t, the headline's (5, 6, n), q u Bsk's (4, 11, n)
REDESIGN_NS = (256, 512, 1024, 2048, 4096, 8192, 16384)
REDESIGN_ROWS = {"1 row mod t": (1, 1), "3 rows mod t": (1, 3),
                 "(5,6,n)": (6, 5), "q u Bsk (4,11,n)": (11, 4)}
APP_SHARD_DIMS = ((64, 128, 256), (16384, 16, 16))   # 1 and 2 batch blocks
# phase 35 (J and E redesigned): J's transforms (tag, n, q bits or SEAL's
# default chain, rows a limb), A and J in turns at each; the headline's
# own rows at n = 16384 decide that n; J's shard blocks of n = 16384, E's
# lift and tail at two data levels (tag, n, q bits)
REDESIGN_J_SHAPES = (("(2,6,16384)", 16384, Q_BITS, 2),
                     ("(5,6,16384)", 16384, Q_BITS, 5),
                     ("(2,16,32768)", 32768, "bfv_default", 2),
                     ("(2,3,65536)", 65536, CEILING_Q_BITS, 2),
                     ("(2,3,131072)", 131072, CEILING_Q_BITS, 2),
                     ("(2,3,262144)", 262144, CEILING_Q_BITS, 2))
REDESIGN_J_SHARDS = (2, 4)
# (the first data level: the chain less its special prime, t =
# batching(n, 20); the multiply lifts two ciphertexts and tails three rows)
REDESIGN_E_SHAPES = (("headline", N, Q_BITS), ("SEAL", 32768, "bfv_default"))
# phase 35 (O1 and O5 redesigned): the rings they are held and timed at,
# in turns with torch.fft.fft / ifft of the same vectors
REDESIGN_O1_NS = (1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072,
                  262144)
O1_KERNELS = ("fft_cols_kernel", "fft_rows_kernel")
# phase 35 (P1 and F redesigned): P1 at the app protocol's three shapes
# (tag, X, I, Y; two components, n = 16384, q = {60,60,60}); the fused
# digits forward against F's digits + A (tag, n, q bits or SEAL's default
# chain, source rows: the data limbs of the first level); F's divide at the
# batched fold's shapes (ciphertexts a fold: a pack layer of 8, the first
# layer of a pack of 256)
REDESIGN_P1_SHAPES = (("conv", 1, 64, 52), ("BIG", 1, 32, 126),
                      ("matmul", 1, 8, 16))
REDESIGN_F_SHAPES = (("(5,6,16384)", 16384, Q_BITS, 5),
                     ("(15,16,32768)", 32768, "bfv_default", 15),
                     ("(2,3,131072)", 131072, CEILING_Q_BITS, 2))
REDESIGN_FOLD_MS = (8, 128)
# phase 35 (O3 and F's divide redesigned): O3 at the CKKS window's levels
# (every data level of the headline chain) and at these: n = 32768 with 15
# and 16 limbs of CKKS_LARGE_BITS, n = 262144 with the ceiling's data limbs
# and five headline primes (tag, n, q bits, limbs); AFi at
# SEAL's n = 32768 relinearize and at n = 512 (the one-pass mode), beside
# the BFV headline's own key switches and folds
REDESIGN_O3_SHAPES = (("(15,32768)", 32768, CKKS_LARGE_BITS, 15),
                      ("(16,32768)", 32768, CKKS_LARGE_BITS, 16),
                      ("(2,262144)", 262144, CEILING_Q_BITS, 2),
                      ("(5,262144)", 262144, Q_BITS, 5))
REDESIGN_AFI_SHAPES = (("SEAL (2,16,32768) onto (c0,c1)", 32768,
                        "bfv_default", 2),
                       ("(2,6,512) onto (c0,c1)", 512, Q_BITS, 2))
# phase 35 (G' and P2 redesigned): AGp against G' + A (tag, the context:
# the BGV headline's first level or the app's, the source rows' leading
# shape: a plaintext, the matmul's and the conv2d's weight tiles); AP2i
# against P2 + A's inverse and P2 alone at the app's pair grids (tag, X,
# Yc, s1, s2: over q u Bsk, lazy words) and P2 over q (tag, X, Yc, over
# q u Bsk)
REDESIGN_AGP_SHAPES = (("headline (n)->(5,n)", "bgv", ()),
                       ("app matmul (8,16,n)->(8,16,2,n)", "app", (8, 16)),
                       ("app conv (64,52,n)->(64,52,2,n)", "app", (64, 52)))
REDESIGN_AP2I_SHAPES = (("app (1,2,6,n)x(16,2,6,n)", 1, 16, 2, 2),
                        ("(2,3,6,n)x(5,2,6,n)", 2, 5, 3, 2))
REDESIGN_P2_SHAPES = (("q u Bsk (1,2,6,n)x(16,2,6,n)", 1, 16, True),
                      ("over q (1,2,2,n)x(16,2,2,n)", 1, 16, False))
# phase 35 (O2 and K redesigned): K's own kernel (the BFV mod switch) at
# the BFV window's level, k = 1, SEAL's n = 32768 first level and the
# ceiling's ring (tag, n, the level's primes, components)
STANDALONE_K_SHAPES = (("(2,5,n)->(2,4,n)", N, Q_BITS[:5], 2),
                       ("(2,2,n)->(2,1,n)", N, Q_BITS[:2], 2),
                       ("SEAL (2,15,32768)->(2,14,32768)", 32768,
                        "bfv_default", 2),
                       ("(2,3,262144)->(2,2,262144)", 262144,
                        CEILING_Q_BITS, 2))

# name -> (source, the TPU function it replaces)
KERNELS = {
    "A_ntt": ("troy_tpu_torch/csrc/ntt.cu", "troy_tpu/ops/ntt.py:318"),
    "AF_ntt_digits": ("troy_tpu_torch/csrc/ntt.cu",
                      "troy_tpu/evaluator.py:179"),
    "AGp_ntt_lift": ("troy_tpu_torch/csrc/ntt.cu",
                     "troy_tpu/evaluator.py:708"),
    "AP2i_pair_intt": ("troy_tpu_torch/csrc/ntt.cu",
                       "troy_tpu/app/linear.py:133"),
    "AO2p_ntt_round": ("troy_tpu_torch/csrc/ntt.cu",
                       "troy_tpu/ops/embedding.py:425"),
    "AKp_rescale_ntt": ("troy_tpu_torch/csrc/ntt.cu",
                        "troy_tpu/ops/rns.py:213"),
    "AKp_keyswitch_ntt": ("troy_tpu_torch/csrc/ntt.cu",
                          "troy_tpu/evaluator.py:337"),
    "AKp_bgv_ntt": ("troy_tpu_torch/csrc/ntt.cu",
                    "troy_tpu/ops/rns.py:246"),
    "AFi_keyswitch_intt": ("troy_tpu_torch/csrc/ntt.cu",
                           "troy_tpu/evaluator.py:290"),
    "AXi_decrypt_intt": ("troy_tpu_torch/csrc/ntt.cu",
                         "troy_tpu/ops/rns.py:189"),
    "ACi_decrypt_intt": ("troy_tpu_torch/csrc/ntt.cu",
                         "troy_tpu/ops/rns.py:169"),
    "B_dyadic_mac": ("troy_tpu_torch/csrc/dyadic_mac.cu",
                     "troy_tpu/ops/ntt.py:428"),
    "C_base_convert": ("troy_tpu_torch/csrc/base_convert.cu",
                       "troy_tpu/ops/rns.py:44"),
    "D_rns_elementwise": ("troy_tpu_torch/csrc/rns_elementwise.cu",
                          "troy_tpu/ops/poly.py:36"),
    "E_behz": ("troy_tpu_torch/csrc/behz.cu", "troy_tpu/ops/rns.py:111"),
    "F_keyswitch": ("troy_tpu_torch/csrc/keyswitch.cu",
                    "troy_tpu/evaluator.py:179"),
    "K_divide_round": ("troy_tpu_torch/csrc/keyswitch.cu",
                       "troy_tpu/ops/rns.py:194"),
    "G_plain_embed": ("troy_tpu_torch/csrc/rns_elementwise.cu",
                      "troy_tpu/ops/poly.py:98"),
    "DG_zero_embed": ("troy_tpu_torch/csrc/rns_elementwise.cu",
                      "troy_tpu/ops/poly.py:98"),
    "M_galois": ("troy_tpu_torch/csrc/galois.cu",
                 "troy_tpu/evaluator.py:785"),
    "O1_ckks_fft": ("troy_tpu_torch/csrc/embedding.cu",
                    "troy_tpu/ops/embedding.py:257"),
    "O2_ckks_round": ("troy_tpu_torch/csrc/embedding.cu",
                      "troy_tpu/ops/embedding.py:425"),
    "O3_ckks_compose": ("troy_tpu_torch/csrc/embedding.cu",
                        "troy_tpu/ops/embedding.py:550"),
    "Kp_rescale_ntt": ("troy_tpu_torch/csrc/divide_round_ntt.cu",
                       "troy_tpu/ops/rns.py:213"),
    "Kp_keyswitch_ntt": ("troy_tpu_torch/csrc/divide_round_ntt.cu",
                         "troy_tpu/evaluator.py:337"),
    "X_exact_convert": ("troy_tpu_torch/csrc/exact_convert.cu",
                        "troy_tpu/ops/rns.py:67"),
    "Kp_bgv_ntt": ("troy_tpu_torch/csrc/divide_round_ntt.cu",
                   "troy_tpu/ops/rns.py:246"),
    "Gp_plain_lift": ("troy_tpu_torch/csrc/plain_embed.cu",
                      "troy_tpu/ops/poly.py:71"),
    "I_sampling": ("troy_tpu_torch/csrc/sampling.cu",
                   "troy_tpu/rlwe.py:57"),
    "N1_negacyclic": ("troy_tpu_torch/csrc/negacyclic.cu",
                      "troy_tpu/ops/poly.py:146"),
    "N2_pack_prepare": ("troy_tpu_torch/csrc/negacyclic.cu",
                        "troy_tpu/evaluator.py:573"),
    "Kpp_bgv_coeff": ("troy_tpu_torch/csrc/keyswitch.cu",
                      "troy_tpu/ops/rns.py:281"),
    "P1_tile_contract": ("troy_tpu_torch/csrc/tiles.cu",
                         "troy_tpu/app/linear.py:43"),
    "P2_pair_convolve": ("troy_tpu_torch/csrc/tiles.cu",
                         "troy_tpu/app/linear.py:133"),
    "P3_group_fold": ("troy_tpu_torch/csrc/tiles.cu",
                      "troy_tpu/app/linear.py:237"),
    "J_ntt_mxu": ("troy_tpu_torch/csrc/ntt_mxu.cu",
                  "troy_tpu/ops/ntt_mxu.py:263"),
    "O4_ckks_encode_stats": ("troy_tpu_torch/csrc/embedding.cu",
                             "troy_tpu/ops/embedding.py:611"),
    "AO4p_ntt_round_stats": ("troy_tpu_torch/csrc/ntt.cu",
                             "troy_tpu/ops/embedding.py:611"),
    "O5_ckks_decode_stats": ("troy_tpu_torch/csrc/embedding.cu",
                             "troy_tpu/ops/embedding.py:637"),
    "R1_shard_modsum": ("troy_tpu_torch/csrc/sharding.cu",
                        "troy_tpu/parallel/sharding.py:153"),
}
# the kernels each path must launch; on A's route the key switch's digits
# run in A's first pass (AF), BFV's divide in A's last inverse pass (AFi),
# K''s temps and finish in A's forward passes (AKp), the decrypt's
# conversions in A's last inverse pass (ACi: C and E's rounding; AXi: X),
# the plain lift in A's first forward pass (AGp: G'), the CKKS encodes'
# rounding in A's first forward pass (AO2p: O2) and BFV's pair
# convolution in A's first inverse pass (AP2i: P2), and the encode's
# statistic too (AO4p: O4); BFV's zero-encryption finish with its plain
# embedding on D's grid (DG: D's finish and G), G for add_plain and the
# host-sampled encrypt; F's and K''s own
# kernels (F, Kp) only on J's route (phase 24, n = 262144 in phase 27, the
# coefficient-sharded key switch of phase 34), C's and X's with E's
# rounding there too (n = 262144 in phase 27), G' there too (phase 24's
# multiply_plain), O2 there too (phase 24's CKKS encodes), O4 there too
# (phase 24's encode_with_stats); P2's own kernel for the CKKS and BGV
# pair grids (the app's BGV ct x ct matmul)
BFV_PATH = ("A_ntt", "AF_ntt_digits", "AFi_keyswitch_intt", "B_dyadic_mac",
            "ACi_decrypt_intt", "D_rns_elementwise", "E_behz",
            "K_divide_round", "G_plain_embed", "DG_zero_embed", "M_galois",
            "I_sampling")
CKKS_PATH = ("A_ntt", "AF_ntt_digits", "B_dyadic_mac", "D_rns_elementwise",
             "M_galois", "O1_ckks_fft", "AO2p_ntt_round", "O3_ckks_compose",
             "AKp_rescale_ntt", "AKp_keyswitch_ntt", "I_sampling")
BGV_PATH = ("A_ntt", "AF_ntt_digits", "B_dyadic_mac", "D_rns_elementwise",
            "M_galois", "AKp_bgv_ntt", "AXi_decrypt_intt", "AGp_ntt_lift",
            "I_sampling")
PLAIN_OPS_PATH = ("A_ntt", "B_dyadic_mac", "D_rns_elementwise",
                  "G_plain_embed", "AGp_ntt_lift", "AKp_rescale_ntt",
                  "ACi_decrypt_intt")
DEFAULT_PATH = ("I_sampling", "A_ntt", "B_dyadic_mac", "D_rns_elementwise",
                "DG_zero_embed", "AGp_ntt_lift")
LWE_PATH = ("N1_negacyclic", "N2_pack_prepare", "Kpp_bgv_coeff", "M_galois",
            "A_ntt", "AF_ntt_digits", "B_dyadic_mac", "D_rns_elementwise",
            "AFi_keyswitch_intt", "AKp_keyswitch_ntt", "AKp_bgv_ntt",
            "ACi_decrypt_intt", "AXi_decrypt_intt")
APP_PATH = ("P1_tile_contract", "P2_pair_convolve", "P3_group_fold", "A_ntt",
            "AF_ntt_digits", "B_dyadic_mac", "ACi_decrypt_intt",
            "D_rns_elementwise", "E_behz", "AFi_keyswitch_intt",
            "AGp_ntt_lift", "AP2i_pair_intt", "AKp_bgv_ntt", "I_sampling",
            "DG_zero_embed", "M_galois", "N1_negacyclic",
            "Kpp_bgv_coeff",
            "AXi_decrypt_intt", "AO2p_ntt_round", "O3_ckks_compose")
# BFV alone (its encryptions finish on DG: no D launch there)
LARGE_BFV_PATH = ("A_ntt", "AF_ntt_digits", "B_dyadic_mac",
                  "ACi_decrypt_intt", "E_behz",
                  "AFi_keyswitch_intt",
                  "K_divide_round", "DG_zero_embed", "M_galois", "I_sampling")
LARGE_CKKS_PATH = ("A_ntt", "AF_ntt_digits", "B_dyadic_mac",
                   "D_rns_elementwise", "M_galois", "O1_ckks_fft",
                   "AO2p_ntt_round", "O3_ckks_compose", "AKp_rescale_ntt",
                   "AKp_keyswitch_ntt", "I_sampling")
# n = 131072 on A (AF, AFi, ACi), 262144 on J (F's digits and divide; C
# and E's rounding)
CEILING_PATH = ("A_ntt", "AF_ntt_digits", "AFi_keyswitch_intt", "J_ntt_mxu",
                "ACi_decrypt_intt",
                "B_dyadic_mac", "C_base_convert", "E_behz", "F_keyswitch",
                "DG_zero_embed", "I_sampling")
BINDER_PATH = ("O1_ckks_fft", "AO2p_ntt_round", "O3_ckks_compose",
               "AO4p_ntt_round_stats", "O5_ckks_decode_stats", "A_ntt",
               "AF_ntt_digits", "B_dyadic_mac", "ACi_decrypt_intt",
               "D_rns_elementwise", "E_behz", "AFi_keyswitch_intt",
               "G_plain_embed", "DG_zero_embed",
               "AGp_ntt_lift", "I_sampling", "K_divide_round",
               "AKp_rescale_ntt", "AKp_keyswitch_ntt", "AKp_bgv_ntt",
               "M_galois",
               "AXi_decrypt_intt")
# the limb-sharded key switch and mod switch on A (AF, AFi, AKp), the
# coefficient-sharded key switch on J (F's digits and divide, Kp)
SHARDED_PATH = ("R1_shard_modsum", "A_ntt", "AF_ntt_digits",
                "AFi_keyswitch_intt", "B_dyadic_mac",
                "E_behz", "F_keyswitch", "K_divide_round", "AKp_rescale_ntt",
                "AKp_keyswitch_ntt", "AKp_bgv_ntt", "Kp_keyswitch_ntt",
                "Kp_bgv_ntt", "M_galois", "J_ntt_mxu", "P1_tile_contract",
                "AGp_ntt_lift")
# the entry points a window on A's route must not launch: F's separate
# digits (their work is in AF), F's divide (in AFi), K''s temps and
# finish (in AKp), the decrypt's X, C and E's rounding (in AXi, ACi),
# G''s lift (in AGp), O2's rounding (in AO2p) and O4's (in AO4p)
A_ROUTE_ABSENT = ("troy_keyswitch_digits", "troy_keyswitch_divide_round",
                  "troy_exact_convert", "troy_base_convert",
                  "troy_behz_decrypt_round", "troy_plain_lift",
                  "troy_ckks_round", "troy_ckks_round_stats",
                  "troy_rescale_ntt_temps",
                  "troy_rescale_ntt_finish", "troy_keyswitch_ntt_temps",
                  "troy_keyswitch_ntt_finish",
                  "troy_bgv_mod_switch_ntt_temps",
                  "troy_bgv_mod_switch_ntt_finish",
                  "troy_bgv_keyswitch_ntt_temps")

# the single noise draws: every zero encryption draws its noise in the one
# launch of its fused entry (troy_sample_zero_sym, _asym), so a window of
# default-path encryptions must not launch these
SINGLE_NOISE_DRAWS = ("troy_sample_cbd_rns", "troy_sample_ternary_rns")
ENCRYPT_ABSENT = A_ROUTE_ABSENT + SINGLE_NOISE_DRAWS


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median device time of fn() in ms, from CUDA events around each run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py runs only "
                           "on a GPU")
    name = torch.cuda.get_device_name(0)
    log(f"[1] device: {name} (count {torch.cuda.device_count()})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        log(line)
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError(f"the native host runtime did not build or load: "
                           f"{native.build_error}")
    log(f"[2] native host runtime built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (g++ {native.build_seconds:.2f} "
        f"s): {native.library_path().name}")
    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.library()
    log(f"[2] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_kernels.build_seconds:.2f} s): {path.name}")
    kernel = ""
    for line in _kernels.build_log.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            kernel = _demangled(found.group(1))
        elif "registers" in line or "spill" in line or "error" in line:
            log(f"[2]   {kernel}: {line.strip()}")


def _demangled(symbol: str) -> str:
    """A kernel's name and template arguments from its mangled symbol
    (c++filt where the toolkit's machine has it)."""
    try:
        text = subprocess.run(["c++filt", symbol], capture_output=True,
                              text=True, timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return symbol
    found = re.search(r"::(\w+(?:<[\w, ]+>)?)\(", text)
    return found.group(1) if found else symbol


def _uniform(rng, bounds, shape, device) -> torch.Tensor:
    """Words uniform in [0, bounds[l]) for limb l of a (..., k, n) shape."""
    lead = shape[:-2]
    cols = [rng.integers(0, b, size=lead + (1, shape[-1]), dtype=np.uint64)
            for b in bounds]
    return to_torch(np.concatenate(cols, axis=-2), device)


def _edge(rng, bounds, shape, device) -> torch.Tensor:
    """Words 0 or bounds[l] - 1 only, for limb l of a (..., k, n) shape."""
    lead = shape[:-2]
    cols = [np.where(rng.integers(0, 2, size=lead + (1, shape[-1])), b - 1,
                     0).astype(np.uint64) for b in bounds]
    return to_torch(np.concatenate(cols, axis=-2), device)


def _full(rng, shape, device) -> torch.Tensor:
    return to_torch(rng.integers(0, 2 ** 64, size=shape, dtype=np.uint64),
                    device)


def crt_values(Q: int, rng) -> list:
    """CRT values (ints) around 0 and Q/2, and ones whose S = sum_j x_j /
    q_j lies within 2^-40 of a half-integer (frac(S) = (v mod Q) / Q),
    where O3 corrects its rounded multiple of Q."""
    h = (Q - 1) // 2
    near = [h - int(rng.integers(0, 1 << 30)) * (Q >> 72) for _ in range(6)]
    near += [h + 1 + int(rng.integers(0, 1 << 30)) * (Q >> 72)
             for _ in range(6)]
    return [0, 1, -1, 2, -2, 12345, -12345, 1 << 40, -(1 << 40), h, -h,
            h + 1, Q - 1, Q - 2] + near


def _bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes: int, mul64: int, f64_ops: int = 0, int32_ops: int = 0):
    """(bound_ms, bound_by): the larger of the memory and the compute
    bound (module docstring)."""
    mem = nbytes / MEM_BYTES_PER_S * 1e3
    ops = ((mul64 * OPS_PER_MUL64 + int32_ops) / OPS_PER_S
           + f64_ops / F64_OPS_PER_S) * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def compare(kind: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """The error of a kernel against its plain version, or raise: "words"
    tolerance 0 on u64 words, "bits" bit-equal f64, "close" (O1) within
    O1_TOLERANCE max|want|. A tuple of results compares member by
    member."""
    if isinstance(want, tuple):
        if not isinstance(got, tuple) or len(got) != len(want):
            raise AssertionError("results differ in number from the plain "
                                 "version's")
        return max(compare(kind, g, w) for g, w in zip(got, want))
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != plain "
                             f"{tuple(want.shape)}")
    if kind == "words":
        err = max_abs_diff(got, want)
        if err:
            raise AssertionError(f"{int((got != want).sum())} words differ "
                                 f"from the plain version (max |diff| {err})")
        return err
    err = float((got - want).abs().max())
    if kind == "bits" and not torch.equal(got, want):
        raise AssertionError(f"not bit-equal to the plain version (max "
                             f"|diff| {err})")
    if kind == "close" and err > O1_TOLERANCE * float(want.abs().max()):
        raise AssertionError(f"max |diff| {err} over {O1_TOLERANCE} "
                             f"max|x| of the plain version")
    return err


def run_checks(tag: str, checks) -> dict:
    """Each (kernel, variant, kind, kernel call, plain call, work or None,
    library call or None) checked and timed (a library call also its
    device time, from the profiler); the first of each kernel is the one
    whose numbers stand in the JSON line."""
    results = {}
    for kernel, variant, kind, run, plain, work, library in checks:
        got, want = run(), plain()
        torch.cuda.synchronize()
        try:
            err = compare(kind, got, want)
        except AssertionError as exc:
            raise AssertionError(f"{kernel} {variant}: {exc}") from None
        ms, plain_ms = cuda_ms(run), cuda_ms(plain)
        line = (f"[{tag}] {kernel:18s} {variant:44s} max |diff| {err:g}; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if kernel not in results:
            bound_ms, bound_by = bound(*work)
            library_ms = cuda_ms(library) if library else None
            results[kernel] = {"max_abs_err": 0, "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by,
                               "library_ms": library_ms}
            line += f", bound {bound_ms:.6f} ms ({bound_by})"
            if library_ms is not None:
                line += f", library {library_ms:.4f} ms"
        elif library:
            line += f", library {cuda_ms(library):.4f} ms"
        if library:
            # the library call's device time beside its CUDA-event time
            line += (f" ({device_kernels_per_op(library)[1] * 1e3:.2f} us "
                     "of device time, profiler)")
        log(line)
        entry = results[kernel]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return results


def phase_kernels(ctx) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    rng = np.random.default_rng(SEED)
    dev = ctx.device
    key, data = ctx.key_context_data, ctx.first_context_data
    q6, q5, t1 = key.ntt, data.ntt, ctx.plain_ntt.rns
    used = q6.select(keyswitch.used_limbs(data.limbs, key.limbs))
    v6, v5 = used.values, q5.values
    tool = data.rns
    k, nb = tool.k, tool.nb
    qb = tool.q_bsk
    lg = N.bit_length() - 1

    x_dec = _uniform(rng, [4 * q for q in v6], (5, 6, N), dev)
    x_inv = _uniform(rng, [2 * q for q in v6], (5, 6, N), dev)
    x_qb = _uniform(rng, [4 * q for q in qb.values], (4, k + nb, N), dev)
    x_t = _uniform(rng, [4 * t1.values[0]], (1, 1, N), dev)
    x_ti = _uniform(rng, [2 * t1.values[0]], (1, 1, N), dev)
    lazy5 = [4 * q for q in v5]
    a1, b1 = (_uniform(rng, lazy5, (1, 2, 5, N), dev) for _ in range(2))
    a5 = _uniform(rng, v6, (5, 6, N), dev)
    b5 = _uniform(rng, v6, (5, 2, 6, N), dev)
    # B's convolution over q u Bsk (BFV) and q, the decrypt's phase with
    # c0 in the sum and the powers' level rows read in place, the key
    # switch one level down (the key's rows read in place)
    c_a, c_b = (_uniform(rng, [4 * q for q in qb.values], (2, k + nb, N),
                         dev) for _ in range(2))
    c_q = _uniform(rng, v5, (2, 2, 5, N), dev)
    d_pow = _uniform(rng, q6.values, (2, 6, N), dev)
    d_c = _uniform(rng, v5, (3, 5, N), dev)
    d_many = _uniform(rng, v5, (3, 3, 5, N), dev)
    used4 = q6.select(keyswitch.used_limbs(4, key.limbs))
    ks_t = _uniform(rng, used4.values, (4, 5, N), dev)
    xq = _full(rng, (4, 5, N), dev)
    xb = _full(rng, (3, tool.b_to_q_m_sk.k_in, N), dev)
    ra, rb = (_uniform(rng, v5, (3, 5, N), dev) for _ in range(2))
    xs = _full(rng, (3, 5, N), dev)
    w, wq = q5.scalar_operand([int(data.plain_modulus)] * 5)
    # E: lift (4, 5, n), tail (3, 5 + 6, n), decrypt rounding (5, n)
    e_lift = _uniform(rng, v5, (4, 5, N), dev)
    e_tail = _uniform(rng, qb.values, (3, k + nb, N), dev)
    e_dec = _uniform(rng, v5, (5, N), dev)
    e_tg = _uniform(rng, [tool.host.t, tool.host.gamma], (2, N), dev)
    # F: digits (5, n) -> (5, 6, n); divide-round (2, 6, n) onto (c0, c1);
    # K: (2, 5, n) -> (2, 4, n)
    f_target = _uniform(rng, v5, (5, N), dev)
    f_x = _uniform(rng, v6, (2, 6, N), dev)
    f_acc = _uniform(rng, v5, (2, 5, N), dev)
    f_consts = keyswitch.divide_round_consts(q5, v6[-1])
    k_x = _uniform(rng, v5, (2, 5, N), dev)
    k_consts = keyswitch.divide_round_consts(q5.slice(0, 4), v5[-1])
    # M: (2, 5, n), the rotation by one step, both forms
    elt = 3
    src, keep = galois.coeff_permutation(N, elt, dev)
    perm = galois.ntt_permutation(N, elt, dev)
    c_table, n_table = galois.coeff_table(N, elt, dev), galois.ntt_table(
        N, elt, dev)
    m_x = _uniform(rng, v5, (2, 5, N), dev)

    def ntt_work(x, t):
        rows = x.numel() // N
        return (_bytes(x, x, t.root_powers, t.root_powers_shoup),
                rows * (N // 2) * lg * 3 + rows * N * 3)

    conv_mul = lambda c, rows: rows * N * (c.k_in * 3 + c.k_in * c.k_out * 2
                                           + c.k_out * 5)
    checks = [
        # (kernel, variant, kernel call, plain call, (bytes, mul64),
        #  library call or None); the first of each kernel is the one whose
        # numbers stand in the JSON line
        ("A_ntt", "forward k=6 (5,6,n)",
         lambda: ntt.rns_ntt_forward(x_dec, used),
         lambda: ntt.ntt_forward_plain(x_dec, used), ntt_work(x_dec, used),
         None),
        ("A_ntt", "forward k=6 (5,6,n) lazy",
         lambda: ntt.rns_ntt_forward(x_dec, used, lazy=True),
         lambda: ntt.ntt_forward_plain(x_dec, used, lazy=True), None, None),
        ("A_ntt", "forward q u Bsk k=11 (4,11,n) lazy",
         lambda: ntt.rns_ntt_forward(x_qb, qb, lazy=True),
         lambda: ntt.ntt_forward_plain(x_qb, qb, lazy=True), None, None),
        ("A_ntt", "inverse k=6 (5,6,n)",
         lambda: ntt.rns_ntt_inverse(x_inv, used),
         lambda: ntt.ntt_inverse_plain(x_inv, used), None, None),
        ("A_ntt", "inverse k=6 (5,6,n) lazy",
         lambda: ntt.rns_ntt_inverse(x_inv, used, lazy=True),
         lambda: ntt.ntt_inverse_plain(x_inv, used, lazy=True), None, None),
        ("A_ntt", "forward k=1 mod t", lambda: ntt.rns_ntt_forward(x_t, t1),
         lambda: ntt.ntt_forward_plain(x_t, t1), None, None),
        ("A_ntt", "forward k=1 mod t lazy",
         lambda: ntt.rns_ntt_forward(x_t, t1, lazy=True),
         lambda: ntt.ntt_forward_plain(x_t, t1, lazy=True), None, None),
        ("A_ntt", "inverse k=1 mod t", lambda: ntt.rns_ntt_inverse(x_ti, t1),
         lambda: ntt.ntt_inverse_plain(x_ti, t1), None, None),
        ("A_ntt", "inverse k=1 mod t lazy",
         lambda: ntt.rns_ntt_inverse(x_ti, t1, lazy=True),
         lambda: ntt.ntt_inverse_plain(x_ti, t1, lazy=True), None, None),
        ("B_dyadic_mac", "J=5 key switch (5,6,n)x(5,2,6,n)",
         lambda: ntt.dyadic_mac(a5, b5, used),
         lambda: ntt.dyadic_mac_plain(a5.unsqueeze(1), b5, used),
         (_bytes(a5, b5) + 2 * 6 * N * 8, 2 * 6 * N * (5 * 2 + 5)), None),
        ("B_dyadic_mac", "J=1 lazy (2,5,n)",
         lambda: ntt.dyadic_mac(a1, b1, q5),
         lambda: ntt.dyadic_mac_plain(a1, b1, q5), None, None),
        ("B_dyadic_mac", f"convolve q u Bsk (2,{k + nb},n)^2 lazy",
         lambda: ntt.dyadic_convolve(c_a, c_b, qb),
         lambda: ntt.dyadic_convolve_plain(c_a, c_b, qb), None, None),
        ("B_dyadic_mac", f"square q u Bsk (2,{k + nb},n) lazy",
         lambda: ntt.dyadic_convolve(c_a, c_a, qb),
         lambda: ntt.dyadic_convolve_plain(c_a, c_a, qb), None, None),
        ("B_dyadic_mac", "convolve q (2,5,n)x(2,5,n)",
         lambda: ntt.dyadic_convolve(c_q[0], c_q[1], q5),
         lambda: ntt.dyadic_convolve_plain(c_q[0], c_q[1], q5), None,
         None),
        ("B_dyadic_mac", "decrypt c0 + c1 s + c2 s^2 (5,n), powers' slice",
         lambda: ntt.dyadic_mac(d_c[1:], d_pow[:, :5], q5, addend=d_c[0]),
         lambda: ntt.dyadic_mac_plain(d_c[1:], d_pow[:, :5], q5, d_c[0]),
         None, None),
        ("B_dyadic_mac", "decrypt_many of 3 (3,3,5,n), c0s in the sum",
         lambda: ntt.dyadic_mac_batched(d_pow[:, :5].unsqueeze(1),
                                        d_many[:, 1:], q5,
                                        addend=d_many[:, :1]),
         lambda: ntt.dyadic_mac_plain(
             d_many[:, 1:].transpose(0, 1).unsqueeze(2),
             d_pow[:, :5].unsqueeze(1).unsqueeze(1), q5, d_many[:, :1]),
         None, None),
        ("B_dyadic_mac", "key switch one level down (4,5,n)x(4,2,6 rows,n)",
         lambda: ntt.dyadic_mac(ks_t, b5[:4], used4),
         lambda: ntt.dyadic_mac_plain(ks_t.unsqueeze(1),
                                      ntt.key_rows_plain(b5[:4], 5), used4),
         None, None),
        ("C_base_convert", f"q->Bsk (4,5,n)->(4,{nb},n)",
         lambda: rns.fast_convert(xq, tool.q_to_bsk),
         lambda: rns.fast_convert_plain(xq, tool.q_to_bsk),
         (_bytes(xq, tool.q_to_bsk.consts) + 4 * nb * N * 8,
          conv_mul(tool.q_to_bsk, 4)), None),
        ("C_base_convert", "q->Bsk+m~ (4,5,n)",
         lambda: rns.fast_convert(xq, tool.q_to_bsk_m_tilde),
         lambda: rns.fast_convert_plain(xq, tool.q_to_bsk_m_tilde),
         None, None),
        ("C_base_convert", "B->q+m_sk (3,|B|,n)",
         lambda: rns.fast_convert(xb, tool.b_to_q_m_sk),
         lambda: rns.fast_convert_plain(xb, tool.b_to_q_m_sk), None, None),
        ("C_base_convert", "q->{t,gamma} (3,5,n)",
         lambda: rns.fast_convert(xq[:3], tool.q_to_t_gamma),
         lambda: rns.fast_convert_plain(xq[:3], tool.q_to_t_gamma),
         None, None),
        ("C_base_convert", "q->{t,gamma} times t gamma, decrypt (5,n)",
         lambda: rns.fast_convert(e_dec, tool.q_to_t_gamma_scaled),
         lambda: rns.fast_convert_plain(e_dec, tool.q_to_t_gamma_scaled),
         None, None),
        ("D_rns_elementwise", "scalar_mul (3,5,n)",
         lambda: poly._elementwise(poly.SCALAR_MUL, xs, None, q5, w, wq),
         lambda: poly.rns_elementwise_plain(poly.SCALAR_MUL, xs, None, q5,
                                            w, wq),
         (_bytes(xs, xs), xs.numel() * 3), None),
        ("D_rns_elementwise", "add (3,5,n)",
         lambda: poly.rns_add(ra, rb, q5),
         lambda: poly.rns_elementwise_plain(poly.ADD, ra, rb, q5), None,
         None),
        ("D_rns_elementwise", "sub (3,5,n)",
         lambda: poly.rns_sub(ra, rb, q5),
         lambda: poly.rns_elementwise_plain(poly.SUB, ra, rb, q5), None,
         None),
        ("D_rns_elementwise", "neg (3,5,n)", lambda: poly.rns_neg(ra, q5),
         lambda: poly.rns_elementwise_plain(poly.NEG, ra, None, q5), None,
         None),
        *d_fused_checks(rng, q5, q6, dev),
        ("E_behz", f"tail (3,{k}+{nb},n)->(3,{k},n)",
         lambda: rns.behz_tail(e_tail, tool),
         lambda: rns.behz_tail_plain(e_tail, tool),
         behz_work(tool, 3, True), None),
        ("E_behz", f"lift (4,{k},n)->(4,{nb},n)",
         lambda: rns.behz_lift(e_lift, tool),
         lambda: rns.behz_lift_plain(e_lift, tool), None, None),
        ("E_behz", "decrypt rounding (2,n)->(n)",
         lambda: rns.behz_decrypt_round(e_tg, tool),
         lambda: rns.behz_decrypt_round_plain(e_tg, tool), None, None),
        ("E_behz", f"decrypt C + E ({k},n)->(n)",
         lambda: rns.decrypt_scale_and_round(e_dec, tool),
         lambda: rns.decrypt_scale_and_round_plain(e_dec, tool), None,
         None),
        # C's conversion and E's rounding in A's last inverse pass, from
        # the NTT-form phase: the phase in, the words out, the inverse
        # twiddles; A's products over k rows, C's (7 k + 10) and E's 11 a
        # coefficient
        ("ACi_decrypt_intt", f"inverse + C + E ({k},n)->(n)",
         lambda: rns.ntt_inverse_decrypt_scale_and_round(e_dec, tool),
         lambda: rns.ntt_inverse_decrypt_scale_and_round_plain(e_dec, tool),
         (_bytes(e_dec, tool.q.inv_root_powers, tool.q.inv_root_powers_shoup)
          + N * 8, ntt_rows_mul64(k) + N * (7 * k + 21)), None),
        ("ACi_decrypt_intt", f"inverse + C + E (3,{k},n)->(3,n)",
         lambda: rns.ntt_inverse_decrypt_scale_and_round(ra, tool),
         lambda: rns.ntt_inverse_decrypt_scale_and_round_plain(ra, tool),
         None, None),
        ("F_keyswitch", "divide-round (2,6,n) onto (c0,c1) -> (2,5,n)",
         lambda: keyswitch.divide_round_last(f_x, f_consts, f_acc),
         lambda: keyswitch.divide_round_last_plain(f_x, f_consts, f_acc),
         (_bytes(f_x, f_acc, f_acc), 2 * N * 5 * 5), None),
        ("F_keyswitch", "digits (5,n)->(5,6,n)",
         lambda: keyswitch.keyswitch_digits(f_target, used),
         lambda: keyswitch.keyswitch_digits_plain(f_target, used),
         None, None),
        # F's divide in A's last inverse pass, from the NTT-form products:
        # the products and the accumulator in, the result out, the inverse
        # twiddles; A's products over 12 rows and F's 5 a word
        ("AFi_keyswitch_intt", "inverse + divide (2,6,n) onto (c0,c1)",
         lambda: keyswitch.ntt_inverse_divide_round(f_x, used, f_consts,
                                                    f_acc),
         lambda: keyswitch.ntt_inverse_divide_round_plain(f_x, used,
                                                          f_consts, f_acc),
         (_bytes(f_x, f_acc, f_acc, used.inv_root_powers,
                 used.inv_root_powers_shoup),
          ntt_rows_mul64(12) + 2 * N * 5 * 5), None),
        ("AFi_keyswitch_intt", "inverse + divide (8,6,n) onto c0 pairs",
         lambda: keyswitch.ntt_inverse_divide_round(a5[:4].repeat(2, 1, 1),
                                                    used, f_consts,
                                                    f_acc[:1, None], 2),
         lambda: keyswitch.ntt_inverse_divide_round_plain(
             a5[:4].repeat(2, 1, 1), used, f_consts, f_acc[:1, None], 2),
         None, None),
        # F's digits in A's first pass: the target in once, the transformed
        # digits out once, the twiddles; A's products over 30 rows and a
        # Barrett-64 (2) a digit word
        ("AF_ntt_digits", "digits + forward (5,n)->(5,6,n)",
         lambda: ntt.rns_ntt_forward_digits(f_target, used),
         lambda: ntt.ntt_forward_digits_plain(f_target, used),
         (_bytes(f_target, x_dec, used.root_powers, used.root_powers_shoup),
          ntt_rows_mul64(30) + 30 * N * 2), None),
        ("AF_ntt_digits", "digits + forward (2,5,n)->(2,5,6,n), any words",
         lambda: ntt.rns_ntt_forward_digits(xq[:2], used),
         lambda: ntt.ntt_forward_digits_plain(xq[:2], used), None, None),
        ("K_divide_round", "mod switch (2,5,n)->(2,4,n)",
         lambda: keyswitch.divide_and_round_q_last(k_x, q5),
         lambda: keyswitch.divide_round_last_plain(k_x, k_consts),
         (_bytes(k_x) + 2 * 4 * N * 8, 2 * N * 4 * 5), None),
        *embed_checks(rng, data, q5, dev),
        ("M_galois", "signed gather (2,5,n), elt 3",
         lambda: galois.permute(m_x, c_table, q5),
         lambda: galois.apply_permutation_signed_plain(m_x, src, keep, q5),
         (_bytes(m_x, m_x), 0),            # src and keep follow from elt
         lambda: m_x.index_select(-1, perm)),
        ("M_galois", "NTT-form gather (2,5,n), elt 3",
         lambda: galois.permute(m_x, n_table),
         lambda: galois.apply_permutation_plain(m_x, perm), None,
         lambda: m_x.index_select(-1, perm)),
        # after each kernel's first check, which stands in the JSON line
        *k_checks(rng, dev, q6, v6, f_consts),
    ]
    results = run_checks("3", [(c[0], c[1], "words") + c[2:]
                               for c in checks])
    # H: the batch encoder's slot scatter and gather are kernel M's
    # unsigned gather over one (n,) row mod t
    be = P.BatchEncoder(ctx)
    slots = to_torch(rng.integers(0, t1.values[0], N, dtype=np.uint64), dev)
    index_map = be._index_map.long()      # the packed table's indices
    h = run_checks("3", [
        ("H_batch_slots", "M gather (n,) by the slot index map", "words",
         lambda: galois.permute(slots, be._index_map),
         lambda: galois.apply_permutation_plain(slots, index_map),
         (_bytes(slots, slots), 0),        # the map is computable from n
         lambda: slots.index_select(-1, index_map))])
    results["H_batch_slots"] = h["H_batch_slots"]
    return results


def k_checks(rng, dev, q6, v6, f_consts) -> list:
    """Phase 3's checks of K's kernel (``keyswitch.divide_and_round_q_last``
    and F's divide on J's route, ``keyswitch.divide_round_last``) against
    its plain version: the mod switch at k = 1, at odd component counts,
    at 16 and 17 limbs (the last limb group full, then one limb), with the
    last row at 0,
    p - 1 and p/2 +- 1 (where the rounding turns) and the data rows at 0
    and q - 1; F's divide in the accumulator layouts its J route uses:
    onto c0 alone (a Galois key switch), onto c0 of each pair with one
    row each (the batched fold) and one row for all (the hoisted path)."""
    def level(bits):
        return ntt.RnsNttTables.from_moduli(
            N, [int(m) for m in P.CoeffModulus.create(N, bits)], dev)

    def mod_switch(tag, t, comps, x=None):
        x = _uniform(rng, t.values, (comps, t.k, N), dev) if x is None else x
        consts = keyswitch.divide_round_consts(t.slice(0, t.k - 1),
                                               t.values[-1])
        return ("K_divide_round", f"mod switch {tag}",
                lambda: keyswitch.divide_and_round_q_last(x, t),
                lambda: keyswitch.divide_round_last_plain(x, consts),
                None, None)

    q5 = q6.slice(0, 5)
    edge = _edge(rng, q5.values, (2, 5, N), dev)
    p = q5.values[-1]
    turns = [0, p - 1, p // 2 - 1, p // 2, p // 2 + 1]
    edge[:, 4, :len(turns)] = to_torch(np.array(turns, dtype=np.uint64),
                                       dev)
    checks = [mod_switch("(2,5,n) edge words", q5, 2, edge),
              mod_switch("(2,2,n)->(2,1,n): k = 1", level(Q_BITS[:2]), 2),
              mod_switch("(3,5,n)->(3,4,n): odd components", q5, 3),
              mod_switch("(1,5,n)->(1,4,n)", q5, 1),
              mod_switch("(2,17,n)->(2,16,n): full limb groups",
                         level([50] * 17), 2),
              mod_switch("(3,18,n)->(3,17,n): a one-limb group",
                         level([50] * 18), 3)]
    v5 = v6[:5]
    x8 = _uniform(rng, v6, (8, 6, N), dev)
    acc_c0 = _uniform(rng, v5, (1, 5, N), dev)
    acc_pairs = _uniform(rng, v5, (4, 1, 5, N), dev)
    acc_one = _uniform(rng, v5, (1, 1, 5, N), dev)
    for tag, x, acc, group in (
            ("(2,6,n) onto c0", x8[:2], acc_c0, None),
            ("(8,6,n) onto c0 of each pair", x8, acc_pairs, 2),
            ("(8,6,n) onto c0 of every pair, one row", x8, acc_one, 2),
            ("(8,6,n), no accumulator", x8, None, None)):
        checks.append((
            "F_keyswitch", f"divide-round {tag}",
            lambda x=x, acc=acc, group=group: keyswitch.divide_round_last(
                x, f_consts, acc, group),
            lambda x=x, acc=acc, group=group:
                keyswitch.divide_round_last_plain(x, f_consts, acc, group),
            None, None))
    return checks


def embed_work(t, groups: int, words_in: int, words_out: int) -> tuple:
    """bound() arguments of a G or DG launch over ``groups`` (k, n) groups
    of t's base: words_in and words_out (k, n) rows a group in and out
    (operands, copies), the m rows and the constants once; a coefficient's
    fix once (10 products: the 128-bit product, the Barrett-128, the odd
    inverse) and each limb's term (5: Shoup and Barrett-64)."""
    k, n = t.k, t.n
    return ((groups * ((words_in + words_out) * k + 1) * n
             + 7 + 4 * k) * 8,
            groups * n * (10 + 5 * k))


def embed_inputs(rng, data, q5, dev, lead):
    """m (lead, n) mod t with the edge words 0, t - 1, (t - 1)/2 and
    (t + 1)/2 first, and the embedding's arguments at the headline's data
    level."""
    tt = int(data.plain_modulus)
    m = rng.integers(0, tt, lead + (N,), dtype=np.uint64)
    m[..., :4] = [0, tt - 1, (tt - 1) // 2, (tt + 1) // 2]
    return to_torch(m, dev), rlwe.bfv_embed_args(data) + (q5,)


def embed_checks(rng, data, q5, dev) -> list:
    """Phase 3's checks of G (the plain embedding on D's grid) and DG (D's
    zero-encryption finish with it) against their plain versions, word for
    word, on random words and on the edge words (m at 0, t - 1, (t - 1)/2,
    (t + 1)/2; the operands at 0 and q - 1): G at m (n) onto c0 (5, n) (the
    JSON line's), a batch of MANY, add_plain's new ciphertext with c1
    copied, the subtract; DG's symmetric finish into c0 of a ciphertext
    (5, n), a batch of MANY into c0 with c1 copied, and the public-key
    finish (2, 5, n) with the embedding on c0."""
    g_checks, dg_checks = [], []

    def into_batch(xb, yb, mb, c1b, args, out):
        poly.zero_sym_embed(xb, yb, mb, *args, out=out[:, 0], c1=c1b)
        return out

    for kind, draw in (("random", _uniform), ("edge", _edge)):
        m1, args = embed_inputs(rng, data, q5, dev, ())
        mb, _ = embed_inputs(rng, data, q5, dev, (MANY,))
        c0 = draw(rng, q5.values, (5, N), dev)
        cb, xb, yb, c1b = (draw(rng, q5.values, (MANY, 5, N), dev)
                           for _ in range(4))
        ct = draw(rng, q5.values, (2, 5, N), dev)
        out1 = torch.empty((2, 5, N), dtype=torch.int64, device=dev)
        outb = torch.empty((MANY, 2, 5, N), dtype=torch.int64, device=dev)
        g_checks += [
            ("G_plain_embed", f"m (n) onto c0 (5,n) {kind}",
             lambda m1=m1, c0=c0: poly.bfv_plain_embed(m1, c0, *args),
             lambda m1=m1, c0=c0: poly.bfv_multiply_add_plain(m1, c0, *args),
             embed_work(q5, 1, 1, 1) if kind == "random" else None, None),
            ("G_plain_embed", f"m ({MANY},n) onto c0 ({MANY},5,n) {kind}",
             lambda mb=mb, cb=cb: poly.bfv_plain_embed(mb, cb, *args),
             lambda mb=mb, cb=cb: poly.bfv_multiply_add_plain(mb, cb, *args),
             None, None),
            ("G_plain_embed", f"add_plain (2,5,n), c1 copied {kind}",
             lambda m1=m1, ct=ct: poly.bfv_plain_embed_c0(ct, m1, *args),
             lambda m1=m1, ct=ct: torch.cat([poly.bfv_multiply_add_plain(
                 m1, ct[0], *args).unsqueeze(0), ct[1:]]), None, None),
            ("G_plain_embed", f"sub_plain (2,5,n), c1 copied {kind}",
             lambda m1=m1, ct=ct: poly.bfv_plain_embed_c0(ct, m1, *args,
                                                          subtract=True),
             lambda m1=m1, ct=ct: torch.cat([poly.bfv_multiply_add_plain(
                 m1, ct[0], *args, subtract=True).unsqueeze(0), ct[1:]]),
             None, None)]
        x, y = ct[0], c0
        dg_checks += [
            ("DG_zero_embed", f"symmetric finish into c0 (5,n) {kind}",
             lambda m1=m1, x=x, y=y, o=out1: poly.zero_sym_embed(
                 x, y, m1, *args, out=o[0]),
             lambda m1=m1, x=x, y=y: poly.zero_sym_embed_plain(x, y, m1,
                                                               *args),
             embed_work(q5, 1, 2, 1) if kind == "random" else None, None),
            ("DG_zero_embed",
             f"symmetric finish ({MANY},5,n) into c0, c1 copied {kind}",
             lambda mb=mb, xb=xb, yb=yb, c1b=c1b, o=outb, a=args:
                 into_batch(xb, yb, mb, c1b, a, o),
             lambda mb=mb, xb=xb, yb=yb, c1b=c1b: torch.stack(
                 [poly.zero_sym_embed_plain(xb, yb, mb, *args), c1b], dim=1),
             None, None),
            ("DG_zero_embed", f"public-key finish (2,5,n), m on c0 {kind}",
             lambda m1=m1, ct=ct, xb=xb: poly.zero_asym_embed(
                 ct, xb[:2], m1, *args),
             lambda m1=m1, ct=ct, xb=xb: poly.zero_asym_embed_plain(
                 ct, xb[:2], m1, *args), None, None)]
    return g_checks + dg_checks


def d_fused_checks(rng, q5, q6, dev) -> list:
    """Phase 3's checks of D's fused forms at the headline's shapes, on
    random words and on the edge words 0 and q - 1: one encryption's finish
    m - (x + y) in place into its ciphertext (5, n), a batch of MANY into
    c0 with c1 copied, the public-key finish (2, 5, n) with m on c0, the
    switching-key rows (5, 6, n) with P w, the balanced add and sub
    (2, 5, n)."""
    checks = []
    for kind, draw in (("random", _uniform), ("edge", _edge)):
        x5, y5, m5 = (draw(rng, q5.values, (5, N), dev) for _ in range(3))
        xb, yb, mb, cb = (draw(rng, q5.values, (MANY, 5, N), dev)
                          for _ in range(4))
        xa, ya = (draw(rng, q5.values, (2, 5, N), dev) for _ in range(2))
        xk, yk, ak = (draw(rng, q6.values, (5, 6, N), dev) for _ in range(3))
        wk = draw(rng, q6.values, (6, N), dev)
        special = q6.values[-1]

        def batch(xb=xb, yb=yb, mb=mb, cb=cb):
            ct = torch.empty((MANY, 2, 5, N), dtype=torch.int64, device=dev)
            poly.zero_sym_finish(xb, yb, q5, mb, out=ct[:, 0], c1=cb)
            return ct

        checks += [
            ("D_rns_elementwise", f"zero finish m-(x+y) into c0 (5,n) {kind}",
             lambda x5=x5, y5=y5, m5=m5: poly.zero_sym_finish(
                 x5, y5, q5, m5, out=torch.empty(
                     (2, 5, N), dtype=torch.int64, device=dev)[0]),
             lambda x5=x5, y5=y5, m5=m5: poly.zero_sym_finish_plain(
                 x5, y5, q5, m5), None, None),
            ("D_rns_elementwise", f"zero finish -(x+y) (5,n) {kind}",
             lambda x5=x5, y5=y5: poly.zero_sym_finish(x5, y5, q5),
             lambda x5=x5, y5=y5: poly.zero_sym_finish_plain(x5, y5, q5),
             None, None),
            ("D_rns_elementwise",
             f"zero finish ({MANY},5,n) into c0, c1 copied {kind}", batch,
             lambda xb=xb, yb=yb, mb=mb, cb=cb: torch.stack(
                 [poly.zero_sym_finish_plain(xb, yb, q5, mb), cb], dim=1),
             None, None),
            ("D_rns_elementwise", f"public-key finish (2,5,n) + m {kind}",
             lambda xa=xa, ya=ya, m5=m5: poly.zero_asym_finish(
                 xa, ya, q5, m5),
             lambda xa=xa, ya=ya, m5=m5: poly.zero_asym_finish_plain(
                 xa, ya, q5, m5), None, None),
            ("D_rns_elementwise", f"key rows (5,6,n) + P w {kind}",
             lambda xk=xk, yk=yk, ak=ak, wk=wk: poly.switching_key_rows(
                 xk, yk, ak, wk, special, q6),
             lambda xk=xk, yk=yk, ak=ak, wk=wk: torch.stack(
                 [poly.key_rows_finish_plain(xk, yk, wk, special, q6), ak],
                 dim=1), None, None)]
        for subtract in (False, True):
            checks.append((
                "D_rns_elementwise",
                f"balanced {'sub' if subtract else 'add'} (2,5,n) {kind}",
                lambda xa=xa, ya=ya, s=subtract: poly.balanced_add(
                    xa, ya, 3, 786431, q5, s),
                lambda xa=xa, ya=ya, s=subtract: poly.balanced_add_plain(
                    xa, ya, 3, 786431, q5, s), None, None))
    return checks


def max_abs_diff(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| over the words, read as unsigned 64-bit."""
    bad = got != want
    if not bool(bad.any()):
        return 0
    g = to_numpy(got[bad]).astype(object)
    w = to_numpy(want[bad]).astype(object)
    return int(max(abs(a - b) for a, b in zip(g, w)))


class PlainCallCounter:
    """Counts calls of the u64ops arithmetic and of every ``*_plain``
    function that get a CUDA tensor: on the main path on the card there
    must be none. Installed by replacing each function in every module of
    the package that holds it, so calls through any name are seen."""

    U64_HOST_HELPERS = {"s64", "u64", "shoup_quotient"}

    def __init__(self):
        self.calls = {}
        pkg = [m for name, m in list(sys.modules.items())
               if name.startswith("troy_tpu_torch") and m is not None]
        u64ops = sys.modules["troy_tpu_torch.ops.u64ops"]
        targets = {}
        for module in pkg:
            for name, fn in vars(module).items():
                if not callable(fn) or getattr(fn, "__module__", None) \
                        != module.__name__:
                    continue
                if name.endswith("_plain") or (
                        module is u64ops and not name.startswith("_")
                        and name not in self.U64_HOST_HELPERS
                        and not isinstance(fn, type)):
                    targets[fn] = f"{module.__name__}.{name}"
        wrapped = {fn: self._wrap(fn, label) for fn, label in targets.items()}
        for module in pkg:
            for name, fn in list(vars(module).items()):
                if callable(fn) and fn in wrapped:
                    setattr(module, name, wrapped[fn])
        self.wrapped = len(wrapped)

    @staticmethod
    def counts(arg) -> bool:
        return isinstance(arg, torch.Tensor) and arg.is_cuda

    def _wrap(self, fn, label):
        def counted(*args, **kwargs):
            if any(self.counts(a) for a in (*args, *kwargs.values())):
                self.calls[label] = self.calls.get(label, 0) + 1
            return fn(*args, **kwargs)
        return counted


class DecryptRecorder:
    """The decrypts of the count windows it is installed around
    (``window``): a plain counter on the decryptor's last step
    (``decryptor._decrypt_phase``: one call a BFV or BGV decrypt or
    decrypt_many), which keeps, at the first call of each shape, the
    level and the inverse correction factor (no copy of the operands,
    so that the window's timed calls carry one count and one lookup), and
    the windows that made calls of that shape. The fused calls are read
    off the entry counters (AXi's and ACi's entries over the window) and
    must match the counter on A's route. Phase 35's redesign_decrypt
    replays every recorded shape on fresh words."""

    ENTRIES = {"AXi": "troy_ntt_inverse_decrypt_bgv",
               "ACi": "troy_ntt_inverse_decrypt_bfv"}

    def __init__(self):
        self.seen = {"AXi": {}, "ACi": {}}    # shape -> (cd, inv_cf, windows)
        self.counts = {}                      # window -> calls

    @contextlib.contextmanager
    def window(self, tag: str):
        counts = self.counts.setdefault(tag, {"decrypts": 0, "AXi": 0,
                                              "ACi": 0})
        last_step = decryptor._decrypt_phase
        seen = self.seen

        def counted(phase, cd, inv_cf=1):
            counts["decrypts"] += 1
            kind = "AXi" if cd.scheme == P.SchemeType.bgv else "ACi"
            shape = tuple(phase.shape)
            if shape not in seen[kind]:
                seen[kind][shape] = (cd, inv_cf, set())
            seen[kind][shape][2].add(tag)
            return last_step(phase, cd, inv_cf)

        before = _kernels.entry_launch_counts()
        decryptor._decrypt_phase = counted
        try:
            yield
        finally:
            decryptor._decrypt_phase = last_step
        after = _kernels.entry_launch_counts()
        for kind, entry in self.ENTRIES.items():
            counts[kind] += after[entry] - before[entry]
        log(f"[{tag}] BFV and BGV decrypts on the card in the window: "
            f"{counts['decrypts']}; ACi calls {counts['ACi']}, AXi calls "
            f"{counts['AXi']}")
        if counts["ACi"] + counts["AXi"] != counts["decrypts"]:
            raise AssertionError(f"{tag}: {counts} - not one fused call a "
                                 "decrypt on A's route")


DECRYPTS = DecryptRecorder()


def phase_fixture(ctx) -> tuple:
    raw = P.interop.load_records(FIXTURE)
    if (list(ctx.key_context_data.coeff_values) != [int(x) for x in raw["q"]]
            or int(ctx.key_context_data.plain_modulus) != int(raw["t"][0])):
        raise AssertionError("moduli differ from the fixture's")

    def same(tensor, name):
        if not np.array_equal(to_numpy(tensor).reshape(-1), raw[name]):
            raise AssertionError(f"fixture record {name!r} differs")
        log(f"[4] {name}: word-equal to troy's C++ vectors")

    t0 = time.perf_counter()
    kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(SEED),
                        host_sampling=True)
    rlk = kg.create_relin_keys()
    log(f"[4] host keygen (sk + relin key): "
        f"{time.perf_counter() - t0:.1f} s")
    same(kg.secret_key.data, "sk")
    same(rlk.keys[2][0], "rlk_0")
    t0 = time.perf_counter()
    gk = kg.create_galois_keys(steps=[1])
    log(f"[4] host keygen (Galois key, step 1): "
        f"{time.perf_counter() - t0:.1f} s")
    same(gk.keys[3][0], "gk_0")
    be = P.BatchEncoder(ctx)
    t = int(raw["t"][0])
    v1 = np.array([(i * i + 3 * i + 1) % t for i in range(N)], np.uint64)
    v2 = np.array([(7 * i + 2) % t for i in range(N)], np.uint64)
    cts = []
    for vals, tag in ((v1, "c1"), (v2, "c2")):
        enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                          seed=rnd.seed_from_uint64(SEED), host_sampling=True)
        cts.append(enc.encrypt_symmetric(be.encode(vals)))
        same(cts[-1].data, tag)
    ev = P.Evaluator(ctx)
    prod = ev.multiply(*cts)
    same(prod.data, "prod")
    rel = ev.relinearize(prod, rlk)
    same(rel.data, "rel")
    same(ev.rotate_rows(rel, 1, gk).data, "rot")
    same(ev.mod_switch_to_next(rel).data, "ms")
    dec = P.Decryptor(ctx, kg.secret_key)
    got = be.decode(dec.decrypt(rel))
    if not np.array_equal(got, raw["dec_rel"]):
        raise AssertionError("decode(decrypt(rel)) differs from dec_rel")
    log("[4] dec_rel: word-equal to troy's C++ vectors")
    budget = dec.invariant_noise_budget(rel)
    if budget != int(raw["rel_budget"][0]):
        raise AssertionError(f"noise budget {budget} != rel_budget "
                             f"{int(raw['rel_budget'][0])}")
    log(f"[4] rel_budget: {budget} bits, equal to troy's")
    return kg, rlk, gk, be, ev, dec


def phase_requests(ctx, kg, rlk, gk, be, ev, dec) -> dict:
    t0 = time.perf_counter()
    more = kg.create_galois_keys(steps=[s for s in ROTATION_STEPS if s != 1])
    gk = P.GaloisKeys(keys={**gk.keys, **more.keys})
    log(f"[5] host keygen (Galois keys, steps -1, 4 and the column swap): "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 1)
    t = be.plain_modulus
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(SEED + 1))
    decode = lambda ct: be.decode(dec.decrypt(ct))
    for r in range(REQUESTS):
        a = rng.integers(0, t, N, dtype=np.uint64)
        b = rng.integers(0, t, N, dtype=np.uint64)
        ca = enc.encrypt_symmetric(be.encode(a))
        cb = enc.encrypt_symmetric(be.encode(b))
        rel = ev.relinearize(ev.multiply(ca, cb), rlk)
        want = (a.astype(object) * b.astype(object) % t).astype(np.uint64)
        rows = want.reshape(2, N // 2)
        expected = {
            "decrypt": (rel, want),
            "rotate_rows(1)": (ev.rotate_rows(rel, 1, gk),
                               np.roll(rows, -1, axis=1).reshape(-1)),
            "rotate_rows(3)": (ev.rotate_rows(rel, 3, gk),
                               np.roll(rows, -3, axis=1).reshape(-1)),
            "rotate_columns": (ev.rotate_columns(rel, gk),
                               rows[::-1].reshape(-1)),
            "mod_switch_to_next": (ev.mod_switch_to_next(rel), want),
        }
        for what, (ct, slots) in expected.items():
            if not np.array_equal(decode(ct), slots):
                raise AssertionError(f"request {r}: {what} decrypts to the "
                                     "wrong slots")
        log(f"[5] request {r}: a*b mod t, its rotations (rows by 1 and by "
            f"3 = 4 - 1, columns) and its mod switch decrypt to the "
            f"expected slots")
    times = {
        "mult_relin_ms": cuda_ms(
            lambda: ev.relinearize(ev.multiply(ca, cb), rlk)),
        "rotate_rows_ms": cuda_ms(lambda: ev.rotate_rows(rel, 1, gk)),
        "mod_switch_ms": cuda_ms(lambda: ev.mod_switch_to_next(rel)),
    }
    log(f"[5] medians over {TIMING_REPS} runs (CUDA events): "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return {"gk": gk, "ca": ca, "cb": cb, "rel": rel, **times}


# --------------------------------------------------------------------------
# CKKS
# --------------------------------------------------------------------------

def ckks_values():
    """The slot vectors troy's generator encoded into p1 and p2."""
    i = np.arange(N // 2)
    return 0.001 * (i % 2000) - 1.0, 0.0005 * (i % 3000) + 0.25


def phase_ckks_kernels(ctx) -> dict:
    """O1-O3 and K' against their plain versions at the CKKS shapes."""
    rng = np.random.default_rng(SEED + 7)
    dev = ctx.device
    key, data = ctx.key_context_data, ctx.first_context_data
    q5 = data.ntt
    k = q5.k
    t = embedding.make_embed_tables(N, dev)
    rt = embedding.make_rns_round_tables(q5)
    cplx = lambda m: torch.from_numpy(rng.uniform(-1, 1, m)
                                      + 1j * rng.uniform(-1, 1, m)).to(dev)
    slots = cplx(N // 2)
    spectrum = embedding.scatter_slots(slots, t)         # the library's input
    coeffs = torch.from_numpy(rng.uniform(-1, 1, N)).to(dev)
    twisted = coeffs * t.twist
    u = cplx(N) * 2.0 ** -7                  # |FFT(V)/n| for |v| <= 1
    res = _uniform(rng, q5.values, (k, N), dev)
    # O3 at the values around 0 and Q/2 and next to S's half-integers
    # (csrc/embedding.cu's tie correction), and one level down
    adv = to_numpy(res).copy()
    for i, v in enumerate(crt_values(rt.total, rng)):
        adv[:, i] = [v % qi for qi in q5.values]
    res_adv = to_torch(adv, dev)
    rt4 = embedding.make_rns_round_tables(q5.slice(0, k - 1))
    res4 = res[:k - 1].contiguous()
    # K': the rescale of a (2, 5, n) ciphertext; the key switch's divide of
    # (2, 6, n) products onto (c0, c1)
    x_rs = _uniform(rng, q5.values, (2, k, N), dev)
    used = key.ntt.select(keyswitch.used_limbs(k, key.limbs))
    ks_consts = keyswitch.divide_round_consts(q5, used.values[-1])
    x_ks = _uniform(rng, used.values, (2, k + 1, N), dev)
    acc_ks = _uniform(rng, q5.values, (2, k, N), dev)
    entries = {}
    for name, x, consts, acc in (("rs", x_rs, data.rescale_consts, None),
                                 ("ks", x_ks, ks_consts, acc_ks)):
        kk = x.shape[1] - 1
        last = _uniform(rng, [int(consts[5 * kk])], (2, 1, N), dev)[:, 0]
        entries[name] = (x, last, consts, acc, kk)
    fft_ops = 5 * N * (N.bit_length() - 1)
    W = rt.words

    def kprime(name, plain):
        x, last, consts, acc, kk = entries[name]
        ent = rns.RESCALE if name == "rs" else rns.KEYSWITCH
        if plain:
            return lambda: rns.divide_round_ntt_finish_plain(
                x, rns.divide_round_ntt_temps_plain(last, consts), consts,
                acc)
        return lambda: rns._ntt_finish(
            ent[1], x, rns._ntt_temps(ent[0], last, consts), consts, acc)

    def kprime_work(name):
        # the function's own data: x's kk rows and the last row in (with
        # the accumulator), kk rows out; not the temps between its launches
        x, last, consts, acc, kk = entries[name]
        rows = 2 * kk * N * 8
        return (_bytes(last) + rows * (2 if acc is None else 3),
                2 * N * kk * 4)

    def fused(name, plain):
        # K''s temps and finish in A's forward (AKp) over the kk limbs
        x, last, consts, acc, kk = entries[name]
        t = (q5.slice(0, kk), q5)[name == "ks"]
        if plain:
            return lambda: rns.ntt_forward_divide_plain(x, last, t, consts,
                                                        acc)
        ent = rns.RESCALE if name == "rs" else rns.KEYSWITCH
        return lambda: rns.ntt_forward_divide(ent[2], x, last, t, consts,
                                              acc)

    def fused_work(name):
        # K''s data and products, with A's twiddles and butterflies
        nbytes, mul64 = kprime_work(name)
        kk = entries[name][4]
        return nbytes + 2 * kk * N * 8, mul64 + ntt_rows_mul64(2 * kk)

    checks = [
        ("O1_ckks_fft", "encode (n/2,) slots -> (n,)", "close",
         lambda: embedding.embed_inverse_fft(slots, t),
         lambda: embedding.embed_inverse_fft_plain(slots, t),
         (_bytes(slots) + N * 16, 0, fft_ops),      # slots in, u out
         lambda: torch.fft.fft(spectrum)),
        ("O1_ckks_fft", "decode (n,) coefficients -> (n/2,) slots", "close",
         lambda: embedding.embed_forward(coeffs, t),
         lambda: embedding.embed_forward_plain(coeffs, t),
         None, lambda: torch.fft.ifft(twisted)),
        ("O2_ckks_round", f"(n,) -> ({k},n) at scale 2^40", "words",
         lambda: embedding.untwist_round_to_rns(u, CKKS_SCALE, t, rt),
         lambda: embedding.untwist_round_to_rns_plain(u, t.untwist,
                                                      CKKS_SCALE, rt),
         (_bytes(u) + k * N * 8, N * k * 4),
         None),
        ("O2_ckks_round", f"(n,) -> ({k},n) at scale 2^100", "words",
         lambda: embedding.untwist_round_to_rns(u, 2.0 ** 100, t, rt),
         lambda: embedding.untwist_round_to_rns_plain(u, t.untwist,
                                                      2.0 ** 100, rt),
         None, None),
        ("O3_ckks_compose", f"({k},n) -> (n,) times 2^-40", "bits",
         lambda: embedding.compose_centered(res, rt, 2.0 ** -40),
         lambda: embedding.compose_centered_plain(res, rt, 2.0 ** -40),
         (_bytes(res) + N * 8, N * k * (2 + 2 * W)),
         None),
        ("O3_ckks_compose", f"({k},n) values around 0, Q/2 and ties",
         "bits", lambda: embedding.compose_centered(res_adv, rt, 2.0 ** -40),
         lambda: embedding.compose_centered_plain(res_adv, rt, 2.0 ** -40),
         None, None),
        ("O3_ckks_compose", f"({k - 1},n) one level down", "bits",
         lambda: embedding.compose_centered(res4, rt4, 2.0 ** -40),
         lambda: embedding.compose_centered_plain(res4, rt4, 2.0 ** -40),
         None, None),
        ("Kp_rescale_ntt", f"temps + finish (2,{k},n) -> (2,{k - 1},n)",
         "words", kprime("rs", False), kprime("rs", True), kprime_work("rs"),
         None),
        ("Kp_keyswitch_ntt", f"temps + finish (2,{k + 1},n) onto (c0,c1)",
         "words", kprime("ks", False), kprime("ks", True), kprime_work("ks"),
         None),
        ("AKp_rescale_ntt", f"fused forward (2,{k},n) -> (2,{k - 1},n)",
         "words", fused("rs", False), fused("rs", True), fused_work("rs"),
         None),
        ("AKp_rescale_ntt", f"with A: rescale (2,{k},n) -> (2,{k - 1},n)",
         "words",
         lambda: rns.divide_and_round_q_last_ntt(x_rs, q5,
                                                 data.rescale_consts),
         lambda: rns.divide_and_round_q_last_ntt_plain(x_rs, q5,
                                                       data.rescale_consts),
         None, None),
        ("AKp_keyswitch_ntt", f"fused forward (2,{k + 1},n) onto (c0,c1)",
         "words", fused("ks", False), fused("ks", True), fused_work("ks"),
         None),
        ("AKp_keyswitch_ntt", f"with A: divide (2,{k + 1},n) onto (c0,c1)",
         "words",
         lambda: rns.divide_round_last_ntt(x_ks, q5, used.slice(k, k + 1),
                                           ks_consts, acc_ks),
         lambda: rns.ntt_forward_divide_plain(
             x_ks, ntt.ntt_inverse_plain(x_ks[:, k:], used.slice(
                 k, k + 1))[:, 0], q5, ks_consts, acc_ks),
         None, None),
    ]
    results = run_checks("7", checks + ao2p_checks(rng, dev, q5, t, rt, u))
    check_encodes_on_the_cpu(ctx, rng)
    return results


def round_work(t, twisted: bool, scaled_words: int = 0) -> tuple:
    """bound() arguments of one AO2p call into t's k rows: the source in
    once (16 bytes a word, 8 without an untwist; the untwist, as for O2,
    not counted), the k rows out and the twiddles once; A's butterfly
    products and the rounding's (a Barrett product a word and limb, and
    the Shoup product by 2^e mod q of the scaled_words with e > 0); its
    f64 products (3 a word with an untwist, 1 without)."""
    k, n = t.k, t.n
    return (n * (16 if twisted else 8) + 3 * k * n * 8,
            ntt_rows_mul64(k, n) + k * n + 2 * k * scaled_words,
            n * (3 if twisted else 1))


def ao2p_checks(rng, dev, q5, t, rt, u) -> list:
    """Phase 7's checks of AO2p (O2's rounding in A's first forward pass,
    ``embedding.rns_ntt_forward_round``) against O2's plain version then
    A's plain forward, word for word: the slot encode's (n) -> (k,n) with
    its untwist at scales 2^40 and 2^100 (the exponent path), the
    polynomial encode's real words without one, at n = 1024 and 512 (two
    passes and one), and against O2 + A themselves."""
    k = q5.k
    coeffs = torch.from_numpy(rng.uniform(-1, 1, N) * 2.0 ** 10).to(dev)

    def pair(uu, untwist, scale, tables, rtt):
        return (lambda: embedding.rns_ntt_forward_round(uu, untwist, scale,
                                                        rtt, tables),
                lambda: embedding.ntt_forward_round_plain(uu, untwist, scale,
                                                          rtt, tables))

    checks = [
        ("AO2p_ntt_round", f"(n,) -> ({k},n) untwisted at scale 2^40",
         "words", *pair(u, t.untwist, CKKS_SCALE, q5, rt),
         round_work(q5, True), None),
        ("AO2p_ntt_round", f"(n,) -> ({k},n) untwisted at scale 2^100",
         "words", *pair(u, t.untwist, 2.0 ** 100, q5, rt), None, None),
        ("AO2p_ntt_round", f"(n,) f64 -> ({k},n) at scale 2^40", "words",
         *pair(coeffs, None, CKKS_SCALE, q5, rt), None, None),
        ("AO2p_ntt_round", f"(n,) f64 -> ({k},n) at scale 2^100", "words",
         *pair(coeffs, None, 2.0 ** 100, q5, rt), None, None),
        ("AO2p_ntt_round", f"with O2 + A: (n,) -> ({k},n) at 2^100",
         "words",
         lambda: embedding.rns_ntt_forward_round(u, t.untwist, 2.0 ** 100,
                                                 rt, q5),
         lambda: ntt.rns_ntt_forward(embedding.untwist_round_to_rns(
             u, 2.0 ** 100, t, rt), q5), None, None),
    ]
    for n in (1024, 512):
        tn = ntt.RnsNttTables.from_moduli(
            n, [int(m) for m in P.CoeffModulus.create(n, Q_BITS[:k])], dev)
        en = embedding.make_embed_tables(n, dev)
        rtn = embedding.make_rns_round_tables(tn)
        un = torch.from_numpy((rng.uniform(-1, 1, n)
                               + 1j * rng.uniform(-1, 1, n)) * 2.0 ** -7
                              ).to(dev)
        cn = torch.from_numpy(rng.uniform(-1, 1, n) * 2.0 ** 10).to(dev)
        checks += [
            ("AO2p_ntt_round", f"(n,) -> ({k},n) untwisted, n = {n}",
             "words", *pair(un, en.untwist, CKKS_SCALE, tn, rtn), None,
             None),
            ("AO2p_ntt_round", f"(n,) f64 -> ({k},n) at 2^100, n = {n}",
             "words", *pair(cn, None, 2.0 ** 100, tn, rtn), None, None),
        ]
    return checks


def check_encodes_on_the_cpu(ctx, rng) -> None:
    """The CKKS slot encode (O1, then AO2p) and encode_polynomial (AO2p)
    on the card, word-equal to the port's own CPU run (the plain versions)
    from the same values, at the first data level and the last (and at
    scale 2^100 at the first, the exponent path); each card encode one
    AO2p call and no O2."""
    cpu = P.HeContext(ctx.key_context_data.parms, device="cpu")
    enc, enc_cpu = P.CKKSEncoder(ctx), P.CKKSEncoder(cpu)
    values = rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2)
    coeffs = rng.uniform(-1, 1, N) * 2.0 ** 10
    cases = []
    for level in (ctx.first_level, ctx.last_level):
        cases += [(f"encode at level {level}", lambda e, lv=level:
                   e.encode(values, CKKS_SCALE, lv)),
                  (f"encode_polynomial at level {level}", lambda e, lv=level:
                   e.encode_polynomial(coeffs, CKKS_SCALE, lv))]
    cases.append(("encode_polynomial at scale 2^100", lambda e:
                  e.encode_polynomial(coeffs, 2.0 ** 100)))
    for what, fn in cases:
        before = _kernels.entry_launch_counts()
        got = fn(enc)
        torch.cuda.synchronize()
        after = _kernels.entry_launch_counts()
        ran = {e: after[e] - before.get(e, 0) for e in (
            "troy_ntt_forward_round", "troy_ckks_round")}
        if ran != {"troy_ntt_forward_round": 1, "troy_ckks_round": 0}:
            raise AssertionError(f"CKKS {what} on the card: {ran}")
        want = fn(enc_cpu)
        if not torch.equal(got.data.cpu(), want.data):
            raise AssertionError(f"CKKS {what}: the card's words differ "
                                 "from the CPU run's")
    log(f"[7] CKKS encode and encode_polynomial on the card (one AO2p call "
        f"each, no O2) word-equal to the CPU run in {len(cases)} cases")


def tie_diffs(ctx, got: torch.Tensor, want_words: np.ndarray):
    """(max |diff|, positions that differ in limb 0) of two NTT-form
    plaintexts of the first data level, in the coefficient domain,
    centred."""
    cd = ctx.first_context_data
    want = to_torch(want_words.reshape(cd.limbs, N), ctx.device)
    a, b = (to_numpy(ntt.rns_ntt_inverse(x, cd.ntt)).astype(object)
            for x in (got, want))
    q = np.array(cd.coeff_values, dtype=object).reshape(-1, 1)
    d = (a - b) % q
    d = np.where(d > q // 2, d - q, d)
    return int(np.max(np.abs(d))), int(np.sum(d[0] != 0))


def phase_ckks_records(ctx) -> tuple:
    raw = interop.load_records(CKKS_FIXTURE)
    if list(ctx.key_context_data.coeff_values) != [int(x) for x in raw["q"]]:
        raise AssertionError("moduli differ from the CKKS records'")

    def same(tensor, name):
        if not np.array_equal(to_numpy(tensor).reshape(-1), raw[name]):
            raise AssertionError(f"CKKS record {name!r} differs")
        log(f"[8] {name}: word-equal to troy's C++ vectors")

    t0 = time.perf_counter()
    kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(CKKS_SEED),
                        host_sampling=True)
    rlk = kg.create_relin_keys()
    gk = kg.create_galois_keys(steps=[1])
    log(f"[8] host keygen (sk + relin key + Galois key, step 1): "
        f"{time.perf_counter() - t0:.1f} s")
    same(kg.secret_key.data, "sk")
    same(rlk.keys[2][0], "rlk_0")
    same(gk.keys[3][0], "gk_0")
    ce = P.CKKSEncoder(ctx)
    v1, v2 = ckks_values()
    for vals, tag in ((v1, "p1"), (v2, "p2")):
        worst, count = tie_diffs(ctx, ce.encode(vals, CKKS_SCALE).data,
                                 raw[tag])
        if worst > 1 or count > 4:
            raise AssertionError(f"encode {tag}: |diff| {worst} at {count} "
                                 "coefficients, over the tie bound")
        log(f"[8] encode {tag}: within the tie bound (|diff| {worst} at "
            f"{count} coefficients)")
    level = ctx.first_level
    cts = []
    for tag, ctag in (("p1", "c1"), ("p2", "c2")):
        plain = interop.plaintext(raw[tag].reshape(-1, N), ctx.device, level,
                                  True, CKKS_SCALE)
        enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                          seed=rnd.seed_from_uint64(CKKS_SEED),
                          host_sampling=True)
        cts.append(enc.encrypt_symmetric(plain))
        same(cts[-1].data, ctag)
    ev = P.Evaluator(ctx)
    prod = ev.multiply(*cts)
    same(prod.data, "prod")
    rel = ev.relinearize(prod, rlk)
    same(rel.data, "rel")
    rs = ev.rescale_to_next(rel)
    same(rs.data, "rs")
    want_scale = struct.unpack("<d", int(raw["rs_meta"][2])
                               .to_bytes(8, "little"))[0]
    if abs(rs.scale - want_scale) > abs(want_scale) * 1e-12:
        raise AssertionError(f"rescaled scale {rs.scale} != {want_scale}")
    same(ev.rotate_vector(rel, 1, gk).data, "rot")
    dec = P.Decryptor(ctx, kg.secret_key)
    err = float(np.abs(np.real(ce.decode(dec.decrypt(rel))) - v1 * v2).max())
    if err > 1e-6:
        raise AssertionError(f"decode(decrypt(rel)) is {err} from v1 v2")
    log(f"[8] decode(decrypt(rel)): within {err:.3g} of v1 v2 (bound 1e-6)")
    return kg, rlk, gk, ce, ev, dec


def phase_ckks_requests(ctx, kg, rlk, gk, ce, ev, dec) -> dict:
    t0 = time.perf_counter()
    conj = kg.create_galois_keys(elts=[2 * N - 1])
    gk = P.GaloisKeys(keys={**gk.keys, **conj.keys})
    log(f"[9] host keygen (Galois key, conjugation): "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 9)
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(CKKS_SEED + 1))
    decode = lambda ct: ce.decode(dec.decrypt(ct))
    slots = lambda: (rng.uniform(-1, 1, N // 2)
                     + 1j * rng.uniform(-1, 1, N // 2))
    worst = 0.0
    for r in range(REQUESTS):
        a, b = slots(), slots()
        ca = enc.encrypt_symmetric(ce.encode(a, CKKS_SCALE))
        cb = enc.encrypt_symmetric(ce.encode(b, CKKS_SCALE))
        rel = ev.relinearize(ev.multiply(ca, cb), rlk)
        rs = ev.rescale_to_next(rel)
        expected = {
            "mult, relin, rescale": (rs, a * b),
            "rotate_vector(1)": (ev.rotate_vector(rs, 1, gk),
                                 np.roll(a * b, -1)),
            "complex_conjugate": (ev.complex_conjugate(rs, gk),
                                  np.conj(a * b)),
        }
        for what, (ct, want) in expected.items():
            err = float(np.abs(decode(ct) - want).max())
            worst = max(worst, err)
            if err > 1e-4:
                raise AssertionError(f"request {r}: {what} decodes {err} "
                                     "from the expected slots")
        log(f"[9] request {r}: a b, its rotate_vector(1) and its "
            f"complex_conjugate decode to the expected slots (max error "
            f"{worst:.3g}, bound 1e-4)")
    pt = dec.decrypt(rs)
    times = {
        "ckks_mult_relin_ms": cuda_ms(
            lambda: ev.relinearize(ev.multiply(ca, cb), rlk)),
        "ckks_rescale_ms": cuda_ms(lambda: ev.rescale_to_next(rel)),
        "ckks_rotate_vector_ms": cuda_ms(lambda: ev.rotate_vector(rel, 1,
                                                                  gk)),
        "ckks_conjugate_ms": cuda_ms(lambda: ev.complex_conjugate(rel, gk)),
        "ckks_encode_ms": cuda_ms(lambda: ce.encode(a, CKKS_SCALE)),
        "ckks_decode_ms": cuda_ms(lambda: ce.decode(pt)),
    }
    log(f"[9] medians over {TIMING_REPS} runs (CUDA events): "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return {"gk": gk, "ca": ca, "cb": cb, "rel": rel, "rs": rs, "pt": pt,
            "a": a, "enc": enc, "max_error": worst, **times}


# --------------------------------------------------------------------------
# BGV and the plaintext-operand ops
# --------------------------------------------------------------------------

def phase_bgv_kernels(ctx) -> dict:
    """X, K'-BGV and G' against their plain versions at the BGV shapes."""
    rng = np.random.default_rng(SEED + 11)
    dev = ctx.device
    key, data = ctx.key_context_data, ctx.first_context_data
    q5 = data.ntt
    k = q5.k
    t = int(data.plain_modulus)
    Q = data.total_coeff_modulus
    conv = data.exact_to_t
    x_dec = _uniform(rng, q5.values, (k, N), dev)         # one phase
    inv_cf = pow(int(rng.integers(2, t)), -1, t)
    # K'-BGV: the mod switch of a (2, 5, n) ciphertext; the key switch's
    # divide of (2, 6, n) products onto (c0, c1)
    ms = data.bgv_mod_switch_consts
    x_ms = _uniform(rng, q5.values, (2, k, N), dev)
    last_ms = _uniform(rng, [q5.values[-1]], (2, 1, N), dev)[:, 0]
    used = key.ntt.select(keyswitch.used_limbs(k, key.limbs))
    ks = data.bgv_keyswitch_consts
    x_ks = _uniform(rng, used.values, (2, k + 1, N), dev)
    last_ks = _uniform(rng, [used.values[-1]], (2, 1, N), dev)[:, 0]
    acc_ks = _uniform(rng, q5.values, (2, k, N), dev)
    # G': m (n) mod t -> (5, n)
    m = to_torch(rng.integers(0, t, N, dtype=np.uint64), dev)
    half = data.plain_upper_half_threshold
    cf = int(rng.integers(2, t))

    def bgv_divide(x, last, consts, acc, entries, plain):
        kk = x.shape[1] - 1
        if plain:
            return lambda: rns.divide_round_ntt_finish_plain(
                x, rns.bgv_divide_ntt_temps_plain(last, consts),
                consts[:5 * kk + 2], acc)
        return lambda: rns._ntt_finish(
            entries[1], x, rns._ntt_temps(entries[0], last, consts),
            consts[:5 * kk + 2], acc)

    def bgv_divide_work(x, last, acc):
        # the function's own data: x's kk rows and the last row in (with
        # the accumulator), kk rows out; per coefficient 3 + 4 kk products
        # for the temps and 2 per output word for the finish
        kk = x.shape[1] - 1
        rows = 2 * kk * N * 8
        return (_bytes(last) + rows * (2 if acc is None else 3),
                2 * N * (3 + 4 * kk + 2 * kk))

    def bgv_fused(x, last, consts, acc, entries, plain):
        # K'-BGV's temps and K''s finish in A's forward (AKp)
        t = q5.slice(0, x.shape[1] - 1)
        if plain:
            return lambda: rns.ntt_forward_divide_plain(x, last, t, consts,
                                                        acc, bgv=True)
        return lambda: rns.ntt_forward_divide(entries[2], x, last, t, consts,
                                              acc)

    def bgv_fused_work(x, last, acc):
        # K'-BGV's data and products (its temps again in every limb's
        # block: 3 + 4 products a word), with A's twiddles and butterflies
        kk = x.shape[1] - 1
        nbytes, _ = bgv_divide_work(x, last, acc)
        return (nbytes + 2 * kk * N * 8,
                2 * N * kk * (3 + 4 + 2) + ntt_rows_mul64(2 * kk))

    checks = [
        ("X_exact_convert", f"decrypt ({k},n) -> (n), cf^-1 = 1", "words",
         lambda: rns.exact_convert(x_dec, conv),
         lambda: rns.exact_convert_plain(x_dec, conv),
         (_bytes(x_dec) + N * 8, N * (7 * k + 9)), None),
        ("X_exact_convert", f"decrypt ({k},n) -> (n), cf^-1 != 1", "words",
         lambda: rns.exact_convert(x_dec, conv, inv_cf),
         lambda: rns.exact_convert_plain(x_dec, conv, inv_cf), None, None),
        # X in A's last inverse pass, from the NTT-form phase: the phase
        # in, the words out, the inverse twiddles; A's products over k rows
        # and X's a coefficient
        ("AXi_decrypt_intt", f"inverse + X ({k},n) -> (n), cf^-1 != 1",
         "words", lambda: rns.ntt_inverse_decrypt_mod_t(x_dec, q5, conv,
                                                        inv_cf),
         lambda: rns.ntt_inverse_decrypt_mod_t_plain(x_dec, q5, conv, inv_cf),
         (_bytes(x_dec, q5.inv_root_powers, q5.inv_root_powers_shoup)
          + N * 8, ntt_rows_mul64(k) + N * (7 * k + 9)), None),
        ("AXi_decrypt_intt", f"inverse + X (2,{k},n) -> (2,n), cf^-1 = 1",
         "words", lambda: rns.ntt_inverse_decrypt_mod_t(x_ms, q5, conv),
         lambda: rns.ntt_inverse_decrypt_mod_t_plain(x_ms, q5, conv),
         None, None),
        ("Kp_bgv_ntt", f"mod switch temps + finish (2,{k},n) -> "
         f"(2,{k - 1},n)", "words",
         bgv_divide(x_ms, last_ms, ms, None, rns.BGV_MOD_SWITCH, False),
         bgv_divide(x_ms, last_ms, ms, None, rns.BGV_MOD_SWITCH, True),
         bgv_divide_work(x_ms, last_ms, None), None),
        ("Kp_bgv_ntt", f"key switch temps + K' finish (2,{k + 1},n) onto "
         "(c0,c1)", "words",
         bgv_divide(x_ks, last_ks, ks, acc_ks, rns.BGV_KEYSWITCH, False),
         bgv_divide(x_ks, last_ks, ks, acc_ks, rns.BGV_KEYSWITCH, True),
         None, None),
        ("AKp_bgv_ntt", f"mod switch fused forward (2,{k},n) -> "
         f"(2,{k - 1},n)", "words",
         bgv_fused(x_ms, last_ms, ms, None, rns.BGV_MOD_SWITCH, False),
         bgv_fused(x_ms, last_ms, ms, None, rns.BGV_MOD_SWITCH, True),
         bgv_fused_work(x_ms, last_ms, None), None),
        ("AKp_bgv_ntt", f"with A: mod switch (2,{k},n) -> (2,{k - 1},n)",
         "words", lambda: rns.mod_t_and_divide_q_last_ntt(x_ms, q5, ms),
         lambda: rns.mod_t_and_divide_q_last_ntt_plain(x_ms, q5, ms),
         None, None),
        ("AKp_bgv_ntt", f"key switch fused forward (2,{k + 1},n) onto "
         "(c0,c1)", "words",
         bgv_fused(x_ks, last_ks, ks, acc_ks, rns.BGV_KEYSWITCH, False),
         bgv_fused(x_ks, last_ks, ks, acc_ks, rns.BGV_KEYSWITCH, True),
         None, None),
        ("Gp_plain_lift", f"(n) -> ({k},n), threshold (t+1)/2", "words",
         lambda: poly.plain_lift(m, q5, t, half, Q),
         lambda: poly.plain_lift_plain(m, q5, t, half, Q),
         (_bytes(m) + k * N * 8, N * (2 + k)), None),
        ("Gp_plain_lift", f"(n) -> ({k},n), threshold t (encrypt)", "words",
         lambda: poly.plain_lift(m, q5, t, t, Q),
         lambda: poly.plain_lift_plain(m, q5, t, t, Q), None, None),
        ("Gp_plain_lift", f"(n) -> ({k},n), times cf mod t", "words",
         lambda: poly.plain_lift(m, q5, t, half, Q, cf),
         lambda: poly.plain_lift_plain(m, q5, t, half, Q, cf), None, None),
        # G''s lift in A's first forward pass: m in, the transformed rows
        # out, the twiddles; A's products and the lift's (2 a word)
        ("AGp_ntt_lift", f"(n) -> ({k},n), threshold (t+1)/2", "words",
         lambda: ntt.rns_ntt_forward_lift(m, q5, t, half, Q),
         lambda: ntt.ntt_forward_lift_plain(m, q5, t, half, Q),
         lift_work(q5, 1), None),
        ("AGp_ntt_lift", f"(n) -> ({k},n), threshold t (encrypt)", "words",
         lambda: ntt.rns_ntt_forward_lift(m, q5, t, t, Q),
         lambda: ntt.ntt_forward_lift_plain(m, q5, t, t, Q), None, None),
        ("AGp_ntt_lift", f"(n) -> ({k},n), times cf mod t", "words",
         lambda: ntt.rns_ntt_forward_lift(m, q5, t, half, Q, cf),
         lambda: ntt.ntt_forward_lift_plain(m, q5, t, half, Q, cf),
         None, None),
        ("AGp_ntt_lift", f"with G' + A: (n) -> ({k},n), times cf mod t",
         "words", lambda: ntt.rns_ntt_forward_lift(m, q5, t, half, Q, cf),
         lambda: ntt.rns_ntt_forward(poly.plain_lift(m, q5, t, half, Q, cf),
                                     q5), None, None),
    ]
    return run_checks("11", checks)


def lift_work(t, sources: int) -> tuple:
    """bound() arguments of one AGp call over ``sources`` rows mod t into
    t's k limbs: the rows in, the k-limb rows out and the twiddles once;
    A's butterfly products and the lift's (at most 2 a word: cf's Shoup
    product, the Barrett)."""
    k, n = t.k, t.n
    return ((sources * n + sources * k * n + 2 * k * n) * 8,
            ntt_rows_mul64(sources * k, n) + 2 * sources * k * n)


def bgv_values(t: int):
    """The slot vectors troy's generator encrypted into c1 and c2."""
    i = np.arange(N, dtype=object)
    return [((3 * i + 11) % t).astype(np.uint64),
            ((i * i + 7) % t).astype(np.uint64)]


def phase_bgv_records(ctx) -> tuple:
    raw = interop.load_records(BGV_FIXTURE)
    if (list(ctx.key_context_data.coeff_values) != [int(x) for x in raw["q"]]
            or int(ctx.key_context_data.plain_modulus) != int(raw["t"][0])):
        raise AssertionError("moduli differ from the BGV records'")
    ev = P.Evaluator(ctx)

    def load(tag):
        size, is_ntt, cf = (int(v) for v in raw[tag + "_meta"][:3])
        ct = interop.ciphertext(raw[tag].reshape(size, -1, N),
                                ctx.first_level, bool(is_ntt), ctx.device,
                                correction_factor=cf)
        return ct if ct.is_ntt_form else ev.transform_to_ntt(ct)

    def same(obj, name, ntt_ct=False):
        if ntt_ct:
            if obj.correction_factor != int(raw[name + "_meta"][2]):
                raise AssertionError(f"BGV record {name!r}: correction "
                                     f"factor {obj.correction_factor}")
            obj = ev.transform_from_ntt(obj).data
        if not np.array_equal(to_numpy(obj).reshape(-1), raw[name]):
            raise AssertionError(f"BGV record {name!r} differs")
        log(f"[12] {name}: word-equal to troy's C++ vectors")

    t0 = time.perf_counter()
    kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(BGV_SEED),
                        host_sampling=True)
    rlk = kg.create_relin_keys()
    gk = kg.create_galois_keys(steps=[1])
    log(f"[12] host keygen (sk + relin key + Galois key, step 1): "
        f"{time.perf_counter() - t0:.1f} s")
    same(kg.secret_key.data, "sk")
    same(rlk.keys[2][0], "rlk_0")
    same(gk.keys[3][0], "gk_0")
    be = P.BatchEncoder(ctx)
    t = be.plain_modulus
    for vals, tag in zip(bgv_values(t), ("c1", "c2")):
        enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                          seed=rnd.seed_from_uint64(BGV_SEED),
                          host_sampling=True)
        same(enc.encrypt_symmetric(be.encode(vals)), tag, True)
    prod = ev.multiply(load("c1"), load("c2"))
    same(prod, "prod", True)
    rel = ev.relinearize(load("prod"), rlk)
    same(rel, "rel", True)
    ms = ev.mod_switch_to_next(load("rel"))
    same(ms, "ms", True)
    log(f"[12] ms: correction factor {ms.correction_factor}, equal to "
        "troy's")
    same(ev.rotate_rows(load("rel"), 1, gk), "rot", True)
    dec = P.Decryptor(ctx, kg.secret_key)
    got = be.decode(dec.decrypt(ms))
    if not np.array_equal(got, raw["dec_ms"]):
        raise AssertionError("decode(decrypt(ms)) differs from dec_ms")
    log("[12] dec_ms: word-equal to troy's C++ vectors")
    return kg, rlk, gk, be, ev, dec


def phase_bgv_requests(ctx, kg, rlk, gk, be, ev, dec) -> dict:
    t0 = time.perf_counter()
    gk = P.GaloisKeys(keys={**gk.keys,
                            **kg.create_galois_keys(steps=[0]).keys})
    log(f"[13] host keygen (Galois key, the column swap): "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 13)
    t = be.plain_modulus
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(BGV_SEED + 1))
    host_enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                           seed=rnd.seed_from_uint64(BGV_SEED + 2),
                           host_sampling=True)
    decode = lambda ct: be.decode(dec.decrypt(ct))
    for r in range(REQUESTS):
        a, b, c = (rng.integers(0, t, N, dtype=np.uint64) for _ in range(3))
        ca, cb, cc = (enc.encrypt_symmetric(be.encode(v)) for v in (a, b, c))
        rel = ev.relinearize(ev.multiply(ca, cb), rlk)
        ms = ev.mod_switch_to_next(rel)
        if ms.correction_factor == 1:
            raise AssertionError("the mod switch left the correction factor "
                                 "at 1")
        ms_a, ms_b, ms_c = (ev.mod_switch_to_next(x) for x in (ca, cb, cc))
        two = ev.relinearize(ev.multiply(ms_a, ms_b), rlk)      # cf^2
        pc = be.encode(c)
        ab = a.astype(object) * b.astype(object) % t
        co = c.astype(object)
        rows = ab.astype(np.uint64).reshape(2, N // 2)
        expected = {
            "mult + relin": (rel, ab),
            "mod_switch_to_next": (ms, ab),
            "rotate_rows(1)": (ev.rotate_rows(rel, 1, gk),
                               np.roll(rows, -1, axis=1).reshape(-1)),
            "rotate_columns": (ev.rotate_columns(rel, gk),
                               rows[::-1].reshape(-1)),
            "switched a b (cf^2) + switched c (cf)": (ev.add(two, ms_c),
                                                      (ab + co) % t),
            "multiply_plain (cf != 1)": (ev.multiply_plain(ms, pc),
                                         ab * co % t),
            "add_plain (cf != 1)": (ev.add_plain(ms, pc), (ab + co) % t),
            "sub_plain (cf != 1)": (ev.sub_plain(ms, pc), (ab - co) % t),
        }
        for what, (ct, slots) in expected.items():
            if not np.array_equal(decode(ct),
                                  np.asarray(slots).astype(np.uint64)):
                raise AssertionError(f"request {r}: {what} decrypts to the "
                                     "wrong slots")
        log(f"[13] request {r}: a b mod t, its mod switch (cf "
            f"{ms.correction_factor}), rotations, a b + c from unequal "
            f"correction factors and the plain ops decrypt to the expected "
            f"slots")
    pt = be.encode(a)
    times = {
        "bgv_mult_relin_ms": cuda_ms(
            lambda: ev.relinearize(ev.multiply(ca, cb), rlk)),
        "bgv_mod_switch_ms": cuda_ms(lambda: ev.mod_switch_to_next(rel)),
        "bgv_rotate_rows_ms": cuda_ms(lambda: ev.rotate_rows(rel, 1, gk)),
        "bgv_multiply_plain_ms": cuda_ms(lambda: ev.multiply_plain(ms, pc)),
        "bgv_encrypt_ms": cuda_ms(lambda: enc.encrypt_symmetric(pt)),
        # host sampling, for comparison: the host's BLAKE2Xb sampling takes
        # seconds, so fewer runs
        "bgv_encrypt_host_ms": cuda_ms(lambda: host_enc.encrypt_symmetric(pt),
                                       reps=SLOW_REPS, warmup=1),
        "bgv_decrypt_ms": cuda_ms(lambda: dec.decrypt(ms)),
    }
    log(f"[13] medians over {TIMING_REPS} runs (CUDA events): "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return {"gk": gk, "ca": ca, "cb": cb, "rel": rel, "ms": ms, "pc": pc,
            "pt": pt, "enc": enc, **times}


def phase_plain_op_requests(bfv, ckks) -> dict:
    """One request on each of the BFV and CKKS paths: multiply_plain, then
    add_plain; the medians of their multiply_plain."""
    ctx, be, ev, dec, ca, rng = bfv
    t = be.plain_modulus
    b, c = (rng.integers(0, t, N, dtype=np.uint64) for _ in range(2))
    a = be.decode(dec.decrypt(ca))
    pb = be.encode(b)
    got = be.decode(dec.decrypt(ev.add_plain(ev.multiply_plain(ca, pb),
                                             be.encode(c))))
    want = (a.astype(object) * b.astype(object) + c) % t
    if not np.array_equal(got, want.astype(np.uint64)):
        raise AssertionError("BFV multiply_plain + add_plain decrypts to "
                             "the wrong slots")
    log("[14] BFV request: multiply_plain then add_plain decrypt to a b + c")
    cctx, ce, cev, cdec, cca, ca_slots = ckks
    cb, cc = (rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2)
              for _ in range(2))
    cpb = ce.encode(cb, CKKS_SCALE)
    prod = cev.rescale_to_next(cev.multiply_plain(cca, cpb))
    out = cev.add_plain(prod, ce.encode(cc, prod.scale, prod.level))
    err = float(np.abs(ce.decode(cdec.decrypt(out))
                       - (ca_slots * cb + cc)).max())
    if err > 1e-4:
        raise AssertionError(f"CKKS multiply_plain + add_plain decodes {err} "
                             "from a b + c")
    log(f"[14] CKKS request: multiply_plain, rescale, add_plain decode to "
        f"a b + c within {err:.3g} (bound 1e-4)")
    return {"bfv_multiply_plain_ms": cuda_ms(
        lambda: ev.multiply_plain(ca, pb)),
        "ckks_multiply_plain_ms": cuda_ms(
            lambda: cev.multiply_plain(cca, cpb)),
        "ckks_plain_max_error": err}


# --------------------------------------------------------------------------
# device sampling and the default encryption path
# --------------------------------------------------------------------------

def sampling_work(k: int, batch: int, kind: str) -> tuple:
    """bound() arguments of one kernel-I launch: batch k n words written
    and the seeds read; uniform: two threefry blocks and a Barrett-128 (5
    64-bit products) per word; CBD and ternary: one block per coefficient
    and a few operations per word (CBD times t: one Shoup product)."""
    words = batch * k * N
    nbytes = words * 8 + batch * 8
    if kind == "uniform":
        return nbytes, words * 5, 0, words * 2 * THREEFRY_OPS
    return (nbytes, words * 2 if kind == "cbd_t" else 0, 0,
            batch * N * THREEFRY_OPS + words * 4)


def phase_sampling_kernels(ctx, t: int) -> dict:
    """I1-I3 against their plain versions at the default path's shapes: the
    key base (6 limbs: public and switching keys) and the first data level
    (5: encryption), for one seed and for device arrays of seeds (MANY for
    encrypt_symmetric_many, decomp for a switching key); the CBD noise
    also times t (BGV)."""
    rng = np.random.default_rng(SEED + 15)
    dev = ctx.device
    key, data = ctx.key_context_data.ntt, ctx.first_context_data.ntt
    seed = int(rng.integers(0, 2 ** 64, dtype=np.uint64))
    draw = lambda count: to_torch(rng.integers(0, 2 ** 64, count,
                                               dtype=np.uint64), dev)
    many, rows = draw(MANY), draw(key.k - 1)
    samplers = {
        "uniform": (sampling.sample_uniform_rns,
                    sampling.sample_uniform_rns_plain, ()),
        "cbd": (sampling.sample_cbd_rns, sampling.sample_cbd_rns_plain, ()),
        "cbd_t": (sampling.sample_cbd_rns, sampling.sample_cbd_rns_plain,
                  (t,)),
        "ternary": (sampling.sample_ternary_rns,
                    sampling.sample_ternary_rns_plain, ()),
    }
    seed2 = int(rng.integers(0, 2 ** 64, dtype=np.uint64))
    e_many, e_rows = draw(MANY), draw(key.k - 1)
    samplers["zero_sym"] = (
        lambda a, tab, *scale, e=None: zero_sym_draw(a, e, tab, *scale),
        lambda a, tab, *scale, e=None: torch.stack(
            sampling.sample_zero_sym_plain(a, e, tab, *scale)), ())
    samplers["zero_sym_t"] = (samplers["zero_sym"][0],
                              samplers["zero_sym"][1], (t,))
    asym = [seed2, seed, 2 ** 64 - 1]
    samplers["zero_asym"] = (
        lambda u, tab, *scale: sampling.sample_zero_asym_rns(
            u, asym[1:], tab, *scale),
        lambda u, tab, *scale: sampling.sample_zero_asym_plain(
            u, asym[1:], tab, *scale), ())
    samplers["zero_asym_t"] = (samplers["zero_asym"][0],
                               samplers["zero_asym"][1], (t,))
    cases = [("uniform", seed, key), ("uniform", seed, data),
             ("uniform", many, data), ("uniform", rows, key),
             ("cbd", seed, data), ("cbd_t", seed, data),
             ("cbd_t", many, data), ("cbd", rows, key), ("cbd_t", rows, key),
             ("ternary", seed, data), ("ternary", seed, key),
             ("zero_sym", seed, data), ("zero_sym_t", seed, data),
             ("zero_sym", many, data), ("zero_sym_t", many, data),
             ("zero_sym", rows, key), ("zero_sym_t", rows, key),
             ("zero_asym", seed, data), ("zero_asym_t", seed, data)]
    checks = []
    for kind, seeds, tab in cases:
        run, plain, extra = samplers[kind]
        kw = {}
        if kind.startswith("zero_sym"):       # the e-seeds beside the a's
            kw["e"] = (seed2 if isinstance(seeds, int)
                       else e_many if seeds is many else e_rows)
        batch = 1 if isinstance(seeds, int) else seeds.numel()
        lead = "" if isinstance(seeds, int) else f"{batch},"
        rows_of = {"zero_sym": "2,", "zero_sym_t": "2,", "zero_asym": "3,",
                   "zero_asym_t": "3,"}.get(kind, "")
        checks.append((
            "I_sampling", f"{kind} ({rows_of}{lead}{tab.k},n), "
            + ("one seed" if isinstance(seeds, int) else f"{batch} seeds"),
            "words",
            lambda run=run, seeds=seeds, tab=tab, extra=extra, kw=kw:
                run(seeds, tab, *extra, **kw),
            lambda plain=plain, seeds=seeds, tab=tab, extra=extra, kw=kw:
                plain(seeds, tab, *extra, **kw),
            sampling_work(tab.k, batch, kind) if kind in SINGLE_DRAWS
            else None, None))
    return run_checks("15", checks)


SINGLE_DRAWS = ("uniform", "cbd", "cbd_t", "ternary")


def zero_sym_draw(a_seeds, e_seeds, tab, scale=None) -> torch.Tensor:
    """Kernel I's symmetric zero-encryption draw into a new (2, [B,] k, n)
    buffer: e, then a."""
    lead = () if isinstance(a_seeds, int) else (a_seeds.numel(),)
    buf = torch.empty((2,) + lead + (tab.k, tab.n), dtype=torch.int64,
                      device=tab.device)
    sampling.sample_zero_sym_rns(a_seeds, e_seeds, tab, scale, buf[0],
                                 buf[1])
    return buf


def encode_requests(ctx) -> tuple:
    """(encoder, MANY slot vectors, their plaintexts) of a context's
    scheme, made on its device."""
    rng = np.random.default_rng(DEFAULT_SEED)
    if ctx.scheme == P.SchemeType.ckks:
        encoder = P.CKKSEncoder(ctx)
        values = [rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2)
                  for _ in range(MANY)]
        return encoder, values, [encoder.encode(v, CKKS_SCALE)
                                 for v in values]
    encoder = P.BatchEncoder(ctx)
    values = [rng.integers(0, encoder.plain_modulus, N, dtype=np.uint64)
              for _ in range(MANY)]
    return encoder, values, [encoder.encode(v) for v in values]


def default_path(ctx, plains) -> dict:
    """The default encryption path on ctx's device, from fixed seeds:
    keygen (a generated key, and an external secret key whose keys are made
    on the device), the public key with its seed, encrypt,
    encrypt_symmetric, save_seed and expand_seed, encrypt_symmetric_many,
    the external key's public key, relin key and key-switching key from
    the first key (kernel Q). Returns the objects and the ops to time."""
    seed = lambda i: rnd.seed_from_uint64(DEFAULT_SEED + i)
    kg = P.KeyGenerator(ctx, seed=seed(0))
    other = P.KeyGenerator(ctx, seed=seed(1))
    ext = P.KeyGenerator(ctx, other.secret_key, seed(2))
    pk = kg.create_public_key(save_seed=True)
    enc = P.Encryptor(ctx, pk, kg.secret_key, seed(3))
    ss = enc.encrypt_symmetric(plains[0], save_seed=True)
    dropped = ss.replace(data=torch.stack([ss.data[0],
                                           torch.zeros_like(ss.data[1])]),
                         seed=ss.seed)
    cd = ctx.first_context_data
    out = {"public_key": pk, "external_public_key": ext.create_public_key(),
           "encrypt": enc.encrypt(plains[0]),
           "encrypt_symmetric": enc.encrypt_symmetric(plains[0]),
           "save_seed": ss, "expand_seed": rlwe.expand_seed(dropped, cd),
           "many": enc.encrypt_symmetric_many(plains),
           "relin_key": ext.create_relin_keys(),
           "keyswitch_key": ext.create_keyswitch_key(kg.secret_key)}
    ops = {"public_key": lambda: kg.create_public_key(save_seed=True),
           "encrypt": lambda: enc.encrypt(plains[0]),
           "encrypt_symmetric": lambda: enc.encrypt_symmetric(plains[0]),
           "expand_seed": lambda: rlwe.expand_seed(dropped, cd),
           f"encrypt_symmetric_many{MANY}":
               lambda: enc.encrypt_symmetric_many(plains),
           "relin_key_q": lambda: ext.create_relin_keys(),
           "keyswitch_key_q": lambda: ext.create_keyswitch_key(
               kg.secret_key)}
    return {"kg": kg, "other": other, "out": out, "ops": ops}


def path_words(out: dict) -> dict:
    """The words (and seeds) of each result of default_path."""
    words = {}
    for name, obj in out.items():
        items = obj if isinstance(obj, list) else [obj]
        for i, o in enumerate(items):
            w = interop.words(o)
            tag = name if len(items) == 1 else f"{name}[{i}]"
            if isinstance(w, dict):
                words.update({f"{tag}[{k}]": v for k, v in w.items()})
            else:
                words[tag] = w
                words[tag + ".seed"] = np.array([o.seed], dtype=np.uint64)
    return words


def check_default_path(ctx, encoder, values, plains, run) -> None:
    """Every result of the default path decrypts right on the card."""
    scheme = ctx.scheme.name
    out, kg, other = run["out"], run["kg"], run["other"]
    ev = P.Evaluator(ctx)

    def decode(ct, sk):
        return encoder.decode(P.Decryptor(ctx, sk).decrypt(ct))

    def same(got, want, what, tol=1e-4):
        if ctx.scheme == P.SchemeType.ckks:
            err = float(np.abs(got - want).max())
            if err > tol:
                raise AssertionError(f"{scheme} {what}: decodes {err} from "
                                     "its slots")
        elif not np.array_equal(got, np.asarray(want).astype(np.uint64)):
            raise AssertionError(f"{scheme} {what}: decrypts to the wrong "
                                 "slots")

    for what in ("encrypt", "encrypt_symmetric", "save_seed", "expand_seed"):
        same(decode(out[what], kg.secret_key), values[0], what)
    for i, ct in enumerate(out["many"]):
        same(decode(ct, kg.secret_key), values[i], f"many[{i}]")
    pk = out["public_key"]
    if pk.seed == 0 or not torch.equal(rlwe._expand_seed_core(
            pk.data, pk.seed, ctx.key_context_data, True), pk.data):
        raise AssertionError(f"{scheme} public key: its seed does not "
                             "regenerate c1")
    ext_enc = P.Encryptor(ctx, out["external_public_key"], other.secret_key,
                          rnd.seed_from_uint64(DEFAULT_SEED + 4))
    same(decode(ext_enc.encrypt(plains[2]), other.secret_key), values[2],
         "the external key's public-key encryption")
    ct = ext_enc.encrypt_symmetric(plains[1])
    prod = ev.relinearize(ev.multiply(ct, ct), out["relin_key"])
    if ctx.scheme == P.SchemeType.ckks:
        want = values[1] * values[1]
        prod = ev.rescale_to_next(prod)
    else:
        t = encoder.plain_modulus
        want = values[1].astype(object) ** 2 % t
    same(decode(prod, other.secret_key), want,
         "a product relinearized by the device relin key", 1e-3)
    switched = ev.apply_keyswitching(out["encrypt_symmetric"],
                                     out["keyswitch_key"])
    same(decode(switched, other.secret_key), values[0],
         "a ciphertext switched by the device key-switching key")
    log(f"[16] {scheme}: encrypt, encrypt_symmetric, save_seed and "
        f"expand_seed, encrypt_symmetric_many({MANY}) decrypt to their "
        "slots; the public key's seed regenerates its c1; the external "
        "key's public key, relin key and key-switching key (kernel Q) "
        "encrypt, relinearize and switch to slots that decrypt right")


def phase_default(ctxs: dict, counter) -> tuple:
    """Phase 16: the default encryption path of each scheme on the card,
    in a count window of its own; then each against the port's CPU run
    from the same seeds and plaintext words, the decrypt checks, the
    medians and the profile."""
    counter.calls.clear()
    _kernels.reset_launch_counts()
    runs = {}
    for name, ctx in ctxs.items():
        encoder, values, plains = encode_requests(ctx)
        runs[name] = (encoder, values, plains, default_path(ctx, plains))
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    check_path("16", "16 (default path)", DEFAULT_PATH, counts, counter,
               ENCRYPT_ABSENT)
    times, per_op = {}, {}
    for name, ctx in ctxs.items():
        encoder, values, plains, run = runs[name]
        t0 = time.perf_counter()
        cpu_ctx = P.HeContext(ctx.key_context_data.parms, device="cpu")
        cpu_plains = [interop.plaintext(to_numpy(p.data), "cpu", p.level,
                                        p.is_ntt_form, p.scale)
                      for p in plains]
        want = path_words(default_path(cpu_ctx, cpu_plains)["out"])
        got = path_words(run["out"])
        if sorted(got) != sorted(want):
            raise AssertionError(f"{name}: results {sorted(got)} against "
                                 f"{sorted(want)}")
        differ = [k for k in want if not np.array_equal(got[k], want[k])]
        if differ:
            raise AssertionError(f"{name} default path: {differ} differ "
                                 "from the CPU run's words")
        log(f"[16] {name}: {len(want)} results word-equal to the port's "
            f"CPU run from the same seeds (CPU run "
            f"{time.perf_counter() - t0:.1f} s)")
        check_default_path(ctx, encoder, values, plains, run)
        times[name] = {op: cuda_ms(fn) for op, fn in run["ops"].items()}
        log(f"[16] {name} medians over {TIMING_REPS} runs (CUDA events): "
            + ", ".join(f"{k} {v:.4f}" for k, v in times[name].items()))
        profiled = profile_ops("16", {f"{name}_{op}": fn
                                      for op, fn in run["ops"].items()})
        per_op.update(profiled)
        check_zero_launches(name, run["ops"], profiled)
    return counts, times, per_op


# kernel I's and the finish's (D's, or DG's for a BFV encryption)
# launches a call of each default-path op (one each for a whole zero
# encryption, public key or switching-key row set), the BFV encryptions
# whose finish is DG's (with no G launch), and the ops whose trace holds
# no device kernel but the port's (no stack, cat or contiguous copy)
ZERO_OP_LAUNCHES = {"public_key": (1, 1), "encrypt": (1, 1),
                    "encrypt_symmetric": (1, 1), "expand_seed": (1, 0),
                    f"encrypt_symmetric_many{MANY}": (1, 1),
                    "relin_key_q": (1, 1), "keyswitch_key_q": (1, 1)}
BFV_EMBED_OPS = ("encrypt", "encrypt_symmetric", f"encrypt_symmetric_many{MANY}")
NO_COPY_OPS = ("public_key", "encrypt", "encrypt_symmetric", "relin_key_q",
               "keyswitch_key_q")


def own_kernels() -> set:
    """The names of the port's device functions (csrc's __global__s)."""
    names = set()
    for src in _kernels.CSRC.glob("*.cu"):
        names.update(re.findall(r"__global__[\s\S]{0,200}?\b(\w+_kernel)\s*\(",
                                src.read_text()))
    return names


def foreign_kernels(each: dict) -> dict:
    """The device kernels and copies of a profiled op that are none of the
    port's (torch's stack, cat and copy kernels, device-to-device and
    device-to-host memcpys); a batched path's upload of its seeds (a host
    to device memcpy) is not counted."""
    own = own_kernels()
    return {k: c for k, (c, _) in each.items()
            if k not in own and not k.startswith("Memcpy HtoD")}


def check_zero_launches(name: str, ops: dict, profiled: dict) -> None:
    """Each op of ZERO_OP_LAUNCHES launches I and its finish (D, or DG)
    that many times a call (launch counters), a BFV encryption (BFV_EMBED_
    OPS) DG once and G never, and each of NO_COPY_OPS no kernel but the
    port's (profiler)."""
    for op, want in ZERO_OP_LAUNCHES.items():
        _kernels.reset_launch_counts()
        ops[op]()
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        dg, g = counts["DG_zero_embed"], counts["G_plain_embed"]
        got = (counts["I_sampling"], counts["D_rns_elementwise"] + dg)
        foreign = foreign_kernels(profiled[f"{name}_{op}"]["each"])
        log(f"[16] {name} {op}: I {got[0]}, D {got[1] - dg}, DG {dg}, G {g} "
            f"launches a call; other device kernels and copies a call "
            f"{foreign or 0}")
        if got != want:
            raise AssertionError(f"{name} {op}: I and the finish launch "
                                 f"{got} times a call, not {want}")
        embeds = name == "bfv" and op in BFV_EMBED_OPS
        if (dg, g) != ((1, 0) if embeds else (0, 0)):
            raise AssertionError(f"{name} {op}: DG and G launch {dg}, {g} "
                                 "times a call")
        if op in NO_COPY_OPS and foreign:
            raise AssertionError(f"{name} {op}: device kernels that are "
                                 f"none of the port's: {foreign}")


# --------------------------------------------------------------------------
# hoisted Galois, the negacyclic shift and LWE: phases 17-19
# --------------------------------------------------------------------------

def lwe_work(words_in: int, words_out: int, mul64: int = 0) -> tuple:
    """bound() arguments: every input word read once, every output word
    written once."""
    return (words_in + words_out) * 8, mul64


def phase_lwe_kernels(ctx) -> dict:
    """Phase 17: N1 (the shift, the extract, the assemble), N2, kernel M's
    batched gather, kernel B's batched product and K'' (divisor P and
    divisor q_last) against their plain versions at the shapes of phase 18
    on the BGV context, word for word."""
    rng = np.random.default_rng(SEED + 17)
    dev = ctx.device
    key, data = ctx.key_context_data, ctx.first_context_data
    q5 = data.ntt
    k = q5.k
    used = key.ntt.select(keyswitch.used_limbs(k, key.limbs))
    half = LWE_TERMS // 2                        # the first layer's folds
    ct = _uniform(rng, q5.values, (2, k, N), dev)
    terms = np.sort(rng.choice(N, LWE_TERMS, replace=False))
    shifts = to_torch(np.where(terms == 0, 0, 2 * N - terms), dev)
    c1s = _uniform(rng, q5.values, (LWE_TERMS, k, N), dev)
    c0s = _uniform(rng, q5.values, (LWE_TERMS, k, 1), dev)[..., 0]
    inv_n = [pow(N, -1, q) for q in q5.values]
    cur = _uniform(rng, q5.values, (LWE_TERMS, 2, k, N), dev)
    elts = [galois_util.get_elt_from_step(N, s) for s in range(1, 17)]
    signed = galois.batched_tables(N, tuple(elts), dev, True)
    srcs, keeps = galois.unpack_table(signed)
    unsigned = galois.batched_tables(N, tuple(elts), dev, False)
    perms, _ = galois.unpack_table(unsigned)
    one = galois.batched_tables(N, (5,), dev, True)
    one_src, one_keep = galois.unpack_table(one.expand(half, N))
    hoist_x = _uniform(rng, q5.values, (16, 2, k, N), dev)
    fold_x = _uniform(rng, q5.values, (half, 2, k, N), dev)
    b_key = _uniform(rng, used.values, (k, 2, k + 1, N), dev)
    b_targets = _uniform(rng, used.values, (half, k, k + 1, N), dev)
    kpp_x = _uniform(rng, used.values, (2 * half, k + 1, N), dev)
    kpp_acc = _uniform(rng, q5.values, (half, 1, k, N), dev)
    kq_x = _uniform(rng, q5.values, (2, k, N), dev)
    ks_consts, ms_consts = data.bgv_keyswitch_consts, data.bgv_mod_switch_consts
    words = lambda *ts: sum(x.numel() for x in ts)
    gather_perms = perms.reshape(16, 1, 1, N).expand(hoist_x.shape)
    checks = [
        ("N1_negacyclic", f"shift (2,{k},n) by n+5",
         lambda: poly.negacyclic_shift(ct, N + 5, q5),
         lambda: poly.negacyclic_shift_plain(ct, N + 5, q5),
         lwe_work(words(ct), words(ct)), None),
        ("N1_negacyclic", f"extract {LWE_TERMS} terms of (2,{k},n)",
         lambda: poly.extract_lwe_many(ct, shifts, q5),
         lambda: poly.extract_lwe_many_plain(ct, shifts, q5), None, None),
        ("N1_negacyclic", f"assemble ({LWE_TERMS},{k},n) at 0, times n^-1",
         lambda: poly.assemble_lwe(c1s, c0s, 0, q5, inv_n),
         lambda: poly.assemble_lwe_plain(c1s, c0s, 0, q5, inv_n), None,
         None),
        ("N1_negacyclic", f"shift ({LWE_TERMS},{k},n), a shift per row",
         lambda: poly.negacyclic_shift(c1s, shifts, q5),
         lambda: poly.negacyclic_shift_plain(c1s, shifts, q5), None, None),
        ("N2_pack_prepare", f"({LWE_TERMS},2,{k},n) by n/2",
         lambda: poly.pack_fold_prepare(cur, N // 2, q5),
         lambda: poly.pack_fold_prepare_plain(cur, N // 2, q5),
         lwe_work(words(cur), 2 * words(cur[:half])), None),
        ("M_galois", f"batched unsigned, 16 tables (16,2,{k},n)",
         lambda: galois.permute_batched(hoist_x, unsigned, q5),
         lambda: galois.permute_batched_plain(hoist_x, perms, None, q5),
         lwe_work(words(hoist_x), words(hoist_x)),
         lambda: hoist_x.gather(-1, gather_perms)),
        ("M_galois", f"batched signed, 16 tables (16,2,{k},n)",
         lambda: galois.permute_batched(hoist_x, signed, q5),
         lambda: galois.permute_batched_plain(hoist_x, srcs, keeps, q5),
         None, None),
        ("M_galois", f"one table, component-major ({half},2,{k},n)",
         lambda: galois.permute_batched(fold_x, one, q5, comps_first=True),
         lambda: galois.permute_batched_plain(fold_x, one_src, one_keep, q5,
                                              comps_first=True), None, None),
        ("B_dyadic_mac", f"batched key switch ({half},{k},{k + 1},n) x "
         f"({k},2,{k + 1},n)",
         lambda: ntt.dyadic_mac_batched(b_key, b_targets, used),
         lambda: ntt.dyadic_mac_plain(b_targets.transpose(0, 1).unsqueeze(2),
                                      b_key.unsqueeze(1), used),
         lwe_work(words(b_key, b_targets), half * 2 * (k + 1) * N,
                  half * 2 * (k + 1) * N * (2 * k + 5)), None),
        ("Kpp_bgv_coeff", f"divisor P ({2 * half},{k + 1},n) onto "
         f"({half},1,{k},n)",
         lambda: keyswitch.bgv_divide_last(kpp_x, ks_consts, kpp_acc, 2),
         lambda: keyswitch.bgv_divide_last_plain(kpp_x, ks_consts, kpp_acc,
                                                 2),
         lwe_work(words(kpp_x, kpp_acc), 2 * half * k * N,
                  2 * half * N * (k * 10 + 5)), None),
        ("Kpp_bgv_coeff", f"divisor q_last (2,{k},n)",
         lambda: rns.mod_t_and_divide_q_last(kq_x, q5, ms_consts),
         lambda: keyswitch.bgv_divide_last_plain(kq_x, ms_consts), None,
         None),
    ]
    return run_checks("17", [(c[0], c[1], "words") + c[2:] for c in checks])


def negashift(v: np.ndarray, s: int, t: Optional[int]) -> np.ndarray:
    """Coefficients v (n,) times x^s mod x^n + 1, mod t (or as floats)."""
    s %= 2 * N
    p = np.arange(N)
    e = p + s
    out = np.zeros_like(v)
    neg = (e // N) % 2 == 1
    vals = np.where(neg, (t - v) % t if t else -v, v)
    out[e % N] = vals
    return out


class LweScheme:
    """One scheme's phase-18 state on the card: keys made on the device
    from a secret key, its encoder, evaluator and decryptor, and the two
    ciphertexts the ops start from (slots for the rotations, coefficients
    for the shift and LWE ops; CKKS takes one for both)."""

    def __init__(self, name: str, ctx, seed: int):
        self.name, self.ctx = name, ctx
        self.ckks = ctx.scheme == P.SchemeType.ckks
        kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(seed))
        dk = P.KeyGenerator(ctx, kg.secret_key, rnd.seed_from_uint64(seed + 1))
        self.rot_elts = galois_util.get_elts_from_steps(N, ROTATE_STEPS)
        self.auto_elts = [(1 << i) + 1 for i in range(1, N.bit_length())]
        elts = sorted(set(self.rot_elts + self.auto_elts + [2 * N - 1]))
        t0 = time.perf_counter()
        self.gk = dk.create_galois_keys(elts=elts)
        torch.cuda.synchronize()
        self.keygen_s = time.perf_counter() - t0
        self.elts = elts
        self.sk = kg.secret_key
        self.ev = P.Evaluator(ctx)
        self.dec = P.Decryptor(ctx, kg.secret_key)
        enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                          seed=rnd.seed_from_uint64(seed + 2))
        rng = np.random.default_rng(seed)
        self.cd = ctx.first_context_data
        if self.ckks:
            self.encoder = P.CKKSEncoder(ctx)
            self.t = None
            self.slots = (rng.uniform(-1, 1, N // 2)
                          + 1j * rng.uniform(-1, 1, N // 2))
            self.ct_slots = enc.encrypt_symmetric(
                self.encoder.encode(self.slots, CKKS_SCALE))
            self.ct_coeffs = self.ct_slots
            self.coeffs = self.coefficients(self.ct_slots)
        else:
            self.encoder = P.BatchEncoder(ctx)
            self.t = self.encoder.plain_modulus
            self.slots = rng.integers(0, self.t, N, dtype=np.uint64)
            self.coeffs = rng.integers(0, self.t, N, dtype=np.uint64)
            self.ct_slots = enc.encrypt_symmetric(
                self.encoder.encode(self.slots))
            self.ct_coeffs = enc.encrypt_symmetric(
                self.encoder.encode_polynomial(self.coeffs))
        self.terms = np.sort(rng.choice(np.arange(2, N - 1), LWE_TERMS - 3,
                                        replace=False))
        self.terms = np.concatenate([[0, 1], self.terms, [N - 1]])
        self.worst = 0.0                 # CKKS: largest coefficient error

    def coefficients(self, ct) -> np.ndarray:
        """The decrypted coefficients: mod t (BFV, BGV) or centred, as
        floats, unscaled (CKKS)."""
        plain = self.dec.decrypt(ct)
        if self.ckks:
            return self.encoder._compose_centered_host(
                plain, self.ctx.get_context_data(plain.level))
        return self.encoder.decode_polynomial(plain)

    def slots_of(self, ct) -> np.ndarray:
        return (self.encoder.decode(self.dec.decrypt(ct)))

    def rotated(self, step: int) -> np.ndarray:
        if self.ckks:
            return np.roll(self.slots, -step)
        rows = self.slots.reshape(2, N // 2)
        return np.roll(rows, -step, axis=1).reshape(-1)

    def same_slots(self, got, want, what: str) -> None:
        if self.ckks:
            err = float(np.abs(got - want).max())
            if err > 1e-4:
                raise AssertionError(f"{self.name} {what}: decodes {err} "
                                     "from the expected slots")
        elif not np.array_equal(got, want):
            raise AssertionError(f"{self.name} {what}: decrypts to the "
                                 "wrong slots")

    def same_coeffs(self, got, want, what: str) -> None:
        if self.ckks:
            err = float(np.abs(got - want).max())
            self.worst = max(self.worst, err)
            if err > CKKS_LWE_BOUND:
                raise AssertionError(f"{self.name} {what}: coefficients "
                                     f"{err} from the expected, over "
                                     f"{CKKS_LWE_BOUND}")
        elif not np.array_equal(got, np.asarray(want).astype(np.uint64)):
            bad = int((got != want).sum())
            raise AssertionError(f"{self.name} {what}: {bad} coefficients "
                                 "decrypt wrong")

    def coeff_form(self, ct):
        return self.ev.transform_from_ntt(ct) if ct.is_ntt_form else ct


def lwe_requests(s: LweScheme) -> dict:
    """Phase 18's ops on one scheme, checked by decryption; returns the
    results the CPU comparison and the timings reuse."""
    ev, n = s.ev, N
    sequential = (ev.rotate_vector if s.ckks else ev.rotate_rows)
    for step, ct in zip(ROTATE_STEPS, ev.rotate_many(s.ct_slots,
                                                     ROTATE_STEPS, s.gk)):
        want = s.rotated(step)
        s.same_slots(s.slots_of(ct), want, f"rotate_many step {step}")
        s.same_slots(s.slots_of(sequential(s.ct_slots, step, s.gk)), want,
                     f"sequential rotation {step}")
    elts4 = [galois_util.get_elt_from_step(n, 1),
             galois_util.get_elt_from_step(n, -1), 2 * n - 1,
             galois_util.get_elt_from_step(n, 4)]
    hoisted4 = ev.apply_galois_many(s.ct_slots, elts4, s.gk)
    for elt, ct in zip(elts4, hoisted4):
        s.same_slots(s.slots_of(ct), s.slots_of(
            ev.apply_galois(s.ct_slots, elt, s.gk)),
            f"apply_galois_many element {elt}")
    if s.ctx.scheme == P.SchemeType.bgv:
        # coefficient form: the key switch divides there (K'')
        coeff_slots = s.coeff_form(s.ct_slots)
        for elt, ct in zip(elts4, ev.apply_galois_many(coeff_slots, elts4,
                                                       s.gk)):
            s.same_slots(s.slots_of(ct), s.slots_of(hoisted4[elts4.index(
                elt)]), f"coefficient-form apply_galois_many element {elt}")
        s.same_slots(s.slots_of(ev.rotate_rows(coeff_slots, 1, s.gk)),
                     s.rotated(1), "coefficient-form rotate_rows(1)")
    coeff_ct = s.coeff_form(s.ct_coeffs)
    for shift in (1, n - 1, n + 5):
        s.same_coeffs(s.coefficients(ev.negacyclic_shift(coeff_ct, shift)),
                      negashift(s.coeffs, shift, s.t),
                      f"negacyclic_shift {shift}")
    lwes = ev.extract_lwe_many(s.ct_coeffs, [int(x) for x in s.terms])
    packed = ev.pack_lwe_ciphertexts(lwes, s.gk)
    want = np.zeros_like(s.coeffs)
    stride = n // LWE_TERMS
    want[::stride] = s.coeffs[s.terms]
    s.same_coeffs(s.coefficients(packed), want,
                  f"pack_lwe_ciphertexts of {LWE_TERMS} extracted terms")
    trace = ev.field_trace(s.ct_coeffs, s.gk, 0)
    want = np.zeros_like(s.coeffs)
    want[0] = (int(s.coeffs[0]) * n % s.t) if s.t else s.coeffs[0] * n
    s.same_coeffs(s.coefficients(trace), want, "field_trace(logn=0)")
    log(f"[18] {s.name}: rotate_many over {ROTATE_STEPS} (one hoist) and "
        f"the sequential rotations, apply_galois_many over {elts4} and "
        "apply_galois"
        + (" (also in coefficient form, and rotate_rows(1) there)"
           if s.ctx.scheme == P.SchemeType.bgv else "")
        + ", negacyclic_shift by 1, n-1, n+5, "
        f"extract_lwe_many({LWE_TERMS}) + pack_lwe_ciphertexts and "
        "field_trace(logn=0) decrypt as expected"
        + (f" (CKKS coefficients within {s.worst:.4g} of the expected, "
           f"bound {CKKS_LWE_BOUND:g} = 2^-16 scale)" if s.ckks else ""))
    return {"elts4": elts4, "hoisted4": hoisted4, "lwes": lwes,
            "coeff_ct": coeff_ct}


def lwe_cpu_check(s: LweScheme, out: dict) -> None:
    """One hoisted call (m = 4) and one pack of 8 against the port's own
    CPU run on the same input words."""
    t0 = time.perf_counter()
    cpu_ctx = P.HeContext(s.ctx.key_context_data.parms, device="cpu")
    ev = P.Evaluator(cpu_ctx)
    ct = s.ct_slots
    cpu_ct = interop.ciphertext(to_numpy(ct.data), ct.level, ct.is_ntt_form,
                                "cpu", ct.scale, ct.correction_factor)
    need = set(out["elts4"]) | set(s.auto_elts)
    gk = P.GaloisKeys(keys={e: s.gk.keys[e].cpu() for e in need})
    got = [to_numpy(c.data) for c in out["hoisted4"]]
    want = [to_numpy(c.data) for c in ev.apply_galois_many(
        cpu_ct, out["elts4"], gk)]
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{s.name}: apply_galois_many(m = 4) differs "
                             "from the CPU run's words")
    lwes = out["lwes"][:8]
    packed = s.ev.pack_lwe_ciphertexts(lwes, s.gk)
    cpu_lwes = [P.LWECiphertext(c1=l.c1.cpu(), c0=l.c0.cpu(), level=l.level,
                                scale=l.scale,
                                correction_factor=l.correction_factor)
                for l in lwes]
    want = to_numpy(ev.pack_lwe_ciphertexts(cpu_lwes, gk).data)
    if not np.array_equal(to_numpy(packed.data), want):
        raise AssertionError(f"{s.name}: pack_lwe_ciphertexts of 8 differs "
                             "from the CPU run's words")
    log(f"[18] {s.name}: apply_galois_many(m = 4) and a pack of 8 are "
        "word-equal to the port's CPU run on the same words (CPU run "
        f"{time.perf_counter() - t0:.1f} s)")


def lwe_timings(s: LweScheme, out: dict) -> dict:
    """Medians (CUDA events) of the hoisted path (forced down to m = 1,
    below the evaluator's HOIST_MIN_M) against m sequential apply_galois
    calls, and of the LWE ops."""
    ev, ct = s.ev, s.ct_slots
    elts = s.elts[:max(HOIST_MS)]
    times = {}
    ev.HOIST_MIN_M = 1
    for m in HOIST_MS:
        times[f"hoisted{m}"] = cuda_ms(
            lambda m=m: ev.apply_galois_many(ct, elts[:m], s.gk))
        times[f"sequential{m}"] = cuda_ms(
            lambda m=m: [ev.apply_galois(ct, e, s.gk) for e in elts[:m]])
    del ev.HOIST_MIN_M
    lwes = out["lwes"]
    terms = [int(x) for x in s.terms]
    times.update({
        f"extract_lwe_many{LWE_TERMS}": cuda_ms(
            lambda: ev.extract_lwe_many(s.ct_coeffs, terms)),
        "pack_lwe16": cuda_ms(lambda: ev.pack_lwe_ciphertexts(lwes[:16],
                                                               s.gk)),
        f"pack_lwe{LWE_TERMS}": cuda_ms(
            lambda: ev.pack_lwe_ciphertexts(lwes, s.gk), reps=SLOW_REPS * 2),
        "field_trace": cuda_ms(lambda: ev.field_trace(s.ct_coeffs, s.gk, 0)),
        "negacyclic_shift": cuda_ms(
            lambda: ev.negacyclic_shift(out["coeff_ct"], N + 5)),
    })
    log(f"[18] {s.name} medians (CUDA events, ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    log(f"[18] {s.name} hoisted / sequential (HOIST_MIN_M = "
        f"{ev.HOIST_MIN_M}): " + ", ".join(
            f"m={m} {times[f'hoisted{m}'] / times[f'sequential{m}']:.3f}"
            for m in HOIST_MS))
    return times


def phase_lwe(ctxs: dict, counter) -> tuple:
    """Phases 18-19: the hoisted Galois path, the negacyclic shift and the
    LWE ops of each scheme on the card, in a count window of their own
    (phase 19), then the CPU comparison, the medians and the profile."""
    schemes = {}
    for i, (name, ctx) in enumerate(ctxs.items()):
        schemes[name] = LweScheme(name, ctx, LWE_SEED + 10 * i)
        log(f"[18] {name}: {len(schemes[name].elts)} Galois keys made on the "
            f"card in {schemes[name].keygen_s:.2f} s (kernel Q)")
    counter.calls.clear()
    _kernels.reset_launch_counts()
    with DECRYPTS.window("lwe"):
        outs = {name: lwe_requests(s) for name, s in schemes.items()}
        torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    check_path("19", "18 (hoisted Galois and LWE)", LWE_PATH, counts,
               counter)
    times, per_op, worst = {}, {}, {}
    for name, s in schemes.items():
        lwe_cpu_check(s, outs[name])
        times[name] = lwe_timings(s, outs[name])
        worst[name] = s.worst
        ev, ct, gk, lwes = s.ev, s.ct_slots, s.gk, outs[name]["lwes"]
        elts8 = s.elts[:8]
        per_op.update(profile_ops("19", {
            f"{name}_apply_galois_many8":
                lambda: ev.apply_galois_many(ct, elts8, gk),
            f"{name}_extract_lwe_many{LWE_TERMS}":
                lambda: ev.extract_lwe_many(s.ct_coeffs,
                                            [int(x) for x in s.terms]),
            f"{name}_pack_lwe16": lambda: ev.pack_lwe_ciphertexts(lwes[:16],
                                                                  gk),
            f"{name}_field_trace":
                lambda: ev.field_trace(s.ct_coeffs, gk, 0),
        }))
    return counts, times, per_op, worst


# --------------------------------------------------------------------------
# troy's app layer: phases 20-22
# --------------------------------------------------------------------------

def tile_work(a: torch.Tensor, w: torch.Tensor, out_words: int,
              mul64: int) -> tuple:
    """bound() arguments of a tile kernel: its inputs read once, its output
    written once, its 64-bit products."""
    return (a.numel() + w.numel() + out_words) * 8, mul64


def phase_app_kernels(ctx) -> dict:
    """Phase 20: P1, P2, P3, AP2i (P2 in A's first inverse pass) and AGp
    (G''s lift in A's first forward pass) against their plain versions on
    the card at the app protocol's full-width shapes, word for word
    (tolerance 0). No PyTorch call computes a modular tile contraction on
    u64 words: no library time."""
    rng = np.random.default_rng(SEED + 20)
    dev = ctx.device
    cd = ctx.first_context_data
    q, qb = cd.ntt, cd.rns.q_bsk
    k = q.k
    conv_a = _uniform(rng, q.values, (1, 64, 2, k, N), dev)
    conv_w = _uniform(rng, q.values, (64, 52, k, N), dev)
    mm_a = _uniform(rng, q.values, (1, 8, 2, k, N), dev)
    mm_w = _uniform(rng, q.values, (8, 16, k, N), dev)
    big_a = _uniform(rng, q.values, (1, 32, 2, k, N), dev)
    big_w = _uniform(rng, q.values, (32, 126, k, N), dev)
    rag_a = _uniform(rng, q.values, (3, 5, 2, k, N), dev)
    rag_w = _uniform(rng, q.values, (5, 13, k, N), dev)
    lazy = [4 * v for v in qb.values]
    bfv_a = _uniform(rng, lazy, (1, 2, qb.k, N), dev)
    bfv_w = _uniform(rng, lazy, (16, 2, qb.k, N), dev)
    ntt_a = _uniform(rng, q.values, (1, 2, k, N), dev)
    ntt_w = _uniform(rng, q.values, (16, 2, k, N), dev)
    bfv_a3 = _uniform(rng, lazy, (2, 3, qb.k, N), dev)
    bfv_w5 = _uniform(rng, lazy, (5, 2, qb.k, N), dev)
    tt, Q = int(cd.plain_modulus), cd.total_coeff_modulus
    half = cd.plain_upper_half_threshold
    mm_m = to_torch(rng.integers(0, tt, (8, 16, N), dtype=np.uint64), dev)
    conv_m = to_torch(rng.integers(0, tt, (64, 52, N), dtype=np.uint64), dev)
    fold16 = _uniform(rng, q.values, (16, 2, k, N), dev)
    fold20 = _uniform(rng, q.values, (20, 2, k, N), dev)
    # P1: per output word 2 I products' words and a Barrett-128 (7) per 63
    # terms; P2: 4 products and 3 Barretts per (x, y, row, coefficient)
    p1_out = 52 * 2 * k * N
    checks = [
        ("P1_tile_contract", f"conv (1,64,2,{k},n) x (64,52,{k},n)",
         lambda: tiles.tile_contract(conv_a, conv_w, q),
         lambda: tiles.tile_contract_plain(conv_a, conv_w, q),
         tile_work(conv_a, conv_w, p1_out, p1_out * (2 * 64 + 7 * 2)),
         None),
        ("P1_tile_contract", f"matmul (1,8,2,{k},n) x (8,16,{k},n)",
         lambda: tiles.tile_contract(mm_a, mm_w, q),
         lambda: tiles.tile_contract_plain(mm_a, mm_w, q), None, None),
        ("P1_tile_contract", f"BIG (1,32,2,{k},n) x (32,126,{k},n)",
         lambda: tiles.tile_contract(big_a, big_w, q),
         lambda: tiles.tile_contract_plain(big_a, big_w, q), None, None),
        ("P1_tile_contract", f"ragged (3,5,2,{k},n) x (5,13,{k},n)",
         lambda: tiles.tile_contract(rag_a, rag_w, q),
         lambda: tiles.tile_contract_plain(rag_a, rag_w, q), None, None),
        ("P2_pair_convolve", f"BFV X=1 Yc=16 over q u Bsk ({qb.k} rows), "
         "lazy",
         lambda: tiles.tile_pair_convolve(bfv_a, bfv_w, qb),
         lambda: tiles.tile_pair_convolve_plain(bfv_a, bfv_w, qb),
         tile_work(bfv_a, bfv_w, 16 * 3 * qb.k * N,
                   16 * qb.k * N * (4 * 2 + 3 * 7)), None),
        ("P2_pair_convolve", f"X=1 Yc=16 over q ({k} rows)",
         lambda: tiles.tile_pair_convolve(ntt_a, ntt_w, q),
         lambda: tiles.tile_pair_convolve_plain(ntt_a, ntt_w, q), None,
         None),
        ("P3_group_fold", f"m=16 P=16 (16,2,{k},n)",
         lambda: tiles.pack_group_fold(fold16, 16, q),
         lambda: tiles.pack_group_fold_plain(fold16, 16, q),
         tile_work(fold16, fold16[:0], 2 * k * N, 0), None),
        ("P3_group_fold", f"ragged m=20 P=16 (20,2,{k},n)",
         lambda: tiles.pack_group_fold(fold20, 16, q),
         lambda: tiles.pack_group_fold_plain(fold20, 16, q), None, None),
        # P2 in A's first inverse pass (BFV's grid on A's route)
        ("AP2i_pair_intt", f"BFV X=1 Yc=16 over q u Bsk ({qb.k} rows), "
         "lazy",
         lambda: ntt.rns_ntt_inverse_pair_convolve(bfv_a, bfv_w, qb),
         lambda: ntt.ntt_inverse_pair_convolve_plain(bfv_a, bfv_w, qb),
         pair_work(bfv_a, bfv_w, qb), None),
        ("AP2i_pair_intt", f"with P2 + A: X=1 Yc=16 over q u Bsk",
         lambda: ntt.rns_ntt_inverse_pair_convolve(bfv_a, bfv_w, qb),
         lambda: ntt.rns_ntt_inverse(tiles.tile_pair_convolve(bfv_a, bfv_w,
                                                              qb), qb),
         None, None),
        ("AP2i_pair_intt", f"X=2 Yc=5, sizes 3 x 2 over q u Bsk",
         lambda: ntt.rns_ntt_inverse_pair_convolve(bfv_a3, bfv_w5, qb),
         lambda: ntt.ntt_inverse_pair_convolve_plain(bfv_a3, bfv_w5, qb),
         None, None),
        # G''s lift in A's first pass at the app's weight tiles (phase 11's
        # headline shape stands for AGp in the JSON line)
        ("AGp_ntt_lift", f"matmul weights (8,16,n) -> (8,16,{k},n)",
         lambda: ntt.rns_ntt_forward_lift(mm_m, q, tt, half, Q),
         lambda: ntt.ntt_forward_lift_plain(mm_m, q, tt, half, Q),
         lift_work(q, 8 * 16), None),
        ("AGp_ntt_lift", f"conv weights (64,52,n) -> (64,52,{k},n)",
         lambda: ntt.rns_ntt_forward_lift(conv_m, q, tt, half, Q),
         lambda: ntt.ntt_forward_lift_plain(conv_m, q, tt, half, Q), None,
         None),
    ]
    out = run_checks("20", [(c[0], c[1], "words") + c[2:] for c in checks])
    del out["AGp_ntt_lift"]
    return out


def pair_work(a: torch.Tensor, w: torch.Tensor, t) -> tuple:
    """bound() arguments of one AP2i call: a and w in, the inverse-
    transformed products out and the inverse twiddles once; P2's products
    (2 a term) and Barrett-128s (7 an output word) and A's butterfly
    products over every output row."""
    X, s1, R, n = a.shape
    Y, s2 = w.shape[:2]
    rows = X * Y * (s1 + s2 - 1) * R
    return ((a.numel() + w.numel() + rows * n + 2 * R * n) * 8,
            X * Y * R * n * (2 * s1 * s2 + 7 * (s1 + s2 - 1))
            + ntt_rows_mul64(rows, n))


def app_context(scheme) -> "P.HeContext":
    """troy's app benchmark configuration (test/app/linear.cu:575-584, as
    benchmarks/linear_bench.py sets it up): n = 16384, q = {60,60,60},
    t = 2^41."""
    return P.HeContext(P.EncryptionParameters(
        scheme=scheme, poly_modulus_degree=N,
        coeff_modulus=tuple(P.CoeffModulus.create(N, APP_Q_BITS)),
        plain_modulus=P.Modulus(APP_T)))


class AppScheme:
    """One scheme's app state on the card: a secret key from the seed, the
    relin key and the pack's automorphism keys made on the device from it
    (kernel Q), the encryptor, decryptor, evaluator and polynomial
    encoder."""

    def __init__(self, name: str, ctx, seed: int):
        self.name, self.ctx = name, ctx
        self.ckks = ctx.scheme == P.SchemeType.ckks
        kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(seed))
        dk = P.KeyGenerator(ctx, kg.secret_key, rnd.seed_from_uint64(seed + 1))
        t0 = time.perf_counter()
        self.rlk = dk.create_relin_keys()
        # the trace of a pack of 16: elements n + 1, n/2 + 1, n/4 + 1, n/8 + 1
        self.gk = dk.create_galois_keys(elts=[(N >> i) + 1 for i in range(4)])
        torch.cuda.synchronize()
        self.keygen_s = time.perf_counter() - t0
        self.enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                               seed=rnd.seed_from_uint64(seed + 2))
        self.dec = P.Decryptor(ctx, kg.secret_key)
        self.ev = P.Evaluator(ctx)
        self.rng = np.random.default_rng(seed)
        if self.ckks:
            ce = P.CKKSEncoder(ctx)
            self.ep = lambda v: ce.encode_polynomial(v, CKKS_SCALE)
            self.dp = ce.decode_polynomial
            self.t = None
        else:
            be = P.BatchEncoder(ctx)
            self.ep, self.dp = be.encode_polynomial, be.decode_polynomial
            self.t = be.plain_modulus

    def ints(self, shape) -> np.ndarray:
        return self.rng.integers(0, APP_INPUT_BOUND, shape, dtype=np.uint64)


def same_grids(a: "linear.Cipher2d", b: "linear.Cipher2d", what: str):
    for ra, rb in zip(a.data, b.data):
        for ca, cb in zip(ra, rb):
            if not torch.equal(ca.data, cb.data) or ca.level != cb.level:
                raise AssertionError(f"{what}: Cipher2d.save/load changed "
                                     "the words")


def roundtrip(grid, ctx, what: str) -> "linear.Cipher2d":
    """The grid through Cipher2d.save and load, checked word for word."""
    back = linear.Cipher2d.load(grid.save(ctx), ctx)
    same_grids(grid, back, what)
    return back


def exact(got: np.ndarray, want: np.ndarray, t: int, what: str) -> None:
    got = got.astype(object) % t
    if got.shape != want.shape or not np.array_equal(got, want % t):
        bad = int((got != want % t).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{what}: {bad} outputs differ from the "
                             "integer oracle mod t")


def matmul_oracle(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """x w exactly: entries below 2^8 and at most 500 terms stay below
    2^53, so float64 products and sums are exact."""
    return (x.astype(np.float64) @ w.astype(np.float64)).astype(
        np.int64).astype(object)


def conv_oracle(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The valid 2-D convolution (cross-correlation, as the app layer
    computes it) by im2col, exact in float64 (below 2^53)."""
    B, CI, H, W = x.shape
    CO, _, KH, KW = w.shape
    oh, ow = H - KH + 1, W - KW + 1
    cols = np.stack([x[:, :, i:i + oh, j:j + ow] for i in range(KH)
                     for j in range(KW)], axis=2)      # (B, CI, KH KW, oh, ow)
    cols = cols.reshape(B, CI * KH * KW, oh * ow).astype(np.float64)
    out = np.einsum("ok,bkp->bop", w.reshape(CO, -1).astype(np.float64), cols)
    return out.reshape(B, CO, oh, ow).astype(np.int64).astype(object)


def app_requests(bfv: AppScheme, bgv: AppScheme, ckks: AppScheme) -> dict:
    """Phase 21's runs, checked: the packed ct x pt and ct x ct matmuls of
    troy's benchmark, the BIG matmul with saveTerms, the full conv2d, and
    a packed BGV and an unpacked CKKS matmul; returns what the timings and
    the profile reuse."""
    s, ctx, ev = bfv, bfv.ctx, bfv.ev
    out = {"bytes": {}}
    # 1: 64 x 128 x 256, pack_lwe (blocks (64, 16, 16))
    h = linear.MatmulHelper(64, 128, 256, N, objective=0, pack_lwe=True)
    x, w = s.ints((64, 128)), s.ints((128, 256))
    want = matmul_oracle(x, w)
    w_pt = h.encode_weights(s.ep, w)
    x_ct = roundtrip(h.encrypt_inputs(s.enc, s.ep, x), ctx, "matmul inputs")
    y = h.matmul(ev, x_ct, w_pt)
    roundtrip(y, ctx, "matmul outputs")
    packed = h.pack_outputs(ev, s.gk, y)
    blob = h.serialize_outputs(ev, ctx, packed)
    back = h.deserialize_outputs(ev, ctx, blob)
    exact(h.decrypt_outputs(s.dp, s.dec, back), want, s.t,
          "matmul 64x128x256 packed")
    out["bytes"]["matmul_packed"] = len(blob)
    # 2: the same with encrypted weights, relinearized, then packed
    w_ct = roundtrip(h.encode_weights(s.ep, w).encrypt_symmetric(s.enc), ctx,
                     "ct x ct weights")
    yc = h.matmul_cipher(ev, x_ct, w_ct)
    rel = yc.relinearize(ev, s.rlk)
    packed_c = h.pack_outputs(ev, s.gk, rel)
    blob_c = h.serialize_outputs(ev, ctx, packed_c)
    exact(h.decrypt_outputs(s.dp, s.dec, h.deserialize_outputs(ev, ctx,
                                                               blob_c)),
          want, s.t, "ct x ct matmul 64x128x256 packed")
    # 3: BIG 128 x 500 x 1001, saveTerms
    hb = linear.MatmulHelper(128, 500, 1001, N, objective=0, pack_lwe=False)
    xb, wb = s.ints((128, 500)), s.ints((500, 1001))
    wb_pt = hb.encode_weights(s.ep, wb)
    xb_ct = roundtrip(hb.encrypt_inputs(s.enc, s.ep, xb), ctx,
                      "BIG matmul inputs")
    yb = hb.matmul(ev, xb_ct, wb_pt)
    blob_b = hb.serialize_outputs(ev, ctx, yb)
    back_b = hb.deserialize_outputs(ev, ctx, blob_b)
    exact(hb.decrypt_outputs(s.dp, s.dec, back_b), matmul_oracle(xb, wb),
          s.t, "BIG matmul 128x500x1001 saveTerms")
    out["bytes"]["big_save_terms"] = len(blob_b)
    # 4: conv2d 1 x 64 x 256, 56 x 56, 3 x 3 (blocks (1, 56, 56, 1, 5))
    hc = linear.Conv2dHelper(1, 56, 56, 3, 3, 64, 256, N, objective=0)
    blocks = (hc.block_batch, hc.block_height, hc.block_width,
              hc.block_in_channels, hc.block_out_channels)
    if blocks != (1, 56, 56, 1, 5):
        raise AssertionError(f"conv2d blocks {blocks}")
    xv, wv = s.ints((1, 64, 56, 56)), s.ints((256, 64, 3, 3))
    wv_pt = hc.encode_weights(s.ep, wv)
    xv_ct = roundtrip(hc.encrypt_inputs(s.enc, s.ep, xv), ctx,
                      "conv2d inputs")
    yv = hc.conv2d(ev, xv_ct, wv_pt)
    blob_v = hc.serialize_outputs(ev, ctx, yv)
    back_v = hc.deserialize_outputs(ev, ctx, blob_v)
    exact(hc.decrypt_outputs(s.dp, s.dec, back_v), conv_oracle(xv, wv), s.t,
          "conv2d 1x64x256 56x56 3x3")
    out["bytes"]["conv_save_terms"] = len(blob_v)
    conv_flat = [c for row in yv.data for c in row]
    # BGV: 64 x 128 x 256 packed, the inputs in coefficient form
    g = bgv
    xg, wg = g.ints((64, 128)), g.ints((128, 256))
    xg_ct = h.encrypt_inputs(g.enc, g.ep, xg)
    xg_ct = linear.Cipher2d([[g.ev.transform_from_ntt(c) for c in row]
                             for row in xg_ct.data])
    yg = h.pack_outputs(g.ev, g.gk, h.matmul(g.ev, xg_ct,
                                             h.encode_weights(g.ep, wg)))
    back_g = h.deserialize_outputs(g.ev, g.ctx,
                                   h.serialize_outputs(g.ev, g.ctx, yg))
    exact(h.decrypt_outputs(g.dp, g.dec, back_g), matmul_oracle(xg, wg), g.t,
          "BGV matmul 64x128x256 packed")
    # BGV ct x ct 64 x 128 x 256, inputs and weights encrypted (NTT form):
    # the pair grid on P2's own kernel, relinearized, decrypted exactly
    hg = linear.MatmulHelper(64, 128, 256, N, objective=0, pack_lwe=False)
    xg_c = hg.encrypt_inputs(g.enc, g.ep, xg)
    wg_c = hg.encode_weights(g.ep, wg).encrypt_symmetric(g.enc)
    exact(hg.decrypt_outputs(g.dp, g.dec, hg.matmul_cipher(
        g.ev, xg_c, wg_c).relinearize(g.ev, g.rlk)), matmul_oracle(xg, wg),
          g.t, "BGV ct x ct matmul 64x128x256")
    # CKKS: 64 x 128 x 256, no packing, scale 2^40
    c = ckks
    hk = linear.MatmulHelper(64, 128, 256, N, objective=0, pack_lwe=False)
    xk, wk = c.rng.uniform(-1, 1, (64, 128)), c.rng.uniform(-1, 1, (128, 256))
    yk = hk.matmul(c.ev, hk.encrypt_inputs(c.enc, c.ep, xk),
                   hk.encode_weights(c.ep, wk))
    back_k = hk.deserialize_outputs(c.ev, c.ctx,
                                    hk.serialize_outputs(c.ev, c.ctx, yk))
    err = float(np.abs(hk.decrypt_outputs(c.dp, c.dec, back_k).astype(
        np.float64) - xk @ wk).max())
    if err > CKKS_APP_BOUND:
        raise AssertionError(f"CKKS matmul: max error {err} over "
                             f"{CKKS_APP_BOUND}")
    out["ckks_max_error"] = err
    log(f"[21] BFV n = {N}, q = {APP_Q_BITS}, t = 2^41: matmul 64x128x256 "
        "packed (ct x pt and ct x ct relinearized), matmul 128x500x1001 "
        "saveTerms, conv2d 1x64x256 56x56 3x3 decrypt exactly to the "
        "integer oracle mod t; so do the packed BGV matmul and the BGV ct "
        "x ct matmul (t = 2^41); "
        f"the CKKS matmul is within {err:.3g} (bound {CKKS_APP_BOUND:g}); "
        "every grid round-trips Cipher2d.save/load; output bytes "
        f"{out['bytes']}")
    out.update(h=h, x=x, w=w, w_pt=w_pt, x_ct=x_ct, y=y, packed=packed,
               blob=blob, back=back, w_ct=w_ct, yc=yc, hb=hb, xb=xb, wb=wb,
               wb_pt=wb_pt, xb_ct=xb_ct, yb=yb, blob_b=blob_b, back_b=back_b,
               hc=hc, xv=xv, wv=wv, wv_pt=wv_pt, xv_ct=xv_ct, yv=yv,
               blob_v=blob_v, back_v=back_v, conv_flat=conv_flat, hg=hg,
               xg_c=xg_c, wg_c=wg_c)
    return out


def app_timings(s: AppScheme, r: dict) -> dict:
    """Phase 21's medians (CUDA events, APP_REPS runs after one warm-up)
    of each protocol phase, in benchmarks/linear_bench.py's order, then
    the BIG matmul's and the conv2d's; the host's encode loops and the
    output gathers are phases of their own."""
    ev, ctx = s.ev, s.ctx
    ms = lambda fn: cuda_ms(fn, reps=APP_REPS, warmup=1)
    h, hb, hc = r["h"], r["hb"], r["hc"]
    times = {
        "encode_weights": ms(lambda: h.encode_weights(s.ep, r["w"])),
        "encode_inputs_host": ms(lambda: h.encode_inputs(s.ep, r["x"])),
        "encode_encrypt_inputs": ms(lambda: h.encrypt_inputs(s.enc, s.ep,
                                                             r["x"])),
        "matmul": ms(lambda: h.matmul(ev, r["x_ct"], r["w_pt"])),
        "pack_outputs": ms(lambda: h.pack_outputs(ev, s.gk, r["y"])),
        "matmul_cipher": ms(lambda: h.matmul_cipher(ev, r["x_ct"],
                                                    r["w_ct"])),
        "relinearize_16": ms(lambda: r["yc"].relinearize(ev, s.rlk)),
        "serialize": ms(lambda: h.serialize_outputs(ev, ctx, r["packed"])),
        "deserialize": ms(lambda: h.deserialize_outputs(ev, ctx, r["blob"])),
        "decrypt_many": ms(lambda: s.dec.decrypt_many(r["back"][0])),
        "decrypt_decode": ms(lambda: h.decrypt_outputs(s.dp, s.dec,
                                                       r["back"])),
        "big_encode_weights": ms(lambda: hb.encode_weights(s.ep, r["wb"])),
        "big_encode_encrypt_inputs": ms(lambda: hb.encrypt_inputs(
            s.enc, s.ep, r["xb"])),
        "big_matmul": ms(lambda: hb.matmul(ev, r["xb_ct"], r["wb_pt"])),
        "big_serialize": ms(lambda: hb.serialize_outputs(ev, ctx, r["yb"])),
        "big_deserialize": ms(lambda: hb.deserialize_outputs(ev, ctx,
                                                             r["blob_b"])),
        "big_decrypt_decode": ms(lambda: hb.decrypt_outputs(s.dp, s.dec,
                                                            r["back_b"])),
        "conv_encode_weights": ms(lambda: hc.encode_weights(s.ep, r["wv"])),
        "conv_encode_inputs_host": ms(lambda: hc.encode_inputs(s.ep,
                                                               r["xv"])),
        "conv_encode_encrypt_inputs": ms(lambda: hc.encrypt_inputs(
            s.enc, s.ep, r["xv"])),
        "conv2d": ms(lambda: hc.conv2d(ev, r["xv_ct"], r["wv_pt"])),
        "conv_serialize": ms(lambda: hc.serialize_outputs(ev, ctx, r["yv"])),
        "conv_deserialize": ms(lambda: hc.deserialize_outputs(
            ev, ctx, r["blob_v"])),
        "conv_decrypt_many": ms(lambda: s.dec.decrypt_many(r["conv_flat"])),
        "conv_decrypt_decode": ms(lambda: hc.decrypt_outputs(
            s.dp, s.dec, r["back_v"])),
    }
    log("[21] medians over %d runs (CUDA events), ms: " % APP_REPS
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return times


def phase_app(bfv_ctx, bgv_ctx, ckks_ctx, counter) -> tuple:
    """Phases 21-22: troy's app protocol at full width, its checks in a
    count window of their own (phase 22), then the medians (phase 21) and
    the profile (phase 22)."""
    schemes = {}
    for i, (name, ctx) in enumerate((("bfv", bfv_ctx), ("bgv", bgv_ctx),
                                     ("ckks", ckks_ctx))):
        schemes[name] = AppScheme(name, ctx, APP_SEED + 10 * i)
        log(f"[21] {name}: relin key and 4 automorphism keys made on the "
            f"card in {schemes[name].keygen_s:.2f} s (kernel Q)")
    counter.calls.clear()
    _kernels.reset_launch_counts()
    with DECRYPTS.window("app"):
        r = app_requests(schemes["bfv"], schemes["bgv"], schemes["ckks"])
        torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    check_path("22", "21 (the app protocol)", APP_PATH, counts, counter)
    s, g = schemes["bfv"], schemes["bgv"]
    # the pair grid's route: BFV's in A's first inverse pass (AP2i), one
    # call an inner tile and P2 never; BGV's on P2's own kernel
    for name, fn, fused in (
            ("BFV", lambda: r["h"].matmul_cipher(s.ev, r["x_ct"], r["w_ct"]),
             True),
            ("BGV", lambda: r["hg"].matmul_cipher(g.ev, r["xg_c"],
                                                  r["wg_c"]), False)):
        _kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        c = _kernels.launch_counts()
        got = (c["AP2i_pair_intt"], c["P2_pair_convolve"])
        if (got[0] > 0, got[1] > 0) != (fused, not fused):
            raise AssertionError(f"{name} matmul_cipher launched AP2i and P2 "
                                 f"{got} times")
        log(f"[22] {name} matmul_cipher: AP2i {got[0]}, P2 {got[1]} "
            "launches a call")
    times = app_timings(s, r)
    c = schemes["ckks"]
    coeffs = c.rng.uniform(-1, 1, N)
    plain = c.ep(coeffs)
    encode_poly = lambda: c.ep(coeffs)
    decode_poly = lambda: c.dp(plain)
    times["ckks_encode_polynomial"] = cuda_ms(encode_poly)
    times["ckks_decode_polynomial"] = cuda_ms(decode_poly)
    log(f"[21] CKKS encode_polynomial {times['ckks_encode_polynomial']:.4f}"
        f" ms, decode_polynomial {times['ckks_decode_polynomial']:.4f} ms "
        f"(medians of {TIMING_REPS}, CUDA events)")
    h, hc, ev, ctx = r["h"], r["hc"], s.ev, s.ctx
    per_op = profile_ops("22", {
        "app_encode_weights": lambda: h.encode_weights(s.ep, r["w"]),
        "app_encode_encrypt_inputs": lambda: h.encrypt_inputs(s.enc, s.ep,
                                                              r["x"]),
        "app_matmul": lambda: h.matmul(ev, r["x_ct"], r["w_pt"]),
        "app_matmul_cipher": lambda: h.matmul_cipher(ev, r["x_ct"],
                                                     r["w_ct"]),
        "app_bgv_matmul_cipher": lambda: r["hg"].matmul_cipher(
            g.ev, r["xg_c"], r["wg_c"]),
        "app_pack_outputs": lambda: h.pack_outputs(ev, s.gk, r["y"]),
        "app_conv2d": lambda: hc.conv2d(ev, r["xv_ct"], r["wv_pt"]),
        "app_decrypt_many_conv52": lambda: s.dec.decrypt_many(
            r["conv_flat"]),
        "app_serialize": lambda: h.serialize_outputs(ev, ctx, r["packed"]),
        "app_deserialize": lambda: h.deserialize_outputs(ev, ctx, r["blob"]),
        "app_decrypt_decode": lambda: h.decrypt_outputs(s.dp, s.dec,
                                                        r["back"]),
        "app_conv_encode_weights": lambda: hc.encode_weights(s.ep, r["wv"]),
        "app_conv_decrypt_decode": lambda: hc.decrypt_outputs(
            s.dp, s.dec, r["back_v"]),
        "app_fetch_to_coeff_conv52": lambda: serialization.
            fetch_ciphertexts_host(r["conv_flat"], ctx, to_coeff=True),
        "ckks_encode_polynomial": encode_poly,
        "ckks_decode_polynomial": decode_poly,
    })
    return counts, times, per_op, {"bytes": r["bytes"],
                                   "ckks_max_error": r["ckks_max_error"]}


# ---------------------------------------------------------------------------
# large rings: kernel J, SEAL's n = 32768 chain and troy's n ceiling (23-28)
# ---------------------------------------------------------------------------

def _moduli(n: int, spec) -> list:
    coeff = P.CoeffModulus.bfv_default(n) if spec == "bfv_default" \
        else P.CoeffModulus.create(n, spec)
    return [int(m) for m in coeff]


def int_mm_products(t, x: torch.Tensor):
    """The library yardstick of J: the plane products of one forward
    transform alone, as ``torch._int_mm`` on the same stacked int8 planes
    (stage 1 W1 (D A, A) x X (A, D rows B), stage 2 Y (D rows A, B) x W2
    (B, D B)); the regroup, folds and twiddles are left out. The port never
    calls it."""
    rows = x.shape[0]
    calls = []
    for i, m in enumerate(t.mxu):
        d = m.planes
        xd = ntt_mxu._digits(x[:, i].reshape(rows, m.a, m.b), d)
        xs = xd.permute(2, 0, 1, 3).reshape(m.a, d * rows * m.b) \
            .to(torch.int8).contiguous()
        ys = xd.reshape(d * rows * m.a, m.b).to(torch.int8).contiguous()
        w1 = m.w1_digits.reshape(d * m.a, m.a).contiguous()
        w2 = m.w2_digits.permute(1, 0, 2).reshape(m.b, d * m.b).contiguous()
        calls.append((w1, xs, ys, w2))

    def run():
        for w1, xs, ys, w2 in calls:
            torch._int_mm(w1, xs)
            torch._int_mm(ys, w2)
    return run


def phase_mxu_kernels(dev) -> dict:
    """Phase 23: J against its plain version (forward and inverse) and
    against A, at every MXU_SHAPES shape and with an X-plane bound; the
    times, the bound, the library yardstick and A's time."""
    rng = np.random.default_rng(SEED + 23)
    shapes = {}
    worst = 0
    for tag, n, spec in MXU_SHAPES:
        moduli = _moduli(n, spec)
        tj = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=True)
        x = _full(rng, (2, len(moduli), n), dev)
        checks = [("forward", lambda: ntt.rns_ntt_forward(x, tj),
                   lambda: ntt_mxu.rns_ntt_mxu_plain(x, tj.mxu, False)),
                  ("inverse", lambda: ntt.rns_ntt_inverse(x, tj),
                   lambda: ntt_mxu.rns_ntt_mxu_plain(x, tj.mxu, True))]
        # A takes words below 4q (forward) and 2q (inverse)
        ta = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=False)
        xr = _uniform(rng, moduli, (2, len(moduli), n), dev)
        checks += [("forward = A", lambda: ntt.rns_ntt_forward(xr, tj),
                    lambda: ntt.rns_ntt_forward(xr, ta)),
                   ("inverse = A", lambda: ntt.rns_ntt_inverse(xr, tj),
                    lambda: ntt.rns_ntt_inverse(xr, ta))]
        xb = x & ((1 << MXU_X_BITS) - 1)
        if tag == "n16384":
            checks.append((f"forward, words < 2^{MXU_X_BITS}",
                           lambda: ntt.rns_ntt_forward(
                               xb, tj, x_bound_bits=MXU_X_BITS),
                           lambda: ntt_mxu.rns_ntt_mxu_plain(
                               xb, tj.mxu, False, (MXU_X_BITS + 7) // 8)))
        for variant, run, plain in checks:
            got, want = run(), plain()
            torch.cuda.synchronize()
            try:
                worst = max(worst, compare("words", got, want))
            except AssertionError as exc:
                raise AssertionError(f"J_ntt_mxu {tag} {variant}: "
                                     f"{exc}") from None
        ms = cuda_ms(lambda: ntt.rns_ntt_forward(x, tj))
        inv_ms = cuda_ms(lambda: ntt.rns_ntt_inverse(x, tj))
        plain_ms = cuda_ms(lambda: ntt_mxu.rns_ntt_mxu_plain(x, tj.mxu,
                                                             False), reps=5)
        library_ms = cuda_ms(int_mm_products(tj, x))
        a_ms = cuda_ms(lambda: ntt.rns_ntt_forward(xr, ta))
        a_device_ms = device_kernels_per_op(
            lambda: ntt.rns_ntt_forward(xr, ta))[1]
        _, device_ms, each = device_kernels_per_op(
            lambda: ntt.rns_ntt_forward(x, tj),
            expect={"ntt_mxu_kernel": None})
        launches, us = each["ntt_mxu_kernel"]
        nbytes, mul64 = j_work(tj, 2)
        bound_ms, bound_by = bound(nbytes, mul64)
        r = {"n": n, "limbs": len(moduli), "rows": 2, "ms": ms,
             "inverse_ms": inv_ms, "device_ms": device_ms,
             "device_us_per_launch": us, "launches_per_transform": launches,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "mul64": mul64, "bytes": nbytes, "plain_ms": plain_ms,
             "library_ms": library_ms, "a_ms": a_ms,
             "a_device_ms": a_device_ms}
        if tag == "n16384":
            r["bounded_ms"] = cuda_ms(lambda: ntt.rns_ntt_forward(
                xb, tj, x_bound_bits=MXU_X_BITS))
        shapes[tag] = r
        log(f"[23] J_ntt_mxu {tag} ({len(moduli)} limbs, 2 rows): word-equal"
            f" to A and to the plain version; forward "
            f"{ms:.4f} ms (device {device_ms:.4f} ms, {launches:g} launches "
            f"at {us:.1f} us), inverse {inv_ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
            f"torch._int_mm {library_ms:.4f} ms, A {a_ms:.4f} ms (device "
            f"{a_device_ms:.4f} ms)")
    head = shapes["n16384"]
    return {"J_ntt_mxu": {"max_abs_err": worst, "ms": head["ms"],
                          "plain_ms": head["plain_ms"],
                          "bound_ms": head["bound_ms"],
                          "bound_by": head["bound_by"],
                          "library_ms": head["library_ms"]}}, shapes


def phase_mxu_headline(parts: dict, counter) -> dict:
    """Phase 24: troy's timetest BFV mult+relin and CKKS
    mult+relin+rescale at n = 16384 on J (use_mxu=True), word-equal to the
    A route on the same ciphertexts and keys; both routes timed; a BFV
    multiply_plain by a mod-t plaintext, whose lift runs on G' there (AGp
    on A's route), and a CKKS encode and encode_polynomial, whose rounding
    runs on O2 there (AO2p on A's route), and an encode_with_stats, whose
    rounding and statistic run on O4 there (AO4p on A's route), word-equal
    too, the statistic bit-equal. The J route runs in a count window of its
    own: J launched, A not, no plain torch on the card."""
    out, results, routes = {}, {}, {}
    rng = np.random.default_rng(SEED + 24)
    values = rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2)
    coeffs = rng.uniform(-1, 1, N)
    for scheme, (ctx, ca, cb, rlk) in parts.items():
        ctx_j = P.HeContext(ctx.key_context_data.parms, use_mxu=True)
        ops, plain_ops = {}, {}
        if scheme == "bfv":
            be = P.BatchEncoder(ctx)
            pt = be.encode(np.arange(N, dtype=np.uint64) % be.plain_modulus)
        for route, c in (("a", ctx), ("j", ctx_j)):
            ev = P.Evaluator(c)
            if scheme == "ckks":
                ops[route] = lambda ev=ev: ev.rescale_to_next(
                    ev.relinearize(ev.multiply(ca, cb), rlk))
                ce = P.CKKSEncoder(c)
                plain_ops[route] = lambda ce=ce: (
                    ce.encode(values, CKKS_SCALE),
                    ce.encode_polynomial(coeffs, CKKS_SCALE),
                    *ce.encode_with_stats(values, CKKS_SCALE))
            else:
                ops[route] = lambda ev=ev: ev.relinearize(
                    ev.multiply(ca, cb), rlk)
                plain_ops[route] = lambda ev=ev: ev.multiply_plain(ca, pt)
        want = ops["a"]()
        want_plain = {r: fn() for r, fn in plain_ops.items() if r == "a"}
        torch.cuda.synchronize()
        counter.calls.clear()
        _kernels.reset_launch_counts()
        got = ops["j"]()
        got_plain = plain_ops["j"]() if plain_ops else None
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        if plain_ops:
            pairs = zip(*(r if isinstance(r, tuple) else (r,)
                          for r in (got_plain, want_plain["a"])))
            what = "encodes" if scheme == "ckks" else "multiply_plain"
            if not all(_same_result(g, w) for g, w in pairs):
                raise AssertionError(f"{scheme} {what}: J route differs "
                                     "from A route")
        # CKKS divides on K''s own kernels there and rounds its encodes on
        # O2's (with the statistic on O4's), BFV divides on F's and lifts
        # its plaintext on G''s
        path = ("J_ntt_mxu",) + (("Kp_rescale_ntt", "Kp_keyswitch_ntt",
                                  "O2_ckks_round", "O4_ckks_encode_stats")
                                 if scheme == "ckks"
                                 else ("F_keyswitch", "Gp_plain_lift"))
        check_path("24", f"24 ({scheme}, J route)", path, counts, counter,
                   absent=())
        on_a = {k: counts[k] for k in ("A_ntt", "AKp_rescale_ntt",
                                       "AKp_keyswitch_ntt",
                                       "AFi_keyswitch_intt", "AGp_ntt_lift",
                                       "AO2p_ntt_round",
                                       "AO4p_ntt_round_stats")
                if counts[k]}
        if on_a:
            raise AssertionError(f"A ran on the J route: {on_a}")
        results[scheme] = counts
        if not torch.equal(got.data, want.data) or got.level != want.level:
            raise AssertionError(f"{scheme}: J route differs from A route")
        tag = "mult_relin_rescale" if scheme == "ckks" else "mult_relin"
        a_ms, j_ms = cuda_ms(ops["a"]), cuda_ms(ops["j"])
        j_ms2, a_ms2 = cuda_ms(ops["j"]), cuda_ms(ops["a"])
        _, a_dev, _ = device_kernels_per_op(ops["a"])
        _, j_dev, each = device_kernels_per_op(ops["j"])
        out[f"{scheme}_{tag}"] = {"a_ms": [a_ms, a_ms2],
                                  "j_ms": [j_ms, j_ms2],
                                  "a_device_ms": a_dev,
                                  "j_device_ms": j_dev, "j_each": each}
        log(f"[24] {scheme} {tag} n = {N}: J route word-equal to the A "
            f"route; A {a_ms:.4f}/{a_ms2:.4f} ms (device {a_dev:.4f}), J "
            f"{j_ms:.4f}/{j_ms2:.4f} ms (device {j_dev:.4f}); J launches "
            f"{counts['J_ntt_mxu']}")
    total = {k: sum(c.get(k, 0) for c in results.values())
             for k in _kernels.launch_counts()}
    return out, total


def _same_result(got, want) -> bool:
    """Two routes' results equal: a plaintext's words, or an encode's
    statistic (EncodeStats) bit for bit."""
    if hasattr(got, "max_abs_small"):
        return bool(got.max_abs_small.view(torch.int64)
                    == want.max_abs_small.view(torch.int64))
    return torch.equal(got.data, want.data)


def _op_times(ops: dict, reps: int) -> dict:
    return {op: cuda_ms(fn, reps=reps, warmup=1) for op, fn in ops.items()}


def phase_seal32768(counter, n: int = 32768) -> tuple:
    """Phase 25: SEAL's 128-bit n = 32768 BFV chain at full width
    (bfv_default(32768), 16 primes, 881 bits; t = batching(32768, 20)),
    every NTT on A: host keygen through the native runtime, encode,
    encrypt and encrypt_symmetric (the default device path), multiply,
    relinearize, rotate_rows(1), rotate_columns, mod_switch_to_next,
    decrypt with the noise budget and decode, exact to the numpy oracle mod
    t; in a count window of its own."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx = P.HeContext(P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.bfv_default(n)),
        plain_modulus=P.PlainModulus.batching(n, 20)))
    ctx_s = time.perf_counter() - t0
    key = ctx.key_context_data
    limbs, bits = key.limbs, key.total_coeff_modulus.bit_length()
    keygen = {}
    t0 = time.perf_counter()
    kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(SEAL_SEED))
    keygen["secret"] = time.perf_counter() - t0
    for name, make in (("public", kg.create_public_key),
                       ("relin", kg.create_relin_keys),
                       ("galois_row1", lambda: kg.create_galois_keys(
                           steps=[1])),
                       ("galois_columns", lambda: kg.create_galois_keys(
                           steps=[0]))):
        t0 = time.perf_counter()
        keygen[name] = make()
        torch.cuda.synchronize()
        keygen[name + "_s"] = time.perf_counter() - t0
    pk, rlk = keygen.pop("public"), keygen.pop("relin")
    gk = P.GaloisKeys(keys={**keygen.pop("galois_row1").keys,
                            **keygen.pop("galois_columns").keys})
    log(f"[25] SEAL n = {n}, {limbs} primes, {bits} bits: context "
        f"{ctx_s:.2f} s; "
        f"native host keygen (s): " + ", ".join(
            f"{k} {v:.2f}" for k, v in keygen.items()))
    be = P.BatchEncoder(ctx)
    t = be.plain_modulus
    enc = P.Encryptor(ctx, pk, kg.secret_key, rnd.seed_from_uint64(
        SEAL_SEED + 1))
    dec = P.Decryptor(ctx, kg.secret_key)
    ev = P.Evaluator(ctx)
    rng = np.random.default_rng(SEAL_SEED)
    a = rng.integers(0, t, n, dtype=np.uint64)
    b = rng.integers(0, t, n, dtype=np.uint64)
    counter.calls.clear()
    _kernels.reset_launch_counts()
    pa, pb = be.encode(a), be.encode(b)
    ca, cb = enc.encrypt(pa), enc.encrypt_symmetric(pb)
    prod = ev.multiply(ca, cb)
    rel = ev.relinearize(prod, rlk)
    rot = ev.rotate_rows(rel, 1, gk)
    col = ev.rotate_columns(rel, gk)
    ms = ev.mod_switch_to_next(rel)
    ab = (a.astype(object) * b % t).astype(np.uint64)
    rows = ab.reshape(2, n // 2)
    want = {"ca": a, "cb": b, "rel": ab,
            "rot": np.roll(rows, -1, axis=1).reshape(-1),
            "col": rows[::-1].reshape(-1), "ms": ab}
    budgets = {}
    for tag, ct in (("ca", ca), ("cb", cb), ("rel", rel), ("rot", rot),
                    ("col", col), ("ms", ms)):
        if not np.array_equal(be.decode(dec.decrypt(ct)), want[tag]):
            raise AssertionError(f"SEAL n = {n}: {tag} does not decrypt to "
                                 "the oracle mod t")
        budgets[tag] = dec.invariant_noise_budget(ct)
        if budgets[tag] <= 0:
            raise AssertionError(f"SEAL n = {n}: {tag} has no noise budget")
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    check_path("25", "25", LARGE_BFV_PATH, counts, counter)
    log(f"[25] every result decrypts exactly to the oracle mod t; noise "
        f"budgets (bits) {budgets}")
    ops = {"encode": lambda: be.encode(a), "encrypt": lambda: enc.encrypt(pa),
           "encrypt_symmetric": lambda: enc.encrypt_symmetric(pa),
           "multiply": lambda: ev.multiply(ca, cb),
           "relinearize": lambda: ev.relinearize(prod, rlk),
           "mult_relin": lambda: ev.relinearize(ev.multiply(ca, cb), rlk),
           "rotate_rows": lambda: ev.rotate_rows(rel, 1, gk),
           "rotate_columns": lambda: ev.rotate_columns(rel, gk),
           "mod_switch": lambda: ev.mod_switch_to_next(rel),
           "decrypt": lambda: dec.decrypt(rel),
           "decode": lambda: be.decode(pa)}
    times = _op_times(ops, LARGE_REPS)
    peak = torch.cuda.max_memory_allocated()
    log(f"[25] medians over {LARGE_REPS} runs (CUDA events, ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f"; max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    return counts, {"limbs": limbs, "bits": bits, "context_s": ctx_s,
                    "keygen_s": keygen, "ms": times,
                    "noise_budget_bits": budgets,
                    "max_memory_allocated": peak}, ops


def phase_ckks32768(counter, n: int = 32768) -> tuple:
    """Phase 26: deep CKKS at n = 32768, q = {60, 40 x 14, 60}, scale
    2^40, on A: encode, encrypt (public key) and encrypt_symmetric,
    multiply, relinearize, rescale_to_next, rotate_vector(1); the rescaled
    product decodes within CKKS_LARGE_BOUND of the numpy product, its
    rotation within CKKS_ROTATION_BOUND of the rotated product; in a count
    window of its own."""
    torch.cuda.reset_peak_memory_stats()
    ctx = P.HeContext(P.EncryptionParameters(
        scheme=P.SchemeType.ckks, poly_modulus_degree=n,
        coeff_modulus=tuple(P.CoeffModulus.create(n, CKKS_LARGE_BITS))))
    keygen = {}
    t0 = time.perf_counter()
    kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(SEAL_SEED + 2))
    pk = kg.create_public_key()
    keygen["secret_public"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rlk = kg.create_relin_keys()
    keygen["relin"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gk = kg.create_galois_keys(steps=[1])
    keygen["galois"] = time.perf_counter() - t0
    log(f"[26] CKKS n = {n}, {len(CKKS_LARGE_BITS)} primes: native host "
        f"keygen (s) "
        + ", ".join(f"{k} {v:.2f}" for k, v in keygen.items()))
    ce = P.CKKSEncoder(ctx)
    enc = P.Encryptor(ctx, pk, kg.secret_key, rnd.seed_from_uint64(
        SEAL_SEED + 3))
    dec = P.Decryptor(ctx, kg.secret_key)
    ev = P.Evaluator(ctx)
    rng = np.random.default_rng(SEAL_SEED + 2)
    a, b = (rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
            for _ in range(2))
    counter.calls.clear()
    _kernels.reset_launch_counts()
    pa, pb = ce.encode(a, CKKS_SCALE), ce.encode(b, CKKS_SCALE)
    ca, cb = enc.encrypt(pa), enc.encrypt_symmetric(pb)
    rel = ev.relinearize(ev.multiply(ca, cb), rlk)
    rs = ev.rescale_to_next(rel)
    rot = ev.rotate_vector(rs, 1, gk)
    err = np.abs(ce.decode(dec.decrypt(rs)) - a * b).max()
    rot_err = np.abs(ce.decode(dec.decrypt(rot)) - np.roll(a * b, -1)).max()
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    check_path("26", "26", LARGE_CKKS_PATH, counts, counter)
    if not (err < CKKS_LARGE_BOUND and rot_err < CKKS_ROTATION_BOUND):
        raise AssertionError(f"CKKS n = {n}: max error {err} (bound "
                             f"{CKKS_LARGE_BOUND}), rotated {rot_err} "
                             f"(bound {CKKS_ROTATION_BOUND})")
    log(f"[26] the rescaled product decodes within {err:.3e} of the numpy "
        f"product (bound {CKKS_LARGE_BOUND}), its rotate_vector(1) within "
        f"{rot_err:.3e} (bound {CKKS_ROTATION_BOUND})")
    ops = {"encode": lambda: ce.encode(a, CKKS_SCALE),
           "encrypt": lambda: enc.encrypt(pa),
           "encrypt_symmetric": lambda: enc.encrypt_symmetric(pa),
           "mult_relin": lambda: ev.relinearize(ev.multiply(ca, cb), rlk),
           "rescale": lambda: ev.rescale_to_next(rel),
           "rotate_vector": lambda: ev.rotate_vector(rs, 1, gk),
           "decrypt": lambda: dec.decrypt(rs)}
    times = _op_times(ops, LARGE_REPS)
    peak = torch.cuda.max_memory_allocated()
    log(f"[26] medians over {LARGE_REPS} runs (CUDA events, ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f"; max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    return counts, {"keygen_s": keygen, "ms": times, "max_error": err,
                    "rotation_max_error": rot_err,
                    "max_memory_allocated": peak}, ops


def phase_ceiling(counter) -> tuple:
    """Phase 27: troy's ceiling (n = 131072) and the JAX package's
    single-chip ring (n = 262144), q = {55,55,60}, t = batching(n, 30)
    (benchmarks/nceiling_tpu.py:31-32): BFV encrypt, multiply,
    relinearize, decrypt, exact to the product mod t; in a count window of
    its own."""
    counts_all, out, ops_all = {}, {}, {}
    counter.calls.clear()
    _kernels.reset_launch_counts()
    for n in CEILING_NS:
        torch.cuda.reset_peak_memory_stats()
        ctx = P.HeContext(P.EncryptionParameters(
            scheme=P.SchemeType.bfv, poly_modulus_degree=n,
            coeff_modulus=tuple(P.CoeffModulus.create(n, CEILING_Q_BITS)),
            plain_modulus=P.PlainModulus.batching(n, CEILING_T_BITS)),
            sec_level=P.SecurityLevel.none)
        t0 = time.perf_counter()
        kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(n))
        rlk = kg.create_relin_keys()
        keygen_s = time.perf_counter() - t0
        be = P.BatchEncoder(ctx)
        t = be.plain_modulus
        enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                          seed=rnd.seed_from_uint64(n + 1))
        dec = P.Decryptor(ctx, kg.secret_key)
        ev = P.Evaluator(ctx)
        rng = np.random.default_rng(n)
        a = rng.integers(0, t, n, dtype=np.uint64)
        b = rng.integers(0, t, n, dtype=np.uint64)
        ca = enc.encrypt_symmetric(be.encode(a))
        cb = enc.encrypt_symmetric(be.encode(b))
        rel = ev.relinearize(ev.multiply(ca, cb), rlk)
        got = be.decode(dec.decrypt(rel))
        if not np.array_equal(got, (a.astype(object) * b % t)
                              .astype(np.uint64)):
            raise AssertionError(f"n = {n}: mult+relin does not decrypt to "
                                 "the product mod t")
        budget = dec.invariant_noise_budget(rel)
        ops = {f"n{n}_mult_relin": lambda ev=ev, ca=ca, cb=cb, rlk=rlk:
               ev.relinearize(ev.multiply(ca, cb), rlk),
               f"n{n}_encrypt": lambda enc=enc, p=be.encode(a):
               enc.encrypt_symmetric(p),
               f"n{n}_decrypt": lambda dec=dec, rel=rel: dec.decrypt(rel)}
        times = _op_times(ops, LARGE_REPS)
        ops_all.update(ops)
        out[f"n{n}"] = {"keygen_s": keygen_s, "ms": times,
                        "noise_budget_bits": budget,
                        "max_memory_allocated":
                            torch.cuda.max_memory_allocated()}
        log(f"[27] n = {n}, q = {CEILING_Q_BITS}, t = {t}: mult+relin "
            f"decrypts exactly to the product mod t (budget {budget} bits); "
            f"host keygen (sk + relin) {keygen_s:.2f} s; medians (ms) "
            + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
            + f"; max_memory_allocated "
            f"{out[f'n{n}']['max_memory_allocated'] / 2 ** 30:.2f} GiB")
    torch.cuda.synchronize()
    counts_all = _kernels.launch_counts()
    check_path("27", "27", CEILING_PATH, counts_all, counter, absent=())
    return counts_all, out, ops_all


def phase_large_profiles(ops: dict, counter) -> dict:
    """Phase 28: the device kernels and time of phases 25-27's ops from the
    profiler, A's and J's shares of each op's device time, and no plain
    torch on the card while they ran."""
    counter.calls.clear()
    per_op = profile_ops("28", ops)
    for op, r in per_op.items():
        for name, kernel in (("a", "ntt_pass_kernel"),
                             ("j", "ntt_mxu_kernel")):
            c, us = r["each"].get(kernel, (0, 0.0))
            r[f"{name}_share"] = c * us / 1e3 / r["device_ms"] \
                if r["device_ms"] else 0
        log(f"[28] {op}: A {r['a_share']:.1%}, J {r['j_share']:.1%} of the "
            "device time")
    if counter.calls:
        raise AssertionError(f"plain torch ran on the card in phase 28: "
                             f"{counter.calls}")
    log(f"[28] plain-version and u64ops calls on CUDA tensors in the "
        f"profiled ops: 0")
    return per_op


def _short(key: str) -> str:
    """A device kernel's function name without its namespace, template
    and arguments; a copy keeps the profiler's name."""
    found = re.search(r"::(\w+)[<(]", key)
    return found.group(1) if found else key[:40]


# Each edge of a trace's window gets idle seconds and spin kernels: the
# profiler drops device events that it places at the edges of its window
# (a whole call, late in a long run), so the first and last traced calls
# keep clear of them, and what an edge loses is a spin kernel, which is
# not counted. A trace taken again waits longer at its end (TRACE_PAD_S
# times TRACE_PAD_GROWTH per attempt, at most TRACE_PAD_MAX_S): a late
# run has lost its last call and trailing spins in every one of 6 traces
# that waited 0.02 s.
TRACE_PAD_S = 0.02
TRACE_PAD_GROWTH = 5
TRACE_PAD_MAX_S = 2.5
TRACE_EDGE_SPINS = 4
TRACE_SPIN = "spin_kernel"
TRACE_ATTEMPTS = 6


def _trace_edge(pad_s: float = TRACE_PAD_S) -> None:
    time.sleep(pad_s)
    for _ in range(TRACE_EDGE_SPINS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(pad_s)


def _trace(fn, reps: int, warmup: int, end_pad_s: float = TRACE_PAD_S
           ) -> tuple:
    """({kernel: [launches, device us]} of reps calls of fn in one
    torch.profiler trace, the edges' spin kernels seen). The profiler's
    schedule traces ``warmup`` calls first and drops them: a trace started
    cold loses the events of its first call. ``end_pad_s``: the idle
    seconds on each side of the trailing spins."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=reps,
                                   repeat=1)) as prof:
        for i in range(warmup + reps):
            if i == warmup:
                _trace_edge()
            fn()
            torch.cuda.synchronize()
            if i == warmup + reps - 1:
                _trace_edge(end_pad_s)
            prof.step()
    device_us = lambda e: getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0))
    each, spins = {}, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or not e.count:
            continue
        if TRACE_SPIN in e.key:
            spins += e.count
            continue
        launches, total = each.get(_short(e.key), (0, 0.0))
        each[_short(e.key)] = [launches + e.count, total + device_us(e)]
    return each, spins


def _trace_faults(each: dict, reps: int, expect: dict, whole: bool) -> list:
    """What makes a trace of reps calls not whole: no device event; a
    kernel of ``expect`` not seen its launches a call (None: some whole
    number of launches a call); with ``whole``, any kernel seen a number of
    times that is no multiple of reps (every call launches the same)."""
    if not each:
        return ["no device event"]
    faults = []
    for name, per_call in expect.items():
        seen = each.get(name, [0, 0.0])[0]
        if seen == 0 or seen % reps or (per_call is not None
                                        and seen != per_call * reps):
            faults.append(f"{name} seen {seen} times in {reps} calls, "
                          f"expected {per_call or 'a multiple'}")
    if whole:
        faults += [f"{name} seen {c} times in {reps} calls"
                   for name, (c, _) in each.items() if c % reps]
    return faults


def device_kernels_per_op(fn, reps: int = 5, warmup: int = 3,
                          expect: Optional[dict] = None,
                          whole: bool = False) -> tuple:
    """(device kernels and copies, device ms, {kernel: [launches, us per
    launch]}) per call of fn, from a torch.profiler trace of reps calls.
    A trace that is not whole (``_trace_faults``: ``expect`` maps kernels
    to their launches a call) is taken again, TRACE_ATTEMPTS times at
    most; then the op fails: no time is read off a trace that lost it."""
    expect = expect or {}
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        each, spins = _trace(fn, reps, warmup, min(
            TRACE_PAD_S * TRACE_PAD_GROWTH ** (attempt - 1),
            TRACE_PAD_MAX_S))
        faults = _trace_faults(each, reps, expect, whole)
        if not faults:
            break
        log(f"[trace] attempt {attempt} of {TRACE_ATTEMPTS} not whole: "
            + "; ".join(faults) + f" ({spins} of {2 * TRACE_EDGE_SPINS} "
            "edge spin kernels seen)")
    else:
        raise AssertionError(f"the profiler lost events in "
                             f"{TRACE_ATTEMPTS} traces: {'; '.join(faults)}")
    count = sum(c for c, _ in each.values()) / reps
    us = sum(t for _, t in each.values()) / reps
    return count, us / 1e3, {k: [c / reps, t / c]
                             for k, (c, t) in each.items()}


def check_path(tag: str, phases: str, path, counts: dict,
               counter: "PlainCallCounter", absent=A_ROUTE_ABSENT) -> None:
    """Every kernel of the path launched, no entry point of ``absent``
    launched since the counts' reset (read now: call right after the
    window), and no plain torch on the card."""
    log(f"[{tag}] kernel launches in phases {phases}: {counts}")
    missing = [k for k in path if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path in "
                             f"phases {phases}: {missing}")
    entries = _kernels.entry_launch_counts()
    there = {e: entries[e] for e in absent if entries[e]}
    if there:
        raise AssertionError(f"entry points launched in phases {phases} "
                             f"that its route must not launch: {there}")
    log(f"[{tag}] plain-version and u64ops calls on CUDA tensors in phases "
        f"{phases} ({counter.wrapped} functions watched): "
        f"{counter.calls or 0}")
    if counter.calls:
        raise AssertionError(f"plain torch ran on the card's main path: "
                             f"{counter.calls}")


B_ENTRIES = ("troy_dyadic_mac", "troy_dyadic_convolve")


def b_launch_words(entry: str, args: tuple) -> int:
    """The words one kernel-B launch must move, from its arguments: each
    term's rows of a read once, of b once for every component (where b
    has a group pitch, for every group), the addend, the output; the
    convolution's operands (b none for a square) and output. B reads
    operands in place, so a tensor argument may hold more than that (a
    key's level slice)."""
    if entry == "troy_dyadic_convolve":
        square, batch, s1, s2, rows, log_n = args[3:9]
        return (batch * rows << log_n) * (s1 + (0 if square else s2)
                                          + s1 + s2 - 1)
    add, terms, comps, groups, rows, log_n = args[3:9]
    b_groups = groups if args[13] else 1
    words = (terms * groups + terms * comps * b_groups
             + comps * groups * (2 if add is not None else 1))
    return (words * rows) << log_n


def launch_work(entry: str, args: tuple) -> tuple:
    """bound() arguments of one launch, from its arguments: every tensor
    argument's bytes once (B's words as ``b_launch_words`` counts them;
    D's, DG's and G's c1, read and written beside out, twice), and I's
    threefry blocks (THREEFRY_OPS 32-bit operations each), its lifts (4 a
    word), its Barrett-128 (5 products a uniform word) and BGV's
    Shoup product (2 a noise word). Every other kernel of RANKED is bound
    by its bytes at its checked shapes (phases 3-20), so its operations
    are not counted."""
    if entry in B_ENTRIES:
        return b_launch_words(entry, args) * 8, 0
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    if entry == "troy_rns_elementwise" and len(args) > 11 and isinstance(
            args[7], torch.Tensor):
        nbytes += args[7].numel() * 8
    copied = {"troy_rns_zero_embed": 6, "troy_bfv_plain_embed": 5}.get(entry)
    if copied is not None and isinstance(args[copied], torch.Tensor):
        nbytes += args[copied].numel() * 8
    if not entry.startswith("troy_sample_"):
        return nbytes, 0
    uniform = small = scaled = 0            # words of each kind
    blocks = 0                              # threefry blocks of small draws
    if entry == "troy_sample_zero_asym":
        rows, k, log_n = args[2:5]
        small, blocks = rows * k << log_n, rows << log_n
        scaled = (rows - 1) * k << log_n if args[6] is not None else 0
    elif entry == "troy_sample_zero_sym":
        batch, k, log_n = args[6:9]
        uniform = small = batch * k << log_n
        blocks = batch << log_n
        scaled = small if args[12] is not None else 0
    else:
        batch, k, log_n = args[3:6]
        words = batch * k << log_n
        if entry == "troy_sample_uniform_rns":
            uniform = words
        else:
            small, blocks = words, batch << log_n
            scaled = words if entry == "troy_sample_cbd_rns" and \
                args[7] is not None else 0
    return (nbytes, uniform * 5 + scaled * 2, 0,
            (2 * uniform + blocks) * THREEFRY_OPS + small * 4)


def launch_bounds(fn) -> dict:
    """{kernel: [launches, the sum of their bounds in us]} of one call of
    fn: each launch's bound from its own arguments (``launch_work``)."""
    seen = {}
    launch = _kernels.launch

    def record(entry, device, *args):
        launch(entry, device, *args)
        ms, _ = bound(*launch_work(entry, args))
        entry_seen = seen.setdefault(_kernels.KERNELS[entry], [0, 0.0])
        entry_seen[0] += 1
        entry_seen[1] += ms * 1e3

    _kernels.launch = record
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        _kernels.launch = launch
    return seen


def profile_ops(tag: str, ops: dict, expect: Optional[dict] = None) -> dict:
    """The per-op device kernels and time; ``expect``: {op: the kernels its
    trace must hold whole (device_kernels_per_op)}, and every op's trace
    holds some device event; and the bounds of one call's launches
    (``launch_bounds``)."""
    per_op = {}
    for op, fn in ops.items():
        want = (expect or {}).get(op)
        count, device_ms, each = device_kernels_per_op(
            fn, expect=want, whole=want is not None)
        per_op[op] = {"device_kernels": count, "device_ms": device_ms,
                      "each": each, "bounds": launch_bounds(fn)}
        log(f"[{tag}] {op}: {count:g} device kernels and copies per op, "
            f"{device_ms:.4f} ms of device time (torch.profiler): "
            + "; ".join(f"{k} x{c:g} at {us:.1f} us"
                        for k, (c, us) in each.items()))
    return per_op


def ntt_rows_mul64(rows: int, n: int = N) -> int:
    """64-bit products of kernel A over ``rows`` rows of n (the phase-3
    count: 3 per butterfly and 3 per word)."""
    return rows * ((n // 2) * (n.bit_length() - 1) * 3 + n * 3)


def composite_bounds(k: int) -> dict:
    """The least times of the composite ops, from their own data: M' (the
    NTT-form rotation of a (2, k, n) ciphertext: both components in and
    out, the Galois key's used rows, k x 2 x (k + 1), read once; A over
    k + k (k + 1) + 2 + 2 k rows, B's 2 (k + 1) rows of k-term sums, M, K'),
    L (multiply_plain of a (2, k, n) ciphertext by a mod-t plaintext:
    the ciphertext and the plaintext in, the product out; G', A over k
    rows, B over 2 k rows; BFV's adds A over 4 k rows) and Q (a device
    switching key of k rows over k + 1 limbs); and M' hoisted over 8
    elements, NTT form."""
    ct = 2 * k * N * 8
    key_rows = k * 2 * (k + 1) * N * 8
    rot_mul = (ntt_rows_mul64(k + k * (k + 1) + 2 + 2 * k)
               + 2 * (k + 1) * N * (2 * k + 5) + 2 * N * (3 + 6 * k))
    plain_mul = N * (2 + k) + ntt_rows_mul64(k) + 2 * k * N * 7
    # Q: decomp = k rows over the k + 1 key limbs; the secret key and the
    # target in, the key out; I1 and I2 (its threefry block once per
    # coefficient), A over decomp (k + 1) rows, B's product and Barrett
    # (6 products a word), the P w_j terms
    kf = k + 1
    key_words = k * kf * N
    q_bytes = (kf * N + k * N) * 8 + 2 * key_words * 8
    q_mul = ntt_rows_mul64(k * kf) + key_words * 6 + k * N * 2
    q_int32 = key_words * (2 * THREEFRY_OPS + 4) + k * N * THREEFRY_OPS
    # M' hoisted over m = 8 elements, NTT form: one decompose (A over
    # k + k (k + 1) rows), then per element the pre-permuted key's rows,
    # B, the divide (A over 2 + 2 k rows, K') and M
    m = 8
    hoist_mul = (ntt_rows_mul64(k + k * (k + 1) + m * (2 + 2 * k))
                 + m * (2 * (k + 1) * N * (2 * k + 5) + 2 * N * (3 + 6 * k)))
    out = {}
    for op, nbytes, mul64, int32 in (
            ("Mp_rotation_ntt", 2 * ct + key_rows, rot_mul, 0),
            ("Mp_hoisted_ntt_m8", (1 + m) * ct + m * key_rows, hoist_mul,
             0),
            ("L_multiply_plain_bgv_ckks", 2 * ct + N * 8, plain_mul, 0),
            ("L_multiply_plain_bfv", 2 * ct + N * 8,
             plain_mul + ntt_rows_mul64(4 * k), 0),
            ("Q_kswitch_key", q_bytes, q_mul, q_int32)):
        ms, by = bound(nbytes, mul64, int32_ops=int32)
        out[op] = {"bound_ms": ms, "bound_by": by}
    return out


def fold_mul64(m: int, k: int) -> int:
    """64-bit products of one batched fold of m coefficient-form
    ciphertexts: A over the m k (k + 1) digit rows, B's k-term sums and
    Barrett over m 2 (k + 1) rows, the inverse A over those rows and the
    divide's rounding over the m 2 k output rows."""
    return (ntt_rows_mul64(m * k * (k + 1)) + ntt_rows_mul64(m * 2 * (k + 1))
            + m * 2 * (k + 1) * N * (2 * k + 7) + m * 2 * k * N * 6)


def slice7_bounds(k: int, k_app: int) -> dict:
    """The least times of the app layer's composite rows of the kernel table:
    N, the pack of 16 LWE samples (the samples in, the 14 folds' used key
    rows read once, the packed ciphertext out; folds over 8, 4, 2, 1 pairs
    then 10 trace steps) and the trace down to degree 1 (one ciphertext in
    and out, 14 keys' rows), k data limbs; the batched decrypt of 52
    size-2 conv2d outputs (A forward over their rows, B and D, the inverse
    A, C and E's rounding to t) at the app configuration's k_app limbs;
    O's polynomial encode (n f64 in, k rows out: O2 and A) and decode."""
    key_words = 14 * k * 2 * (k + 1) * N
    ct = 2 * k * N
    pack_mul = sum(fold_mul64(m, k) for m in (8, 4, 2, 1) + (1,) * 10)
    dec_rows = 52 * 2 * k_app
    dec_mul = (ntt_rows_mul64(dec_rows + 52 * k_app)
               + 52 * k_app * N * 9 + 52 * N * (4 * k_app + 12))
    out = {}
    for op, nbytes, mul64 in (
            ("N_pack_lwe16", (16 * (k * N + k) + key_words + ct) * 8,
             pack_mul + 16 * ct * 2),
            ("N_field_trace", (2 * ct + key_words) * 8,
             sum(fold_mul64(1, k) for _ in range(14))),
            ("batched_decrypt_conv52",
             (52 * 2 * k_app * N + k_app * N + 52 * N) * 8, dec_mul),
            ("O_encode_polynomial", (N + k * N) * 8,
             ntt_rows_mul64(k) + k * N * 4),
            ("O_decode_polynomial", (k * N + N) * 8,
             ntt_rows_mul64(k) + N * k * 8)):
        ms, by = bound(nbytes, mul64)
        out[op] = {"bound_ms": ms, "bound_by": by}
    return out


# --------------------------------------------------------------------------
# the CKKS statistics, troy's binder API and troy's wire: 29-32
# --------------------------------------------------------------------------

def phase_stats_kernels(dev) -> tuple:
    """Phase 29: O4, AO4p and O5 against their plain versions at every
    STATS_SHAPES shape: O4's words equal to O2's and its statistic
    bit-equal to the plain version's on the same u; AO4p's (O4's statistic
    in A's forward passes, the encode_with_stats of A's route) words equal
    to AO2p's and its plain version's, its statistic bit-equal to O4's and
    its plain version's; O5, on O5_INPUTS
    coefficient vectors (so that a reduction over part of the slots
    shows): its slots bit-equal to O1's (embed_forward) on the same
    coefficients, slots and partners within O1_TOLERANCE of the plain
    version's, its statistic bit-equal to the residual of its own slots
    and partners (a maximum is exact), both residuals in (0,
    RESIDUAL_BOUND] and the kernel's within O1_TOLERANCE max|v| of the
    plain version's; the times, device time per launch, bound, plain time
    and torch.fft.fft's time and device time (the transform's yardstick: no
    PyTorch call computes either statistic)."""
    rng = np.random.default_rng(SEED + 29)
    shapes, results = {}, {}
    for tag, n, bits, scale in STATS_SHAPES:
        moduli = _moduli(n, bits)
        k = len(moduli) - 1                         # the first data level
        t = embedding.make_embed_tables(n, dev)
        tabs = ntt.RnsNttTables.from_moduli(n, moduli[:k], dev)
        rt = embedding.make_rns_round_tables(tabs)
        vals = torch.from_numpy(rng.uniform(-1, 1, n // 2)
                                + 1j * rng.uniform(-1, 1, n // 2)).to(dev)
        u = embedding.embed_inverse_fft(vals, t)
        # a decode's input in slot units: the real coefficients of vals
        coeffs = (u * t.untwist).real.contiguous()
        o4 = lambda: embedding.untwist_round_to_rns_stats(u, scale, t, rt)
        o4_plain = lambda: (
            embedding.untwist_round_to_rns_plain(u, t.untwist, scale, rt),
            embedding.round_stats_plain(u, t.untwist, scale))
        ao4p = lambda: embedding.rns_ntt_forward_round_stats(
            u, t.untwist, scale, rt, tabs)
        ao4p_plain = lambda: embedding.ntt_forward_round_stats_plain(
            u, t.untwist, scale, rt, tabs)
        o5 = lambda: embedding.embed_forward_stats(coeffs, t)
        o5_plain = lambda: embedding.embed_forward_stats_plain(coeffs, t)
        (words, stat), (pwords, pstat) = o4(), o4_plain()
        (fwords, fstat), (fpwords, fpstat) = ao4p(), ao4p_plain()
        o2 = embedding.untwist_round_to_rns(u, scale, t, rt)
        torch.cuda.synchronize()
        try:
            compare("words", words, o2)
            compare("words", words, pwords)
            compare("bits", stat, pstat)
            compare("words", fwords, embedding.rns_ntt_forward_round(
                u, t.untwist, scale, rt, tabs))
            compare("words", fwords, fpwords)
            compare("bits", fstat, fpstat)
            compare("bits", fstat, stat)
            # the first input is timed below; the others are raw
            # coefficients in (-1, 1)
            o5_checks = [check_o5(c, t) for c in [coeffs] + [
                torch.from_numpy(rng.uniform(-1, 1, n)).to(dev)
                for _ in range(O5_INPUTS - 1)]]
        except AssertionError as exc:
            raise AssertionError(f"O4/AO4p/O5 {tag}: {exc}") from None
        _, e, pe = o5_checks[0]
        slot_err = max(c[0] for c in o5_checks)
        library_ms = cuda_ms(lambda: torch.fft.fft(u))
        library_device_us = device_kernels_per_op(
            lambda: torch.fft.fft(u))[1] * 1e3
        fft_ops = 5 * n * (n.bit_length() - 1)
        r = {"n": n, "limbs": k, "scale_log2": int(np.log2(scale)),
             "statistic": float(stat), "residual": e, "plain_residual": pe,
             "library_ms": library_ms,
             "library_device_us": library_device_us}
        for name, run, plain, work, err_ in (
                ("O4_ckks_encode_stats", o4, o4_plain,
                 (_bytes(u) + k * n * 8 + 8, n * k * 4), 0),
                ("AO4p_ntt_round_stats", ao4p, ao4p_plain,
                 (lambda w: (w[0] + 8,) + w[1:])(round_work(tabs, True)), 0),
                ("O5_ckks_decode_stats", o5, o5_plain,
                 (_bytes(coeffs) + 2 * (n // 2 * 16) + 8, 0,
                  fft_ops + 3 * (n // 2)),
                 max(max(c[0], abs(c[1] - c[2])) for c in o5_checks))):
            ms, plain_ms = cuda_ms(run), cuda_ms(plain)
            # each device op once a launch: the sum of their times, which
            # a trace that drops some events does not lower
            each = device_kernels_per_op(run)[2]
            device_us = sum(us for _, us in each.values())
            bound_ms, bound_by = bound(*work)
            r[name] = {"ms": ms, "device_us_per_launch": device_us,
                       "device_kernels": each, "bound_ms": bound_ms,
                       "bound_by": bound_by, "plain_ms": plain_ms,
                       "max_abs_err": err_}
            log(f"[29] {name} {tag} ({k} limbs): kernel {ms:.4f} ms, "
                f"device {device_us:.1f} us a launch ("
                + "; ".join(f"{kk} x{c:g} at {us:.1f} us"
                            for kk, (c, us) in each.items())
                + f"), bound {bound_ms:.6f} ms ({bound_by}), plain "
                f"{plain_ms:.4f} ms, torch.fft.fft {library_ms:.4f} ms "
                f"({library_device_us:.2f} us of device time, profiler)")
            if name not in results:
                # no PyTorch call rounds into RNS and transforms (AO4p);
                # the FFT is O4's and O5's transform yardstick
                results[name] = {"max_abs_err": err_, "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                                 "bound_by": bound_by,
                                 "library_ms": None if name.startswith("AO4p")
                                 else library_ms}
            else:
                results[name]["max_abs_err"] = max(
                    results[name]["max_abs_err"], err_)
        log(f"[29] {tag}: O4 words equal to O2's and the plain version's, "
            f"statistic {float(stat):.17g} bit-equal; AO4p words equal to "
            f"AO2p's and the plain version's, statistic bit-equal to O4's "
            f"and the plain version's; O5 on {O5_INPUTS} "
            f"inputs: slots bit-equal to O1's, slots and partners within "
            f"{slot_err:.3g} of the plain version's, statistic bit-equal to "
            f"the residual of its own slots and partners; residuals "
            + ", ".join(f"{c[1]:.3g} (plain {c[2]:.3g})" for c in o5_checks))
        shapes[tag] = r
    return results, shapes


def check_o5(coeffs: torch.Tensor, t) -> tuple:
    """O5 on one coefficient vector against O1 and its plain version (see
    phase_stats_kernels): (max error of slots and partners, residual,
    plain residual), or raise."""
    slots, partners, err = embedding.embed_forward_stats(coeffs, t)
    pslots, ppartners, perr = embedding.embed_forward_stats_plain(coeffs, t)
    o1 = embedding.embed_forward(coeffs, t)
    torch.cuda.synchronize()
    compare("bits", slots, o1)
    slot_err = max(compare("close", slots, pslots),
                   compare("close", partners, ppartners))
    # a maximum of values each rounded once is exact: the kernel's
    # reduction bit-equal to the residual of its own slots and partners
    compare("bits", err, embedding.conj_residual(slots, partners))
    tol = O1_TOLERANCE * float(pslots.abs().max())
    e, pe = float(err), float(perr)
    if not (0 < e <= RESIDUAL_BOUND and 0 < pe <= RESIDUAL_BOUND
            and abs(e - pe) <= tol):
        raise AssertionError(f"O5: residuals {e} (kernel) and {pe} (plain): "
                             f"not both in (0, {RESIDUAL_BOUND}] within "
                             f"{tol} of each other")
    return slot_err, e, pe


class BinderAlice:
    """troy's binder/test.py:9-78 Alice, against troy_tpu_torch.compat (the
    prints of the script become checks)."""

    def __init__(self):
        parameters = pytroy.EncryptionParameters(pytroy.SchemeType.ckks)
        parameters.set_poly_modulus_degree(BINDER_N)
        parameters.set_coeff_modulus(pytroy.CoeffModulus.create(
            BINDER_N, BINDER_BITS))
        self.context = pytroy.SEALContext(parameters)
        self.encoder = pytroy.CKKSEncoder(self.context)
        self.keygen = pytroy.KeyGenerator(self.context)
        self.public_key = self.keygen.create_public_key()
        self.encryptor = pytroy.Encryptor(self.context, self.public_key)
        self.decryptor = pytroy.Decryptor(self.context,
                                          self.keygen.secret_key())
        self.evaluator = pytroy.Evaluator(self.context)

    def get_public_key(self):
        relin_keys = self.keygen.create_relin_keys()
        galois_keys = self.keygen.create_galois_keys()
        relin_keys.load(relin_keys.save())
        self.relin_keys = relin_keys
        return (self.public_key.save(), relin_keys.save(),
                galois_keys.save())

    def get_ciphers(self):
        p1, p2 = pytroy.Plaintext(), pytroy.Plaintext()
        self.encoder.encode([1, 2, 3, 4], 1 << 40, p1)
        self.encoder.encode([0.5, 0.6, 0.7, 0.8], 1 << 40, p2)
        c1, c2 = pytroy.Ciphertext(), pytroy.Ciphertext()
        self.encryptor.encrypt(p1, c1)
        self.encryptor.encrypt(p2, c2)
        ret = (c1.save(), c2.save())
        self.c1, self.c2 = c1.copy(), c2.copy()
        self.evaluator.multiply_inplace(c1, c2)
        self.evaluator.relinearize_inplace(c1, self.relin_keys)
        self.product = c1
        got = np.real(self.decrypt(c1.save())[:4])
        if np.abs(got - BINDER_WANT).max() > BINDER_BOUND:
            raise AssertionError(f"Alice's own product decodes to {got}")
        return ret

    def decrypt(self, c_s):
        c = pytroy.Ciphertext()
        c.load(c_s)
        p = pytroy.Plaintext()
        self.decryptor.decrypt(c, p)
        return self.encoder.decode(p)


class BinderBob:
    """binder/test.py Bob: his own context, Alice's keys from bytes."""

    def __init__(self):
        parameters = pytroy.EncryptionParameters(pytroy.SchemeType.ckks)
        parameters.set_poly_modulus_degree(BINDER_N)
        parameters.set_coeff_modulus(pytroy.CoeffModulus.create(
            BINDER_N, BINDER_BITS))
        self.context = pytroy.SEALContext(parameters)
        self.encoder = pytroy.CKKSEncoder(self.context)

    def receive_public_key(self, keys):
        s_public_key, s_relin_keys, s_galois_keys = keys
        self.public_key = pytroy.PublicKey()
        self.public_key.load(s_public_key)
        self.encryptor = pytroy.Encryptor(self.context, self.public_key)
        self.evaluator = pytroy.Evaluator(self.context)
        self.relin_keys = pytroy.RelinKeys()
        self.relin_keys.load(s_relin_keys)
        self.galois_keys = pytroy.GaloisKeys()
        self.galois_keys.load(s_galois_keys)

    def evaluate(self, c1_s, c2_s):
        c1, c2 = pytroy.Ciphertext(), pytroy.Ciphertext()
        c1.load(c1_s)
        c2.load(c2_s)
        self.evaluator.multiply_inplace(c1, c2)
        self.evaluator.relinearize_inplace(c1, self.relin_keys)
        self.evaluator.rescale_to_next_inplace(c1)
        return c1.save()


def negacyclic(a: np.ndarray, b: np.ndarray, t: int) -> np.ndarray:
    """a b mod (x^n + 1, t) for int64 coefficient vectors whose products
    and sums stay below 2^63."""
    n = len(a)
    full = np.convolve(a.astype(np.int64), b.astype(np.int64))
    res = full[:n].copy()
    res[:n - 1] -= full[n:]
    return res % t


class TimeTest:
    """binder/timetest.py's TimeTestCKKS and TimeTestBFVBGV (:53-372) at its
    main() configurations, repeat = 2, through troy_tpu_torch.compat, with
    every op's result decrypted and checked (timing scaffolding removed)."""

    def __init__(self, scheme, seed):
        self.scheme, self.rng = scheme, np.random.default_rng(seed)
        n = TIMETEST_N
        parms = pytroy.EncryptionParameters(scheme)
        parms.set_poly_modulus_degree(n)
        self.ckks = scheme == pytroy.SchemeType.ckks
        if self.ckks:
            parms.set_coeff_modulus(pytroy.CoeffModulus.create(
                n, TIMETEST_CKKS_Q))
            self.count = n // 2
        else:
            parms.set_plain_modulus(1 << TIMETEST_T_BITS)
            parms.set_coeff_modulus(pytroy.CoeffModulus.create(
                n, TIMETEST_BFV_Q))
            self.count = n
        context = pytroy.SEALContext(parms)
        keygen = pytroy.KeyGenerator(context)
        self.pk, self.rlk = pytroy.PublicKey(), pytroy.RelinKeys()
        keygen.create_public_key(self.pk)
        keygen.create_relin_keys(self.rlk)
        if self.ckks:
            self.gk = pytroy.GaloisKeys()
            keygen.create_galois_keys(self.gk)
            self.encoder = pytroy.CKKSEncoder(context)
        else:
            self.encoder = pytroy.BatchEncoder(context)
        self.encryptor = pytroy.Encryptor(context, self.pk)
        self.decryptor = pytroy.Decryptor(context, keygen.secret_key())
        self.evaluator = pytroy.Evaluator(context)
        self.worst = 0.0

    def vector(self):
        if self.ckks:
            return self.rng.uniform(-DATA_BOUND, DATA_BOUND, self.count)
        return self.rng.integers(0, DATA_BOUND, self.count, dtype=np.int64)

    def plaintext(self, v):
        if self.ckks:
            ret = pytroy.Plaintext()
            self.encoder.encode(v, TIMETEST_DELTA, ret)
            return ret
        return self.encoder.encode_polynomial(v.astype(np.uint64))

    def ciphertext(self, v):
        ret = pytroy.Ciphertext()
        self.encryptor.encrypt(self.plaintext(v), ret)
        return ret

    def mul(self, a, b):
        return a * b if self.ckks else negacyclic(a, b, 1 << TIMETEST_T_BITS)

    def check(self, what, c, want):
        p = self.decryptor.decrypt(c)
        if self.ckks:
            got = np.real(self.encoder.decode(p))
            err = float(np.abs(got - want).max())
            self.worst = max(self.worst, err / max(1.0, np.abs(want).max()))
            if err > TIMETEST_CKKS_BOUND * max(1.0, np.abs(want).max()):
                raise AssertionError(f"timetest {what}: {err} from the "
                                     "expected slots")
        else:
            got = self.encoder.decode_polynomial(p).astype(np.int64)
            if not np.array_equal(got, np.asarray(want) % (
                    1 << TIMETEST_T_BITS)):
                raise AssertionError(f"timetest {self.scheme.name} {what} "
                                     "decrypts wrong")

    def run(self, repeat=2):
        ev = self.evaluator
        a, b = self.vector(), self.vector()
        c1, c2 = self.ciphertext(a), self.ciphertext(b)
        p2 = self.plaintext(b)
        c3 = pytroy.Ciphertext()
        for _ in range(repeat):                       # testAdd
            ev.add(c1, c2, c3)
            ev.add_inplace(c3, c1)
            c4 = ev.add(c1, c3)
        self.check("add", c4, 3 * a + b)
        for _ in range(repeat):                       # testAddPlain
            ev.add_plain(c1, p2, c3)
            ev.add_plain_inplace(c3, p2)
            c4 = ev.add_plain(c3, p2)
        self.check("add_plain", c4, a + 3 * b)
        for _ in range(repeat):                       # testMultiplyPlain
            ev.multiply_plain(c1, p2, c3)
            ev.multiply_plain_inplace(c3, p2)
            c4 = ev.multiply_plain(c1, p2)
        self.check("multiply_plain", c4, self.mul(a, b))
        if not self.ckks:
            self.check("multiply_plain twice", c3,
                       self.mul(self.mul(a, b), b))
        c5 = None
        for _ in range(repeat):           # testMultiplyRescale / ModSwitch
            ev.multiply(c1, c2, c3)
            if self.ckks:
                ev.rescale_to_next(c3, c4)
            else:
                ev.mod_switch_to_next(c3, c4)
            c5 = c1.copy()
            ev.multiply_inplace(c5, c2)
            if self.ckks:
                ev.rescale_to_next_inplace(c5)
            else:
                ev.mod_switch_to_next_inplace(c5)
        if c4.size() != 3 or c5.size() != 3:
            raise AssertionError("the product is not of size 3")
        self.check("multiply, rescale or mod switch", c4, self.mul(a, b))
        self.check("multiply_inplace", c5, self.mul(a, b))
        for _ in range(repeat):                       # testSquare
            ev.square(c1, c2)
            c3 = c1.copy()
            ev.square_inplace(c3)
            c4 = ev.square(c1)
        self.check("square", c4, self.mul(a, a))
        self.check("square_inplace", c3, self.mul(a, a))
        self.check("relinearize", ev.relinearize(c4, self.rlk),
                   self.mul(a, a))
        if self.ckks:                                 # testRotateVector
            c6, c7 = pytroy.Ciphertext(), c1.copy()
            for _ in range(repeat):
                ev.rotate_vector(c7, 1, self.gk, c6)
                ev.rotate_vector_inplace(c7, 1, self.gk)
            self.check("rotate_vector", c6, np.roll(a, -repeat))
        for _ in range(repeat):                       # testMemoryPool
            c8 = pytroy.Ciphertext()
            ev.square(c1, c8)
        self.check("memory pool square", c8, self.mul(a, a))


def phase_binder(counter) -> tuple:
    """Phase 30: troy's binder scripts through troy_tpu_torch.compat on the
    card at full width, in a count window of their own: binder/test.py's
    Alice/Bob protocol (CKKS n = 16384, six 40-bit primes, keys and
    ciphertexts exchanged as save() bytes), binder/timetest.py's op surface
    (BFV and BGV at (8192, t = 2^41, (60,50,60)), CKKS at (8192,
    (60,40,40,60), 2^40)), a borderline CKKS encode (kernel O4 and the
    exact check) and one too large, and decode_max_error (O5) on a fresh
    product; then the shim ops' device kernels from the profiler."""
    counter.calls.clear()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pytroy.initialize_kernel()
    alice = BinderAlice()
    keys = alice.get_public_key()
    bob = BinderBob()
    bob.receive_public_key(keys)
    keygen_s = time.perf_counter() - t0
    c3_s = bob.evaluate(*alice.get_ciphers())
    got = np.real(alice.decrypt(c3_s)[:4])
    err = float(np.abs(got - BINDER_WANT).max())
    if err > BINDER_BOUND:
        raise AssertionError(f"binder/test.py decodes to {got}, {err} from "
                             f"{BINDER_WANT.tolist()}")
    log(f"[30] binder/test.py (CKKS n = {BINDER_N}, six 40-bit primes): "
        f"decodes to {got.tolist()}, within {err:.3g} of "
        f"{BINDER_WANT.tolist()} (bound {BINDER_BOUND}); keys and contexts "
        f"{keygen_s:.1f} s, {len(keys[2])} bytes of Galois keys")
    worst = {}
    for scheme, seed in ((pytroy.SchemeType.bfv, 7),
                         (pytroy.SchemeType.bgv, 13),
                         (pytroy.SchemeType.ckks, 11)):
        tt = TimeTest(scheme, SEED + 30 + seed)
        tt.run()
        worst[scheme.name] = tt.worst
        log(f"[30] binder/timetest.py {scheme.name} (n = {TIMETEST_N}): "
            f"add, add_plain, multiply_plain, multiply with "
            f"{'rescale' if tt.ckks else 'mod switch'}, square, "
            f"relinearize{', rotate_vector' if tt.ckks else ''} and the "
            f"memory-pool squares decrypt right"
            + (f" (max relative error {tt.worst:.3g})" if tt.ckks else ""))
    # the exact magnitude check (troy's gMaxReal path) and a too-large one
    enc = alice.encoder
    Q = alice.context._inner.first_context_data.total_coeff_modulus
    one = np.zeros(BINDER_N // 2)
    one[0] = 4.0 * Q / BORDER_SCALE
    border = enc.encode(one, BORDER_SCALE)
    back = float(np.real(enc.decode(border)[0]))
    if abs(back - one[0]) > 1e-9 * one[0]:
        raise AssertionError(f"the borderline encode decodes to {back}, not "
                             f"{one[0]}")
    try:
        enc.encode(np.full(BINDER_N // 2, Q / BORDER_SCALE), BORDER_SCALE)
    except ValueError:
        pass
    else:
        raise AssertionError("a CKKS encode above Q/2 did not raise")
    plain = alice.decryptor.decrypt(alice.product)
    max_err = alice.encoder._inner.decode_max_error(plain._inner)
    if not 0 <= max_err <= RESIDUAL_BOUND:
        raise AssertionError(f"decode_max_error {max_err} outside [0, "
                             f"{RESIDUAL_BOUND}]")
    log(f"[30] borderline encode (one slot at 4 Q / 2^45) accepted by the "
        f"exact check, decoding within {abs(back - one[0]) / one[0]:.3g} "
        f"(relative); every slot at Q / 2^45 raises; decode_max_error of "
        f"the product {max_err:.3g}")
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    check_path("30", "30", BINDER_PATH, counts, counter)
    ev, rlk = alice.evaluator, alice.relin_keys
    c1, c2 = alice.c1, alice.c2
    tmp = pytroy.Ciphertext()
    values = np.linspace(-1, 1, BINDER_N // 2)
    per_op = profile_ops("30", {
        "shim_ckks_mult_relin": lambda: (ev.multiply(c1, c2, tmp),
                                         ev.relinearize_inplace(tmp, rlk)),
        "shim_ckks_encode": lambda: enc.encode(values, BINDER_SCALE),
        "shim_ckks_encode_borderline": lambda: enc.encode(one, BORDER_SCALE),
        "shim_ckks_decode_max_error": lambda: enc._inner.decode_max_error(
            plain._inner),
        "shim_ckks_save_load": lambda: pytroy.Ciphertext().load(
            c1.save(), alice.context)})
    if counter.calls:
        raise AssertionError(f"plain torch ran on the card in phase 30's "
                             f"profile: {counter.calls}")
    return counts, {"binder_max_error": err, "timetest_ckks_max_rel_error":
                    worst["ckks"], "decode_max_error": max_err,
                    "border_decode": back}, per_op, alice


def phase_wire(dev) -> dict:
    """Phase 31: troy's raw-struct wire (refwire.py) on the card at
    n = 16384 (BFV, q = {60,40,40,40,40,60}): the bytes of seeded keys, a
    public-key ciphertext, a seed-compressed one (saved expanded) and a
    product equal to the port's own CPU run from the same seeds; saveTerms
    and loadTerms round trip; every stream loads back and decrypts right;
    save and load times of a ciphertext."""
    out = {}
    for where in (dev, "cpu"):
        ctx = P.HeContext(P.EncryptionParameters(
            scheme=P.SchemeType.bfv, poly_modulus_degree=N,
            coeff_modulus=tuple(P.CoeffModulus.create(N, Q_BITS)),
            plain_modulus=P.PlainModulus.batching(N, 20)), device=where)
        kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(WIRE_SEED))
        pk = kg.create_public_key()
        rlk = kg.create_relin_keys()
        gk = kg.create_galois_keys(steps=[1])
        enc = P.Encryptor(ctx, pk, kg.secret_key,
                          rnd.seed_from_uint64(WIRE_SEED + 1))
        be = P.BatchEncoder(ctx)
        ev = P.Evaluator(ctx)
        t = be.plain_modulus
        a = np.arange(N, dtype=np.uint64) % t
        ct = enc.encrypt(be.encode(a))
        seeded = enc.encrypt_symmetric(be.encode(a), save_seed=True)
        if seeded.seed == 0:
            raise AssertionError("encrypt_symmetric(save_seed=True) kept no "
                                 "seed")
        prod = ev.relinearize(ev.multiply(ct, seeded), rlk)
        blobs = {"sk": refwire.save_secret_key_ref(kg.secret_key, ctx),
                 "pk": refwire.save_public_key_ref(pk, ctx),
                 "rlk": refwire.save_relin_keys_ref(rlk, ctx),
                 "gk": refwire.save_galois_keys_ref(gk, ctx),
                 "ct": refwire.save_ciphertext_ref(ct, ctx),
                 "seeded": refwire.save_ciphertext_ref(seeded, ctx),
                 "prod": refwire.save_ciphertext_ref(prod, ctx),
                 "terms": refwire.save_terms_ref(prod, ctx, WIRE_TERMS)}
        out[str(where)] = blobs
        if where != "cpu":
            card = (ctx, kg, be, ev, a, prod, seeded, rlk)
    differ = [k for k in out["cpu"] if out[str(dev)][k] != out["cpu"][k]]
    if differ:
        raise AssertionError(f"troy-wire bytes on the card differ from the "
                             f"CPU run's: {differ}")
    ctx, kg, be, ev, a, prod, seeded, rlk = card
    blobs = out[str(dev)]
    dec = P.Decryptor(ctx, refwire.load_secret_key_ref(blobs["sk"], ctx))
    t = be.plain_modulus
    square = (a.astype(object) * a.astype(object) % t).astype(np.uint64)
    checks = {"ct": a, "seeded": a, "prod": square}
    for name, want in checks.items():
        back = refwire.load_ciphertext_ref(blobs[name], ctx)
        if not np.array_equal(be.decode(dec.decrypt(back)), want):
            raise AssertionError(f"troy-wire {name} decrypts wrong")
    expanded = rlwe.expand_seed(seeded, ctx.first_context_data)
    if refwire.load_ciphertext_ref(blobs["seeded"], ctx).data.ne(
            expanded.data).any():
        raise AssertionError("the seed-compressed ciphertext did not save "
                             "expanded")
    part = refwire.load_terms_ref(blobs["terms"], ctx, WIRE_TERMS)
    if not (torch.equal(part.data[0][:, WIRE_TERMS],
                        prod.data[0][:, WIRE_TERMS])
            and torch.equal(part.data[1], prod.data[1])):
        raise AssertionError("saveTerms/loadTerms lost words")
    if refwire.save_terms_ref(part, ctx, WIRE_TERMS) != blobs["terms"]:
        raise AssertionError("loadTerms -> saveTerms changed the bytes")
    keys = refwire.load_relin_keys_ref(blobs["rlk"], ctx)
    if not torch.equal(keys.keys[2], rlk.keys[2]):
        raise AssertionError("the relin key did not round trip")
    times = {"save_ciphertext_ms": cuda_ms(
        lambda: refwire.save_ciphertext_ref(prod, ctx), reps=10),
        "load_ciphertext_ms": cuda_ms(
        lambda: refwire.load_ciphertext_ref(blobs["prod"], ctx), reps=10),
        "save_terms_ms": cuda_ms(
        lambda: refwire.save_terms_ref(prod, ctx, WIRE_TERMS), reps=10)}
    log(f"[31] troy wire at n = {N}: the bytes of sk, pk, relin key, Galois "
        f"key, a public-key ciphertext, a seed-compressed one (saved "
        f"expanded) and a product equal the CPU run's; each decrypts right "
        f"after load; saveTerms/loadTerms of {len(WIRE_TERMS)} terms round "
        f"trips; " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f"; {len(blobs['prod'])} bytes a product")
    return {**times, "bytes": {k: len(v) for k, v in blobs.items()}}


def phase_stats_medians(ckks_ctx, alice) -> dict:
    """Phase 32: the medians (CUDA events) of encode, encode_with_stats,
    encode_device, decode, decode_device and decode_device_with_stats at
    n = 16384 and 32768, and of mult+relin through the shim against the
    same op through Evaluator, alternately in SHIM_ROUNDS rounds (the
    shim's cost per op, beside the Evaluator's own spread)."""
    out = {}
    large = P.HeContext(P.EncryptionParameters(
        scheme=P.SchemeType.ckks, poly_modulus_degree=32768,
        coeff_modulus=tuple(P.CoeffModulus.create(32768, CKKS_LARGE_BITS))))
    rng = np.random.default_rng(SEED + 32)
    for tag, ctx in (("n16384", ckks_ctx), ("n32768", large)):
        ce = P.CKKSEncoder(ctx)
        n = ctx.n
        vals = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
        re = torch.from_numpy(vals.real.copy()).to(ctx.device)
        im = torch.from_numpy(vals.imag.copy()).to(ctx.device)
        plain = ce.encode(vals, CKKS_SCALE)
        times = {
            "encode": cuda_ms(lambda: ce.encode(vals, CKKS_SCALE)),
            "encode_with_stats": cuda_ms(
                lambda: ce.encode_with_stats(vals, CKKS_SCALE)),
            "encode_device": cuda_ms(
                lambda: ce.encode_device(re, im, CKKS_SCALE, 1.5)),
            "decode": cuda_ms(lambda: ce.decode(plain)),
            "decode_device": cuda_ms(lambda: ce.decode_device(plain)),
            "decode_device_with_stats": cuda_ms(
                lambda: ce.decode_device_with_stats(plain))}
        out[tag] = times
        log(f"[32] CKKS {tag} medians over {TIMING_REPS} runs (ms, CUDA "
            f"events): " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    ev, rlk, c1, c2 = alice.evaluator, alice.relin_keys, alice.c1, alice.c2
    tmp = pytroy.Ciphertext()
    inner = ev._inner
    shim = lambda: (ev.multiply(c1, c2, tmp), ev.relinearize_inplace(tmp,
                                                                    rlk))
    direct = lambda: inner.relinearize(inner.multiply(c1._inner, c2._inner),
                                       rlk._inner)
    runs = {"shim": [], "evaluator": []}
    for _ in range(SHIM_ROUNDS):
        for which in ("shim", "evaluator", "evaluator", "shim"):
            runs[which].append(cuda_ms(shim if which == "shim" else direct))
    shim_ms = statistics.median(runs["shim"])
    direct_ms = statistics.median(runs["evaluator"])
    q1, _, q3 = statistics.quantiles(runs["evaluator"], n=4)
    wins = sum(a < b for a, b in zip(runs["evaluator"], runs["shim"]))
    out["mult_relin"] = {"shim_ms": runs["shim"],
                         "evaluator_ms": runs["evaluator"],
                         "shim_cost_ms": shim_ms - direct_ms,
                         "evaluator_iqr_ms": q3 - q1,
                         "evaluator_faster_pairs": wins}
    log(f"[32] CKKS n = {BINDER_N} mult+relin, {SHIM_ROUNDS} rounds of "
        f"shim, Evaluator, Evaluator, shim: medians shim {shim_ms:.4f}, "
        f"Evaluator {direct_ms:.4f} ms; the shim's cost per op "
        f"{shim_ms - direct_ms:.4f} ms against the Evaluator's own "
        f"interquartile spread {q3 - q1:.4f} ms; Evaluator faster in {wins} "
        f"of {len(runs['shim'])} pairs")
    return out


def phase_shard_kernels(dev) -> tuple:
    """Phase 33: kernel R1 against its plain version at the key switch's
    partials of phase 34, (w, m, 2, 6, n) at n = 16384 (w = 4 and 2 ranks,
    one ciphertext; the (2, 2) mesh's tp pair with a batch of 2), word for
    word, with its times, device us a launch and bound; kernel J's stages
    on per-shard tables (ops/ntt_mxu.make_shard_tables: a rank's column
    and row blocks with its twiddle blocks) against their plain version at
    n = 16384 over 2 and 4 ranks and n = 131072 over 2, the first and the
    last rank's tables, every stage."""
    rng = np.random.default_rng(SEED + 33)
    moduli = _moduli(N, Q_BITS)
    t = ntt.RnsNttTables.from_moduli(N, moduli, dev)
    checks = []
    for w, m in ((4, 1), (2, 1), (2, 2)):
        parts = _uniform(rng, moduli, (w, m, 2, len(moduli), N), dev)
        words = m * 2 * len(moduli) * N
        work = (_bytes(parts) + words * 8, 0, 0, 4 * (w - 1) * words)
        checks.append(("R1_shard_modsum", f"({w}, {m}, 2, 6, n)", "words",
                       lambda p=parts: shard.shard_modsum(p, t),
                       lambda p=parts: shard.shard_modsum_plain(p, t), work,
                       None))
    results = run_checks("33", checks)
    first = _uniform(rng, moduli, (4, 1, 2, len(moduli), N), dev)
    _, device_ms, each = device_kernels_per_op(
        lambda: shard.shard_modsum(first, t),
        expect={"shard_modsum_kernel": 1})
    launches, us = each["shard_modsum_kernel"]
    results["R1_shard_modsum"]["device_us_per_launch"] = us
    log(f"[33] R1_shard_modsum (4, 1, 2, 6, n): {launches:g} launch at "
        f"{us:.1f} us of device time")
    jshapes = {}
    for n, bits, w in ((N, Q_BITS, 2), (N, Q_BITS, 4),
                       (CEILING_NS[0], CEILING_Q_BITS, 2)):
        moduli = _moduli(n, bits)
        for i in sorted({0, w - 1}):
            mxu = [ntt_mxu.make_shard_tables(n, q, dev, w, i)
                   for q in moduli]
            ptrs = ntt_mxu.pointer_table(mxu, dev)
            a, b = mxu[0].a, mxu[0].b
            col_any = _full(rng, (2, len(moduli), a, b // w), dev)
            row_any = _full(rng, (2, len(moduli), a // w, b), dev)
            col_red = _uniform(rng, moduli, (2, len(moduli), a * b // w),
                               dev).reshape(2, len(moduli), a, b // w)
            row_red = _uniform(rng, moduli, (2, len(moduli), a * b // w),
                               dev).reshape(2, len(moduli), a // w, b)
            tag = f"n{n}_w{w}_rank{i}"
            shape = {}
            for stage, x in (("forward_left", col_any),
                             ("forward_right", row_red),
                             ("inverse_right", row_any),
                             ("inverse_left", col_red)):
                got = ntt_mxu.rns_mxu_stage(x, mxu, ptrs, stage)
                want = ntt_mxu.mxu_stage_plain(x, mxu, stage)
                torch.cuda.synchronize()
                try:
                    compare("words", got, want)
                except AssertionError as exc:
                    raise AssertionError(f"J_ntt_mxu shard {tag} {stage}: "
                                         f"{exc}") from None
                shape[f"{stage}_ms"] = cuda_ms(
                    lambda x=x, stage=stage: ntt_mxu.rns_mxu_stage(
                        x, mxu, ptrs, stage))
            jshapes[tag] = shape
            log(f"[33] J_ntt_mxu on rank {i}'s tables of {w} at n = {n} "
                f"({len(moduli)} limbs, blocks ({a}, {b // w}) and "
                f"({a // w}, {b})): every stage word-equal to the plain "
                "version; "
                + ", ".join(f"{k} {v:.4f}" for k, v in shape.items()))
    return results, jshapes


class ShardScheme:
    """One configuration's state for phase 34 on the card: keys made from
    a seed, the encoder, the evaluator, the decryptor, and fresh
    encryptions of seeded values."""

    def __init__(self, ctx, seed: int):
        self.ctx = ctx
        self.ckks = ctx.scheme == P.SchemeType.ckks
        kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(seed))
        self.rlk = kg.create_relin_keys()
        self.gk = kg.create_galois_keys(steps=[1])
        self.enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                               seed=rnd.seed_from_uint64(seed + 1))
        self.dec = P.Decryptor(ctx, kg.secret_key)
        self.ev = P.Evaluator(ctx)
        self.rng = np.random.default_rng(seed)
        if self.ckks:
            self.encoder, self.t = P.CKKSEncoder(ctx), None
        else:
            self.encoder = P.BatchEncoder(ctx)
            self.t = self.encoder.plain_modulus

    def spec(self) -> dict:
        cd = self.ctx.key_context_data
        return {"scheme": self.ctx.scheme.name, "n": self.ctx.n,
                "q": list(cd.coeff_values), "t": self.t or 0}

    def fresh(self):
        """(values, ciphertext) of seeded values."""
        if self.ckks:
            v = self.rng.uniform(-1, 1, self.ctx.n // 2)
            return v, self.enc.encrypt_symmetric(self.encoder.encode(
                v, CKKS_SCALE))
        v = self.rng.integers(0, self.t, self.ctx.n, dtype=np.uint64)
        return v, self.enc.encrypt_symmetric(self.encoder.encode(v))

    def check(self, ct, want: np.ndarray, what: str) -> float:
        """Decrypt and decode ct against the expected slots: exact for BFV
        and BGV, within CKKS_ROTATION_BOUND for CKKS; the CKKS error."""
        got = self.encoder.decode(self.dec.decrypt(ct))
        if self.ckks:
            err = float(np.abs(got - want).max())
            if err > CKKS_ROTATION_BOUND:
                raise AssertionError(f"{what}: decodes {err:g} from the "
                                     "expected slots")
            return err
        if not np.array_equal(got, want):
            raise AssertionError(f"{what}: does not decrypt to the expected "
                                 "slots")
        return 0.0

    def product(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return a * b if self.ckks else (a.astype(object) * b % self.t) \
            .astype(np.uint64)

    def rotated(self, v: np.ndarray) -> np.ndarray:
        if self.ckks:
            return np.roll(v, -1)
        h = len(v) // 2
        return np.concatenate([np.roll(v[:h], -1), np.roll(v[h:], -1)])


def sharded_rank(spec: dict) -> dict:
    """Phase 34 in one spawned rank: spmd.run_jobs with every plain-torch
    call on a CUDA tensor counted (there must be none)."""
    counter = PlainCallCounter()
    out = spmd.run_jobs(spec)
    out["plain_calls"] = dict(counter.calls)
    return out


def shard_jobs(schemes: dict, ceiling: "ShardScheme",
               app: "ShardScheme") -> tuple:
    """Phase 34's jobs (parallel/spmd.py) and, for each, the port's
    unsharded result on the card (the words to equal), a check of that
    result's decryption and the unsharded op to time."""
    jobs, refs = [], {}
    w = interop.words

    def add(job, want, check, op):
        jobs.append(job)
        refs[job["name"]] = (want, check, op)

    for name, s in schemes.items():
        (va, ca), (vb, cb) = s.fresh(), s.fresh()
        ev, rlk, gk = s.ev, s.rlk, s.gk
        rel = ev.relinearize(ev.multiply(ca, cb), rlk)
        mr = (lambda ev=ev, ca=ca, cb=cb, rlk=rlk:
              ev.relinearize(ev.multiply(ca, cb), rlk))
        prod = s.product(va, vb)
        chk = (lambda ct, s=s, p=prod, n=name: s.check(ct, p, n))
        for regime in ("limb", "coeff"):
            add({"name": f"{regime}_{name}", "context": name,
                 "regime": f"{regime}_multiply_relin", "key": f"{name}_rlk",
                 "inputs": [w(ca), w(cb)]}, rel, chk, mr)
        rotate = ev.rotate_vector if s.ckks else ev.rotate_rows
        add({"name": f"rotate_{name}", "context": name,
             "regime": "limb_rotate", "key": f"{name}_gk", "steps": 1,
             "inputs": [w(ca)]}, rotate(ca, 1, gk),
            lambda ct, s=s, v=s.rotated(va), n=name: s.check(ct, v, n),
            lambda rotate=rotate, ca=ca, gk=gk: rotate(ca, 1, gk))
        switch = ev.rescale_to_next if s.ckks else ev.mod_switch_to_next
        add({"name": f"mod_switch_{name}", "context": name,
             "regime": "limb_mod_switch", "inputs": [w(rel)]}, switch(rel),
            chk, lambda switch=switch, rel=rel: switch(rel))
        if name == "bfv":
            # one level down: the ranks hold the first level's cut less
            # the dropped limb (4 limbs: 3/1 and 2/2/0/0)
            low = switch(rel)
            add({"name": "mod_switch_next_bfv", "context": name,
                 "regime": "limb_mod_switch", "level": low.level,
                 "inputs": [w(low)]}, switch(low), chk,
                lambda switch=switch, low=low: switch(low))
    s = schemes["bfv"]
    pairs = [(s.fresh(), s.fresh()) for _ in range(SHARD_BATCH)]
    rels = [s.ev.relinearize(s.ev.multiply(a[1], b[1]), s.rlk)
            for a, b in pairs]

    def batch_check(prods):
        def check(cts):
            for i, (ct, p) in enumerate(zip(cts, prods)):
                s.check(ct, p, f"batch element {i}")
        return check

    prods = [s.product(a[0], b[0]) for a, b in pairs]
    add({"name": "dp_bfv", "context": "bfv", "regime": "dp_multiply_relin",
         "key": "bfv_rlk",
         "inputs": [np.stack([w(a[1]) for a, _ in pairs]),
                    np.stack([w(b[1]) for _, b in pairs])]},
        rels, batch_check(prods),
        lambda: [s.ev.relinearize(s.ev.multiply(a[1], b[1]), s.rlk)
                 for a, b in pairs])
    sub = pairs[:SHARD_BATCH_2D]
    add({"name": "dp_limb_bfv", "context": "bfv",
         "regime": "dp_limb_multiply_relin", "key": "bfv_rlk", "mesh": None,
         "inputs": [np.stack([w(a[1]) for a, _ in sub]),
                    np.stack([w(b[1]) for _, b in sub])]},
        rels[:SHARD_BATCH_2D], batch_check(prods[:SHARD_BATCH_2D]),
        lambda: [s.ev.relinearize(s.ev.multiply(a[1], b[1]), s.rlk)
                 for a, b in sub])
    chain = [s.ev.mod_switch_to_next(s.ev.rotate_rows(a[1], 1, s.gk))
             for a, _ in sub]
    add({"name": "dp_limb_rotate_mod_switch_bfv", "context": "bfv",
         "regime": "dp_limb_rotate_mod_switch", "key": "bfv_gk",
         "mesh": None, "steps": 1,
         "inputs": [np.stack([w(a[1]) for a, _ in sub])]},
        chain, batch_check([s.rotated(a[0]) for a, _ in sub]),
        lambda: [s.ev.mod_switch_to_next(s.ev.rotate_rows(a[1], 1, s.gk))
                 for a, _ in sub])
    c = ceiling
    (va, ca), (vb, cb) = c.fresh(), c.fresh()
    add({"name": "coeff_bfv131072", "context": "bfv131072",
         "regime": "coeff_multiply_relin", "key": "bfv131072_rlk",
         "inputs": [w(ca), w(cb)]},
        c.ev.relinearize(c.ev.multiply(ca, cb), c.rlk),
        lambda ct: c.check(ct, c.product(va, vb), "n = 131072"),
        lambda: c.ev.relinearize(c.ev.multiply(ca, cb), c.rlk))
    be = app.encoder
    for dims in APP_SHARD_DIMS:
        h = linear.MatmulHelper(*dims, N, objective=0, pack_lwe=False)
        x = app.rng.integers(0, APP_INPUT_BOUND, dims[:2], dtype=np.uint64)
        wt = app.rng.integers(0, APP_INPUT_BOUND, dims[1:], dtype=np.uint64)
        x_ct = h.encrypt_inputs(app.enc, be.encode_polynomial, x)
        w_pt = h.encode_weights(be.encode_polynomial, wt)
        tag = "app_" + "x".join(map(str, dims))
        add({"name": tag, "context": "app", "regime": "app_matmul",
             "inputs": [np.stack([np.stack([w(ct) for ct in row])
                                  for row in x_ct.data]),
                        np.stack([np.stack([w(p) for p in row])
                                  for row in w_pt.data])],
             "level": x_ct.data[0][0].level, "ntt_form": False},
            h.matmul(app.ev, x_ct, w_pt),
            lambda grid, h=h, x=x, wt=wt, tag=tag: exact(
                h.decrypt_outputs(be.decode_polynomial, app.dec, grid),
                matmul_oracle(x, wt), app.t, tag),
            lambda h=h, x_ct=x_ct, w_pt=w_pt: h.matmul(app.ev, x_ct, w_pt))
    return jobs, refs


def _as_words(want) -> np.ndarray:
    """The words of an unsharded result: a ciphertext, a batch of them or
    a Cipher2d."""
    if isinstance(want, linear.Cipher2d):
        return np.stack([np.stack([interop.words(c) for c in row])
                         for row in want.data])
    if isinstance(want, list):
        return np.stack([interop.words(c) for c in want])
    return interop.words(want)


def _rebuild(want, words: np.ndarray, dev):
    """The gathered words in the unsharded result's objects."""
    if isinstance(want, linear.Cipher2d):
        return linear.Cipher2d([[c.replace(data=to_torch(words[i, j], dev))
                                 for j, c in enumerate(row)]
                                for i, row in enumerate(want.data)])
    if isinstance(want, list):
        return [c.replace(data=to_torch(x, dev)) for c, x in zip(want, words)]
    return want.replace(data=to_torch(words, dev))


def phase_sharded(ctxs: dict, app_ctx) -> tuple:
    """Phase 34: every regime of parallel/sharding.py on the card, in
    spawned ranks sharing it (SHARD_RUNS: gloo in 2 and 4 ranks, with the
    collectives staged through host memory, and NCCL in one rank): data
    parallel (8 BFV pairs), limb-sharded mult+relin, rotation by one step
    and mod switch (CKKS: rescale) of BFV, CKKS and BGV at n = 16384
    (5 limbs: 3/2, 2/2/1/0 and 5) and BFV's mod switch one level down (4
    limbs on the first level's cut: 3/1, 2/2/0/0 and 4), the (2, 2) mesh's mult+relin of 4 pairs
    and rotation chained into the mod switch (the 4-rank run; (1, 1) at one
    rank), coefficient-sharded mult+relin of all three and of BFV at troy's
    ceiling n = 131072 (not in the 4-rank run), and the app matmul over the
    batch-block rows of 64x128x256 (one block) and 16384x16x16 (two); every
    gathered output word-equal to the port's unsharded op on the card and
    decrypting right; per rank, the median of SHARD_REPS runs (CUDA
    events), the collectives' calls and bytes, the bytes of its shards and
    no plain torch on the card; the launches of every rank and run summed
    into one count window, which must launch SHARDED_PATH; the unsharded
    ops' medians beside them."""
    dev = app_ctx.device
    t0 = time.perf_counter()
    schemes = {name: ShardScheme(ctx, SHARD_SEED + 10 * i)
               for i, (name, ctx) in enumerate(ctxs.items())}
    ceiling = ShardScheme(P.HeContext(P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=CEILING_NS[0],
        coeff_modulus=tuple(P.CoeffModulus.create(CEILING_NS[0],
                                                  CEILING_Q_BITS)),
        plain_modulus=P.PlainModulus.batching(CEILING_NS[0],
                                              CEILING_T_BITS)),
        sec_level=P.SecurityLevel.none, device=dev), SHARD_SEED + 40)
    app = ShardScheme(app_ctx, SHARD_SEED + 50)
    jobs, refs = shard_jobs(schemes, ceiling, app)
    keys = {}
    for name, s in (*schemes.items(), ("bfv131072", ceiling)):
        keys[f"{name}_rlk"] = interop.words(s.rlk)
        keys[f"{name}_gk"] = interop.words(s.gk)
    contexts = {name: s.spec() for name, s in (*schemes.items(),
                                                ("bfv131072", ceiling),
                                                ("app", app))}
    log(f"[34] set-up (keys, inputs, unsharded results): "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (want, check, _) in refs.items():
        check(want)
    unsharded_ms = {name: cuda_ms(op, reps=SHARD_REPS)
                    for name, (_, _, op) in refs.items()}
    counts, out = {}, {}
    for backend, world in SHARD_RUNS:
        run_jobs = []
        for job in jobs:
            if job.get("mesh", False) is None:
                if world not in (1, 4):
                    continue
                job = dict(job, mesh=[world // 2 or 1, 2 if world == 4
                                      else 1])
            if world == 4 and (job["name"] == "coeff_bfv131072"
                               or job["regime"] == "app_matmul"):
                continue
            run_jobs.append(job)
        t0 = time.perf_counter()
        ranks = sharding.spawn(
            sharded_rank, world, backend, str(dev),
            ({"contexts": contexts, "keys": keys, "jobs": run_jobs,
              "reps": SHARD_REPS},), timeout_s=SHARD_TIMEOUT_S)
        wall = time.perf_counter() - t0
        tag = f"{backend}{world}"
        for r, rank in enumerate(ranks):
            if rank["plain_calls"]:
                raise AssertionError(f"[34] {tag} rank {r}: plain torch on "
                                     f"the card: {rank['plain_calls']}")
            if rank["jax_loaded"]:
                raise AssertionError(f"[34] {tag} rank {r} imported JAX")
            for k, v in rank["launches"].items():
                counts[k] = counts.get(k, 0) + v
        for job in run_jobs:
            name = job["name"]
            want, check, _ = refs[name]
            res = [rank["results"][name] for rank in ranks]
            got = res[0]["out"]
            if not np.array_equal(got, _as_words(want)):
                raise AssertionError(f"[34] {tag} {name}: the gathered words "
                                     "differ from the unsharded op's")
            check(_rebuild(want, got, dev))
            entry = {
                "ms": max(x["ms"] for x in res),
                "rank_ms": [x["ms"] for x in res],
                "unsharded_ms": unsharded_ms[name],
                "collective_calls": [x["collectives"]["calls"] for x in res],
                "collective_bytes": [sum(x["collectives"]["bytes"].values())
                                     for x in res],
                "shard_bytes": [x["shard_bytes"] for x in res],
                "bound_ms_per_rank": max(x["shard_bytes"] for x in res)
                / MEM_BYTES_PER_S * 1e3,
                "shard_shapes": [x["shard_shape"] for x in res]}
            out.setdefault(name, {})[tag] = entry
            log(f"[34] {tag} {name}: word-equal to the unsharded op, "
                f"decrypts right; median {entry['ms']:.4f} ms (ranks "
                + ", ".join(f"{m:.4f}" for m in entry["rank_ms"])
                + f"; unsharded {entry['unsharded_ms']:.4f} ms); "
                f"collectives {entry['collective_calls'][0]}, "
                f"{entry['collective_bytes']} bytes received per rank; "
                f"shards {entry['shard_shapes']}; per-rank byte bound "
                f"{entry['bound_ms_per_rank']:.6f} ms")
        log(f"[34] {tag}: {len(run_jobs)} jobs in {wall:.1f} s (spawn, "
            "contexts, runs, checks)")
    log(f"[34] kernel launches of every rank of every run: {counts}")
    missing = [k for k in SHARDED_PATH if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched in phase 34: {missing}")
    log("[34] plain-version and u64ops calls on CUDA tensors in every rank: "
        "0")
    return counts, out


# --------------------------------------------------------------------------
# kernels A and M redesigned for the H100: phase 35
# --------------------------------------------------------------------------

def _ntt_rows(n: int, shape: str, dev) -> "ntt.RnsNttTables":
    """Kernel A's tables for one of REDESIGN_ROWS' shapes at n: the batching
    prime of t for the row mod t, six 60-bit primes for (5, 6, n), eleven for
    q u Bsk's (4, 11, n); A's tables (no J) at every n."""
    k = REDESIGN_ROWS[shape][0]
    if k == 1:
        moduli = [int(P.PlainModulus.batching(n, 20))]
    else:
        moduli = [int(m) for m in P.CoeffModulus.create(n, [60] * k)]
    return ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=False)


def host_us(fn, reps: int = 500) -> float:
    """Host microseconds to enqueue one call of fn, the device idle: what a
    wrapper and its launch cost the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def graph_us(fn, calls: int = 20, reps: int = 5) -> float:
    """Device us of one call of fn: calls back to back in a CUDA graph,
    replayed under CUDA events (the median of reps), so the host's
    enqueue time, longer than these kernels, does not count."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / calls)
    return statistics.median(times)


def alternating_ms(pairs: dict, rounds: int = 4) -> dict:
    """Median CUDA-event ms of each call, timed in turns (a, b, b, a, ...)
    in this process: wrapper medians move up to 2 times between
    processes."""
    times = {name: [] for name in pairs}
    names = list(pairs)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(cuda_ms(pairs[name]))
    return {name: statistics.median(v) for name, v in times.items()}


def phase_redesign(dev, bfv_ops: dict, per_op: dict, app_ctx,
                   divide_ops: dict, zero_ctxs: dict,
                   decrypt_ops: dict) -> dict:
    """Phase 35: kernels A and M (then J, E, B's shapes, O1 and O5, P1 and
    F's digits, K' and K'-BGV, D and I, O3 and F's divide, X and C, G' and
    P2, O2 and K, B and K'', G and O4: redesign_j, redesign_e, redesign_b,
    redesign_o1, redesign_p1, redesign_f, redesign_kp, redesign_zero,
    redesign_o3, redesign_afi, redesign_decrypt, standalone_decrypt,
    redesign_agp, redesign_ap2i, standalone_p2, redesign_ao2p,
    redesign_embed, redesign_ao4p, standalone_k, standalone_kpp) as
    redesigned
    for the H100. A against its plain version, word for word, at every n of
    REDESIGN_NS (one pass over whole rows below 1024, two passes from it
    up) and the shapes of
    REDESIGN_ROWS, forward and inverse, lazy and not, and at n = 32768
    beside J; A's device us per launch and blocks per launch; M's
    wrapper ms in every form beside index_select / gather timed in turns in
    this process, its device us; and the host's enqueue us of a launch."""
    rng = np.random.default_rng(SEED + 35)
    checks = 0
    for n in REDESIGN_NS:
        for shape, (k, lead) in REDESIGN_ROWS.items():
            t = _ntt_rows(n, shape, dev)
            x = _uniform(rng, [4 * q for q in t.values], (lead, k, n), dev)
            y = _uniform(rng, [2 * q for q in t.values], (lead, k, n), dev)
            for lazy in (False, True):
                for fn, plain, v in ((ntt.rns_ntt_forward,
                                      ntt.ntt_forward_plain, x),
                                     (ntt.rns_ntt_inverse,
                                      ntt.ntt_inverse_plain, y)):
                    try:
                        compare("words", fn(v, t, lazy), plain(v, t, lazy))
                    except AssertionError as exc:
                        raise AssertionError(f"A at n = {n}, {shape}, lazy "
                                             f"{lazy}: {exc}") from None
                    checks += 1
    log(f"[35] A word-equal to its plain version in {checks} checks: n = "
        f"{list(REDESIGN_NS)}, rows {list(REDESIGN_ROWS)}, forward and "
        "inverse, lazy and not")

    def a_profile(t, x, inverse=False):
        """Device us a call (graph replay) and a launch (profiler, every
        pass of every traced call seen)."""
        fn = ntt.rns_ntt_inverse if inverse else ntt.rns_ntt_forward
        passes = len(ntt.launch_blocks(x.numel() // t.n, t.n, inverse))
        _, _, each = device_kernels_per_op(
            lambda: fn(x, t), reps=10, expect={"ntt_pass_kernel": passes},
            whole=True)
        return {"device_us": graph_us(lambda: fn(x, t)), "launches": passes,
                "us_per_launch": each["ntt_pass_kernel"][1]}

    per_shape = {}
    for shape, (k, lead) in REDESIGN_ROWS.items():
        t = _ntt_rows(N, shape, dev)
        x = _uniform(rng, [4 * q for q in t.values], (lead, k, N), dev)
        fwd, inv = a_profile(t, x), a_profile(t, x, True)
        per_shape[shape] = {
            "forward": fwd, "inverse": inv,
            "blocks": ntt.launch_blocks(lead * k, N),
            "wrapper_ms": cuda_ms(lambda: ntt.rns_ntt_forward(x, t))}
        log(f"[35] A at ({lead},{k},n) {shape}: forward {fwd['device_us']:.1f}"
            f" us of device time a call ({fwd['us_per_launch']:.1f} us a "
            f"launch, {fwd['launches']} launches a call), inverse "
            f"{inv['device_us']:.1f} us; blocks per launch "
            f"{per_shape[shape]['blocks']}; wrapper "
            f"{per_shape[shape]['wrapper_ms']:.4f} ms")
    # the plan on either side of its crossover: (5, 6, n) at every n
    per_n = {}
    for n in REDESIGN_NS:
        t = _ntt_rows(n, "(5,6,n)", dev)
        x = _uniform(rng, [4 * q for q in t.values], (5, 6, n), dev)
        per_n[str(n)] = a_profile(t, x)
    log("[35] A at (5,6,n) forward, device us a call (launches): " + ", ".join(
        f"n = {n} {r['device_us']:.1f} ({r['launches']})"
        for n, r in per_n.items()))
    # M, every form, beside the one PyTorch call of the same gather
    q5 = ntt.RnsNttTables.from_moduli(
        N, [int(m) for m in P.CoeffModulus.create(N, Q_BITS[:5])], dev)
    m_x = _uniform(rng, q5.values, (2, 5, N), dev)
    perm = galois.ntt_permutation(N, 3, dev)
    c_table, n_table = galois.coeff_table(N, 3, dev), galois.ntt_table(
        N, 3, dev)
    elts = tuple(galois_util.get_elt_from_step(N, s) for s in range(1, 17))
    hoist_x = _uniform(rng, q5.values, (16, 2, 5, N), dev)
    unsigned = galois.batched_tables(N, elts, dev, False)
    signed = galois.batched_tables(N, elts, dev, True)
    index = galois.unpack_table(unsigned)[0].reshape(16, 1, 1, N).expand(
        hoist_x.shape)
    forms = {
        "signed (2,5,n)": (lambda: galois.permute(m_x, c_table, q5),
                           lambda: m_x.index_select(-1, perm)),
        "unsigned (2,5,n)": (lambda: galois.permute(m_x, n_table),
                             lambda: m_x.index_select(-1, perm)),
        "batched unsigned (16,2,5,n)": (
            lambda: galois.permute_batched(hoist_x, unsigned, q5),
            lambda: hoist_x.gather(-1, index)),
        "batched signed (16,2,5,n)": (
            lambda: galois.permute_batched(hoist_x, signed, q5),
            lambda: hoist_x.gather(-1, index)),
    }
    m_forms = {}
    for form, (kernel, library) in forms.items():
        _, _, each = device_kernels_per_op(
            kernel, reps=20, expect={"galois_permute_kernel": 1}, whole=True)
        us = each["galois_permute_kernel"][1]
        ms = alternating_ms({"ms": kernel, "library_ms": library})
        m_forms[form] = {**ms, "device_us_per_launch": us,
                         "device_us": graph_us(kernel),
                         "library_device_us": graph_us(library)}
        log(f"[35] M {form}: wrapper {ms['ms']:.4f} ms, library "
            f"{ms['library_ms']:.4f} ms (in turns, this process); device "
            f"{m_forms[form]['device_us']:.2f} us a call (graph; profiler "
            f"{us:.2f} us a launch), library "
            f"{m_forms[form]['library_device_us']:.2f} us")

    # the launch path: host us to enqueue one call
    tiny = ntt.RnsNttTables.from_moduli(
        64, [int(P.CoeffModulus.create(64, [40])[0])], dev)
    a64 = _uniform(rng, tiny.values, (1, 1, 64), dev)
    t6 = _ntt_rows(N, "(5,6,n)", dev)
    x6 = _uniform(rng, [4 * q for q in t6.values], (5, 6, N), dev)
    host = {"D add (1,1,64)": host_us(lambda: poly.rns_add(a64, a64, tiny)),
            "M unsigned (2,5,n)": host_us(lambda: galois.permute(m_x,
                                                                 n_table)),
            "A forward (5,6,n)": host_us(
                lambda: ntt.rns_ntt_forward(x6, t6)),
            "index_select (2,5,n)": host_us(
                lambda: m_x.index_select(-1, perm))}
    log("[35] host us to enqueue one call: " + ", ".join(
        f"{k} {v:.1f}" for k, v in host.items()))
    j = redesign_j(dev, rng)
    e = redesign_e(dev, rng)
    b = redesign_b(dev)
    check_b_launches(b)
    o1 = redesign_o1(dev, rng, per_op)
    p1 = redesign_p1(app_ctx, rng)
    f = redesign_f(dev, rng)
    kp = redesign_kp(divide_ops)
    zero = redesign_zero(zero_ctxs)
    o3 = redesign_o3(dev, rng, zero_ctxs["ckks"])
    afi = redesign_afi(dev, rng, bfv_ops)
    axi = redesign_decrypt("AXi", dev, rng, decrypt_ops["bgv"])
    aci = redesign_decrypt("ACi", dev, rng, decrypt_ops["bfv"])
    standalone = standalone_decrypt(dev, rng)
    wall = decrypt_wall()
    agp = redesign_agp(zero_ctxs["bgv"], app_ctx, rng)
    ap2i = redesign_ap2i(app_ctx, rng)
    p2 = standalone_p2(dev, rng)
    ao2p = redesign_ao2p(zero_ctxs["ckks"], rng)
    embed = redesign_embed(zero_ctxs["bfv"], rng)
    ao4p = redesign_ao4p(zero_ctxs["ckks"], rng)
    k_alone = standalone_k(dev, rng)
    kpp_alone = standalone_kpp(dev, rng)
    spread = op_spread(divide_ops)
    return {"a_checks": checks, "a_shapes": per_shape, "a_per_n": per_n,
            "m_forms": m_forms, "host_enqueue_us": host, "j": j, "e": e,
            "b": b, "o1": o1, "p1": p1, "f": f, "kp": kp, "zero": zero,
            "o3": o3, "afi": afi, "axi": axi, "aci": aci,
            "standalone_decrypt": standalone, "decrypt_wall": wall,
            "agp": agp, "ap2i": ap2i, "standalone_p2": p2,
            "ao2p": ao2p, "embed": embed, "ao4p": ao4p,
            "standalone_k": k_alone,
            "standalone_kpp": kpp_alone,
            "spread": spread}


SPREAD_TRACES = 8


def op_spread(ops: dict) -> dict:
    """Phase 35: how far one op's profiled device time moves within this
    process, operands unchanged: each op's trace (as phase 10 and 14 take
    it) taken SPREAD_TRACES times, its device us and A's us a launch; the
    floor under which a difference between two runs says nothing."""
    out = {}
    for op in ("ckks_rotate_vector", "bgv_rotate_rows"):
        rows = []
        for _ in range(SPREAD_TRACES):
            _, ms, each = device_kernels_per_op(
                ops[op], expect={"ntt_pass_kernel": None}, whole=True)
            rows.append((ms * 1e3, each["ntt_pass_kernel"][1]))
        out[op] = rows
        log(f"[35] spread of {op} over {SPREAD_TRACES} traces in this "
            f"process: device {min(r[0] for r in rows):.2f}-"
            f"{max(r[0] for r in rows):.2f} us, A "
            f"{min(r[1] for r in rows):.2f}-{max(r[1] for r in rows):.2f} "
            "us a launch")
    return out


# --------------------------------------------------------------------------
# phase 35, kernels D and I: the compositions their fused forms replace,
# on the single D steps and the single draws (the words of the fused
# forms; the launches, stacks and copies of the path before)
# --------------------------------------------------------------------------

def composed_zero_sym(a_seeds, e_seeds, sk, cd, ntt_form: bool):
    """(c0, c1): two draws, B, A, then D's add and negate."""
    t = cd.ntt
    a = sampling.sample_uniform_rns(a_seeds, t)
    e = sampling.sample_cbd_rns(e_seeds, t, rlwe._noise_scale(cd))
    as_ntt = ntt.dyadic_mac(sk[:cd.limbs].unsqueeze(0), a.unsqueeze(0), t)
    if ntt_form:
        return poly.rns_neg(poly.rns_add(as_ntt, ntt.rns_ntt_forward(e, t),
                                         t), t), a
    both = ntt.rns_ntt_inverse(torch.stack([as_ntt, a]), t)
    return poly.rns_neg(poly.rns_add(both[0], e, t), t), both[1]


def composed_embed(m, c0, cd):
    """c0 + the plaintext: G (BFV), D's add (CKKS), G', A and D's add
    (BGV)."""
    t = cd.ntt
    if cd.scheme == P.SchemeType.bfv:
        return poly.bfv_plain_embed(
            m, c0, int(cd.plain_modulus), cd.coeff_modulus_mod_plain_modulus,
            cd.coeff_div_plain_modulus, t)
    if cd.scheme == P.SchemeType.ckks:
        return poly.rns_add(c0, m, t)
    tt = int(cd.plain_modulus)
    lifted = poly.plain_lift(m, t, tt, tt, cd.total_coeff_modulus)
    return poly.rns_add(c0, ntt.rns_ntt_forward(lifted, t), t)


def composed_encrypt_sym(seeds, m, sk, cd, ntt_form: bool):
    c0, c1 = composed_zero_sym(seeds[0], seeds[1], sk, cd, ntt_form)
    return torch.stack([composed_embed(m, c0, cd), c1])


def composed_encrypt_many(a_seeds, e_seeds, m, sk, cd, ntt_form: bool):
    c0, c1 = composed_zero_sym(a_seeds, e_seeds, sk, cd, ntt_form)
    return torch.stack([composed_embed(m, c0, cd), c1], dim=1)


def composed_encrypt_asym(seeds, m, pk, cd, ntt_form: bool):
    """u's draw and transform, B, one draw per e_j and their stack, A or
    A's inverse, D's add, the embed and a cat."""
    t = cd.ntt
    u_ntt = ntt.rns_ntt_forward(sampling.sample_ternary_rns(seeds[0], t), t)
    prods = ntt.dyadic_mac(u_ntt.unsqueeze(0), pk.unsqueeze(0), t)
    e = torch.stack([sampling.sample_cbd_rns(s, t, rlwe._noise_scale(cd))
                     for s in seeds[1:]])
    zero = (poly.rns_add(prods, ntt.rns_ntt_forward(e, t), t) if ntt_form
            else poly.rns_add(ntt.rns_ntt_inverse(prods, t), e, t))
    return torch.cat([composed_embed(m, zero[0], cd).unsqueeze(0),
                      zero[1:]])


def composed_key_rows(a_seeds, e_seeds, w, sk, key_cd):
    c0, c1 = composed_zero_sym(a_seeds, e_seeds, sk, key_cd, True)
    return keygen._add_special_terms(c0, c1, w, key_cd)


def composed_balanced_add(x, y, e1, e2, t, subtract: bool):
    op = poly.rns_sub if subtract else poly.rns_add
    return op(poly.rns_broadcast_scalar_mul(x, e1, t),
              poly.rns_broadcast_scalar_mul(y, e2, t), t)


def _zero_inputs(ctx, rng):
    """A secret and public key (host keygen), MANY plaintexts' words and the
    level of a scheme's encryptions."""
    kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(DEFAULT_SEED + 35))
    pk = kg.create_public_key()
    if ctx.scheme == P.SchemeType.ckks:
        enc = P.CKKSEncoder(ctx)
        plains = [enc.encode(rng.uniform(-1, 1, N // 2), CKKS_SCALE)
                  for _ in range(MANY)]
        cd = ctx.get_context_data(plains[0].level)
    else:
        enc = P.BatchEncoder(ctx)
        plains = [enc.encode(rng.integers(0, enc.plain_modulus, N,
                                          dtype=np.uint64))
                  for _ in range(MANY)]
        cd = ctx.first_context_data
    return kg, pk, torch.stack([p.data for p in plains]), cd


def _in_turns(fused, composed) -> dict:
    """Both calls' words compared, their device us a call in turns (graph
    replay, 4 rounds), their device kernels and copies a call
    (profiler), I's, D's, DG's and G's launches a call (counters)."""
    compare("words", fused(), composed())
    calls = {"fused": fused, "composed": composed}
    turns = {name: [] for name in calls}
    for r in range(4):
        for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            turns[name].append(graph_us(calls[name]))
    out = {"device_us_turns": turns}
    for name, fn in calls.items():
        _kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        count, device_ms, each = device_kernels_per_op(fn, reps=10,
                                                       whole=True)
        out[name] = {"device_us": statistics.median(turns[name]),
                     "kernels": count, "profiler_us": device_ms * 1e3,
                     "I": counts["I_sampling"],
                     "D": counts["D_rns_elementwise"],
                     "DG": counts.get("DG_zero_embed", 0),
                     "G": counts["G_plain_embed"],
                     "foreign": foreign_kernels(each), "each": each}
    return out


def redesign_zero(ctxs: dict) -> dict:
    """Phase 35, kernels D and I redesigned around the zero encryptions:
    each fused path word-equal to the composition it replaces (two draws,
    the single D steps, the stacks), both timed in turns (graph replay)
    with their device kernels, copies and I and D launches a call: the
    symmetric encryption of each scheme, the public-key encryption,
    encrypt_symmetric_many's batch of MANY, a device switching-key row set
    (BFV and BGV), BGV's balanced add and sub, and the bare draws at (5, n)
    and (MANY, 5, n) beside their bounds."""
    rng = np.random.default_rng(SEED + 36)
    seed = lambda: int(rng.integers(0, 2 ** 64, dtype=np.uint64))
    dev_seeds = lambda count: to_torch(rng.integers(
        0, 2 ** 64, count, dtype=np.uint64), ctxs["bfv"].device)
    out = {}

    def record(tag, fused, composed, bound_fn=None, want=(1, 1),
               embeds=False):
        """want: the fused path's I and finish (D, or DG) launches a call;
        embeds: a BFV encryption, whose finish is DG's, with no G."""
        r = _in_turns(fused, composed)
        f = r["fused"]
        if (f["I"], f["D"] + f["DG"]) != want or \
                (f["DG"], f["G"]) != ((1, 0) if embeds else (0, 0)):
            raise AssertionError(f"zero {tag}: I, D, DG and G launch "
                                 f"{f['I']}, {f['D']}, {f['DG']}, {f['G']} "
                                 f"times a call, not {want} and "
                                 f"{'one DG' if embeds else 'no DG'}")
        if bound_fn is not None:
            b = launch_bounds(bound_fn)["I_sampling"]
            r["bound_us"] = b[1] / b[0]
        out[tag] = r
        f, c = r["fused"], r["composed"]
        bound = (f", bound {r['bound_us']:.3f} us" if "bound_us" in r
                 else "")
        log(f"[35] zero {tag}: word-equal to the composition; device us a "
            f"call in turns (graph): fused {f['device_us']:.2f}, composed "
            f"{c['device_us']:.2f}; kernels a call (profiler) {f['kernels']:g}"
            f" against {c['kernels']:g}, I {f['I']} against {c['I']}, D "
            f"{f['D']} against {c['D']}, DG {f['DG']} against {c['DG']}, G "
            f"{f['G']} against {c['G']}, other kernels and copies "
            f"{f['foreign'] or 0} against {c['foreign'] or 0}{bound}")

    for name, ctx in ctxs.items():
        kg, pk, m, cd = _zero_inputs(ctx, rng)
        sk = kg.secret_key.data
        ntt_form = ctx.scheme != P.SchemeType.bfv
        pk_k = pk.data[:, :cd.limbs].contiguous()
        sym = (seed(), seed())
        record(f"{name} encrypt_symmetric (2,{cd.limbs},n)",
               lambda: encryptor._encrypt_sym_full(sym, m[0], sk, cd,
                                                   ntt_form),
               lambda: composed_encrypt_sym(sym, m[0], sk, cd, ntt_form),
               embeds=not ntt_form)
        asym = (seed(), seed(), seed())
        record(f"{name} encrypt (2,{cd.limbs},n)",
               lambda: encryptor._encrypt_asym_full(asym, m[0], pk_k, cd,
                                                    ntt_form),
               lambda: composed_encrypt_asym(asym, m[0], pk_k, cd,
                                             ntt_form),
               embeds=not ntt_form)
        a_seeds, e_seeds = dev_seeds(MANY), dev_seeds(MANY)
        record(f"{name} encrypt_symmetric_many ({MANY},2,{cd.limbs},n)",
               lambda: encryptor._encrypt_sym_batch(a_seeds, e_seeds, m, sk,
                                                    cd, ntt_form),
               lambda: composed_encrypt_many(a_seeds, e_seeds, m, sk, cd,
                                             ntt_form),
               embeds=not ntt_form)
        if name in ("bfv", "bgv"):
            key_cd = ctx.key_context_data
            d = key_cd.limbs - 1
            ka, ke = dev_seeds(d), dev_seeds(d)
            w = kg._sk_power(2)
            record(f"{name} switching-key rows ({d},2,{key_cd.limbs},n)",
                   lambda: keygen._kswitch_key_core(ka, ke, w, sk, key_cd),
                   lambda: composed_key_rows(ka, ke, w, sk, key_cd))
    bgv_cd = ctxs["bgv"].first_context_data
    x, y = (_uniform(rng, bgv_cd.ntt.values, (2, bgv_cd.limbs, N),
                     ctxs["bgv"].device) for _ in range(2))
    for subtract in (False, True):
        record(f"bgv balanced {'sub' if subtract else 'add'} (2,5,n)",
               lambda s=subtract: poly.balanced_add(x, y, 3, 786431,
                                                    bgv_cd.ntt, s),
               lambda s=subtract: composed_balanced_add(x, y, 3, 786431,
                                                        bgv_cd.ntt, s),
               want=(0, 1))
    t5 = ctxs["ckks"].first_context_data.ntt
    one = (seed(), seed())
    record("I draw (2,5,n), one seed pair",
           lambda: tuple(zero_sym_draw(one[0], one[1], t5)),
           lambda: (sampling.sample_cbd_rns(one[1], t5),
                    sampling.sample_uniform_rns(one[0], t5)),
           lambda: zero_sym_draw(one[0], one[1], t5), (1, 0))
    ma, me = dev_seeds(MANY), dev_seeds(MANY)
    record(f"I draw (2,{MANY},5,n), {MANY} seed pairs",
           lambda: tuple(zero_sym_draw(ma, me, t5)),
           lambda: (sampling.sample_cbd_rns(me, t5),
                    sampling.sample_uniform_rns(ma, t5)),
           lambda: zero_sym_draw(ma, me, t5), (1, 0))
    return out


def redesign_kp(ops: dict) -> dict:
    """Phase 35, K' and K'-BGV folded into A's forward passes (AKp,
    ``rns.ntt_forward_divide``): every fused forward of one run of each op
    (the CKKS and BGV headline's mult+relin, rescale or mod switch and
    rotation) recorded with its operands; at each distinct shape the fused
    forward word-equal to the unfused composition on K''s own kernels
    (temps, A's lazy forward, finish), the two timed in turns (device us a
    call, graph replay) with their device us a launch (profiler), beside
    the fused op's bound: last, x's k rows and the accumulator in, the
    result out and A's twiddles once; A's butterfly products, and K''s 4
    (K'-BGV's 9) products a word."""
    seen = {}
    fused = rns.ntt_forward_divide

    def record(entry, x, last, tables, consts, acc=None, group=None):
        key = (entry, tuple(x.shape),
               None if acc is None else tuple(acc.shape), group)
        if key not in seen:
            seen[key] = ((x.clone(), last.clone(), tables, consts,
                          None if acc is None else acc.clone(), group), [])
        seen[key][1].append(op)
        return fused(entry, x, last, tables, consts, acc, group)

    rns.ntt_forward_divide = record
    try:
        for op, fn in ops.items():
            fn()
    finally:
        rns.ntt_forward_divide = fused
    torch.cuda.synchronize()
    uses = {use[2]: use for use in (rns.RESCALE, rns.KEYSWITCH,
                                    rns.BGV_MOD_SWITCH, rns.BGV_KEYSWITCH)}
    out = {}
    for (entry, xs, accs, group), (args, names) in seen.items():
        x, last, t, consts, acc, g = args
        temps_entry, finish_entry, _ = uses[entry]
        bgv = temps_entry.startswith("troy_bgv")
        k, s = t.k, x.shape[0]
        calls = {
            "fused": lambda: fused(entry, x, last, t, consts, acc, g),
            "unfused": lambda: rns._ntt_finish(
                finish_entry, x, ntt.rns_ntt_forward(
                    rns._ntt_temps(temps_entry, last, consts), t, lazy=True),
                consts[:5 * k + 2], acc, g)}
        tag = f"{entry[len('troy_ntt_forward_'):]} {xs} acc {accs}"
        try:
            compare("words", calls["fused"](), calls["unfused"]())
        except AssertionError as exc:
            raise AssertionError(f"AKp {tag}: {exc}") from None
        turns = {name: [] for name in calls}
        for r in range(4):
            for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                turns[name].append(graph_us(calls[name]))
        passes = len(ntt.launch_blocks(s * k, t.n))
        temps_kernel = "bgv_temps_kernel" if bgv else "temps_kernel"
        _, _, each_f = device_kernels_per_op(
            calls["fused"], reps=10, expect={"ntt_pass_kernel": passes},
            whole=True)
        _, _, each_u = device_kernels_per_op(
            calls["unfused"], reps=10,
            expect={temps_kernel: 1, "ntt_pass_kernel": passes,
                    "finish_kernel": 1}, whole=True)
        words = s * k * t.n
        bound_ms, bound_by = bound(
            _bytes(last) + words * 8 * (2 if acc is None else 3)
            + 2 * k * t.n * 8,
            ntt_rows_mul64(s * k) + words * (9 if bgv else 4))
        r = {"ops": sorted(set(names)), "calls": len(names),
             "device_us_turns": turns,
             "fused_us": statistics.median(turns["fused"]),
             "unfused_us": statistics.median(turns["unfused"]),
             "fused_us_per_launch": each_f["ntt_pass_kernel"][1],
             "ntt_us_per_launch": each_u["ntt_pass_kernel"][1],
             "temps_us_per_launch": each_u[temps_kernel][1],
             "finish_us_per_launch": each_u["finish_kernel"][1],
             "bound_ms": bound_ms, "bound_by": bound_by}
        out[tag] = r
        log(f"[35] AKp {tag} ({', '.join(r['ops'])}): word-equal to K''s "
            f"temps + A + finish; device us a call in turns (graph): fused "
            f"{r['fused_us']:.2f}, unfused {r['unfused_us']:.2f}; a launch "
            f"(profiler): fused passes {r['fused_us_per_launch']:.2f}, A's "
            f"passes {r['ntt_us_per_launch']:.2f}, temps "
            f"{r['temps_us_per_launch']:.2f}, finish "
            f"{r['finish_us_per_launch']:.2f}; bound {bound_ms * 1e3:.2f} us "
            f"({bound_by})")
    return out


def redesign_p1(app_ctx, rng) -> dict:
    """Phase 35, kernel P1 (the tiled contraction, csrc/tiles.cu) at the app
    protocol's conv2d, BIG matmul and matmul shapes (phase 20 holds each to
    its plain version): its device us a launch (profiler) and a call
    (graph replay) beside its bound. The bound: the
    tiles in and the products out once over the memory rate, and 2 I
    products a word and a Barrett-128 (7) per 63 terms and at the end."""
    q = app_ctx.first_context_data.ntt
    k, dev = q.k, app_ctx.device
    out = {}
    for tag, X, I, Y in REDESIGN_P1_SHAPES:
        a = _uniform(rng, q.values, (X, I, 2, k, N), dev)
        w = _uniform(rng, q.values, (I, Y, k, N), dev)
        call = lambda: tiles.tile_contract(a, w, q)
        _, _, each = device_kernels_per_op(
            call, reps=5, expect={"tile_contract_kernel": 1}, whole=True)
        words = X * Y * 2 * k * N
        bound_ms, bound_by = bound(
            (a.numel() + w.numel() + words) * 8,
            words * (2 * I + 7 * (-(-I // 63))))
        r = {"shape": f"({X},{I},2,{k},n) x ({I},{Y},{k},n)",
             "us_per_launch": each["tile_contract_kernel"][1],
             "device_us": graph_us(call, calls=5), "bound_ms": bound_ms,
             "bound_by": bound_by}
        out[tag] = r
        log(f"[35] P1 {tag} {r['shape']}: {r['us_per_launch']:.1f} us a "
            f"launch (profiler), {r['device_us']:.1f} us a call (graph), "
            f"bound {bound_ms * 1e3:.1f} us ({bound_by}), "
            f"{r['us_per_launch'] / (bound_ms * 1e3):.2f} times it")
        del a, w
    torch.cuda.empty_cache()
    return out


def redesign_f(dev, rng) -> dict:
    """Phase 35, kernel F: its digits folded into A's first pass (AF,
    ``rns_ntt_forward_digits``) word-equal to F's digits then A's forward
    at REDESIGN_F_SHAPES, the two timed in turns (device us a
    call, graph replay) with their device us a launch (profiler). F's
    divide on A's route is AFi's (redesign_afi)."""
    fused = {}
    for tag, n, spec, rows in REDESIGN_F_SHAPES:
        t = ntt.RnsNttTables.from_moduli(n, _moduli(n, spec), dev,
                                         use_mxu=False)
        x = _uniform(rng, t.values[:rows], (rows, n), dev)
        calls = {"fused": lambda: ntt.rns_ntt_forward_digits(x, t),
                 "two_launch": lambda: ntt.rns_ntt_forward(
                     keyswitch.keyswitch_digits(x, t), t)}
        try:
            compare("words", calls["fused"](), calls["two_launch"]())
        except AssertionError as exc:
            raise AssertionError(f"AF at {tag}: {exc}") from None
        turns = {name: [] for name in calls}
        for r in range(4):
            for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                turns[name].append(graph_us(calls[name]))
        _, _, each_f = device_kernels_per_op(
            calls["fused"], reps=10, expect={"ntt_pass_kernel": 2},
            whole=True)
        _, _, each_t = device_kernels_per_op(
            calls["two_launch"], reps=10,
            expect={"keyswitch_digits_kernel": 1, "ntt_pass_kernel": 2},
            whole=True)
        lg = n.bit_length() - 1
        out_rows = rows * t.k
        bound_ms, bound_by = bound(
            (rows * n + out_rows * n + 2 * t.k * n) * 8,
            out_rows * ((n // 2) * lg * 3 + n * 3 + n * 2))
        r = {"device_us_turns": turns,
             "fused_us": statistics.median(turns["fused"]),
             "two_launch_us": statistics.median(turns["two_launch"]),
             "fused_us_per_launch": each_f["ntt_pass_kernel"][1],
             "digits_us_per_launch": each_t["keyswitch_digits_kernel"][1],
             "ntt_us_per_launch": each_t["ntt_pass_kernel"][1],
             "bound_ms": bound_ms, "bound_by": bound_by}
        fused[tag] = r
        log(f"[35] AF {tag}: word-equal to F's digits + A; "
            f"device us a call in turns (graph): fused {r['fused_us']:.2f}, "
            f"two-launch {r['two_launch_us']:.2f}; a launch (profiler): "
            f"fused passes {r['fused_us_per_launch']:.2f}, F's digits "
            f"{r['digits_us_per_launch']:.2f}, A's passes "
            f"{r['ntt_us_per_launch']:.2f}; bound {bound_ms * 1e3:.2f} us "
            f"({bound_by})")

    return {"fused": fused}


def _fused_turns(tag: str, fused, composed, kf: dict, kc: dict,
                 work: tuple, calls: int = 20, extra: Optional[dict] = None
                 ) -> dict:
    """One fused call against its composition (and ``extra`` calls): the
    words compared, device us a call of each in turns (graph replay of
    ``calls`` calls, 4 rounds), device us a launch (profiler; kf, kc: the
    kernels of each a call), beside the fused call's bound."""
    try:
        compare("words", fused(), composed())
    except AssertionError as exc:
        raise AssertionError(f"{tag}: {exc}") from None
    calls_ = {"fused": fused, "composed": composed, **(extra or {})}
    turns = _turns(calls_, graph_calls=calls)
    _, _, each_f = device_kernels_per_op(fused, reps=5, expect=kf,
                                         whole=True)
    _, _, each_c = device_kernels_per_op(composed, reps=5, expect=kc,
                                         whole=True)
    bound_ms, bound_by = bound(*work)
    r = {"device_us_turns": turns,
         **{f"{name}_us": statistics.median(v) for name, v in turns.items()},
         "fused_each": each_f, "composed_each": each_c,
         "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"[35] {tag}: word-equal to the composition; device us a call in "
        "turns (graph): " + ", ".join(f"{name} {r[name + '_us']:.2f}"
                                      for name in calls_)
        + "; a launch (profiler): fused " + ", ".join(
            f"{k} {us:.2f}" for k, (_, us) in each_f.items())
        + "; composed " + ", ".join(f"{k} {us:.2f}"
                                    for k, (_, us) in each_c.items())
        + f"; bound {bound_ms * 1e3:.2f} us ({bound_by})")
    return r


def redesign_agp(bgv_ctx, app_ctx, rng) -> dict:
    """Phase 35, AGp (G''s lift in A's first forward pass,
    ``ntt.rns_ntt_forward_lift``) at REDESIGN_AGP_SHAPES, word-equal to G'
    then A's forward, the two timed in turns with A's forward alone on the
    lifted rows (the difference is the first pass's: AGp's reads the
    source rows, A's the k-limb rows G' wrote), their device us a launch
    (profiler) beside AGp's bound."""
    out = {}
    for tag, which, lead in REDESIGN_AGP_SHAPES:
        cd = (bgv_ctx if which == "bgv" else app_ctx).first_context_data
        t, tt, Q = cd.ntt, int(cd.plain_modulus), cd.total_coeff_modulus
        half = cd.plain_upper_half_threshold
        m = to_torch(rng.integers(0, tt, lead + (N,), dtype=np.uint64),
                     t.device)
        lifted = poly.plain_lift(m, t, tt, half, Q)
        big = bool(lead) and lead[0] > 8
        out[tag] = _fused_turns(
            f"AGp {tag}", lambda: ntt.rns_ntt_forward_lift(m, t, tt, half,
                                                           Q),
            lambda: ntt.rns_ntt_forward(poly.plain_lift(m, t, tt, half, Q),
                                        t),
            {"ntt_pass_kernel": 2},
            {"plain_lift_kernel": 1, "ntt_pass_kernel": 2},
            lift_work(t, m.numel() // N), calls=5 if big else 20,
            extra={"A_alone": lambda: ntt.rns_ntt_forward(lifted, t)})
        del m, lifted
        torch.cuda.empty_cache()
    return out


def redesign_ao2p(ckks_ctx, rng) -> dict:
    """Phase 35, AO2p (O2's rounding in A's first forward pass,
    ``embedding.rns_ntt_forward_round``) at the CKKS headline's (n) ->
    (5,n): the slot encode's (an untwist) word-equal to O2 then A's
    forward, and the polynomial encode's (float64 words, no untwist)
    word-equal to its old route, the complex copy, O2 with a unit untwist,
    then A; each timed in turns with its composition and with A alone on
    the rounded rows, their device us a launch (profiler) beside AO2p's
    bound."""
    cd = ckks_ctx.first_context_data
    t, dev = cd.ntt, ckks_ctx.device
    emb = embedding.make_embed_tables(N, dev)
    rt = embedding.make_rns_round_tables(t)
    u = torch.from_numpy((rng.uniform(-1, 1, N) + 1j * rng.uniform(-1, 1, N))
                         * 2.0 ** -7).to(dev)
    c = torch.from_numpy(rng.uniform(-1, 1, N) * 2.0 ** 10).to(dev)
    rows = embedding.untwist_round_to_rns(u, CKKS_SCALE, emb, rt)
    out = {"slot (n)->(5,n)": _fused_turns(
        "AO2p slot encode (n)->(5,n)",
        lambda: embedding.rns_ntt_forward_round(u, emb.untwist, CKKS_SCALE,
                                                rt, t),
        lambda: ntt.rns_ntt_forward(embedding.untwist_round_to_rns(
            u, CKKS_SCALE, emb, rt), t),
        {"ntt_pass_kernel": 2}, {"round_kernel": 1, "ntt_pass_kernel": 2},
        round_work(t, True),
        extra={"A_alone": lambda: ntt.rns_ntt_forward(rows, t)})}
    out["polynomial (n)->(5,n)"] = _fused_turns(
        "AO2p polynomial encode (n)->(5,n)",
        lambda: embedding.rns_ntt_forward_round(c, None, CKKS_SCALE, rt, t),
        lambda: ntt.rns_ntt_forward(embedding.round_to_rns(c, CKKS_SCALE,
                                                           rt), t),
        {"ntt_pass_kernel": 2}, {"round_kernel": 1, "ntt_pass_kernel": 2},
        round_work(t, False),
        extra={"A_alone": lambda: ntt.rns_ntt_forward(rows, t)})
    return out


def _bits(result: tuple) -> tuple:
    """(words, a 0-d float64 statistic) with the statistic as its int64
    bit pattern (a view), for a word-for-word comparison."""
    return result[0], result[1].view(torch.int64)


def redesign_embed(bfv_ctx, rng) -> dict:
    """Phase 35, G and DG redesigned (the BFV plain embedding on D's grid,
    and folded into D's zero-encryption finish): DG's symmetric finish at
    (5, n), a batch of MANY into c0 with c1 copied and the public-key
    finish (2, 5, n), each word-equal to D's finish then G, the two timed
    in turns (graph); G at m (n) onto c0 (5, n), a batch of MANY and
    add_plain's new ciphertext (2, 5, n) with c1 copied, each word-equal to
    its plain version, timed in turns with D's add at (5, n) (the launch
    floor); device us a launch (profiler) beside the bounds."""
    data = bfv_ctx.first_context_data
    q5, dev = data.ntt, bfv_ctx.device
    m1, args = embed_inputs(rng, data, q5, dev, ())
    mb, _ = embed_inputs(rng, data, q5, dev, (MANY,))
    x, y = (_uniform(rng, q5.values, (5, N), dev) for _ in range(2))
    xb, yb, c1b = (_uniform(rng, q5.values, (MANY, 5, N), dev)
                   for _ in range(3))
    ct = _uniform(rng, q5.values, (2, 5, N), dev)
    one = torch.empty((2, 5, N), dtype=torch.int64, device=dev)
    batch = torch.empty((MANY, 2, 5, N), dtype=torch.int64, device=dev)

    def batch_finish():
        poly.zero_sym_embed(xb, yb, mb, *args, out=batch[:, 0], c1=c1b)
        return batch

    def batch_composed():
        c0 = poly.bfv_plain_embed(mb, poly.zero_sym_finish(xb, yb, q5),
                                  *args)
        return torch.stack([c0, c1b], dim=1)

    def asym_composed():
        c = poly.zero_asym_finish(ct, xb[:2], q5)
        c[0] = poly.bfv_plain_embed(m1, c[0], *args)
        return c

    dg_k = {"zero_embed_kernel": 1}
    out = {"DG symmetric (5,n)": _fused_turns(
        "DG symmetric finish (5,n) into c0",
        lambda: poly.zero_sym_embed(x, y, m1, *args, out=one[0]),
        lambda: poly.bfv_plain_embed(m1, poly.zero_sym_finish(x, y, q5),
                                     *args),
        dg_k, {"rns_elementwise_kernel": 1, "plain_embed_kernel": 1},
        embed_work(q5, 1, 2, 1))}
    out[f"DG symmetric ({MANY},5,n)"] = _fused_turns(
        f"DG symmetric finish ({MANY},5,n) into c0, c1 copied",
        batch_finish, batch_composed, dg_k,
        {"rns_elementwise_kernel": 1, "plain_embed_kernel": 1},
        embed_work(q5, MANY, 3, 2))
    out["DG public key (2,5,n)"] = _fused_turns(
        "DG public-key finish (2,5,n)",
        lambda: poly.zero_asym_embed(ct, xb[:2], m1, *args), asym_composed,
        dg_k, {"rns_elementwise_kernel": 1, "plain_embed_kernel": 1},
        embed_work(q5, 2, 2, 1))
    for tag, run, plain, work in (
            ("G m (n) onto c0 (5,n)",
             lambda: poly.bfv_plain_embed(m1, x, *args),
             lambda: poly.bfv_multiply_add_plain(m1, x, *args),
             embed_work(q5, 1, 1, 1)),
            (f"G m ({MANY},n) onto c0 ({MANY},5,n)",
             lambda: poly.bfv_plain_embed(mb, xb, *args),
             lambda: poly.bfv_multiply_add_plain(mb, xb, *args),
             embed_work(q5, MANY, 1, 1)),
            ("G add_plain (2,5,n), c1 copied",
             lambda: poly.bfv_plain_embed_c0(ct, m1, *args),
             lambda: torch.cat([poly.bfv_multiply_add_plain(
                 m1, ct[0], *args).unsqueeze(0), ct[1:]]),
             embed_work(q5, 1, 2, 2))):
        try:
            compare("words", run(), plain())
        except AssertionError as exc:
            raise AssertionError(f"{tag}: {exc}") from None
        turns = _turns({"G": run, "D add (5,n)": lambda: poly.rns_add(
            x, y, q5)})
        _, _, each = device_kernels_per_op(
            run, reps=10, expect={"plain_embed_kernel": 1}, whole=True)
        bound_ms, bound_by = bound(*work)
        out[tag] = {"device_us_turns": turns,
                    "G_us": statistics.median(turns["G"]),
                    "D_add_us": statistics.median(turns["D add (5,n)"]),
                    "us_per_launch": each["plain_embed_kernel"][1],
                    "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"[35] {tag}: word-equal to its plain version; device us a call "
            f"in turns (graph): G {out[tag]['G_us']:.2f}, D's add (5,n) "
            f"{out[tag]['D_add_us']:.2f}; a launch (profiler) "
            f"{out[tag]['us_per_launch']:.2f}; bound {bound_ms * 1e3:.2f} us "
            f"({bound_by})")
    return out


def redesign_ao4p(ckks_ctx, rng) -> dict:
    """Phase 35, AO4p (O4's statistic with AO2p's rounding in A's forward
    passes, ``embedding.rns_ntt_forward_round_stats``) at the CKKS
    headline's (n) -> (5,n): word-equal, the statistic bit for bit, to O4
    (its memset and launch) then A's forward, timed in turns with that
    composition and with AO2p (no statistic), their device us a launch
    (profiler) beside the bound."""
    cd = ckks_ctx.first_context_data
    t, dev = cd.ntt, ckks_ctx.device
    emb = embedding.make_embed_tables(N, dev)
    rt = embedding.make_rns_round_tables(t)
    u = torch.from_numpy((rng.uniform(-1, 1, N) + 1j * rng.uniform(-1, 1, N))
                         * 2.0 ** -7).to(dev)

    def composed():
        words, stat = embedding.untwist_round_to_rns_stats(u, CKKS_SCALE,
                                                           emb, rt)
        return _bits((ntt.rns_ntt_forward(words, t), stat))

    work = round_work(t, True)
    return {"slot (n)->(5,n)": _fused_turns(
        "AO4p encode_with_stats (n)->(5,n)",
        lambda: _bits(embedding.rns_ntt_forward_round_stats(
            u, emb.untwist, CKKS_SCALE, rt, t)), composed,
        {"ntt_pass_kernel": 2}, {"round_kernel": 1, "ntt_pass_kernel": 2},
        (work[0] + 8,) + work[1:],
        extra={"AO2p": lambda: embedding.rns_ntt_forward_round(
            u, emb.untwist, CKKS_SCALE, rt, t)})}


def standalone_k(dev, rng) -> dict:
    """Phase 35, K's own kernel (``keyswitch.divide_and_round_q_last``, the
    BFV mod switch) at STANDALONE_K_SHAPES: word-equal to its plain
    version, its device us a call (graph replay) and a launch (profiler)
    beside the bound (x in, the result out; 5 products a word and limb)
    and the bound's share. Written on the wrappers that the earlier trees
    have too, so that it times those trees' K in turns with this one."""
    out = {}
    for tag, n, spec, comps in STANDALONE_K_SHAPES:
        moduli = _moduli(n, spec)
        if spec == "bfv_default":
            moduli = moduli[:-1]               # the first data level's
        t = ntt.RnsNttTables.from_moduli(n, moduli, dev)
        k = t.k - 1
        x = _uniform(rng, t.values, (comps, t.k, n), dev)
        consts = keyswitch.divide_round_consts(t.slice(0, k), t.values[-1])
        fn = lambda: keyswitch.divide_and_round_q_last(x, t)
        try:
            compare("words", fn(), keyswitch.divide_round_last_plain(
                x, consts))
        except AssertionError as exc:
            raise AssertionError(f"K {tag}: {exc}") from None
        _, _, each = device_kernels_per_op(
            fn, reps=10, expect={"divide_round_kernel": 1}, whole=True)
        us = each["divide_round_kernel"][1]
        bound_ms, bound_by = bound((comps * (2 * k + 1) * n) * 8,
                                   comps * k * n * 5)
        r = {"device_us": graph_us(fn), "us_per_launch": us,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "bound_share": bound_ms * 1e3 / us}
        out[tag] = r
        log(f"[35] standalone K {tag}: word-equal to its plain version; "
            f"{r['device_us']:.2f} us a call (graph), {us:.2f} us a launch "
            f"(profiler); bound {bound_ms * 1e3:.3f} us ({bound_by}), "
            f"{100 * r['bound_share']:.1f} % of the launch")
        del x
        torch.cuda.empty_cache()
    return out


def redesign_ap2i(app_ctx, rng) -> dict:
    """Phase 35, AP2i (P2 in A's first inverse pass,
    ``ntt.rns_ntt_inverse_pair_convolve``) at REDESIGN_AP2I_SHAPES over
    q u Bsk with lazy words, word-equal to P2 then A's inverse, the two
    timed in turns with P2 alone, their device us a launch (profiler)
    beside AP2i's bound."""
    qb = app_ctx.first_context_data.rns.q_bsk
    lazy = [4 * v for v in qb.values]
    out = {}
    for tag, X, Y, s1, s2 in REDESIGN_AP2I_SHAPES:
        a = _uniform(rng, lazy, (X, s1, qb.k, N), app_ctx.device)
        w = _uniform(rng, lazy, (Y, s2, qb.k, N), app_ctx.device)
        out[tag] = _fused_turns(
            f"AP2i {tag}",
            lambda: ntt.rns_ntt_inverse_pair_convolve(a, w, qb),
            lambda: ntt.rns_ntt_inverse(tiles.tile_pair_convolve(a, w, qb),
                                        qb),
            {"inverse_pair_kernel": 1, "ntt_pass_kernel": 1},
            {"tile_pair_convolve_kernel": 1, "ntt_pass_kernel": 2},
            pair_work(a, w, qb),
            extra={"P2": lambda: tiles.tile_pair_convolve(a, w, qb)})
    return out


def standalone_p2(dev, rng) -> dict:
    """Phase 35, P2's own kernel (the CKKS and BGV pair grids, J's route)
    at REDESIGN_P2_SHAPES: device us a call (graph replay) and a launch
    (profiler) beside the bound (the tiles in, the products out; 2
    products a term and a Barrett-128 (7) an output word) and the bound's
    share of the launch. Written on the wrappers that the earlier trees
    have too, so that it can time those trees' kernel in turns with this
    one."""
    cd = app_context(P.SchemeType.bfv).first_context_data
    out = {}
    for tag, X, Y, bsk in REDESIGN_P2_SHAPES:
        t = cd.rns.q_bsk if bsk else cd.ntt
        bounds = [4 * v for v in t.values] if bsk else list(t.values)
        a = _uniform(rng, bounds, (X, 2, t.k, N), dev)
        w = _uniform(rng, bounds, (Y, 2, t.k, N), dev)
        fn = lambda: tiles.tile_pair_convolve(a, w, t)
        _, _, each = device_kernels_per_op(
            fn, reps=10, expect={"tile_pair_convolve_kernel": 1}, whole=True)
        words = X * Y * 3 * t.k * N
        bound_ms, bound_by = bound(*tile_work(
            a, w, words, X * Y * t.k * N * (4 * 2 + 3 * 7)))
        us = each["tile_pair_convolve_kernel"][1]
        r = {"device_us": graph_us(fn), "us_per_launch": us,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "bound_share": bound_ms * 1e3 / us}
        out[tag] = r
        log(f"[35] standalone P2 {tag}: {r['device_us']:.2f} us a call "
            f"(graph), {us:.2f} us a launch (profiler); bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by}), "
            f"{100 * r['bound_share']:.1f} % of the launch")
    return out


def redesign_o3(dev, rng, ckks_ctx) -> dict:
    """Phase 35, kernel O3 (the centred CRT composition: one rounded
    multiple of Q, the constants in shared memory): at every data level of
    the CKKS headline chain and at REDESIGN_O3_SHAPES, bit-equal to its
    plain version on random residues with crt_values in the first
    coefficients; its device us a call (graph replay) and a launch
    (profiler) beside its bound: the residues in and the f64 values out
    once, the accumulator's products (phase 7)."""
    shapes = []
    for level in range(ckks_ctx.first_level, ckks_ctx.last_level + 1):
        t = ckks_ctx.get_context_data(level).ntt
        shapes.append((f"({t.k},{t.n}) CKKS level {level}", t))
    for tag, n, spec, k in REDESIGN_O3_SHAPES:
        shapes.append((tag, ntt.RnsNttTables.from_moduli(
            n, _moduli(n, spec)[:k], dev, use_mxu=False)))
    out = {}
    for tag, t in shapes:
        rt = embedding.make_rns_round_tables(t)
        k, n = t.k, t.n
        words = to_numpy(_uniform(rng, t.values, (k, n), dev))
        for i, v in enumerate(crt_values(rt.total, rng)):
            words[:, i] = [v % q for q in t.values]
        res = to_torch(words, dev)
        call = lambda: embedding.compose_centered(res, rt, 2.0 ** -40)
        try:
            compare("bits", call(), embedding.compose_centered_plain(
                res, rt, 2.0 ** -40))
        except AssertionError as exc:
            raise AssertionError(f"O3 at {tag}: {exc}") from None
        _, _, each = device_kernels_per_op(
            call, reps=10, expect={"compose_kernel": 1}, whole=True)
        bound_ms, bound_by = bound(_bytes(res) + n * 8,
                                   n * k * (2 + 2 * rt.words))
        r = {"k": k, "n": n, "words": rt.words, "device_us": graph_us(call),
             "us_per_launch": each["compose_kernel"][1],
             "bound_ms": bound_ms, "bound_by": bound_by}
        out[tag] = r
        log(f"[35] O3 {tag}, W = {rt.words}: bit-equal to its plain version;"
            f" {r['device_us']:.2f} us a call (graph), "
            f"{r['us_per_launch']:.2f} us a launch (profiler); bound "
            f"{bound_ms * 1e3:.3f} us ({bound_by})")
    return out


def redesign_afi(dev, rng, bfv_ops: dict) -> dict:
    """Phase 35, AFi (F's divide folded into A's last inverse pass,
    ``keyswitch.ntt_inverse_divide_round``): every call of one run of the
    BFV headline's mult+relin, rotate_rows(1) and apply_galois_many
    recorded with its operands, each op launching AFi once a key switch
    and F's divide never (entry counters); then at each distinct shape,
    the batched fold's (REDESIGN_FOLD_MS) and REDESIGN_AFI_SHAPES, AFi
    word-equal to A's inverse then F's divide, the two timed in turns
    (device us a call, graph replay) with their device us a launch
    (profiler), beside the fused call's bound: the products and the
    accumulator in, the result out and the inverse twiddles once; A's
    butterfly products and F's 5 a word."""
    seen, per_op = {}, {}
    fused = keyswitch.ntt_inverse_divide_round

    def record(x, rows, consts, acc=None, group=None):
        key = (tuple(x.shape), None if acc is None else tuple(acc.shape),
               group)
        if key not in seen:
            seen[key] = ((x.clone(), rows, consts,
                          None if acc is None else acc.clone(), group), [])
        seen[key][1].append(op)
        per_op[op] += 1
        return fused(x, rows, consts, acc, group)

    keyswitch.ntt_inverse_divide_round = record
    try:
        for op, fn in bfv_ops.items():
            per_op[op] = 0
            _kernels.reset_launch_counts()
            fn()
            torch.cuda.synchronize()
            entries = _kernels.entry_launch_counts()
            got = (entries["troy_ntt_inverse_keyswitch"],
                   entries["troy_keyswitch_divide_round"])
            if got != (per_op[op], 0):
                raise AssertionError(
                    f"AFi: {op} launched AFi {got[0]} times and F's divide "
                    f"{got[1]} times in {per_op[op]} key switches")
            log(f"[35] AFi: {op} launched AFi once in each of its "
                f"{per_op[op]} key switches, F's divide never")
    finally:
        keyswitch.ntt_inverse_divide_round = fused
    if not any(per_op.values()):
        raise AssertionError("AFi: the BFV ops ran no key switch on it")
    args = next(iter(seen.values()))[0]
    rows, consts = args[1], args[2]
    k = rows.k - 1
    for m in REDESIGN_FOLD_MS:
        x = _uniform(rng, rows.values, (2 * m, k + 1, N), dev)
        acc = _uniform(rng, rows.values[:k], (m, 1, k, N), dev)
        seen[(tuple(x.shape), tuple(acc.shape), 2)] = (
            (x, rows, consts, acc, 2), [f"batched fold of {m}"])
    for tag, n, spec, s in REDESIGN_AFI_SHAPES:
        moduli = _moduli(n, spec)
        t = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=False)
        kk = t.k - 1
        x = _uniform(rng, moduli, (s, kk + 1, n), dev)
        acc = _uniform(rng, moduli[:kk], (2, kk, n), dev)
        seen[(tuple(x.shape), tuple(acc.shape), None)] = (
            (x, t, keyswitch.divide_round_consts(t.slice(0, kk), moduli[kk]),
             acc, None), [tag])
    out = {}
    for (xs, accs, group), (args, ops) in seen.items():
        x, t, c, acc, g = args
        s, kk, n = x.shape[0], t.k - 1, t.n
        calls = {"fused": lambda: fused(x, t, c, acc, g),
                 "composed": lambda: keyswitch.divide_round_last(
                     ntt.rns_ntt_inverse(x, t), c, acc, g)}
        tag = f"{xs} acc {accs} group {group}"
        try:
            compare("words", calls["fused"](), calls["composed"]())
        except AssertionError as exc:
            raise AssertionError(f"AFi {tag}: {exc}") from None
        turns = {name: [] for name in calls}
        for r in range(4):
            for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                turns[name].append(graph_us(calls[name]))
        passes = len(ntt.launch_blocks(s * t.k, n, True))
        expect = {"inverse_divide_kernel": 1}
        if passes > 1:
            expect["ntt_pass_kernel"] = passes - 1
        _, _, each_f = device_kernels_per_op(calls["fused"], reps=10,
                                             expect=expect, whole=True)
        _, _, each_c = device_kernels_per_op(
            calls["composed"], reps=10,
            expect={"ntt_pass_kernel": passes, "divide_round_kernel": 1},
            whole=True)
        words = s * kk * n
        bound_ms, bound_by = bound(
            _bytes(x) + (0 if acc is None else _bytes(acc)) + words * 8
            + 2 * t.k * n * 8, ntt_rows_mul64(s * t.k) + words * 5)
        r = {"ops": sorted(set(ops)), "calls": len(ops),
             "device_us_turns": turns,
             "fused_us": statistics.median(turns["fused"]),
             "composed_us": statistics.median(turns["composed"]),
             "fused_last_pass_us": each_f["inverse_divide_kernel"][1],
             "fused_first_pass_us": (each_f["ntt_pass_kernel"][1]
                                     if passes > 1 else None),
             "a_us_per_launch": each_c["ntt_pass_kernel"][1],
             "divide_us_per_launch": each_c["divide_round_kernel"][1],
             "bound_ms": bound_ms, "bound_by": bound_by}
        out[tag] = r
        first = ("" if r["fused_first_pass_us"] is None else
                 f"first pass {r['fused_first_pass_us']:.2f}, ")
        log(f"[35] AFi {tag} ({', '.join(r['ops'])}): word-equal to A's "
            f"inverse + F's divide; device us a call in turns (graph): "
            f"fused {r['fused_us']:.2f}, composed {r['composed_us']:.2f}; a "
            f"launch (profiler): fused {first}last pass "
            f"{r['fused_last_pass_us']:.2f}; A's passes "
            f"{r['a_us_per_launch']:.2f}, F's divide "
            f"{r['divide_us_per_launch']:.2f}; bound {bound_ms * 1e3:.2f} us "
            f"({bound_by})")
    return {"key_switches": per_op, "shapes": out}


def _decrypt_level(n: int, moduli: list, t: int, dev) -> tuple:
    """A's tables of a level's primes, X's converter to t and the BFV
    tool with t (the decrypt's constants)."""
    host = rns_util.make_rns_tool(n, tuple(moduli), t)
    tables = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=False)
    bsk = ntt.RnsNttTables.from_moduli(n, host.base_Bsk.values, dev,
                                       use_mxu=False)
    return (tables, rns.ExactConverter.build(host.conv_q_to_t, dev),
            rns.DeviceRnsTool.build(host, tables, bsk))


def _decrypt_calls(kind: str, x: torch.Tensor, args: tuple):
    """(fused, composed, the kernels of each a call, bound of the fused
    call) of one decrypt shape: AXi against A's inverse then X, or ACi
    against A's inverse then C and E's rounding. The bound: the phase in,
    the words out and the inverse twiddles once, or A's butterfly products
    and X's (7 k + 9) or C's and E's (7 k + 21) a coefficient."""
    tables = args[0] if kind == "AXi" else args[0].q
    k, n = tables.k, tables.n
    passes = len(ntt.launch_blocks(x.numel() // n, n, True))
    fused_kernels = {"inverse_decrypt_kernel": 1}
    if passes > 1:
        fused_kernels["ntt_pass_kernel"] = passes - 1
    if kind == "AXi":
        conv, inv_cf = args[1], args[2]
        fused = lambda: rns.ntt_inverse_decrypt_mod_t(x, tables, conv,
                                                      inv_cf)
        composed = lambda: rns.decrypt_mod_t(ntt.rns_ntt_inverse(x, tables),
                                             conv, inv_cf)
        composed_kernels = {"ntt_pass_kernel": passes,
                            "exact_convert_kernel": 1}
        per_coeff = 7 * k + 9
    else:
        tool = args[0]
        fused = lambda: rns.ntt_inverse_decrypt_scale_and_round(x, tool)
        composed = lambda: rns.decrypt_scale_and_round(
            ntt.rns_ntt_inverse(x, tables), tool)
        composed_kernels = {"ntt_pass_kernel": passes,
                            "base_convert_kernel": 1,
                            "behz_decrypt_round_kernel": 1}
        per_coeff = 7 * k + 21
    comps = x.numel() // (k * n)
    work = bound(_bytes(x) + comps * n * 8 + 2 * k * n * 8,
                 ntt_rows_mul64(comps * k, n) + comps * n * per_coeff)
    return fused, composed, fused_kernels, composed_kernels, work


def _turns(calls: dict, rounds: int = 4, graph_calls: int = 20) -> dict:
    """Device us a call of each, in turns (graph replay of graph_calls
    calls)."""
    turns = {name: [] for name in calls}
    for r in range(rounds):
        for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            turns[name].append(graph_us(calls[name], calls=graph_calls))
    return turns


def redesign_decrypt(kind: str, dev, rng, ops: dict) -> dict:
    """Phase 35, AXi (X's exact conversion in A's last inverse pass,
    ``rns.ntt_inverse_decrypt_mod_t``) or ACi (C's conversion and E's
    rounding there, ``rns.ntt_inverse_decrypt_scale_and_round``): each op
    of ``ops`` (a decrypt and a decrypt_many of the headline's BGV or BFV)
    launching the fused entry once and X, C or E's rounding never (entry
    counters); then at every shape the count windows' decrypts gave
    (DECRYPTS: the BFV, BGV, plain-op, LWE and app windows; fresh words
    over the recorded level), at the headline's (3,5,n) and batch of 52
    at k = 2, at SEAL's (1,15,32768) and at the ceiling's (1,2,131072)
    and (1,2,262144) on A's tables, the fused call word-equal to the
    composition (A's inverse, then X, or C and E's rounding), the two
    timed in turns (graph replay) with their device us a launch
    (profiler), beside the fused call's bound, and the host us to enqueue
    each, in turns."""
    entry = DECRYPTS.ENTRIES[kind]
    absent = ("troy_exact_convert", "troy_base_convert",
              "troy_behz_decrypt_round")
    for op, fn in ops.items():
        _kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        entries = _kernels.entry_launch_counts()
        got = (entries[entry], *(entries[e] for e in absent))
        if got != (1, 0, 0, 0):
            raise AssertionError(f"{kind}: {op} launched {entry}, X, C and "
                                 f"E's rounding {got} times, not (1, 0, 0, "
                                 "0)")
        log(f"[35] {kind}: {op} launched {entry} once and X, C and E's "
            "rounding never")
    if not DECRYPTS.seen[kind]:
        raise AssertionError(f"{kind}: the windows made no call of it")
    shapes = {}
    for shape, (cd, inv_cf, windows) in DECRYPTS.seen[kind].items():
        x = _uniform(rng, cd.ntt.values, shape, dev)
        args = ((cd.ntt, cd.exact_to_t, inv_cf) if kind == "AXi"
                else (cd.rns,))
        shapes[shape] = ((x,) + args, sorted(windows))
    for tag, n, spec, k, lead in (
            ("headline", N, Q_BITS, 5, 3), ("headline", N, Q_BITS, 2, 52),
            ("SEAL", 32768, "bfv_default", 15, 1),
            ("ceiling", 131072, CEILING_Q_BITS, 2, 1),
            ("ceiling", 262144, CEILING_Q_BITS, 2, 1)):
        if (lead, k, n) in shapes:
            shapes[(lead, k, n)][1].append(tag)
            continue
        t = int(P.PlainModulus.batching(n, 20 if n <= 32768 else 30))
        tables, conv, tool = _decrypt_level(n, _moduli(n, spec)[:k], t, dev)
        x = _uniform(rng, tables.values, (lead, k, n), dev)
        args = (tables, conv, pow(7, -1, t)) if kind == "AXi" else (tool,)
        shapes[(lead, k, n)] = ((x,) + args, [tag])
    out = {}
    for shape, (args, windows) in shapes.items():
        x, rest = args[0], args[1:]
        fused, composed, kf, kc, (bound_ms, bound_by) = _decrypt_calls(
            kind, x, rest)
        tag = f"{shape} ({', '.join(windows)})"
        try:
            compare("words", fused(), composed())
        except AssertionError as exc:
            raise AssertionError(f"{kind} {tag}: {exc}") from None
        turns = _turns({"fused": fused, "composed": composed})
        host = {"fused": [], "composed": []}
        for i in range(4):
            for name in (("fused", "composed") if i % 2 == 0
                         else ("composed", "fused")):
                host[name].append(host_us(
                    fused if name == "fused" else composed, reps=100))
        _, _, each_f = device_kernels_per_op(fused, reps=10, expect=kf,
                                             whole=True)
        _, _, each_c = device_kernels_per_op(composed, reps=10, expect=kc,
                                             whole=True)
        r = {"windows": windows, "device_us_turns": turns,
             "fused_us": statistics.median(turns["fused"]),
             "composed_us": statistics.median(turns["composed"]),
             "fused_each": each_f, "composed_each": each_c,
             "host_us_turns": host,
             "fused_host_us": statistics.median(host["fused"]),
             "composed_host_us": statistics.median(host["composed"]),
             "bound_ms": bound_ms, "bound_by": bound_by}
        out[str(shape)] = r
        first = ("" if "ntt_pass_kernel" not in each_f else
                 f"first pass {each_f['ntt_pass_kernel'][1]:.2f}, ")
        log(f"[35] {kind} {tag}: word-equal to the composition; device us a "
            f"call in turns (graph): fused {r['fused_us']:.2f}, composed "
            f"{r['composed_us']:.2f}; a launch (profiler): fused {first}"
            f"last pass {each_f['inverse_decrypt_kernel'][1]:.2f}; composed "
            + ", ".join(f"{name} {us:.2f}" for name, (_, us) in each_c.items())
            + f"; bound {bound_ms * 1e3:.2f} us ({bound_by}); host us to "
            f"enqueue a call in turns: fused {r['fused_host_us']:.1f}, "
            f"composed {r['composed_host_us']:.1f}")
    return {"shapes": out, "windows": DECRYPTS.counts}


def standalone_decrypt(dev, rng) -> dict:
    """Phase 35, the standalone X and C (with E's rounding) that J's route
    and the levels past the fused pass's caps run, at the J-route shapes:
    a BGV decrypt at the headline's (1,5,16384) and the ceiling's
    (1,2,262144), each a coefficient-form phase through X, or C then E's
    rounding: device us a call (graph replay) and a launch (profiler)
    beside the bound (the phase in, the words out; X's or C's and E's
    products). Written on the wrappers that the earlier trees have too, so
    that it can time those trees' kernels in turns with these."""
    out = {}
    for tag, n, bits in (("(1,5,16384)", N, Q_BITS[:5]),
                         ("(1,2,262144)", 262144, CEILING_Q_BITS[:2])):
        t = int(P.PlainModulus.batching(n, 20 if n <= 32768 else 30))
        moduli = [int(m) for m in P.CoeffModulus.create(n, bits)]
        host = rns_util.make_rns_tool(n, tuple(moduli), t)
        tables = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=False)
        tool = rns.DeviceRnsTool.build(host, tables, ntt.RnsNttTables.
                                       from_moduli(n, host.base_Bsk.values,
                                                   dev, use_mxu=False))
        conv = rns.ExactConverter.build(host.conv_q_to_t, dev)
        k = len(moduli)
        x = _uniform(rng, moduli, (1, k, n), dev)
        tg = rns.fast_convert(x, tool.q_to_t_gamma_scaled)
        calls = {
            "X": (lambda: rns.exact_convert(x, conv, 7),
                  {"exact_convert_kernel": 1}, n * (7 * k + 9)),
            "C": (lambda: rns.fast_convert(x, tool.q_to_t_gamma_scaled),
                  {"base_convert_kernel": 1}, n * (7 * k + 10)),
            "E rounding": (lambda: rns.behz_decrypt_round(tg, tool),
                           {"behz_decrypt_round_kernel": 1}, n * 11)}
        for name, (fn, expect, mul64) in calls.items():
            _, _, each = device_kernels_per_op(fn, reps=10, expect=expect,
                                               whole=True)
            result = fn()
            bound_ms, bound_by = bound(_bytes(x if name != "E rounding"
                                              else tg, result), mul64)
            r = {"device_us": graph_us(fn),
                 "us_per_launch": each[next(iter(expect))][1],
                 "bound_ms": bound_ms, "bound_by": bound_by}
            out[f"{name} {tag}"] = r
            log(f"[35] standalone {name} {tag}: {r['device_us']:.2f} us a "
                f"call (graph), {r['us_per_launch']:.2f} us a launch "
                f"(profiler); bound {bound_ms * 1e3:.3f} us ({bound_by})")
    return out


def decrypt_wall(rounds: int = 4) -> dict:
    """The headline's BFV decrypt of a relinearized product (k = 5) and
    BGV decrypt of its mod switch (k = 4, correction factor != 1) as a
    user waits for each: the median of CUDA events around each call
    (``cuda_ms``, as phase 13 times ``bgv_decrypt``: the host's enqueue
    included) and the host us to enqueue one (``host_us``), the two ops
    in turns ``rounds`` times. Written on the package's public API alone,
    so that it times an earlier tree's package too (PERF.md: the parent
    and this tree in turns)."""
    calls = {}
    for scheme in ("bfv", "bgv"):
        ctx = P.HeContext(P.EncryptionParameters(
            scheme=getattr(P.SchemeType, scheme), poly_modulus_degree=N,
            coeff_modulus=tuple(P.CoeffModulus.create(N, Q_BITS)),
            plain_modulus=P.PlainModulus.batching(N, 20)))
        kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(SEED + 40))
        be, ev = P.BatchEncoder(ctx), P.Evaluator(ctx)
        enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                          seed=rnd.seed_from_uint64(SEED + 41))
        t = int(be.plain_modulus)
        a = np.arange(N, dtype=np.uint64) % t
        ct = enc.encrypt_symmetric(be.encode(a))
        ct = ev.relinearize(ev.multiply(ct, ct), kg.create_relin_keys())
        if scheme == "bgv":
            ct = ev.mod_switch_to_next(ct)
        dec = P.Decryptor(ctx, kg.secret_key)
        want = (a.astype(object) ** 2 % t).astype(np.uint64)
        if not np.array_equal(be.decode(dec.decrypt(ct)), want):
            raise AssertionError(f"{scheme} decrypt: wrong slots")
        calls["decrypt" if scheme == "bfv" else "bgv_decrypt"] = (
            lambda dec=dec, ct=ct: dec.decrypt(ct))
    turns = {op: {"ms": [], "host_us": []} for op in calls}
    for r in range(rounds):
        for op in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            turns[op]["ms"].append(cuda_ms(calls[op]))
            turns[op]["host_us"].append(host_us(calls[op]))
    for op, v in turns.items():
        log(f"[35] {op} as a user waits: {statistics.median(v['ms']):.4f} "
            f"ms a call (CUDA events, median of {rounds} medians of "
            f"{TIMING_REPS}: " + ", ".join(f"{x:.4f}" for x in v["ms"])
            + f"); host enqueue {statistics.median(v['host_us']):.1f} us")
    return turns


B_KERNELS = ("dyadic_mac_kernel", "dyadic_convolve_kernel",
             "dyadic_convolve_any_kernel")
B_WRAPPERS = ("dyadic_mac", "dyadic_mac_batched", "dyadic_convolve")
B_SEED = 2036                        # redesign_b's keys and encryptions
B_PACK = 16                          # the LWE pack of redesign_b


def _b_ops(dev) -> dict:
    """The ops whose B launches redesign_b reads, on headline contexts of
    the three schemes made here (keys on the card from B_SEED): each
    scheme's mult+relin, the BFV and BGV decrypt and decrypt_many of 3,
    the BFV symmetric and public-key encrypt, BGV's multiply_plain, and a
    BGV LWE pack of B_PACK (its batched folds)."""
    ops = {}
    for i, scheme in enumerate(("bfv", "ckks", "bgv")):
        ckks = scheme == "ckks"
        extra = {} if ckks else {
            "plain_modulus": P.PlainModulus.batching(N, 20)}
        ctx = P.HeContext(P.EncryptionParameters(
            scheme=getattr(P.SchemeType, scheme), poly_modulus_degree=N,
            coeff_modulus=tuple(P.CoeffModulus.create(N, Q_BITS)), **extra),
            device=dev)
        kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(B_SEED + 10 * i))
        rlk, pk = kg.create_relin_keys(), kg.create_public_key()
        enc = P.Encryptor(ctx, public_key=pk, secret_key=kg.secret_key,
                          seed=rnd.seed_from_uint64(B_SEED + 10 * i + 1))
        ev, dec = P.Evaluator(ctx), P.Decryptor(ctx, kg.secret_key)
        rng = np.random.default_rng(B_SEED + i)
        if ckks:
            enc_ = P.CKKSEncoder(ctx)
            pts = [enc_.encode(rng.uniform(-1, 1, N // 2), CKKS_SCALE)
                   for _ in range(2)]
        else:
            enc_ = P.BatchEncoder(ctx)
            pts = [enc_.encode(rng.integers(0, enc_.plain_modulus, N,
                                            dtype=np.uint64))
                   for _ in range(2)]
        ca, cb = (enc.encrypt_symmetric(p) for p in pts)
        ops[f"{scheme}_mult_relin"] = (
            lambda ev=ev, ca=ca, cb=cb, rlk=rlk:
            ev.relinearize(ev.multiply(ca, cb), rlk))
        if scheme == "bfv":
            ops["bfv_encrypt_symmetric"] = (
                lambda enc=enc, p=pts[0]: enc.encrypt_symmetric(p))
            ops["bfv_encrypt"] = lambda enc=enc, p=pts[0]: enc.encrypt(p)
        if ckks:
            continue
        rel = ev.relinearize(ev.multiply(ca, cb), rlk)
        ops[f"{scheme}_decrypt"] = lambda dec=dec, rel=rel: dec.decrypt(rel)
        ops[f"{scheme}_decrypt_many3"] = (
            lambda dec=dec, cts=(rel, ca, cb): dec.decrypt_many(cts))
        if scheme == "bgv":
            ops["bgv_multiply_plain"] = (
                lambda ev=ev, ca=ca, p=pts[1]: ev.multiply_plain(ca, p))
            gk = kg.create_galois_keys(
                elts=[(1 << j) + 1 for j in range(1, N.bit_length())])
            coeffs = ev.transform_from_ntt(ca)
            lwes = ev.extract_lwe_many(coeffs, list(range(B_PACK)))
            ops["bgv_pack_lwe16"] = (
                lambda ev=ev, lwes=lwes, gk=gk:
                ev.pack_lwe_ciphertexts(lwes, gk))
    return ops


def redesign_b(dev) -> dict:
    """Phase 35, kernel B at the main path's shapes (``_b_ops``): every
    call of B's wrappers in one run of each op recorded with its
    arguments; then each distinct call's device us a launch (profiler,
    B's device functions) and what else its call ran (the earlier trees'
    copies), beside its bound: the words the call must move (each term's
    rows of a read once, b's once for each component, the addend, the
    output; a square's operand once) over 3.35 TB/s; and each op's B
    launches, B's device us and the op's device us (profiler). Written on
    the wrappers and ops the earlier trees have too, so that
    tools/compare_trees.py b times their B in turns with this tree's."""
    ops = _b_ops(dev)
    wrapped = {w: getattr(ntt, w) for w in B_WRAPPERS if hasattr(ntt, w)}
    calls, op_name = {}, [None]

    def recorder(name):
        def record(*args, **kw):
            shapes = (tuple(tuple(a.shape) for a in args[:2]),
                      tuple(sorted((k, tuple(v.shape)) for k, v in kw.items()
                                   if isinstance(v, torch.Tensor))))
            calls.setdefault((name, shapes), (args, kw, set()))[2].add(
                op_name[0])
            return wrapped[name](*args, **kw)
        return record

    try:
        for name in wrapped:
            setattr(ntt, name, recorder(name))
        for op_name[0], fn in ops.items():
            fn()
    finally:
        for name, fn in wrapped.items():
            setattr(ntt, name, fn)
    torch.cuda.synchronize()
    shapes = {}
    for (name, (arg_shapes, kw_shapes)), (args, kw, in_ops) in calls.items():
        fn = wrapped[name]
        _, ms, each = device_kernels_per_op(
            lambda: fn(*args, **kw), reps=10, expect=None, whole=True)
        b = {k: v for k, v in each.items() if k in B_KERNELS}
        launches = sum(c for c, _ in b.values())
        if not launches:
            raise AssertionError(f"{name}: no launch of B's device "
                                 f"functions in its trace: {sorted(each)}")
        us = sum(c * t for c, t in b.values()) / launches
        words = b_call_words(name, args, kw)
        bound_ms, bound_by = bound(words * 8, 0)
        tag = (f"{name} {' x '.join(str(s) for s in arg_shapes)}"
               + "".join(f", {k} {v}" for k, v in kw_shapes))
        shapes[tag] = {
            "ops": sorted(in_ops), "launches_a_call": launches,
            "us_per_launch": us, "call_device_us": ms * 1e3,
            "other_us": ms * 1e3 - launches * us, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms * 1e3 / us}
        log(f"[35] B {tag} ({', '.join(sorted(in_ops))}): {launches:g} "
            f"launch(es) of {us:.2f} us, the call {ms * 1e3:.2f} us of "
            f"device time; bound {bound_ms * 1e3:.2f} us ({bound_by}), "
            f"{100 * bound_ms * 1e3 / us:.1f} % of a launch")
    per_op = {}
    for op, fn in ops.items():
        _kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        _, ms, each = device_kernels_per_op(fn, reps=5, expect=None,
                                            whole=True)
        b_us = sum(c * t for k, (c, t) in each.items() if k in B_KERNELS)
        per_op[op] = {"b_launches": counts["B_dyadic_mac"],
                      "d_launches": counts["D_rns_elementwise"],
                      "b_us": b_us, "device_us": ms * 1e3}
        log(f"[35] B in {op}: {counts['B_dyadic_mac']} launches, "
            f"{b_us:.2f} us of the op's {ms * 1e3:.2f} us of device time "
            f"(D {counts['D_rns_elementwise']} launches)")
    return {"shapes": shapes, "ops": per_op}


def b_call_words(name: str, args: tuple, kw: dict) -> int:
    """The words one call of a B wrapper must move: each term's rows of a
    once, b's once for each component it is read for, the addend, the
    output; a square's operand once."""
    if name == "dyadic_convolve":
        a, b = args[0], args[1]
        square = a.data_ptr() == b.data_ptr() and a.shape == b.shape
        out = a.shape[:-3] + (a.shape[-3] + b.shape[-3] - 1,) + a.shape[-2:]
        return a.numel() + (0 if square else b.numel()) + math.prod(out)
    add = kw.get("addend")
    if name == "dyadic_mac_batched":
        key, targets = args[0], args[1]
        k = targets.shape[-2]
        out = targets.shape[0] * key.shape[1] * k * targets.shape[-1]
        key_words = key.shape[0] * key.shape[1] * k * key.shape[-1]
        return (targets.numel() + key_words + out
                + (add.numel() if add is not None else 0))
    a, b = args[0], args[1]
    k = a.shape[-2]
    out = math.prod(b.shape[1:-2]) * k * a.shape[-1]
    return (a.numel() + b.shape[0] * out + out
            + (add.numel() if add is not None else 0))


def check_b_launches(b: dict) -> None:
    """B's launch counts in redesign_b's ops: two a mult+relin (the
    convolution and the key switch's inner product), one a decrypt with
    no D launch (c0 in B's sum)."""
    ops = b["ops"]
    for scheme in ("bfv", "ckks", "bgv"):
        got = ops[f"{scheme}_mult_relin"]["b_launches"]
        if got != 2:
            raise AssertionError(f"{scheme} mult+relin launches B {got} "
                                 "times, not 2")
    for op in ("bfv_decrypt", "bgv_decrypt", "bfv_decrypt_many3",
               "bgv_decrypt_many3"):
        if (ops[op]["b_launches"], ops[op]["d_launches"]) != (1, 0):
            raise AssertionError(f"{op}: B {ops[op]['b_launches']} and D "
                                 f"{ops[op]['d_launches']} launches, not 1 "
                                 "and 0")
    log("[35] B launches twice a mult+relin of each scheme and once a "
        "decrypt or decrypt_many, with no D launch")


# phase 35 (B and K'' redesigned): K'''s own kernel at the LWE window's
# folds (the coefficient-form BGV key switch of m pairs, onto c0 of each
# pair) and the BGV mod switch's divide at the headline (tag, m pairs or
# None for the mod switch)
STANDALONE_KPP_SHAPES = (("fold of 8 (16,6,n) onto (8,1,5,n)", 8),
                         ("fold of 4 (8,6,n) onto (4,1,5,n)", 4),
                         ("fold of 1 (2,6,n) onto (1,1,5,n)", 1),
                         ("q_last (2,5,n)->(2,4,n)", None))


def standalone_kpp(dev, rng) -> dict:
    """Phase 35, K'''s own kernel (``keyswitch.bgv_divide_last``) at
    STANDALONE_KPP_SHAPES on the BGV headline's primes: word-equal to its
    plain version, its device us a call (graph replay) and a launch
    (profiler) beside the bound (x, the accumulator and the constants
    read, the result written, over 3.35 TB/s) and the bound's share.
    Written on the wrappers that the earlier trees have too, so that it
    times those trees' K'' in turns with this one."""
    moduli = _moduli(N, Q_BITS)
    tt = int(P.PlainModulus.batching(N, 20))
    key = ntt.RnsNttTables.from_moduli(N, moduli, dev)
    out = {}
    for tag, m in STANDALONE_KPP_SHAPES:
        if m is None:
            level = key.slice(0, 5)
            consts = keyswitch.bgv_divide_consts(level.slice(0, 4),
                                                 moduli[4], tt)
            x, acc, group = _uniform(rng, moduli[:5], (2, 5, N), dev), None, \
                None
        else:
            level = key.slice(0, 5)
            consts = keyswitch.bgv_divide_consts(level, moduli[-1], tt)
            x = _uniform(rng, moduli[:5] + moduli[-1:], (2 * m, 6, N), dev)
            acc, group = _uniform(rng, moduli[:5], (m, 1, 5, N), dev), 2
        fn = lambda: keyswitch.bgv_divide_last(x, consts, acc, group)
        try:
            compare("words", fn(), keyswitch.bgv_divide_last_plain(
                x, consts, acc, group))
        except AssertionError as exc:
            raise AssertionError(f"K'' {tag}: {exc}") from None
        _, _, each = device_kernels_per_op(
            fn, reps=10, expect={"bgv_divide_kernel": 1}, whole=True)
        us = each["bgv_divide_kernel"][1]
        k = x.shape[1] - 1
        words = x.numel() + x.shape[0] * k * N + consts.numel() + (
            acc.numel() if acc is not None else 0)
        bound_ms, bound_by = bound(words * 8, x.shape[0] * N * (2 + 6 * k))
        r = {"device_us": graph_us(fn), "us_per_launch": us,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "bound_share": bound_ms * 1e3 / us}
        out[tag] = r
        log(f"[35] standalone K'' {tag}: word-equal to its plain version; "
            f"{r['device_us']:.2f} us a call (graph), {us:.2f} us a launch "
            f"(profiler); bound {bound_ms * 1e3:.3f} us ({bound_by}), "
            f"{100 * r['bound_share']:.1f} % of the launch")
    return out


def j_work(t, rows: int) -> tuple:
    """(bytes, 64-bit products) of one transform of ``rows`` rows per limb
    on J: the words in and out once, each limb's butterfly tables and its
    twiddle grid with their Shoup words once; per row (n/2) log2 n
    butterflies of 3 products, the entry reduction (2) and the grid
    product (3) a word."""
    n = t.n
    nbytes = 2 * rows * t.k * n * 8 + t.k * (2 * n + 2 * (t.mxu[0].a
                                                          + t.mxu[0].b)) * 8
    return nbytes, rows * t.k * (n // 2 * (n.bit_length() - 1) * 3 + 5 * n)


def sharded_transform(x: torch.Tensor, mxus: list, ptrs: list, a: int,
                      b: int, inverse: bool) -> torch.Tensor:
    """J's transform of x (..., k, n) as the coefficient regime runs it
    over len(mxus) ranks, the all-to-alls done in this process: each
    rank's stages on its own blocks and tables (parallel/sharding.py
    _CoeffNtt)."""
    w = len(mxus)
    y = x.reshape(x.shape[:-1] + (a, b))
    cols = lambda v, i: v[..., :, i * b // w:(i + 1) * b // w].contiguous()
    rows = lambda v, i: v[..., i * a // w:(i + 1) * a // w, :].contiguous()
    run = lambda v, i, stage: ntt_mxu.rns_mxu_stage(v, mxus[i], ptrs[i],
                                                    stage)
    if inverse:
        y = torch.cat([run(rows(y, i), i, "inverse_right")
                       for i in range(w)], dim=-2)
        y = torch.cat([run(cols(y, i), i, "inverse_left")
                       for i in range(w)], dim=-1)
    else:
        y = torch.cat([run(cols(y, i), i, "forward_left")
                       for i in range(w)], dim=-1)
        y = torch.cat([run(rows(y, i), i, "forward_right")
                       for i in range(w)], dim=-2)
    return y.reshape(x.shape)


def redesign_j(dev, rng) -> dict:
    """Phase 35, kernel J: at every REDESIGN_J_SHAPES shape each stage and
    both transforms against J's plain version (any u64 words into the
    stages that reduce first, reduced words into the others) and against A
    (reduced words); J's device us a launch (profiler, both launches of
    every traced call seen) beside its bound; A and J in turns at each n
    (device us a call from CUDA graphs, then the wrappers), and the
    largest n at which A was the faster in this run (at n = 16384 at the
    headline's (5, 6, n), the last shape of an n deciding it); the shard
    blocks of n = 16384
    over 2 and 4 ranks, every rank's stages against the plain version and
    the sharded transforms against A."""
    out, order = {}, {}
    for tag, n, spec, lead in REDESIGN_J_SHAPES:
        moduli = _moduli(n, spec)
        k = len(moduli)
        tj = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=True)
        ta = ntt.RnsNttTables.from_moduli(n, moduli, dev, use_mxu=False)
        a, b = tj.mxu[0].a, tj.mxu[0].b
        x = _full(rng, (lead, k, n), dev)
        xr = _uniform(rng, moduli, (lead, k, n), dev)
        checks = [("forward", lambda: ntt.rns_ntt_forward(x, tj),
                   lambda: ntt_mxu.rns_ntt_mxu_plain(x, tj.mxu, False)),
                  ("inverse", lambda: ntt.rns_ntt_inverse(x, tj),
                   lambda: ntt_mxu.rns_ntt_mxu_plain(x, tj.mxu, True)),
                  ("forward = A", lambda: ntt.rns_ntt_forward(xr, tj),
                   lambda: ntt.rns_ntt_forward(xr, ta)),
                  ("inverse = A", lambda: ntt.rns_ntt_inverse(xr, tj),
                   lambda: ntt.rns_ntt_inverse(xr, ta))]
        for stage, (_, _, _, reduce_in) in ntt_mxu.STAGES.items():
            v = (x if reduce_in else xr).reshape(lead, k, a, b)
            checks.append((stage, lambda v=v, stage=stage:
                           ntt_mxu.rns_mxu_stage(v, tj.mxu, tj.mxu_pointers,
                                                 stage),
                           lambda v=v, stage=stage:
                           ntt_mxu.mxu_stage_plain(v, tj.mxu, stage)))
        for variant, run, want in checks:
            try:
                compare("words", run(), want())
            except AssertionError as exc:
                raise AssertionError(f"J {tag} {variant}: {exc}") from None
        each = {}
        for inverse in (False, True):
            fn = ntt.rns_ntt_inverse if inverse else ntt.rns_ntt_forward
            _, device_ms, kernels = device_kernels_per_op(
                lambda: fn(x, tj), reps=10, expect={"ntt_mxu_kernel": 2},
                whole=True)
            each["inverse" if inverse else "forward"] = {
                "device_ms": device_ms,
                "us_per_launch": kernels["ntt_mxu_kernel"][1]}
        bound_ms, bound_by = bound(*j_work(tj, lead))
        # A and J in turns: device us a call (graph), then the wrappers
        turns = {"a_device_us": [], "j_device_us": []}
        for r in range(4):
            for name in (("a", "j") if r % 2 == 0 else ("j", "a")):
                t = ta if name == "a" else tj
                turns[f"{name}_device_us"].append(graph_us(
                    lambda t=t: ntt.rns_ntt_forward(xr, t)))
        timed = {key: statistics.median(v) for key, v in turns.items()}
        timed.update(alternating_ms({
            "a_ms": lambda: ntt.rns_ntt_forward(xr, ta),
            "j_ms": lambda: ntt.rns_ntt_forward(xr, tj)}))
        out[tag] = {"n": n, "limbs": k, "a": a, "b": b, **each,
                    "bound_ms": bound_ms, "bound_by": bound_by, **timed,
                    "device_us_turns": turns}
        order[n] = timed["a_device_us"] <= timed["j_device_us"]
        log(f"[35] J {tag} (A, B) = ({a}, {b}): every stage and both "
            f"transforms word-equal to the plain version and to A; forward "
            f"{each['forward']['device_ms'] * 1e3:.1f} us of device time "
            f"(2 launches of {each['forward']['us_per_launch']:.1f} us), "
            f"inverse {each['inverse']['device_ms'] * 1e3:.1f} us; bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by}); in turns, device us a "
            f"call: A {timed['a_device_us']:.1f}, J "
            f"{timed['j_device_us']:.1f}; wrappers A {timed['a_ms']:.4f} "
            f"ms, J {timed['j_ms']:.4f} ms")
    crossover = max((n for n, a_faster in order.items() if a_faster),
                    default=0)
    log(f"[35] A was the faster at n = "
        f"{[n for n, f in order.items() if f]}, J at "
        f"{[n for n, f in order.items() if not f]}: the largest n at which "
        f"A was the faster is {crossover or 'none'} (ops/ntt.py "
        f"MAX_KERNEL_N = {ntt.MAX_KERNEL_N})")
    shards = {}
    moduli = _moduli(N, Q_BITS)
    ta = ntt.RnsNttTables.from_moduli(N, moduli, dev, use_mxu=False)
    for w in REDESIGN_J_SHARDS:
        mxus = [[ntt_mxu.make_shard_tables(N, q, dev, w, i) for q in moduli]
                for i in range(w)]
        ptrs = [ntt_mxu.pointer_table(m, dev) for m in mxus]
        a, b = mxus[0][0].a, mxus[0][0].b
        for i in range(w):
            for stage, (left, _, _, reduce_in) in ntt_mxu.STAGES.items():
                shape = (2, len(moduli)) + ((a, b // w) if left
                                            else (a // w, b))
                v = _full(rng, shape, dev) if reduce_in else _uniform(
                    rng, moduli, shape[:2] + (shape[2] * shape[3],),
                    dev).reshape(shape)
                try:
                    compare("words",
                            ntt_mxu.rns_mxu_stage(v, mxus[i], ptrs[i], stage),
                            ntt_mxu.mxu_stage_plain(v, mxus[i], stage))
                except AssertionError as exc:
                    raise AssertionError(f"J shard {i} of {w} {stage}: "
                                         f"{exc}") from None
        xr = _uniform(rng, moduli, (2, len(moduli), N), dev)
        for inverse in (False, True):
            want = (ntt.rns_ntt_inverse if inverse else ntt.rns_ntt_forward)(
                xr, ta)
            try:
                compare("words", sharded_transform(xr, mxus, ptrs, a, b,
                                                   inverse), want)
            except AssertionError as exc:
                raise AssertionError(f"J sharded over {w}, inverse "
                                     f"{inverse}: {exc}") from None
        v = _full(rng, (2, len(moduli), a, b // w), dev)
        _, _, kernels = device_kernels_per_op(
            lambda: ntt_mxu.rns_mxu_stage(v, mxus[0], ptrs[0],
                                          "forward_left"),
            reps=10, expect={"ntt_mxu_kernel": 1}, whole=True)
        shards[f"w{w}"] = {"forward_left_us_per_launch":
                           kernels["ntt_mxu_kernel"][1]}
        log(f"[35] J on the shard blocks of n = {N} over {w} ranks: every "
            f"rank's stages word-equal to the plain version, the sharded "
            f"transforms to A; forward_left on ({a}, {b // w}) blocks "
            f"{kernels['ntt_mxu_kernel'][1]:.1f} us a launch")
    return {"shapes": out, "a_faster_up_to": crossover, "shards": shards}


def behz_work(tool, lead: int, tail: bool) -> tuple:
    """(bytes, 64-bit products) of E's tail over (lead, k + nb, n) or its
    lift over (lead, k, n): the words in and out and the constants once;
    the products as phase 3 counts them (Shoup 3, a conversion's terms 2
    and its Barrett-128 5)."""
    k, nb, n = tool.k, tool.nb, tool.q.n
    if tail:
        nbytes = (lead * (k + nb + k) * n + tool.tail_consts.numel()) * 8
        mul = lead * n * (k * 6 + nb * (2 * k + 11) + (nb - 1) * 3
                          + (k + 1) * (2 * (nb - 1) + 5) + 3 + k * 3)
    else:
        nbytes = (lead * (k + nb) * n + tool.lift_consts.numel()) * 8
        mul = lead * n * (k * 6 + (nb + 1) * (2 * k + 5) + 3 + nb * 9)
    return nbytes, mul


def redesign_e(dev, rng) -> dict:
    """Phase 35, kernel E: the lift over (4, k, n) and the tail over (3,
    k + |Bsk|, n) at each REDESIGN_E_SHAPES data level, against their
    plain versions (reduced words, and any u64 words into the tail), with
    the device us a launch (profiler), a call (graph) and the bound."""
    out = {}
    for tag, n, spec in REDESIGN_E_SHAPES:
        q = tuple(_moduli(n, spec)[:-1])
        host = rns_util.make_rns_tool(n, q, int(P.PlainModulus.batching(n,
                                                                        20)))
        tool = rns.DeviceRnsTool.build(
            host, ntt.RnsNttTables.from_moduli(n, q, dev, use_mxu=False),
            ntt.RnsNttTables.from_moduli(n, host.base_Bsk.values, dev,
                                         use_mxu=False))
        k, nb = tool.k, tool.nb
        lift_x = _uniform(rng, q, (4, k, n), dev)
        tail_x = _uniform(rng, tool.q_bsk.values, (3, k + nb, n), dev)
        tail_any = _full(rng, (3, k + nb, n), dev)
        for what, run, want in (
                ("lift", lambda: rns.behz_lift(lift_x, tool),
                 lambda: rns.behz_lift_plain(lift_x, tool)),
                ("tail", lambda: rns.behz_tail(tail_x, tool),
                 lambda: rns.behz_tail_plain(tail_x, tool)),
                ("tail, any words", lambda: rns.behz_tail(tail_any, tool),
                 lambda: rns.behz_tail_plain(tail_any, tool))):
            try:
                compare("words", run(), want())
            except AssertionError as exc:
                raise AssertionError(f"E {tag} {what}: {exc}") from None
        r = {"n": n, "k": k, "nb": nb}
        for what, fn, kernel, work in (
                ("lift", lambda: rns.behz_lift(lift_x, tool),
                 "behz_lift_kernel", behz_work(tool, 4, False)),
                ("tail", lambda: rns.behz_tail(tail_x, tool),
                 "behz_tail_kernel", behz_work(tool, 3, True))):
            _, _, kernels = device_kernels_per_op(
                fn, reps=10, expect={kernel: 1}, whole=True)
            bound_ms, bound_by = bound(*work)
            r[what] = {"us_per_launch": kernels[kernel][1],
                       "device_us": graph_us(fn), "bound_ms": bound_ms,
                       "bound_by": bound_by}
        out[tag] = r
        log(f"[35] E {tag} (n = {n}, k = {k}, |Bsk| = {nb}): lift and tail "
            f"word-equal to their plain versions; lift (4,{k},n) "
            f"{r['lift']['us_per_launch']:.1f} us a launch (bound "
            f"{r['lift']['bound_ms'] * 1e3:.2f} us, "
            f"{r['lift']['bound_by']}), tail (3,{k}+{nb},n) "
            f"{r['tail']['us_per_launch']:.1f} us (bound "
            f"{r['tail']['bound_ms'] * 1e3:.2f} us, "
            f"{r['tail']['bound_by']})")
    return out


def o1_work(n: int, what: str) -> tuple:
    """(bytes, 64-bit products, f64 operations) of one O1 or O5 call at n,
    as phases 7 and 29 count them: the slots in and u out (encode), the
    coefficients in and the slots out (decode; O5 also its partners and
    the residual word), 5 n log2 n f64 operations of an FFT (O5: 3 more a
    slot)."""
    ops = 5 * n * (n.bit_length() - 1)
    if what == "encode":
        return n // 2 * 16 + n * 16, 0, ops
    if what == "decode":
        return n * 8 + n // 2 * 16, 0, ops
    return n * 8 + 2 * (n // 2 * 16) + 8, 0, ops + 3 * (n // 2)


def redesign_o1(dev, rng, per_op: dict) -> dict:
    """Phase 35, kernels O1 and O5 (the FFT passes in shared memory): at
    every REDESIGN_O1_NS ring O1's encode (all slots and 3) and decode
    (an encoding's coefficients and raw ones) within O1_TOLERANCE of their
    plain versions, O5 held as phase 29 holds it (check_o5); each one's
    device us a call (CUDA graphs) in turns with torch.fft.fft and
    torch.fft.ifft of the same (n,) complex128 vectors, its device us a
    launch (profiler, both launches of every traced call seen) and the
    library's device us a call from the profiler, its blocks and threads a
    launch and its bound; and the device time of phase 10's CKKS encode and
    decode with O1's part of it."""
    out = {}
    for n in REDESIGN_O1_NS:
        t = embedding.make_embed_tables(n, dev)
        vals = torch.from_numpy(rng.uniform(-1, 1, n // 2)
                                + 1j * rng.uniform(-1, 1, n // 2)).to(dev)
        few = vals[:3]
        coeffs = (embedding.embed_inverse_fft(vals, t) * t.untwist
                  ).real.contiguous()
        raw = torch.from_numpy(rng.uniform(-1, 1, n) * 2.0 ** 30).to(dev)
        try:
            err = max(
                compare("close", embedding.embed_inverse_fft(v, t),
                        embedding.embed_inverse_fft_plain(v, t))
                for v in (vals, few))
            err = max([err] + [
                compare("close", embedding.embed_forward(c, t),
                        embedding.embed_forward_plain(c, t))
                for c in (coeffs, raw)])
            o5_err, residual, _ = check_o5(coeffs, t)
        except AssertionError as exc:
            raise AssertionError(f"O1/O5 at n = {n}: {exc}") from None
        spectrum = embedding.scatter_slots(vals, t)
        twisted = coeffs * t.twist
        calls = {"encode": lambda: embedding.embed_inverse_fft(vals, t),
                 "decode": lambda: embedding.embed_forward(coeffs, t),
                 "o5": lambda: embedding.embed_forward_stats(coeffs, t),
                 "fft": lambda: torch.fft.fft(spectrum),
                 "ifft": lambda: torch.fft.ifft(twisted)}
        turns = {name: [] for name in calls}
        for r in range(4):
            for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                turns[name].append(graph_us(calls[name]))
        r = {"n": n, "a": t.a, "b": t.b, "max_abs_err": max(err, o5_err),
             "residual": residual,
             "blocks_threads": embedding.launch_geometry(t),
             "device_us_turns": turns}
        for name, fn in calls.items():
            library = name in ("fft", "ifft")
            _, device_ms, each = device_kernels_per_op(
                fn, reps=10, expect=None if library else {
                    k: 1 for k in O1_KERNELS}, whole=not library)
            r[name] = {"device_us": statistics.median(turns[name]),
                       "profiler_us": device_ms * 1e3}
            if not library:
                bound_ms, bound_by = bound(*o1_work(n, name))
                r[name].update(us_per_launch={k: each[k][1]
                                              for k in O1_KERNELS},
                               bound_ms=bound_ms, bound_by=bound_by)
        out[str(n)] = r
        log(f"[35] O1/O5 n = {n} (A, B) = ({t.a}, {t.b}), (blocks, threads) "
            f"a launch {r['blocks_threads']}: within {r['max_abs_err']:.3g} "
            f"of the plain versions, residual {residual:.3g}; device us a "
            f"call in turns (graph): encode {r['encode']['device_us']:.2f}, "
            f"decode {r['decode']['device_us']:.2f}, O5 "
            f"{r['o5']['device_us']:.2f}, torch.fft.fft "
            f"{r['fft']['device_us']:.2f}, ifft {r['ifft']['device_us']:.2f}"
            f" (profiler: {r['fft']['profiler_us']:.2f}, "
            f"{r['ifft']['profiler_us']:.2f}); a launch (profiler): "
            + "; ".join(f"{name} " + ", ".join(
                f"{us:.2f}" for us in r[name]["us_per_launch"].values())
                        for name in ("encode", "decode", "o5"))
            + f"; bound {r['encode']['bound_ms'] * 1e3:.3f} us (encode, "
            f"{r['encode']['bound_by']})")
    ops = {}
    for op in ("ckks_encode", "ckks_decode"):
        each = per_op[op]["each"]
        o1_ms = sum(c * us for k, (c, us) in each.items()
                    if k in O1_KERNELS) / 1e3
        ops[op] = {"device_ms": per_op[op]["device_ms"], "o1_ms": o1_ms}
        log(f"[35] phase 10's {op}: {per_op[op]['device_ms'] * 1e3:.2f} us "
            f"of device time, O1's launches {o1_ms * 1e3:.2f} us of it")
    return {"rings": out, "ckks_ops": ops}


# the kernels ranked by their loss (PERF.md section 6): those not yet
# redesigned for the H100 (none since G and O4), and B, D, DG, G, I, K,
# K'' and O4 (redesigned, and kept in the ranking), and their device
# functions' names in the profiler (O2 and O4 share round_kernel, and run
# only on J's route, O2's and O4's work in AO2p and AO4p on A's; G's is
# plain_embed_kernel on D's grid, DG's zero_embed_kernel; F's digits and
# divide run only on J's route, K keeps divide_round_kernel; X and C,
# redesigned into AXi and ACi, only on J's route and past the fused
# decrypt's limbs)
# ---- phase 36: the oracle suites on the card ----

# tools/ (no package) holds the suites' cases, shared with the CPU tests
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tools"))
NARROW_BITS = (40, 48)               # phase 36c's Bsk widths
NARROW_SEED = 2037                   # phase 36c's keys and encryptions
PRECISION_BITS_TOLERANCE = 0.1       # phase 36d: the card's rows, in bits
# the kernels the suites launch: n = 64 and 4096 at 30-, 40-, 50- and
# 60-bit primes on A's route (its one pass), J's route at n = 2048 (F's
# digits and divide, G'), the RNS tool's standalone decrypt scaling (C,
# E's rounding) beside ACi, and the headline's BFV and CKKS chains
SUITES_PATH = ("A_ntt", "AF_ntt_digits", "AFi_keyswitch_intt",
               "B_dyadic_mac", "ACi_decrypt_intt", "AXi_decrypt_intt",
               "C_base_convert", "D_rns_elementwise", "E_behz",
               "K_divide_round", "G_plain_embed", "DG_zero_embed",
               "M_galois", "I_sampling", "O1_ckks_fft", "AO2p_ntt_round",
               "O3_ckks_compose", "AKp_rescale_ntt", "AKp_keyswitch_ntt",
               "AKp_bgv_ntt", "AGp_ntt_lift", "J_ntt_mxu", "F_keyswitch",
               "Gp_plain_lift")


def suite_fixtures(dev) -> dict:
    """36a: every case of tools/troy_vectors_torch.py that runs ops, on the
    card, word for word against troy's words."""
    import troy_vectors_torch as tv
    return {case.__name__: tv.verify(case(str(dev))) for case in tv.CASES}


def suite_fuzz(dev) -> dict:
    """36b: tools/fuzz_torch.py's sequences on the card, one seed each:
    the steps each checked against its model and decrypt_many."""
    import fuzz_torch as fz
    d = str(dev)
    out = {f"{s.name} seed 0": fz.bfv_bgv_sequence(s, 0, d)
           for s in (P.SchemeType.bfv, P.SchemeType.bgv)}
    out["ckks seed 0"] = fz.ckks_sequence(0, d)
    out["bfv on J, n = 2048"] = fz.mxu_sequence(d)
    out["t = 2^41"] = fz.polynomial_sequence(1 << 41, [60, 60, 60], 0, d)
    out["non-batching t"] = fz.polynomial_sequence((1 << 20) - 3,
                                                   [40, 40, 40], 0, d)
    for s in (P.SchemeType.bfv, P.SchemeType.bgv, P.SchemeType.ckks):
        out[f"{s.name} other ops"] = fz.other_ops(s, d)
    return out


def narrow_base_run(bits: int, dev) -> dict:
    """36c: BFV at the headline (n = 16384, q = {60,40,40,40,40,60},
    t = 786433) with Bsk primes of ``bits`` bits: multiply, relinearize,
    decrypt and decrypt_many from seeded keys and encryptions; the words
    of each step and the decoded slots."""
    ctx = P.HeContext(P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=N,
        coeff_modulus=tuple(P.CoeffModulus.create(N, Q_BITS)),
        plain_modulus=P.PlainModulus.batching(N, 20)),
        internal_prime_bits=bits, device=dev)
    kg = P.KeyGenerator(ctx, seed=rnd.seed_from_uint64(NARROW_SEED))
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(NARROW_SEED + 1))
    be, ev = P.BatchEncoder(ctx), P.Evaluator(ctx)
    dec = P.Decryptor(ctx, kg.secret_key)
    t = be.plain_modulus
    rng = np.random.default_rng(NARROW_SEED + bits)
    a = rng.integers(0, t, N, dtype=np.uint64)
    b = rng.integers(0, t, N, dtype=np.uint64)
    ca, cb = (enc.encrypt_symmetric(be.encode(v)) for v in (a, b))
    prod = ev.multiply(ca, cb)
    rel = ev.relinearize(prod, kg.create_relin_keys())
    pt = dec.decrypt(rel)
    many = dec.decrypt_many([rel, ca, cb])
    return {"bsk": ctx.first_context_data.rns_tool.base_Bsk.values,
            "t": t, "a": a, "b": b,
            "words": {"prod": interop.words(prod), "rel": interop.words(rel),
                      "decrypt": interop.words(pt),
                      **{f"decrypt_many {i}": interop.words(p)
                         for i, p in enumerate(many)}},
            "slots": [be.decode(p) for p in (pt, *many)]}


def suite_narrow_base(dev) -> dict:
    """36c: each width on the card word-equal to the plain versions' run
    on the CPU at the same seeds, the Bsk primes of that width, the product
    decoding to a b mod t and decrypt_many to decrypt's words; E's and
    ACi's launches on the card at each width."""
    out = {}
    for bits in NARROW_BITS:
        before = _kernels.launch_counts()
        card = narrow_base_run(bits, dev)
        torch.cuda.synchronize()
        counts = {k: c - before[k]
                  for k, c in _kernels.launch_counts().items()}
        want = narrow_base_run(bits, "cpu")
        if any(p.bit_length() != bits for p in card["bsk"]) \
                or card["bsk"] != want["bsk"]:
            raise AssertionError(f"Bsk at {bits} bits: {card['bsk']} "
                                 f"(CPU {want['bsk']})")
        for step, words in want["words"].items():
            if not np.array_equal(card["words"][step], words):
                raise AssertionError(f"{bits}-bit Bsk: {step} on the card "
                                     "differs from the CPU run")
        t, a, b = card["t"], card["a"], card["b"]
        product = (a.astype(object) * b.astype(object) % t).astype(np.uint64)
        for got, model in zip(card["slots"], (product, product, a, b)):
            if not np.array_equal(got, model):
                raise AssertionError(f"{bits}-bit Bsk: a decryption on the "
                                     "card is not its slots' model")
        out[bits] = {"E_behz": counts.get("E_behz", 0),
                     "ACi_decrypt_intt": counts.get("ACi_decrypt_intt", 0)}
        if not all(out[bits].values()):
            raise AssertionError(f"{bits}-bit Bsk: E or ACi never launched: "
                                 f"{counts}")
    return out


def suite_precision(dev) -> dict:
    """36d: tools/ckks_precision_torch.py's chain at the headline on the
    card. Fed the CPU run's plaintext words, every stage's ciphertext on
    the card equals the CPU run's word for word (O1's FFT may round an
    encoded word the other way, so the card's own encode is not held to
    words); with its own encode and decode, every row within
    PRECISION_BITS_TOLERANCE bits of the CPU run's."""
    import ckks_precision_torch as cp
    cpu_words, card_words = {}, {}
    cpu_rows, _ = cp.run(device="cpu", record=cpu_words)
    cp.run(device=dev, plaintexts=cpu_words, record=card_words)
    differ = [k for k in cpu_words
              if not np.array_equal(cpu_words[k], card_words[k])]
    if differ:
        raise AssertionError(f"the CKKS chain on the card differs from the "
                             f"CPU run's at {differ}")
    rows, meta = cp.run(device=dev)
    for r, w in zip(rows, cpu_rows):
        if (r["stage"], r["level"]) != (w["stage"], w["level"]) or abs(
                r["precision_bits"] - w["precision_bits"]) \
                > PRECISION_BITS_TOLERANCE:
            raise AssertionError(f"CKKS precision on the card: {r} against "
                                 f"the CPU's {w}")
    if len(rows) != len(cpu_rows):
        raise AssertionError("CKKS precision: the card's rows are not the "
                             "CPU's")
    log(cp.table(rows, meta))
    return {"words_checked": len(cpu_words), "rows": rows,
            "cpu_bits": [w["precision_bits"] for w in cpu_rows]}


def phase_suites(dev, counter) -> tuple:
    """Phase 36: the port's oracle suites on the card (the CPU tests
    tests/test_torch_*vectors*.py, *fuzz*.py, internal_base.py and
    ckks_precision.py run them through the plain versions), each part in
    a count window of its own: a. troy's C++ fixtures, word for word; b.
    the fuzz sequences against their models; c. the narrow BEHZ base at
    the headline; d. CKKS precision against depth. No plain torch on the
    card in any part; every kernel of SUITES_PATH launched. Then each
    part's card work once more in a profiler trace for its device
    seconds. (launch counts of the phase, results)"""
    import ckks_precision_torch as cp
    t_phase = time.perf_counter()
    counter.calls.clear()
    parts = {"a": ("fixtures", lambda: suite_fixtures(dev)),
             "b": ("fuzz", lambda: suite_fuzz(dev)),
             "c": ("narrow base", lambda: suite_narrow_base(dev)),
             "d": ("ckks precision", lambda: suite_precision(dev))}
    total, results = {}, {}
    for part, (what, fn) in parts.items():
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: c for k, c in _kernels.launch_counts().items() if c}
        for kernel, c in counts.items():
            total[kernel] = total.get(kernel, 0) + c
        results[part] = {"result": result, "wall_s": wall}
        if part == "a":
            said = (f"{len(result)} cases, {sum(result.values())} checks "
                    "word-equal to troy's words on the card")
        elif part == "b":
            said = (f"{len(result)} sequences, steps checked against their "
                    f"models and decrypt_many: {result}")
        elif part == "c":
            said = (f"BFV n = {N} at Bsk widths {list(result)} word-equal "
                    f"to the CPU run, decrypting to a b; launches {result}")
        else:
            said = (f"{result['words_checked']} plaintexts and "
                    f"ciphertexts word-equal to the CPU run's, precision bits "
                    f"{[r['precision_bits'] for r in result['rows']]} "
                    f"(CPU {result['cpu_bits']})")
        log(f"[36{part}] {what}: {said}; {wall:.1f} s; kernel launches "
            f"{counts}")
    # the device seconds of each part's card work (the CPU references
    # left out), traced once more
    card_work = {
        "a": parts["a"][1], "b": parts["b"][1],
        "c": lambda: [narrow_base_run(bits, dev) for bits in NARROW_BITS],
        "d": lambda: cp.run(device=dev)}
    device_s = {}
    for part, fn in card_work.items():
        each, _ = _trace(fn, reps=1, warmup=0)
        device_s[part] = sum(us for _, us in each.values()) / 1e6
        results[part]["device_s"] = device_s[part]
    check_path("36", "36", SUITES_PATH, total, counter, absent=())
    wall = time.perf_counter() - t_phase
    log(f"[36] suites on the card: {wall:.1f} s in all; device seconds "
        f"(profiler, one more run of each part's card work) "
        + ", ".join(f"{p} {s:.4f}" for p, s in device_s.items()))
    return total, {**results, "wall_s": wall}


RANKED = {
    "B_dyadic_mac": ("dyadic_mac_kernel", "dyadic_convolve_kernel",
                     "dyadic_convolve_any_kernel"),
    "D_rns_elementwise": ("rns_elementwise_kernel",),
    "DG_zero_embed": ("zero_embed_kernel",),
    "F_keyswitch": ("keyswitch_digits_kernel",),
    "G_plain_embed": ("plain_embed_kernel",),
    "I_sampling": ("uniform_kernel", "small_kernel", "zero_sym_kernel",
                   "zero_asym_kernel"),
    "K_divide_round": ("divide_round_kernel",),
    "N1_negacyclic": ("shift_kernel", "extract_kernel", "assemble_kernel"),
    "N2_pack_prepare": ("pack_prepare_kernel",),
    "O2_ckks_round": ("round_kernel",),
    "O4_ckks_encode_stats": ("round_kernel",),
    "P3_group_fold": ("pack_group_fold_kernel",),
    "Kpp_bgv_coeff": ("bgv_divide_kernel",),
}
# the ranked kernels redesigned for the H100 (DG is G's fold into D's
# finish); the others of RANKED were never redesigned
REDESIGNED = ("B_dyadic_mac", "D_rns_elementwise", "DG_zero_embed",
              "F_keyswitch", "G_plain_embed", "I_sampling", "K_divide_round",
              "Kpp_bgv_coeff", "O2_ckks_round", "O4_ckks_encode_stats")
# the windows and profiled ops of the headline configuration (n = 16384);
# P3 runs only in the app protocol. Redesigned and out of the ranking: X
# and C (in AXi and ACi; their own kernels on J's route, n = 262144 in
# phase 27), G' and P2 (G''s lift in AGp on A's route, G' itself on J's,
# phase 24's multiply_plain; P2 in AP2i for BFV's pair grid on A's route,
# P2's own redesigned kernel for the CKKS and BGV grids, phase 21's BGV ct
# x ct matmul)
HEADLINE_WINDOWS = ("bfv", "ckks", "bgv", "plain_ops", "default", "lwe")
OTHER_OPS = ("app_", "seal", "ckks32768", "n131072", "n262144", "shim_")
APP_ONLY = ("P3_group_fold",)


def _ranked_ops(per_op: dict, app: bool):
    """The profiled ops of the headline windows (the app's for P3)."""
    for op, prof in per_op.items():
        if op.startswith("app_") == app and (
                app or not op.startswith(OTHER_OPS)):
            yield op, prof


def unredesigned_losses(entries: list, per_op: dict,
                        kernel_results: dict) -> dict:
    """Each kernel of RANKED: its launches in the headline windows (the
    app's for P3) times its device us a launch less its bound a
    launch, both launch-weighted means over the profiled ops of the same
    windows (the bound of each launch from its own arguments,
    ``launch_work``), ordered by that product: where the next redesign
    saves the most. A kernel those ops never launch keeps its bound at its
    first checked shape."""
    by_name = {e["name"]: e for e in entries}
    out = {}
    for kernel, names in RANKED.items():
        app = kernel in APP_ONLY
        launches = (by_name[kernel]["launches_app"] if app else
                    sum(by_name[kernel][f"launches_{w}"]
                        for w in HEADLINE_WINDOWS))
        n = t = bn = bt = 0.0
        for op, prof in _ranked_ops(per_op, app):
            for name in names:
                if name in prof["each"]:
                    count, us = prof["each"][name]
                    n, t = n + count, t + count * us
            if kernel in prof["bounds"]:
                calls, bound_us = prof["bounds"][kernel]
                bn, bt = bn + calls, bt + bound_us
        us = t / n if n else None
        bound_us = bt / bn if bn else kernel_results[kernel]["bound_ms"] * 1e3
        out[kernel] = {"redesigned": kernel in REDESIGNED,
                       "launches": launches, "us_per_launch": us,
                       "bound_us": bound_us, "bound_launches": bn,
                       "lost_ms": None if us is None else
                       launches * max(0.0, us - bound_us) / 1e3}
    ranked = sorted(out.items(), key=lambda kv: -(kv[1]["lost_ms"] or 0))
    for kernel, r in ranked:
        us = "not profiled" if r["us_per_launch"] is None else \
            f"{r['us_per_launch']:.2f} us a launch"
        lost = "" if r["lost_ms"] is None else \
            f", {r['lost_ms']:.4f} ms over the bound"
        at = (f"over {r['bound_launches']:g} profiled launches"
              if r["bound_launches"] else "at its first checked shape")
        done = " (redesigned)" if r["redesigned"] else " (not redesigned)"
        log(f"[rank] {kernel}{done}: {r['launches']} launches, {us}, bound "
            f"{r['bound_us']:.3f} us ({at}){lost}")
    return dict(ranked)


def a_share(per_op: dict, op: str) -> dict:
    """Kernel A's share of one profiled op's device time (its trace held
    whole, A's launches in it: profile_ops' expect)."""
    launches, us = per_op[op]["each"]["ntt_pass_kernel"]
    a_ms = launches * us / 1e3
    return {"a_ms": a_ms, "device_ms": per_op[op]["device_ms"],
            "share": a_ms / per_op[op]["device_ms"]}


def main() -> None:
    wall0 = time.perf_counter()
    name = phase_device()
    phase_build()
    parms = P.EncryptionParameters(
        scheme=P.SchemeType.bfv, poly_modulus_degree=N,
        coeff_modulus=tuple(P.CoeffModulus.create(N, Q_BITS)),
        plain_modulus=P.PlainModulus.batching(N, 20))
    ctx = P.HeContext(parms)
    if ctx.device.type != "cuda":
        raise AssertionError(f"HeContext defaulted to {ctx.device}")
    kernel_results = phase_kernels(ctx)

    # ---- BFV: phases 4-6 ----
    counter = PlainCallCounter()
    _kernels.reset_launch_counts()
    with DECRYPTS.window("bfv"):
        state = phase_fixture(ctx)
        req = phase_requests(ctx, *state)
        torch.cuda.synchronize()
    bfv_counts = _kernels.launch_counts()
    check_path("6", "4-5", BFV_PATH, bfv_counts, counter,
               ENCRYPT_ABSENT)
    kg, rlk, _, be, ev, dec = state
    ca, cb, rel, gk = req["ca"], req["cb"], req["rel"], req["gk"]
    # bound now: the CKKS and BGV phases below rebind these names, and
    # phase 35 runs these ops after them
    bfv_ops = {"mult_relin": lambda ev=ev, ca=ca, cb=cb, rlk=rlk:
               ev.relinearize(ev.multiply(ca, cb), rlk),
               "rotate_rows": lambda ev=ev, rel=rel, gk=gk:
               ev.rotate_rows(rel, 1, gk),
               "apply_galois_many": lambda ev=ev, rel=rel, gk=gk:
               ev.apply_galois_many(rel, list(gk.keys), gk),
               "decrypt": lambda dec=dec, rel=rel: dec.decrypt(rel)}
    decrypt_ops = {"bfv": {
        "decrypt": lambda dec=dec, rel=rel: dec.decrypt(rel),
        "decrypt_many of 3": lambda dec=dec, cts=(rel, ca, cb):
        dec.decrypt_many(cts)}}
    enc = P.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(SEED + 2))
    slots = np.arange(N, dtype=np.uint64) % be.plain_modulus
    pt = be.encode(slots)
    per_op = profile_ops("6", {
        "mult_relin": lambda: ev.relinearize(ev.multiply(ca, cb), rlk),
        "rotate_rows": lambda: ev.rotate_rows(rel, 1, gk),
        "mod_switch": lambda: ev.mod_switch_to_next(rel),
        "encrypt": lambda: enc.encrypt_symmetric(pt),
        "decrypt": lambda: dec.decrypt(rel),
        "encode": lambda: be.encode(slots),
        "decode": lambda: be.decode(pt),
    }, expect={"mult_relin": {"ntt_pass_kernel": None}})
    mult_relin_a = a_share(per_op, "mult_relin")
    log(f"[6] A's share of mult_relin's device time: "
        f"{mult_relin_a['a_ms']:.4f} of {mult_relin_a['device_ms']:.4f} ms "
        f"({100 * mult_relin_a['share']:.1f} %)")

    # ---- CKKS: phases 7-10 ----
    ckks_ctx = P.HeContext(P.EncryptionParameters(
        scheme=P.SchemeType.ckks, poly_modulus_degree=N,
        coeff_modulus=tuple(P.CoeffModulus.create(N, Q_BITS))))
    kernel_results.update(phase_ckks_kernels(ckks_ctx))
    counter.calls.clear()
    _kernels.reset_launch_counts()
    cstate = phase_ckks_records(ckks_ctx)
    creq = phase_ckks_requests(ckks_ctx, *cstate)
    torch.cuda.synchronize()
    ckks_counts = _kernels.launch_counts()
    check_path("10", "8-9", CKKS_PATH, ckks_counts, counter,
               ENCRYPT_ABSENT)
    _, rlk, _, ce, ev, dec = cstate
    ca, cb, rel, gk = creq["ca"], creq["cb"], creq["rel"], creq["gk"]
    per_op.update(profile_ops("10", {
        "ckks_mult_relin": lambda: ev.relinearize(ev.multiply(ca, cb), rlk),
        "ckks_rescale": lambda: ev.rescale_to_next(rel),
        "ckks_rotate_vector": lambda: ev.rotate_vector(rel, 1, gk),
        "ckks_conjugate": lambda: ev.complex_conjugate(rel, gk),
        "ckks_encode": lambda: ce.encode(creq["a"], CKKS_SCALE),
        "ckks_decode": lambda: ce.decode(creq["pt"]),
        "ckks_decrypt": lambda: dec.decrypt(creq["rs"]),
    }))
    ckks_parts = (ckks_ctx, ce, ev, dec, ca, creq["a"])
    # bound now, as bfv_ops: phase 35 records their divides
    divide_ops = {
        "ckks_mult_relin": lambda ev=ev, ca=ca, cb=cb, rlk=rlk:
        ev.relinearize(ev.multiply(ca, cb), rlk),
        "ckks_rescale": lambda ev=ev, rel=rel: ev.rescale_to_next(rel),
        "ckks_rotate_vector": lambda ev=ev, rel=rel, gk=gk:
        ev.rotate_vector(rel, 1, gk)}

    # ---- BGV: phases 11-14 ----
    bgv_ctx = P.HeContext(P.EncryptionParameters(
        scheme=P.SchemeType.bgv, poly_modulus_degree=N,
        coeff_modulus=tuple(P.CoeffModulus.create(N, Q_BITS)),
        plain_modulus=P.PlainModulus.batching(N, 20)))
    kernel_results.update(phase_bgv_kernels(bgv_ctx))
    counter.calls.clear()
    _kernels.reset_launch_counts()
    with DECRYPTS.window("bgv"):
        bstate = phase_bgv_records(bgv_ctx)
        breq = phase_bgv_requests(bgv_ctx, *bstate)
        torch.cuda.synchronize()
    bgv_counts = _kernels.launch_counts()
    check_path("14", "12-13", BGV_PATH, bgv_counts, counter,
               ENCRYPT_ABSENT)
    _, rlk, _, be, ev, dec = bstate
    ca, cb, rel, ms, gk = (breq[k] for k in ("ca", "cb", "rel", "ms", "gk"))
    per_op.update(profile_ops("14", {
        "bgv_mult_relin": lambda: ev.relinearize(ev.multiply(ca, cb), rlk),
        "bgv_mod_switch": lambda: ev.mod_switch_to_next(rel),
        "bgv_rotate_rows": lambda: ev.rotate_rows(rel, 1, gk),
        "bgv_multiply_plain": lambda: ev.multiply_plain(ms, breq["pc"]),
        "bgv_add_plain": lambda: ev.add_plain(ms, breq["pc"]),
        "bgv_encrypt": lambda: breq["enc"].encrypt_symmetric(breq["pt"]),
        "bgv_decrypt": lambda: dec.decrypt(ms),
    }))
    divide_ops.update({
        "bgv_mult_relin": lambda ev=ev, ca=ca, cb=cb, rlk=rlk:
        ev.relinearize(ev.multiply(ca, cb), rlk),
        "bgv_mod_switch": lambda ev=ev, rel=rel: ev.mod_switch_to_next(rel),
        "bgv_rotate_rows": lambda ev=ev, rel=rel, gk=gk:
        ev.rotate_rows(rel, 1, gk)})
    decrypt_ops["bgv"] = {
        "decrypt (correction factor != 1)": lambda dec=dec, ms=ms:
        dec.decrypt(ms),
        "decrypt_many of 3": lambda dec=dec, cts=(rel, ca, cb):
        dec.decrypt_many(cts)}
    counter.calls.clear()
    _kernels.reset_launch_counts()
    with DECRYPTS.window("plain_ops"):
        plain = phase_plain_op_requests(
            (ctx, state[3], state[4], state[5], req["ca"],
             np.random.default_rng(SEED + 14)), ckks_parts)
        torch.cuda.synchronize()
    plain_counts = _kernels.launch_counts()
    check_path("14", "14 (plain-op requests)", PLAIN_OPS_PATH, plain_counts,
               counter)
    log(f"[14] medians over {TIMING_REPS} runs (CUDA events): "
        f"bfv_multiply_plain_ms {plain['bfv_multiply_plain_ms']:.4f}, "
        f"ckks_multiply_plain_ms {plain['ckks_multiply_plain_ms']:.4f}")

    # ---- device sampling and the default encryption path: 15-16 ----
    kernel_results.update(phase_sampling_kernels(
        ctx, int(bgv_ctx.first_context_data.plain_modulus)))
    default_counts, default_times, default_per_op = phase_default(
        {"bfv": ctx, "ckks": ckks_ctx, "bgv": bgv_ctx}, counter)
    per_op.update(default_per_op)

    # ---- hoisted Galois, the negacyclic shift and LWE: 17-19 ----
    lwe_kernels = phase_lwe_kernels(bgv_ctx)
    for kernel in ("N1_negacyclic", "N2_pack_prepare", "Kpp_bgv_coeff"):
        kernel_results[kernel] = lwe_kernels[kernel]
    lwe_counts, lwe_times, lwe_per_op, lwe_worst = phase_lwe(
        {"bfv": ctx, "ckks": ckks_ctx, "bgv": bgv_ctx}, counter)
    per_op.update(lwe_per_op)

    # ---- troy's app layer: 20-22 ----
    app_ctx = app_context(P.SchemeType.bfv)
    kernel_results.update(phase_app_kernels(app_ctx))
    app_counts, app_times, app_per_op, app_checks = phase_app(
        app_ctx, app_context(P.SchemeType.bgv), ckks_ctx, counter)
    per_op.update(app_per_op)

    # ---- kernel J and the large rings: 23-28 ----
    mxu_results, mxu_shapes = phase_mxu_kernels(ctx.device)
    kernel_results.update(mxu_results)
    mxu_headline, mxu16_counts = phase_mxu_headline(
        {"bfv": (ctx, req["ca"], req["cb"], state[1]),
         "ckks": (ckks_ctx, creq["ca"], creq["cb"], cstate[1])}, counter)
    seal_counts, seal, seal_ops = phase_seal32768(counter)
    if (seal["limbs"], seal["bits"]) != (16, 881):
        raise AssertionError(f"bfv_default(32768) is {seal['limbs']} primes, "
                             f"{seal['bits']} bits, not 16 and 881")
    ckks32_counts, ckks32, ckks32_ops = phase_ckks32768(counter)
    ceiling_counts, ceiling, ceiling_ops = phase_ceiling(counter)
    large_ops = {f"seal32768_{k}": seal_ops[k] for k in (
        "mult_relin", "rotate_rows", "rotate_columns", "mod_switch",
        "encrypt", "decrypt")}
    large_ops.update({f"ckks32768_{k}": ckks32_ops[k] for k in (
        "mult_relin", "rescale", "rotate_vector")})
    large_ops.update({k: v for k, v in ceiling_ops.items()
                      if k.endswith("mult_relin")})
    per_op.update(phase_large_profiles(large_ops, counter))

    # ---- the CKKS statistics, troy's binder API and wire: 29-32 ----
    stats_results, stats_shapes = phase_stats_kernels(ctx.device)
    kernel_results.update(stats_results)
    binder_counts, binder, binder_per_op, alice = phase_binder(counter)
    per_op.update(binder_per_op)
    wire = phase_wire(ctx.device)
    stats_ms = phase_stats_medians(ckks_ctx, alice)

    # ---- the oracle suites on the card: 36 ----
    suites_counts, suites = phase_suites(ctx.device, counter)

    # ---- kernels A and M redesigned: 35, before phase 34 spawns its
    # ranks on the card (after it, the profiler lost the same share of
    # every trace in this process) ----
    redesign = phase_redesign(ctx.device, bfv_ops, per_op, app_ctx,
                              divide_ops, {"bfv": ctx, "ckks": ckks_ctx,
                                           "bgv": bgv_ctx}, decrypt_ops)

    # ---- multi-device (R): 33-34 ----
    shard_results, j_shards = phase_shard_kernels(ctx.device)
    kernel_results.update(shard_results)
    sharded_counts, sharded = phase_sharded(
        {"bfv": ctx, "ckks": ckks_ctx, "bgv": bgv_ctx}, app_ctx)

    entries = []
    windows = (bfv_counts, ckks_counts, bgv_counts, plain_counts,
               default_counts, lwe_counts, app_counts, mxu16_counts,
               seal_counts, ckks32_counts, ceiling_counts, binder_counts,
               sharded_counts, suites_counts)
    for kernel, (source, replaces) in KERNELS.items():
        r = kernel_results[kernel]
        launches = [c.get(kernel, 0) for c in windows]
        entries.append({"name": kernel, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": sum(launches),
                        "launches_bfv": launches[0],
                        "launches_ckks": launches[1],
                        "launches_bgv": launches[2],
                        "launches_plain_ops": launches[3],
                        "launches_default": launches[4],
                        "launches_lwe": launches[5],
                        "launches_app": launches[6],
                        "launches_mxu16384": launches[7],
                        "launches_seal32768": launches[8],
                        "launches_ckks32768": launches[9],
                        "launches_ceiling": launches[10],
                        "launches_binder": launches[11],
                        "launches_sharded": launches[12],
                        "launches_suites": launches[13],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    losses = unredesigned_losses(entries, per_op, kernel_results)
    composites = composite_bounds(ckks_ctx.first_context_data.limbs)
    composites["Mp_rotation_ntt"].update(
        ms=creq["ckks_rotate_vector_ms"],
        device_ms=per_op["ckks_rotate_vector"]["device_ms"],
        bgv_ms=breq["bgv_rotate_rows_ms"],
        bgv_device_ms=per_op["bgv_rotate_rows"]["device_ms"])
    composites["L_multiply_plain_bgv_ckks"].update(
        ms=breq["bgv_multiply_plain_ms"],
        device_ms=per_op["bgv_multiply_plain"]["device_ms"],
        ckks_ms=plain["ckks_multiply_plain_ms"])
    composites["L_multiply_plain_bfv"].update(
        ms=plain["bfv_multiply_plain_ms"])
    composites["Mp_hoisted_ntt_m8"].update(
        ms=lwe_times["ckks"]["hoisted8"],
        device_ms=per_op["ckks_apply_galois_many8"]["device_ms"],
        sequential_ms=lwe_times["ckks"]["sequential8"],
        bgv_ms=lwe_times["bgv"]["hoisted8"],
        bgv_device_ms=per_op["bgv_apply_galois_many8"]["device_ms"])
    composites["Q_kswitch_key"].update(
        ms=default_times["bfv"]["relin_key_q"],
        device_ms=per_op["bfv_relin_key_q"]["device_ms"],
        bgv_ms=default_times["bgv"]["relin_key_q"])
    slice7 = slice7_bounds(ckks_ctx.first_context_data.limbs,
                           app_ctx.first_context_data.limbs)
    for scheme in ("bfv", "ckks", "bgv"):
        slice7["N_pack_lwe16"][f"{scheme}_ms"] = lwe_times[scheme][
            "pack_lwe16"]
        slice7["N_pack_lwe16"][f"{scheme}_device_ms"] = per_op[
            f"{scheme}_pack_lwe16"]["device_ms"]
        slice7["N_field_trace"][f"{scheme}_ms"] = lwe_times[scheme][
            "field_trace"]
        slice7["N_field_trace"][f"{scheme}_device_ms"] = per_op[
            f"{scheme}_field_trace"]["device_ms"]
    slice7["batched_decrypt_conv52"].update(
        ms=app_times["conv_decrypt_many"],
        device_ms=per_op["app_decrypt_many_conv52"]["device_ms"])
    for op in ("O_encode_polynomial", "O_decode_polynomial"):
        key = "ckks_" + op[2:]
        slice7[op].update(ms=app_times[key],
                          device_ms=per_op[key]["device_ms"])
    composites.update(slice7)
    for op, c in composites.items():
        log(f"[14] {op}: {c}")
    ops = ("mult_relin_ms", "rotate_rows_ms", "mod_switch_ms")
    ckks_ops = ("ckks_mult_relin_ms", "ckks_rescale_ms",
                "ckks_rotate_vector_ms", "ckks_conjugate_ms",
                "ckks_encode_ms", "ckks_decode_ms")
    bgv_ops = ("bgv_mult_relin_ms", "bgv_mod_switch_ms",
               "bgv_rotate_rows_ms", "bgv_multiply_plain_ms",
               "bgv_encrypt_ms", "bgv_encrypt_host_ms", "bgv_decrypt_ms")
    log(f"wall seconds of the whole run: {time.perf_counter() - wall0:.1f}")
    log(json.dumps({"kernels": entries,
                    "H_batch_slots": kernel_results["H_batch_slots"],
                    "batched": {k: lwe_kernels[k]
                                for k in ("M_galois", "B_dyadic_mac")},
                    "lwe_ms": lwe_times, "ckks_lwe_max_error": lwe_worst,
                    "composites": composites,
                    **{op: req[op] for op in ops},
                    **{op: creq[op] for op in ckks_ops},
                    **{op: breq[op] for op in bgv_ops},
                    "bfv_multiply_plain_ms": plain["bfv_multiply_plain_ms"],
                    "ckks_multiply_plain_ms": plain["ckks_multiply_plain_ms"],
                    "ckks_max_error": creq["max_error"],
                    "ckks_plain_max_error": plain["ckks_plain_max_error"],
                    "default_path_ms": default_times,
                    "app_ms": app_times, "app": app_checks,
                    "J_shapes": mxu_shapes, "mxu_headline": mxu_headline,
                    "seal32768": seal, "ckks32768": ckks32,
                    "ceiling": ceiling,
                    "stats_shapes": stats_shapes, "binder": binder,
                    "wire": wire, "stats_ms": stats_ms,
                    "sharded": sharded, "J_shard_shapes": j_shards,
                    "suites": suites,
                    "native_build_s": native.build_seconds,
                    "redesign": redesign, "mult_relin_a": mult_relin_a,
                    "unredesigned_losses": losses,
                    "per_op": per_op}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
