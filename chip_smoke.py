#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sandstorm_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, one JSON object per line:
  1. device and toolchain (torch, CUDA, nvcc, nvidia-smi, triton);
  2. the nvcc build of csrc/*.cu, with its time and registers per kernel;
     then (build_air) the generated constraint-group kernels of every
     layout at the trace lengths this run proves (air/codegen.py, one nvcc
     a group kernel, all at once, linked into a library a layout and
     size), with the seconds and ptxas's registers, stack frame and spills
     per group kernel;
  3. every kernel against its plain PyTorch twin on the card, bit-exact
     (tolerance 0: field arithmetic, transforms, openings and hashes are
     exact), with the kernel's time beside the plain version's; 3b holds
     the two steps of the main path's forward LDE (2^21 rows by 5
     columns): the fused first leaf of the four-step (ntt_leaf_fused: leaf,
     w^(k c) multiply, transposed store) at [2048, 1024 x 5] and the leaf
     at [1024, 2048 x 5], and the leaf at [2048, 5120] besides;
  3a'. fp252.cuh's unreduced accumulate (the fold of the group kernels
     and deep_compose: 1, 8 and 16 products of mul_wide added with
     add_wide's carry chain, one redc) against its plain-C twin
     (add_wide_c) on the card, the plain sum of montmuls and python ints;
  3c. the pair-indexed opener (open_pairs, one launch) at the main path's
     pairs (the plain layout's 50 over 20 points, 8 columns, n = 2^20) and
     on a pair list in which a point names more columns than a block's
     group holds, unsorted and with a repeated pair;
  3e. the Pedersen walk (ec_madd_walk) against its plain version at the
     main path's largest level and at 8-bit windows, hash_pairs against the
     host C++ batch and the python oracle, one tree level of 2^5..2^12
     pairs timed on the card and on the host, and the 16-bit table build;
  3i. the Keccak kernel (keccak_rows) against its plain twin at plain-eth's
     base rows ([2^21, 40], masked to 20 bytes), node pairs ([2^20, 16]),
     FRI rows ([2^18, 64]) and the 136-byte rate's edge ([2^12, 33..35]),
     64 rows of each against the host keccak256;
  3j. the grind kernel (pow_grind), Keccak and Blake2s, on the coins' own
     prefixes from fixed seeds at 8, 12 and 16 bits, against its plain twin
     batch by batch on the card and the coin's host check; a launch of one
     batch with no hit timed alone and with its read of the result;
  4. the tiny plain/generic proof on the card, which must equal
     tests/data/self_proof_generic.bin byte for byte; 4b. the same claim
     under the cairo scheme, which must equal self_proof_cairo.bin; 4d.
     under the eth scheme, self_proof_eth.bin;
  5. the slice at size: a 2^16-step plain-layout run proved under the
     generic scheme with the default ProofOptions (trace 2^20 rows, LDE
     2^21), twice, accepted by the port's verifier and rejected with one
     byte flipped; every kernel's launch count in the first prove must be
     > 0; each slice line carries its proof's sha256 (the prover is
     deterministic: a kernel redesign must leave it unchanged);
  6. the same claim under the cairo scheme (friendly Merkle trees, Pedersen
     levels through ec_madd_walk), twice, verified at 80 bits and rejected
     tampered; ec_madd_walk and every kernel of phase 5 must have launched;
  3f. the Goldilocks kernels (gl_mul/add/sub, gl3_mul) against their plain
     twins at 2^21 elements and in the broadcast forms the prover passes;
  3g. the two steps of plain-gl3-2^16's forward LDE (2^21 rows by 5
     GF(p^3) columns, 15 Goldilocks columns): the fused first leaf
     (gl_ntt_leaf_fused: leaf, w^(k c) multiply, transposed store) at
     [2048, 1024 x 15, 2] and gl_ntt_leaf at [1024, 2048 x 15, 2], and
     the leaf at [2048, 15360, 2] besides (the kernels line's row); GL and
     GL3 transforms at 2^12 and 2^21 against the plain radix-2;
  3h. the ALU probe (tools/probe_alu.py), run through its entry point:
     every op against its plain chain, Tops/s per op;
  4c. the tiny Goldilocks and GF(p^3) proofs on the card, and the tiny
     Goldilocks proof under the cairo scheme, whose sha256 must equal
     TINY_SHA256 (the JAX package's proofs of the same claims); the
     Goldilocks one is gl_mul's path (the GF(p^3) slice multiplies in
     gl3_mul and its four-step twiddles in the fused leaf): its launches
     are counted from zero and gl_mul's must be > 0;
  7. the slice in GF(p^3) (plain-gl3-2^16): the claim of phase 5 with
     Goldilocks trace values and GF(p^3) challenges, twice, verified at 80
     bits and rejected tampered; every Goldilocks kernel and blake2s_rows
     must have launched, and no Fp252 kernel; the second prove, its tables
     built, launches no gl_mul;
  8. the recursive layout (recursive-cairo-16384): the 16384-step claim of
     claims.recursive_loop_claim (trace 2^18 rows by 7 + 3 columns, 93
     constraints, periodic Pedersen columns, three made-up Pedersen and
     three bitwise instances) under the cairo scheme at the default
     ProofOptions, as bench.py proves the recursive layout: the trace build
     timed on the host, two proves with identical bytes, verified at 80
     bits and rejected tampered; every fp252 kernel, ec_madd_walk included,
     must have launched, and the proof's sha256 must equal
     RECURSIVE_SHA256.  Phase 3b also times the leaves at this path's
     largest transform (the base LDE, 2^19 rows by 7 columns) and phase 3c
     the opener at its pair list (135 pairs on 73 points, 12 columns,
     n = 2^18): those rows of the kernels line carry path slice_recursive;
     3b, 3c and 3i time the leaves, the opener and keccak_rows at phase
     10's shapes too (the base LDE of 2^22 rows by 9 columns: ntt_leaf_fused
     at [2048, 2048 x 9] and ntt_leaf at [2048, 2048 x 9]; 271 pairs on 192
     points, 12 columns, n = 2^21; the 9-felt base rows, [2^22, 72], three
     absorbed blocks a row): rows with path slice_starknet;
  9. bundles through the command line (cli.main in this process, so that
     the launch counters count): (a) plain-eth-2^16, the bundle of phase
     5's run (tools/make_artifacts.loop_bundle) proved with --scheme eth at
     the default options twice with equal bytes, verified at 80 bits
     through the CLI and through `python -m sandstorm_tpu_torch` in a
     subprocess, which must also reject it with one byte flipped;
     keccak_rows, pow_grind and every fp252 kernel must have launched, and
     neither blake2s_rows nor ec_madd_walk; (b) the bundle of phase 8's
     claim (make_artifacts.recursive_bundle) proved under the layout's
     scheme (cairo), whose sha256 must equal RECURSIVE_SHA256, verified
     through the CLI.  The cairo paths (6, 8, 9b) grind through pow_grind;
 10. the starknet layout (starknet-eth-2^21, slice_starknet): the bundle of
     claims.starknet_loop_claim(131072) (make_artifacts.starknet_bundle:
     2^21 rows by 9 + 1 columns, 195 constraints, made-up instances of
     every builtin) proved through the CLI with no --scheme (the layout's
     eth) at the default options twice with equal bytes, whose sha256 must
     equal STARKNET_SHA256, verified at 80 bits through the CLI and
     rejected with one byte flipped; keccak_rows, pow_grind and every fp252
     kernel must have launched, and neither blake2s_rows nor ec_madd_walk;
     its line gives the bundle write, the trace build, the proves and the
     engine's phases, verify_s, the peak device memory, the proof's size
     and the windows of the constraint evaluation and of DEEP; the trace
     build's seconds a builtin (Pedersen, ECDSA, EC-op: the whole, the
     native batch's share and the hand-off);
 10b. starknet-eth-2^21-ec (slice_starknet_ec): the same claim with every
     Pedersen, ECDSA and EC-op slot filled (claims.starknet_ec_counts:
     4096, 64, 128), its bundle written, the trace built on the native
     route (the witness seconds split as in 10), proved once through the
     CLI at the default options, whose sha256 must equal
     STARKNET_EC_SHA256, verified at 80 bits through the CLI and rejected
     with one byte flipped; it must launch the kernels slice_starknet
     launched, and the kernels line lists them with path
     slice_starknet_ec (their times those of the row named in timed_as).
 10c. plain-cairo-gl-2^16 (slice_cairo_gl): the claim of phase 5 over
     Goldilocks under the cairo scheme (claims.loop_claim(65536,
     field=GL, scheme="cairo"), the claim API's route), the Pedersen table
     evicted first, proved twice with equal bytes, whose sha256 must equal
     SLICE_SHA256, verified at 64 bits (the Goldilocks field's cap of the
     default options) and rejected with one byte flipped; every kernel of
     CAIRO_GL_KERNELS must have launched and none of CAIRO_GL_ABSENT.
     Then the rows' conversion chain (widen, fp252_mul by R^2, byte
     reversal) on one 2^21-row column, held to to_montgomery_bytes on a
     sample, timed, with its device ms a prove; and the proof's own Blake2s
     grind replayed (its prefix recorded from the coin): a launch a window
     of WINDOW batches, each against the plain twin over the same window,
     the kernel alone, the launches with their reads, the plain twin.  Phase 3g times the leaves at this
     path's LDE (2^21 rows by 5 columns: gl_ntt_leaf_fused at [2048,
     1024 x 5, 2], gl_ntt_leaf at [1024, 2048 x 5, 2]); the kernels line
     lists this path's kernels with path slice_cairo_gl, the leaves and
     the grind at its own shapes, the others as the row in timed_as.
  3k. the running-product scan (fp252_scan_mul, one launch) and the
     segmented batch inversion (fp252_batch_inv, two launches and one host
     trip) against their plain versions (prefix_scan of mul_plain,
     batch_inv_plain, on the card): at ragged lengths around a tile in 1
     and 4 columns, both directions, with a zero in a column; one call
     over segments of mixed lengths with zeros; 10 repeats at 2^20 (a
     look-back race shows as a rare wrong row); at 2^21 and 2^22 rows,
     timed (the inversion's two launches alone, the whole call, the host
     trip alone); then tools/time_scan.py's line: a batch inversion's
     microseconds at n = 1 .. 2^22 and 25 arrays in one call against 25
     calls;
  3l. the generated constraint-group kernels (air_group) of the plain,
     recursive and starknet layouts at their paths' shapes (N = 2^21,
     2^19, 2^22) on random columns: each against the plain interpreter of
     the same programs over the card's plain field ops (over the whole
     domain; starknet over its first and last 2^18 rows), and the starknet
     fold against the eager route's result over the whole domain;
  3m. DEEP (deep_compose: one batch inversion of u = 1 / (x - z) and v =
     1 / (x - z^m), then the kernel, which reads a trace point's inverses
     at a shifted row) at the recursive path's 73 points / 135 terms
     (N = 2^19) and starknet's 192 points / 271 terms (N = 2^22) against
     _deep_compose (the windowed loop of the JAX package's form over the
     plain field ops; starknet over its first and last 2^17 rows); the
     whole call and the kernel alone timed, the bound of the least work
     (T + K montmuls a row and the inversions' 3 an element) with the
     fraction form's count (T + 3K + 2) beside it.
  3n. the native lockstep witness batch (host C++, native/ecdsa.cpp,
     built by this machine's c++) against the python `new`, bit-exact: 32
     Pedersen instances (a = b = 0 among them), 4 signatures (keys k and
     FR - k: at least one takes the batch's mirrored-y call), 8 EC ops,
     and the three dummy templates.
 11. multi-device proving (parallel/): (a) the tiny generic, cairo,
     Goldilocks and GF(p^3) claims under make_mesh(4, device=cuda:0)
     equal their oracles (the pinned bytes, TINY_SHA256); (b)
     recursive-cairo-16384 (mesh_recursive) under make_mesh(4) on the one
     card, or one shard a card where there are several: proved twice,
     sha256 == RECURSIVE_SHA256, verified at 80 bits, rejected tampered,
     dist_ntt called and every kernel of PATHS["mesh_recursive"] launched,
     beside the same process's single-device warm prove; then
     (mesh_kernels) the path's own shapes against their plain versions,
     timed: each shard's leaf on its columns, [2^9, 2^10 / D x 7], and on
     its rows, [2^10, 2^9 / D x 7] (the base LDE's split), and the
     twiddle fp252_mul of [2^9, 2^10 / D, 7] by [2^9, 2^10 / D, 1]; the
     kernels line's mesh_recursive rows of ntt_leaf (both leaves summed)
     and fp252_mul carry these; (c) two
     processes (tools/mesh_prove.py: a file rendezvous, one shard each;
     NCCL with a card a process where there are two cards, else both on
     this card through a gloo group, named so in the line) each prove the stand-in to
     RECURSIVE_SHA256 and verify it; (d) the grind's windows, both hashes:
     the first hit in the first batch, in a later batch, in none, each
     against the plain twin over the same window, timed; the recursive
     proof's own grind replayed as in 10c; pow_grind's launches a prove.
Every fp252 slice's first prove (5, 6, 8, 9a, 9b, 10, 10b) must have launched
fp252_scan_mul, fp252_batch_inv, air_group and deep_compose (the route of
a CUDA Fp252 prove: constraint evaluation and DEEP in one window each),
the GF(p^3) slice none of them; the slice lines give the two phases' seconds.
The 2^16-step proofs' sha256 must equal SLICE_SHA256.
Then the nvidia-smi line, the bound of the walk at 8-bit windows (on no
path, so outside the table), the kernels table {"kernels": [...]}, and last
{"ok": true, "device": {...}}.  Each kernel's `launches` is its count in
the run of the path named by its `path` (a slice's first prove, the tiny
Goldilocks prove, the probe tool's run, or a prove of phase 9).  Its
`bound_ms` is the least time the card could take for the work of its
timed call: the larger of the bytes it must move (each
input read once, each output written once) over HBM_BYTES_PER_S and its
IMAD-pipe operations (or, for Blake2s, Keccak and the grind, ALU
operations) over the u32 multiply (add) rate that phase 3h's probe
measured in this run; the counts are taken from this run's inputs (the
walk counts its nonzero windows).  `library_ms` is null for every kernel:
no single PyTorch call computes a prime-field product, transform, EC walk,
Blake2s, Keccak or a grind.  Any failure raises before the last line.
Without a CUDA device, or without the repository around it, the script
exits non-zero and prints no result.
"""

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 1 << 16
RECURSIVE_STEPS = 1 << 14
STARKNET_STEPS = 1 << 17
# sha256 of the JAX package's proofs of the tiny claim (16 steps,
# ProofOptions(num_queries=4, proof_of_work_bits=4), generic scheme) over
# Goldilocks and with GF(p^3) challenges: tests/test_torch_gl_slice.py
# holds the port's CPU proofs to them and compares with a live JAX prove
TINY_SHA256 = {
    "goldilocks":
        "ec1784946847a2a82e0618f930748a39b8c328aa7d1e7f46c850994867a869a2",
    "gl3":
        "c5e6371ad984c35655849e4307ba578c4c58bd80fef54dc921cdaac26a64185f",
    # the same claim over Goldilocks under the cairo scheme
    # (tests/data/self_proof_cairo_gl.bin; tests/test_torch_cairo_gl.py)
    "goldilocks_cairo":
        "05044dd28e11034973aa8e09d53ee0d168aeb7534084b1823ec57b15819f3e5c",
}

# sha256 of the proofs of phases 5-7, 9a and of phase 8 (and 9b): a change
# that moves one has changed the proof.  The JAX package's CPU prove of
# phase 8's claim gives the same bytes (tests/data/recursive_proof_cairo.bin,
# which tests/test_torch_recursive_proof.py holds to this digest); the JAX
# package's verifier accepts phase 9a's proof
SLICE_SHA256 = {
    "slice":
        "cfb909a0eacc1a03119a810bf6c90bb77cb0f70f1de515c95a124d220cf3f290",
    "slice_cairo":
        "02d6ab36d4f02a32a2f6679dd012e46ea2e50653e229c66ecbc93468cc858953",
    "slice_gl3":
        "2b5a7f9e0c9dc10c82e4088970c2a84fb81ef58092772e3662d0b9a9f5433284",
    "slice_eth":
        "50e1d3c848923c95591ab064c2288cdef3e0235724487d84e10626f4d0b0a39b",
    # phase 10c, plain-cairo-gl-2^16 (tests/data/plain_cairo_gl_proof.bin,
    # which both packages' verifiers accept at 64 bits on the CPU)
    "slice_cairo_gl":
        "53cb725b99cb39d7562aff17db1ad15af72a7fb74d4478ee21d501a27d6311e2",
}
RECURSIVE_SHA256 = \
    "5a5901ddcd95523a97542da64505296d7b8cebe5d7e7e80ec8c81264eab0b099"
# sha256 of phase 10's proof (tests/data/starknet_proof_eth.bin, which
# both packages' verifiers accept on the CPU)
STARKNET_SHA256 = \
    "0173f39a26ba0936386de3015e4d16a58f6acf6a9dcbfe7d768bec157f0319cf"
# sha256 of phase 10b's proof, starknet-eth-2^21-ec
# (tests/data/starknet_ec_proof_eth.bin, which both packages' verifiers
# accept on the CPU)
STARKNET_EC_SHA256 = \
    "c340221ff39b6d6a479c67beee5ac8585f837db5d9bac676f3564d40af4ae80b"

# kernel entry -> (source, TPU kernel it replaces)
KERNELS = {
    "fp252_mul": ("sandstorm_tpu_torch/csrc/fp252.cu",
                  "sandstorm_tpu/fields/fp252_pallas.py:239"),
    "fp252_add": ("sandstorm_tpu_torch/csrc/fp252.cu",
                  "sandstorm_tpu/fields/fp252_pallas.py:97"),
    "fp252_sub": ("sandstorm_tpu_torch/csrc/fp252.cu",
                  "sandstorm_tpu/fields/fp252_pallas.py:110"),
    "ntt_leaf": ("sandstorm_tpu_torch/csrc/ntt.cu",
                 "sandstorm_tpu/ntt/ntt_pallas.py:101"),
    "ntt_leaf_fused": ("sandstorm_tpu_torch/csrc/ntt.cu",
                       "sandstorm_tpu/ntt/ntt_pallas.py:101"),
    "open_pairs": ("sandstorm_tpu_torch/csrc/open_pairs.cu",
                   "sandstorm_tpu/fields/fp252_pallas.py:336"),
    "blake2s_rows": ("sandstorm_tpu_torch/csrc/blake2s.cu",
                     "sandstorm_tpu/hashing/blake2s.py:95"),
    "ec_madd_walk": ("sandstorm_tpu_torch/csrc/ec_madd.cu",
                     "sandstorm_tpu/fields/fp252_pallas.py:181"),
    "gl_mul": ("sandstorm_tpu_torch/csrc/goldilocks.cu",
               "sandstorm_tpu/fields/gl_pallas.py:29"),
    "gl_add": ("sandstorm_tpu_torch/csrc/goldilocks.cu",
               "sandstorm_tpu/fields/gl_pallas.py:40"),
    "gl_sub": ("sandstorm_tpu_torch/csrc/goldilocks.cu",
               "sandstorm_tpu/fields/gl_pallas.py:47"),
    "gl3_mul": ("sandstorm_tpu_torch/csrc/goldilocks.cu",
                "sandstorm_tpu/fields/gl3.py:284"),
    "gl_ntt_leaf": ("sandstorm_tpu_torch/csrc/gl_ntt.cu",
                    "sandstorm_tpu/ntt/ntt_pallas.py:101"),
    "gl_ntt_leaf_fused": ("sandstorm_tpu_torch/csrc/gl_ntt.cu",
                          "sandstorm_tpu/ntt/ntt_pallas.py:101"),
    "probe_alu": ("sandstorm_tpu_torch/csrc/probe_alu.cu",
                  "tools/probe_alu.py:31"),
    "keccak_rows": ("sandstorm_tpu_torch/csrc/keccak.cu",
                    "sandstorm_tpu/hashing/keccak.py:115"),
    "pow_grind": ("sandstorm_tpu_torch/csrc/grind.cu",
                  "sandstorm_tpu/crypto/grind.py:33"),
    "fp252_scan_mul": ("sandstorm_tpu_torch/csrc/scan.cu",
                       "sandstorm_tpu/fields/scan.py:56"),
    "fp252_batch_inv": ("sandstorm_tpu_torch/csrc/scan.cu",
                        "sandstorm_tpu/fields/fp252.py:534"),
    # the generator of the group kernels (the generated source is a build
    # product under sandstorm_tpu_torch/_build/)
    "air_group": ("sandstorm_tpu_torch/air/codegen.py",
                  "sandstorm_tpu/air/expr.py:677"),
    "deep_compose": ("sandstorm_tpu_torch/csrc/deep.cu",
                     "sandstorm_tpu/stark/prover.py:554"),
}
# the kernels of each path: the generic scheme's (phase 5), the cairo
# scheme's (phase 6), the GF(p^3) slice's (phase 7), the tiny Goldilocks
# prove's (phase 4c: gl_mul's path) and the probe tool's
FP252_KERNELS = ["fp252_mul", "fp252_add", "fp252_sub", "ntt_leaf",
                 "ntt_leaf_fused", "open_pairs", "fp252_scan_mul",
                 "fp252_batch_inv", "air_group", "deep_compose"]
GENERIC_KERNELS = FP252_KERNELS + ["blake2s_rows"]
# the Cairo coin grinds its proof of work through pow_grind (Blake2s)
CAIRO_KERNELS = GENERIC_KERNELS + ["ec_madd_walk", "pow_grind"]
GL3_KERNELS = ["gl_add", "gl_sub", "gl3_mul", "gl_ntt_leaf",
               "gl_ntt_leaf_fused", "blake2s_rows"]
TINY_GL_KERNELS = ["gl_mul", "gl_add", "gl_sub", "gl_ntt_leaf",
                   "blake2s_rows"]
# the eth scheme (phase 9a): Keccak trees and the Solidity coin's Keccak
# grind, and no Blake2s or Pedersen
ETH_KERNELS = FP252_KERNELS + ["keccak_rows", "pow_grind"]
ETH_ABSENT = ["blake2s_rows", "ec_madd_walk"]
# the cairo scheme over Goldilocks (phase 10c): GL transforms and
# arithmetic, the rows widened to Stark252 Montgomery felts (fp252_mul),
# Blake2s rows, Pedersen merges (ec_madd_walk, then fp252_batch_inv and
# fp252_mul for x = X / Z^2) and the Blake2s grind; no Fp252 transform,
# opener, constraint or DEEP kernel
CAIRO_GL_KERNELS = ["gl_mul", "gl_add", "gl_sub", "gl_ntt_leaf",
                    "gl_ntt_leaf_fused", "fp252_mul", "fp252_batch_inv",
                    "blake2s_rows", "ec_madd_walk", "pow_grind"]
CAIRO_GL_ABSENT = ["ntt_leaf", "ntt_leaf_fused", "open_pairs",
                   "fp252_scan_mul", "air_group", "deep_compose", "gl3_mul"]
# recursive-cairo-16384 under a mesh (phase 11b): every transform is the
# exchange NTT, whose shards' transforms are single leaves (n1, n2 <=
# 2^10), so the fused first leaf has no launch to make there
MESH_KERNELS = [k for k in CAIRO_KERNELS if k != "ntt_leaf_fused"]
PATHS = {"slice_cairo": CAIRO_KERNELS, "slice_gl3": GL3_KERNELS,
         "tiny_gl": ["gl_mul"], "probe_alu": ["probe_alu"],
         "slice_recursive": CAIRO_KERNELS, "slice_eth": ETH_KERNELS,
         "cli_recursive": CAIRO_KERNELS, "slice_cairo_gl": CAIRO_GL_KERNELS,
         "mesh_recursive": MESH_KERNELS}
# the path of each kernel's row: the first path above that runs it, but
# the eth path for the two kernels it brought (pow_grind's row is the eth
# proof's own Keccak grind, replayed; the Blake2s grinds are in the
# slice_cairo_gl_costs and grind_windows lines)
ROW_PATH = {**{k: next(p for p, ks in PATHS.items() if k in ks)
               for k in KERNELS},
            "keccak_rows": "slice_eth", "pow_grind": "slice_eth",
            "fp252_scan_mul": "slice_starknet",
            "fp252_batch_inv": "slice_starknet",
            "deep_compose": "slice_starknet"}
# the kernels timed again at the recursive and starknet paths' own shapes
# (air_group's main row is the plain path's, deep_compose's and the scan
# kernels' the starknet path's)
RECURSIVE_ROWS = ["ntt_leaf", "ntt_leaf_fused", "open_pairs", "air_group",
                  "deep_compose"]
STARKNET_ROWS = ["ntt_leaf", "ntt_leaf_fused", "open_pairs", "keccak_rows",
                 "air_group"]

# the bound of each kernel row (see the docstring): device memory rate of
# the H100 SXM (its published HBM3 rate), and the operations
# a kernel's arithmetic needs, counted from its inputs.  A 32 x 32 -> 64
# product is two IMAD-pipe issues (IMAD + IMAD.HI.U32 in the SASS of
# fp252_mul).  A montmul needs 64 products, a square 36 (the triangle and
# the diagonal); the REDC needs none, because p = 1 + 2^192 (1 + 2^4 + 2^59)
# makes its multipliers a negation and its terms shifted copies
HBM_BYTES_PER_S = 3.35e12
MONTMUL_IMAD = 64 * 2
SQUARE_IMAD = 36 * 2
MADD_IMAD = 7 * MONTMUL_IMAD + 4 * SQUARE_IMAD   # madd-2007-bl: 7M + 4S
GL_MUL_IMAD = 8             # 64 x 64 -> 128 bits: four 32 x 32 products
GL3_MUL_GL_MULS = 9
BLAKE2S_BLOCK_ALU = 1136    # 10 rounds x 8 G x 14 ops, 16 finalising XORs
# a Keccak-f[1600] permutation on 32-bit halves: 24 rounds of theta (the
# five column parities as two three-input XORs a half, two funnel shifts a
# rotated parity, 50 XORs into the lanes), rho (24 lanes x 2 funnel
# shifts), chi (one LOP3 a half-lane) and iota (2 XORs): 20 + 10 + 50 +
# 48 + 50 + 2 = 180 a round
KECCAK_PERM_ALU = 24 * 180

def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def run_cmd(args):
    proc = subprocess.run(args, capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"{args[0]} failed: {proc.stderr[-500:]}")
    return proc.stdout.strip()


def cuda_ms(torch, fn, iters):
    """Mean milliseconds of fn() over `iters` back-to-back calls, by CUDA
    events after a quarter as many warm-up calls (at least one)."""
    for _ in range(max(1, iters // 4)):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_once(torch, fn):
    """(fn(), milliseconds of that one call by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(torch, a, b):
    """Largest |difference| of the u32 words of two limb tensors."""
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    da = a.to(torch.int64) & 0xFFFFFFFF
    db = b.to(torch.int64) & 0xFFFFFFFF
    return int((da - db).abs().max().item()) if a.numel() else 0


def ptxas_report(log):
    """({kernel: registers}, {kernel: [stack frame bytes, spill store
    bytes, spill load bytes]}) from nvcc's -Xptxas -v report."""
    names = [("blake2s_kernel", "blake2s_rows"),
             ("12binop_kernelILi0", "fp252_add"),
             ("12binop_kernelILi1", "fp252_sub"),
             ("12binop_kernelILi2", "fp252_mul"),
             ("15ntt_leaf_kernelILi3ELb0E", "ntt_leaf"),
             ("15ntt_leaf_kernelILi3ELb1E", "ntt_leaf_fused"),
             ("15gl_binop_kernelILi0", "gl_add"),
             ("15gl_binop_kernelILi1", "gl_sub"),
             ("15gl_binop_kernelILi2", "gl_mul"),
             ("14gl3_mul_kernel", "gl3_mul"),
             ("18gl_ntt_leaf_kernelILi4ELb0E", "gl_ntt_leaf"),
             ("18gl_ntt_leaf_kernelILi4ELb1E", "gl_ntt_leaf_fused"),
             ("12probe_kernelILi2", "probe_alu"),
             ("open_pairs_kernel", "open_pairs"),
             ("walk_kernelILi16", "ec_madd_walk"),
             ("walk_kernelILi8", "ec_madd_walk_w8"),
             ("keccak_kernel", "keccak_rows"),
             ("grind_kernelILi0", "pow_grind"),
             ("grind_kernelILi1", "pow_grind_blake2s"),
             ("11scan_kernel", "fp252_scan_mul"),
             ("18inv_forward_kernel", "fp252_batch_inv_forward"),
             ("19inv_backward_kernel", "fp252_batch_inv_backward"),
             ("11deep_kernel", "deep_compose"),
             ("10dot_kernel", "fp252_dot")]
    regs, spills, cur = {}, {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = next((n for key, n in names if key in line), None)
        elif "Used" in line and "registers" in line and cur:
            regs[cur] = int(line.split("Used")[1].split()[0])
        elif "spill stores" in line and cur:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spills[cur] = nums[:3]   # stack frame, stores, loads
    return regs, spills


def ptxas_generated(log):
    """{group: [registers, stack frame bytes, spill store bytes, spill load
    bytes]} of a generated library's kernels g0, g1, ..., and the same
    (registers None) under "<group>M" / "<group>Q" for the out-of-line
    product and square that group's unit compiles, from -Xptxas -v."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) "
                      r"'?(\S+?)'?(?: for|$)", line)
        if m:
            g = re.search(r"g(\d+)ENS_4TabsE", m.group(1))
            f = re.search(r"air_g(\d+?)1([MQ])EN2fp", m.group(1))
            cur = str(int(g.group(1))) if g else \
                f.group(1) + f.group(2) if f else m.group(1)
            out.setdefault(cur, [None, 0, 0, 0])
        elif "spill stores" in line and cur is not None:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[cur][1:] = nums[:3]
        elif "Used" in line and "registers" in line and cur is not None:
            out[cur][0] = int(line.split("Used")[1].split()[0])
    return out


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from sandstorm_tpu_torch import _native, _tables, cli, native
    from sandstorm_tpu_torch.builtins import curve, ec_op, ecdsa
    from sandstorm_tpu_torch.builtins import pedersen as ped_builtin
    from sandstorm_tpu_torch.builtins.pedersen import pedersen_hash_oracle
    from sandstorm_tpu_torch.claims import (CairoClaim, _made_up_ec_ops,
                                            loop_claim, recursive_loop_claim,
                                            starknet_ec_counts)
    from sandstorm_tpu_torch.crypto import coins as coins_mod
    from sandstorm_tpu_torch.crypto import grind as pow_grind
    from sandstorm_tpu_torch.crypto.coins import (CairoVerifierPublicCoin,
                                                  SolidityVerifierPublicCoin)
    from sandstorm_tpu_torch.crypto.hashes import (MaskedKeccak256HashFn,
                                                   to_montgomery_bytes)
    from sandstorm_tpu_torch.examples import load_artifacts
    from sandstorm_tpu_torch.fields import fp252_cuda as fc
    from sandstorm_tpu_torch.fields import gl_cuda
    from sandstorm_tpu_torch.fields.fp252 import Fp252 as F
    from sandstorm_tpu_torch.fields.gl3 import GL3, Fq3S
    from sandstorm_tpu_torch.fields.goldilocks import GL
    from sandstorm_tpu_torch.hashing import blake2s, keccak
    from sandstorm_tpu_torch.hashing import pedersen
    from sandstorm_tpu_torch.layouts.plain.air import PlainAirConfig
    from sandstorm_tpu_torch.layouts.recursive.air import RecursiveAirConfig
    from sandstorm_tpu_torch.layouts.starknet.air import StarknetAirConfig
    from sandstorm_tpu_torch.ntt import ntt
    from sandstorm_tpu_torch.ntt import ntt_cuda
    from sandstorm_tpu_torch.parallel import dist as pdist
    from sandstorm_tpu_torch.parallel import make_mesh
    from sandstorm_tpu_torch.stark import prover
    from sandstorm_tpu_torch.stark.ark import parse_proof, serialize_proof
    from sandstorm_tpu_torch.stark.openings import point_powers
    from sandstorm_tpu_torch.stark.options import ProofOptions
    from sandstorm_tpu_torch.stark.verifier import VerificationError
    from sandstorm_tpu_torch.air import codegen
    from sandstorm_tpu_torch.air.expr import (LdeContext, _fold_run,
                                              _fold_setup, evaluate_lde,
                                              trace_arguments)
    from sandstorm_tpu_torch.air.expr import walk as dag_walk
    from sandstorm_tpu_torch.fields.scan import prefix_scan
    from sandstorm_tpu_torch.tools import make_artifacts, probe_alu, time_scan

    dev = torch.device("cuda", 0)
    P = F.MODULUS
    rng = np.random.default_rng(2026)
    results = {}   # kernel entry -> {max_abs_err, ms, plain_ms, shape}
    rec_results = {}   # the same at the recursive path's shapes
    star_results = {}  # the same at the starknet path's shapes
    # every grind the coins run, (hash, prefix, bits, start, nonce): phase
    # 10c and 11d replay a slice's own grind (the redesigned kernel stops
    # early, so its time depends on the prefix)
    grinds = []
    coin_grind = coins_mod.grind

    def recording_grind(hash_name, prefix, bits, start=1, *, device):
        nonce = coin_grind(hash_name, prefix, bits, start, device=device)
        grinds.append((hash_name, prefix, bits, start, nonce))
        return nonce

    coins_mod.grind = recording_grind

    # -- 1: device and toolchain -----------------------------------------
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"])
    print(smi, flush=True)
    try:
        import triton
        triton_version = triton.__version__
    except ImportError as e:
        triton_version = f"not importable: {e}"
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "python": sys.version.split()[0], "torch": torch.__version__,
          "torch_cuda": torch.version.cuda,
          "nvcc": run_cmd([_native.nvcc_path(),
                           "--version"]).splitlines()[-1],
          "triton": triton_version})

    # -- 2: kernel build ---------------------------------------------------
    t0 = time.perf_counter()
    info = _native.build()
    _native.lib()
    emit({"phase": "build", "built": info["built"],
          "nvcc_s": info["seconds"], "total_s": time.perf_counter() - t0,
          "library": os.path.relpath(info["path"], ROOT),
          **dict(zip(("registers", "stack_spill_bytes"),
                     ptxas_report(info["log"])))})
    # the generated group kernels of every layout at the trace lengths this
    # run proves (the tiny claim's, the 2^16-step slices', the recursive
    # and starknet stand-ins') and at phase 3l's shapes, one nvcc each,
    # all at once
    tiny_claim, tiny_witness = loop_claim(16, dev)
    tiny_n = tiny_claim.generate_trace(tiny_witness).trace_len
    del tiny_claim, tiny_witness
    air_plans = {
        "plain_tiny": codegen.air_plan(PlainAirConfig, tiny_n, 2),
        "plain": codegen.air_plan(PlainAirConfig, 1 << 20, 2),
        "recursive": codegen.air_plan(RecursiveAirConfig, 1 << 18, 2),
        "starknet": codegen.air_plan(StarknetAirConfig, 1 << 21, 2)}
    t0 = time.perf_counter()
    built = codegen.build(air_plans.values())
    air_build_s = time.perf_counter() - t0
    emit({"phase": "build_air", "total_s": air_build_s,
          "layouts": {k: {"stem": pl.stem, "groups": len(pl.groups),
                          "tables": len(pl.tables),
                          "built": built[pl.stem]["built"],
                          "nvcc_s": built[pl.stem]["seconds"],
                          # group -> [registers, stack frame bytes,
                          # spill store bytes, spill load bytes]
                          "ptxas": ptxas_generated(built[pl.stem]["log"])}
                      for k, pl in air_plans.items()}})

    def raw_ms(entry, args, iters):
        """Mean ms of C entry `entry` called straight through ctypes on
        prepared arguments: a wrapper's Python work per call (checks,
        allocation, the counter) takes longer than these kernels run, so
        timing through it would time the host."""
        fn = getattr(_native.lib(), entry)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, stream)
        torch.cuda.synchronize()
        check(rc == 0, f"{entry} returned CUDA error {rc}")
        return cuda_ms(torch, lambda: fn(*args, stream), iters)

    def rand_elems(n):
        """n random field elements (< 2^251) led by 0, 1 and p - 1 in raw
        and in Montgomery form."""
        w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
        w[:, 7] &= (1 << 27) - 1
        x = torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)
        special = F.encode_ints([0, 1, P - 1], dev)
        raw = torch.from_numpy(np.array(
            [[(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
             for v in (0, 1, P - 1)], dtype=np.uint32).view(np.int32)).to(dev)
        x[:3] = special
        x[3:6] = raw
        return x

    # -- 3a: kernel 1, elementwise multiply / add / subtract ----------------
    n = 1 << 20
    a, b = rand_elems(n), rand_elems(n).flip(0).contiguous()
    out = torch.empty_like(a)
    want_host = {"add": lambda x, y: (x + y) % P,
                 "sub": lambda x, y: (x - y) % P,
                 "mul": lambda x, y: x * y % P}
    for op in ("mul", "add", "sub"):
        got = fc.binop(op, a, b)
        err = max_abs_err(torch, got, fc.PLAIN[op](a, b))
        check(err == 0, f"fp252_{op} differs from its plain version")
        xs, ys, zs = (F.decode_ints(t[:512]) for t in (a, b, got))
        check(zs == [want_host[op](x, y) for x, y in zip(xs, ys)],
              f"fp252_{op} differs from python ints")
        results[f"fp252_{op}"] = {
            "max_abs_err": err, "shape": [n, 8],
            "ms": raw_ms(f"fp252_{op}", (a.data_ptr(), 1, n, b.data_ptr(), 1,
                                         n, out.data_ptr(), n), 200),
            "plain_ms": cuda_ms(torch, lambda: fc.PLAIN[op](a, b), 3),
            "work": {"bytes": 96 * n,
                     "imad": MONTMUL_IMAD * n if op == "mul" else 0}}
    # the broadcast operands the prover passes, read in place: a scalar, a
    # tiled period, a repeated table
    a4 = rand_elems(4 * 6 * 5).reshape(4, 6, 5, 8)
    t = rand_elems(24)
    for b4 in (t[0], t.reshape(4, 6, 1, 8), t[:1].reshape(1, 1, 1, 8),
               t[:6].reshape(6, 1, 8), t[:5].reshape(5, 8)):
        shape = list(b4.shape)
        check(max_abs_err(torch, F.mul(a4, b4), fc.mul_plain(a4, b4)) == 0,
              f"fp252_mul with a {shape} operand differs")
        check(max_abs_err(torch, F.sub(b4, a4), fc.sub_plain(b4, a4)) == 0,
              f"fp252_sub with a {shape} operand differs")
    emit({"phase": "kernel_fp252", "n": n, "broadcast_forms_equal": True,
          **{k: v for k, v in results.items() if k.startswith("fp252")}})

    # -- 3a': the unreduced accumulate of fp252.cuh (the fold of the group
    # kernels and of deep_compose): k 512-bit products and one redc, through
    # the PTX carry chain and its plain-C twin, against the plain sum of
    # montmuls and python ints; rows led by p - 1 in every term (the
    # largest sums)
    dot_line = {}
    pm1 = F.encode_ints([P - 1], dev)[0]
    for k in (1, 8, fc.WIDE_TERMS):
        a3, b3 = rand_elems(4096 * k).reshape(4096, k, 8), \
            rand_elems(4096 * k).flip(0).reshape(4096, k, 8)
        a3[:2], b3[:1] = pm1, pm1
        got = fc.dot(a3, b3)
        err = max_abs_err(torch, got, fc.dot_plain(a3, b3))
        err_c = max_abs_err(torch, got, fc.dot(a3, b3, plain_c=True))
        check(err == 0 and err_c == 0, f"the accumulate of {k} products "
              f"differs from its plain-C twin or the plain sum")
        xs, ys = F.decode_ints(a3[:64].reshape(-1, 8)), \
            F.decode_ints(b3[:64].reshape(-1, 8))
        want = [sum(x * y for x, y in zip(xs[r * k:r * k + k],
                                          ys[r * k:r * k + k])) % P
                for r in range(64)]
        check(F.decode_ints(got[:64]) == want,
              f"the accumulate of {k} products differs from python ints")
        dot_line[str(k)] = {"max_abs_err": err, "plain_c_max_abs_err": err_c}
    emit({"phase": "kernel_fp252_dot", "rows": 4096, "terms": dot_line})

    # -- 3b: kernel 2, the NTT leaf ----------------------------------------
    ntt_checks = {}
    for logn in (12, 21):
        N = 1 << logn
        x = rand_elems(N)
        for inverse in (False, True):
            got = ntt(F, x, inverse=inverse)
            t0 = time.perf_counter()
            want = ntt_cuda.ntt_leaf_plain(
                x[:, None], ntt_cuda.stage_table(F, N, inverse, dev))[:, 0]
            if inverse:
                want = fc.mul_plain(want, F.encode_int(pow(N, -1, P), dev))
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            err = max_abs_err(torch, got, want)
            check(err == 0, f"ntt 2^{logn} inverse={inverse} differs")
            ntt_checks[f"2^{logn}{'_inv' if inverse else ''}"] = {
                "max_abs_err": err,
                "ms": cuda_ms(torch, lambda: ntt(F, x, inverse=inverse), 5),
                "plain_radix2_ms": plain_s * 1e3}

    def leaf_entry(M, Bt):
        """ntt_leaf at [M, Bt] against its plain version, timed, with its
        work: one montmul per butterfly whose twiddle is not 1 (stage s has
        M / 2^s butterflies at twiddle index 0: M - 1 in all)."""
        x = rand_elems(M * Bt).reshape(M, Bt, 8)
        tw = ntt_cuda.stage_table(F, M, False, dev)
        err = max_abs_err(torch, ntt_cuda.ntt_leaf(x, tw),
                          ntt_cuda.ntt_leaf_plain(x, tw))
        check(err == 0, f"ntt_leaf differs from its plain version at "
                        f"[{M}, {Bt}]")
        mults = Bt * (M // 2 * (M.bit_length() - 1) - (M - 1))
        return x, tw, mults, {
            "max_abs_err": err, "shape": [M, Bt, 8],
            "ms": cuda_ms(torch, lambda: ntt_cuda.ntt_leaf(x, tw), 10),
            "plain_ms": cuda_ms(
                torch, lambda: ntt_cuda.ntt_leaf_plain(x, tw), 1),
            "work": {"bytes": 2 * x.numel() * 4 + tw.numel() * 4,
                     "imad": MONTMUL_IMAD * mults}}

    def fused_entry(M, C, Bi):
        """(ntt_leaf at [M, C * Bi], ntt_leaf_fused at x [M, C * Bi] ->
        [C, M * Bi]: output k of column c * Bi + b times w^(k c), the
        twiddle 1 where k = 0 or c = 0), each against its plain version,
        timed, with its work."""
        x, tw, leaf_mults, leaf = leaf_entry(M, C * Bi)
        rc = ntt_cuda._rc_twiddle(F, M * C, M, False, dev)
        err = max_abs_err(torch, ntt_cuda.ntt_leaf_fused(x, tw, rc, Bi),
                          ntt_cuda.ntt_leaf_fused_plain(x, tw, rc, Bi))
        check(err == 0, f"ntt_leaf_fused differs from its plain version at "
                        f"[{M}, {C} x {Bi}]")
        return leaf, {
            "max_abs_err": err, "shape": [M, C * Bi, 8], "Bi": Bi,
            "ms": cuda_ms(torch, lambda: ntt_cuda.ntt_leaf_fused(
                x, tw, rc, Bi), 10),
            "plain_ms": cuda_ms(
                torch, lambda: ntt_cuda.ntt_leaf_fused_plain(x, tw, rc, Bi),
                1),
            "work": {"bytes": (2 * x.numel() + tw.numel() + rc.numel()) * 4,
                     "imad": MONTMUL_IMAD * (
                         leaf_mults + M * C * Bi - (M + C - 1) * Bi)}}

    # the main path's forward LDE of 2^21 rows by Bi = 5 columns splits as
    # R = 2048 rows by C = 1024: the fused first leaf at [2048, 1024 x 5],
    # then the leaf at [1024, 2048 x 5] (the kernels line's row); the leaf
    # at [2048, 5120] is timed too, the shape earlier commits recorded.
    # The recursive path's largest transform, its base LDE of 2^19 rows by
    # 7 columns, splits as R = 1024 by C = 512
    M, C, Bi = 2048, 1024, 5
    _, _, _, results["ntt_leaf"] = leaf_entry(C, M * Bi)
    leaf_2048, results["ntt_leaf_fused"] = fused_entry(M, C, Bi)
    M, C, Bi = 1024, 512, 7
    _, _, _, rec_results["ntt_leaf"] = leaf_entry(C, M * Bi)
    _, rec_results["ntt_leaf_fused"] = fused_entry(M, C, Bi)
    # the starknet path's base LDE, 2^22 rows by 9 columns: R = C = 2048
    M, C, Bi = 2048, 2048, 9
    _, _, _, star_results["ntt_leaf"] = leaf_entry(C, M * Bi)
    _, star_results["ntt_leaf_fused"] = fused_entry(M, C, Bi)
    emit({"phase": "kernel_ntt", "transforms": ntt_checks,
          "leaf": results["ntt_leaf"], "leaf_2048x5120": leaf_2048,
          "fused_leaf": results["ntt_leaf_fused"],
          "recursive_leaf": rec_results["ntt_leaf"],
          "recursive_fused_leaf": rec_results["ntt_leaf_fused"],
          "starknet_leaf": star_results["ntt_leaf"],
          "starknet_fused_leaf": star_results["ntt_leaf_fused"]})

    # -- 3c: kernel 3, the pair-indexed opener at the main path's shape -----
    def opener_entry(air, n, ncols):
        """open_pairs (one launch) at the pair list a prove of `air` at
        trace length n opens: the trace arguments' (point, column) pairs
        and the composition's 2 columns at z^2, on random columns and
        points, against its plain version, timed through its wrapper (the
        call runs longer than the wrapper's host work; the pairs' group
        table is cached on the card), with its work.  Returns (entry,
        (cols, lo, hi, pts))."""
        g = F.root_of_unity_int(n)
        targs = trace_arguments(air.constraints(n, P, g))
        offsets = sorted({off for (_, off) in targs})
        pairs = sorted({(offsets.index(off), c) for (c, off) in targs})
        pairs += [(len(offsets), ncols + l) for l in range(2)]  # at z^2
        cols = rand_elems((ncols + 2) * n).reshape(ncols + 2, n, 8)
        prng = random.Random(7)
        pts = [prng.randrange(P) for _ in range(len(offsets) + 1)]
        bb = 1 << ((n.bit_length() - 1) // 2)
        lo = point_powers(F, pts, bb, dev)
        hi = point_powers(F, [pow(pt, bb, P) for pt in pts], n // bb, dev)
        kidx, cidx = [k for k, _ in pairs], [c for _, c in pairs]
        got = fc.open_pairs(cols, lo, hi, kidx, cidx)
        t0 = time.perf_counter()
        want = fc.open_pairs_plain(cols, lo, hi, kidx, cidx)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(torch, got, want)
        check(err == 0, f"open_pairs differs from its plain version at "
                        f"{len(pairs)} pairs on {len(pts)} points")
        # montmuls the arithmetic needs: the power of each point named once
        # per coefficient, then one product per (pair, coefficient); the
        # kernel forms the power once per group
        # (z_products_per_coefficient)
        ngroups = fc.pair_groups(kidx, cidx).shape[0]
        return {
            "max_abs_err": err, "pairs": len(pairs), "points": len(pts),
            "shape": [len(pairs), ncols + 2, n, 8],
            "ms": cuda_ms(
                torch, lambda: fc.open_pairs(cols, lo, hi, kidx, cidx), 10),
            "plain_ms": plain_ms, "groups": ngroups,
            "z_products_per_coefficient": ngroups,
            "work": {"bytes": (cols.numel() + lo.numel() + hi.numel()
                               + got.numel()) * 4,
                     "imad": MONTMUL_IMAD * n * (
                         len(pairs) + len({k for k, _ in pairs}))}}, \
            (cols, lo, hi, pts)

    ncols = PlainAirConfig.NUM_BASE_COLUMNS \
        + PlainAirConfig.NUM_EXTENSION_COLUMNS
    results["open_pairs"], (cols, lo, hi, pts) = opener_entry(
        PlainAirConfig, 1 << 20, ncols)
    # a pair list out of order in which point 1 names every column (more
    # than one group of OPEN_GROUP), a column is named by every point, and
    # one pair comes twice
    prng = random.Random(8)
    wide = [(1, c) for c in range(ncols + 2)] \
        + [(k, 2) for k in range(len(pts))] + [(0, 0), (3, 5), (0, 0)]
    prng.shuffle(wide)
    check(max(sum(1 for k, _ in wide if k == kk) for kk in range(len(pts)))
          > fc.OPEN_GROUP, "the wide pair list fits one group")
    wk, wc = [k for k, _ in wide], [c for _, c in wide]
    wide_err = max_abs_err(torch, fc.open_pairs(cols, lo, hi, wk, wc),
                           fc.open_pairs_plain(cols, lo, hi, wk, wc))
    check(wide_err == 0, "open_pairs differs from its plain version on a "
                         "point with more columns than a group")
    results["open_pairs"]["max_abs_err"] = max(
        results["open_pairs"]["max_abs_err"], wide_err)
    del cols, lo, hi
    # the recursive path's pair list: 133 trace arguments on 72 row offsets
    # over 10 columns, and the composition at z^2 (n = 2^18)
    rec_results["open_pairs"], _ = opener_entry(
        RecursiveAirConfig, 1 << 18, RecursiveAirConfig.NUM_BASE_COLUMNS
        + RecursiveAirConfig.NUM_EXTENSION_COLUMNS)
    check((rec_results["open_pairs"]["pairs"],
           rec_results["open_pairs"]["points"]) == (135, 73),
          "the recursive pair list is not 135 pairs on 73 points")
    # the starknet path's: 269 trace arguments on 191 row offsets over 10
    # columns, and the composition at z^2 (n = 2^21)
    star_results["open_pairs"], _ = opener_entry(
        StarknetAirConfig, 1 << 21, StarknetAirConfig.NUM_BASE_COLUMNS
        + StarknetAirConfig.NUM_EXTENSION_COLUMNS)
    check((star_results["open_pairs"]["pairs"],
           star_results["open_pairs"]["points"]) == (271, 192),
          "the starknet pair list is not 271 pairs on 192 points")
    emit({"phase": "kernel_open_pairs", "wide_pairs": len(wide),
          "open_pairs": results["open_pairs"],
          "open_pairs_recursive": rec_results["open_pairs"],
          "open_pairs_starknet": star_results["open_pairs"]})

    # -- 3d: kernel 4, Blake2s ------------------------------------------------
    for W, label in ((40, "rows"), (16, "node_pairs")):
        msg = torch.from_numpy(rng.integers(
            0, 1 << 32, size=(1 << 16, W), dtype=np.uint64).astype(
            np.uint32).view(np.int32)).to(dev)
        got = blake2s.blake2s_words(msg)
        err = max_abs_err(torch, got, blake2s.blake2s_words_plain(msg, 4 * W))
        check(err == 0, f"blake2s {label} differs from its plain version")
        host_msg = msg[:64].cpu().numpy().view(np.uint32)
        host_dig = got[:64].cpu().numpy().view(np.uint32)
        for r in range(64):
            check(host_dig[r].astype("<u4").tobytes() == hashlib.blake2s(
                host_msg[r].astype("<u4").tobytes(), digest_size=32).digest(),
                f"blake2s {label} row {r} differs from hashlib")
        entry = {"max_abs_err": err, "shape": [1 << 16, W],
                 "ms": raw_ms("blake2s_rows", (msg.data_ptr(), msg.shape[0],
                                               W, 4 * W, got.data_ptr()), 200),
                 "plain_ms": cuda_ms(
                     torch, lambda: blake2s.blake2s_words_plain(msg, 4 * W),
                     2),
                 "work": {"bytes": (msg.numel() + got.numel()) * 4,
                          "alu": msg.shape[0] * -(-4 * W // 64)
                          * BLAKE2S_BLOCK_ALU}}
        if W == 40:
            results["blake2s_rows"] = entry
        emit({"phase": f"kernel_blake2s_{label}", **entry})
    # byte lengths that end inside a word, and the empty message
    for W, nbytes in ((3, 9), (1, 0)):
        msg = torch.from_numpy(rng.integers(
            0, 1 << 32, size=(300, W), dtype=np.uint64).astype(
            np.uint32).view(np.int32)).to(dev)
        got = blake2s.blake2s_words(msg, nbytes)
        check(max_abs_err(torch, got,
                          blake2s.blake2s_words_plain(msg, nbytes)) == 0,
              f"blake2s of {nbytes} bytes differs from its plain version")
        host_msg = msg.cpu().numpy().view(np.uint32)
        host_dig = got.cpu().numpy().view(np.uint32)
        for r in range(0, 300, 37):
            check(host_dig[r].astype("<u4").tobytes() == hashlib.blake2s(
                host_msg[r].astype("<u4").tobytes()[:nbytes],
                digest_size=32).digest(),
                f"blake2s of {nbytes} bytes, row {r}, differs from hashlib")
    emit({"phase": "kernel_blake2s_short", "byte_lengths": [9, 0],
          "equal": True})

    # -- 3e: kernel 5, the Pedersen walk -------------------------------------
    # the 8-bit window tables, built in python on the host once per process
    # (the host C++ batch and the 8-bit walk read them), then the 16-bit
    # table on its own: combined from them on the card through the montmul
    # kernel, once per device
    t0 = time.perf_counter()
    native._window_tables()
    tables8_host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t16 = pedersen.tables16(F, dev)
    torch.cuda.synchronize()
    table16_s = time.perf_counter() - t0
    t8, shift = pedersen.tables8(dev), pedersen.shift_point(dev)
    walk = {}
    # 2^20 pairs: the first Pedersen level of a 2^21-leaf tree, the main
    # path's largest
    for bits, M in ((16, 1 << 20), (8, 1 << 12)):
        table = t16 if bits == 16 else t8
        a, b = rand_elems(M), rand_elems(M).flip(0).contiguous()
        got = fc.ec_madd_walk(a, b, table, shift, bits)
        want, plain_ms = cuda_ms_once(
            torch, lambda: fc.ec_madd_walk_plain(a, b, table, shift, bits))
        err = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
        check(err == 0, f"ec_madd_walk ({bits}-bit) differs from its plain "
                        f"version at M = {M}")
        # one madd per nonzero window of this run's inputs
        adds = int((torch.cat([fc.window_values(a, bits),
                               fc.window_values(b, bits)], 1) != 0).sum())
        walk[bits] = {"max_abs_err": err, "shape": [M, 8], "M": M,
                      "ms": cuda_ms(torch, lambda: fc.ec_madd_walk(
                          a, b, table, shift, bits), 5),
                      "plain_ms": plain_ms, "madds": adds,
                      "work": {"bytes": M * 5 * 32 + adds * 64,
                               "imad": adds * MADD_IMAD}}
    results["ec_madd_walk"] = walk[16]
    del a, b, got, want
    # hash_pairs against the host C++ batch (all) and the python oracle
    # (a few), with zero inputs, a high window and masked-digest sizes
    prng = random.Random(11)
    av = [0, 5, prng.getrandbits(160), 0, P - 1] + [
        prng.getrandbits(251) for _ in range(1019)]
    bv = [0, 0, prng.getrandbits(160), (1 << 248) + 5, P - 1] + [
        prng.getrandbits(160 if i % 2 else 251) for i in range(1019)]

    def canon(vals):
        return torch.from_numpy(np.stack(
            [native._int_to_limbs(v) for v in vals]).view(np.int32)).to(dev)

    ca, cb = canon(av), canon(bv)
    hp = pedersen.hash_pairs(F, ca, cb)
    host = native.pedersen_hash_pairs(ca.cpu().numpy().view("<u8"),
                                      cb.cpu().numpy().view("<u8"))
    check(np.array_equal(hp.cpu().numpy().view("<u8"), host),
          "hash_pairs differs from the host C++ batch")
    got_ints = [int.from_bytes(r.tobytes(), "little") for r in host[:8]]
    check(got_ints == [pedersen_hash_oracle(x, y)
                       for x, y in zip(av[:8], bv[:8])],
          "hash_pairs differs from the python oracle")
    # one friendly-tree level of M pairs on each route, host clock (median
    # of 5): hash_pairs on the card (it syncs for the inversion) against the
    # host C++ batch on inputs already on the host; merkle.py sends levels
    # of at least DEVICE_PEDERSEN_MIN_PAIRS pairs to the card
    crossover = {}
    for logm in range(5, 13):
        M = 1 << logm
        da, db = rand_elems(M), rand_elems(M).flip(0).contiguous()
        ha, hb = (t.cpu().numpy().view("<u8") for t in (da, db))
        check(np.array_equal(pedersen.hash_pairs(F, da, db).cpu().numpy()
                             .view("<u8"), native.pedersen_hash_pairs(ha, hb)),
              f"hash_pairs differs from the host batch at M = {M}")
        dev_s, host_s = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pedersen.hash_pairs(F, da, db)
            torch.cuda.synchronize()
            dev_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            native.pedersen_hash_pairs(ha, hb)
            host_s.append(time.perf_counter() - t0)
        crossover[M] = {"device_ms": sorted(dev_s)[2] * 1e3,
                        "host_ms": sorted(host_s)[2] * 1e3}
    emit({"phase": "kernel_ec_madd_walk",
          "walk_16bit": walk[16], "walk_8bit": walk[8],
          "tables8_host_s": tables8_host_s,
          "table16_build_s": table16_s, "table16_bytes":
          t16.numel() * t16.element_size(),
          "hash_pairs_vs_host": len(av), "hash_pairs_vs_oracle": 8,
          "hash_pairs_ms": cuda_ms(
              torch, lambda: pedersen.hash_pairs(F, ca, cb), 5),
          "level_device_vs_host": crossover,
          "device_faster_from_pairs": min(
              [M for M, r in crossover.items()
               if r["device_ms"] < r["host_ms"]], default=None)})
    del t16

    # -- 3f: the Goldilocks kernels -----------------------------------------
    PG = GL.MODULUS

    def rand_gl(n, width):
        """n random canonical elements of `width` words (2: GL, 6: GL3),
        every hi word below 2^32 - 1, led by 0, 1, p - 1, 2^32 - 1, 2^32
        and 2^63 in every coordinate."""
        w = rng.integers(0, 1 << 32, size=(n, width), dtype=np.uint64)
        w[:, 1::2] %= 0xFFFFFFFF
        x = torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)
        edges = [0, 1, PG - 1, (1 << 32) - 1, 1 << 32, 1 << 63]
        x[:len(edges)] = GL.encode_ints(edges, dev).repeat(1, width // 2)
        return x

    n = 1 << 21
    gl_host = {"add": lambda x, y: (x + y) % PG,
               "sub": lambda x, y: (x - y) % PG,
               "mul": lambda x, y: x * y % PG}
    a, b = rand_gl(n, 2), rand_gl(n, 2).flip(0).contiguous()
    out = torch.empty_like(a)
    for op in ("mul", "add", "sub"):
        got = gl_cuda.binop(op, a, b)
        err = max_abs_err(torch, got, gl_cuda.PLAIN[op](a, b))
        check(err == 0, f"gl_{op} differs from its plain version")
        xs, ys, zs = (GL.decode_ints(t[:512]) for t in (a, b, got))
        check(zs == [gl_host[op](x, y) for x, y in zip(xs, ys)],
              f"gl_{op} differs from python ints")
        results[f"gl_{op}"] = {
            "max_abs_err": err, "shape": [n, 2],
            "ms": raw_ms(f"gl_{op}", (a.data_ptr(), 1, n, b.data_ptr(), 1, n,
                                      out.data_ptr(), n), 200),
            "plain_ms": cuda_ms(torch, lambda: gl_cuda.PLAIN[op](a, b), 3),
            "work": {"bytes": 24 * n,
                     "imad": GL_MUL_IMAD * n if op == "mul" else 0}}
    a, b = rand_gl(n, 6), rand_gl(n, 6).flip(0).contiguous()
    got = gl_cuda.gl3_mul(a, b)
    out = torch.empty_like(a)
    err = max_abs_err(torch, got, gl_cuda.gl3_mul_plain(a, b))
    check(err == 0, "gl3_mul differs from its plain version")
    xs, ys, zs = (GL3.decode_ints(t[:256]) for t in (a, b, got))
    check(zs == [int(Fq3S.from_packed(x) * Fq3S.from_packed(y))
                 for x, y in zip(xs, ys)], "gl3_mul differs from Fq3S")
    results["gl3_mul"] = {
        "max_abs_err": err, "shape": [n, 6],
        "ms": raw_ms("gl3_mul", (a.data_ptr(), 1, n, b.data_ptr(), 1, n,
                                 out.data_ptr(), n), 200),
        "plain_ms": cuda_ms(torch, lambda: gl_cuda.gl3_mul_plain(a, b), 3),
        "work": {"bytes": 72 * n,
                 "imad": GL3_MUL_GL_MULS * GL_MUL_IMAD * n}}
    for op in ("add", "sub"):     # the GL kernels on the [..., 3, 2] view
        check(torch.equal(getattr(GL3, op)(a[:4096], b[:4096]).cpu(),
                          getattr(GL3, op)(a[:4096].cpu(), b[:4096].cpu())),
              f"GL3.{op} on the card differs from the CPU")
    # the broadcast operands the prover passes, read in place
    for width, mul, mul_plain in (
            (2, lambda x, y: gl_cuda.binop("mul", x, y), gl_cuda.mul_plain),
            (6, gl_cuda.gl3_mul, gl_cuda.gl3_mul_plain)):
        a4 = rand_gl(4 * 6 * 5, width).reshape(4, 6, 5, width)
        t = rand_gl(24, width)
        for b4 in (t[0], t.reshape(4, 6, 1, width),
                   t[:1].reshape(1, 1, 1, width), t[:6].reshape(6, 1, width),
                   t[:5].reshape(5, width)):
            shape = list(b4.shape)
            check(max_abs_err(torch, mul(a4, b4), mul_plain(a4, b4)) == 0,
                  f"{'gl3_mul' if width == 6 else 'gl_mul'} with a {shape} "
                  f"operand differs")
            if width == 2:
                check(max_abs_err(torch, gl_cuda.binop("sub", b4, a4),
                                  gl_cuda.sub_plain(b4, a4)) == 0,
                      f"gl_sub with a {shape} operand differs")
    emit({"phase": "kernel_gl", "n": n, "broadcast_forms_equal": True,
          **{k: results[k] for k in ("gl_mul", "gl_add", "gl_sub",
                                     "gl3_mul")}})
    del a, b, got

    # -- 3g: the Goldilocks NTT leaf ---------------------------------------
    gl_ntt = {}
    for logn in (12, 21):
        N = 1 << logn
        for Fg, width in ((GL, 2), (GL3, 6)):
            x = rand_gl(N, width)
            for inverse in (False, True):
                got = ntt(Fg, x, inverse=inverse)
                t0 = time.perf_counter()
                want = ntt_cuda.ntt_leaf_plain(
                    x.reshape(N, -1, 2),
                    ntt_cuda.stage_table(GL, N, inverse, dev),
                    gl_cuda.PLAIN).reshape(x.shape)
                if inverse:
                    scale = (gl_cuda.mul_plain if width == 2
                             else gl_cuda.gl3_mul_plain)
                    want = scale(want, Fg.encode_int(pow(N, -1, PG), dev))
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t0
                err = max_abs_err(torch, got, want)
                check(err == 0, f"{Fg.NAME} ntt 2^{logn} inverse={inverse} "
                                f"differs")
                gl_ntt[f"{Fg.NAME} 2^{logn}{'_inv' if inverse else ''}"] = {
                    "max_abs_err": err,
                    "ms": cuda_ms(torch, lambda: ntt(Fg, x, inverse=inverse),
                                  5),
                    "plain_radix2_ms": plain_s * 1e3}
    def gl_leaf_entry(M, Bt):
        """gl_ntt_leaf at [M, Bt] against its plain version, timed, with
        its work: one multiply per butterfly whose twiddle is not 1."""
        x = rand_gl(M * Bt, 2).reshape(M, Bt, 2)
        tw = ntt_cuda.stage_table(GL, M, False, dev)
        err = max_abs_err(torch, ntt_cuda.gl_ntt_leaf(x, tw),
                          ntt_cuda.ntt_leaf_plain(x, tw, gl_cuda.PLAIN))
        check(err == 0, f"gl_ntt_leaf differs from its plain version at "
                        f"[{M}, {Bt}]")
        mults = Bt * (M // 2 * (M.bit_length() - 1) - (M - 1))
        return x, tw, mults, {
            "max_abs_err": err, "shape": [M, Bt, 2],
            "ms": cuda_ms(torch, lambda: ntt_cuda.gl_ntt_leaf(x, tw), 10),
            "plain_ms": cuda_ms(
                torch,
                lambda: ntt_cuda.ntt_leaf_plain(x, tw, gl_cuda.PLAIN), 1),
            "work": {"bytes": (2 * x.numel() + tw.numel()) * 4,
                     "imad": GL_MUL_IMAD * mults}}

    # plain-gl3-2^16's forward LDE of 2^21 rows by 5 GF(p^3) columns (Bi =
    # 15 Goldilocks columns) splits as R = 2048 rows by C = 1024: the fused
    # first leaf at [2048, 1024 x 15], then the leaf at [1024, 2048 x 15];
    # the leaf at [2048, 15360] is the kernels line's row, the shape earlier
    # commits recorded
    M, C, Bi = 2048, 1024, 15
    _, _, _, gl_leaf_1024 = gl_leaf_entry(C, M * Bi)
    x, tw, leaf_mults, results["gl_ntt_leaf"] = gl_leaf_entry(M, C * Bi)
    rc = ntt_cuda._rc_twiddle(GL, M * C, M, False, dev)
    err = max_abs_err(torch, ntt_cuda.gl_ntt_leaf_fused(x, tw, rc, Bi),
                      ntt_cuda.gl_ntt_leaf_fused_plain(x, tw, rc, Bi))
    check(err == 0, "gl_ntt_leaf_fused differs from its plain version")
    results["gl_ntt_leaf_fused"] = {
        "max_abs_err": err, "shape": [M, C * Bi, 2], "Bi": Bi,
        "ms": cuda_ms(
            torch, lambda: ntt_cuda.gl_ntt_leaf_fused(x, tw, rc, Bi), 10),
        "plain_ms": cuda_ms(
            torch, lambda: ntt_cuda.gl_ntt_leaf_fused_plain(x, tw, rc, Bi),
            1),
        # what the one launch replaces: the leaf, gl_mul, the transpose copy
        "apart_ms": cuda_ms(torch, lambda: ntt_cuda._twiddle_transpose(
            ntt_cuda.gl_ntt_leaf(x, tw), rc, Bi, GL.mul), 10),
        "work": {"bytes": (2 * x.numel() + tw.numel() + rc.numel()) * 4,
                 "imad": GL_MUL_IMAD * (
                     leaf_mults + M * C * Bi - (M + C - 1) * Bi)}}
    del x, rc
    # plain-cairo-gl-2^16's forward LDE, 2^21 rows by 5 Goldilocks columns:
    # the fused first leaf at [2048, 1024 x 5], the leaf at [1024, 2048 x 5]
    # (the kernels line's rows with path slice_cairo_gl)
    gl_cairo_results = {}
    Bi = 5
    x, tw, _, gl_cairo_results["gl_ntt_leaf"] = gl_leaf_entry(C, M * Bi)
    x, tw, leaf_mults, _ = gl_leaf_entry(M, C * Bi)
    rc = ntt_cuda._rc_twiddle(GL, M * C, M, False, dev)
    err = max_abs_err(torch, ntt_cuda.gl_ntt_leaf_fused(x, tw, rc, Bi),
                      ntt_cuda.gl_ntt_leaf_fused_plain(x, tw, rc, Bi))
    check(err == 0, "gl_ntt_leaf_fused differs from its plain version at "
                    "Bi = 5")
    gl_cairo_results["gl_ntt_leaf_fused"] = {
        "max_abs_err": err, "shape": [M, C * Bi, 2], "Bi": Bi,
        "ms": cuda_ms(
            torch, lambda: ntt_cuda.gl_ntt_leaf_fused(x, tw, rc, Bi), 10),
        "plain_ms": cuda_ms(
            torch, lambda: ntt_cuda.gl_ntt_leaf_fused_plain(x, tw, rc, Bi),
            1),
        "work": {"bytes": (2 * x.numel() + tw.numel() + rc.numel()) * 4,
                 "imad": GL_MUL_IMAD * (
                     leaf_mults + M * C * Bi - (M + C - 1) * Bi)}}
    del x, rc
    emit({"phase": "kernel_gl_ntt", "transforms": gl_ntt,
          "leaf": results["gl_ntt_leaf"], "leaf_1024x30720": gl_leaf_1024,
          "fused_leaf": results["gl_ntt_leaf_fused"],
          "slice_cairo_gl": gl_cairo_results})

    # -- 3h: the ALU probe, through the tool's entry point ----------------
    _native.reset_counts()
    probe = {op: dict(zip(("ms", "tops_per_s"), probe_alu.run(op, dev)))
             for op in probe_alu.OPS}
    probe_launches = dict(_native.LAUNCHES)
    for op, entry in probe.items():
        a, b = probe_alu.inputs(op, dev)
        got = probe_alu.probe_alu(a, b, op)
        want = probe_alu.probe_alu_plain(a, b, op)
        if op.startswith("f32"):
            rel = float(((got.double() - want.double()).abs()
                         / want.double().abs()).max())
            check(rel <= probe_alu.F32_RTOL,
                  f"probe {op} differs from its plain chain ({rel})")
            entry["max_rel_err"] = rel
        else:
            entry["max_abs_err"] = max_abs_err(torch, got, want)
            check(entry["max_abs_err"] == 0,
                  f"probe {op} differs from its plain chain")
    # the kernel and its plain chain over the same full grid, one op
    op = "u32 mul+add"
    a, b = (t.repeat(probe_alu.COPIES) for t in probe_alu.inputs(op, dev))
    _, plain_ms = cuda_ms_once(
        torch, lambda: probe_alu.probe_alu_plain(a, b, op))
    del a, b
    elements = probe_alu.TILE * probe_alu.COPIES
    results["probe_alu"] = {
        "max_abs_err": probe[op]["max_abs_err"], "op": op,
        "shape": [elements], "ms": probe[op]["ms"], "plain_ms": plain_ms,
        "work": {"bytes": 3 * 4 * elements,   # one IMAD per chained step
                 "imad": elements * probe_alu.R}}
    emit({"phase": "probe_alu", "nvidia_smi": smi, "r": probe_alu.R,
          "elements": probe_alu.TILE * probe_alu.COPIES, "ops": probe,
          "launches": probe_launches})

    # the card's integer rates, as the probe measured them in this run
    imad_per_s = probe["u32 mul"]["tops_per_s"] * 1e12
    alu_per_s = probe["u32 add"]["tops_per_s"] * 1e12

    def bound(work):
        mem_ms = work["bytes"] / HBM_BYTES_PER_S * 1e3
        op_ms = max(work.get("imad", 0) / imad_per_s,
                    work.get("alu", 0) / alu_per_s) * 1e3
        return {"bound_ms": max(mem_ms, op_ms),
                "bound_by": "bytes" if mem_ms >= op_ms else "operations"}

    def with_reach(entry):
        """entry with its bound and reach (bound / ms)."""
        b = bound(entry["work"])
        return {**entry, **b, "reach": b["bound_ms"] / entry["ms"]}

    # -- 3i: Keccak-256 of rows and nodes ---------------------------------
    def rand_words(n, W):
        return torch.from_numpy(rng.integers(
            0, 1 << 32, size=(n, W), dtype=np.uint64).astype(
            np.uint32).view(np.int32)).to(dev)

    keccak_line = {}
    # plain-eth's base rows (5 columns, two permutations a row, masked as
    # the tree masks them), starknet's (9 columns, three permutations), the
    # node pairs of a 2^21-leaf tree, a FRI layer's rows of eight felts,
    # and the 136-byte rate's edge
    for n, W, keep, label in ((1 << 21, 40, 5, "base_rows"),
                              (1 << 22, 72, 5, "starknet_base_rows"),
                              (1 << 20, 16, 5, "node_pairs"),
                              (1 << 18, 64, 5, "fri_rows"),
                              (1 << 12, 33, 8, "w33"),
                              (1 << 12, 34, 8, "w34"),
                              (1 << 12, 35, 8, "w35")):
        msg = rand_words(n, W)
        got = keccak.keccak256_words(msg, keep_words=keep)
        want, plain_ms = cuda_ms_once(
            torch, lambda: keccak.keccak256_words_plain(msg, keep))
        err = max_abs_err(torch, got, want)
        check(err == 0, f"keccak_rows differs from its plain version at "
                        f"[{n}, {W}] keep {keep}")
        host = msg[:64].cpu().numpy().view(np.uint32)
        dig = got[:64].cpu().numpy().view(np.uint32)
        H = MaskedKeccak256HashFn(4 * keep)
        for r in range(64):
            check(dig[r].astype("<u4").tobytes()
                  == H.hash(host[r].astype("<u4").tobytes()),
                  f"keccak_rows {label} row {r} differs from host keccak256")
        perms = W // 34 + 1
        keccak_line[label] = {
            "max_abs_err": err, "shape": [n, W], "keep_words": keep,
            "permutations_per_row": perms,
            "ms": raw_ms("keccak_rows", (msg.data_ptr(), n, W, keep,
                                         got.data_ptr()), 50),
            "plain_ms": plain_ms,
            "work": {"bytes": (msg.numel() + got.numel()) * 4,
                     "alu": n * perms * KECCAK_PERM_ALU}}
        del msg, got, want
    results["keccak_rows"] = keccak_line["base_rows"]
    star_results["keccak_rows"] = keccak_line["starknet_base_rows"]
    emit({"phase": "kernel_keccak_rows", "host_rows_checked": 64,
          **{k: with_reach(v) for k, v in keccak_line.items()}})

    # -- 3j: the proof-of-work grind, both hashes ---------------------------
    # the coins' own prefixes from fixed seeds at 8, 12 and 16 bits: the
    # kernel's nonce against the plain twin's over the same batches on the
    # card, and the coin's host check
    grind_line = {}
    for coin_cls in (SolidityVerifierPublicCoin, CairoVerifierPublicCoin):
        hname = coin_cls.GRIND_HASH
        for bits in (8, 12, 16):
            coin = coin_cls(hashlib.sha256(bytes([bits])).digest())
            prefix = coin._pow_prefix(bits)
            words = torch.from_numpy(np.frombuffer(prefix, "<u4").view(
                np.int32).copy()).to(dev)
            nonce = coin.grind_proof_of_work(bits, dev)
            n0 = 1
            while True:
                idx = pow_grind.pow_grind_plain(words, n0, bits, hname)
                if idx < pow_grind.BATCH:
                    break
                n0 += pow_grind.BATCH
            check(nonce == n0 + idx, f"pow_grind ({hname}, {bits} bits) "
                                     f"differs from its plain version")
            check(coin.verify_proof_of_work(nonce, bits),
                  f"pow_grind ({hname}, {bits} bits) fails the host check")
            grind_line[f"{hname}_{bits}"] = {"nonce": nonce,
                                             "batches": (n0 - 1)
                                             // pow_grind.BATCH + 1}
        # one batch: the kernel alone (CUDA events, through ctypes), one
        # wrapper call with its read of the result (host clock, median of
        # 21), the plain twin's batch
        out = torch.full((1,), pow_grind.BATCH, dtype=torch.int32,
                         device=dev)
        hid = pow_grind.HASH_IDS[hname]
        kernel_ms = raw_ms("pow_grind", (words.data_ptr(), 1, 32, hid,
                                         pow_grind.BATCH, out.data_ptr()),
                           50)
        wrapper_s = []
        for _ in range(21):
            t0 = time.perf_counter()
            pow_grind.pow_grind(words, 1, 32, hname)
            wrapper_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pow_grind.pow_grind_plain(words, 1, 32, hname)
        plain_ms = (time.perf_counter() - t0) * 1e3
        grind_line[hname] = {
            "max_abs_err": 0, "shape": [pow_grind.BATCH],
            "ms": kernel_ms, "plain_ms": plain_ms,
            "launch_and_read_ms": sorted(wrapper_s)[10] * 1e3,
            "work": {"bytes": 32 + 4,
                     "alu": pow_grind.BATCH * (
                         KECCAK_PERM_ALU if hname == "keccak"
                         else BLAKE2S_BLOCK_ALU)}}
    emit({"phase": "kernel_pow_grind", **{
        k: with_reach(v) if "work" in v else v
        for k, v in grind_line.items()}})

    grind_alu = {"keccak": KECCAK_PERM_ALU, "blake2s": BLAKE2S_BLOCK_ALU}

    def grind_replay(rec):
        """A coin's recorded grind (hash, prefix, bits, start, nonce)
        replayed as grind() runs it, a launch a window of WINDOW batches up
        to the window of the nonce: each launch's offset against the plain
        twin's over the same window, the kernel alone (CUDA events through
        ctypes; its memset and launch a window, summed), grind()'s launches
        with their reads (host clock, median of 21), the plain twin; the
        bound counts the hashes the nonce needed, and batches_before the
        launches of one 2^16-nonce batch each that the grind took before
        the windows."""
        hname, prefix, bits, start, nonce = rec
        words = torch.from_numpy(np.frombuffer(prefix, "<u4").view(
            np.int32).copy()).to(dev)
        span = pow_grind.WINDOW * pow_grind.BATCH
        starts = list(range(start, nonce + 1, span))
        got = [pow_grind.pow_grind(words, n0, bits, hname, pow_grind.WINDOW)
               for n0 in starts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = [pow_grind.pow_grind_plain(words, n0, bits, hname,
                                          pow_grind.WINDOW) for n0 in starts]
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(abs(a - b) for a, b in zip(got, want))
        check(err == 0 and starts[-1] + got[-1] == nonce,
              f"pow_grind ({hname}) replay: offsets {got}, plain {want}, "
              f"nonce {nonce}")
        out = torch.empty((1,), dtype=torch.int32, device=dev)
        kernel_ms = sum(raw_ms("pow_grind", (words.data_ptr(), n0, bits,
                                             pow_grind.HASH_IDS[hname], span,
                                             out.data_ptr()), 50)
                        for n0 in starts)
        walls = []
        for _ in range(21):
            t0 = time.perf_counter()
            for n0 in starts:
                pow_grind.pow_grind(words, n0, bits, hname, pow_grind.WINDOW)
            walls.append(time.perf_counter() - t0)
        return {"hash": hname, "bits": bits, "start": start, "nonce": nonce,
                "launches": len(starts),
                "batches_before": (nonce - start) // pow_grind.BATCH + 1,
                "max_abs_err": err, "shape": [len(starts), span],
                "ms": kernel_ms, "plain_ms": plain_ms,
                "launch_and_read_ms": sorted(walls)[10] * 1e3,
                "work": {"bytes": 32 + 4,
                         "alu": (nonce - start + 1) * grind_alu[hname]}}

    # the plain versions of the new routes on the card: Fp252 with the
    # kernels' plain versions as its ops
    class PlainF:
        NAME, NLIMBS, MODULUS, BASE_MODULUS = "fp252", 8, P, P
        s = staticmethod(F.s)
        encode_ints = staticmethod(F.encode_ints)
        encode_int = staticmethod(F.encode_int)
        add = staticmethod(fc.add_plain)
        sub = staticmethod(fc.sub_plain)
        mul = staticmethod(fc.mul_plain)

        @staticmethod
        def neg(a):
            return fc.sub_plain(torch.zeros_like(a), a)

        @staticmethod
        def batch_inv(a, axis=0):
            return fc.batch_inv_plain(a)

    # -- 3k: the running-product scan and the segmented batch inversion ----
    def rand_canon(shape):
        """random canonical field elements (no zero among them, but by a
        chance of 2^-251) of shape + (8,)"""
        w = rng.integers(0, 1 << 32, size=tuple(shape) + (8,),
                         dtype=np.uint64)
        w[..., 7] &= (1 << 27) - 1
        return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)

    def scan_plain(x, reverse):
        return prefix_scan(fc.mul_plain, x, reverse)

    scan_line, inv_line = {}, {}
    # ragged lengths around a tile (runs of 1 row below 2 x 256 x SMs rows:
    # tiles of 256; 2^18 + 5: runs of 2, the last of 513 tiles 5 rows), 1
    # and 4 columns
    ragged = [1, 2, 31, 32, 33, 255, 256, 257, (1 << 18) + 5]
    for n in ragged:
        for C in (1, 4):
            x = rand_canon((n, C))
            for reverse in (False, True):
                check(torch.equal(fc.scan_mul(x, reverse),
                                  scan_plain(x, reverse)),
                      f"fp252_scan_mul differs from its plain version at "
                      f"[{n}, {C}] (reverse={reverse})")
            x[n // 2, C - 1] = 0
            (got,) = fc.batch_inv_segments([x])
            check(torch.equal(got, fc.batch_inv_plain(x)),
                  f"fp252_batch_inv differs from its plain version at "
                  f"[{n}, {C}]")
            check(not got[:, C - 1].any(),
                  f"fp252_batch_inv: a zero left nonzero inverses in its "
                  f"column at [{n}, {C}]")
    # one call over segments of mixed lengths and widths, zeros in two
    shapes = [(1,), (2, 3), (257,), (5000, 2), ((1 << 18) + 5,), (33, 4),
              (70001,)]
    xs = [rand_canon(sh) for sh in shapes]
    xs[3][4999, 0] = 0
    xs[6][0] = 0
    got = fc.batch_inv_segments(xs)
    for sh, x, g in zip(shapes, xs, got):
        check(torch.equal(g, fc.batch_inv_plain(x)),
              f"fp252_batch_inv differs from its plain version in a "
              f"segmented call ({sh})")
    check(not got[3][:, 0].any() and got[3][:, 1].any(dim=-1).all()
          and not got[6].any(), "fp252_batch_inv: zeros of a segmented "
                                "call reached the wrong columns")
    scan_line["ragged"] = {"lengths": ragged, "columns": [1, 4],
                           "segments": [list(sh) for sh in shapes],
                           "max_abs_err": 0}
    # repeats at a many-tile size: a race in the look-back shows as a rare
    # wrong row
    x = rand_canon((1 << 20,))
    want = [scan_plain(x, False), scan_plain(x, True),
            fc.batch_inv_plain(x)]
    for _ in range(10):
        check(torch.equal(fc.scan_mul(x), want[0])
              and torch.equal(fc.scan_mul(x, True), want[1])
              and torch.equal(fc.batch_inv_segments([x])[0], want[2]),
              "fp252_scan_mul / fp252_batch_inv: a repeat at 2^20 differs")
    scan_line["repeats_2^20"] = {"calls": 10, "max_abs_err": 0}
    for logn in (21, 22):
        n = 1 << logn
        x = rand_canon((n,))
        for reverse in (False, True):
            got = fc.scan_mul(x, reverse)
            want, plain_ms = cuda_ms_once(
                torch, lambda: scan_plain(x, reverse))
            err = max_abs_err(torch, got, want)
            check(err == 0, f"fp252_scan_mul differs from its plain version "
                            f"at 2^{logn} (reverse={reverse})")
            scan_line[f"2^{logn}{'_reverse' if reverse else ''}"] = {
                "max_abs_err": err, "shape": [n, 8],
                "run": fc.run_length(n, fc.sm_count(dev)),
                "ms": cuda_ms(torch, lambda: fc.scan_mul(x, reverse), 10),
                "plain_ms": plain_ms,
                # each element read once and written once; n - 1 products
                "work": {"bytes": 64 * n, "imad": MONTMUL_IMAD * (n - 1)}}
        del got, want
        for zero in (False, True):
            if zero:
                x[n // 3] = 0
            want, plain_ms = cuda_ms_once(torch,
                                          lambda: fc.batch_inv_plain(x))
            got = F.batch_inv(x)
            err = max_abs_err(torch, got, want)
            check(err == 0, f"fp252_batch_inv differs from its plain version "
                            f"at 2^{logn} (zero={zero})")
            check(not zero or not got.any(),
                  "fp252_batch_inv of a column with a zero is not all zeros")
        del got, want
        x[n // 3] = 1
        # the two launches alone (the seeds of one host trip), the whole
        # call, the host trip alone (host clock: it ends in its copy)
        job = fc.inv_prepare([x])
        fc.inv_launch(job, 0, job["totals"])
        seeds = fc.invert_totals(job["totals"])
        trip = []
        for _ in range(21):
            t0 = time.perf_counter()
            fc.invert_totals(job["totals"])
            torch.cuda.synchronize()
            trip.append((time.perf_counter() - t0) * 1e3)
        inv_line[f"2^{logn}"] = {
            "max_abs_err": 0, "shape": [n, 8], "run": job["run"],
            "tiles": job["ntiles"],
            "ms": cuda_ms(torch, lambda: (
                fc.inv_launch(job, 0, job["totals"]),
                fc.inv_launch(job, 1, seeds)), 10),
            "call_ms": cuda_ms(torch, lambda: F.batch_inv(x), 10),
            "host_trip_ms": sorted(trip)[10],
            "plain_ms": plain_ms,
            # the least work: a read once, out written once; 3 montmuls an
            # element (Montgomery's trick)
            "work": {"bytes": 64 * n, "imad": 3 * MONTMUL_IMAD * n}}
        del x, job, seeds
    results["fp252_scan_mul"] = scan_line["2^22"]
    results["fp252_batch_inv"] = inv_line["2^22"]
    emit({"phase": "kernel_scan", **{k: with_reach(v) if "work" in v else v
                                     for k, v in scan_line.items()}})
    emit({"phase": "kernel_batch_inv",
          **{k: with_reach(v) for k, v in inv_line.items()}})
    # a call's latency at small n, and 25 arrays in one call against 25
    # calls (tools/time_scan.py, also run against a parent checkout)
    emit({"phase": "scan_latency", **time_scan.measure(dev)})

    def fold_inputs(A, n, blowup, seed):
        """The layout's constraints, an LdeContext over random columns
        (views of one stacked tensor, as a prove's LDEs are) with its
        periodic columns, and alpha powers."""
        prng = random.Random(seed)
        g_n = F.root_of_unity_int(n)
        cons = A.constraints(n, P, g_n, base_modulus=P)
        keys = [nd.key for nd in dag_walk(cons)]
        N = n * blowup
        ncols = A.NUM_BASE_COLUMNS + A.NUM_EXTENSION_COLUMNS
        stack = rand_elems(N * ncols).reshape(N, ncols, 8)
        dom = prover._DomainCache(F, N, F.GENERATOR, dev)
        pcs = A.periodic_columns(n) if hasattr(A, "periodic_columns") \
            else []

        def scalars(kind):
            count = 1 + max((k[1] for k in keys if k[0] == kind),
                            default=-1)
            return [F.encode_int(prng.randrange(P), dev)
                    for _ in range(count)]

        ctx = LdeContext(F, dict(enumerate(stack.unbind(1))), blowup,
                         dom.domain, dom.x_pow,
                         challenges=scalars("challenge"),
                         hints=scalars("hint"),
                         periodic=[pc.lde_fn(F, dom) for pc in pcs])
        alpha = prng.randrange(P)
        return cons, ctx, N, [pow(alpha, i, P) for i in range(len(cons))]

    # -- 3l: the generated constraint-group kernels (air_group) -------------
    air_line = {}
    for label, A, n, plain_rows in (
            ("plain", PlainAirConfig, 1 << 20, None),
            ("recursive", RecursiveAirConfig, 1 << 18, None),
            ("starknet", StarknetAirConfig, 1 << 21, 1 << 18)):
        cons, ctx, N, coeffs = fold_inputs(A, n, 2, n)
        t0 = time.perf_counter()
        plan, tables, scalars = _fold_setup(cons, ctx, N, coeffs)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        check(plan.stem == air_plans[label].stem,
              f"the {label} plan is not the one built ahead")
        got = torch.empty((N, 8), dtype=torch.int32, device=dev)
        _fold_run(F, plan, tables, scalars, 2, got)
        # the plain interpreter of the same programs over the plain ops
        want = torch.empty_like(got)
        windows = [(0, N)] if plain_rows is None else \
            [(0, plain_rows), (N - plain_rows, plain_rows)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s0, B in windows:
            for g in range(len(plan.groups)):
                codegen.run_group_plain(PlainF, plan, g, tables, scalars, 2,
                                        s0, B, want[s0:s0 + B], g > 0)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(max_abs_err(torch, got[s0:s0 + B], want[s0:s0 + B])
                  for s0, B in windows)
        check(err == 0, f"air_group ({label}) differs from its plain "
                        f"interpreter")
        del want
        code = [ins for grp in plan.groups for ins in grp.code]
        prods = sum(1 for ins in code if ins[0] in ("mul", "fold"))
        squares = sum(1 for ins in code if ins[0] == "mul"
                      and ins[2] == ins[3])
        entry = {"max_abs_err": err, "shape": [N, len(ctx.columns), 8],
                 "groups": len(plan.groups), "setup_s": setup_s,
                 "plain_rows": sum(B for _, B in windows),
                 "ms": cuda_ms(torch, lambda: _fold_run(
                     F, plan, tables, scalars, 2, got), 3),
                 "plain_ms": plain_ms,
                 # the plan's products a row: a square (Q in the kernels)
                 # takes 36 products, any other product or fold 64
                 "montmuls_per_row": prods - squares,
                 "squares_per_row": squares,
                 "work": {
                     "bytes": sum(t.shape[0] * 32 for t in tables)
                     + scalars.numel() * 4 + N * 32,
                     "imad": N * (MONTMUL_IMAD * (prods - squares)
                                  + SQUARE_IMAD * squares)},
                 # every product counted as a montmul, squares too
                 "work_all_montmul": {"bytes": 0,
                                      "imad": MONTMUL_IMAD * N * prods}}
        if label == "starknet":
            # the eager route (one launch a node, 2^20-row windows) over the
            # whole domain
            alpha_pows = F.encode_ints(coeffs, dev)

            def fold(acc, v, i):
                t = F.mul(v, alpha_pows[i])
                return t if acc is None else F.add(acc, t)

            eager, entry["eager_ms"] = cuda_ms_once(torch, lambda: evaluate_lde(
                cons, ctx, N, fold=fold,
                chunk_size=prover.constraint_chunk_size(F, N)))
            entry["eager_max_abs_err"] = max_abs_err(torch, got, eager)
            check(entry["eager_max_abs_err"] == 0,
                  "air_group (starknet) differs from the eager route")
            del eager
        air_line[label] = entry
        del cons, ctx, plan, tables, scalars, got
    results["air_group"] = air_line["plain"]
    rec_results["air_group"] = air_line["recursive"]
    star_results["air_group"] = air_line["starknet"]

    def air_reach(entry):
        """the kernels against the plan's least work, and against every
        product counted as a montmul"""
        ob = bound(entry["work_all_montmul"])
        return {**with_reach(entry), "bound_ms_all_montmul": ob["bound_ms"],
                "reach_all_montmul": ob["bound_ms"] / entry["ms"]}

    emit({"phase": "kernel_air_group", "nvidia_smi": smi,
          **{k: air_reach(v) for k, v in air_line.items()}})

    # -- 3m: DEEP (deep_compose) --------------------------------------------
    class Window:
        """rows s .. s + B of a _DomainCache's domain, as _deep_compose
        reads it"""

        def __init__(self, dom, s0, B):
            self.d = dom.domain()[s0:s0 + B]

        def domain(self):
            return self.d

    deep_line = {}
    for label, A, n, plain_rows in (
            ("recursive", RecursiveAirConfig, 1 << 18, None),
            ("starknet", StarknetAirConfig, 1 << 21, 1 << 17)):
        prng = random.Random(n)
        targs = trace_arguments(A.constraints(n, P, F.root_of_unity_int(n)))
        ncols = A.NUM_BASE_COLUMNS + A.NUM_EXTENSION_COLUMNS
        N = 2 * n
        stack = rand_elems(N * (ncols + 2)).reshape(N, ncols + 2, 8)
        cols = dict(enumerate(stack[:, :ncols].unbind(1)))
        comp = list(stack[:, ncols:].unbind(1))
        tv = [prng.randrange(P) for _ in targs]
        cv = [prng.randrange(P) for _ in range(2)]
        z, alpha = prng.randrange(P), prng.randrange(P)
        g_n = F.root_of_unity_int(n)
        dom = prover._DomainCache(F, N, F.GENERATOR, dev)
        args = (targs, cols, comp, tv, cv, z, g_n, n, alpha)
        got = prover.deep_compose(F, dom, *args)
        windows = [(0, N)] if plain_rows is None else \
            [(0, plain_rows), (N - plain_rows, plain_rows)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = [prover._deep_compose(
            PlainF, Window(dom, s0, B), targs,
            {c: v[s0:s0 + B] for c, v in cols.items()},
            [v[s0:s0 + B] for v in comp], tv, cv, z, g_n, n, alpha)
            for s0, B in windows]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(max_abs_err(torch, got[s0:s0 + B], w)
                  for (s0, B), w in zip(windows, want))
        check(err == 0, f"deep_compose ({label}) differs from its plain "
                        f"version")
        K = len({off for _, off in targs}) + 1
        T = len(targs) + 2
        # the kernel alone, on the tables the wrapper prepares for it (its
        # batch inversion, fp252_batch_inv, is phase 3k's)
        prep = prover.deep_prepare(F, dom, *args)
        check(torch.equal(prover.deep_launch(prep), got),
              f"deep_compose ({label}): two launches differ")
        points = prep["points"]   # after splitting (16 terms a point)
        den = rand_elems(N)
        entry = {"max_abs_err": err, "shape": [N, ncols + 2, 8],
                 "points": K, "terms": T, "kernel_points": points,
                 "plain_rows": sum(B for _, B in windows),
                 "ms": cuda_ms(torch, lambda: prover.deep_compose(
                     F, dom, *args), 3),
                 "kernel_ms": cuda_ms(torch, lambda: prover.deep_launch(prep),
                                      3),
                 "batch_inv_ms": cuda_ms(torch, lambda: F.batch_inv(den), 3),
                 "plain_ms": plain_ms,
                 # the least work of the function: T + K montmuls a row
                 # (each term's product, each point's product with its
                 # shifted inverse) and two batch inversions, 3 montmuls an
                 # element each (Montgomery's trick)
                 "work": {"bytes": (ncols + 2 + 1) * N * 32,
                          "imad": MONTMUL_IMAD * N * (T + K + 6)},
                 # the kernel alone: T + K products a row
                 "kernel_work": {"bytes": (ncols + 2 + 3) * N * 32,
                                 "imad": MONTMUL_IMAD * N * (T + points)},
                 # the fraction form's count (num / den a row): its
                 # kernel's T + 3K - 2 montmuls a row, its batch
                 # inversion's ~3 and the last product
                 "work_fraction": {"bytes": (ncols + 2 + 2) * N * 32,
                                   "imad": MONTMUL_IMAD * N
                                   * (T + 3 * K + 2)}}
        del prep
        check((K, T) == ((73, 135) if label == "recursive" else (192, 271)),
              f"the {label} DEEP shape is {K} points, {T} terms")
        deep_line[label] = entry
        del stack, cols, comp, got, want, den, dom
    results["deep_compose"] = deep_line["starknet"]
    rec_results["deep_compose"] = deep_line["recursive"]

    def deep_reach(entry):
        """the whole call against the least work, the kernel alone against
        its own, and the whole call against the fraction form's count"""
        kb, ob = bound(entry["kernel_work"]), bound(entry["work_fraction"])
        return {**with_reach(entry),
                "kernel_bound_ms": kb["bound_ms"],
                "kernel_reach": kb["bound_ms"] / entry["kernel_ms"],
                "bound_ms_fraction": ob["bound_ms"],
                "reach_fraction": ob["bound_ms"] / entry["ms"]}

    emit({"phase": "kernel_deep_compose",
          **{k: deep_reach(v) for k, v in deep_line.items()}})

    # -- 3n: the native lockstep witness batch (host C++, native/ecdsa.cpp)
    # built by this machine's c++: new_batch against the python `new`,
    # bit-exact, on 32 Pedersen instances (a = b = 0 and the flag bits among
    # them), 4 signatures by the keys k and FR - k (public keys of one x:
    # one of each pair is not recover_y's and takes the batch's second,
    # mirrored call), 8 EC ops, and the three dummy templates
    t0 = time.perf_counter()
    native.build("witness")
    witness_build_s = time.perf_counter() - t0
    wrng = np.random.default_rng(12)

    def felt(bound=P):
        return int.from_bytes(wrng.bytes(32), "little") % bound

    top = (1 << 251) | (1 << 196) | (1 << 192)
    ped_items = [(0, 0, 0), (1, top, top + 5), (2, 1, P - 1)] + [
        (i, felt(), felt(1 << 251)) for i in range(3, 32)]
    key = felt(curve.FR - 1) + 1
    sig_items = []
    for priv in (key, key, curve.FR - key, curve.FR - key):
        msg, sig = 0, None
        while not msg or sig is None:
            msg = felt(1 << 251)
            sig = ecdsa.sign(priv, msg, felt(curve.FR - 1) + 1)
        sig_items.append((len(sig_items),
                          curve.ec_mul(priv, curve.GENERATOR)[0], msg, *sig))
    op_items = [(o["index"], *(int(o[k], 16) for k in
                               ("p_x", "p_y", "q_x", "q_y", "m")))
                for o in _made_up_ec_ops(8, 5)]
    shift = ped_builtin.shift_and_table_points()[0]
    witness_line = {"phase": "native_witness", "build_s": witness_build_s}
    batches = {}
    for name, module, items, dummy in (
            ("pedersen", ped_builtin, ped_items, (0, 0, 0)),
            ("ecdsa", ecdsa, sig_items, (0, *ecdsa.gen_dummy_instance())),
            ("ec_op", ec_op, op_items, (0, *shift, *curve.GENERATOR, 1))):
        t0 = time.perf_counter()
        batch = module.InstanceTrace.new_batch(items)
        batch_s = time.perf_counter() - t0
        batches[name] = batch
        t0 = time.perf_counter()
        plain = [module.InstanceTrace.new(*it) for it in items]
        plain_s = time.perf_counter() - t0
        check([dataclasses.asdict(t) for t in batch]
              == [dataclasses.asdict(t) for t in plain],
              f"the native {name} batch differs from the python new")
        check(dataclasses.asdict(module.InstanceTrace.new_dummy(0))
              == dataclasses.asdict(module.InstanceTrace.new(*dummy)),
              f"the native {name} dummy differs from the python new")
        witness_line[name] = {"instances": len(items), "batch_s": batch_s,
                              "python_s": plain_s, "bit_exact": True,
                              "dummy_bit_exact": True}
    mirrored = sum(t.pubkey[1] != curve.recover_y(t.pubkey_x)
                   for t in batches["ecdsa"])
    check(0 < mirrored < 4, f"3n: {mirrored} mirrored signatures of 4")
    witness_line["ecdsa"]["mirrored_y"] = mirrored
    emit(witness_line)

    # -- 4: the tiny proofs on the card -------------------------------------
    for scheme in ("generic", "cairo", "eth"):
        claim, witness = loop_claim(16, dev, scheme=scheme)
        t0 = time.perf_counter()
        blob = serialize_proof(claim.prove(
            witness, ProofOptions(num_queries=4, proof_of_work_bits=4)))
        tiny_s = time.perf_counter() - t0
        with open(os.path.join(ROOT, "tests", "data",
                               f"self_proof_{scheme}.bin"), "rb") as f:
            pinned = f.read()
        check(blob == pinned,
              f"tiny GPU proof ({scheme}) differs from the pinned bytes")
        emit({"phase": "tiny_proof", "scheme": scheme,
              "equal_to_pinned": True, "bytes": len(blob),
              "prove_s": tiny_s})

    # -- 4c: the tiny Goldilocks and GF(p^3) proofs ------------------------
    tiny_launches = {}
    for name, Fg, scheme in (("goldilocks", GL, "generic"),
                             ("gl3", GL3, "generic"),
                             ("goldilocks_cairo", GL, "cairo")):
        claim, witness = loop_claim(16, dev, field=Fg, scheme=scheme)
        _native.reset_counts()
        t0 = time.perf_counter()
        blob = serialize_proof(claim.prove(
            witness, ProofOptions(num_queries=4, proof_of_work_bits=4)))
        tiny_s = time.perf_counter() - t0
        tiny_launches[name] = dict(_native.LAUNCHES)
        check(hashlib.sha256(blob).hexdigest() == TINY_SHA256[name],
              f"tiny GPU proof ({name}) differs from the JAX package's")
        check(claim.verify(parse_proof(blob, modulus=Fg.MODULUS),
                           required_security_bits=0),
              f"port verifier rejected the tiny {name} proof")
        emit({"phase": "tiny_proof", "scheme": scheme, "field": Fg.NAME,
              "sha256_equal_to_jax": True, "bytes": len(blob),
              "prove_s": tiny_s, "launches": tiny_launches[name]})
    missing = [k for k in TINY_GL_KERNELS
               if tiny_launches["goldilocks"].get(k, 0) == 0]
    check(not missing, f"the tiny Goldilocks prove launched no {missing}")

    # -- 5 to 8: the slices at size ------------------------------------------
    def run_slice(phase, scheme, kernels, field=F, recursive=False,
                  absent=(), bits=80, extra=None, mesh=None):
        """Prove a slice twice (under `mesh`, if given), verify it at
        `bits`, reject it tampered; fail unless the first prove launched
        every kernel of `kernels` and none of `absent` (and, under a mesh,
        took the four-step exchange NTT).  Returns the slice's line."""
        steps = RECURSIVE_STEPS if recursive else STEPS
        t0 = time.perf_counter()
        if recursive:
            claim, witness = recursive_loop_claim(steps, dev, scheme=scheme)
        else:
            claim, witness = loop_claim(steps, dev, scheme=scheme,
                                        field=field)
        witness_s = time.perf_counter() - t0
        # the host trace build alone (every prove builds it again)
        t0 = time.perf_counter()
        claim.generate_trace(witness)
        trace_build_s = time.perf_counter() - t0
        options = ProofOptions()
        # drop the 16-bit Pedersen table that phases 3e and 4b left cached:
        # the cairo scheme's first prove builds it again, so that
        # first_prove_s carries it
        _tables.evict("pedersen_w16", dev)
        _native.reset_counts()
        native.HASHES.clear()
        del grinds[:]
        ntt_calls = pdist.NTT_CALLS
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        proof = claim.prove(witness, options, mesh=mesh)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(_native.LAUNCHES)
        ntt_calls = pdist.NTT_CALLS - ntt_calls
        first_grinds = list(grinds)
        hashes = dict(native.HASHES)
        phases_first = [[k, v] for k, v in prover.LAST_PHASES]
        peak_first = torch.cuda.max_memory_allocated(dev)
        missing = [k for k in kernels if launches.get(k, 0) == 0]
        check(not missing, f"{phase} path launched no {missing}")
        ran = [k for k in absent if launches.get(k, 0)]
        check(not ran, f"{phase} path launched {ran}")

        torch.cuda.reset_peak_memory_stats(dev)
        _native.reset_counts()
        t0 = time.perf_counter()
        proof2 = claim.prove(witness, options, mesh=mesh)
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        launches_warm = dict(_native.LAUNCHES)
        peak_second = torch.cuda.max_memory_allocated(dev)
        blob = serialize_proof(proof)
        check(serialize_proof(proof2) == blob,
              f"two proves of one claim differ ({phase})")

        t0 = time.perf_counter()
        check(claim.verify(parse_proof(blob, modulus=field.MODULUS),
                           required_security_bits=bits),
              f"port verifier rejected the proof ({phase}) at {bits} bits")
        verify_s = time.perf_counter() - t0
        bad = bytearray(blob)
        bad[len(bad) // 2] ^= 0x01
        try:
            claim.verify(parse_proof(bytes(bad), modulus=field.MODULUS),
                         required_security_bits=bits)
            rejected = False
        except (VerificationError, AssertionError):
            rejected = True
        check(rejected, f"port verifier accepted a proof with one byte "
                        f"flipped ({phase})")
        digest = hashlib.sha256(blob).hexdigest()
        line = {"phase": phase, "scheme": scheme, "field": field.NAME,
                "layout": claim.layout.value, "steps": steps,
                "trace_rows": proof.trace_len,
                "lde_rows": proof.trace_len * options.lde_blowup_factor,
                "options": list(proof.options), "witness_s": witness_s,
                "trace_build_s": trace_build_s,
                "first_prove_s": first_s, "prove_s": second_s,
                "steps_per_s": steps / second_s,
                "phases_first": phases_first,
                "phases": [[k, v] for k, v in prover.LAST_PHASES],
                "peak_mem_bytes_first": peak_first,
                "peak_mem_bytes": peak_second, "proof_bytes": len(blob),
                # the second prove's constraint evaluation and DEEP, and the
                # first prove's launches in all
                "eval_s": dict(prover.LAST_PHASES)["constraint evaluation"],
                "deep_s": dict(prover.LAST_PHASES)["DEEP composition"],
                "windows": dict(prover.LAST_CHUNKS),
                "launches_per_prove": sum(launches.values()),
                "proof_sha256": digest, "pow_nonce": proof.pow_nonce,
                "fri_layers": len(proof.fri_layers),
                "verify_s": verify_s, "verified_bits": bits,
                "tampered_rejected": rejected, "launches": launches,
                "launches_warm": launches_warm,
                "grinds": [{"hash": h, "bits": b, "start": st, "nonce": nc}
                           for h, _, b, st, nc in first_grinds],
                **(extra or {})}
        if mesh is not None:
            line["mesh"] = {"shards": mesh.size,
                            "devices": [str(d) for d in mesh.devices],
                            "dist_ntt_calls": ntt_calls}
            check(ntt_calls > 0, f"{phase} took no four-step exchange NTT")
        if scheme == "cairo":
            # Pedersen hashes of the first prove, by route: the kernel
            # ("cuda") and the host C++ batch ("host", the small tree levels
            # and the transcript's felt-list reseeds)
            line["pedersen_hashes"] = hashes
        if field is GL3:
            # the GF(p^3) path runs no Fp252 kernel
            line["fp252_launches"] = sum(
                launches.get(k, 0) for k in FP252_KERNELS + ["ec_madd_walk"])
            check(line["fp252_launches"] == 0,
                  f"{phase} launched Fp252 kernels")
            # its four-step twiddles ride in the fused leaf: once the
            # power tables are built (the first prove builds them with
            # gl_mul) a prove multiplies in gl3_mul alone
            check(launches_warm.get("gl_mul", 0) == 0,
                  f"{phase} launched gl_mul on a warm prove")
        emit(line)
        line["grind_records"] = first_grinds
        pinned = RECURSIVE_SHA256 if recursive else SLICE_SHA256[phase]
        check(digest == pinned, f"{phase} proof sha256 {digest} differs "
                                f"from the pinned {pinned}")
        return line

    run_slice("slice", "generic", GENERIC_KERNELS)
    rec_line = run_slice("slice_recursive", "cairo", CAIRO_KERNELS,
                         recursive=True)
    path_launches = {
        "slice_recursive": rec_line["launches"],
        "slice_cairo": run_slice("slice_cairo", "cairo",
                                 CAIRO_KERNELS)["launches"],
        "slice_gl3": run_slice("slice_gl3", "generic", GL3_KERNELS,
                               GL3)["launches"],
        "tiny_gl": tiny_launches["goldilocks"],
        "probe_alu": probe_launches}

    # -- 9: bundles through the command line ---------------------------------
    def run_cli(argv):
        """cli.main(argv) in this process, its printed lines captured."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        check(rc == 0, f"cli {argv[-1]} returned {rc}")
        return buf.getvalue().splitlines()

    def cli_slice(phase, paths, scheme, kernels, absent=(), proves=2,
                  subprocess_verify=False, tamper=False, extra=None):
        """Prove a bundle through the CLI (`proves` times, equal bytes),
        verify it through the CLI at 80 bits, optionally again through
        `python -m sandstorm_tpu_torch` in a subprocess, with one byte
        flipped too, or (`tamper`) with one byte flipped through the CLI in
        this process; the launches of the first prove; its sha256.  `extra`
        joins the phase's line."""
        head = ["--program", paths["program"],
                "--air-public-input", paths["public"]]
        if scheme:
            head += ["--scheme", scheme]
        out = os.path.join(os.path.dirname(paths["program"]), "proof.bin")
        prove_argv = head + ["prove", "--device", "cuda",
                             "--air-private-input", paths["private"],
                             "--output", out]
        # the host trace build alone (every prove builds it again)
        program, pub, witness = load_artifacts(
            paths["program"], paths["public"], paths["private"])
        claim = CairoClaim(program, pub, device=dev,
                           scheme=cli.scheme_for(pub.layout, F, scheme))
        native.SECONDS.clear()
        t0 = time.perf_counter()
        trace = claim.generate_trace(witness)
        trace_build_s = time.perf_counter() - t0
        # the starknet builder's seconds a builtin (witness and column
        # fill), the native batch's share and the rest (the hand-off)
        secs = native.SECONDS
        witness_s = {k: {"s": v, "native_s": secs[f"{k}_witness_batch"],
                         "handoff_s": v - secs[f"{k}_witness_batch"]}
                     for k, v in getattr(trace, "witness_s", {}).items()}
        del claim, witness, trace
        blobs, walls, printed = [], [], []
        del grinds[:]
        for k in range(proves):
            _native.reset_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            printed.append(run_cli(prove_argv))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if k == 0:
                launches = dict(_native.LAUNCHES)
                peak = torch.cuda.max_memory_allocated(dev)
                first_grinds = list(grinds)
            with open(out, "rb") as f:
                blobs.append(f.read())
        check(all(b == blobs[0] for b in blobs),
              f"two CLI proves of one bundle differ ({phase})")
        missing = [k for k in kernels if launches.get(k, 0) == 0]
        check(not missing, f"{phase} path launched no {missing}")
        ran = [k for k in absent if launches.get(k, 0)]
        check(not ran, f"{phase} path launched {ran}")
        verify_argv = head + ["verify", "--proof", out,
                              "--required-security-bits", "80"]
        t0 = time.perf_counter()
        verified = run_cli(verify_argv)
        verify_s = time.perf_counter() - t0
        line = {"phase": phase, "scheme": scheme or "from the layout",
                "layout": pub.layout.value, "steps": pub.n_steps,
                "trace_build_s": trace_build_s, "witness_s": witness_s,
                # the CLI call's wall (load, trace build, prove, write) of
                # each prove; the engine alone (the prover's phases) of the
                # last
                "cli_prove_s": walls, "prove_s": walls[-1],
                "engine_s": sum(v for _, v in prover.LAST_PHASES),
                "phases": [[k, v] for k, v in prover.LAST_PHASES],
                "eval_s": dict(prover.LAST_PHASES)["constraint evaluation"],
                "deep_s": dict(prover.LAST_PHASES)["DEEP composition"],
                "launches_per_prove": sum(launches.values()),
                "peak_mem_bytes_first": peak, "proof_bytes": len(blobs[0]),
                "proof_sha256": hashlib.sha256(blobs[0]).hexdigest(),
                "verify_s": verify_s, "verified_bits": 80,
                "cli_printed": printed[-1] + verified,
                "windows": dict(prover.LAST_CHUNKS),
                "launches": launches, **(extra or {})}
        if subprocess_verify:
            cmd = [sys.executable, "-m", "sandstorm_tpu_torch", *verify_argv]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  text=True, timeout=600)
            line["verify_subprocess_s"] = time.perf_counter() - t0
            check(proc.returncode == 0, f"python -m sandstorm_tpu_torch "
                                        f"verify failed: {proc.stderr[-800:]}")
            bad = bytearray(blobs[0])
            bad[len(bad) // 2] ^= 0x01
            with open(out, "wb") as f:
                f.write(bytes(bad))
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  text=True, timeout=600)
            check(proc.returncode != 0 and "proof rejected" in proc.stderr,
                  f"python -m sandstorm_tpu_torch verify accepted a proof "
                  f"with one byte flipped ({phase}): {proc.returncode}")
            line["tampered_rejected"] = True
        if tamper:
            bad = bytearray(blobs[0])
            bad[len(bad) // 2] ^= 0x01
            with open(out, "wb") as f:
                f.write(bytes(bad))
            t0 = time.perf_counter()
            try:
                cli.main(verify_argv)
                rejected = False
            except SystemExit as e:
                rejected = "proof rejected" in str(e)
            line["tampered_verify_s"] = time.perf_counter() - t0
            check(rejected, f"the CLI accepted a proof with one byte "
                            f"flipped ({phase})")
            line["tampered_rejected"] = True
        emit(line)
        line["grind_records"] = first_grinds
        return line

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = make_artifacts.loop_bundle(os.path.join(tmp, "eth"), STEPS)
        bundle_s = time.perf_counter() - t0
        eth = cli_slice("slice_eth", paths, "eth", ETH_KERNELS, ETH_ABSENT,
                        subprocess_verify=True)
        t0 = time.perf_counter()
        paths = make_artifacts.recursive_bundle(os.path.join(tmp, "rec"),
                                                RECURSIVE_STEPS)
        rec_bundle_s = time.perf_counter() - t0
        rec = cli_slice("cli_recursive", paths, None, CAIRO_KERNELS,
                        proves=1)
        check(rec["proof_sha256"] == RECURSIVE_SHA256,
              f"cli_recursive proof sha256 {rec['proof_sha256']} differs "
              f"from RECURSIVE_SHA256")
        # 10: the starknet stand-in under the layout's scheme (eth)
        t0 = time.perf_counter()
        paths = make_artifacts.starknet_bundle(os.path.join(tmp, "star"),
                                               STARKNET_STEPS)
        star_bundle_s = time.perf_counter() - t0
        star = cli_slice("slice_starknet", paths, None, ETH_KERNELS,
                         ETH_ABSENT, tamper=True,
                         extra={"bundle_write_s": star_bundle_s})
        check(star["proof_sha256"] == STARKNET_SHA256,
              f"slice_starknet proof sha256 {star['proof_sha256']} differs "
              f"from STARKNET_SHA256")
        check(star["windows"] == {"constraint evaluation": 1,
                                  "DEEP composition": 1},
              f"slice_starknet windows {star['windows']}")
        # 10b: starknet-eth-2^21-ec, every Pedersen, ECDSA and EC-op slot
        # filled (the native witness batch's full load)
        counts = starknet_ec_counts(STARKNET_STEPS)
        t0 = time.perf_counter()
        paths = make_artifacts.starknet_bundle(os.path.join(tmp, "star_ec"),
                                               STARKNET_STEPS, **counts)
        ec_bundle_s = time.perf_counter() - t0
        star_ec = cli_slice("slice_starknet_ec", paths, None, ETH_KERNELS,
                            ETH_ABSENT, proves=1, tamper=True,
                            extra={"bundle_write_s": ec_bundle_s,
                                   "instances": counts})
        check(star_ec["proof_sha256"] == STARKNET_EC_SHA256,
              f"slice_starknet_ec proof sha256 {star_ec['proof_sha256']} "
              f"differs from STARKNET_EC_SHA256")
        check(star_ec["windows"] == star["windows"],
              f"slice_starknet_ec windows {star_ec['windows']}")
        ran = [sorted(k for k, v in x["launches"].items() if v)
               for x in (star, star_ec)]
        check(ran[0] == ran[1], f"slice_starknet_ec launched {ran[1]}, "
                                f"slice_starknet {ran[0]}")
        emit({"phase": "bundles", "plain_eth_write_s": bundle_s,
              "recursive_write_s": rec_bundle_s,
              "starknet_write_s": star_bundle_s,
              "starknet_ec_write_s": ec_bundle_s})
    check(eth["proof_sha256"] == SLICE_SHA256["slice_eth"],
          f"slice_eth proof sha256 {eth['proof_sha256']} differs from the "
          f"pinned {SLICE_SHA256['slice_eth']}")
    path_launches["slice_eth"] = eth["launches"]
    # the eth path's own Keccak grind replayed: the kernels line's
    # pow_grind row (3j's batch stays in its phase line)
    results["pow_grind"] = with_reach(grind_replay(eth["grind_records"][0]))
    check(results["pow_grind"]["launches"] == eth["launches"]["pow_grind"],
          f"the eth grind took {results['pow_grind']['launches']} windows, "
          f"pow_grind launched {eth['launches']['pow_grind']}")
    path_launches["cli_recursive"] = rec["launches"]
    path_launches["slice_starknet"] = star["launches"]
    path_launches["slice_starknet_ec"] = star_ec["launches"]

    # -- 10c: plain-cairo-gl-2^16 (slice_cairo_gl) -------------------------
    # the claim of phase 5 over Goldilocks under the cairo scheme, through
    # the claim API (no CLI route reaches it), verified at 64 bits: the
    # Goldilocks field caps the default options' 81
    gl_line = run_slice("slice_cairo_gl", "cairo", CAIRO_GL_KERNELS, GL,
                        absent=CAIRO_GL_ABSENT, bits=64,
                        extra={"nvidia_smi": smi})
    path_launches["slice_cairo_gl"] = gl_line["launches"]
    # the rows' conversion chain (widen, fp252_mul by R^2, byte reversal)
    # on one 2^21-row column through its wrappers, held to the host's
    # to_montgomery_bytes on a sample, and its device ms a prove: the base
    # and composition columns and every FRI layer's elements take the
    # chain, the one-column extension tree the widen alone
    col = rand_gl(gl_line["lde_rows"], 2)
    sample = GL.decode_ints(col[:4096])
    mont = GL.to_stark252_mont_be_words(col[:4096]).cpu().numpy()
    check([w.astype("<u4").tobytes() for w in mont]
          == [to_montgomery_bytes(v) for v in sample],
          "the GL rows' Montgomery words differ from to_montgomery_bytes")
    widen_ms = cuda_ms(torch, lambda: GL.to_stark252_canonical(col), 20)
    chain_ms = cuda_ms(torch, lambda: GL.to_stark252_mont_be_words(col), 20)
    n_lde = gl_line["lde_rows"]
    fri_elems = sum(n_lde >> (3 * i) for i in range(gl_line["fri_layers"]))
    chain_cols = (PlainAirConfig.NUM_BASE_COLUMNS
                  + PlainAirConfig.CE_BLOWUP_FACTOR + fri_elems / n_lde)
    del col
    gl_grind = with_reach(grind_replay(gl_line["grind_records"][0]))
    check(gl_grind["launches"] == gl_line["launches"]["pow_grind"]
          == gl_line["launches_warm"]["pow_grind"],
          f"the grind took {gl_grind['launches']} windows, pow_grind "
          f"launched {gl_line['launches']['pow_grind']}")
    emit({"phase": "slice_cairo_gl_costs", "nvidia_smi": smi,
          "conversion": {"rows": n_lde, "widen_ms": widen_ms,
                         "chain_ms": chain_ms,
                         "chain_columns_a_prove": chain_cols,
                         "ms_a_prove": chain_ms * chain_cols + widen_ms},
          "pow_grind": gl_grind})

    # -- 11: multi-device proving (parallel/) --------------------------------
    # (a) the tiny proofs under a virtual 4-shard mesh on the card: the
    # pinned bytes, the JAX package's digests
    n_cards = torch.cuda.device_count()
    tiny_opts = ProofOptions(num_queries=4, proof_of_work_bits=4)
    mesh4 = make_mesh(4, device=dev)
    tiny_mesh = {}
    for name, Fg, scheme in (("generic", F, "generic"),
                             ("cairo", F, "cairo"),
                             ("goldilocks", GL, "generic"),
                             ("gl3", GL3, "generic")):
        claim, witness = loop_claim(16, dev, field=Fg, scheme=scheme)
        calls = pdist.NTT_CALLS
        blob = serialize_proof(claim.prove(witness, tiny_opts, mesh=mesh4))
        calls = pdist.NTT_CALLS - calls
        check(calls > 0, f"the tiny {name} mesh prove took no dist_ntt")
        if Fg is F:
            with open(os.path.join(ROOT, "tests", "data",
                                   f"self_proof_{scheme}.bin"), "rb") as f:
                check(blob == f.read(), f"the tiny {name} proof under a "
                                        f"mesh differs from the pinned bytes")
        else:
            check(hashlib.sha256(blob).hexdigest() == TINY_SHA256[name],
                  f"the tiny {name} proof under a mesh differs from the JAX "
                  f"package's")
        tiny_mesh[name] = {"dist_ntt_calls": calls, "bytes": len(blob),
                           "equal_to_oracle": True}
    emit({"phase": "mesh_tiny", "shards": 4, "device": str(dev),
          **tiny_mesh})

    # (b) recursive-cairo-16384 under a mesh: four shards on the one card
    # (the exchanges are copies), or one shard a card where there are
    # several; beside it the same process's single-device warm prove
    mesh = make_mesh(4, device=dev) if n_cards == 1 else make_mesh(n_cards)
    claim, witness = recursive_loop_claim(RECURSIVE_STEPS, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = serialize_proof(claim.prove(witness, ProofOptions()))
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    check(hashlib.sha256(single).hexdigest() == RECURSIVE_SHA256,
          "the single-device recursive proof moved")
    mesh_line = run_slice("mesh_recursive", "cairo", PATHS["mesh_recursive"],
                          recursive=True, mesh=mesh,
                          extra={"single_device_prove_s": single_s,
                                 "nvidia_smi": smi})
    path_launches["mesh_recursive"] = mesh_line["launches"]
    # the mesh path's own shapes: its largest transform, the base LDE of
    # 2^19 rows by 7 columns, splits as n1 = 2^9 by n2 = 2^10 over D
    # shards; each shard runs the leaf on its columns at [n1, n2 / D x 7]
    # and on its rows at [n2, n1 / D x 7], and between them the twiddle
    # fp252_mul of [n1, n2 / D, 7] by a broadcast [n1, n2 / D, 1]
    D = mesh.size
    n1, n2, Bm = 1 << 9, 1 << 10, 7
    mesh_results = {}
    legs = [leaf_entry(n1, n2 // D * Bm)[3], leaf_entry(n2, n1 // D * Bm)[3]]
    mesh_results["ntt_leaf"] = {
        "max_abs_err": max(g["max_abs_err"] for g in legs),
        "shape": [g["shape"] for g in legs],
        **{k: sum(g[k] for g in legs) for k in ("ms", "plain_ms")},
        "work": {k: sum(g["work"][k] for g in legs)
                 for k in ("bytes", "imad")}}
    N = n1 * (n2 // D) * Bm
    xa = rand_elems(N).reshape(n1, n2 // D, Bm, 8)
    tw = rand_elems(n1 * (n2 // D)).reshape(n1, n2 // D, 1, 8)
    err = max_abs_err(torch, F.mul(xa, tw), fc.mul_plain(xa, tw))
    check(err == 0, "fp252_mul at the mesh twiddle's broadcast differs")
    out = torch.empty_like(xa)
    mesh_results["fp252_mul"] = {
        "max_abs_err": err, "shape": [list(xa.shape), list(tw.shape)],
        "ms": raw_ms("fp252_mul", (xa.data_ptr(), 1, N, tw.data_ptr(), Bm,
                                   n1 * (n2 // D), out.data_ptr(), N), 200),
        "plain_ms": cuda_ms(torch, lambda: fc.mul_plain(xa, tw), 3),
        "work": {"bytes": 32 * (2 * N + n1 * (n2 // D)),
                 "imad": MONTMUL_IMAD * N}}
    del xa, tw, out
    emit({"phase": "mesh_kernels", "shards": D, "n1": n1, "n2": n2,
          "columns": Bm, "ntt_leaf_legs": [with_reach(g) for g in legs],
          **{k: with_reach(v) for k, v in mesh_results.items()}})

    # (c) two processes (tools/mesh_prove.py), each proving the recursive
    # stand-in under one mesh of both: NCCL with a card a process where
    # there are two cards, else both on this card through a gloo group
    # named as such (its exchanges pass through host memory)
    backend = "nccl" if n_cards >= 2 else "gloo"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "sandstorm_tpu_torch", "tools",
                                      "mesh_prove.py"),
         "--procs", "2", "--backend", backend, "--proves", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    two_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"two-process prove exited "
                                f"{proc.returncode}: {proc.stderr[-3000:]}")
    workers = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith('{"rank"')]
    check(len(workers) == 2, f"two-process prove: {proc.stdout[-2000:]}")
    for w in workers:
        check(w["proof_sha256"] == RECURSIVE_SHA256 and w["verified"]
              and w["dist_ntt_calls_a_prove"] > 0,
              f"two-process prove: rank {w['rank']} gave {w}")
    emit({"phase": "mesh_two_process", "backend": backend,
          "exchange": ("NCCL, one card a process" if backend == "nccl"
                       else "gloo named by the caller: both processes on "
                            f"{dev}, exchanges through host memory"),
          "wall_s": two_s, "processes": workers})

    # (d) the grind's windows, both hashes: the first hit in the first
    # batch (8 bits), in a later batch of the window (20 bits) and in none
    # (32 bits over two batches), each launch three times against the plain
    # twin over the same window; and the slices' own grinds replayed
    window_line = {"window_batches": pow_grind.WINDOW, "nvidia_smi": smi}
    for hname in ("keccak", "blake2s"):
        for case, bits, batches, seed in (
                ("first_batch", 8, pow_grind.WINDOW, "1"),
                ("later_batch", 20, pow_grind.WINDOW, "1"),
                ("none", 32, 2, "none")):
            prefix = hashlib.sha256(f"window {hname} {seed}".encode()).digest()
            words = torch.from_numpy(np.frombuffer(prefix, "<u4").view(
                np.int32).copy()).to(dev)
            count = batches * pow_grind.BATCH
            got = {pow_grind.pow_grind(words, 1, bits, hname, batches)
                   for _ in range(3)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = pow_grind.pow_grind_plain(words, 1, bits, hname, batches)
            plain_ms = (time.perf_counter() - t0) * 1e3
            check(got == {want}, f"pow_grind ({hname}, {case}) gave {got}, "
                                 f"its plain twin {want}")
            where = want // pow_grind.BATCH
            check({"first_batch": where == 0,
                   "later_batch": 0 < where < batches,
                   "none": want == count}[case],
                  f"pow_grind ({hname}, {case}): offset {want}")
            out = torch.empty((1,), dtype=torch.int32, device=dev)
            kernel_ms = raw_ms("pow_grind", (words.data_ptr(), 1, bits,
                                             pow_grind.HASH_IDS[hname], count,
                                             out.data_ptr()), 50)
            walls = []
            for _ in range(21):
                t0 = time.perf_counter()
                pow_grind.pow_grind(words, 1, bits, hname, batches)
                walls.append(time.perf_counter() - t0)
            window_line[f"{hname}_{case}"] = with_reach({
                "bits": bits, "offset": want, "batch": where,
                "max_abs_err": 0, "shape": [count], "ms": kernel_ms,
                "plain_ms": plain_ms,
                "launch_and_read_ms": sorted(walls)[10] * 1e3,
                "work": {"bytes": 32 + 4,
                         "alu": min(want + 1, count) * grind_alu[hname]}})
    rec_grind = with_reach(grind_replay(rec_line["grind_records"][0]))
    check(rec_grind["launches"] == rec_line["launches"]["pow_grind"],
          f"the recursive grind took {rec_grind['launches']} windows, "
          f"pow_grind launched {rec_line['launches']['pow_grind']}")
    window_line["slice_cairo_gl"] = gl_grind
    window_line["slice_recursive"] = rec_grind
    window_line["pow_grind_launches_a_prove"] = {
        path: path_launches[path].get("pow_grind", 0)
        for path in ("slice_cairo", "slice_recursive", "slice_cairo_gl",
                     "slice_eth", "mesh_recursive")}
    emit({"phase": "grind_windows", **window_line})

    emit({"phase": "elapsed", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    # the walk at 8-bit windows runs on no path (tests and phase 3e only):
    # its bound stands beside its time here, outside the kernels line
    emit({"phase": "ec_madd_walk_8bit_bound", "M": walk[8]["M"],
          "madds": walk[8]["madds"], "ms": walk[8]["ms"],
          "plain_ms": walk[8]["plain_ms"], **bound(walk[8]["work"])})
    rows = []
    for k, (src, rep) in KERNELS.items():
        path = ROW_PATH[k]
        rows.append({"name": k, "route": "cuda", "source": src,
                     "replaces": rep, "path": path,
                     "launches": path_launches[path].get(k, 0),
                     "max_abs_err": results[k]["max_abs_err"],
                     "ms": results[k]["ms"],
                     "plain_ms": results[k]["plain_ms"],
                     **bound(results[k]["work"]), "library_ms": None})
    for path, names, res in (("slice_recursive", RECURSIVE_ROWS,
                              rec_results),
                             ("slice_starknet", STARKNET_ROWS,
                              star_results)):
        for k in names:
            src, rep = KERNELS[k]
            r = res[k]
            rows.append({"name": k, "route": "cuda", "source": src,
                         "replaces": rep, "path": path, "shape": r["shape"],
                         "launches": path_launches[path].get(k, 0),
                         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "plain_ms": r["plain_ms"], **bound(r["work"]),
                         "library_ms": None})
    # the full-load path launches the starknet path's kernels at its
    # shapes: each row's times are those of the row it names in timed_as
    for k in ETH_KERNELS:
        src, rep = KERNELS[k]
        timed_as = "slice_starknet" if k in STARKNET_ROWS else ROW_PATH[k]
        r = star_results[k] if k in STARKNET_ROWS else results[k]
        rows.append({"name": k, "route": "cuda", "source": src,
                     "replaces": rep, "path": "slice_starknet_ec",
                     "timed_as": timed_as, "shape": r.get("shape"),
                     "launches": path_launches["slice_starknet_ec"].get(k, 0),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], **bound(r["work"]),
                     "library_ms": None})
    # plain-cairo-gl-2^16: its transforms' leaves and its grind at its own
    # shapes, every other kernel as the row named in timed_as
    for k in CAIRO_GL_KERNELS:
        src, rep = KERNELS[k]
        own = gl_cairo_results.get(k) or (gl_grind if k == "pow_grind"
                                          else None)
        timed_as = "slice_cairo_gl" if own else ROW_PATH[k]
        r = own or results[k]
        rows.append({"name": k, "route": "cuda", "source": src,
                     "replaces": rep, "path": "slice_cairo_gl",
                     "timed_as": timed_as, "shape": r.get("shape"),
                     "launches": path_launches["slice_cairo_gl"].get(k, 0),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], **bound(r["work"]),
                     "library_ms": None})
    # recursive-cairo-16384 under a mesh: the shards' leaves (a column
    # and a row leaf, summed) and the twiddle fp252_mul at the mesh's own
    # shapes; the kernels that run on the claim's device at the recursive
    # path's rows (the opener, the group kernels, DEEP, the grind's
    # replay), every other kernel as the row in timed_as
    for k in PATHS["mesh_recursive"]:
        src, rep = KERNELS[k]
        if k in mesh_results:
            timed_as, r = "mesh_recursive", mesh_results[k]
        else:
            own = rec_results.get(k) if k in RECURSIVE_ROWS else (
                rec_grind if k == "pow_grind" else None)
            timed_as = "slice_recursive" if own else ROW_PATH[k]
            r = own or results[k]
        rows.append({"name": k, "route": "cuda", "source": src,
                     "replaces": rep, "path": "mesh_recursive",
                     "timed_as": timed_as, "shape": r.get("shape"),
                     "launches": path_launches["mesh_recursive"].get(k, 0),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], **bound(r["work"]),
                     "library_ms": None})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
