"""Smoke run of the PyTorch/CUDA port (nmftpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from nmftpu_torch/csrc with nvcc (sm_90a), checks
each against its plain torch twin, drives nmftpu_torch.nmf end to end at
the 4096 x 4096 / rank-256 headline shape and at the ML-20M shape, times
one MU iteration on three paths, then serves top-k recommendations with
nmftpu_torch.Recommender at BASELINE config 5's full width (10,485,760
items, rank 256, batches of 512 and 2048 users, k = 100) through the
reservoir-scan and count-above kernels, and times the serving paths.
Phases 10-12 factorize sparse V at BASELINE config 2's full width
(ML-20M's 138,493 x 26,744 shape and 20,000,263 ratings, rank 64)
through the ELL engine with the segment-SpMM kernel, the plain ELL
engine and the densified bf16 engine, under the Frobenius and KL
objectives, and time them. Phases 13-15 hold the fused multiply-divide,
the int8 x int8 numerator kernels and the HALS sweep against their twins
(up to the ML-20M shape), factorize 4096 x 4096 / rank 256, 2048 x 2048 /
rank 512 and the ML-20M shape (dense float32 V, rank 64) with HALS
through the sweep kernel, and run Jacobi MU (Frobenius and KL; float32,
bfloat16 and int8 V, int8 with the dual-numerator kernel) and int8 x int8
Gauss-Seidel MU against their Gauss-Seidel and kernel counterparts. After
the build, cuobjdump -sass counts each kernel's tensor-core instructions
and the script fails unless the int8 numerator kernels, the bf16 and
int8 reservoir and count scans and the split-tf32 MU kernels have some.
Phases 3, 5 and 13 also hold the MU kernels (#1-#4) and the HALS sweep
(#7) against float64: their error at most 4x the plain float32 twin's.
Phase 16 runs BASELINE config 3 at full size (138,000 x 27,000
power-law clicks from nmftpu_torch.data.synthetic, values 1, rank 128,
alpha_confidence 40) through prepare_sparse / SparsePlan.run on the
densified bf16 engine (auto's choice), densified int8, ELL and scatter:
the weighted objective must fall on each, one step must match a float64
recomputation on a row and a column sample, ELL and scatter must agree,
and the densified engines' objectives must agree with ELL's; it prints
ms per iteration and peak device memory. Phase 17, at config 2's shape,
runs int8 densified MU (Frobenius through #6's one-sided entries, whose
launches it counts and holds against the exact product; KL) and masked
completion (Frobenius and KL) on ELL and scatter, which must agree.
Phase 18 serves 2,048 cold users (users outside training, 100 items
each) from phase 8's two tables: prepare_table (the int8 Gram on the
int8 kernel's one-sided entry, one launch per 131,072-item panel, exact;
the bf16 Gram against float64), fold_in_batch (ALS, weighted ALS, MU,
KL, HALS on the sweep kernel, once per iteration) and
recommend_from_history_batch on the reservoir kernel at b = 512 and 2048;
each solve is held against float64 within 10 kappa 2^-24, each iterative
objective must fall, the scan's recall against the exact scan of the same
embeddings must reach 0.999 with no history item returned; it prints the
times. Phase 19 runs dense MU under the beta divergence (beta 0, 0.5,
1.5) at 4096 x 4096 / rank 256 through nmf, V stored as float32, bfloat16
and int8: D_beta must fall at every iteration, one float32 step must
match float64, and the bf16 and int8 runs must end within a limit
derived from V's storage rounding of the float32 run's D_beta. The
native host library (native/build/libnmftpu_io.so, built with make in
phase 2 beside the kernels) builds every CSR and ELL layout from phase 10
on; phase 20 holds its CSR and ELL builds equal to numpy's at config 3
(in phase 16, whose ELL build must count two native calls) and config 2,
prints both paths' host seconds, and parses both MovieLens fixtures with
the native and the numpy parser. It then runs beta MU (beta 0.5, 1.5) at
config 2's full width on the densified bf16 (auto's choice), densified
int8, ELL and scatter engines, and ELL on the int8-dequantized ratings,
4 iterations each: D_beta must fall at every iteration, one step must
match a float64 recomputation on 64 rows and 64 columns (ELL, scatter
1e-4; densified within its derived bf16 bound), ELL and scatter must
agree, and the densified runs' D_beta must agree with ELL's; it prints
ms per iteration and peak memory, and checks auto's engine under beta.
Phase 21 runs the dense ALS family (ALS, ACLS, AHCLS), GDCLS and nsNMF
(Frobenius and KL) through nmf on float32, bf16 and int8 V: at 4096 x
4096 / rank 256 for 50 iterations each (the error must fall; one step,
each half-step from the same inputs, against a float64 recomputation:
solves within 10 sqrt(r) kappa 2^-24 of the float64 solve of their own
Gram and right-hand side, MU-type steps 1e-4, bf16 ones 5 * 2^-9; the
int8 right-hand sides equal to the exact product; #6's one-sided entries
launched once per int8 half-step), and int8 and bf16 ALS, GDCLS and nsNMF
at the ML-20M shape for 10 (bf16's final error within 1e-3 of float32's,
int8's after one iteration, on the same stored values); then the k-means
init (the within-cluster sum must not rise) and the k-means and NNDSVD
inits at 4096^2 (host seconds, the NNDSVD variants from one shared SVD;
nndsvd and nndsvdar start below the random init's error), and every
algorithm from every init on BASELINE
config 1 (the ML-100K fixture, and 943 x 1682 / 100,000 ratings at rank
32), printing the final RMSD.
Phase 22 runs the ALS family (ALS, ACLS, AHCLS), GDCLS and nsNMF
(Frobenius and KL) on sparse V at config 2's full width (phase 10's
ratings, rank 64) on ELL, scatter, densified bf16 (auto's choice) and
int8 (the Frobenius family, its right-hand sides on #6's one-sided
entries, launched once each an iteration), and HALS on scatter (auto's
choice; its sweeps on #7, two launches an iteration, #7 held against its
twin on the run's operands and timed at 138,493 x 64 beside its bound),
4 iterations each from one W0/H0: the objective falls at every iteration
for nsNMF and HALS (the clamped solves of the ALS family and GDCLS need
not descend; theirs is printed), one step on 64 rows and 64 columns
matches float64
(solves within 10 sqrt(r) kappa 2^-24 of the float64 solve of the card's
own Gram and right-hand side, those within 1e-4, bf16 MU-type halves 5 *
2^-9, int8 right-hand sides exact), ELL and scatter agree after one
iteration, densified bf16 ends within 1e-3 of ELL. It runs iALS at config
3's full size (phase 16's matrix and start, rank 128, alpha 40; within
the card's default Gram budget, its refusal checked under 8 GiB) on
ELL (auto's choice; exact and cg) and scatter: the float64 weighted
objective after 0, 1 and 4 iterations beside weighted MU's of phase 16,
cg's final error beside exact's, one step per row against float64 normal
equations from the triplets (LU; for cg the same CG steps), ELL against
scatter; masked
ALS at config 2 on ELL and scatter; dense iALS at 4096^2 / rank 256; and
the sparse inits: k-means at config 2's full width (the within-cluster sum
never rises), and at config 1's shape (943 x 1682, 100,000 power-law
ratings, rank 32) sparse k-means against the dense Lloyd (float64) and
NNDSVD from a host svds (nndsvd and nndsvdar below the random start,
nndsvda the nndsvd start filled with the mean, within 1e-3 of the dense
nndsvd start). It prints ms per iteration, peak memory and its seconds.
Phase 23 drives the remaining surfaces: (a) the sklearn facade at config
2's full width (phase 10's ratings as a scipy CSR, phase 22's W0/H0,
rank 64): NMF(solver="cd") (HALS on scatter, #7 twice an iteration)
after one iteration within 1e-4 of compute_sparse from the same start
and its objective after 4 within 2e-3, reconstruction_err_ within 1e-4
of the script's float64 error of the same factors, NMF(solver="mu",
beta_loss="kullback-leibler") likewise (auto's engine printed), the
HALS fold-in (transform) of 2,048 held-out users with 100 distinct
items each falling at every iteration on #7, inverse_transform and
non_negative_factorization(update_H=False); (b) MiniBatchNMF (KL,
1,024-row panels, 2 epochs): one minibatch_step against float64 at
1e-4, the divergence per epoch, ms per panel and peak device memory
below one dense n x m float32 array, and an OnlineNMF stream saved
after 68 panels, loaded and fed the other 68, equal to the
uninterrupted stream (atol 0); (c) compute_batched of 8 problems at
4096 x 4096 / rank 256 (phase 4's generator) on plain MU, #1/#2, #3/#4
and HALS (#7), each problem against a solo compute (W/H 1e-3; int8 and
HALS errors 1e-3 and 2e-3, HALS after one iteration 1e-4), one launch
per problem and half-step, and #1-#4 and #7 against their twins on
problem 0's factors; (d) 4 vectorized restarts (#1/#2, HALS) against
the sequential ones (run errors 1e-4, the best run); (e) a checkpoint
after 10 iterations resumed to 20 against the uninterrupted run
(1e-6); (f) rank selection over ranks 16, 32, 64 at config 1's shape
(consensus symmetric, unit diagonal, in [0, 1]) and the compat API
(the card's name, RMSD below the zero model's); (g) python -m
nmftpu_torch on config 1's ratings written as u.data (recall@10, a
saved bundle that Recommender.load reads onto the card, one JSONL record
per check); (h) native/test_capi.c compiled unchanged against the
port's C ABI (nmftpu_torch.capi.build()) and run on the card.
Phase 24 drives slice 6a, the multi-GPU layer, through the port's
launcher (nmftpu_torch.parallel.launch: spawned ranks, a FileStore; any
rank's failure fails the script): (a) one rank under NCCL on a 1 x 1 mesh
at one device's share of BASELINE config 4 on an 8 x 4 grid (12,500,000 x
2,500,000, rank 256, 156,250,000 power-law draws from the port's
generator, made in a background process while phases 2-23 run): MU
Frobenius through prepare_sharded / run on ELL (2 iterations) and
scatter (1), each half of one iteration against compute_sparse from the
same W0/H0 (1e-4, or 8 sqrt(K) 2^-24 for sums of K > 175,000 terms), ms
per iteration and peak memory; (b) four ranks sharing the card on a 2 x 2
gloo mesh at config 2 (phase 10's ratings, phase 22's W0/H0): MU
Frobenius and KL on ELL and scatter, HALS (#7, two launches an iteration
on every rank) and iALS (alpha 40) on scatter, each half of one
iteration against the 1 x 1 run and compute_sparse, the error after 4
against the 1 x 1 run, the bytes staged through the host for gloo, which
gloo collectives take CUDA tensors, and #7 against its twin on each
rank's operands; (c) four ranks on a 1 x 4 mesh serving config 5, each
holding a quarter of
phase 8's int8 table: recommend on the reservoir kernel (#8 on each
rank), the exact sharded scan, recommend_certified(fallback="exact")
with the count kernel (#9 on each rank), against the unsharded exact scan
(recall@100, rows not exact, seen violations), #8 and #9 against their
twins on each rank's slice. Times of ranks sharing one card say nothing
about scaling.
Phase 25 drives slice 6b on four gloo ranks sharing the card and one NCCL
rank: (a) the ring engine (a 4-ring; p = 1 under NCCL, nothing sent) at
config 2's full width (phase 10's ratings, phase 22's W0/H0, rank 64:
MU Frobenius and KL, beta 1.5, ALS, GDCLS, nsNMF) and weighted MU at
config 3's (phase 16's matrix and start, rank 128, alpha 40), each half
of one iteration against compute_sparse's scatter engine from the same
(W, H) within 8 sqrt(K) 2^-24 (a solved half (10 sqrt(r) + 8 sqrt(K))
kappa 2^-24), ms an iteration a rank and MB staged; (b) dense V at the
ML-20M shape (each rank densifies its tile of the ratings on the card),
float32 and int8, on 2 x 2 and 1 x 1: each half against the unsharded
driver.compute (1e-4; int8 1e-5), the errors after 2 iterations (1e-3);
4096^2 / rank 256 (phase 4's V) with use_pallas on 4 x 1 and 1 x 4
(#1-#4 on the local half, #5 on the other) and int8 Jacobi on 2 x 2
(#6's dual entry), each against the unsharded run, the kernels against
their twins on a rank's tile and #5 bit-equal; every kernel of (b) must
launch; (c) config 5's int8 table on 1 x 4 (2,621,440 items a rank):
phase 18's cold users at b = 512, the sharded Gram equal to the
unsharded one, ALS against float64 within 10 kappa 2^-24, ALS, MU and
HALS fold-ins against the unsharded ones (1e-4), recommend_from_history's
recall@100 against the exact scan (0.999) with no history item, #7 and
#8 against their twins on a rank; (d) MiniBatchNMF (KL, 1,024-row
panels, one epoch) on four item shards against one card; (e) NMF(mesh=)
at config 2 and checkpoint.resume(mesh=) of phase 23's checkpoint on 2 x
2 against one card, rank_selection(mesh=) at config 1's shape, the three
conversions onto the mesh and dryrun_multichip(4).
Phase 26 drives slice 16: (a) nmftpu_torch.graft_entry.entry(), the twin
of __graft_entry__.entry (one MU-Frobenius step and its error at 256^2,
rank 32), on the card against the same step on the CPU (1e-5), and its
ms; (b) ring iALS (alpha 40) with the exact and the cg row solver, one
iteration from (W0, H0): config 3 (phase 16's matrix and start, rank
128) on one NCCL rank, config 2 (phase 10's ratings, phase 22's start,
rank 64, cg) on four gloo ranks sharing the card; each half against
compute_sparse's scatter engine with the same solver on 64 users and 64
items (the most popular included), per row within 10 sqrt(r) kappa_row
2^-24, the H half plus kappa_row times W's measured difference; (c) on
the NCCL rank at config 2, a ring and an ELL plan prepared unmasked
refuse a mask="observed" run with ValueError before any launch.
Phase 27 runs kernel #12 (nmftpu_torch/kernels/row_solve.py, the per-row
ridged solves) alone at config 3's two half-steps, 136,677 and 20,108
seeded iALS-like systems at r = 128, against the plain path (the panel
loop over the batched Cholesky and its explicit inverse) and, on a row
sample, float64 Cholesky: its error at most 4x the plain path's, and the
ms of both beside the bound.
Phase 28 runs kernel #13 (nmftpu_torch/kernels/ell_gram.py, every row's
weighted Gram and right-hand side of an iALS half-step) alone at config
3's two half-steps: synthetic clicks at ML-20M clicks' shape (136,677 x
20,108, 9,990,682 requested, Zipf 0.9 both ways), r = 128, alpha 40,
against the plain path (gathers, batched products, index_add_): each
half's work-unit index, its launches (one, two with split rows), the
kernel against the plain path and, on a row sample with the heaviest
row, both against float64 (the kernel's error at most twice the plain
path's), and the ms of both beside the bound. Phase 22 counts its
launches on the main path (the ELL iALS runs at config 3).
Phase 29 runs kernel #11 under its CG rule (nmftpu_torch/kernels/
sparse_ell_kernel.py `ell_cg`, the sparse term of the iALS systems'
product with a CG direction) on the msd-clicks cell's clicks (571,355 x
41,140, 33,633,450 ones, from benchmark/datagen/clicks.py and
benchmark/configs/msd-clicks.json), r = 256, each half: one launch
against its twin sparse_ell.cg_product_ell within ELL_KL_RTOL of the
largest entry, the ms of both beside the bound, and a whole matrix-free
half-step on the kernel routes (3 steps) against float64 CG from the
same start on 64 rows (the heaviest included), its error over those rows
together at most CG_F32_PER_KAPPA kappa, the plain twin's beside it.
Phase 22 counts its launches (8 an iteration) on config 3's ELL cg run
and holds that run's first W half-step to the same rule, beside the
twin and the formed systems' float32 route that nmftpu runs.
Every phase prints its results; any failure exits non-zero, as does a
kernel timed below its bound. Without a CUDA device it exits 1 and runs
nothing.

The line before the last is a JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SEED = 20240611

# phase 3: kernel vs plain twin, all inputs nonnegative. float32 sums of up
# to K = 4096 terms in two orders differ by ~sqrt(K) * 2^-24 ~ 4e-6
# relative; the ratio num / den adds two such errors. 1e-4 leaves >10x.
KERNEL_RTOL = 1e-4
KERNEL_SHAPES = [(4096, 4096, 256), (943, 1682, 32), (1000, 1500, 37)]
# phases 3, 5 and 13: the float64 check. #1-#4 multiply on the tensor
# cores in split tf32 and #7 sums in another order; one tf32 pass (2^-11
# relative) would pass KERNEL_RTOL, so every output is also held against
# a float64 product: its largest relative error (#7: largest error over
# max|W|) at most F64_FACTOR times the plain float32 twin's
F64_FACTOR = 4
# phase 4: final W/H of 50 kernel iterations vs the plain path, as
# max|a - b| / max|b|. The per-step reordering error above compounds over
# the run: 3e-6 after 50 steps at 1024^2 / r = 64 on the CPU; 1e-3 leaves
# room for K = 4096 and r = 256.
E2E_RTOL = 1e-3

# phases 7-9: the serving kernels. Scores are float32 sums of 256 exact
# products in two orders, ~sqrt(256) * 2^-24 = 1e-6 relative apart;
# 1e-5 leaves 10x. Reservoir ids may differ only at such near-ties. The
# count must equal the chain count exactly: the reference counts a float32
# matmul's scores where they lie farther than SCAN_RTOL |theta| from theta
# and re-scores the rest by the k-ordered chain (_gather_scores).
SCAN_RTOL = 1e-5
# the band's constant (kernels/count_above.py BAND_C, in units of
# r 2^-23 ||q||_1 h_max) must exceed the largest tensor-core error seen on
# the full tables, in those units, this many times
BAND_MARGIN = 4
# BASELINE config 5 at full width; users as ML-20M's
SERVE_USERS, SERVE_ITEMS, SERVE_RANK = 138_493, 10_485_760, 256
SERVE_SEEN = 100            # seen items per user, uniform over the catalog
SERVE_K = 100
RECALL_FLOOR = 0.999        # expected miss C(k,3)/R^2 = 0.0096 items/row

# phases 10-12: the ELL segment SpMM. Each output is a float32 sum of at
# most 512 nonnegative products in two orders, ~sqrt(512) * 2^-24 =
# 1.3e-6 relative apart; 1e-5 leaves 7x.
ELL_RTOL = 1e-5
# #11 against its twin: the same sums, each coefficient's sample a float32
# dot of r terms in another order (~sqrt(r) * 2^-24: 4.8e-7 at r = 64,
# 9.5e-7 at 256) on top: 2.3e-6 at most, 1e-5 leaves 4x
ELL_KL_RTOL = 1e-5
# BASELINE config 2: ML-20M's shape and rating count, rank 64
SPARSE_RANK = 64
SPARSE_ITERS, SPARSE_CHECK = 10, 2
# final W/H of the kernel run vs the plain ELL run after 10 iterations
# (max|a - b| / max|b|): per-step reordering error ~1e-6, and index_add_
# adds segments atomically, in another order on every run
SPARSE_E2E_RTOL = 1e-3
# final D_KL of the ELL run vs the densified run. Half-star ratings are
# exact in bf16, so the two see the same V; they differ in that the
# densified contractions round W and H to bf16 (2^-9 relative per
# operand, at random over the r = 64 terms) and sum in another order
KL_ENGINES_RTOL = 1e-3

# phases 13-15: dense HALS and the int8 x int8 numerators. The HALS
# kernel sums in float32 in another order than its twin, and the clamp
# and the division by the hessian amplify it: nmftpu's bound for its own
# sweep kernel, times max|W|
HALS_ATOL = 3e-5
# HALS through the kernel vs the plain blocked sweep. One iteration's W/H,
# max|a - b| / max|b|: float32 reordering, ~1e-6. After that a float32
# ulp can flip a clamp, and coordinate descent moves the factors to
# another point of nearly equal error (two plain sweeps in another order
# or precision do the same), so the factors are held after one iteration
# and the error after 50; the factors after 50 are printed, with no limit.
HALS_STEP_RTOL = 1e-4
HALS_E2E_RTOL = 2e-3
# ML-20M's shape, rank and rating count (phases 5 and 13-15)
ML20M = (138_493, 26_744, 64, 20_000_263)

# phases 16-17: confidence weighting, int8 densified storage, masked
# completion. BASELINE config 3 as scripts/graded_configs_tpu.py builds
# it: 138,000 x 27,000, 40M power-law draws (duplicates collapse: the
# true nnz is read from the result), values 1, rank 128, alpha 40
CONFIG3 = dict(n=138_000, m=27_000, nnz=40_000_000, alpha_user=0.9,
               alpha_item=0.9, seed=2)
C3_RANK, C3_ALPHA = 128, 40.0
# each engine: one step (checked against float64), then C3_ITERS - 1 more
C3_ITERS = 4
# one step against a float64 recomputation of the weighted update on a
# row and a column sample, max|a - b| / max|b|. ELL and scatter: float32
# sums of up to a row's or a column's nonzeros in another order,
# ~sqrt(K) 2^-24 ~ 1e-6; 1e-4 leaves 100x. Densified: each sum is of
# nonnegative terms, each term's bf16 roundings bound its relative error:
# the numerator rounds the partner factor (C.V = 41 is exact), the
# denominator W and H inside WH, then C.WH, then the partner (4 roundings);
# a row or column with few nonzeros averages nothing away, so the ratio's
# bound 5 * 2^-9 = 9.8e-3 is the limit. An update without the alpha term
# is off by O(1)
C3_STEP_RTOL = {"float32": 1e-4, "bf16": 5 * 2**-9}
# ELL against scatter after C3_ITERS: the same float32 update, gathers
# against atomic scatters (as SPARSE_E2E_RTOL)
C3_ENGINES_RTOL = 1e-3
# the weighted objective sum c (v - wh)^2 after C3_ITERS, densified (bf16
# and int8) against ELL: the bf16 roundings move each step's factors by
# ~1e-4 (above); the objective moves by at most about twice that
# relative, compounded over C3_ITERS steps
C3_OBJECTIVE_RTOL = 1e-3
# phase 17 at config 2's shape, rank 64
S8_ITERS = 4

# phase 27: #12 alone at config 3's two half-steps (ML-20M clicks: 136,677
# user rows, 20,108 item rows, r = 128), on seeded iALS-like systems: the
# other side's Gram of uniform factors plus 40 times the outer products of
# ROW_SOLVE_CLICKS of its rows a row (kappa about 10^3), lambda 0.1. A
# seeded sample of ROW_SOLVE_SAMPLE rows a half is solved again in
# float64; the kernel's error is held to F64_FACTOR times the plain
# path's on the same rows
ROW_SOLVE_HALVES = (("W", 136_677, 20_108), ("H", 20_108, 136_677))
ROW_SOLVE_CLICKS = 16
ROW_SOLVE_SAMPLE = 2048
ROW_SOLVE_LAMBDA = 0.1

# phase 28: #13 alone at config 3's two half-steps: synthetic clicks at
# ML-20M clicks' shape (the benchmark's implicit-ml20m cell), Zipf 0.9 for
# users and items. ELL_GRAM_SAMPLE rows a half (the heaviest included) are
# summed again in float64; the kernel's error (the largest over the rows
# of max|G - G64| / max|G64|) is held to ELL_GRAM_F64_FACTOR times the
# plain path's on the same rows (test_torch_ell_gram.py's rule)
ELL_GRAM_SHAPE = (136_677, 20_108, 9_990_682)
ELL_GRAM_SAMPLE = 128
ELL_GRAM_F64_FACTOR = 2

# phase 29: #11's CG rule on the msd-clicks cell's clicks and settings
# (rank, alpha, lambda) at ELL_CG_STEPS steps a half-step, a matrix-free
# half-step checked on ELL_CG_SAMPLE rows (the heaviest included)
ELL_CG_CONFIG = "benchmark/configs/msd-clicks.json"
ELL_CG_STEPS = 3
ELL_CG_SAMPLE = 64
# a float32 CG half-step (3 steps) against float64 CG from the same start,
# the rows together: at most CG_F32_PER_KAPPA times the largest kappa of
# the rows. Float32 arithmetic inside the steps sets this distance, not
# the route: 3 float32 steps leave float64 CG by up to ~10% on single rows
# of kappa ~10^3 (phase 22), and float32 routes of the same iteration
# spread over 4x on config 3's rows at kappa 614 (the plain twin 7.7e-3,
# nmftpu's formed systems 1.5e-2, the kernel routes 2.9e-2 to 3.1e-2 on
# an H100), while a sound route's products stay within ELL_KL_RTOL of the
# twin's (phase 29) and its float64 iteration within 1e-10 of the formed
# one (tests/test_torch_ell_cg.py)
CG_F32_PER_KAPPA = 1e-4

# phase 18: cold users at config 5 (users outside training, SERVE_SEEN
# distinct items each, drawn as serving_data draws them), folded in against
# phase 8's two tables. The fold-in defaults of recommend_from_history*
# (ALS, Frobenius, lambda_w 1e-6, 50 iterations for MU and HALS)
COLD_USERS = 2048
COLD_ALPHA = 40.0           # the weighted ALS fold-in, values 1 .. 5
COLD_ITERS = 50
COLD_LAMBDA, COLD_EPS = 1e-6, 1e-9
COLD_SAMPLE = 16            # users whose weighted solve is redone in f64
# a float32 solve of (G + lambda I) w = n is off by about kappa 2^-24
# relative (kappa the system's condition number, computed and printed);
# the fold-in's W against a float64 solve of the same equations
SOLVE_FACTOR = 10
# the bf16 table's float32 Gram against float64: sums of about 10^6
# positive products per panel, sqrt(10^6) 2^-24 ~ 6e-5
GRAM_BF16_RTOL = 1e-4

# phase 19: dense float32 beta MU at 4096^2 / r = 256 through nmf; one
# step against float64: float32 powers of WH (a sum of 256 positive
# products, ~1e-6 relative) and sums of 4096 positive terms, ~1e-5
BETAS = (0.0, 0.5, 1.5)
BETA_SHAPE = (4096, 4096, 256)
BETA_ITERS = 10
BETA_STEP_RTOL = 1e-4
# phase 19, bf16 and int8 V: the final D_beta against the float32 run's.
# The stored V' differs from V by up to 2^-9 |v| (bf16) or scale / 2
# (int8); at fixed factors that moves D_beta by at most
# sum |d d_beta / dv| |v' - v|, d d_beta / dv = (v^(b-1) - wh^(b-1)) / (b-1)
# (1/wh - 1/v at b = 0), computed in float64 at the float32 run's final
# factors; the densified update's bf16 roundings of W and H (in WH, raised
# to b - 2 and b - 1), of (WH)^(b-2) V and (WH)^(b-1), and of the partner
# factor move one step's ratio by at most (2|b - 2| + 2|b - 1| + 4) 2^-9.
# The limit is the sum of the two, relative to D_beta, printed beside it.

# phase 20: beta MU at BASELINE config 2's full width (the ratings of
# phases 10-12, rank 64) on four engines, 4 iterations each
C2_BETAS = (0.5, 1.5)
C2_BETA_ITERS = 4
# one step against a float64 recomputation on 64 rows and 64 columns (the
# most popular user and item included), largest relative error of an
# entry. ELL and scatter: float32 sums in another order and float32
# powers (|b - 2| ulps of WH's rounding), ~1e-6; 1e-4 leaves 100x.
# Densified: its bound is C2_BF16_STEP(beta), derived in the function
C2_STEP_RTOL = 1e-4
# after C2_BETA_ITERS: ELL against scatter (W, H); densified bf16 against
# ELL and densified int8 against ELL on the dequantized ratings (D_beta):
# as phase 16's C3_ENGINES_RTOL and C3_OBJECTIVE_RTOL
C2_ENGINES_RTOL = 1e-3

# phase 21: the dense ALS family, GDCLS and nsNMF (Frobenius, KL) through
# nmf on float32, bf16 and int8 V: phase 4's 4096^2 / r = 256 problem for
# FAMILY_ITERS iterations, and int8 and bf16 ALS, GDCLS and nsNMF at the
# ML-20M shape (phase 5's ratings, dense, r = 64) for FAMILY_ML_ITERS
FAMILY = (("als", "frobenius", {}),
          ("acls", "frobenius", {"lambda_w": 0.1, "lambda_h": 0.1}),
          ("ahcls", "frobenius", {"lambda_w": 0.1, "lambda_h": 0.1,
                                  "alpha_w": 0.5, "alpha_h": 0.5}),
          ("gdcls", "frobenius", {"lambda_tik": 0.1}),
          ("nsnmf", "frobenius", {"theta": 0.5}),
          ("nsnmf", "kullback-leibler", {"theta": 0.5}))
FAMILY_ITERS = 50
FAMILY_ML_ITERS = 10
# one step against a float64 recomputation of the same equations, max|a -
# b| / max|b|, each half-step from the same inputs. A solve (ALS, ACLS,
# AHCLS, the GDCLS H step), as phase 18 holds one: the float64 solve of the
# card's own Gram and right-hand side, within SOLVE_FACTOR sqrt(r) kappa
# 2^-24 (kappa of the solved matrix): a Cholesky or LU solve's backward
# error grows with the order r (~sqrt(r) 2^-24 typical, r 2^-24 at worst),
# and at r = 256 every float32 solver lands at 5-22 kappa 2^-24 on these
# systems (the explicit inverse, cholesky_solve and LU, on the card and the
# host; the first system prints them); the Gram and the right-hand side
# themselves against
# float64 products of the operands the step rounds (V as stored; the
# partner in bf16, or quantized and dequantized for int8) at
# FAMILY_MU_RTOL. An MU-type half-step (the GDCLS W step, nsNMF) on float32
# V, or on int8 V under Frobenius (dequantized operands): float32 sums of
# 4096 positive terms in another order, ~1e-6; 1e-4 leaves 100x
FAMILY_MU_RTOL = 1e-4
# an MU-type half-step on bf16 V, or nsNMF-KL on int8 V (its contractions
# are bf16), against float64 on the unrounded factors: each product term
# carries at most three bf16 roundings (W and H inside WH, the ratio, the
# partner), so phase 16's 5 * 2^-9 bounds the ratio of two positive sums
FAMILY_BF16_RTOL = 5 * 2**-9
# ML-20M shape: the error of a bf16 run after FAMILY_ML_ITERS against the
# float32 run on the ratings (half stars are exact in bf16; rounding the
# factors is the difference); of an int8 run after its first iteration
# against the float32 run, both on the dequantized ratings (one step's
# requantization is the difference). Later int8 iterations compound the
# coarseness of one scale over W's 138,493 rows, which no limit here
# derives; their distance from float32 is printed. nmftpu's int8 GDCLS
# leaves float32 the same way, step for step with the port, at all
# 138,493 rows and 8192 columns (tests/test_torch_int8_scale_witness.py)
FAMILY_STORAGE_RTOL = 1e-3
# the inits at 4096^2 / r = 256: Lloyd's within-cluster sum of squares
# cannot rise in exact arithmetic; a float32 argmin can move a column whose
# two distances tie within their rounding (~2^-24 (|v|^2 + |c|^2) each),
# far below 1e-6 of the sum
KMEANS_ITERS = 25
KMEANS_RISE_RTOL = 1e-6
# BASELINE config 1 ("MovieLens-100K dense NMF, rank 32"): every
# algorithm from every init, on the repo's ML-100K fixture (302 ratings of
# 30 users and 40 items, so rank 8, as the CPU tests take it) and at
# config 1's full width, 943 x 1682 with ML-100K's 100,000 ratings
# (synthetic: distinct cells drawn uniformly, 1 to 5 stars) at rank 32
CONFIG1 = (943, 1682, 100_000)
CONFIG1_RANK = 32
CONFIG1_FIXTURE_RANK = 8
CONFIG1_ITERS = 100

# phase 22: the ALS family, GDCLS, nsNMF (FAMILY) and HALS on sparse V at
# config 2's full width (phase 10's ratings, r = 64) on ELL, scatter and
# densified bf16 and int8, S12_ITERS iterations each from one W0/H0; iALS
# at config 3's full size (phase 16's matrix and W0/H0, r = 128, alpha 40)
# on ELL (exact and cg) and scatter; masked ALS at config 2; dense iALS at
# 4096^2 / r = 256 (phase 4's V, W0, H0); the sparse inits
S12_ITERS = 4
# one step against float64 on 64 rows and 64 columns (the most popular
# user and item included), each half from its own inputs: a solve at
# SOLVE_FACTOR sqrt(r) kappa 2^-24 of the float64 solve of the card's own
# Gram and right-hand side (phase 21's limit); the Gram and the right-hand
# side, float32 SpMMs of at most a row's or a column's nonzeros, at phase
# 20's 1e-4; an MU-type half at 1e-4 (bf16: FAMILY_BF16_RTOL); HALS against
# the sequential float64 sweep at HALS_STEP_RTOL (phase 14's one-iteration
# limit)
S12_MU_RTOL = 1e-4
# each rule's final objective on densified bf16 against ELL's after
# S12_ITERS: phase 16's C3_OBJECTIVE_RTOL
S12_ENGINES_RTOL = 1e-3
# config 3 iALS: one step per row against float64 normal equations built
# from the triplets, solved by LU, at SOLVE_FACTOR sqrt(r) kappa 2^-24,
# kappa the row's own (cg: its solver run to r steps on the same rows);
# the weighted objective after 0, 1 and S12_ITERS iterations is printed
# beside weighted MU's from the same W0/H0 (phase 16's ELL run): clamped
# iALS from a random start need not descend (tests/test_torch_ials.py's
# witness). The cg run's final Frobenius error at most IALS_CG_FACTOR x
# the exact run's (nmftpu's test_ials_cg_solver_tracks_exact)
IALS_CG_FACTOR = 1.02
# (n + m) r^2 4 bytes = 10.07 GiB of per-row Grams at config 3: within the
# card's default budget (half its memory); phase 22 checks the refusal under
# SMALL_BUDGET, and phase 26 sets IALS_BUDGET for its ranks
IALS_BUDGET = 16 * 2**30
SMALL_BUDGET = 8 * 2**30
DENSE_IALS_ITERS = 2

# phase 23: the remaining surfaces. (a) the sklearn facade at config 2's
# full width (phase 10's ratings, phase 22's W0/H0, r = 64), fits of 1 and
# SURFACE_FIT_ITERS iterations: one cd iteration against compute_sparse at
# HALS_STEP_RTOL, the objective after SURFACE_FIT_ITERS at HALS_E2E_RTOL
# (scatter's atomics reorder the sums; after the first sweep a float32 ulp
# can flip a clamp), reconstruction_err_ against the script's float64
# error of the same factors at SURFACE_ERR_RTOL (float32 sums of the
# Gram-trick terms or of 3.7e9 KL terms in row panels); (b) MiniBatchNMF
# at config 2, batch MB_BATCH, 2 epochs: one step against float64 at
# SURFACE_ERR_RTOL (the same guarded float32 operations, sums of 26,744
# terms); (c) compute_batched, BATCH problems of 4096^2 / r = 256 (phase
# 4's generator, seeds SEED + i), BATCH_ITERS iterations, each against a
# solo compute at E2E_RTOL (HALS: one iteration at HALS_STEP_RTOL, the
# error at HALS_E2E_RTOL); (d) VEC_RUNS vectorized restarts against the
# sequential ones; (f) RANKS at config 1
SURFACE_FIT_ITERS = 4
SURFACE_ERR_RTOL = 1e-4
MB_BATCH = 1024
BATCH, BATCH_ITERS = 8, 20
BATCH_SHAPE = (4096, 256)   # n = m, r
VEC_RUNS = 4
RANKS = (16, 32, 64)

# phase 24: slice 6a, the 2-D grid and sharded serving over the port's
# launcher. (a) one rank, NCCL, a 1 x 1 mesh, at one device's share of
# BASELINE config 4 on an 8 x 4 grid: 100M x 10M / 32 devices, the graded
# script's power-law generator (alphas 1.1, seed 3) and 50 ratings a user
# (5e9 draws / 32), rank 256; duplicate draws collapse, so the tile's
# nonzeros are read from the result. MU-Frobenius on ELL and scatter
# through prepare_sharded / run, each half of one iteration against
# compute_sparse (scatter) from the same W0/H0 (grid_config's orders):
# float32 sums of up to the tile's longest row's or column's K terms in
# another order (gathers against atomics), ~sqrt(K) 2^-24 apart; held at
# GRID_STEP_RTOL as phase 22 holds ELL against scatter (7x its sqrt(K)
# 2^-24 there), or at the same margin, 8 sqrt(K) 2^-24, where K passes
# 175,000 (config 4's head rows and columns hold ~10^6 nonzeros). (b)
# four ranks sharing the card (gloo), a 2 x 2 mesh, config 2 (phase 10's
# ratings, phase 22's W0/H0): MU Frobenius and KL on ELL and scatter, HALS
# and iALS (alpha 40) on scatter; each half of one iteration against the
# 1 x 1 run and compute_sparse at GRID_STEP_RTOL (HALS at HALS_ATOL of
# max|W|: the sweep's clamp and hessian division amplify the reordering,
# as phase 13 holds #7), the error after GRID_ITERS against the 1 x 1 run
# at GRID_ERR_RTOL (a float32 ulp can flip a clamp after the first step).
# (c) four ranks on a 1 x 4 mesh, config 5 at full width, each holding a
# quarter of phase 8's int8 table.
C4_SHAPE = (12_500_000, 2_500_000)
C4_DRAWS = 156_250_000
C4_RANK, C4_SEED = 256, 3
GRID_STEP_RTOL = 1e-4
GRID_ERR_RTOL = 1e-3
GRID_ITERS = 4
GRID_RANKS, GRID_SHAPE, SERVE_GRID = 4, (2, 2), (1, 4)
GRID_TIMEOUT = 600

# phase 25: slice 6b over the port's launcher, four gloo ranks sharing the
# card and one NCCL rank. (a) the ring at config 2's full width (phase
# 10's ratings, phase 22's W0/H0, rank 64; six algorithms, one iteration
# in each order) and weighted MU at config 3's (phase 16's matrix and
# start, rank 128, alpha 40), each half against compute_sparse's scatter
# engine from the same (W, H): float32 sums of up to the longest row's or
# column's K terms in another order, 8 sqrt(K) 2^-24 (GRID_STEP_RTOL at
# least), a solved half (10 sqrt(r) + 8 sqrt(K)) kappa 2^-24 of its
# system. (b) dense V at the ML-20M shape (the ratings densified tile by
# tile on the card), float32 and int8, MU Frobenius, on 2 x 2 and on one
# NCCL rank: each half from (W0, H0) against the unsharded
# driver.compute's at DENSE_F32_RTOL (sums of up to 138,493 terms in
# another order) and
# DENSE_INT8_RTOL (int32 sums exact, only the Grams' order differs), the
# errors after DENSE_ITERS at DENSE_ERR_RTOL (requantization can flip);
# 4096^2 / rank 256 with the fused kernels on 4 x 1 and 1 x 4 and int8
# Jacobi on 2 x 2. (c) config 5's int8 table on 1 x 4 (2,621,440 items a
# rank), phase 18's cold users at b = FOLD_B: the Gram equal to the
# unsharded one, the fold-ins at FOLD_RTOL, the top-100's recall against
# the exact unsharded scan at RECALL_FLOOR. (d) MiniBatchNMF, KL, one
# epoch at config 2 on four item shards. (e) the surfaces on 2 x 2.
MESH_RANKS = 4
RING_KINDS = ("mu-frobenius", "mu-kl", "beta-1.5", "als", "gdcls", "nsnmf")
DENSE_F32_RTOL, DENSE_INT8_RTOL, DENSE_ERR_RTOL = 1e-4, 1e-5, 1e-3
DENSE_ITERS = 2
FOLD_B = 512
# the sharded fold-in against the unsharded one: the same Gram, history
# rows summed by index_add_ (atomics: float32 sums in another order), then
# the same solves and iterations
FOLD_RTOL = 1e-4
MESH_TIMEOUT = 900
# the kernels that phase 25 (b) must launch: #1-#5 and #6's entries
DENSE_KERNELS = ("w_update_fused", "h_update_fused", "w_update_fused_q",
                 "h_update_fused_q", "fused_multiply_divide", "vht_int8",
                 "wtv_int8", "dual_numerators_int8")

# phase 26: slice 16. (a) graft_entry.entry()'s step on the card against
# the same step on the CPU: float32 sums of 256 terms in another order
# (TF32 off), GRAFT_RTOL on W, H and the error. (b) ring iALS against
# compute_sparse's scatter engine with the same solver, one iteration
# from (W0, H0) on rows and columns drawn as phase 22 (b) draws them:
# each row within SOLVE_FACTOR sqrt(r) kappa_row 2^-24 (kappa_row its
# float64 system's), the H half plus kappa_row times W's difference; if
# cg's finite-precision steps amplify the engines' reordered Grams past
# that, each engine's cg rows are held against the same steps in float64
# on the row's own system: the ring's worst row within the limit or at
# most twice the scatter engine's (test_cg_row_solver_matches's rule for
# two float32 cg), and the script says which form held.
# (c) a ring and an ELL plan refuse a masked run: ValueError, no launch
GRAFT_RTOL = 1e-5
GRAFT_ITERS = 200
SLICE16_SOLVERS = ("exact", "cg")

# the card's peaks (NVIDIA's H100 SXM data sheet, dense): float32 on the
# CUDA cores, bf16 and int8 on the tensor cores, HBM bandwidth
F32_PEAK, BF16_PEAK, INT8_PEAK = 67e12, 989e12, 1979e12
TF32_PEAK = 495e12
HBM_BYTES_PER_S = 3.35e12

# where each kernel's TPU original is (file:line of the wrapper that
# reaches pl.pallas_call; "none" and what it replaces where there is no
# TPU kernel), and its source here
REPLACES = {
    "w_update_fused": "nmftpu/kernels/dense_mu.py:277",
    "h_update_fused": "nmftpu/kernels/dense_mu.py:188",
    "w_update_fused_q": "nmftpu/kernels/quantized.py:148",
    "h_update_fused_q": "nmftpu/kernels/quantized.py:70",
    "reservoir_scan": "nmftpu/kernels/mips_reservoir.py:135",
    "count_above": "nmftpu/kernels/count_above.py:95",
    "ell_rowsums": "nmftpu/kernels/sparse_ell_kernel.py:98",
    "ell_kl": "none (XLA gathers, nmftpu/sparse_ell.py:678)",
    "fused_multiply_divide": "nmftpu/kernels/dense_mu.py:341",
    "dual_numerators_int8": "nmftpu/kernels/dual_numer.py:128",
    "hals_sweep": "nmftpu/kernels/hals_sweep.py:121",
    # the one-sided int8 entries replace XLA contractions, not a TPU
    # kernel: the _rhs_vht_int8 / _rhs_wtv_int8 dots
    "vht_int8": "nmftpu/linalg/dense.py:334",
    "wtv_int8": "nmftpu/linalg/dense.py:344",
    # the per-row ridged solves replace XLA's batched Cholesky
    "row_solve": "none (XLA's batched Cholesky, nmftpu/linalg/dense.py "
                 "_batched_solve_clamped)",
    # every row's weighted Gram and right-hand side replace XLA's gathers
    # and einsums
    "ell_gram": "none (XLA gathers and einsums, nmftpu/sparse_ell.py:852 "
                "grams_and_rhs_ell)",
    # #11 under its CG rule replaces the per-row Grams that nmftpu's cg
    # solver forms before its steps
    "ell_cg": "none (XLA gathers and einsums, nmftpu/sparse_ell.py:852 "
              "grams_and_rhs_ell, then nmftpu/linalg/dense.py "
              "_batched_solve_clamped_cg)",
}
SOURCES = {
    "w_update_fused": "nmftpu_torch/csrc/dense_mu.cu",
    "h_update_fused": "nmftpu_torch/csrc/dense_mu.cu",
    "w_update_fused_q": "nmftpu_torch/csrc/dense_mu.cu",
    "h_update_fused_q": "nmftpu_torch/csrc/dense_mu.cu",
    "reservoir_scan": "nmftpu_torch/csrc/mips_reservoir.cu",
    "count_above": "nmftpu_torch/csrc/count_above.cu",
    "ell_rowsums": "nmftpu_torch/csrc/ell_rowsums.cu",
    "ell_kl": "nmftpu_torch/csrc/ell_rowsums.cu",
    "fused_multiply_divide": "nmftpu_torch/csrc/muldiv.cu",
    "dual_numerators_int8": "nmftpu_torch/csrc/dual_numer.cu",
    "hals_sweep": "nmftpu_torch/csrc/hals_sweep.cu",
    "vht_int8": "nmftpu_torch/csrc/dual_numer.cu",
    "wtv_int8": "nmftpu_torch/csrc/dual_numer.cu",
    "row_solve": "nmftpu_torch/csrc/row_solve.cu",
    "ell_gram": "nmftpu_torch/csrc/ell_gram.cu",
    "ell_cg": "nmftpu_torch/csrc/ell_rowsums.cu",
}
DENSE = ("w_update_fused", "h_update_fused", "w_update_fused_q",
         "h_update_fused_q")


# the kernels that must run on the tensor cores: (symbol fragment, how
# many instantiations); cuobjdump -sass must show wgmma (IGMMA/HGMMA) or
# mma.sync (IMMA/HMMA) instructions in each
TENSOR_CORE_KERNELS = (("int8_numer_kernel", 3), ("reservoir_tc_kernel", 4),
                       ("count_tc_kernel", 4), ("update_kernel", 8))
TC_OPCODE = re.compile(r"\b(IGMMA|HGMMA|IMMA|HMMA)\b")


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + "  ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_tool(name: str) -> str:
    for path in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if path and Path(path).exists():
            return path
    fail(f"{name} not found")


def sass_tensor_core_counts(lib_path) -> dict:
    """{kernel symbol (demangled): its count of tensor-core instructions}
    for every kernel in the built library, from cuobjdump -sass."""
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = 0
        elif name is not None:
            counts[name] += len(TC_OPCODE.findall(line))
    filt = shutil.which("c++filt") or shutil.which("cu++filt")
    if filt and counts:
        names = subprocess.run([filt], input="\n".join(counts),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        counts = dict(zip(names, counts.values()))
    return counts


def check_tensor_cores(lib_path) -> None:
    """Phase 2's SASS check: print each kernel's tensor-core instruction
    count; fail unless every instantiation of TENSOR_CORE_KERNELS has
    some."""
    counts = sass_tensor_core_counts(lib_path)
    for name, c in sorted(counts.items()):
        say("2 sass", kernel=name, tensor_core_instructions=c)
    for frag, want in TENSOR_CORE_KERNELS:
        found = {k: c for k, c in counts.items() if frag in k}
        if len(found) != want or min(found.values(), default=0) < 1:
            fail(f"{frag}: expected {want} kernels with tensor-core "
                 f"instructions, found {found}")


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, max |a - b| / |b|) over all elements. Where b is
    exactly 0 (an MU factor entry that reached zero), a must be 0 too."""
    diff = (a - b).abs()
    tiny = torch.finfo(b.dtype).tiny
    return float(diff.max()), float((diff / b.abs().clamp_min(tiny)).max())


def f64_check(phase: str, name: str, label: str, got, plain, exact,
              scaled=False) -> None:
    """The float64 check: fail unless the kernel's error against `exact`
    is at most F64_FACTOR times the plain twin's. Relative per element
    (rel_err), or with `scaled` over max|exact| (#7)."""
    if scaled:
        top = float(exact.abs().max())
        k = float((got.double() - exact).abs().max()) / top
        p = float((plain.double() - exact).abs().max()) / top
    else:
        k, p = rel_err(got.double(), exact)[1], rel_err(plain.double(),
                                                       exact)[1]
    say(f"{phase} float64", kernel=name, case=label, kernel_err=f"{k:.3e}",
        plain_f32_err=f"{p:.3e}", ratio=f"{k / p:.3f}" if p else "inf",
        limit=F64_FACTOR)
    if not k <= F64_FACTOR * p:
        fail(f"{name} {label}: error {k:.3e} against float64 exceeds "
             f"{F64_FACTOR}x the plain float32 twin's {p:.3e}")


def mu_exact(step: str, V, scale, W, H, G, eps=1e-9, rows=8192):
    """One MU half-step ("w" or "h") in float64 on V * scale (scale None:
    1), V's rows taken in chunks so that no float64 copy of V exists."""
    W64, H64, G64 = W.double(), H.double(), G.double()
    s = 1.0 if scale is None else float(scale)
    if step == "w":
        num = torch.cat([V[i:i + rows].double() @ H64.T
                         for i in range(0, V.shape[0], rows)]) * s
        return W64 * num / (W64 @ G64 + eps)
    num = torch.zeros_like(H64)
    for i in range(0, V.shape[0], rows):
        num += W64[i:i + rows].T @ V[i:i + rows].double()
    return H64 * (num * s) / (G64 @ H64 + eps)


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over `iters` calls, by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def abba_ms(fns: dict, iters: int) -> dict:
    """Time each callable twice, in the order A B C ... C B A, on one
    card, and return the mean of the two readings per name."""
    names = list(fns)
    times = {k: [] for k in names}
    for k in names + names[::-1]:
        times[k].append(cuda_ms(fns[k], iters))
    return {k: sum(v) / len(v) for k, v in times.items()}


def synthetic_lowrank(n, m, r, gen, dev):
    """Nonnegative rank-r V with 5% uniform noise, values about 0..5."""
    Wt = torch.rand(n, r, generator=gen, device=dev)
    Ht = torch.rand(r, m, generator=gen, device=dev)
    V = Wt @ Ht * (4.0 / r)
    V += 0.05 * V.mean() * torch.rand(n, m, generator=gen, device=dev)
    return V


def synthetic_ratings(n, m, nnz, gen, dev, rows_per_chunk=2048):
    """Dense (n, m) float32 matrix of half-star ratings (0.5 .. 5.0) with
    exactly `nnz` nonzeros, made on the device. Users rate at least 20
    items, with lognormal counts; items are picked without replacement
    with Zipf-like popularity (Efraimidis–Spirakis keys log(u) / w)."""
    w = torch.exp(torch.randn(n, generator=gen, device=dev))
    extra = nnz - 20 * n
    counts = 20 + torch.floor(extra * w / w.sum()).long()
    short = nnz - int(counts.sum())
    counts[torch.argsort(counts)[:short]] += 1
    if int(counts.sum()) != nnz or int(counts.max()) > m:
        raise RuntimeError("rating counts do not fit the shape")
    pop = 1.0 / torch.arange(1, m + 1, device=dev, dtype=torch.float32) ** 0.9
    pop = pop[torch.randperm(m, generator=gen, device=dev)]
    V = torch.zeros(n, m, device=dev)
    for i in range(0, n, rows_per_chunk):
        c = counts[i:i + rows_per_chunk]
        u = torch.rand(len(c), m, generator=gen, device=dev)
        keys = torch.log(u) / pop
        kmax = int(c.max())
        cols = torch.topk(keys, kmax, dim=1).indices
        del u, keys
        keep = torch.arange(kmax, device=dev)[None, :] < c[:, None]
        stars = torch.randint(1, 11, (len(c), kmax), generator=gen,
                              device=dev).float() * 0.5
        V[i:i + rows_per_chunk].scatter_(1, cols, stars * keep)
    return V


def distinct_items(n, gen, dev, m=SERVE_ITEMS):
    """(n, SERVE_SEEN) int32 numpy array of sorted distinct item ids per
    user, uniform over a catalog of m items: draw a few spare, drop
    repeats (they sort last as m), keep the first SERVE_SEEN."""
    items = torch.randint(0, m, (n, SERVE_SEEN + 8), generator=gen,
                          device=dev)
    items = torch.sort(items, dim=1).values
    items[:, 1:].masked_fill_(items[:, 1:] == items[:, :-1], m)
    items = torch.sort(items, dim=1).values[:, :SERVE_SEEN]
    if int(items.max()) >= m:
        raise RuntimeError("too many repeated draws for one user")
    return items.int().cpu().numpy()


def serving_data(gen, dev, chunk=1 << 20):
    """Config-5-shaped factors made on the device: W (n, r) uniform; H
    (r, m) uniform times per-dimension magnitudes from 1 down to 0.01
    (the spread the int8 table's per-dimension scales exist for); and
    the training CSR, SERVE_SEEN items per user drawn uniformly."""
    from nmftpu_torch.sparse import SparseCSR

    n, m, r = SERVE_USERS, SERVE_ITEMS, SERVE_RANK
    W = torch.rand(n, r, generator=gen, device=dev)
    mag = torch.logspace(0, -2, r, device=dev)[:, None]
    H = torch.empty(r, m, device=dev)
    for lo in range(0, m, chunk):
        H[:, lo:lo + chunk] = torch.rand(r, min(chunk, m - lo),
                                         generator=gen, device=dev) * mag
    items = distinct_items(n, gen, dev)
    indptr = np.arange(0, n * SERVE_SEEN + 1, SERVE_SEEN, dtype=np.int64)
    train = SparseCSR(indptr, items.reshape(-1),
                      np.ones(n * SERVE_SEEN, np.float32), (n, m))
    return W, H, train


def check_reservoir(MR, label, Wq, H, m, slots):
    """The reservoir kernel against its twin, slot by slot: scores within
    SCAN_RTOL; where the ids differ, the two competing items' float64
    scores (at the kernel's operand values) within SCAN_RTOL. Returns
    (max |score difference|, candidate scores of the twin, the kernel's
    candidates (scores, ids))."""
    before = dict(MR.VARIANT_LAUNCHES)
    s, i = MR.reservoir_scan(Wq, H, m, slots)
    ran = [k for k in before if MR.VARIANT_LAUNCHES[k] > before[k]]
    s0, i0 = MR.reservoir_scan_plain(Wq, H, m, slots)
    torch.cuda.synchronize()
    fin = torch.isfinite(s0)
    if not bool((fin == torch.isfinite(s)).all()):
        fail(f"reservoir_scan {label}: -inf slots differ from the twin")
    diff = (s - s0).abs()[fin]
    max_abs = float(diff.max()) if diff.numel() else 0.0
    rel = float((diff / s0.abs()[fin].clamp_min(1e-30)).max()) \
        if diff.numel() else 0.0
    q, c = ((i != i0) & fin).nonzero(as_tuple=True)
    qd = Wq.to(torch.bfloat16).double()[q]
    got = (qd * H[:, i[q, c].long()].double().T).sum(1)
    want = (qd * H[:, i0[q, c].long()].double().T).sum(1)
    far = int(((got - want).abs() > SCAN_RTOL * want.abs()).sum())
    say("7 reservoir_scan", case=label, kernels=ran, max_abs=f"{max_abs:.3e}",
        max_rel=f"{rel:.3e}", rtol=SCAN_RTOL,
        slots_with_other_id_at_near_tie=len(q) - far,
        slots_with_other_id_beyond_tol=far)
    if not rel <= SCAN_RTOL or far:
        fail(f"reservoir_scan {label}: kernel disagrees with its twin")
    return max_abs, s0, (s, i)


def tensor_core_error(Wq, H, h_scale, h_max, cand, rows=128) -> float:
    """The largest |tensor-core score - chain score| over the reservoir
    kernel's finite candidates `cand` (scores, ids), each row's in units
    of r 2^-23 ||q||_1 h_max (q the bf16 scan operand): the quantity the
    count kernel's band constant must bound. The chain is
    retrieval.mips._gather_scores."""
    from nmftpu_torch._operands import _scan_operands
    from nmftpu_torch.retrieval.mips import _gather_scores

    s, i = cand
    q = _scan_operands(Wq, H.dtype, h_scale)[0]
    unit = q.shape[1] * 2.0**-23 * q.double().abs().sum(1) * float(h_max)
    worst = 0.0
    for lo in range(0, s.shape[0], rows):
        hi = min(lo + rows, s.shape[0])
        chain = _gather_scores(Wq[lo:hi], H, i[lo:hi], h_scale)
        fin = torch.isfinite(s[lo:hi])
        err = ((s[lo:hi] - chain).abs().double() / unit[lo:hi, None])[fin]
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    return worst


def chain_count(Wq, H, theta, h_scale, block=1 << 17):
    """#{j : chain(q, j) > theta} per row, the count the certificate needs:
    a float32 matmul decides the pairs farther than SCAN_RTOL |theta| from
    a finite theta, and retrieval.mips._gather_scores (the k-ordered
    chain) re-scores the rest. Returns (counts (b,) int32, pairs
    re-scored)."""
    from nmftpu_torch._operands import _scan_operands
    from nmftpu_torch.retrieval.mips import _gather_scores

    q = _scan_operands(Wq, H.dtype, h_scale)[0]
    b, m = Wq.shape[0], H.shape[1]
    slack = torch.where(torch.isfinite(theta), SCAN_RTOL * theta.abs(),
                        torch.zeros_like(theta))[:, None]
    count = torch.zeros(b, dtype=torch.int64, device=H.device)
    rows, cols = [], []
    for lo in range(0, m, block):
        s = q @ H[:, lo:lo + block].float()
        near = (s - theta[:, None]).abs() <= slack
        count += ((s > theta[:, None]) & ~near).sum(1)
        rr, cc = near.nonzero(as_tuple=True)
        rows.append(rr)
        cols.append(cc + lo)
        del s, near
    rows, cols = torch.cat(rows), torch.cat(cols)
    for lo in range(0, rows.numel(), 1 << 20):
        rr, cc = rows[lo:lo + (1 << 20)], cols[lo:lo + (1 << 20)]
        sc = _gather_scores(Wq[rr], H, cc[:, None], h_scale)[:, 0]
        count.index_add_(0, rr, (sc > theta[rr]).long())
    return count.int(), rows.numel()


def check_count(CA, label, Wq, H, theta, h_scale, h_max=None,
                all_band=False) -> tuple[int, int]:
    """The count kernel against the exact chain count (`chain_count`):
    equal in every row. With `all_band`, every pair of a finite-theta row
    must have gone through the band. Returns (the largest count
    difference measured, the kernel's band pairs)."""
    before = CA.band_pairs()
    got = CA.count_above_fused(Wq, H, theta, h_scale=h_scale, h_max=h_max)
    band = CA.band_pairs() - before
    want, rescored = chain_count(Wq, H, theta, h_scale)
    torch.cuda.synchronize()
    d = int((got - want).abs().max())
    say("7 count_above", case=label, max_count_diff=d, band_pairs=band,
        reference_rescored_pairs=rescored,
        mean_count=f"{float(want.float().mean()):.2f}")
    if d != 0:
        fail(f"count_above {label}: kernel differs from the chain count")
    finite_rows = int(torch.isfinite(theta).sum())
    if all_band and band != finite_rows * H.shape[1]:
        fail(f"count_above {label}: {band} band pairs, expected every pair "
             f"({finite_rows * H.shape[1]})")
    return d, band


def check_zero_queries(CA, rec, Wq, theta, card) -> int:
    """A batch of config 5 whose queries 3, 130, 300 and 511 (one in each
    128-query block) are all zero, as a user with no factors is: they
    score exactly 0 on every item and their kth score, theta, is 0, so all
    m items tie it. The count must stay exact and those ties must not go
    through the band; the batch is timed beside the same batch without
    them. Returns the largest count difference."""
    zero = torch.tensor([3, 130, 300, 511], device=Wq.device)
    Wz, tz = Wq.clone(), theta.clone()
    Wz[zero], tz[zero] = 0.0, 0.0
    m = rec.H.shape[1]
    d, band = check_count(CA, f"zero queries b={Wq.shape[0]} m={m} int8",
                          Wz, rec.H, tz, rec._h_scale)
    ms = abba_ms({
        "zero_queries": lambda: CA.count_above_fused(
            Wz, rec.H, tz, h_scale=rec._h_scale),
        "no_zero_queries": lambda: CA.count_above_fused(
            Wq, rec.H, theta, h_scale=rec._h_scale)}, iters=3)
    say("7 count_above", case="zero queries timing", band_pairs=band,
        ms_with_zero_queries=f"{ms['zero_queries']:.3f}",
        ms_without=f"{ms['no_zero_queries']:.3f}", card=card)
    if band >= m:
        fail(f"count_above zero queries: {band} band pairs, so an all-zero "
             f"row's {m} ties went through the band")
    return d


def rows_not_exact(s, i, s_ex, i_ex, k):
    """Rows of (s, i) that are not the exact top-k (s_ex, i_ex hold the
    exact top k+1): the id set and the sorted scores must match, except
    that a row whose kth and (k+1)th exact scores tie within SCAN_RTOL
    may hold either item."""
    bad = 0
    for row in range(len(s)):
        ok = np.allclose(np.sort(s[row]), np.sort(s_ex[row, :k]),
                         rtol=SCAN_RTOL, atol=0)
        same = set(i[row].tolist()) == set(i_ex[row, :k].tolist())
        tie = abs(s_ex[row, k - 1] - s_ex[row, k]) \
            <= SCAN_RTOL * abs(s_ex[row, k - 1])
        bad += not (ok and (same or tie))
    return bad


def event_ms(fn, iters: int) -> float:
    """Mean ms per call by CUDA events, after one warm-up call. Each
    serving call ends in a device-to-host copy of its result."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def serve_table(MR, CA, td, rec, train, batches, card) -> None:
    """Phase 8 for one table: serve its batches (512 and 2048 users for
    int8, 512 for bf16), check recall, seen violations and the exact
    fallback against the exact scan, and time the serving paths."""
    exact = type(rec).from_table(
        rec.W, rec.H, h_scale=rec._h_scale, train=train,
        method="exact")
    for b in ((512, 2048) if td == "int8" else (512,)):
        users = batches[b]
        seen = [set(train.indices[train.indptr[u]:train.indptr[u + 1]]
                    .tolist()) for u in users]
        torch.cuda.reset_peak_memory_stats()
        before = (MR.LAUNCHES["reservoir_scan"],
                  CA.LAUNCHES["count_above"], CA.band_pairs())
        s_ex, i_ex = exact.recommend(users, k=SERVE_K + 1)
        s, i = rec.recommend(users, k=SERVE_K)
        recall = np.mean([
            len(set(i[row].tolist()) & set(i_ex[row, :SERVE_K]
                                           .tolist())) / SERVE_K
            for row in range(b)])
        violations = sum(len(set(i[row].tolist()) & seen[row])
                         for row in range(b))
        s_c, i_c, cert = rec.recommend_certified(users, k=SERVE_K,
                                                 fallback="exact")
        not_exact = rows_not_exact(s_c, i_c, s_ex, i_ex, SERVE_K)
        cert_violations = sum(len(set(i_c[row].tolist()) & seen[row])
                              for row in range(b))
        launched = (MR.LAUNCHES["reservoir_scan"] - before[0],
                    CA.LAUNCHES["count_above"] - before[1])
        band = CA.band_pairs() - before[2]
        finite = bool(np.isfinite(s).all() and np.isfinite(s_c).all())
        say("8 serve", table=td, batch=b, k=SERVE_K,
            recall_at_100=f"{recall:.6f}", seen_violations=violations,
            certified_fraction=f"{cert.mean():.6f}",
            rows_not_exact=not_exact,
            certified_seen_violations=cert_violations,
            finite=finite, launches=launched, count_band_pairs=band,
            band_pairs_per_query=f"{band / b:.4f}",
            peak_GiB=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")
        if not (recall >= RECALL_FLOOR and violations == 0
                and not_exact == 0 and cert_violations == 0 and finite):
            fail(f"serving {td} b={b}: recall {recall:.6f} (floor "
                 f"{RECALL_FLOOR}), {violations} + {cert_violations} "
                 f"seen violations, {not_exact} rows not exact")
        if min(launched) < 1:
            fail(f"serving {td} b={b}: kernels not launched {launched}")
        paths = {
            "reservoir": lambda: rec.recommend(users, k=SERVE_K),
            "reservoir_no_exclusion": lambda: rec.recommend(
                users, k=SERVE_K, exclude_seen=False),
            "certified": lambda: rec.recommend_certified(
                users, k=SERVE_K),
            "all_exact_composed": lambda: rec.recommend_certified(
                users, k=SERVE_K, fallback="exact"),
            "exact_scan": lambda: exact.recommend(users, k=SERVE_K),
        }
        for path, fn in paths.items():
            ms = event_ms(fn, iters=3)
            say("8 timing", table=td, batch=b, path=path,
                ms=f"{ms:.3f}", q_per_s=f"{b / ms * 1e3:.1f}", card=card)


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The least time the card could take for a kernel's work, in ms: the
    larger of its operations over `peak` and its bytes (each input read
    once, each output written once) over the HBM rate, and which of the
    two that is."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ratings_csr(R, rows_per_chunk=8192):
    """The nonzeros of a dense (n, m) device matrix as a host SparseCSR,
    row block by row block (nonzero() walks each block's rows in order,
    columns ascending)."""
    from nmftpu_torch.sparse import SparseCSR

    n, m = R.shape
    rows, cols, vals = [], [], []
    for i in range(0, n, rows_per_chunk):
        blk = R[i:i + rows_per_chunk]
        idx = blk.nonzero()
        rows.append((idx[:, 0] + i).cpu().numpy())
        cols.append(idx[:, 1].int().cpu().numpy())
        vals.append(blk[idx[:, 0], idx[:, 1]].cpu().numpy())
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(np.concatenate(rows), minlength=n),
              out=indptr[1:])
    return SparseCSR(indptr, np.concatenate(cols), np.concatenate(vals),
                     (n, m))


def ragged_csr(n, m, seed):
    """A small ratings CSR at 2% density with an empty row and a row of
    1,200 nonzeros (three segments of the widest bucket)."""
    from nmftpu_torch.sparse import from_dense

    rng = np.random.default_rng(seed)
    a = np.where(rng.random((n, m)) < 0.02,
                 rng.integers(1, 11, (n, m)) * 0.5, 0.0).astype(np.float32)
    a[0, rng.choice(m, 1200, replace=False)] = 2.5
    a[1] = 0.0
    return from_dense(a).to_csr()


def check_ell(SEK, label, buckets, table) -> float:
    """Kernel #10 against its twin on every bucket of one ELL direction:
    max relative error within ELL_RTOL. Returns max |difference|."""
    worst_abs = worst_rel = 0.0
    for b in buckets:
        got = SEK.bucket_rowsums(b.vals, b.cols, table)
        want = SEK.bucket_rowsums_plain(b.vals, b.cols, table)
        torch.cuda.synchronize()
        a, rel = rel_err(got, want)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, rel)
        del got, want
    say("10 ell_rowsums", case=label, dtype=str(table.dtype),
        widths=[b.width for b in buckets],
        segments=sum(b.vals.shape[0] for b in buckets),
        max_abs=f"{worst_abs:.3e}", max_rel=f"{worst_rel:.3e}",
        rtol=ELL_RTOL)
    if not worst_rel <= ELL_RTOL:
        fail(f"ell_rowsums {label}: kernel disagrees with its twin")
    return worst_abs


def check_ell_products(SEK, SE, label, pair, W, H) -> float:
    """The fused path (one launch per product, every bucket, sums added
    into the rows) against the plain ELL products in both directions:
    V Hᵀ (n, r) and Wᵀ V (r, m) within ELL_RTOL. Returns max |difference|.
    """
    worst = 0.0
    for direction, fused, plain in (
            ("V Ht", lambda: SEK.v_ht_ell_pallas(pair.rows, H),
             lambda: SE.v_ht_ell(pair.rows, H)),
            ("Wt V", lambda: SEK.wt_v_ell_pallas(pair, W),
             lambda: SE.wt_v_ell(pair, W))):
        before = SEK.LAUNCHES["ell_rowsums"]
        got = fused()
        launched = SEK.LAUNCHES["ell_rowsums"] - before
        want = plain()
        torch.cuda.synchronize()
        a, rel = rel_err(got, want)
        worst = max(worst, a)
        say("10 ell_spmm", case=label, product=direction,
            dtype=str(H.dtype), launches=launched, max_abs=f"{a:.3e}",
            max_rel=f"{rel:.3e}", rtol=ELL_RTOL)
        if not (rel <= ELL_RTOL and launched == 1):
            fail(f"ell_spmm {label} {direction}: fused path disagrees with "
                 f"the plain product or took {launched} launches")
        del got, want
    return worst


def check_ell_kl(SEK, label, ell, own, table) -> float:
    """Kernel #11 (one launch, every bucket) against its twin on one ELL
    direction: relative error within ELL_KL_RTOL (1e-12 in float64).
    Returns max |difference|."""
    from nmftpu_torch import sparse_ell as SE

    before = SEK.LAUNCHES["ell_kl"]
    got = SEK.ell_kl(ell, own, table)
    launched = SEK.LAUNCHES["ell_kl"] - before
    want = SE.kl_numerator_ell(ell, own, table)
    torch.cuda.synchronize()
    a, rel = rel_err(got, want)
    rtol = ELL_KL_RTOL if table.dtype == torch.float32 else 1e-12
    say("10 ell_kl", case=label, dtype=str(table.dtype), launches=launched,
        max_abs=f"{a:.3e}", max_rel=f"{rel:.3e}", rtol=rtol)
    if not (rel <= rtol and launched == 1):
        fail(f"ell_kl {label}: kernel disagrees with its twin or took "
             f"{launched} launches")
    return a


def sparse_phases(nt, ratings, card, dev) -> dict:
    """Phases 10-12 on the host CSR `ratings` (config 2's shape): kernel
    #10 against its twin, the sparse engines end to end through
    prepare_sparse / nmf, and their timing. Returns the ELL kernel's
    and #11's fields of the kernels line."""
    from nmftpu_torch import densified as DF
    from nmftpu_torch import sparse_ell as SE
    from nmftpu_torch.config import Initialization, NmfConfig, Objective
    from nmftpu_torch.kernels import sparse_ell_kernel as SEK
    from nmftpu_torch.linalg import dense as D

    n, m = ratings.shape
    nnz, r = ratings.nnz, SPARSE_RANK
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

    # -- 10. kernel #10 against its twin -----------------------------------
    max_abs = kl_abs = 0.0
    small = ragged_csr(1000, 1500, SEED + 10)
    for dtype in (torch.float32, torch.float64):
        pair = SE.build_ell_pair(small, dtype=dtype, device=dev)
        Ht = torch.rand(1500, 37, generator=gen, device=dev, dtype=dtype)
        Wt = torch.rand(1000, 37, generator=gen, device=dev, dtype=dtype)
        for label, ell, table in (("V Ht", pair.rows, Ht),
                                  ("Vt W", pair.cols, Wt)):
            max_abs = max(max_abs, check_ell(
                SEK, f"ragged 1000x1500 r=37 {label}", ell.buckets, table))
        max_abs = max(max_abs, check_ell_products(
            SEK, SE, "ragged 1000x1500 r=37", pair, Wt, Ht.T))
        for label, ell, own, table in (("W half", pair.rows, Wt, Ht),
                                       ("H half", pair.cols, Ht, Wt)):
            kl_abs = max(kl_abs, check_ell_kl(
                SEK, f"ragged 1000x1500 r=37 {label}", ell, own, table))
    cfg = NmfConfig(rank=r, init_method=Initialization.COPY_EXISTING,
                    num_iterations=SPARSE_ITERS, check_interval=SPARSE_CHECK)
    t0 = time.perf_counter()
    plan = nt.prepare_sparse(ratings, cfg, strategy="ell", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pair = plan.operand
    lanes = sum(b.vals.numel() for b in pair.rows.buckets)
    say("10 ell layout", shape=f"{n}x{m}", nnz=nnz,
        build_s=f"{build_s:.2f}",
        row_buckets=[(b.width, b.vals.shape[0]) for b in pair.rows.buckets],
        col_buckets=[(b.width, b.vals.shape[0]) for b in pair.cols.buckets],
        row_lanes_per_nnz=f"{lanes / nnz:.3f}")
    Ht = torch.rand(m, r, generator=gen, device=dev)
    Wt = torch.rand(n, r, generator=gen, device=dev)
    max_abs = max(max_abs, check_ell(
        SEK, f"ML-20M shape r={r} V Ht (table {m}x{r})", pair.rows.buckets,
        Ht))
    max_abs = max(max_abs, check_ell(
        SEK, f"ML-20M shape r={r} Vt W (table {n}x{r})", pair.cols.buckets,
        Wt))
    max_abs = max(max_abs, check_ell_products(
        SEK, SE, f"ML-20M shape r={r}", pair, Wt, Ht.T))
    for label, ell, own, table in (("W half", pair.rows, Wt, Ht),
                                   ("H half", pair.cols, Ht, Wt)):
        kl_abs = max(kl_abs, check_ell_kl(SEK, f"ML-20M shape r={r} {label}",
                                          ell, own, table))
    del Ht, Wt

    # -- 11. config 2 end to end (the third main path) ----------------------
    # W0/H0 drawn as the random init draws them: (u + 1e-4) sqrt(mean V / r)
    scale = (float(ratings.data.sum(dtype=np.float64)) / (n * m) / r) ** 0.5
    W0 = (torch.rand(n, r, generator=gen, device=dev) + 1e-4) * scale
    H0 = (torch.rand(r, m, generator=gen, device=dev) + 1e-4) * scale
    kl0 = float(SE.kl_error_ell(pair, W0, H0))
    common = dict(init="copy", W0=W0, H0=H0, num_iterations=SPARSE_ITERS,
                  check_interval=SPARSE_CHECK, device=dev)

    def run(label, fn, frobenius=True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        errs = res.stats.errors
        finite = bool(torch.isfinite(res.W).all()
                      and torch.isfinite(res.H).all())
        say("11 e2e", run=label, errors=[f"{e:.6g}" for e in errs],
            kl_error=res.kl_error, iterations=res.num_iterations,
            finite=finite, seconds=f"{secs:.3f}",
            loop_seconds=f"{res.elapsed_ms / 1e3:.3f}",
            peak_GiB=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
        # under KL the checked Frobenius error need not fall; D_KL is
        # checked below
        if not (finite and (errs[-1] < errs[0] or not frobenius)):
            fail(f"{label}: non-finite factors or the error did not fall: "
                 f"{errs.tolist()}")
        return res

    SEK.LAUNCHES["ell_rowsums"] = 0          # the main path starts here
    SEK.LAUNCHES["ell_kl"] = 0
    res_k = run("nmf ell use_pallas=True frobenius", lambda: nt.nmf(
        ratings, r, strategy="ell", use_pallas=True, **common))
    res_p = run("plan.run ell frobenius", lambda: plan.run(W0=W0, H0=H0))
    cfg_kl = NmfConfig(rank=r, objective=Objective.KL,
                       init_method=Initialization.COPY_EXISTING,
                       num_iterations=SPARSE_ITERS,
                       check_interval=SPARSE_CHECK)
    t0 = time.perf_counter()
    plan_kl = nt.prepare_sparse(ratings, cfg_kl, strategy="auto",
                                device=dev)
    torch.cuda.synchronize()
    say("11 auto", objective="kl", resolved=plan_kl.strategy,
        densify_s=f"{time.perf_counter() - t0:.2f}")
    if plan_kl.strategy != "densified":
        fail(f"strategy='auto' resolved to {plan_kl.strategy!r} at the "
             "ML-20M shape, not 'densified'")
    res_dk = run("plan.run auto (densified bf16) kl",
                 lambda: plan_kl.run(W0=W0, H0=H0), frobenius=False)
    res_ek = run("plan.run ell kl", lambda: plan.run(cfg_kl, W0=W0, H0=H0),
                 frobenius=False)
    launches = SEK.LAUNCHES["ell_rowsums"]   # the main path ends here
    kl_launches = SEK.LAUNCHES["ell_kl"]
    dw = float((res_k.W - res_p.W).abs().max() / res_p.W.abs().max())
    dh = float((res_k.H - res_p.H).abs().max() / res_p.H.abs().max())
    dkl = abs(res_ek.kl_error - res_dk.kl_error) / res_dk.kl_error
    # the two KL engines' factors, for the record (no limit: densified
    # rounds W and H to bf16 in each contraction)
    dw_kl = float((res_ek.W - res_dk.W).abs().max() / res_dk.W.abs().max())
    say("11 checks", ell_rowsums_launches_one_per_product=launches,
        ell_kl_launches=kl_launches,
        ell_kl_iterations=res_ek.num_iterations,
        kernel_vs_plain_W=
        f"{dw:.3e}", kernel_vs_plain_H=f"{dh:.3e}", rtol=SPARSE_E2E_RTOL,
        kl_start=f"{kl0:.6g}", kl_ell=f"{res_ek.kl_error:.6g}",
        kl_densified=f"{res_dk.kl_error:.6g}", kl_rel=f"{dkl:.3e}",
        kl_rtol=KL_ENGINES_RTOL, kl_engines_W_rel=f"{dw_kl:.3e}")
    if launches < 1:
        fail("the ELL kernel was not launched on the main path")
    if kl_launches != 2 * res_ek.num_iterations:
        fail(f"the ELL KL run took {kl_launches} launches of #11 for "
             f"{res_ek.num_iterations} iterations, not two an iteration")
    if not (dw <= SPARSE_E2E_RTOL and dh <= SPARSE_E2E_RTOL):
        fail(f"ELL kernel run differs from the plain ELL run (W {dw:.3e}, "
             f"H {dh:.3e} > {SPARSE_E2E_RTOL})")
    if not (res_ek.kl_error < kl0 and res_dk.kl_error < kl0
            and dkl <= KL_ENGINES_RTOL):
        fail(f"KL did not fall or the engines disagree: start {kl0}, ell "
             f"{res_ek.kl_error}, densified {res_dk.kl_error}")
    del res_k, res_p, res_dk, res_ek

    # the densified Frobenius step's transient memory with the row-panel
    # bf16 contraction, and with the contraction as it was before (one
    # float32 copy of each whole operand)
    Vd = plan_kl.operand
    Wp = torch.nn.functional.pad(W0, (0, 0, 0, Vd.shape[0] - n))
    panels = D._bf16_dot

    def whole(a, b, block_rows=None):
        return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()

    for label, dot in (("row panels", panels), ("whole operands", whole)):
        D._bf16_dot = dot
        try:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            D.mu_update_frobenius_bf16v(Vd, Wp, H0)
            torch.cuda.synchronize()
        finally:
            D._bf16_dot = panels
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        say("11 densified frobenius step", bf16_contraction=label,
            transient_GiB=f"{peak:.2f}", card=card)

    # -- 12. timing at config 2's shape --------------------------------------
    it_ms = abba_ms({
        "ell_plain_frobenius": lambda: SE.mu_update_frobenius_ell(
            pair, W0, H0),
        "ell_kernel_frobenius": lambda: SEK.mu_update_frobenius_ell_pallas(
            pair, W0, H0),
        "densified_frobenius": lambda: D.mu_update_frobenius_bf16v(
            Vd, Wp, H0),
        "ell_kl": lambda: SE.mu_update_kl_ell(pair, W0, H0),
        "ell_kernel_kl": lambda: SE.mu_update_kl_ell(
            pair, W0, H0, numerator=SEK.ell_kl),
        "densified_kl": lambda: DF.mu_update_kl_densified(Vd, Wp, H0),
    }, iters=3)
    for path, ms in it_ms.items():
        say("12 timing", path=path, ms_per_iter=f"{ms:.3f}", card=card)
    Ht0 = H0.T.contiguous()
    # cuSPARSE through torch.sparse.mm, on V and on Vᵀ as CSR: the library
    # yardsticks, timed here and called nowhere in the port (torch warns
    # that its sparse CSR support is in beta)
    def device_csr(csr):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(
                torch.from_numpy(csr.indptr).to(dev),
                torch.from_numpy(csr.indices.astype(np.int64)).to(dev),
                torch.from_numpy(csr.data).to(dev), size=csr.shape,
                check_invariants=True)

    Vcsr, VTcsr = device_csr(ratings), device_csr(ratings.T.to_csr())
    _, lib_rel = rel_err(torch.sparse.mm(Vcsr, Ht0),
                         SEK.v_ht_ell_pallas(pair.rows, H0))
    _, lib_rel_wtv = rel_err(torch.sparse.mm(VTcsr, W0),
                             SEK.wt_v_ell_pallas(pair, W0).T)
    out_vht = torch.zeros(n, r, device=dev)
    out_wtv = torch.zeros(m, r, device=dev)
    sp_ms = abba_ms({
        "kernel_path": lambda: SEK.v_ht_ell_pallas(pair.rows, H0),
        "kernel_only": lambda: SEK.ell_spmm(pair.rows.buckets, Ht0,
                                            out_vht.zero_()),
        "plain_path": lambda: SE.v_ht_ell(pair.rows, H0),
        "torch_sparse_mm": lambda: torch.sparse.mm(Vcsr, Ht0),
        "kernel_path_WtV": lambda: SEK.wt_v_ell_pallas(pair, W0),
        "kernel_only_WtV": lambda: SEK.ell_spmm(pair.cols.buckets, W0,
                                                out_wtv.zero_()),
        "plain_path_WtV": lambda: SE.wt_v_ell(pair, W0),
        "torch_sparse_mm_WtV": lambda: torch.sparse.mm(VTcsr, W0),
    }, iters=5)
    # one V Ht SpMM needs each nonzero's value and column once, the table
    # and the output: counted over the nonzeros, not the padded lanes
    flops = 2 * nnz * r
    nbytes = nnz * (4 + 4) + (m + n) * r * 4
    bound_ms, bound_by = bound(flops, nbytes, F32_PEAK)
    for path, ms in sp_ms.items():
        say("12 spmm timing", path=path, ms=f"{ms:.4f}",
            GB_s_of_needed_bytes=f"{nbytes / ms / 1e6:.1f}", card=card)
    say("12 spmm bound", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        gathered_row_GB=f"{nnz * r * 4 / 1e9:.2f}",
        library_vs_kernel_path_max_rel=f"{lib_rel:.3e}",
        library_vs_kernel_path_WtV_max_rel=f"{lib_rel_wtv:.3e}", card=card)
    if not (lib_rel <= 1e-4 and lib_rel_wtv <= 1e-4):
        fail(f"torch.sparse.mm and the kernel path disagree ({lib_rel:.3e}, "
             f"{lib_rel_wtv:.3e})")
    del Vcsr, VTcsr, out_vht, out_wtv
    # #11, each half alone (its operands row-major, as the step passes
    # them) and through its twin
    Hrows = H0.T.contiguous()
    kl_ms = abba_ms({
        "kernel_W": lambda: SEK.ell_kl(pair.rows, W0, Ht0),
        "plain_W": lambda: SE.kl_numerator_ell(pair.rows, W0, Ht0),
        "kernel_H": lambda: SEK.ell_kl(pair.cols, Hrows, W0),
        "plain_H": lambda: SE.kl_numerator_ell(pair.cols, Hrows, W0),
    }, iters=5)
    # a half-step samples and sums at every nonzero (4·nnz·r) and reads
    # each value and column once, both factors and the output once
    kl_bound_ms, kl_bound_by = bound(4 * nnz * r,
                                     nnz * (4 + 4) + (2 * n + m) * r * 4,
                                     F32_PEAK)
    for path, ms in kl_ms.items():
        say("12 ell_kl timing", path=path, ms=f"{ms:.4f}",
            bound_ms=f"{kl_bound_ms:.4f}", bound_by=kl_bound_by, card=card)
    return {"launches": launches, "max_abs_err": max_abs,
            "ms": sp_ms["kernel_path"], "plain_ms": sp_ms["plain_path"],
            "library_ms": sp_ms["torch_sparse_mm"], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "kl": {"launches": kl_launches, "max_abs_err": kl_abs,
                   "ms": kl_ms["kernel_W"], "plain_ms": kl_ms["plain_W"],
                   "bound_ms": kl_bound_ms, "bound_by": kl_bound_by}}


def check_hals(HS, label, n, r, gen, dev, zero_col=None) -> float:
    """Kernel #7 against its twin (the blocked sweep) on a random
    problem: |difference| <= HALS_ATOL * max|twin|; a zero-hessian
    column stays as it was. Returns max |difference|."""
    X = torch.randn(n, r, generator=gen, device=dev)
    A = torch.randn(r, r, generator=gen, device=dev)
    G = A @ A.T + torch.eye(r, device=dev)
    if zero_col is not None:
        G[zero_col, :] = 0.0
        G[:, zero_col] = 0.0
    W = torch.rand(n, r, generator=gen, device=dev)
    got = HS.hals_sweep(X, G, W)
    want = HS.hals_sweep_plain(X, G, W)
    exact = HS.hals_sweep_plain(X.double(), G.double(), W.double())
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    kept = (zero_col is None
            or bool(torch.equal(got[:, zero_col], W[:, zero_col])))
    say("13 hals_sweep", case=label, max_abs=f"{diff:.3e}",
        rel_to_max=f"{diff / scale:.3e}", bound=HALS_ATOL,
        zero_hessian_column_kept=kept)
    if not (diff <= HALS_ATOL * scale and kept):
        fail(f"hals_sweep {label}: kernel disagrees with its twin")
    f64_check("13", "hals_sweep", label, got, want, exact, scaled=True)
    return diff


def check_int8(DN, label, Vq, WqT, Hq) -> None:
    """Kernel #6 (dual entry, both outputs) and the one-sided entries
    against the exact float64 products: equal, and every sum inside the
    int32 range, so that "equal" needs no wrap-around."""
    exact_w, exact_h = DN.vht_exact(Vq, Hq), DN.wtv_exact(Vq, WqT)
    peak = max(float(exact_w.abs().max()), float(exact_h.abs().max()))
    want_w, want_h = DN._wrap_int32(exact_w), DN._wrap_int32(exact_h)
    del exact_w, exact_h
    nw, nh = DN.dual_int8(Vq, WqT, Hq)
    vht, wtv = DN.vht_int8(Vq, Hq), DN.wtv_int8(Vq, WqT)
    torch.cuda.synchronize()
    same = {"dual_nw": torch.equal(nw, want_w),
            "dual_nh": torch.equal(nh, want_h),
            "vht": torch.equal(vht, want_w), "wtv": torch.equal(wtv, want_h)}
    say("13 int8 numerators", case=label, equal=same,
        max_abs_sum=f"{peak:.6g}", int32_limit=2**31 - 1)
    if peak >= 2**31:
        fail(f"int8 numerators {label}: a sum leaves the int32 range")
    if not all(same.values()):
        fail(f"int8 numerators {label}: a kernel differs from the exact "
             f"product: {same}")


def slice4a_phases(nt, card, dev, V, W0, H0, Vq, scale, plain_ms) -> dict:
    """Phases 13-15: kernels #5-#7 against their twins, dense HALS end to
    end, Jacobi and int8 x int8 MU end to end. V, W0, H0, Vq, scale are
    phase 4's 4096^2 / r = 256 problem; plain_ms is phase 6's plain
    float32 ms per MU iteration. Returns the kernels line's fields of
    the five kernel entries."""
    from nmftpu_torch.kernels import dense_mu as K
    from nmftpu_torch.kernels import dual_numer as DN
    from nmftpu_torch.kernels import hals_sweep as HS
    from nmftpu_torch.kernels import quantized as Q
    from nmftpu_torch.linalg import dense as D

    n, m = V.shape
    r = W0.shape[1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    n5, m5, r5, nnz = ML20M
    t0 = time.perf_counter()
    R = synthetic_ratings(n5, m5, nnz, torch.Generator(device=dev)
                          .manual_seed(SEED + 5), dev)
    torch.cuda.synchronize()
    say("13 data", shape=f"{n5}x{m5}", nnz=int(torch.count_nonzero(R)),
        make_V_s=f"{time.perf_counter() - t0:.2f}")
    Vq5, scale5 = Q.quantize_v(R)

    # -- 13. kernels #5, #6, #7 against their plain versions ----------------
    max_abs = {"hals_sweep": 0.0}
    for label, (hn, hr), zero in (("4096x256", (4096, 256), None),
                                  ("2048x512", (2048, 512), None),
                                  ("138493x64", (n5, r5), None),
                                  ("ragged 1000x37, hessian 0 at 5",
                                   (1000, 37), 5)):
        max_abs["hals_sweep"] = max(max_abs["hals_sweep"], check_hals(
            HS, label, hn, hr, gen, dev, zero))
    W5 = torch.rand(n5, r5, generator=gen, device=dev)
    H5 = torch.rand(r5, m5, generator=gen, device=dev)
    ragged = Q.quantize_v(5.0 * torch.rand(1000, 1500, generator=gen,
                                           device=dev))[0]
    for label, Vqc, Wc, Hc in (
            ("4096^2 r=256", Vq, W0, H0),
            ("ML-20M shape r=64", Vq5, W5, H5),
            ("ragged 1000x1500 r=37", ragged,
             torch.rand(1000, 37, generator=gen, device=dev),
             torch.rand(37, 1500, generator=gen, device=dev))):
        check_int8(DN, label, Vqc, D.quantize_sym_t(Wc)[1],
                   D.quantize_sym(Hc)[1])
    # #6 at the ML-20M shape, where reading V (3.70 GB) once pays: the
    # kernels, the float64 twins, and torch._int_mm (timed only) for V Hqᵀ
    # and for Wqᵀ V, whose contraction n = 138,493 is not a multiple of 8,
    # which _int_mm needs: there V and Wqᵀ get zero rows (columns) up to
    # n = 138,496, the copies made outside the timing, and _int_mm takes
    # Vᵀ (m, n) row-major and Wq (n, r) column-major, as at 4096^2
    WqT5, Hq5 = D.quantize_sym_t(W5)[1], D.quantize_sym(H5)[1]
    del W5, H5, ragged
    pad8 = -n5 % 8
    VqT5p = torch.nn.functional.pad(Vq5, (0, 0, 0, pad8)).T.contiguous()
    WqT5p = torch.nn.functional.pad(WqT5, (0, pad8))
    ml_ms = abba_ms({
        "dual_numerators_int8": lambda: DN.dual_int8(Vq5, WqT5, Hq5),
        "dual_numerators_int8_plain": lambda: DN.dual_int8_plain(
            Vq5, WqT5, Hq5),
        "vht_int8": lambda: DN.vht_int8(Vq5, Hq5),
        "vht_int8_plain": lambda: DN.vht_int8_plain(Vq5, Hq5),
        "vht_int8_library": lambda: torch._int_mm(Vq5, Hq5.t()),
        "wtv_int8": lambda: DN.wtv_int8(Vq5, WqT5),
        "wtv_int8_plain": lambda: DN.wtv_int8_plain(Vq5, WqT5),
        "wtv_int8_library": lambda: torch._int_mm(VqT5p, WqT5p.t()),
    }, iters=3)
    del VqT5p, WqT5p
    ml_ms["dual_numerators_int8_library"] = (ml_ms["vht_int8_library"]
                                             + ml_ms["wtv_int8_library"])
    ml_bounds = {
        "dual_numerators_int8": bound(4 * n5 * m5 * r5,
                                      n5 * m5 + 5 * r5 * (n5 + m5),
                                      INT8_PEAK),
        "vht_int8": bound(2 * n5 * m5 * r5, n5 * m5 + r5 * m5 + 4 * n5 * r5,
                          INT8_PEAK),
        "wtv_int8": bound(2 * n5 * m5 * r5, n5 * m5 + n5 * r5 + 4 * r5 * m5,
                          INT8_PEAK),
    }
    for name, (b_ms, b_by) in ml_bounds.items():
        say("13 kernel timing", kernel=name, shape=f"{n5}x{m5} r={r5}",
            ms=f"{ml_ms[name]:.4f}", plain_ms=f"{ml_ms[name + '_plain']:.4f}",
            library_ms=f"{ml_ms[name + '_library']:.4f}",
            **({"library": f"_int_mm, n padded to {n5 + pad8}"}
               if name != "vht_int8" else {}),
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, card=card)
    del WqT5, Hq5
    for label, shape in (("4096x4096", (4096, 4096)),
                         ("ragged 1000x37", (1000, 37))):
        x, y, z = (torch.rand(*shape, generator=gen, device=dev)
                   for _ in range(3))
        same = torch.equal(K.fused_multiply_divide(x, y, z),
                           K.fused_multiply_divide_plain(x, y, z))
        say("13 fused_multiply_divide", case=label, bit_equal=same)
        if not same:
            fail(f"fused_multiply_divide {label}: kernel differs from its "
                 "twin")
    # timing at the main path's 4096^2 / r = 256 shapes
    WqT, Hq = D.quantize_sym_t(W0)[1], D.quantize_sym(H0)[1]
    XHt, G = V @ H0.T, H0 @ H0.T
    x, y, z = (torch.rand(n, m, generator=gen, device=dev) for _ in range(3))
    # the library yardstick for #6: cuBLASLt's int8 GEMM through
    # torch._int_mm, in the operand layouts it takes (B column-major),
    # which costs Vq's transpose, made here once
    VqT = Vq.t().contiguous()
    lib_w, lib_ht = torch._int_mm(Vq, Hq.t()), torch._int_mm(VqT, WqT.t())
    nw, nh = DN.dual_int8(Vq, WqT, Hq)
    lib_same = bool(torch.equal(lib_w, nw) and torch.equal(lib_ht.t(), nh))
    del lib_w, lib_ht, nw, nh
    t_ms = abba_ms({
        "hals_sweep": lambda: HS.hals_sweep(XHt, G, W0),
        "hals_sweep_plain": lambda: HS.hals_sweep_plain(XHt, G, W0),
        "dual_numerators_int8": lambda: DN.dual_int8(Vq, WqT, Hq),
        "dual_numerators_int8_plain": lambda: DN.dual_int8_plain(Vq, WqT,
                                                                 Hq),
        "dual_numerators_int8_library": lambda: (
            torch._int_mm(Vq, Hq.t()), torch._int_mm(VqT, WqT.t())),
        "vht_int8": lambda: DN.vht_int8(Vq, Hq),
        "vht_int8_plain": lambda: DN.vht_int8_plain(Vq, Hq),
        "vht_int8_library": lambda: torch._int_mm(Vq, Hq.t()),
        "wtv_int8": lambda: DN.wtv_int8(Vq, WqT),
        "wtv_int8_plain": lambda: DN.wtv_int8_plain(Vq, WqT),
        "wtv_int8_library": lambda: torch._int_mm(VqT, WqT.t()),
        "fused_multiply_divide": lambda: K.fused_multiply_divide(x, y, z),
        "fused_multiply_divide_plain": lambda: K.fused_multiply_divide_plain(
            x, y, z),
    }, iters=10)
    del VqT, WqT
    # bounds: each input read once, each output written once; #7 on the
    # float32 CUDA cores, #6 and its one-sided entries on the int8 tensor
    # cores' rate, #5 by its bytes
    b = 16
    bounds = {
        "hals_sweep": bound(2 * n * r * r + 2 * n * r * b,
                            4 * (3 * n * r + r * r), F32_PEAK),
        "dual_numerators_int8": bound(4 * n * m * r,
                                      n * m + n * r + r * m
                                      + 4 * (n * r + r * m), INT8_PEAK),
        "vht_int8": bound(2 * n * m * r, n * m + r * m + 4 * n * r,
                          INT8_PEAK),
        "wtv_int8": bound(2 * n * m * r, n * m + n * r + 4 * r * m,
                          INT8_PEAK),
        "fused_multiply_divide": bound(2 * n * m, 4 * 4 * n * m, F32_PEAK),
    }
    library = {"dual_numerators_int8": t_ms["dual_numerators_int8_library"],
               "vht_int8": t_ms["vht_int8_library"],
               "wtv_int8": t_ms["wtv_int8_library"],
               "hals_sweep": None, "fused_multiply_divide": None}
    for name, (b_ms, b_by) in bounds.items():
        say("13 kernel timing", kernel=name, shape=f"{n}x{m} r={r}",
            ms=f"{t_ms[name]:.4f}", plain_ms=f"{t_ms[name + '_plain']:.4f}",
            library_ms=(None if library[name] is None
                        else f"{library[name]:.4f}"),
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, card=card)
    say("13 library", torch_int_mm_equals_kernel=lib_same)
    if not lib_same:
        fail("torch._int_mm and the int8 kernels disagree")

    # -- 14. dense HALS end to end (the fourth main path) --------------------
    # -- 15. Jacobi and int8 x int8 MU end to end (the fifth) ----------------
    for counts in (HS.LAUNCHES, DN.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    K.LAUNCHES["fused_multiply_divide"] = 0
    common = dict(init="copy", W0=W0, H0=H0, num_iterations=50,
                  check_interval=10, device="cuda")

    def run(phase, label, V_in, rank, check=True, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = nt.nmf(V_in, rank, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        errs = res.stats.errors
        finite = bool(torch.isfinite(res.W).all()
                      and torch.isfinite(res.H).all())
        say(phase, run=label, iterations=res.num_iterations,
            first_error=f"{errs[0]:.6g}", last_error=f"{errs[-1]:.6g}",
            kl_error=res.kl_error, finite=finite, seconds=f"{secs:.3f}")
        if not finite or (check and not errs[-1] < errs[0]):
            fail(f"{label}: non-finite factors or the error did not fall: "
                 f"{errs.tolist()}")
        return res

    before = HS.LAUNCHES["hals_sweep"]
    hals = run("14 hals e2e", "4096^2 r=256 hals", V, r, algorithm="hals",
               **common)
    hals_launches = HS.LAUNCHES["hals_sweep"] - before
    mu = run("14 hals e2e", "4096^2 r=256 mu (plain f32)", V, r, **common)
    # one iteration, then the same 50, through the plain blocked sweep;
    # the kernel's two launches here compare, and stay out of the count
    one_k = D.hals_update(V, W0, H0)
    HS.LAUNCHES["hals_sweep"] -= 2
    Wp, Hp = D.hals_update(V, W0, H0, impl="blocked")
    dw = float((one_k[0] - Wp).abs().max() / Wp.abs().max())
    dh = float((one_k[1] - Hp).abs().max() / Hp.abs().max())
    for _ in range(49):
        Wp, Hp = D.hals_update(V, Wp, Hp, impl="blocked")
    e_plain = float(D.frobenius_error(V, Wp, Hp))
    de = abs(hals.frobenius_error / e_plain - 1)
    # the factors after 50 iterations, for the record (no limit: see
    # HALS_STEP_RTOL)
    dw50 = float((hals.W - Wp).abs().max() / Wp.abs().max())
    dh50 = float((hals.H - Hp).abs().max() / Hp.abs().max())
    say("14 checks", cell="4096^2 r=256", hals_sweep_launches=hals_launches,
        expected=100, one_iteration_kernel_vs_plain_W=f"{dw:.3e}",
        one_iteration_kernel_vs_plain_H=f"{dh:.3e}", rtol=HALS_STEP_RTOL,
        after_50_W=f"{dw50:.3e}", after_50_H=f"{dh50:.3e}",
        hals_error=f"{hals.frobenius_error:.6g}",
        plain_sweep_error=f"{e_plain:.6g}", error_rel=f"{de:.3e}",
        error_rtol=HALS_E2E_RTOL, mu_error=f"{mu.frobenius_error:.6g}")
    if hals_launches != 100:
        fail(f"hals_sweep launched {hals_launches} times, not 100")
    if not (dw <= HALS_STEP_RTOL and dh <= HALS_STEP_RTOL):
        fail(f"one HALS iteration through the kernel differs from the plain "
             f"sweep (W {dw:.3e}, H {dh:.3e} > {HALS_STEP_RTOL})")
    if not de <= HALS_E2E_RTOL:
        fail(f"50 HALS iterations through the kernel end {de:.3e} from the "
             f"plain sweep's error (> {HALS_E2E_RTOL})")
    del one_k
    if not hals.frobenius_error <= mu.frobenius_error * 1.001:
        fail("HALS ends above MU at equal iterations")
    del hals, mu, Wp, Hp
    V2 = synthetic_lowrank(2048, 2048, 512, gen, dev)
    for label, V_in, rank, kw in (
            ("2048^2 r=512", V2, 512, dict(init="random", seed=0)),
            ("ML-20M shape r=64 (float32 V)", R, r5,
             dict(init="random", seed=0))):
        before = HS.LAUNCHES["hals_sweep"]
        h = run("14 hals e2e", f"{label} hals", V_in, rank,
                algorithm="hals", num_iterations=10, check_interval=2,
                **kw)
        launched = HS.LAUNCHES["hals_sweep"] - before
        u = run("14 hals e2e", f"{label} mu (plain f32)", V_in, rank,
                num_iterations=10, check_interval=2, **kw)
        say("14 checks", cell=label, hals_sweep_launches=launched,
            expected=20, hals_error=f"{h.frobenius_error:.6g}",
            mu_error=f"{u.frobenius_error:.6g}")
        if launched != 20:
            fail(f"{label}: hals_sweep launched {launched} times, not 20")
        if not h.frobenius_error <= u.frobenius_error * 1.001:
            fail(f"{label}: HALS ends above MU at equal iterations")
        del h, u
    del V2

    # -- 15. Jacobi and int8 x int8 MU at 4096^2 / r = 256 -------------------
    pairs = {
        "float32 frobenius": dict(),
        "float32 kl": dict(objective="kl"),
        "bfloat16 frobenius": dict(v_storage="bfloat16"),
        "int8 frobenius": dict(v_storage="int8"),
        "int8 frobenius use_pallas": dict(v_storage="int8", use_pallas=True),
    }
    finals = {}
    for label, knobs in pairs.items():
        for style in ("gauss-seidel", "jacobi"):
            before = dict(DN.LAUNCHES)
            res = run("15 mu e2e", f"{label} {style}", V, r,
                      check=knobs.get("objective") != "kl",
                      mu_style=style, **common, **knobs)
            finals[label, style] = (res.kl_error if "kl" in label
                                    else res.frobenius_error)
            launched = {k: DN.LAUNCHES[k] - before[k] for k in DN.LAUNCHES}
            want = dict.fromkeys(DN.LAUNCHES, 0)
            if label == "int8 frobenius":
                want.update(vht_int8=50, wtv_int8=50)
            elif label == "int8 frobenius use_pallas" and style == "jacobi":
                want["dual_numerators_int8"] = 50
            say("15 launches", run=f"{label} {style}", launches=launched)
            if launched != want:
                fail(f"{label} {style}: int8 kernel launches {launched}, "
                     f"expected {want}")
            del res
        ratio = finals[label, "jacobi"] / finals[label, "gauss-seidel"]
        say("15 checks", run=label, jacobi_over_gauss_seidel=f"{ratio:.4f}",
            limit=1.10)
        if not ratio <= 1.10:
            fail(f"{label}: jacobi ends {ratio:.4f}x above Gauss-Seidel")
    gs_rel = abs(finals["int8 frobenius", "gauss-seidel"]
                 / finals["int8 frobenius use_pallas", "gauss-seidel"] - 1)
    say("15 checks", int8_x_int8_vs_int8_kernels_3_4=f"{gs_rel:.3e}",
        rtol=1e-3)
    if not gs_rel <= 1e-3:
        fail(f"int8 x int8 and the int8 kernels #3/#4 end {gs_rel:.3e} "
             "apart")
    before = DN.LAUNCHES["dual_numerators_int8"]
    run("15 mu e2e", "ML-20M shape r=64 int8 jacobi use_pallas", R, r5,
        init="random", seed=0, num_iterations=10, check_interval=2,
        v_storage="int8", use_pallas=True, mu_style="jacobi")
    launched = DN.LAUNCHES["dual_numerators_int8"] - before
    say("15 checks", cell="ML-20M shape", dual_launches=launched, expected=10)
    if launched != 10:
        fail(f"ML-20M shape: dual kernel launched {launched} times, not 10")
    # the main paths end here (fused_multiply_divide has no caller on them)
    launches = {**HS.LAUNCHES, **DN.LAUNCHES,
                "fused_multiply_divide": K.LAUNCHES["fused_multiply_divide"]}
    del R, Vq5, scale5

    # ms per iteration at 4096^2 / r = 256, beside phase 6's plain f32 MU
    it_ms = abba_ms({
        "hals (kernel #7)": lambda: D.hals_update(V, W0, H0),
        "mu jacobi f32": lambda: D.mu_update_frobenius(V, W0, H0,
                                                       order="jacobi"),
        "mu jacobi bf16": lambda: D.mu_update_frobenius_bf16v(
            V.to(torch.bfloat16), W0, H0, order="jacobi"),
        "mu jacobi int8 (one-sided #6)": lambda: (
            D.mu_update_frobenius_int8x8(Vq, scale, W0, H0, order="jacobi")),
        "mu jacobi int8 use_pallas (dual #6)": lambda: (
            D.mu_update_frobenius_int8x8(Vq, scale, W0, H0, order="jacobi",
                                         use_fused=True)),
        "mu gauss-seidel int8 (one-sided #6)": lambda: (
            D.mu_update_frobenius_int8x8(Vq, scale, W0, H0)),
        "mu kl jacobi f32": lambda: D.mu_update_kl(V, W0, H0,
                                                   order="jacobi"),
    }, iters=10)
    for path, ms in it_ms.items():
        say("15 timing", path=path, ms_per_iter=f"{ms:.4f}",
            phase6_plain_f32_mu_ms=f"{plain_ms:.4f}", card=card)
    return {name: {"launches": launches[name],
                   "max_abs_err": max_abs.get(name, 0.0),
                   "ms": t_ms[name], "plain_ms": t_ms[name + "_plain"],
                   "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                   "library_ms": library[name]}
            for name in bounds}


def device_triplets(csr, dev):
    """(rows, cols, values float64) of a host CSR's nonzeros on `dev`."""
    n = csr.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(csr.indptr))
    return (torch.from_numpy(rows).to(dev),
            torch.from_numpy(np.asarray(csr.indices, np.int32)).to(dev),
            torch.from_numpy(np.asarray(csr.data, np.float64)).to(dev))


def weighted_objective(trip, W, H, alpha, chunk=1 << 21) -> float:
    """sum c (v - wh)^2 with c = 1 + alpha v at the nonzeros, 1 elsewhere,
    in float64: sum_nz [v^2 - 2 v wh + alpha v (v - wh)^2] + <W^T W, H H^T>
    (the zeros' (wh)^2 summed by the Gram identity)."""
    rows, cols, v = trip
    W64, Ht64 = W.double(), H.double().T.contiguous()
    total = torch.zeros((), dtype=torch.float64, device=W.device)
    for s in range(0, v.shape[0], chunk):
        wh = (W64[rows[s:s + chunk]] * Ht64[cols[s:s + chunk]]).sum(1)
        vv = v[s:s + chunk]
        total += torch.sum(vv * vv - 2.0 * vv * wh
                           + alpha * vv * (vv - wh) ** 2)
    quad = torch.sum((W64.T @ W64) * (Ht64.T @ Ht64))
    return float(total + quad)


def dense_lines(csr, idx, dev) -> torch.Tensor:
    """Rows `idx` of a host CSR as a dense float64 (len(idx), m) tensor."""
    out = np.zeros((len(idx), csr.shape[1]))
    for k, i in enumerate(idx):
        a, b = csr.indptr[i], csr.indptr[i + 1]
        out[k, csr.indices[a:b]] = csr.data[a:b]
    return torch.from_numpy(out).to(dev)


def weighted_step_error(Vr, Vc, rows, cols, W0, H0, W1, H1, alpha,
                        eps=1e-9) -> float:
    """One weighted MU step ("WH" order) recomputed in float64: the W
    half-step on rows `rows` (dense Vr) from (W0, H0), the H half-step on
    columns `cols` (dense Vc, n x len(cols)) from the engine's (W1, H0).
    Returns the larger max|a - b| / max|b| of the two samples."""
    H0d, W1d = H0.double(), W1.double()
    Wr = W0[rows].double()
    C = 1.0 + alpha * Vr
    want_w = Wr * (((C * Vr) @ H0d.T) / ((C * (Wr @ H0d)) @ H0d.T + eps))
    Hc = H0d[:, cols]
    C = 1.0 + alpha * Vc
    want_h = Hc * ((W1d.T @ (C * Vc)) / (W1d.T @ (C * (W1d @ Hc)) + eps))
    return max(rel_err(W1[rows], want_w)[1], rel_err(H1[:, cols], want_h)[1])


def slice8_phases(nt, card, dev, ratings) -> dict:
    """Phases 16-17: BASELINE config 3 at full size on the four engines
    (densified bf16 by `auto`, densified int8, ELL, scatter), then int8
    densified MU (Frobenius through #6's one-sided entries, and KL) and
    masked completion on ELL and scatter at config 2's shape (`ratings`).
    Returns phase 17's launches of the one-sided entries and their
    largest difference from the exact product, and config 3's CSR, W0,
    H0 and the weighted objective of its ELL run after 0, 1 and C3_ITERS
    iterations (for phase 22)."""
    from nmftpu_torch import densified as DF
    from nmftpu_torch import native_loader as NL
    from nmftpu_torch import sparse_ell as SE
    from nmftpu_torch import sparse_ops as TS
    from nmftpu_torch.config import Initialization, NmfConfig, Objective
    from nmftpu_torch.data.synthetic import synthetic_powerlaw_sparse
    from nmftpu_torch.kernels import dual_numer as DN
    from nmftpu_torch.linalg import dense as D

    # -- 16. BASELINE config 3 at full size ----------------------------------
    t0 = time.perf_counter()
    sp3 = synthetic_powerlaw_sparse(rank=16, **CONFIG3)
    sp3.data[:] = 1.0
    make_s = time.perf_counter() - t0
    # phase 20 (a) at config 3: native CSR and ELL against numpy's
    csr = native_build_check("config 3", sp3, card)
    csc = sp3.T.to_csr()
    del sp3
    n, m = csr.shape
    nnz, r, alpha = csr.nnz, C3_RANK, C3_ALPHA
    say("16 data", shape=f"{n}x{m}", requested_nnz=CONFIG3["nnz"], nnz=nnz,
        rank=r, alpha_confidence=alpha, make_s=f"{make_s:.2f}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    # W0/H0 drawn as the random init draws them: (u + 1e-4) sqrt(mean V / r)
    scale = (nnz / (n * m) / r) ** 0.5
    W0 = (torch.rand(n, r, generator=gen, device=dev) + 1e-4) * scale
    H0 = (torch.rand(r, m, generator=gen, device=dev) + 1e-4) * scale
    trip = device_triplets(csr, dev)
    rng = np.random.default_rng(SEED + 16)
    # the most popular user and item (index 0 under the power law) and a
    # random sample of each
    rows = np.concatenate([[0], rng.choice(np.arange(1, n), 63,
                                           replace=False)])
    cols = np.concatenate([[0], rng.choice(np.arange(1, m), 63,
                                           replace=False)])
    Vr, Vc = dense_lines(csr, rows, dev), dense_lines(csc, cols, dev).T
    obj0 = weighted_objective(trip, W0, H0, alpha)

    def cfg(iters, **knobs):
        return NmfConfig(rank=r, alpha_confidence=alpha,
                         init_method=Initialization.COPY_EXISTING,
                         num_iterations=iters, check_interval=iters,
                         **knobs)

    engines = {"densified bf16 (auto)": ("auto", {}, "bf16"),
               "densified int8": ("densified", {"v_storage": "int8"},
                                  "bf16"),
               "ell": ("ell", {}, "float32"),
               "scatter": ("scatter", {}, "float32")}
    final = {}
    for label, (strategy, knobs, kind) in engines.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ell_builds = NL.CALLS["ell_build"]
        t0 = time.perf_counter()
        plan = nt.prepare_sparse(csr, cfg(1, **knobs), strategy=strategy,
                                 device=dev)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        if strategy == "auto" and plan.strategy != "densified":
            fail(f"config 3: strategy='auto' resolved to {plan.strategy!r}, "
                 "not 'densified'")
        native_ell = NL.CALLS["ell_build"] - ell_builds
        if strategy == "ell" and native_ell != 2:
            fail(f"config 3: the ELL build made {native_ell} native "
                 "ell_build calls, not 2 (V and its transpose)")
        one = plan.run(cfg(1, **knobs), W0=W0, H0=H0)
        step = weighted_step_error(Vr, Vc, rows, cols, W0, H0, one.W, one.H,
                                   alpha)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = plan.run(cfg(C3_ITERS - 1, **knobs), W0=one.W, H0=one.H)
        end.record()
        end.synchronize()
        loop_ms = start.elapsed_time(end) / (C3_ITERS - 1)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        # one iteration alone by CUDA events (the update the loop runs)
        op = plan.operand
        update = plan._bundle(cfg(1, **knobs)).update
        Wp = torch.nn.functional.pad(W0, (0, 0, 0, plan.n_pad - n))
        it_ms = event_ms(lambda: update(op, (), Wp, H0), 1)
        obj1 = weighted_objective(trip, one.W, one.H, alpha)
        objn = weighted_objective(trip, res.W, res.H, alpha)
        finite = bool(torch.isfinite(res.W).all()
                      and torch.isfinite(res.H).all())
        say("16 config 3", engine=label, strategy=plan.strategy,
            iterations=C3_ITERS, ms_per_iter=f"{it_ms:.3f}",
            loop_ms_per_iter_with_checks=f"{loop_ms:.3f}",
            prepare_s=f"{prep_s:.2f}", native_ell_builds=native_ell,
            peak_GiB=f"{peak:.2f}", nm_float32_GiB=f"{4 * n * m / 2**30:.2f}",
            objective=[f"{obj0:.9g}", f"{obj1:.9g}", f"{objn:.9g}"],
            one_step_vs_float64=f"{step:.3e}", rtol=C3_STEP_RTOL[kind],
            finite=finite, card=card)
        if not finite:
            fail(f"config 3 {label}: non-finite factors")
        if not obj0 > obj1 > objn:
            fail(f"config 3 {label}: the weighted objective did not fall: "
                 f"{obj0}, {obj1}, {objn}")
        if not step <= C3_STEP_RTOL[kind]:
            fail(f"config 3 {label}: one step is {step:.3e} from float64 "
                 f"(> {C3_STEP_RTOL[kind]})")
        if label.startswith("densified") and not peak < 4 * n * m / 2**30:
            fail(f"config 3 {label}: peak {peak:.2f} GiB reaches an n*m "
                 "float32 array")
        final[label] = (res.W, res.H, objn)
        if label == "ell":
            mu_objective = (obj0, obj1, objn)
        del plan, op, update, one, res, Wp
        torch.cuda.empty_cache()
    (We, He, obj_e), (Ws, Hs, _) = final["ell"], final["scatter"]
    dw = float((We - Ws).abs().max() / Ws.abs().max())
    dh = float((He - Hs).abs().max() / Hs.abs().max())
    d_obj = {label: abs(final[label][2] / obj_e - 1)
             for label in ("densified bf16 (auto)", "densified int8")}
    say("16 checks", ell_vs_scatter_W=f"{dw:.3e}",
        ell_vs_scatter_H=f"{dh:.3e}", rtol=C3_ENGINES_RTOL,
        densified_vs_ell_objective={k: f"{v:.3e}" for k, v in d_obj.items()},
        objective_rtol=C3_OBJECTIVE_RTOL)
    if not (dw <= C3_ENGINES_RTOL and dh <= C3_ENGINES_RTOL):
        fail(f"config 3: ELL and scatter differ (W {dw:.3e}, H {dh:.3e})")
    if not max(d_obj.values()) <= C3_OBJECTIVE_RTOL:
        fail(f"config 3: densified and ELL objectives differ: {d_obj}")
    # phase 22 runs iALS on the same matrix from the same W0/H0
    config3 = {"csr": csr, "W0": W0, "H0": H0, "mu_objective": mu_objective}
    del final, We, He, Ws, Hs, trip, Vr, Vc, W0, H0, csr, csc
    torch.cuda.empty_cache()

    # -- 17. int8 densified and masked completion at config 2's shape --------
    n, m = ratings.shape
    r = SPARSE_RANK
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    scale = (float(ratings.data.sum(dtype=np.float64)) / (n * m) / r) ** 0.5
    W0 = (torch.rand(n, r, generator=gen, device=dev) + 1e-4) * scale
    H0 = (torch.rand(r, m, generator=gen, device=dev) + 1e-4) * scale

    def cfg17(**knobs):
        return NmfConfig(rank=r, init_method=Initialization.COPY_EXISTING,
                         num_iterations=S8_ITERS, check_interval=1, **knobs)

    def timed(label, plan, config, fn):
        """Run `config` on `plan` from (W0, H0), print its errors and one
        iteration's ms (CUDA events); return the result and #6's launch
        counts read just after the run."""
        t0 = time.perf_counter()
        res = plan.run(config, W0=W0, H0=H0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = dict(DN.LAUNCHES)
        ms = event_ms(fn, 1)
        finite = bool(torch.isfinite(res.W).all()
                      and torch.isfinite(res.H).all())
        say("17 e2e", run=label, strategy=plan.strategy,
            errors=[f"{e:.6g}" for e in res.stats.errors],
            kl_error=res.kl_error, rmsd=f"{res.rmsd:.6g}",
            ms_per_iter=f"{ms:.3f}", seconds=f"{secs:.3f}", finite=finite,
            card=card)
        if not finite:
            fail(f"{label}: non-finite factors")
        return res, launched

    # int8 densified, Frobenius through #6's one-sided entries (the main
    # path of this phase: counts from zero, read just after the run)
    plan = nt.prepare_sparse(ratings, cfg17(v_storage="int8"),
                             strategy="auto", device=dev)
    if plan.strategy != "densified":
        fail(f"int8: strategy='auto' resolved to {plan.strategy!r}")
    Vq, vscale = plan.operand
    Wp = torch.nn.functional.pad(W0, (0, 0, 0, Vq.shape[0] - n))
    DN.LAUNCHES.update(dict.fromkeys(DN.LAUNCHES, 0))
    res, launched = timed(
        "int8 densified frobenius", plan, cfg17(v_storage="int8"),
        lambda: D.mu_update_frobenius_int8x8(Vq, vscale, Wp, H0))
    launches = {k: launched[k] for k in ("vht_int8", "wtv_int8")}
    errs = res.stats.errors
    say("17 checks", run="int8 densified frobenius", launches=launches,
        iterations=res.num_iterations, scale=f"{float(vscale):.6g}")
    if not (min(launches.values()) >= res.num_iterations
            and sum(launches.values()) >= 2 * res.num_iterations):
        fail(f"int8 densified: #6's one-sided entries launched {launches} "
             f"times in {res.num_iterations} iterations")
    if not errs[-1] < errs[0]:
        fail(f"int8 densified frobenius: the error did not fall: {errs}")
    # the entries at this path's shapes (Vq row-padded, the run's final
    # factors quantized) against the exact product
    Wf = torch.nn.functional.pad(res.W, (0, 0, 0, Vq.shape[0] - n))
    _, Hq = D.quantize_sym(res.H)
    _, WqT = D.quantize_sym_t(Wf)
    exact_w, exact_h = DN.vht_exact(Vq, Hq), DN.wtv_exact(Vq, WqT)
    peak = max(float(exact_w.abs().max()), float(exact_h.abs().max()))
    got_w, got_h = DN.vht_int8(Vq, Hq), DN.wtv_int8(Vq, WqT)
    diff = max(float((got_w.double() - exact_w).abs().max()),
               float((got_h.double() - exact_h).abs().max()))
    say("17 int8 numerators", shape=f"{Vq.shape[0]}x{m} r={r}",
        max_abs_diff=diff, max_abs_sum=f"{peak:.6g}", int32_limit=2**31 - 1)
    if peak >= 2**31 or diff != 0:
        fail("int8 densified: the one-sided entries differ from the exact "
             "product (or a sum leaves the int32 range)")
    del exact_w, exact_h, got_w, got_h, Wf, Hq, WqT
    kl_cfg = cfg17(v_storage="int8", objective=Objective.KL)
    kl0 = float(DF.kl_error_densified(Vq, Wp, H0, scale=vscale))
    res, _ = timed("int8 densified kl", plan, kl_cfg,
                lambda: DF.mu_update_kl_densified(Vq, Wp, H0, scale=vscale))
    say("17 checks", run="int8 densified kl", kl_start=f"{kl0:.6g}",
        kl_end=f"{res.kl_error:.6g}")
    if not res.kl_error < kl0:
        fail("int8 densified kl: D_KL did not fall")
    del plan, Vq, vscale, Wp, res
    torch.cuda.empty_cache()

    # masked completion, Frobenius and KL, on ELL and scatter
    masked = {}
    for strategy in ("ell", "scatter"):
        plan = nt.prepare_sparse(ratings, cfg17(mask="observed"),
                                 strategy=strategy, device=dev)
        op = plan.operand
        for obj in (Objective.FROBENIUS, Objective.KL):
            config = cfg17(mask="observed", objective=obj)
            if strategy == "ell":
                fn = (SE.mu_update_frobenius_masked_ell
                      if obj is Objective.FROBENIUS
                      else SE.mu_update_kl_masked_ell)
                start = (SE.frobenius_error_masked_ell(op, W0, H0),
                         SE.kl_error_masked_ell(op, W0, H0))
            else:
                fn = (TS.mu_update_frobenius_masked
                      if obj is Objective.FROBENIUS
                      else TS.mu_update_kl_masked)
                start = (TS.frobenius_error_masked(op, W0, H0),
                         TS.kl_error_masked(op, W0, H0))
            res, _ = timed(f"masked {obj.value} {strategy}", plan, config,
                           lambda: fn(op, W0, H0))
            errs = res.stats.errors
            end = (res.frobenius_error if obj is Objective.FROBENIUS
                   else res.kl_error)
            begin = float(start[0 if obj is Objective.FROBENIUS else 1])
            say("17 checks", run=f"masked {obj.value} {strategy}",
                start=f"{begin:.6g}", end=f"{end:.6g}",
                rmsd_denominator=f"nnz={ratings.nnz}",
                rmsd_check=f"{res.frobenius_error / ratings.nnz ** 0.5:.6g}")
            if not (end < begin and abs(res.rmsd - res.frobenius_error
                                        / ratings.nnz ** 0.5)
                    <= 1e-6 * res.rmsd):
                fail(f"masked {obj.value} {strategy}: the masked objective "
                     "did not fall, or the RMSD is not over the observed set")
            if obj is Objective.FROBENIUS and not all(
                    b < a for a, b in zip(errs[:-1], errs[1:])):
                fail(f"masked frobenius {strategy}: the masked error is not "
                     f"monotone: {errs}")
            masked[strategy, obj] = (res.W, res.H)
        del plan, op
        torch.cuda.empty_cache()
    for obj in (Objective.FROBENIUS, Objective.KL):
        (We, He), (Ws, Hs) = masked["ell", obj], masked["scatter", obj]
        dw = float((We - Ws).abs().max() / Ws.abs().max())
        dh = float((He - Hs).abs().max() / Hs.abs().max())
        say("17 checks", run=f"masked {obj.value}", ell_vs_scatter_W=
            f"{dw:.3e}", ell_vs_scatter_H=f"{dh:.3e}", rtol=C3_ENGINES_RTOL)
        if not (dw <= C3_ENGINES_RTOL and dh <= C3_ENGINES_RTOL):
            fail(f"masked {obj.value}: ELL and scatter differ (W {dw:.3e}, "
                 f"H {dh:.3e})")
    del masked
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": diff, "config3": config3}


def foldin_system64(prep, csr):
    """The unweighted ALS fold-in's normal equations in float64: A =
    prepare_table's Gram + (lambda + eps) I, and N = sum v h over each
    history's rows of the table (its stored values, the scale applied in
    float64); also the gathered rows, their user rows and values."""
    dev = prep.G.device
    b, r = csr.shape[0], prep.G.shape[0]
    rows = torch.as_tensor(np.repeat(np.arange(b), np.diff(csr.indptr)),
                           device=dev)
    cols = torch.as_tensor(csr.indices.astype(np.int64), device=dev)
    Hc = prep.Ht.T.index_select(1, cols).double().T
    if prep.scale is not None:
        Hc = Hc * prep.scale.double()
    vals = torch.as_tensor(csr.data, dtype=torch.float64, device=dev)
    N = torch.zeros((b, r), dtype=torch.float64, device=dev).index_add_(
        0, rows, vals[:, None] * Hc)
    A = prep.G.double() + (COLD_LAMBDA + COLD_EPS) * torch.eye(
        r, dtype=torch.float64, device=dev)
    return A, N, Hc, rows, vals


def check_solve(label, W, W64, kappa) -> None:
    """A fold-in's W (numpy) against the float64 solve of its equations:
    max|a - b| / max|b| within SOLVE_FACTOR kappa 2^-24."""
    rel = float(np.abs(W - W64).max() / np.abs(W64).max())
    limit = SOLVE_FACTOR * kappa * 2.0 ** -24
    say("18 solve", case=label, kappa=f"{kappa:.4g}", rel_err=f"{rel:.3e}",
        limit=f"{limit:.3e}")
    if not rel <= limit:
        fail(f"{label}: fold-in solve off by {rel:.3e} relative, above "
             f"{SOLVE_FACTOR} kappa 2^-24 = {limit:.3e}")


def cold_user_phase(nt, card, dev, recs, max_abs) -> dict:
    """Phase 18: cold users at config 5 against phase 8's two tables
    (`recs`, int8 and bf16, method reservoir): prepare_table (the int8
    Gram on #6's one-sided entry), fold_in_batch under every rule, and
    recommend_from_history_batch at b = 512 and 2048 (#8), driven once
    with every count of the path from 0; then the checks against float64
    and the exact scan, and the times. Returns the path's launches by
    kernel; raises max_abs's entries to the errors the checks saw."""
    from nmftpu_torch import foldin as PF
    from nmftpu_torch.kernels import dual_numer as DN
    from nmftpu_torch.kernels import hals_sweep as HS
    from nmftpu_torch.kernels import mips_reservoir as MR
    from nmftpu_torch.retrieval.exclusion import build_block_exclusion

    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    items = distinct_items(COLD_USERS, gen, dev)
    rng = np.random.default_rng(SEED + 18)
    weights = rng.integers(1, 6, items.shape).astype(np.float32)
    hists = {b: list(items[:b]) for b in (1, 512, COLD_USERS)}
    weighted = [(ids, v) for ids, v in zip(items[:512], weights[:512])]

    # -- the main path, every count from 0 -----------------------------------
    for counts in (DN.LAUNCHES, HS.LAUNCHES, MR.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    gram_launches, served, folded = {}, {}, {}
    for td, rec in recs.items():
        rec._prepared = None
        before = DN.LAUNCHES["vht_int8"]
        rec._prep()
        gram_launches[td] = DN.LAUNCHES["vht_int8"] - before
        for b in (512, COLD_USERS):
            before = MR.LAUNCHES["reservoir_scan"]
            served[td, b] = rec.recommend_from_history_batch(hists[b],
                                                             k=SERVE_K)
            served[td, b] += (MR.LAUNCHES["reservoir_scan"] - before,)
        folded[td, "als"] = rec.fold_in_batch(hists[512])
        folded[td, "weighted"] = rec.fold_in_batch(
            weighted, alpha_confidence=COLD_ALPHA)
    rec = recs["int8"]
    hals_calls = []
    for rule in ("mu", "kl", "hals"):
        kw = ({"algorithm": "mu", "objective": "kl"} if rule == "kl"
              else {"algorithm": rule})
        before = HS.LAUNCHES["hals_sweep"]
        folded["int8", rule] = rec.fold_in_batch(
            hists[512], num_iterations=COLD_ITERS, **kw)
        hals_calls.append(HS.LAUNCHES["hals_sweep"] - before)
    torch.cuda.synchronize()
    launches = {"vht_int8": DN.LAUNCHES["vht_int8"],
                "hals_sweep": HS.LAUNCHES["hals_sweep"],
                "reservoir_scan": MR.LAUNCHES["reservoir_scan"]}
    # the main path ends here; the launches below check or time kernels
    say("18 launches", **launches, int8_gram=gram_launches["int8"],
        bf16_gram=gram_launches["bfloat16"], hals_per_call=hals_calls[2],
        expected_hals=COLD_ITERS)
    if gram_launches["int8"] < -(-SERVE_ITEMS // PF.GRAM_PANEL_INT8):
        fail(f"the int8 Gram ran #6 {gram_launches['int8']} times, not "
             f"once per {PF.GRAM_PANEL_INT8}-item panel")
    if hals_calls != [0, 0, COLD_ITERS]:
        fail(f"HALS fold-in launched #7 {hals_calls[2]} times in "
             f"{COLD_ITERS} iterations (MU, KL: {hals_calls[:2]})")
    if min(launches.values()) < 1:
        fail(f"a kernel of the cold-user path never launched: {launches}")

    # -- prepare_table: the int8 Gram exact, the bf16 Gram against float64 --
    Hq = recs["int8"].H
    G_int = PF.int8_gram(Hq)
    G_exact = torch.zeros_like(G_int, dtype=torch.float64)
    for lo in range(0, SERVE_ITEMS, PF.GRAM_PANEL_INT8):
        P = Hq[:, lo:lo + PF.GRAM_PANEL_INT8].contiguous()
        G_exact += DN.vht_exact(P, P)
    gram_diff = float((G_int.double() - G_exact).abs().max())
    max_abs["vht_int8"] = max(max_abs["vht_int8"], gram_diff)
    Hb = recs["bfloat16"].H
    G64 = torch.zeros_like(G_exact)
    for lo in range(0, SERVE_ITEMS, PF.GRAM_PANEL_FLOAT):
        P = Hb[:, lo:lo + PF.GRAM_PANEL_FLOAT].double()
        G64 += P @ P.T
    del P
    bf16_rel = float((recs["bfloat16"]._prep().G.double() - G64).abs().max()
                     / G64.abs().max())
    say("18 prepare_table", int8_gram_vs_exact_max_abs=gram_diff,
        largest_int8_sum=f"{float(G_exact.abs().max()):.6g}",
        bf16_gram_rel_err=f"{bf16_rel:.3e}", bf16_rtol=GRAM_BF16_RTOL)
    if gram_diff != 0.0:
        fail(f"the int8 Gram differs from the exact one by {gram_diff}")
    if not bf16_rel <= GRAM_BF16_RTOL:
        fail(f"the bf16 Gram is off by {bf16_rel:.3e} relative")
    del G_int, G_exact, G64

    # -- the solves against float64 ------------------------------------------
    csr512 = rec._histories_csr(hists[512])
    for td, r8 in recs.items():
        A, N, Hc, rows, vals = foldin_system64(r8._prep(), csr512)
        W64 = torch.clamp(torch.linalg.solve(A, N.T).T, min=0.0)
        check_solve(f"ALS b=512 {td}", folded[td, "als"],
                    W64.cpu().numpy(), float(torch.linalg.cond(A)))
        # the weighted fold-in, per sampled user: Gram_u = G + sum (c - 1)
        # h hᵀ and rhs_u = sum c v h, c = 1 + alpha v, with the float32
        # path's relative ridge
        wcsr = r8._histories_csr(weighted)
        _, _, Hc, rows, vals = foldin_system64(r8._prep(), wcsr)
        G64 = r8._prep().G.double()
        r = G64.shape[0]
        for u in rng.choice(512, COLD_SAMPLE, replace=False):
            sel = rows == int(u)
            h, v = Hc[sel], vals[sel]
            Gu = G64 + h.T @ (h * (COLD_ALPHA * v)[:, None])
            ridge = (COLD_LAMBDA + COLD_EPS + max(COLD_EPS, 100 * 2.0 ** -23)
                     * float(torch.diagonal(Gu).sum()) / r)
            Au = Gu + ridge * torch.eye(r, dtype=G64.dtype, device=dev)
            w64 = torch.clamp(torch.linalg.solve(
                Au, h.T @ ((1.0 + COLD_ALPHA * v) * v)), min=0.0)
            check_solve(f"weighted ALS alpha={COLD_ALPHA} user {u} {td}",
                        folded[td, "weighted"][u], w64.cpu().numpy(),
                        float(torch.linalg.cond(Au)))
    del A, N, Hc, rows, vals, G64

    # -- MU, KL and HALS: each objective falls; #7 against its twin ----------
    prep = rec._prep()
    for rule, kw in (("mu", {"algorithm": "mu"}),
                     ("kl", {"algorithm": "mu", "objective": "kl"}),
                     ("hals", {"algorithm": "hals"})):
        errs = [PF.transform(csr512, prep, num_iterations=k, **kw).error
                for k in (0, 1, COLD_ITERS)]
        say("18 objective", rule=rule, iterations=[0, 1, COLD_ITERS],
            error=[f"{e:.8g}" for e in errs])
        if not errs[0] > errs[1] > errs[2]:
            fail(f"{rule} fold-in: the objective did not fall: {errs}")
    cols = torch.as_tensor(csr512.indices.astype(np.int64), device=dev)
    rows = torch.as_tensor(np.repeat(np.arange(512), SERVE_SEEN), device=dev)
    N = torch.zeros((512, SERVE_RANK), device=dev).index_add_(
        0, rows, PF._table_rows(prep, cols))
    Gh = prep.G + COLD_LAMBDA * torch.eye(SERVE_RANK, device=dev)
    W0 = PF._init_w(512, SERVE_RANK, 0, None, dev)
    got, want = HS.hals_sweep(N, Gh, W0), HS.hals_sweep_plain(N, Gh, W0)
    one = PF.transform(csr512, prep, algorithm="hals", num_iterations=1,
                       lambda_w=COLD_LAMBDA).W
    exact = HS.hals_sweep_plain(N.double(), Gh.double(), W0.double())
    torch.cuda.synchronize()
    # the sweep's rounding is in units of the W it reads: a fold-in's
    # first sweep shrinks W from its uniform(0.1, 1) start by about 10^3
    # (N is 100 items' rows, W0 G is all m items'), so phase 13's
    # max|W| is taken over the sweep's input and output
    diff = float((got - want).abs().max())
    top = max(float(want.abs().max()), float(W0.abs().max()))
    path_diff = float((one - want).abs().max())
    max_abs["hals_sweep"] = max(max_abs["hals_sweep"], diff)
    say("18 hals_sweep", case="fold-in b=512 r=256", max_abs=f"{diff:.3e}",
        rel_to_max=f"{diff / top:.3e}", transform_one_iteration_rel=
        f"{path_diff / top:.3e}", max_W_out=f"{float(want.abs().max()):.4g}",
        max_W_in=f"{float(W0.abs().max()):.4g}", bound=HALS_ATOL)
    if not (diff <= HALS_ATOL * top and path_diff <= HALS_ATOL * top):
        fail("hals_sweep at the fold-in's shape disagrees with its twin")
    f64_check("18", "hals_sweep", "fold-in b=512 r=256", got, want, exact,
              scaled=True)
    del N, Gh, W0, got, want, one, exact

    # -- recommend_from_history_batch against the exact scan -----------------
    for (td, b), (s, i, scans) in served.items():
        r8 = recs[td]
        csr = r8._histories_csr(hists[b])
        Wq = r8._fold_in_csr(csr, algorithm="als", objective="frobenius",
                             num_iterations=COLD_ITERS, alpha_confidence=0.0,
                             lambda_w=COLD_LAMBDA, seed=0)
        exact = type(r8).from_table(r8.W, r8.H, h_scale=r8._h_scale,
                                    method="exact", device=dev)
        lists = build_block_exclusion(np.arange(b), csr, SERVE_ITEMS,
                                      exact.block)
        i_ex = exact._topk(Wq, SERVE_K, lists, None)[1].cpu().numpy()
        recall = np.mean([len(set(i[row].tolist()) & set(i_ex[row].tolist()))
                          / SERVE_K for row in range(b)])
        violations = sum(len(set(i[row].tolist()) & set(items[row].tolist()))
                         for row in range(b))
        finite = bool(np.isfinite(s).all())
        say("18 serve", table=td, batch=b, k=SERVE_K, reservoir_scans=scans,
            recall_at_100=f"{recall:.6f}", history_violations=violations,
            finite=finite)
        if not (scans >= 1 and recall >= RECALL_FLOOR and violations == 0
                and finite):
            fail(f"cold users {td} b={b}: {scans} scans, recall "
                 f"{recall:.6f}, {violations} history items returned")
        if td == "int8" and b == 512:
            Wk = (Wq * r8._h_scale).contiguous()
            a, _, _ = check_reservoir(MR, "cold users b=512 int8", Wk, r8.H,
                                      SERVE_ITEMS, r8.reservoir_slots)
            max_abs["reservoir_scan"] = max(max_abs["reservoir_scan"], a)
        del exact, lists, Wq

    # -- times ----------------------------------------------------------------
    for td, r8 in recs.items():
        ms = event_ms(lambda: PF.prepare_table(r8.H, scale=r8._h_scale),
                      iters=2)
        say("18 timing", path=f"prepare_table {td}", ms=f"{ms:.3f}",
            card=card)
    # one panel of the int8 Gram: #6's one-sided entry, its twin, and
    # torch._int_mm (cuBLASLt int8, timed only)
    P = Hq[:, :PF.GRAM_PANEL_INT8].contiguous()
    g_ms = abba_ms({"kernel": lambda: DN.vht_int8(P, P),
                    "plain": lambda: DN.vht_int8_plain(P, P),
                    "library": lambda: torch._int_mm(P, P.t())}, iters=5)
    b_ms, b_by = bound(2 * SERVE_RANK ** 2 * PF.GRAM_PANEL_INT8,
                       P.numel() + 4 * SERVE_RANK ** 2, INT8_PEAK)
    say("18 kernel timing", kernel="vht_int8",
        shape=f"int8 Gram panel {SERVE_RANK}x{PF.GRAM_PANEL_INT8}",
        ms=f"{g_ms['kernel']:.4f}", plain_ms=f"{g_ms['plain']:.4f}",
        library_ms=f"{g_ms['library']:.4f}", bound_ms=f"{b_ms:.4f}",
        bound_by=b_by, card=card)
    del P
    paths = {
        "ALS b=1": lambda: rec.fold_in_batch(hists[1]),
        "ALS b=512": lambda: rec.fold_in_batch(hists[512]),
        "weighted ALS b=512": lambda: rec.fold_in_batch(
            weighted, alpha_confidence=COLD_ALPHA),
        "MU b=512": lambda: rec.fold_in_batch(
            hists[512], algorithm="mu", num_iterations=COLD_ITERS),
        "MU KL b=512": lambda: rec.fold_in_batch(
            hists[512], algorithm="mu", objective="kl",
            num_iterations=COLD_ITERS),
        "HALS b=512": lambda: rec.fold_in_batch(
            hists[512], algorithm="hals", num_iterations=COLD_ITERS),
    }
    for path, fn in paths.items():
        say("18 timing", path=f"fold_in_batch {path} int8",
            ms=f"{event_ms(fn, iters=3):.3f}", card=card)
    for td, r8 in recs.items():
        for b in (512, COLD_USERS):
            ms = event_ms(lambda: r8.recommend_from_history_batch(
                hists[b], k=SERVE_K), iters=3)
            say("18 timing", path=f"recommend_from_history_batch {td}",
                batch=b, ms=f"{ms:.3f}", q_per_s=f"{b / ms * 1e3:.1f}",
                card=card)
    return launches


def beta_storage_limit(D, V, Vs, W, H, beta) -> float:
    """The limit on |D_beta(bf16 or int8 run) / D_beta(float32 run) - 1|
    (see BETA_STEP_RTOL's note): sum |d d_beta / dv| |v' - v| / D_beta at
    the float32 run's final factors (W, H), in float64, for the stored V'
    (Vs, dequantized), plus one step's ratio rounding."""
    V64 = V.double()
    WH = (W.double() @ H.double()).clamp_min(1e-12)
    if beta == 0.0:
        grad = 1.0 / WH - 1.0 / V64
    else:
        grad = (V64 ** (beta - 1.0) - WH ** (beta - 1.0)) / (beta - 1.0)
    first = float((grad.abs() * (Vs.double() - V64).abs()).sum())
    del grad, WH
    div = float(D.beta_divergence(V64, W.double(), H.double(), beta))
    return (first / div
            + (2 * abs(beta - 2) + 2 * abs(beta - 1) + 4) * 2.0 ** -9)


def beta_phase(nt, D, card, dev) -> None:
    """Phase 19: dense MU under the beta divergence at 4096^2 / r = 256
    through nmf, V stored as float32, bfloat16 and int8 (the densified
    row-panel update), one iteration a call from the previous call's
    factors: D_beta (the result's kl_error, on the float32 V) falls at
    each step, the first float32 step matches a float64 recomputation,
    the bf16 and int8 runs end within their derived limit of the float32
    run's D_beta; ms per iteration."""
    from nmftpu_torch import densified as DF
    from nmftpu_torch.kernels import quantized as Q

    n, m, r = BETA_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    V = synthetic_lowrank(n, m, r, gen, dev)
    W0 = torch.rand(n, r, generator=gen, device=dev) + 0.01
    H0 = torch.rand(r, m, generator=gen, device=dev) + 0.01
    Vb = V.to(torch.bfloat16)
    Vq, vscale = Q.quantize_v(V)
    stored = {"bfloat16": Vb.float(), "int8": Vq.float() * vscale}
    updates = {
        "float32": lambda W, H, b: D.mu_update_beta(V, W, H, b),
        "bfloat16": lambda W, H, b: DF.mu_update_beta_densified(Vb, W, H, b),
        "int8": lambda W, H, b: DF.mu_update_beta_densified(
            Vq, W, H, b, scale=vscale)}
    for beta in BETAS:
        final = {}
        for storage, update in updates.items():
            W, H = W0, H0
            divs = [float(D.beta_divergence(V, W, H, beta))]
            for it in range(BETA_ITERS):
                res = nt.nmf(V, r, objective="beta-divergence", beta=beta,
                             v_storage=storage, init="copy", W0=W, H0=H,
                             num_iterations=1, device=dev)
                if it == 0 and storage == "float32":
                    W64, H64 = D.mu_update_beta(V.double(), W0.double(),
                                                H0.double(), beta)
                    dw = float((res.W.double() - W64).abs().max()
                               / W64.abs().max())
                    dh = float((res.H.double() - H64).abs().max()
                               / H64.abs().max())
                    del W64, H64
                W, H = res.W, res.H
                divs.append(res.kl_error)
            ms = cuda_ms(lambda: update(W, H, beta), iters=10)
            falls = all(b < a for a, b in zip(divs[:-1], divs[1:]))
            final[storage] = (divs[-1], W, H)
            if storage == "float32":
                checks = dict(step_W_rel=f"{dw:.3e}", step_H_rel=f"{dh:.3e}",
                              rtol=BETA_STEP_RTOL)
            else:
                d32, W32, H32 = final["float32"]
                diff = abs(divs[-1] / d32 - 1)
                limit = beta_storage_limit(D, V, stored[storage], W32, H32,
                                           beta)
                checks = dict(vs_float32=f"{diff:.3e}", limit=f"{limit:.3e}")
            say("19 beta MU", beta=beta, v_storage=storage, shape=f"{n}x{m}",
                rank=r, divergence=[f"{d:.8g}" for d in divs], falls=falls,
                **checks, ms_per_iter=f"{ms:.4f}", card=card)
            if not falls:
                fail(f"beta={beta} {storage}: D_beta did not fall every "
                     f"iteration: {divs}")
            if storage == "float32" and not (dw <= BETA_STEP_RTOL
                                             and dh <= BETA_STEP_RTOL):
                fail(f"beta={beta}: one step differs from float64 (W "
                     f"{dw:.3e}, H {dh:.3e})")
            if storage != "float32" and not diff <= limit:
                fail(f"beta={beta} {storage}: D_beta {divs[-1]} is "
                     f"{diff:.3e} from the float32 run's (> {limit:.3e})")
    del V, Vb, Vq, stored, updates, final
    torch.cuda.empty_cache()


def native_build_check(label, coo, card):
    """Phase 20 (a) on one matrix: its CSR (from the COO `coo`) and its
    ELL pair, each built by the native library and by numpy, must be
    equal array for array; host seconds of both. Returns the native
    CSR."""
    import os

    from nmftpu_torch import native_loader as NL
    from nmftpu_torch import sparse_ell as SE

    def timed(fn, native):
        if native:
            os.environ.pop("NMFTPU_NATIVE_CSR", None)
        else:
            os.environ["NMFTPU_NATIVE_CSR"] = "0"
        try:
            t0 = time.perf_counter()
            return fn(), time.perf_counter() - t0
        finally:
            os.environ.pop("NMFTPU_NATIVE_CSR", None)

    calls = dict(NL.CALLS)
    csr, csr_native_s = timed(coo.to_csr, True)
    ref, csr_numpy_s = timed(coo.to_csr, False)
    if NL.CALLS["csr_build"] != calls["csr_build"] + 1:
        fail(f"{label}: the CSR build did not take the native path")
    for f in ("indptr", "indices", "data"):
        if not np.array_equal(getattr(csr, f), getattr(ref, f)):
            fail(f"{label}: native and numpy CSR differ in {f}")
    del ref
    calls = dict(NL.CALLS)
    pair, ell_native_s = timed(lambda: SE.build_ell_pair(csr, device="cpu"),
                               True)
    ref, ell_numpy_s = timed(lambda: SE.build_ell_pair(csr, device="cpu"),
                             False)
    if NL.CALLS["ell_build"] != calls["ell_build"] + 2:
        fail(f"{label}: the ELL build did not take the native path")
    buckets = 0
    for a, b in ((pair.rows, ref.rows), (pair.cols, ref.cols)):
        if len(a.buckets) != len(b.buckets):
            fail(f"{label}: native and numpy ELL differ in bucket count")
        for x, y in zip(a.buckets, b.buckets):
            buckets += 1
            if x.width != y.width or not all(
                    torch.equal(getattr(x, f), getattr(y, f))
                    for f in ("vals", "cols", "out_row")):
                fail(f"{label}: native and numpy ELL differ (bucket of "
                     f"width {y.width})")
    say("20 native", data=label, shape=f"{csr.shape[0]}x{csr.shape[1]}",
        nnz=csr.nnz, equal=True, ell_buckets=buckets,
        csr_native_s=f"{csr_native_s:.3f}", csr_numpy_s=f"{csr_numpy_s:.3f}",
        ell_pair_native_s=f"{ell_native_s:.3f}",
        ell_pair_numpy_s=f"{ell_numpy_s:.3f}", card=card)
    return csr


def native_parse_check(card) -> None:
    """Phase 20 (a): both MovieLens fixtures through the native and the
    numpy parser: equal matrices and id maps."""
    from nmftpu_torch.data import load_movielens

    for name in ("ml100k_u.data", "ml20m_ratings.csv"):
        path = str(HERE / "tests" / "fixtures" / name)
        nat = load_movielens(path, use_native=True)
        py = load_movielens(path, use_native=False)
        same = (nat.matrix.shape == py.matrix.shape
                and np.array_equal(nat.matrix.todense(), py.matrix.todense())
                and np.array_equal(nat.user_ids, py.user_ids)
                and np.array_equal(nat.item_ids, py.item_ids))
        say("20 native", fixture=name, shape=nat.matrix.shape,
            nnz=nat.matrix.nnz, native_equals_numpy=same, card=card)
        if not same:
            fail(f"{name}: the native and numpy parsers differ")


def beta_step_error(D, Vr, Vc, rows, cols, W0, H0, W1, H1, beta) -> float:
    """One beta MU step ("WH" order) recomputed in float64: the W
    half-step on rows `rows` (dense Vr) from (W0, H0), which needs only
    W_R H; the H half-step on columns `cols` (dense Vc, n x len(cols))
    from the engine's (W1, H0), which needs only W1 H_C. Returns the
    largest relative error of an entry of the two samples."""
    gamma = D.beta_gamma(beta)

    def stab(X):
        return torch.where(X < D._STAB_EPS, 0.0, X) if beta < 1.0 else X

    want_w = stab(D.beta_w_step(Vr, W0[rows].double(), H0.double(), beta,
                                gamma=gamma))
    want_h = stab(D.beta_h_step(Vc, W1.double(), H0[:, cols].double(), beta,
                                gamma=gamma))
    return max(rel_err(W1[rows], want_w)[1], rel_err(H1[:, cols], want_h)[1])


def beta_engines_phase(nt, card, dev, ratings) -> None:
    """Phase 20: the native host layer at config 2 (config 3's is checked
    in phase 16) and the fixtures; beta MU at config 2's full width on the
    densified bf16 (auto), densified int8, ELL and scatter engines, and
    ELL on the int8-dequantized ratings, 4 iterations each: D_beta (each
    engine's own) falls, one step matches float64 on a row and a column
    sample, the engines agree; ms per iteration and peak memory; auto's
    choice of engine under beta."""
    from nmftpu_torch import sparse as host_sparse
    from nmftpu_torch import sparse_ops as TS
    from nmftpu_torch.config import Initialization, NmfConfig, Objective
    from nmftpu_torch.linalg import dense as D

    # -- (a) the native layer at config 2, the fixtures ----------------------
    native_build_check("config 2", ratings.to_coo(), card)
    native_parse_check(card)

    # -- (d) auto's engine under beta -----------------------------------------
    n, m = ratings.shape
    r = SPARSE_RANK

    def cfg(beta, iters=1, **knobs):
        return NmfConfig(rank=r, objective=Objective.BETA, beta=beta,
                         init_method=Initialization.COPY_EXISTING,
                         num_iterations=iters, check_interval=iters,
                         **knobs)

    resolved = {
        "float64": TS._resolve_strategy(None, cfg(0.5, dtype="float64"),
                                        "auto", n, m),
        "config 2 float32": TS._resolve_strategy(None, cfg(0.5), "auto", n,
                                                 m),
        "10^6 x 10^6": TS._resolve_strategy(None, cfg(0.5), "auto", 10**6,
                                            10**6)}
    say("20 auto", resolved=resolved)
    if resolved != {"float64": "scatter", "config 2 float32": "densified",
                    "10^6 x 10^6": "ell"}:
        fail(f"auto under beta resolved {resolved}")

    # -- (c) config 2 on four engines ----------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    scale = (float(ratings.data.sum(dtype=np.float64)) / (n * m) / r) ** 0.5
    W0 = (torch.rand(n, r, generator=gen, device=dev) + 1e-4) * scale
    H0 = (torch.rand(r, m, generator=gen, device=dev) + 1e-4) * scale
    csc = ratings.T.to_csr()
    rng = np.random.default_rng(SEED + 20)
    top_user = int(np.argmax(np.diff(ratings.indptr)))
    top_item = int(np.argmax(np.diff(csc.indptr)))
    rows = np.concatenate([[top_user], rng.choice(
        np.setdiff1d(np.arange(n), [top_user]), 63, replace=False)])
    cols = np.concatenate([[top_item], rng.choice(
        np.setdiff1d(np.arange(m), [top_item]), 63, replace=False)])
    lines = (dense_lines(ratings, rows, dev), dense_lines(csc, cols, dev).T)
    del csc

    for beta in C2_BETAS:
        gamma = D.beta_gamma(beta)
        # densified: bf16 rounds W and H inside WH (2^-8 on the sum of
        # positive products, raised to b - 2 and b - 1), then (WH)^(b-2) V
        # and (WH)^(b-1), then the partner factor: the numerator's and
        # the denominator's sums of positive terms are off by at most
        # (2|b - 2| + 2) 2^-9 and (2|b - 1| + 2) 2^-9, the ratio by their
        # sum, raised to gamma
        bf16_step = gamma * (2 * abs(beta - 2) + 2 * abs(beta - 1)
                             + 4) * 2.0 ** -9
        runs = {"densified bf16 (auto)": (ratings, "auto", {}, bf16_step),
                "densified int8": (ratings, "densified",
                                   {"v_storage": "int8"}, bf16_step),
                "ell": (ratings, "ell", {}, C2_STEP_RTOL),
                "scatter": (ratings, "scatter", {}, C2_STEP_RTOL)}
        final = {}
        for label in list(runs) + ["ell dequantized"]:
            if label == "ell dequantized":
                # the int8 run's ratings, scale * round(v / scale) in
                # float32 as densify_quantized rounds them
                s32 = np.float32(float(vscale))
                deq = (np.clip(np.round(ratings.data / s32), -127, 127)
                       * s32).astype(np.float32)
                runs[label] = (host_sparse.SparseCSR(
                    ratings.indptr, ratings.indices, deq, ratings.shape),
                    "ell", {}, C2_STEP_RTOL)
            src, strategy, knobs, step_rtol = runs[label]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            plan = nt.prepare_sparse(src, cfg(beta, **knobs),
                                     strategy=strategy, device=dev)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            if strategy == "auto" and plan.strategy != "densified":
                fail(f"config 2 beta: strategy='auto' resolved to "
                     f"{plan.strategy!r}, not 'densified'")
            op, bundle = plan.operand, plan._bundle(cfg(beta, **knobs))
            Wp = torch.nn.functional.pad(W0, (0, 0, 0, plan.n_pad - n))
            Vr, Vc = lines
            if label in ("densified int8", "ell dequantized"):
                if label == "densified int8":
                    vscale = op[1]
                Vr, Vc = ((torch.round(x.float() / vscale).clamp(-127, 127)
                           * vscale).double() for x in lines)
            divs = [float(bundle.kl(op, (), Wp, H0))]
            W, H = W0, H0
            for it in range(C2_BETA_ITERS):
                res = plan.run(cfg(beta, **knobs), W0=W, H0=H)
                if it == 0:
                    step = beta_step_error(D, Vr, Vc, rows, cols, W0, H0,
                                           res.W, res.H, beta)
                W, H = res.W, res.H
                divs.append(res.kl_error)
            ms = event_ms(lambda: bundle.update(op, (), Wp, H0), 1)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            falls = all(b < a for a, b in zip(divs[:-1], divs[1:]))
            finite = bool(torch.isfinite(W).all() and torch.isfinite(H).all())
            say("20 config 2 beta", beta=beta, engine=label,
                strategy=plan.strategy, iterations=C2_BETA_ITERS,
                divergence=[f"{d:.9g}" for d in divs], falls=falls,
                one_step_vs_float64=f"{step:.3e}", rtol=f"{step_rtol:.3e}",
                ms_per_iter=f"{ms:.3f}", prepare_s=f"{prep_s:.2f}",
                peak_GiB=f"{peak:.2f}", finite=finite, card=card)
            if not (finite and falls):
                fail(f"config 2 beta={beta} {label}: D_beta did not fall at "
                     f"every iteration, or the factors are not finite: "
                     f"{divs}")
            if not step <= step_rtol:
                fail(f"config 2 beta={beta} {label}: one step is "
                     f"{step:.3e} from float64 (> {step_rtol:.3e})")
            final[label] = (W, H, divs[-1])
            del plan, op, bundle, Wp, res
            torch.cuda.empty_cache()
        (We, He, d_ell), (Ws, Hs, _) = final["ell"], final["scatter"]
        dw = float((We - Ws).abs().max() / Ws.abs().max())
        dh = float((He - Hs).abs().max() / Hs.abs().max())
        d_bf16 = abs(final["densified bf16 (auto)"][2] / d_ell - 1)
        d_int8 = abs(final["densified int8"][2]
                     / final["ell dequantized"][2] - 1)
        say("20 checks", beta=beta, ell_vs_scatter_W=f"{dw:.3e}",
            ell_vs_scatter_H=f"{dh:.3e}",
            densified_bf16_vs_ell_divergence=f"{d_bf16:.3e}",
            densified_int8_vs_ell_dequantized_divergence=f"{d_int8:.3e}",
            rtol=C2_ENGINES_RTOL)
        if not max(dw, dh, d_bf16, d_int8) <= C2_ENGINES_RTOL:
            fail(f"config 2 beta={beta}: the engines differ (W {dw:.3e}, H "
                 f"{dh:.3e}, bf16 {d_bf16:.3e}, int8 {d_int8:.3e})")
        del final, We, He, Ws, Hs
    del lines, W0, H0
    torch.cuda.empty_cache()


def family_operand(X, storage):
    """The factor operand as a step of `storage` feeds it to the large
    product, in float64: rounded to bf16, quantized and dequantized
    (int8), or as it is."""
    from nmftpu_torch.linalg import dense as D

    if storage == "bfloat16":
        return X.to(torch.bfloat16).double()
    if storage == "int8":
        s, Xq = D.quantize_sym(X)
        return Xq.double() * s.double()
    return X.double()


def family_mu64(alg, kl, side, Vx, W, H, S, storage, eps=1e-9):
    """One MU-type half-step (`side` "w" or "h": the GDCLS W step, nsNMF
    under Frobenius or KL) recomputed in float64 from the card's float32
    W and H; Vx is V as the step stores it, in float64, and the large
    product's factor operand is rounded as `storage` says ("float32":
    unrounded)."""
    W64, H64, S64 = W.double(), H.double(), S.double()
    if side == "w":
        P64 = H64 if alg == "gdcls" else S64 @ H64
        if kl:
            ratio = Vx / (W64 @ P64 + eps)
            return (W64 * (ratio @ P64.T)
                    / torch.clamp(P64.sum(dim=1), min=eps)[None, :])
        Pop = family_operand(H if alg == "gdcls" else S @ H, storage)
        return W64 * (Vx @ Pop.T) / (W64 @ (P64 @ P64.T) + eps)
    Q64 = W64 @ S64
    if kl:
        ratio = Vx / (Q64 @ H64 + eps)
        return (H64 * (Q64.T @ ratio)
                / torch.clamp(Q64.sum(dim=0), min=eps)[:, None])
    Pop = family_operand(W @ S, storage)
    return H64 * (Pop.T @ Vx) / ((Q64.T @ Q64) @ H64 + eps)


def family_ls_terms(storage, side, aux, V, W, H):
    """The Gram and the right-hand side of a solve half-step as the route
    of `storage` forms them on the card (float32), and both in float64
    from the same rounded operands."""
    from nmftpu_torch import densified as DF
    from nmftpu_torch.linalg import dense as D

    if storage == "int8":
        fn = D._ls_terms_w_int8 if side == "w" else D._ls_terms_h_int8
        gram, rhs = fn(aux[0], aux[1], H if side == "w" else W)
        Vx = aux[0].double() * aux[1].double()
    elif storage == "bfloat16":
        Vb = aux[0]
        P = H if side == "w" else W
        gram = P @ P.T if side == "w" else P.T @ P
        rhs = DF._big_vht(Vb, H).T if side == "w" else DF._big_wtv(W, Vb)
        Vx = Vb.double()
    else:
        gram = H @ H.T if side == "w" else W.T @ W
        rhs = H @ V.T if side == "w" else W.T @ V
        Vx = V.double()
    Pop = family_operand(H if side == "w" else W, storage)
    P64 = Pop if storage == "int8" else (H if side == "w" else W).double()
    if side == "w":
        return gram, rhs, P64 @ P64.T, Pop @ Vx.T
    return gram, rhs, P64.T @ P64, Pop.T @ Vx


def solver_spread(D, label, A, rhs) -> None:
    """Print how far float32 solvers of A X = rhs land from the float64
    solve, in units of kappa 2^-24, on the card and on the host: the
    port's explicit-inverse Cholesky solve (linalg.dense.spd_solve),
    cholesky_solve (two triangular solves) and LU."""
    want = torch.linalg.solve(A.double(), rhs.double())
    unit = float(torch.linalg.cond(A.double())) * 2.0 ** -24
    for Ax, bx in ((A, rhs), (A.cpu(), rhs.cpu())):
        got = {"spd_solve": D.spd_solve(Ax, bx),
               "cholesky_solve": torch.cholesky_solve(
                   bx, torch.linalg.cholesky(Ax)),
               "lu": torch.linalg.solve(Ax, bx)}
        errs = {f"{k}_in_kappa_u":
                float((x.to(want).double() - want).abs().max()
                      / want.abs().max()) / unit for k, x in got.items()}
        say("21 float32 solvers", system=label, device=Ax.device.type,
            r=A.shape[0], kappa=f"{unit * 2**24:.4g}",
            **{k: f"{v:.2f}" for k, v in errs.items()})


def family_solve_check(label, side, got, gram, rhs, shift, off,
                       eps=1e-9) -> tuple:
    """A solve half-step's result against the float64 solve of the same
    equations (the card's Gram and right-hand side, as phase 18 takes
    them), clamped at 0: (max|a - b| / max|b|, kappa of the matrix)."""
    r = gram.shape[0]
    A = gram.double() + (shift + eps) * torch.eye(
        r, dtype=torch.float64, device=gram.device) + off
    want = torch.clamp(torch.linalg.solve(A, rhs.double()), min=0.0)
    if side == "w":
        want = want.T
    rel = float((got.double() - want).abs().max() / want.abs().max())
    return rel, float(torch.linalg.cond(A))


def family_shifts(alg, kn, storage, r):
    """(shift_w, shift_h, off_w, off_h) the route of `alg` on `storage`
    solves with: the float64 Hoyer shifts of the int8 and bf16 routes
    (linalg.dense._als_family_shifts), the dense float32 AHCLS shift in
    float32 (linalg.dense._ahcls_shift), the penalties, or the GDCLS
    Tikhonov term (H side)."""
    import nmftpu_torch as nt
    from nmftpu_torch.linalg import dense as D

    if alg == "gdcls":
        return 0.0, kn["lambda_tik"], 0.0, 0.0
    if storage != "float32" or alg != "ahcls":
        return D._als_family_shifts(nt.NmfConfig(rank=r, algorithm=alg,
                                                 **kn))
    (dw, ow), (dh, oh) = (
        D._ahcls_shift(kn[f"lambda_{s}"], kn[f"alpha_{s}"], r, torch.float32)
        for s in "wh")
    return float(dw), float(dh), float(ow), float(oh)


def family_run(nt, DN, label, V_in, rank, W0, H0, iters, **kw):
    """One nmf run from (W0, H0), checked every iteration, with #6's
    one-sided counts from 0 just before it; returns (result, launches,
    peak GiB, seconds)."""
    DN.LAUNCHES.update(vht_int8=0, wtv_int8=0)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = nt.nmf(V_in, rank, init="copy", W0=W0, H0=H0, num_iterations=iters,
                 check_interval=1, device=V_in.device, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = {k: DN.LAUNCHES[k] for k in ("vht_int8", "wtv_int8")}
    finite = bool(torch.isfinite(res.W).all() and torch.isfinite(res.H).all())
    if not finite or not np.isfinite(res.stats.errors).all():
        fail(f"{label}: non-finite factors or errors "
             f"{res.stats.errors.tolist()}")
    return res, launched, torch.cuda.max_memory_allocated() / 2**30, secs


def check_int8_rhs(DN, D, label, Vq, pw, ph) -> None:
    """#6's one-sided entries on the operands an int8 step quantized (pw
    for the W side, ph for the H side) against the exact float64 product
    (atol 0)."""
    Hq = D.quantize_sym(pw)[1]
    WqT = D.quantize_sym_t(ph)[1]
    dv = float((DN.vht_int8(Vq, Hq).double() - DN.vht_exact(Vq, Hq))
               .abs().max())
    dw = float((DN.wtv_int8(Vq, WqT).double() - DN.wtv_exact(Vq, WqT))
               .abs().max())
    say("21 int8 rhs", run=label, vht_vs_exact_max_abs=dv,
        wtv_vs_exact_max_abs=dw)
    if dv or dw:
        fail(f"{label}: the int8 right-hand sides differ from the exact "
             f"product (vht {dv}, wtv {dw})")


def family_phase(nt, card, dev, V, W0, H0) -> dict:
    """Phase 21: the dense ALS family, GDCLS and nsNMF (slice 4b-i). (a)
    every algorithm on float32, bf16 and int8 V at 4096^2 / r = 256 (V,
    W0, H0 are phase 4's) through nmf, each step held against float64;
    (b) int8 and bf16 ALS, GDCLS and nsNMF at the ML-20M shape against
    float32; (c) the k-means and NNDSVD inits at 4096^2; (d) every
    algorithm from every init on BASELINE config 1. Returns the launches
    of #6's one-sided entries on these paths."""
    from nmftpu_torch.algorithms import build_dense_update
    from nmftpu_torch.kernels import dual_numer as DN
    from nmftpu_torch.kernels import quantized as Q
    from nmftpu_torch.linalg import dense as D

    r = W0.shape[1]
    total = {"vht_int8": 0, "wtv_int8": 0}
    Vq, scale = Q.quantize_v(V)
    stored = {"float32": V.double(), "bfloat16": V.to(torch.bfloat16).double(),
              "int8": Vq.double() * scale.double()}
    S = D.nsnmf_smoothing_matrix(r, 0.5, device=dev)
    # -- 21 (a): 4096^2 / r = 256, 50 iterations each -----------------------
    for alg, obj, kn in FAMILY:
        kl = obj == "kullback-leibler"
        for storage in ("float32", "bfloat16", "int8"):
            label = f"{alg}{' kl' if kl else ''} {storage}"
            knobs = dict(algorithm=alg, objective=obj, v_storage=storage,
                         **kn)
            make_aux, update, eff = build_dense_update(
                nt.NmfConfig(rank=r, **knobs))
            aux = make_aux(V)
            e0 = float(D.frobenius_error(V, W0, eff(aux, H0)))
            res, launched, peak, secs = family_run(
                nt, DN, label, V, r, W0, H0, FAMILY_ITERS, **knobs)
            for k in total:
                total[k] += launched[k]
            int8_entries = storage == "int8" and not kl
            want = FAMILY_ITERS if int8_entries else 0
            ms = cuda_ms(lambda: update(V, aux, W0, H0), iters=5)
            errs = res.stats.errors
            # one step, each half from the same inputs, against float64
            W1, H1 = update(V, aux, W0, H0)
            shifts = family_shifts(alg, kn, storage, r)
            checks = {}
            for side, got, Wi in (("w", W1, W0), ("h", H1, W1)):
                if alg in ("als", "acls", "ahcls") or (alg == "gdcls"
                                                       and side == "h"):
                    sh, off = ((shifts[0], shifts[2]) if side == "w"
                               else (shifts[1], shifts[3]))
                    gram, rhs, gram64, rhs64 = family_ls_terms(
                        storage, side, aux, V, Wi, H0)
                    rel, kappa = family_solve_check(label, side, got, gram,
                                                    rhs, sh, off)
                    products = max(
                        float((x.double() - x64).abs().max()
                              / x64.abs().max())
                        for x, x64 in ((gram, gram64), (rhs, rhs64)))
                    checks[side] = (rel, SOLVE_FACTOR * r ** 0.5 * kappa
                                    * 2.0 ** -24, kappa, products)
                    if storage == "float32" and (alg, side) in (
                            ("als", "w"), ("acls", "h")):
                        solver_spread(D, f"{alg} {side}", gram + (
                            sh + 1e-9) * torch.eye(r, device=dev) + off,
                            rhs)
                    continue
                # bf16 MU-type steps (and int8 KL's bf16 panels) are held
                # on the unrounded factors
                mu_bf16 = storage == "bfloat16" or (storage == "int8"
                                                    and kl)
                want64 = family_mu64(alg, kl, side, stored[storage], Wi, H0,
                                     S, "float32" if mu_bf16 else storage)
                rel = float((got.double() - want64).abs().max()
                            / want64.abs().max())
                checks[side] = (rel, FAMILY_BF16_RTOL if mu_bf16
                                else FAMILY_MU_RTOL, None, None)
            say("21 family 4096^2 r=256", run=label,
                errors_0_1_50=[f"{e0:.6g}", f"{errs[0]:.6g}",
                               f"{errs[-1]:.6g}"],
                kl_error=res.kl_error, ms_per_iter=f"{ms:.4f}",
                peak_GiB=f"{peak:.2f}", seconds=f"{secs:.3f}",
                launches=launched, expected_each=want, card=card)
            for side, (rel, limit, kappa, products) in checks.items():
                extra = {} if kappa is None else {
                    "kappa": f"{kappa:.4g}",
                    "gram_rhs_vs_float64": f"{products:.3e}",
                    "products_limit": FAMILY_MU_RTOL}
                say("21 step vs float64", run=label, half=side,
                    rel_err=f"{rel:.3e}", limit=f"{limit:.3e}", **extra)
                if not rel <= limit:
                    fail(f"{label}: the {side} half-step is off by {rel:.3e} "
                         f"against float64, above {limit:.3e}")
                if products is not None and not products <= FAMILY_MU_RTOL:
                    fail(f"{label}: the {side} half-step's Gram or "
                         f"right-hand side is off by {products:.3e} "
                         "against float64")
            if not errs[-1] < e0:
                fail(f"{label}: the error did not fall from iteration 0 to "
                     f"{FAMILY_ITERS}: {e0} -> {errs[-1]}")
            if launched != {"vht_int8": want, "wtv_int8": want}:
                fail(f"{label}: #6's one-sided entries launched {launched}, "
                     f"not {want} each")
            if int8_entries:
                check_int8_rhs(DN, D, label, Vq,
                               H0 if alg != "nsnmf" else S @ H0,
                               W1 if alg != "nsnmf" else W1 @ S)
            del res, aux, W1, H1
    del stored
    torch.cuda.empty_cache()

    # -- 21 (b): the ML-20M shape, dense, r = 64, 10 iterations -------------
    n5, m5, r5, nnz = ML20M
    t0 = time.perf_counter()
    R = synthetic_ratings(n5, m5, nnz, torch.Generator(device=dev)
                          .manual_seed(SEED + 5), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    W5 = torch.rand(n5, r5, generator=gen, device=dev) + 0.01
    H5 = torch.rand(r5, m5, generator=gen, device=dev) + 0.01
    Vq5, scale5 = Q.quantize_v(R)
    # the int8 runs and their float32 twins take the dequantized ratings,
    # whose quantization gives the ratings' integers back, so that both
    # report their error against the same V
    R_dq = Vq5.float() * scale5
    if not torch.equal(Q.quantize_v(R_dq)[0], Vq5):
        fail("the dequantized ratings do not quantize to the same integers")
    del Vq5
    torch.cuda.synchronize()
    say("21 ML-20M data", shape=f"{n5}x{m5}", rank=r5,
        seconds=f"{time.perf_counter() - t0:.2f}")
    S5 = D.nsnmf_smoothing_matrix(r5, 0.5, device=dev)
    for alg, obj, kn in FAMILY:
        if alg not in ("als", "gdcls") and not (alg == "nsnmf"
                                                and obj == "frobenius"):
            continue
        for storage, source in (("int8", R_dq), ("bfloat16", R)):
            label = f"{alg} {storage}"
            knobs = dict(algorithm=alg, objective=obj, **kn)
            res, launched, peak, secs = family_run(
                nt, DN, f"ML-20M {label}", source, r5, W5, H5,
                FAMILY_ML_ITERS, v_storage=storage, **knobs)
            for k in total:
                total[k] += launched[k]
            want = FAMILY_ML_ITERS if storage == "int8" else 0
            ref, _, _, _ = family_run(nt, DN, f"ML-20M {alg} float32", source,
                                      r5, W5, H5, FAMILY_ML_ITERS, **knobs)
            make_aux, update, eff = build_dense_update(
                nt.NmfConfig(rank=r5, v_storage=storage, **knobs))
            aux = make_aux(source)
            e0 = float(D.frobenius_error(source, W5, eff(aux, H5)))
            ms = cuda_ms(lambda: update(source, aux, W5, H5), iters=3)
            errs, ref_errs = res.stats.errors, ref.stats.errors
            rel1 = abs(errs[0] / ref_errs[0] - 1)
            rel = abs(errs[-1] / ref_errs[-1] - 1)
            quant = {}
            if storage == "int8":
                # no int32 sum wrapped (n = 138,493 > 133,144) on the first
                # step's operands nor the last's; how coarse one scale
                # makes W's int8 copy at the end
                W1 = update(source, aux, W5, H5)[0]
                for tag, Wx, Hx in (("first", W1, H5),
                                    ("last", res.W, res.H)):
                    if alg == "nsnmf":
                        Wx, Hx = Wx @ S5, S5 @ Hx
                    check_int8_rhs(DN, D, f"ML-20M {label} {tag} step",
                                   aux[0], Hx, Wx)
                s_w, Wq = D.quantize_sym(res.W)
                w_err = torch.linalg.norm(res.W - Wq.float() * s_w)
                quant = {
                    "W_int8_rel_err":
                        f"{float(w_err / torch.linalg.norm(res.W)):.3e}",
                    "W_entries_at_0":
                        f"{float((Wq == 0).float().mean()):.3f}"}
            say("21 family ML-20M shape", run=label,
                errors_0_to_10=[f"{e:.7g}" for e in (e0, *errs)],
                float32_1_to_10=[f"{e:.7g}" for e in ref_errs],
                float32_on="dequantized ratings" if storage == "int8"
                else "ratings", rel_to_float32_1=f"{rel1:.3e}",
                rel_to_float32_10=f"{rel:.3e}", rtol=FAMILY_STORAGE_RTOL,
                held_at="1" if storage == "int8" else "10",
                ms_per_iter=f"{ms:.3f}", peak_GiB=f"{peak:.2f}",
                seconds=f"{secs:.3f}", launches=launched,
                expected_each=want, **quant, card=card)
            if not errs[-1] < e0:
                fail(f"ML-20M {label}: the error did not fall: {e0} -> "
                     f"{errs[-1]}")
            held = rel1 if storage == "int8" else rel
            if not held <= FAMILY_STORAGE_RTOL:
                fail(f"ML-20M {label}: the error is {held:.3e} from "
                     f"float32's (errors {errs.tolist()} against "
                     f"{ref_errs.tolist()})")
            if launched != {"vht_int8": want, "wtv_int8": want}:
                fail(f"ML-20M {label}: #6's one-sided entries launched "
                     f"{launched}, not {want} each")
            del res, ref, aux
    del R, R_dq, W5, H5, S5
    torch.cuda.empty_cache()

    # -- 21 (c): the k-means and NNDSVD inits at 4096^2 / r = 256 -----------
    from nmftpu_torch.init import kmeans as KM

    n, m = V.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    km_ms = cuda_ms(lambda: KM.kmeans_columns(V, r, gen, KMEANS_ITERS), 1)
    cols = torch.randperm(m, generator=gen, device=dev)[:r]
    c = V[:, cols]
    Vd = V.double()
    wcss = []
    for _ in range(KMEANS_ITERS):
        c, a = KM._lloyd(V, c, 1)
        wcss.append(float(((Vd - c.double()[:, a]) ** 2).sum()))
    rise = max([(b - a) / a for a, b in zip(wcss, wcss[1:])] + [0.0])
    say("21 kmeans", shape=f"{n}x{m}", rank=r, iterations=KMEANS_ITERS,
        ms=f"{km_ms:.3f}", wcss_first_last=[f"{wcss[0]:.6g}",
                                             f"{wcss[-1]:.6g}"],
        largest_relative_rise=f"{rise:.3e}", limit=KMEANS_RISE_RTOL,
        card=card)
    if not rise <= KMEANS_RISE_RTOL:
        fail(f"k-means: the within-cluster sum rose by {rise:.3e}")
    del Vd, c
    # the random and k-means inits through nmf; the NNDSVD variants from
    # one host SVD of V that they share (through nmf, a variant costs that
    # SVD plus its own host seconds printed here)
    from nmftpu_torch.init import nndsvd as ND

    inits = {}
    for init in ("random", "kmeans_random", "kmeans_nonnegative_wtv",
                 "kmeans_absolute_wtv"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = nt.nmf(V, r, init=init, num_iterations=0, device=dev)
        torch.cuda.synchronize()
        inits[init] = (res.W, res.H, res.error, time.perf_counter() - t0)
    Vh = V.cpu().numpy()
    t0 = time.perf_counter()
    svd = ND._truncated_svd(Vh, r)
    say("21 init", init="the NNDSVD variants' SVD", shape=f"{n}x{m}",
        rank=r, host_seconds=f"{time.perf_counter() - t0:.3f}")
    for init in ("nndsvd", "nndsvda", "nndsvdar"):
        t0 = time.perf_counter()
        Wn, Hn = (torch.as_tensor(x, dtype=V.dtype, device=dev) for x in
                  ND._nndsvd_from_svd(Vh, *svd, variant=init, eps=1e-6,
                                      seed=SEED))
        torch.cuda.synchronize()
        inits[init] = (Wn, Hn, float(D.frobenius_error(V, Wn, Hn)),
                       time.perf_counter() - t0)
    del Vh, svd
    for init, (Wi, Hi, err, secs) in inits.items():
        nonneg = bool((Wi >= 0).all() and (Hi >= 0).all())
        say("21 init", init=init, shape=f"{n}x{m}", rank=r,
            host_seconds=f"{secs:.3f}", error=f"{err:.6g}",
            nonnegative=nonneg)
        if not nonneg or not np.isfinite(err):
            fail(f"init {init}: negative or non-finite factors")
    e_rand = inits["random"][2]
    for init in ("nndsvd", "nndsvdar"):
        if not inits[init][2] < e_rand:
            fail(f"init {init}: initial error {inits[init][2]} is not "
                 f"below all_random_values' {e_rand}")
    # nndsvda fills nndsvd's zeros with mean(V), which puts its start above
    # the random one: it is held to that construction instead
    mean_v = float(np.mean(V.cpu().numpy()))
    for core, filled in zip(inits["nndsvd"][:2], inits["nndsvda"][:2]):
        want = torch.where(core > 0, core, torch.tensor(mean_v, device=dev))
        if not torch.equal(filled, want):
            fail("init nndsvda is not nndsvd with its zeros at mean(V)")
    say("21 init checks", random_error=f"{e_rand:.6g}",
        nndsvd_below_random=True, nndsvdar_below_random=True,
        nndsvda_is_nndsvd_filled_with_mean=True,
        nndsvda_error=f"{inits['nndsvda'][2]:.6g}")
    del inits, res

    # -- 21 (d): BASELINE config 1, every algorithm from every init ---------
    from nmftpu_torch.data import load_movielens

    fixture = load_movielens(str(HERE / "tests" / "fixtures" /
                                 "ml100k_u.data")).matrix.todense()
    n1, m1, nnz1 = CONFIG1
    rng = np.random.default_rng(SEED + 23)
    config1 = np.zeros(n1 * m1, np.float32)
    config1[rng.choice(n1 * m1, nnz1, replace=False)] = rng.integers(
        1, 6, nnz1)
    config1 = config1.reshape(n1, m1)
    algs = (("mu", "frobenius", {}), ("hals", "frobenius", {})) + FAMILY
    for data, X, rank in (("fixture", fixture, CONFIG1_FIXTURE_RANK),
                          ("config 1 shape", config1, CONFIG1_RANK)):
        X = X.astype(np.float32)
        rmsd_zero = float(np.sqrt(np.mean(X.astype(np.float64) ** 2)))
        rng = np.random.default_rng(SEED)
        copy_from = {"W0": rng.uniform(0.1, 1.0, (X.shape[0], rank)),
                     "H0": rng.uniform(0.1, 1.0, (rank, X.shape[1]))}
        t0 = time.perf_counter()
        for alg, obj, kn in algs:
            name = f"{alg}{'-kl' if obj == 'kullback-leibler' else ''}"
            row = {}
            for init in ("copy", "random", "mean_columns", "kmeans_random",
                         "kmeans_nonnegative_wtv", "kmeans_absolute_wtv",
                         "nndsvd", "nndsvda", "nndsvdar"):
                res = nt.nmf(X, rank, algorithm=alg, objective=obj,
                             init=init, num_iterations=CONFIG1_ITERS,
                             seed=1, device=dev, **kn,
                             **(copy_from if init == "copy" else {}))
                if not (np.isfinite(res.rmsd) and res.rmsd < rmsd_zero):
                    fail(f"{data} {name} from {init}: RMSD {res.rmsd} (the "
                         f"zero model's is {rmsd_zero})")
                row[init] = f"{res.rmsd:.5f}"
            say("21 config 1", data=data, algorithm=name, rank=rank,
                iterations=CONFIG1_ITERS, final_rmsd=row)
        say("21 config 1", data=data, shape=f"{X.shape[0]}x{X.shape[1]}",
            nonzeros=int(np.count_nonzero(X)),
            zero_model_rmsd=f"{rmsd_zero:.5f}",
            seconds=f"{time.perf_counter() - t0:.2f}")
    return total


def refusal(fn, *args) -> str:
    """The message of the ValueError that fn(*args) raises, '' if none."""
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return ""


def sparse_shifts(alg, kn, r):
    """(shift_w, shift_h, off_w, off_h) of a solve on a sparse engine: the
    float64 shifts of linalg.dense._als_family_shifts, or GDCLS's Tikhonov
    term on the H side."""
    import nmftpu_torch as nt
    from nmftpu_torch.linalg import dense as D

    if alg == "gdcls":
        return 0.0, kn["lambda_tik"], 0.0, 0.0
    return D._als_family_shifts(nt.NmfConfig(rank=r, algorithm=alg, **kn))


def engine_ls_terms(strategy, op, side, W, H):
    """The Gram and the right-hand side (r, n_pad or m) of a solve
    half-step as the engine forms them on the card: the ELL or scatter
    SpMM, the densified bf16 contraction, or the int8 entries."""
    from nmftpu_torch import densified as DF
    from nmftpu_torch import sparse_ell as SE
    from nmftpu_torch import sparse_ops as TS
    from nmftpu_torch.linalg import dense as D

    if strategy == "int8":
        fn = D._ls_terms_w_int8 if side == "w" else D._ls_terms_h_int8
        return fn(op[0], op[1], H if side == "w" else W)
    gram = H @ H.T if side == "w" else W.T @ W
    if strategy == "ell":
        rhs = (SE.v_ht_ell(op.rows, H).T if side == "w"
               else SE.wt_v_ell(op, W))
    elif strategy == "scatter":
        rhs = TS.v_ht(op, H).T if side == "w" else TS.wt_v(op, W)
    else:
        rhs = DF._big_vht(op, H).T if side == "w" else DF._big_wtv(W, op)
    return gram, rhs


def engine_step_checks(label, strategy, op, n_pad, alg, kl, kn, S, lines,
                       rows, cols, W0, H0, W1, H1) -> list:
    """One step of a rule (order "WH", each half from the inputs it
    used: W from (W0, H0), H from (W1, H0)) on 64 rows and 64 columns
    against float64: a solve against the float64 solve of the card's
    own Gram and right-hand side at SOLVE_FACTOR sqrt(r) kappa 2^-24,
    the Gram and the right-hand side against float64 products of the
    operands the step rounds at S12_MU_RTOL; an MU-type half against
    a float64 recomputation at S12_MU_RTOL (bf16: FAMILY_BF16_RTOL).
    `lines` holds V's stored rows and columns in float64. Returns
    (half, rel, limit, kappa or None, products or None) per half."""
    r = W0.shape[1]
    n = W1.shape[0]
    storage = {"int8": "int8", "densified bf16": "bfloat16"}.get(
        strategy, "float32")
    engine = {"int8": "int8", "densified bf16": "bf16"}.get(strategy,
                                                            strategy)
    Vr, Vc = lines
    sw, sh, ow, oh = (sparse_shifts(alg, kn, r) if alg != "nsnmf"
                      else (0.0,) * 4)
    solves = {"w": alg in ("als", "acls", "ahcls"),
              "h": alg in ("als", "acls", "ahcls", "gdcls")}
    out = []
    for side, got, Wi in (("w", W1[rows], W0), ("h", H1[:, cols], W1)):
        if solves[side]:
            Wp = torch.nn.functional.pad(Wi, (0, 0, 0, n_pad - n))
            gram, rhs = engine_ls_terms(engine, op, side, Wp, H0)
            rhs = rhs[:, rows] if side == "w" else rhs[:, cols]
            sh_, off = (sw, ow) if side == "w" else (sh, oh)
            rel, kappa = family_solve_check(label, side, got, gram, rhs,
                                            sh_, off)
            Pop = family_operand(H0 if side == "w" else Wi, storage)
            P64 = Pop if storage == "int8" else (
                H0 if side == "w" else Wi).double()
            if side == "w":
                gram64, rhs64 = P64 @ P64.T, Pop @ Vr.T
            else:
                gram64, rhs64 = P64.T @ P64, Pop.T @ Vc
            products = max(float((x.double() - x64).abs().max()
                                 / x64.abs().max())
                           for x, x64 in ((gram, gram64), (rhs, rhs64)))
            out.append((side, rel, SOLVE_FACTOR * r ** 0.5 * kappa
                        * 2.0 ** -24, kappa, products))
            continue
        mu_bf16 = storage == "bfloat16" or (storage == "int8" and kl)
        if side == "w":
            want = family_mu64(alg, kl, "w", Vr, W0[rows], H0, S,
                               "float32" if mu_bf16 else storage)
        else:
            want = family_mu64(alg, kl, "h", Vc, Wi, H0[:, cols], S,
                               "float32" if mu_bf16 else storage)
        rel = float((got.double() - want).abs().max() / want.abs().max())
        out.append((side, rel, FAMILY_BF16_RTOL if mu_bf16 else S12_MU_RTOL,
                    None, None))
    return out


def hals_step_error(D, lines, rows, cols, W0, H0, W1, H1) -> float:
    """One HALS step (order "WH") on 64 rows and 64 columns against the
    strictly sequential sweep in float64 (rows of W, and of Hᵀ, sweep
    independently): max|a - b| / max|b| of the two samples."""
    Vr, Vc = lines
    H64, W164 = H0.double(), W1.double()
    want_w = D._hals_half_sweep(Vr @ H64.T, H64 @ H64.T, W0[rows].double())
    want_h = D._hals_half_sweep(Vc.T @ W164, W164.T @ W164,
                                H0[:, cols].T.double())
    return max(float((W1[rows].double() - want_w).abs().max()
                     / want_w.abs().max()),
               float((H1[:, cols].T.double() - want_h).abs().max()
                     / want_h.abs().max()))


def row_systems64(csr, idx, P, alpha, lam, masked, eps=1e-9, x0=None,
                  cg_steps=None):
    """The per-row normal equations of iALS (c = 1 + alpha v) or masked
    ALS (0/1 weight, no base Gram) for rows `idx` of a host CSR, in
    float64 from its triplets (P the (m, r) table of the partner), with
    the float32 path's ridge (shift + eps + max(eps, 100 2^-23) mean
    diagonal), solved by LU, or by `cg_steps` steps of the port's
    Jacobi-preconditioned CG from the rows x0, and clamped: (solutions
    (k, r), kappas (k,))."""
    P64 = P.double()
    r = P.shape[1]
    base = None if masked else P64.T @ P64
    eye = torch.eye(r, dtype=torch.float64, device=P.device)
    As, rhss = [], []
    for u in idx:
        a, b = csr.indptr[u], csr.indptr[u + 1]
        T = P64[torch.as_tensor(csr.indices[a:b].astype(np.int64),
                                device=P.device)]
        v = torch.as_tensor(csr.data[a:b].astype(np.float64), device=P.device)
        w = (v != 0).double() if masked else alpha * v
        A = (T.T * w) @ T
        if base is not None:
            A = A + base
        rhs = T.T @ (v if masked else v * (1.0 + alpha * v))
        ridge = lam + eps + max(eps, 100 * 2.0 ** -23) * float(
            torch.trace(A)) / r
        As.append(A + ridge * eye)
        rhss.append(rhs)
    A, rhs = torch.stack(As), torch.stack(rhss)
    if cg_steps is None:
        x = torch.linalg.solve(A, rhs[..., None])[..., 0]
    else:
        dinv = 1.0 / torch.diagonal(A, dim1=1, dim2=2)
        x = x0.double()
        res = rhs - torch.einsum("nij,nj->ni", A, x)
        z = dinv * res
        p = z
        rz = torch.sum(res * z, dim=1, keepdim=True)
        for _ in range(cg_steps):
            Ap = torch.einsum("nij,nj->ni", A, p)
            den = torch.sum(p * Ap, dim=1, keepdim=True)
            step = torch.where(den > 0, rz / torch.where(den > 0, den, 1.0),
                               0.0)
            x = x + step * p
            res = res - step * Ap
            z = dinv * res
            rz2 = torch.sum(res * z, dim=1, keepdim=True)
            p = z + torch.where(rz > 0, rz2 / torch.where(rz > 0, rz, 1.0),
                                0.0) * p
            rz = rz2
    return torch.clamp(x, min=0.0), torch.linalg.cond(A)


def per_row_check(got, want, kappas, r, extra=None, scale=1.0) -> tuple:
    """Each row's max|a - b| / max|b| (0 where both are 0) against its
    own SOLVE_FACTOR sqrt(r) kappa 2^-24 (+ `extra` kappa, the
    propagated difference of an input), times `scale` (2 for two float32
    solves, each within the limit of float64): (worst ratio, worst rel,
    its kappa)."""
    diff = (got.double() - want).abs().amax(dim=1)
    top = torch.maximum(want.abs().amax(dim=1), got.double().abs().amax(
        dim=1)).clamp_min(torch.finfo(torch.float64).tiny)
    rel = diff / top
    limit = SOLVE_FACTOR * r ** 0.5 * kappas * 2.0 ** -24
    if extra is not None:
        limit = limit + kappas * extra
    limit = scale * limit
    k = int(torch.argmax(rel / limit))
    return float((rel / limit)[k]), float(rel[k]), float(kappas[k])


def cg_step_check(got, refs, csr, idx, table, x0, alpha, lam, steps):
    """A matrix-free CG half-step's rows `idx` of a host CSR (got, on the
    kernel routes) against `steps` steps of float64 CG from x0 on the
    rows' formed systems (`row_systems64`): the error, max|x - x64| /
    max|x64| over the rows together (as the card test and the benchmark's
    `w_gap` normalize), at most CG_F32_PER_KAPPA times the largest kappa
    of the rows. The float32 routes in `refs` are measured the same way,
    for the reader. Returns (ratio to the limit, error, kappa, the
    largest of the refs' errors)."""
    sel = torch.as_tensor(idx, device=got.device)
    want, kappas = row_systems64(csr, idx, table, alpha, lam, False,
                                 x0=x0[sel], cg_steps=steps)
    top = float(want.abs().max())
    err, ref_err = (max(float((x[sel].double() - want).abs().max()) / top
                        for x in xs) for xs in ([got], refs))
    kappa = float(kappas.max())
    return err / (CG_F32_PER_KAPPA * kappa), err, kappa, ref_err


def sparse_algorithms_phase(nt, card, dev, ratings, c3, V, W0d, H0d) -> dict:
    """Phase 22 (slices 4b-ii and 4c): the ALS family, GDCLS, nsNMF and
    HALS on sparse V at config 2's full width on every engine (a);
    iALS at config 3's full size on ELL and scatter (b); masked ALS at
    config 2 on ELL and scatter (c); dense iALS at 4096^2 / r = 256
    (phase 4's V, W0d, H0d) (d); the sparse k-means and NNDSVD inits
    (e). Returns the launches of #6's one-sided entries and #7 on these
    paths, #12's on the ELL iALS run, #7's largest difference from its
    twin, its ms and bound at 138,493 x 64."""
    import os

    from nmftpu_torch import sparse_ell as SE
    from nmftpu_torch import sparse_ops as TS
    from nmftpu_torch.algorithms import build_dense_update
    from nmftpu_torch.config import Initialization, NmfConfig
    from nmftpu_torch.init import kmeans as KM
    from nmftpu_torch.init import nndsvd as ND
    from nmftpu_torch.kernels import dual_numer as DN
    from nmftpu_torch.kernels import hals_sweep as HS
    from nmftpu_torch.kernels import ell_gram as EG
    from nmftpu_torch.kernels import row_solve as RS
    from nmftpu_torch.kernels import sparse_ell_kernel as SEK
    from nmftpu_torch.linalg import dense as D

    t_phase = time.perf_counter()
    # -- 22 (a): config 2, r = 64, every rule on every engine ---------------
    n, m = ratings.shape
    r = SPARSE_RANK
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    scale = (float(ratings.data.sum(dtype=np.float64)) / (n * m) / r) ** 0.5
    W0 = (torch.rand(n, r, generator=gen, device=dev) + 1e-4) * scale
    H0 = (torch.rand(r, m, generator=gen, device=dev) + 1e-4) * scale
    csc = ratings.T.to_csr()
    rng = np.random.default_rng(SEED + 22)
    top_user = int(np.argmax(np.diff(ratings.indptr)))
    top_item = int(np.argmax(np.diff(csc.indptr)))
    rows = np.concatenate([[top_user], rng.choice(
        np.setdiff1d(np.arange(n), [top_user]), 63, replace=False)])
    cols = np.concatenate([[top_item], rng.choice(
        np.setdiff1d(np.arange(m), [top_item]), 63, replace=False)])
    lines = (dense_lines(ratings, rows, dev), dense_lines(csc, cols, dev).T)
    S = D.nsnmf_smoothing_matrix(r, 0.5, device=dev)

    def cfg(alg, obj, kn, iters=1, **knobs):
        return NmfConfig(rank=r, algorithm=alg, objective=obj,
                         init_method=Initialization.COPY_EXISTING,
                         num_iterations=iters, check_interval=1, **kn,
                         **knobs)

    t0 = time.perf_counter()
    plans = {"ell": nt.prepare_sparse(ratings, NmfConfig(rank=r),
                                      strategy="ell", device=dev),
             "scatter": nt.prepare_sparse(ratings, NmfConfig(rank=r),
                                          strategy="scatter", device=dev)}
    torch.cuda.synchronize()
    say("22 plans", engines="ell, scatter", shape=f"{n}x{m}",
        nnz=ratings.nnz, rank=r, prepare_s=f"{time.perf_counter() - t0:.2f}")
    resolved = {
        "als": TS._resolve_strategy(ratings, cfg("als", "frobenius", {}),
                                    "auto", n, m),
        "hals": TS._resolve_strategy(ratings, cfg("hals", "frobenius", {}),
                                     "auto", n, m)}
    say("22 auto", resolved=resolved)
    if resolved != {"als": "densified", "hals": "scatter"}:
        fail(f"config 2: auto resolved {resolved}, not densified for the "
             "ALS family and scatter for HALS")

    finals, halves, it_ms = {}, {}, {}
    int8_launches = {"vht_int8": 0, "wtv_int8": 0}
    hals = {}

    def run_rule(label, engine, plan, alg, obj, kn, storage):
        """Four chained one-iteration runs from (W0, H0) (each reads its
        objective), the step checks, one iteration's ms; returns (W1, H1,
        objectives)."""
        kl = obj == "kullback-leibler"
        knobs = {"v_storage": "int8"} if storage == "int8" else {}
        config = cfg(alg, obj, kn, **knobs)
        bundle = plan._bundle(config)
        op = plan.operand
        aux = bundle.make_aux(op)
        Wp = torch.nn.functional.pad(W0, (0, 0, 0, plan.n_pad - n))
        He = bundle.effective_h(aux, H0)
        objs = [float(bundle.kl(op, aux, Wp, He) if kl else bundle.frobenius(
            op, aux, Wp, He, bundle.sum_v_sq(op)))]
        DN.LAUNCHES.update(vht_int8=0, wtv_int8=0)
        HS.LAUNCHES["hals_sweep"] = 0
        W, H = W0, H0
        for it in range(S12_ITERS):
            res = plan.run(config, W0=W, H0=H)
            if it == 0:
                W1, H1 = res.W, res.H
            W, H = res.W, res.H
            objs.append(res.kl_error if kl else res.frobenius_error)
        launched = {k: DN.LAUNCHES[k] for k in int8_launches}
        hals_launched = HS.LAUNCHES["hals_sweep"]
        ms = event_ms(lambda: bundle.update(op, aux, Wp, H0), 1)
        it_ms[f"{engine} {label}"] = ms
        finite = bool(torch.isfinite(W).all() and torch.isfinite(H).all())
        falls = all(b < a for a, b in zip(objs[:-1], objs[1:]))
        say("22 config 2", run=label, engine=engine, strategy=plan.strategy,
            iterations=S12_ITERS, objective="kl" if kl else "frobenius",
            values=[f"{x:.9g}" for x in objs], falls_each=falls,
            ms_per_iter=f"{ms:.3f}", launches_6=launched,
            launches_7=hals_launched, finite=finite, card=card)
        if not (finite and np.isfinite(objs).all()):
            fail(f"config 2 {label} {engine}: non-finite factors or "
                 f"objective {objs}")
        # nsNMF's MU and HALS's coordinate steps descend; the clamped
        # solves of the ALS family and GDCLS's H step need not (nmftpu's
        # trajectory too: test_clamped_als_family_need_not_descend), so
        # theirs is printed and their steps are held against float64
        if alg in ("nsnmf", "hals") and not falls:
            fail(f"config 2 {label} {engine}: the objective did not fall "
                 f"at every iteration: {objs}")
        if alg == "hals":
            checks = [("w+h", hals_step_error(D, lines, rows, cols, W0, H0,
                                              W1, H1), HALS_STEP_RTOL,
                       None, None)]
            hals.update(launches=hals_launched, W1=W1)
        else:
            strategy = {"densified": "densified bf16"}.get(plan.strategy,
                                                           plan.strategy)
            if storage == "int8":
                strategy = "int8"
            lines_x = lines
            if storage == "int8":
                s = op[1]
                lines_x = tuple((torch.round(x.float() / s).clamp(-127, 127)
                                 * s).double() for x in lines)
            checks = engine_step_checks(label, strategy, op, plan.n_pad, alg,
                                        kl, kn, S, lines_x, rows, cols, W0,
                                        H0, W1, H1)
        for side, rel, limit, kappa, products in checks:
            extra = {} if kappa is None else {
                "kappa": f"{kappa:.4g}",
                "gram_rhs_vs_float64": f"{products:.3e}",
                "products_limit": S12_MU_RTOL}
            say("22 step vs float64", run=label, engine=engine, half=side,
                rel_err=f"{rel:.3e}", limit=f"{limit:.3e}", **extra)
            if not rel <= limit:
                fail(f"config 2 {label} {engine}: the {side} half-step is "
                     f"off by {rel:.3e} against float64 (> {limit:.3e})")
            if products is not None and not products <= S12_MU_RTOL:
                fail(f"config 2 {label} {engine}: the {side} Gram or "
                     f"right-hand side is off by {products:.3e}")
        if storage == "int8":
            if launched != {"vht_int8": S12_ITERS, "wtv_int8": S12_ITERS}:
                fail(f"config 2 {label} int8: #6's one-sided entries "
                     f"launched {launched}, not {S12_ITERS} each")
            for k in int8_launches:
                int8_launches[k] += launched[k]
            Vq = op[0]
            W1p = torch.nn.functional.pad(W1, (0, 0, 0, plan.n_pad - n))
            check_int8_rhs(DN, D, f"22 {label}", Vq,
                           H0 if alg != "nsnmf" else S @ H0,
                           W1p if alg != "nsnmf" else W1p @ S)
        elif alg != "hals" and launched != {"vht_int8": 0, "wtv_int8": 0}:
            fail(f"config 2 {label} {engine}: #6 launched {launched}")
        return W1, H1, objs

    rules = [(alg, obj, kn) for alg, obj, kn in FAMILY]
    for engine in ("ell", "scatter", "densified bf16", "densified int8"):
        if engine.startswith("densified"):
            storage = "int8" if engine.endswith("int8") else "bfloat16"
            knobs = {"v_storage": "int8"} if storage == "int8" else {}
            t0 = time.perf_counter()
            plan = nt.prepare_sparse(
                ratings, cfg("als", "frobenius", {}, **knobs),
                strategy="auto" if storage == "bfloat16" else "densified",
                device=dev)
            torch.cuda.synchronize()
            if plan.strategy != "densified":
                fail(f"config 2 {engine}: the plan is {plan.strategy!r}")
            say("22 plans", engine=engine, prepare_s=
                f"{time.perf_counter() - t0:.2f}")
        else:
            plan, storage = plans[engine], "float32"
        for alg, obj, kn in rules:
            kl = obj == "kullback-leibler"
            if storage == "int8" and kl:
                continue  # the Frobenius family on int8
            label = f"{alg}{' kl' if kl else ''}"
            W1, H1, objs = run_rule(label, engine, plan, alg, obj, kn,
                                    storage)
            finals[engine, label] = objs[-1]
            if engine in ("ell", "scatter"):
                # the H half from (W0, H0): order "HW", one iteration
                hw = plan.run(cfg(alg, obj, kn, update_order="HW"), W0=W0,
                              H0=H0)
                halves[engine, label] = (W1, hw.H)
        if engine == "scatter":
            label = "hals"
            run_rule(label, engine, plan, "hals", "frobenius", {}, storage)
        if engine.startswith("densified"):
            del plan
            torch.cuda.empty_cache()
    # ELL against scatter after one iteration, each half from (W0, H0): a
    # solve's difference is its own error (SOLVE_FACTOR sqrt(r) kappa
    # 2^-24) plus its right-hand sides' measured difference amplified by
    # kappa, times sqrt(r) from the 2-norm of a perturbation bound to the
    # largest entry (an item's column sums up to ~10^5 ratings in another
    # order: ~1e-5 apart)
    pair, coo = plans["ell"].operand, plans["scatter"].operand
    d_rhs = {"w": float((SE.v_ht_ell(pair.rows, H0) - TS.v_ht(coo, H0))
                        .abs().max() / TS.v_ht(coo, H0).abs().max()),
             "h": float((SE.wt_v_ell(pair, W0) - TS.wt_v(coo, W0)).abs()
                        .max() / TS.wt_v(coo, W0).abs().max())}
    for alg, obj, kn in rules:
        kl = obj == "kullback-leibler"
        label = f"{alg}{' kl' if kl else ''}"
        (We, He), (Ws, Hs) = halves["ell", label], halves["scatter", label]
        dw = float((We - Ws).abs().max() / Ws.abs().max())
        dh = float((He - Hs).abs().max() / Hs.abs().max())
        sw, sh, ow, oh = (sparse_shifts(alg, kn, r) if alg != "nsnmf"
                          else (0.0,) * 4)
        eye = torch.eye(r, dtype=torch.float64, device=dev)
        kw_ = float(torch.linalg.cond(H0.double() @ H0.double().T
                                      + (sw + 1e-9) * eye + ow))
        kh_ = float(torch.linalg.cond(W0.double().T @ W0.double()
                                      + (sh + 1e-9) * eye + oh))
        unit = SOLVE_FACTOR * r ** 0.5 * 2.0 ** -24
        lw = (kw_ * (unit + r ** 0.5 * d_rhs["w"])
              if alg in ("als", "acls", "ahcls") else S12_MU_RTOL)
        lh = (kh_ * (unit + r ** 0.5 * d_rhs["h"])
              if alg in ("als", "acls", "ahcls", "gdcls") else S12_MU_RTOL)
        d_bf16 = abs(finals["densified bf16", label] / finals["ell", label]
                     - 1)
        say("22 checks", run=label, ell_vs_scatter_W=f"{dw:.3e}",
            limit_W=f"{lw:.3e}", ell_vs_scatter_H=f"{dh:.3e}",
            limit_H=f"{lh:.3e}", kappa_W=f"{kw_:.4g}", kappa_H=f"{kh_:.4g}",
            rhs_ell_vs_scatter={k: f"{v:.3e}" for k, v in d_rhs.items()},
            densified_bf16_vs_ell_final=f"{d_bf16:.3e}",
            rtol=S12_ENGINES_RTOL)
        if not (dw <= lw and dh <= lh):
            fail(f"config 2 {label}: ELL and scatter differ after one "
                 f"iteration (W {dw:.3e} > {lw:.3e} or H {dh:.3e} > "
                 f"{lh:.3e})")
        if not d_bf16 <= S12_ENGINES_RTOL:
            fail(f"config 2 {label}: densified bf16's final objective is "
                 f"{d_bf16:.3e} from ELL's")
    del halves, pair
    # #7 on the HALS run's own operands against its blocked plain twin, and
    # its time at 138,493 x 64 beside the bound
    XHt, G = TS.v_ht(coo, H0), H0 @ H0.T
    got, want = HS.hals_sweep(XHt, G, W0), HS.hals_sweep_plain(XHt, G, W0)
    exact = HS.hals_sweep_plain(XHt.double(), G.double(), W0.double())
    torch.cuda.synchronize()
    hals_diff = float((got - want).abs().max())
    top = float(want.abs().max())
    f64_check("22", "hals_sweep", f"{n}x{r}", got, want, exact, scaled=True)
    t_ms = abba_ms({"kernel": lambda: HS.hals_sweep(XHt, G, W0),
                    "plain": lambda: HS.hals_sweep_plain(XHt, G, W0)},
                   iters=20)
    hals_bound = bound(2 * n * r * r, 3 * n * r * 4, F32_PEAK)
    say("22 hals_sweep", shape=f"{n}x{r}", max_abs=f"{hals_diff:.3e}",
        rel_to_max=f"{hals_diff / top:.3e}", bound=HALS_ATOL,
        launches=hals["launches"], expected=2 * S12_ITERS,
        ms=f"{t_ms['kernel']:.4f}", plain_ms=f"{t_ms['plain']:.4f}",
        bound_ms=f"{hals_bound[0]:.4f}", bound_by=hals_bound[1], card=card)
    if not hals_diff <= HALS_ATOL * top:
        fail("hals_sweep: the kernel disagrees with its twin on the sparse "
             "HALS run's operands")
    if hals["launches"] != 2 * S12_ITERS:
        fail(f"sparse HALS launched #7 {hals['launches']} times in "
             f"{S12_ITERS} iterations, not {2 * S12_ITERS}")
    del got, want, exact, XHt, G
    say("22 (a) ms per iteration", **{k: f"{v:.3f}" for k, v in
                                      it_ms.items()}, card=card)

    # -- 22 (c): masked ALS at config 2 on ELL and scatter -------------------
    masked = {}
    for engine in ("ell", "scatter"):
        plan = plans[engine]
        config = NmfConfig(rank=r, algorithm="als", mask="observed",
                           init_method=Initialization.COPY_EXISTING,
                           num_iterations=1, check_interval=1)
        bundle = plan._bundle(config)
        op = plan.operand
        start = float(bundle.frobenius(op, (), W0, H0, None)) / ratings.nnz \
            ** 0.5
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t_start = torch.cuda.Event(enable_timing=True)
        t_end = torch.cuda.Event(enable_timing=True)
        t_start.record()
        one = plan.run(config, W0=W0, H0=H0)
        t_end.record()
        t_end.synchronize()
        ms = t_start.elapsed_time(t_end)
        rmsd = [start, one.rmsd]
        W, H = one.W, one.H
        for _ in range(S12_ITERS - 1):
            res = plan.run(config, W0=W, H0=H)
            W, H = res.W, res.H
            rmsd.append(res.rmsd)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        want_w, kap_w = row_systems64(ratings, rows, H0.T, 0.0, 0.0, True)
        want_h, kap_h = row_systems64(csc, cols, one.W, 0.0, 0.0, True)
        cw = per_row_check(one.W[rows], want_w, kap_w, r)
        ch = per_row_check(one.H[:, cols].T, want_h, kap_h, r)
        say("22 masked als", engine=engine, rmsd=[f"{x:.7g}" for x in rmsd],
            ms_first_iter=f"{ms:.3f}", peak_GiB=f"{peak:.2f}",
            step_W_worst_ratio_to_limit=f"{cw[0]:.3e}",
            step_W_rel=f"{cw[1]:.3e}", step_W_kappa=f"{cw[2]:.4g}",
            step_H_worst_ratio_to_limit=f"{ch[0]:.3e}",
            step_H_rel=f"{ch[1]:.3e}", step_H_kappa=f"{ch[2]:.4g}",
            card=card)
        # the clamped completion solves need not lower the observed RMSD
        # from a random start (nmftpu's too: test_masked_als_need_not_
        # descend_from_a_random_start); the steps are held
        if not (np.isfinite(rmsd).all() and torch.isfinite(W).all()):
            fail(f"masked ALS {engine}: non-finite factors or RMSD {rmsd}")
        if not (cw[0] <= 1.0 and ch[0] <= 1.0):
            fail(f"masked ALS {engine}: one step is off from float64 beyond "
                 f"{SOLVE_FACTOR} sqrt(r) kappa 2^-24 (W {cw}, H {ch})")
        masked[engine] = (one.W, one.H, want_w, kap_w, want_h, kap_h)
    (We, He, *_), (Ws, Hs, _, kap_w, _, kap_h) = (masked["ell"],
                                                  masked["scatter"])
    dW = float((We - Ws).abs().max() / Ws.abs().max())
    cw = per_row_check(We[rows], Ws[rows].double(), kap_w, r)
    ch = per_row_check(He[:, cols].T, Hs[:, cols].T.double(), kap_h, r,
                       extra=dW)
    say("22 masked als", ell_vs_scatter_W_rows_worst_ratio=f"{cw[0]:.3e}",
        ell_vs_scatter_H_cols_worst_ratio=f"{ch[0]:.3e}",
        W_rel_whole=f"{dW:.3e}")
    if not (cw[0] <= 1.0 and ch[0] <= 1.0):
        fail(f"masked ALS: ELL and scatter differ beyond the limit (W {cw}, "
             f"H {ch})")
    del masked, We, He, Ws, Hs, plans, coo
    torch.cuda.empty_cache()

    # -- 22 (e), config 2: k-means on the full width -------------------------
    coo = TS.device_put_sparse(ratings, device=dev)
    coo64 = TS.device_put_sparse(ratings, dtype=torch.float64, device=dev)
    col_sq = float(TS.col_sums(coo64.with_values(coo64.values ** 2)).sum())
    gk = torch.Generator(device=dev).manual_seed(SEED + 22)
    km_ms = event_ms(lambda: TS.kmeans_columns_sparse(coo, r, gk,
                                                      KMEANS_ITERS), 1)
    c = TS.extract_columns(coo, torch.randperm(m, generator=gk,
                                               device=dev)[:r])
    wcss = []
    idx = torch.arange(m, device=dev)
    for _ in range(KMEANS_ITERS):
        c, a = TS._lloyd_sparse(coo, c, 1)
        c64 = c.double()
        cross = TS.wt_v(coo64, c64)[a, idx].sum()
        wcss.append(col_sq - 2.0 * float(cross)
                    + float((c64 * c64).sum(0)[a].sum()))
    rise = max([(b - a) / a for a, b in zip(wcss, wcss[1:])] + [0.0])
    say("22 sparse kmeans", shape=f"{n}x{m}", rank=r, rounds=KMEANS_ITERS,
        ms=f"{km_ms:.3f}", wcss_first_last=[f"{wcss[0]:.9g}",
                                             f"{wcss[-1]:.9g}"],
        largest_relative_rise=f"{rise:.3e}", limit=KMEANS_RISE_RTOL,
        card=card)
    if not rise <= KMEANS_RISE_RTOL:
        fail(f"sparse k-means: the within-cluster sum rose by {rise:.3e}")
    del coo, coo64, c, c64
    del lines, csc, W0, H0
    torch.cuda.empty_cache()

    # -- 22 (b): iALS at config 3's full size --------------------------------
    csr3, W3, H3 = c3["csr"], c3["W0"], c3["H0"]
    n3, m3 = csr3.shape
    r3, alpha = C3_RANK, C3_ALPHA
    csc3 = csr3.T.to_csr()
    trip = device_triplets(csr3, dev)
    need = (n3 + m3) * r3 * r3 * 4
    default = TS._default_weighted_gram_budget(dev)
    os.environ["NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES"] = str(SMALL_BUDGET)
    try:
        refused = refusal(TS._check_weighted_gram_budget, n3, m3, r3, dev)
    finally:
        os.environ.pop("NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES")
    admitted = refusal(TS._check_weighted_gram_budget, n3, m3, r3, dev)
    want_msg = (f"weighted ALS per-row Grams need ~{need / 2**30:.1f} GiB "
                f"((n+m)·r² f32) — over the {SMALL_BUDGET / 2**30:.1f} GiB "
                "budget")
    say("22 config 3 budget", need_GiB=f"{need / 2**30:.4f}",
        default_budget_GiB=f"{default / 2**30:.2f}",
        small_budget_GiB=SMALL_BUDGET / 2**30, refusal=refused[:80])
    if not refused.startswith(want_msg):
        fail(f"config 3 iALS: a {SMALL_BUDGET / 2**30:.0f} GiB budget does "
             f"not refuse it with the reference's message: {refused!r}")
    if admitted or default != torch.cuda.get_device_properties(
            dev).total_memory // 2:
        fail(f"config 3 iALS: the card's default budget ({default} bytes) "
             f"is not half its memory, or refuses: {admitted!r}")
    rng3 = np.random.default_rng(SEED + 222)
    u_top = int(np.argmax(np.diff(csr3.indptr)))
    i_top = int(np.argmax(np.diff(csc3.indptr)))
    rows3 = np.concatenate([[u_top], rng3.choice(
        np.setdiff1d(np.arange(n3), [u_top]), 63, replace=False)])
    cols3 = np.concatenate([[i_top], rng3.choice(
        np.setdiff1d(np.arange(m3), [i_top]), 63, replace=False)])
    obj0, mu1, mu4 = c3["mu_objective"]

    def cfg3(iters, **knobs):
        return NmfConfig(rank=r3, algorithm="als", alpha_confidence=alpha,
                         init_method=Initialization.COPY_EXISTING,
                         num_iterations=iters, check_interval=iters,
                         **knobs)

    ials, rs_launches, eg_launches = {}, {}, {}
    cg_launches = 0
    plan = None
    for engine, strategy, solver in (("ell", "auto", "exact"),
                                     ("ell", "auto", "cg"),
                                     ("scatter", "scatter", "exact")):
        knobs = {"als_solver": solver} if solver == "cg" else {}
        if plan is None or plan.strategy != engine:
            del plan
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            plan = nt.prepare_sparse(csr3, cfg3(1), strategy=strategy,
                                     device=dev)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            if plan.strategy != engine:
                fail(f"config 3 iALS: strategy={strategy!r} resolved to "
                     f"{plan.strategy!r}, not {engine!r}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t_start = torch.cuda.Event(enable_timing=True)
        t_end = torch.cuda.Event(enable_timing=True)
        RS.LAUNCHES["row_solve"] = 0     # the main path's iALS starts here
        EG.LAUNCHES["ell_gram"] = 0
        SEK.LAUNCHES["ell_cg"] = 0
        t_start.record()
        one = plan.run(cfg3(1, **knobs), W0=W3, H0=H3)
        t_end.record()
        t_end.synchronize()
        ms1 = t_start.elapsed_time(t_end)
        obj1 = weighted_objective(trip, one.W, one.H, alpha)
        objs = [obj0, obj1]
        if engine == "ell":
            res = plan.run(cfg3(S12_ITERS - 1, **knobs), W0=one.W, H0=one.H)
            objs.append(weighted_objective(trip, res.W, res.H, alpha))
            ials[engine, solver] = res.frobenius_error
            del res
        # #12 takes every exact half-step at r = 128, one launch each; cg
        # never reaches it
        iters = S12_ITERS if engine == "ell" else 1
        rs_launches[engine, solver] = RS.LAUNCHES["row_solve"]
        if rs_launches[engine, solver] != (2 * iters if solver == "exact"
                                           else 0):
            fail(f"config 3 iALS {engine} {solver}: {iters} iterations "
                 f"launched #12 {rs_launches[engine, solver]} times")
        # #13 builds every exact ELL half-step's Grams: one launch a half,
        # and one more where the half has split rows; the cg half-steps
        # build none (matrix-free: #11's CG rule, 3 + 1 launches a half)
        eg_launches[engine, solver] = EG.LAUNCHES["ell_gram"]
        per_iter = 0 if engine != "ell" or solver == "cg" else sum(
            1 + (EG.units_of(ell).splits.shape[0] > 0)
            for ell in (plan.operand.rows, plan.operand.cols))
        if eg_launches[engine, solver] != per_iter * iters:
            fail(f"config 3 iALS {engine} {solver}: {iters} iterations "
                 f"launched #13 {eg_launches[engine, solver]} times, not "
                 f"{per_iter * iters}")
        cg_want = 2 * (3 + 1) * iters if (engine, solver) == ("ell",
                                                             "cg") else 0
        if SEK.LAUNCHES["ell_cg"] != cg_want:
            fail(f"config 3 iALS {engine} {solver}: {iters} iterations "
                 f"launched #11's CG rule {SEK.LAUNCHES['ell_cg']} times, "
                 f"not {cg_want}")
        cg_launches += SEK.LAUNCHES["ell_cg"]
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        # one step per row against float64 normal equations solved by LU;
        # cg's 3 float32 steps leave their exact-arithmetic iterates by up
        # to ~10% on rows of kappa ~10^3 (the residual loses its digits
        # once the large eigen-direction is gone: nmftpu's float32 CG as
        # the port's), so the cg run's own first W half-step (#11's CG
        # rule, 3 steps from W3) is held to float64 CG from W3 on the same
        # rows, beside the plain matrix-free twin's half-step
        twin_err = None
        if solver == "exact":
            want_w, kap_w = row_systems64(csr3, rows3, H3.T, alpha, 0.0,
                                          False)
            want_h, kap_h = row_systems64(csc3, cols3, one.W, alpha, 0.0,
                                          False)
            checks = {"W": per_row_check(one.W[rows3], want_w, kap_w, r3),
                      "H": per_row_check(one.H[:, cols3].T, want_h, kap_h,
                                         r3)}
            ials[engine, "one"] = (one.W, one.H, kap_w, kap_h)
        else:
            # the float32 routes printed beside it: the plain matrix-free
            # twin and nmftpu's own, formed systems (plain Grams, then
            # row_solver's cg)
            twin = SE.cg_half_ell(plan.operand.rows, H3.T, W3, 0.0, 1e-9,
                                  alpha, 3)
            dG, rhs = SE.grams_and_rhs_ell(
                plan.operand.rows, H3.T, lambda v: alpha * v,
                lambda v: v * (1.0 + alpha * v))
            formed = D.row_solver("cg", 3)(H3 @ H3.T, dG, rhs, 0.0, 1e-9,
                                           W3)
            del dG, rhs
            *check, twin_err = cg_step_check(one.W, [twin, formed], csr3,
                                             rows3, H3.T, W3, alpha, 0.0, 3)
            checks = {"W_cg_3_steps": tuple(check)}
            del twin, formed
        say("22 config 3 ials", engine=engine, solver=solver,
            strategy=plan.strategy, weighted_objective=[f"{x:.9g}"
                                                        for x in objs],
            weighted_mu_objective_1_4=[f"{mu1:.9g}", f"{mu4:.9g}"],
            over_weighted_mu=[f"{o / mu:.4f}" for o, mu in zip(
                objs[1:], (mu1, mu4))],
            ms_first_iter_with_check=f"{ms1:.3f}", peak_GiB=f"{peak:.2f}",
            row_solve_launches=rs_launches[engine, solver],
            ell_gram_launches=eg_launches[engine, solver],
            ell_cg_launches=SEK.LAUNCHES["ell_cg"],
            cg_float32_routes_err_f64=("none" if twin_err is None
                                       else f"{twin_err:.3e}"),
            gram_need_GiB=f"{need / 2**30:.4f}", prepare_s=f"{prep_s:.2f}",
            **{f"step_{k}_worst_ratio_to_limit": f"{v[0]:.3e}"
               for k, v in checks.items()},
            **{f"step_{k}_rel_kappa": f"{v[1]:.3e}/{v[2]:.4g}"
               for k, v in checks.items()}, card=card)
        # clamped iALS from a random start need not descend, nor stay
        # below weighted MU (nmftpu's trajectory too: ROADMAP queue 3), so
        # the objectives are printed beside MU's; the steps are held
        if not (np.isfinite(objs).all() and torch.isfinite(one.W).all()):
            fail(f"config 3 iALS {engine} {solver}: non-finite factors or "
                 f"objective {objs}")
        if any(v[0] > 1.0 for v in checks.values()):
            fail(f"config 3 iALS {engine} {solver}: one step is off from "
                 f"float64 beyond its limit (exact: {SOLVE_FACTOR} sqrt(r) "
                 f"kappa 2^-24; cg: {CG_F32_PER_KAPPA} kappa): {checks}")
        del one
    del plan
    cg, ex = ials["ell", "cg"], ials["ell", "exact"]
    (We, He, kap_w, kap_h), (Ws, Hs, _, _) = (ials["ell", "one"],
                                              ials["scatter", "one"])
    dW = float((We - Ws).abs().max() / Ws.abs().max())
    cw = per_row_check(We[rows3], Ws[rows3].double(), kap_w, r3)
    ch = per_row_check(He[:, cols3].T, Hs[:, cols3].T.double(), kap_h, r3,
                       extra=dW)
    say("22 config 3 ials checks", cg_final_frobenius=f"{cg:.9g}",
        exact_final_frobenius=f"{ex:.9g}", cg_over_exact=f"{cg / ex:.4f}",
        cg_limit=IALS_CG_FACTOR,
        ell_vs_scatter_W_rows_worst_ratio=f"{cw[0]:.3e}",
        ell_vs_scatter_H_cols_worst_ratio=f"{ch[0]:.3e}",
        W_rel_whole=f"{dW:.3e}")
    if not cg <= IALS_CG_FACTOR * ex:
        fail(f"config 3 iALS: the cg run's error {cg} exceeds "
             f"{IALS_CG_FACTOR} x the exact run's {ex}")
    if not (cw[0] <= 1.0 and ch[0] <= 1.0):
        fail(f"config 3 iALS: ELL and scatter differ beyond the limit (W "
             f"{cw}, H {ch})")
    del ials, We, He, Ws, Hs, trip
    torch.cuda.empty_cache()

    # -- 22 (d): dense iALS at 4096^2 / r = 256 ------------------------------
    rd = W0d.shape[1]
    Vd = V.double()

    def dense_objective(W, H):
        R = Vd - W.double() @ H.double()
        return float(torch.sum((1.0 + C3_ALPHA * Vd) * R * R))

    kwd = dict(algorithm="als", alpha_confidence=C3_ALPHA, init="copy",
               num_iterations=1, check_interval=1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    objs = [dense_objective(W0d, H0d)]
    W, H = W0d, H0d
    for it in range(DENSE_IALS_ITERS):
        res = nt.nmf(V, rd, W0=W, H0=H, **kwd)
        if it == 0:
            W1d = res.W
        W, H = res.W, res.H
        objs.append(dense_objective(W, H))
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    _, update, _ = build_dense_update(NmfConfig(
        rank=rd, algorithm="als", alpha_confidence=C3_ALPHA))
    ms = cuda_ms(lambda: update(V, (), W0d, H0d), iters=1)
    rows_d = np.random.default_rng(SEED + 221).choice(V.shape[0], 64,
                                                      replace=False)
    H64 = H0d.double()
    C = 1.0 + C3_ALPHA * Vd[rows_d]
    A = torch.einsum("rm,um,sm->urs", H64, C, H64)
    rhs = (C * Vd[rows_d]) @ H64.T
    ridge = 1e-9 + max(1e-9, 100 * 2.0 ** -23) * torch.diagonal(
        A, dim1=1, dim2=2).sum(1)[:, None, None] / rd
    A = A + ridge * torch.eye(rd, dtype=torch.float64, device=dev)
    want = torch.clamp(torch.linalg.solve(A, rhs[..., None])[..., 0], min=0.0)
    cd = per_row_check(W1d[rows_d], want, torch.linalg.cond(A), rd)
    say("22 dense ials", shape=f"{V.shape[0]}x{V.shape[1]}", rank=rd,
        alpha=C3_ALPHA, weighted_objective=[f"{x:.9g}" for x in objs],
        ms_per_iter=f"{ms:.3f}", peak_GiB=f"{peak:.2f}",
        step_W_worst_ratio_to_limit=f"{cd[0]:.3e}",
        step_W_rel=f"{cd[1]:.3e}", step_W_kappa=f"{cd[2]:.4g}", card=card)
    if not all(b < a for a, b in zip(objs[:-1], objs[1:])):
        fail(f"dense iALS: the weighted objective did not fall: {objs}")
    if not cd[0] <= 1.0:
        fail(f"dense iALS: one step is off from float64: {cd}")
    del Vd, A, C, want, W1d, res
    torch.cuda.empty_cache()

    # -- 22 (e), config 1: sparse k-means and NNDSVD -------------------------
    from nmftpu_torch import sparse as host_sparse
    from nmftpu_torch.data.synthetic import synthetic_powerlaw_sparse

    n1, m1, nnz1 = CONFIG1
    sp = synthetic_powerlaw_sparse(n1, m1, 3 * nnz1, alpha_user=0.9,
                                   alpha_item=0.9, seed=SEED % 1000)
    if sp.nnz < nnz1:
        fail(f"config 1 power-law draw has {sp.nnz} distinct ratings")
    keep = np.sort(np.random.default_rng(SEED).choice(sp.nnz, nnz1,
                                                      replace=False))
    sp1 = host_sparse.SparseCOO(sp.row[keep], sp.col[keep], sp.data[keep],
                                sp.shape)
    dense1 = torch.zeros(sp1.shape, dtype=torch.float64, device=dev)
    dense1[torch.as_tensor(sp1.row.astype(np.int64), device=dev),
           torch.as_tensor(sp1.col.astype(np.int64), device=dev)] = \
        torch.as_tensor(sp1.data.astype(np.float64), device=dev)
    r1 = CONFIG1_RANK
    cols1 = torch.randperm(m1, generator=torch.Generator(device=dev)
                           .manual_seed(SEED + 223), device=dev)[:r1]
    agree = {}
    for dtype in (torch.float64, torch.float32):
        coo1 = TS.device_put_sparse(sp1, dtype=dtype, device=dev)
        Vx = dense1.to(dtype)
        cs, as_ = TS._lloyd_sparse(coo1, TS.extract_columns(coo1, cols1),
                                   KMEANS_ITERS)
        cdn, ad = KM._lloyd(Vx, Vx[:, cols1], KMEANS_ITERS)
        agree[str(dtype)] = (bool(torch.equal(as_, ad)),
                             float((cs - cdn).abs().max() / cdn.abs().max()))
    say("22 config 1 kmeans", shape=f"{n1}x{m1}", ratings=nnz1, rank=r1,
        rounds=KMEANS_ITERS, sparse_vs_dense_same_assign_and_rel=agree,
        held="float64", rtol=1e-5)
    if not (agree["torch.float64"][0]
            and agree["torch.float64"][1] <= 1e-5):
        fail(f"config 1: sparse k-means differs from the dense Lloyd: "
             f"{agree}")
    csr1 = TS.host_csr(TS.device_put_sparse(sp1, device=dev))
    t0 = time.perf_counter()
    ND._truncated_svd(csr1, r1)
    svds_s = time.perf_counter() - t0
    starts = {}
    for init in ("random", "nndsvd", "nndsvda", "nndsvdar"):
        res = nt.nmf(sp1, r1, init=init, num_iterations=0,
                     strategy="scatter", device=dev)
        starts[init] = (res.W, res.H, res.error)
    dense_nndsvd = nt.nmf(dense1.float(), r1, init="nndsvd",
                          num_iterations=0, device=dev).error
    # the fill as init.nndsvd takes it: the stored values' sum over n m
    mean_v = ND._mean(csr1)
    filled = all(torch.equal(f, torch.where(c_ > 0, c_, torch.tensor(
        mean_v, dtype=c_.dtype, device=dev)))
        for c_, f in zip(starts["nndsvd"][:2], starts["nndsvda"][:2]))
    d_dense = abs(starts["nndsvd"][2] / dense_nndsvd - 1)
    say("22 config 1 nndsvd", svds_host_seconds=f"{svds_s:.3f}",
        start_errors={k: f"{v[2]:.7g}" for k, v in starts.items()},
        dense_nndsvd_error=f"{dense_nndsvd:.7g}",
        sparse_vs_dense_nndsvd=f"{d_dense:.3e}", rtol=1e-3,
        nndsvda_is_nndsvd_filled_with_mean=filled)
    for init in ("nndsvd", "nndsvdar"):
        if not starts[init][2] < starts["random"][2]:
            fail(f"config 1: {init}'s start {starts[init][2]} is not below "
                 f"the random init's {starts['random'][2]}")
    if not filled:
        fail("config 1: nndsvda is not nndsvd with its zeros at mean(V)")
    if not d_dense <= 1e-3:
        fail(f"config 1: sparse nndsvd starts {d_dense:.3e} from the dense")
    del dense1, starts, sp, sp1
    torch.cuda.empty_cache()
    say("22 seconds", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return {"launches": {"hals_sweep": hals["launches"], **int8_launches},
            "row_solve": rs_launches["ell", "exact"],
            "ell_gram": eg_launches["ell", "exact"],
            "ell_cg": cg_launches,
            "hals_max_abs": hals_diff, "hals_ms": t_ms["kernel"],
            "hals_plain_ms": t_ms["plain"], "hals_bound": hals_bound}


# -- phase 23: the remaining surfaces (slice 5) ------------------------------


def config2_start(n, m, r, data_sum, dev):
    """Phase 22's W0/H0 at config 2 (the random init's scale, generator
    SEED + 22), made again from the same generator."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    scale = (data_sum / (n * m) / r) ** 0.5
    W0 = (torch.rand(n, r, generator=gen, device=dev) + 1e-4) * scale
    H0 = (torch.rand(r, m, generator=gen, device=dev) + 1e-4) * scale
    return W0, H0


def csr_panel(X, lo, hi, dev):
    """Rows lo:hi of a scipy CSR as a dense float32 device panel, made on
    the card (the script's own source for the online stream and the
    per-epoch divergences; the facade densifies its panels on the
    host)."""
    blk = X[lo:hi]
    rows = np.repeat(np.arange(hi - lo), np.diff(blk.indptr))
    P = torch.zeros(hi - lo, X.shape[1], device=dev)
    P[torch.as_tensor(rows, device=dev),
      torch.as_tensor(blk.indices.astype(np.int64), device=dev)] = \
        torch.as_tensor(blk.data, device=dev)
    return P


class DevicePanels:
    """A row-sliceable view of a scipy CSR whose slices are device
    panels (`csr_panel`)."""

    def __init__(self, X, dev):
        self.X, self.dev, self.shape = X, dev, X.shape

    def __getitem__(self, sl):
        return csr_panel(self.X, sl.start, sl.stop, self.dev)


def fro64(X, W, H, chunk=1 << 21) -> float:
    """||X - W H||_F in float64 for a scipy CSR X and device factors:
    ||X||^2 - 2 <X, WH> + tr(WᵀW HHᵀ), the cross term over the nonzeros
    in chunks."""
    W64, H64 = W.double(), H.double()
    coo = X.tocoo()
    cross = 0.0
    for s in range(0, coo.nnz, chunk):
        r = torch.as_tensor(coo.row[s:s + chunk].astype(np.int64),
                            device=W.device)
        c = torch.as_tensor(coo.col[s:s + chunk].astype(np.int64),
                            device=W.device)
        v = torch.as_tensor(coo.data[s:s + chunk], device=W.device).double()
        cross += float((v * (W64[r] * H64[:, c].T).sum(1)).sum())
    vv = float(np.square(coo.data.astype(np.float64)).sum())
    quad = float(((W64.T @ W64) * (H64 @ H64.T)).sum())
    return max(vv - 2.0 * cross + quad, 0.0) ** 0.5


def kl64(X, W, H, chunk=1 << 21) -> float:
    """D_KL(X || W H) in float64 for a scipy CSR X: the nonzeros'
    v log(v / wh) - v, plus the sum of WH (zero entries add their wh)."""
    W64, H64 = W.double(), H.double()
    coo = X.tocoo()
    total = float(W64.sum(0) @ H64.sum(1))
    for s in range(0, coo.nnz, chunk):
        r = torch.as_tensor(coo.row[s:s + chunk].astype(np.int64),
                            device=W.device)
        c = torch.as_tensor(coo.col[s:s + chunk].astype(np.int64),
                            device=W.device)
        v = torch.as_tensor(coo.data[s:s + chunk], device=W.device).double()
        wh = (W64[r] * H64[:, c].T).sum(1)
        total += float((v * torch.log(v / wh) - v).sum())
    return total


def rel_to_max(a, b) -> float:
    """max|a - b| / max|b| of two tensors or arrays."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return float((a.double() - b.double().to(a.device)).abs().max()
                 / b.double().abs().max())


def surfaces_phase(nt, card, dev, ratings, max_abs, ck_dir) -> dict:
    """Phase 23 (slice 5): the sklearn facade at config 2's full width
    (a), MiniBatchNMF and an OnlineNMF stream at config 2 (b),
    compute_batched at 4096^2 / r = 256 on four routes (c), vectorized
    restarts (d), a checkpoint and resume (e), rank selection and the
    compat API at config 1 (f), the CLI (g) and the C ABI (h). Each path
    is driven with the kernels' counts read just before and just after
    it; returns the launches of #1-#4 and #7 on them and raises max_abs's
    entries to the errors of #1-#4 and #7 against their twins on this
    phase's operands. The checkpoint of (e) is written to `ck_dir`, where
    phase 25 resumes it on a mesh."""
    import os
    import tempfile

    import scipy.sparse as sps

    from nmftpu_torch import capi
    from nmftpu_torch import checkpoint as CK
    from nmftpu_torch import compat
    from nmftpu_torch import minibatch as MB
    from nmftpu_torch import model_selection as MS
    from nmftpu_torch import sklearn_api as SK
    from nmftpu_torch import sparse_ops as TS
    from nmftpu_torch.batched import compute_batched
    from nmftpu_torch.config import Initialization, NmfConfig
    from nmftpu_torch.kernels import dense_mu as K
    from nmftpu_torch.kernels import hals_sweep as HS
    from nmftpu_torch.kernels import quantized as Q
    from nmftpu_torch.serving import Recommender

    t_phase = time.perf_counter()
    counted = (K.LAUNCHES, Q.LAUNCHES, HS.LAUNCHES)
    names = ("w_update_fused", "h_update_fused", "w_update_fused_q",
             "h_update_fused_q", "hals_sweep")
    launches = dict.fromkeys(names, 0)

    def snapshot():
        return {k: c[k] for c in counted for k in c if k in names}

    def add(before):
        now = snapshot()
        delta = {k: now[k] - before[k] for k in names}
        for k in names:
            launches[k] += delta[k]
        return delta

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # -- 23 (a): the sklearn facade at config 2's full width -----------------
    n, m = ratings.shape
    r = SPARSE_RANK
    X = sps.csr_matrix((ratings.data, ratings.indices, ratings.indptr),
                       shape=(n, m))
    W0, H0 = config2_start(n, m, r,
                           float(ratings.data.sum(dtype=np.float64)), dev)
    W0n, H0n = W0.cpu().numpy(), H0.cpu().numpy()
    del W0, H0
    common = dict(n_components=r, init="custom", tol=0.0, device=dev)
    fits, secs = {}, {}
    for label, kw in (("cd", dict(solver="cd")),
                      ("kl", dict(solver="mu",
                                  beta_loss="kullback-leibler"))):
        # a warm-up fit first: the timed fits' difference is the
        # iterations' time
        SK.NMF(max_iter=1, **common, **kw).fit(X, W=W0n, H=H0n)
        for iters in (1, SURFACE_FIT_ITERS):
            est = SK.NMF(max_iter=iters, **common, **kw)
            before = snapshot()
            t0 = time.perf_counter()
            W = est.fit_transform(X, W=W0n, H=H0n)
            secs[label, iters] = sync_s(t0)
            delta = add(before)
            fits[label, iters] = (est, W)
            if label == "cd" and delta["hals_sweep"] != 2 * iters:
                fail(f"NMF(solver='cd') launched #7 {delta['hals_sweep']} "
                     f"times in {iters} iterations, not {2 * iters}")
    port_csr = nt.sparse.from_scipy(X)
    cd1, cd4 = fits["cd", 1][0], fits["cd", SURFACE_FIT_ITERS][0]
    engines = {label: TS._resolve_strategy(
        port_csr, fits[label, 1][0]._config(
            r, Initialization.COPY_EXISTING, (n, m)), "auto", n, m)
        for label in ("cd", "kl")}
    say("23 (a) auto", engines=engines)
    if engines["cd"] != "scatter":
        fail(f"NMF(solver='cd') ran on {engines['cd']}, not scatter")
    refs = {}
    for iters, est in ((1, cd1), (SURFACE_FIT_ITERS, cd4)):
        cfg = est._config(r, Initialization.COPY_EXISTING, (n, m))
        refs[iters] = nt.compute_sparse(port_csr, cfg, W0=W0n, H0=H0n,
                                        device=dev)
    dW = rel_to_max(torch.as_tensor(fits["cd", 1][1]), refs[1].W.cpu())
    dH = rel_to_max(torch.as_tensor(cd1.components_), refs[1].H.cpu())
    d_obj = abs(cd4.reconstruction_err_ - refs[SURFACE_FIT_ITERS]
                .frobenius_error) / refs[SURFACE_FIT_ITERS].frobenius_error
    W4 = torch.as_tensor(fits["cd", SURFACE_FIT_ITERS][1], device=dev)
    H4 = torch.as_tensor(cd4.components_, device=dev)
    e64 = fro64(X, W4, H4)
    d_err = abs(cd4.reconstruction_err_ - e64) / e64
    kl_est = fits["kl", SURFACE_FIT_ITERS][0]
    Wk = torch.as_tensor(fits["kl", SURFACE_FIT_ITERS][1], device=dev)
    Hk = torch.as_tensor(kl_est.components_, device=dev)
    kl_err64 = (2.0 * kl64(X, Wk, Hk)) ** 0.5
    d_kl = abs(kl_est.reconstruction_err_ - kl_err64) / kl_err64
    it_ms = {label: (secs[label, SURFACE_FIT_ITERS] - secs[label, 1])
             / (SURFACE_FIT_ITERS - 1) * 1e3 for label in ("cd", "kl")}
    say("23 (a) NMF", shape=f"{n}x{m}", nnz=X.nnz, rank=r,
        cd_one_iteration_W_rel=f"{dW:.3e}", H_rel=f"{dH:.3e}",
        limit=HALS_STEP_RTOL, cd_objective_vs_compute_sparse=f"{d_obj:.3e}",
        objective_limit=HALS_E2E_RTOL,
        cd_reconstruction_err=f"{cd4.reconstruction_err_:.7g}",
        float64=f"{e64:.7g}", rel=f"{d_err:.3e}",
        kl_reconstruction_err=f"{kl_est.reconstruction_err_:.7g}",
        kl_float64=f"{kl_err64:.7g}", kl_rel=f"{d_kl:.3e}",
        err_limit=SURFACE_ERR_RTOL)
    say("23 (a) ms per iteration", cd=f"{it_ms['cd']:.3f}",
        kl=f"{it_ms['kl']:.3f}",
        fit_s={f"{k[0]}x{k[1]}": f"{v:.2f}" for k, v in secs.items()},
        card=card)
    if not (dW <= HALS_STEP_RTOL and dH <= HALS_STEP_RTOL):
        fail(f"NMF(solver='cd') after one iteration: W {dW:.3e}, H "
             f"{dH:.3e} from compute_sparse (> {HALS_STEP_RTOL})")
    if not d_obj <= HALS_E2E_RTOL:
        fail(f"NMF(solver='cd'): objective {d_obj:.3e} from "
             "compute_sparse's")
    if not (d_err <= SURFACE_ERR_RTOL and d_kl <= SURFACE_ERR_RTOL):
        fail(f"reconstruction_err_ off float64: cd {d_err:.3e}, KL "
             f"{d_kl:.3e} (> {SURFACE_ERR_RTOL})")
    del refs, fits, Wk, Hk, kl_est

    # held-out users: 100 distinct items each, drawn as phase 18 draws
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    items = distinct_items(COLD_USERS, gen, dev, m=m)
    vals = np.random.default_rng(SEED + 18).integers(
        1, 6, items.shape).astype(np.float32)
    Xh = sps.csr_matrix((vals.reshape(-1), items.reshape(-1),
                         np.arange(0, items.size + 1, SERVE_SEEN)),
                        shape=(COLD_USERS, m))
    Xh_dense = torch.as_tensor(Xh.toarray(), device=dev).double()
    H4_64 = H4.double()

    def held_out_error(W):
        W = torch.as_tensor(W, device=dev).double()
        return float(torch.linalg.norm(Xh_dense - W @ H4_64))

    fold = []
    before = snapshot()
    for k in range(1, SURFACE_FIT_ITERS + 1):
        cd4.set_params(max_iter=k)
        Wt = cd4.transform(Xh)
        fold.append((held_out_error(Wt), float(Wt.min())))
    delta = add(before)
    cd4.set_params(max_iter=SURFACE_FIT_ITERS)
    recon = cd4.inverse_transform(Wt)
    before = snapshot()
    Wn, _, _ = SK.non_negative_factorization(
        Xh, H=cd4.components_, n_components=r, update_H=False,
        solver="cd", max_iter=SURFACE_FIT_ITERS, device=dev)
    nnf_delta = add(before)
    nnf_err = held_out_error(Wn)
    errs = [e for e, _ in fold]
    want_sweeps = SURFACE_FIT_ITERS * (SURFACE_FIT_ITERS + 1) // 2
    say("23 (a) transform", users=COLD_USERS, items_each=SERVE_SEEN,
        objective_per_iteration=[f"{e:.7g}" for e in errs],
        min_W=min(w for _, w in fold), hals_launches=delta["hals_sweep"],
        expected=want_sweeps, inverse_shape=recon.shape,
        non_negative_factorization_objective=f"{nnf_err:.7g}",
        its_hals_launches=nnf_delta["hals_sweep"])
    if not all(b < a for a, b in zip(errs, errs[1:])):
        fail(f"the HALS fold-in objective did not fall: {errs}")
    if min(w for _, w in fold) < 0:
        fail("transform returned negative W")
    if recon.shape != (COLD_USERS, m):
        fail(f"inverse_transform shape {recon.shape}")
    if delta["hals_sweep"] != want_sweeps or \
            nnf_delta["hals_sweep"] != SURFACE_FIT_ITERS:
        fail(f"#7 launches: transform {delta['hals_sweep']} (not "
             f"{want_sweeps}), non_negative_factorization "
             f"{nnf_delta['hals_sweep']} (not {SURFACE_FIT_ITERS})")
    # #7 on the fold-in's own operands against its twin
    N = (Xh_dense.float() @ H4.T).contiguous()
    G = (H4 @ H4.T).contiguous()
    Wf = torch.as_tensor(Wt, device=dev).contiguous()
    got, want = HS.hals_sweep(N, G, Wf), HS.hals_sweep_plain(N, G, Wf)
    d7 = float((got - want).abs().max())
    say("23 kernel", kernel="hals_sweep", operands="fold-in 2048x64",
        max_abs=f"{d7:.3e}", rel_to_max=f"{d7 / float(want.abs().max()):.3e}",
        bound=HALS_ATOL)
    if not d7 <= HALS_ATOL * float(want.abs().max()):
        fail("hals_sweep disagrees with its twin on the fold-in's operands")
    max_abs["hals_sweep"] = max(max_abs["hals_sweep"], d7)
    del Xh_dense, N, G, Wf, got, want, recon, W4, H4, H4_64, cd1, cd4

    # -- 23 (b): MiniBatchNMF and an OnlineNMF stream at config 2 ------------
    bs = MB_BATCH
    panels = -(-n // bs)
    mb = SK.MiniBatchNMF(r, beta_loss="kullback-leibler", batch_size=bs,
                         init="random", random_state=SEED, max_iter=2,
                         tol=0.0, max_no_improvement=None, device=dev)
    W0n, H0n = mb._init_wh(X, r, None, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    Wmb = mb.fit_transform(X)
    fit_s = sync_s(t0)
    peak = torch.cuda.max_memory_allocated() - base_mem
    src = DevicePanels(X, dev)
    div0 = MB.divergence_blocked(src, W0n, H0n, 1.0, batch=bs, device=dev)
    W1, H1, _, _ = MB.minibatch_fit(src, r, batch_size=bs, max_iter=1,
                                    beta=1.0, tol=0.0,
                                    max_no_improvement=None, W0=W0n,
                                    H0=H0n, device=dev)
    div1 = MB.divergence_blocked(src, W1, H1, 1.0, batch=bs, device=dev)
    div2 = mb.reconstruction_err_ ** 2 / 2.0
    # one step on the first panel against float64 (same function)
    rho = 0.7 ** (bs / n)
    Xb = csr_panel(X, 0, bs, dev)
    args32 = [torch.as_tensor(a, device=dev, dtype=torch.float32)
              for a in (W0n[:bs], H0n, H0n, np.ones_like(H0n))]
    out32 = MB.minibatch_step(Xb, *args32[:2], *args32[2:], rho, beta=1.0)
    out64 = MB.minibatch_step(Xb.double(), *[a.double() for a in args32[:2]],
                              *[a.double() for a in args32[2:]], rho,
                              beta=1.0)
    d_step = max(rel_to_max(a, b) for a, b in zip(out32[:4], out64[:4]))
    say("23 (b) MiniBatchNMF", shape=f"{n}x{m}", batch=bs, panels=panels,
        epochs=2, divergence_per_epoch=[f"{d:.7g}" for d in
                                        (div0, div1, div2)],
        one_step_vs_float64=f"{d_step:.3e}", limit=SURFACE_ERR_RTOL,
        fit_s=f"{fit_s:.2f}", ms_per_panel=f"{fit_s / (2 * panels) * 1e3:.3f}",
        peak_GiB=f"{peak / 2**30:.3f}",
        limit_GiB=f"{n * m * 4 / 2**30:.2f}", card=card)
    if not d_step <= SURFACE_ERR_RTOL:
        fail(f"minibatch_step off float64 by {d_step:.3e}")
    if not peak < n * m * 4:
        fail(f"MiniBatchNMF peaked at {peak / 2**30:.2f} GiB on the card, "
             "not below one dense n x m float32 array")
    if not (np.isfinite(Wmb).all() and Wmb.shape == (n, r)):
        fail("MiniBatchNMF returned non-finite or misshapen W")
    del Wmb, W1, H1, out32, out64, args32, Xb
    # the stream: saved after half the panels, loaded, fed the rest
    whole = MB.OnlineNMF(r, beta=1.0, batch_size=bs, n_rows_hint=n,
                         seed=SEED, device=dev)
    part = MB.OnlineNMF(r, beta=1.0, batch_size=bs, n_rows_hint=n,
                        seed=SEED, device=dev)
    half = panels // 2
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(panels):
            P = csr_panel(X, i * bs, min((i + 1) * bs, n), dev)
            whole.partial_fit(P, H0=H0n)
            if i < half:
                part.partial_fit(P, H0=H0n)
            if i == half - 1:
                part.save(tmp)
                part = MB.OnlineNMF.load(tmp, device=dev)
            if i >= half:
                part.partial_fit(P)
    stream_s = sync_s(t0)
    same = all(torch.equal(a, b) for a, b in ((whole.H, part.H),
                                              (whole._A, part._A),
                                              (whole._B, part._B)))
    say("23 (b) OnlineNMF", panels=panels, saved_after=half,
        resumed_equals_uninterrupted=same, n_steps=part.n_steps,
        seconds=f"{stream_s:.2f}")
    if not same or part.n_steps != panels:
        fail("the resumed OnlineNMF stream differs from the uninterrupted "
             "one")
    del whole, part, X, port_csr

    # -- 23 (c): compute_batched at 4096^2, r = 256 --------------------------
    nb, rb = BATCH_SHAPE
    Vs, W0s, H0s = [], [], []
    for i in range(BATCH):
        g = torch.Generator(device=dev).manual_seed(SEED + i)
        Vs.append(synthetic_lowrank(nb, nb, rb, g, dev))
        W0s.append(torch.rand(nb, rb, generator=g, device=dev) + 0.01)
        H0s.append(torch.rand(rb, nb, generator=g, device=dev) + 0.01)
    Vs, W0s, H0s = torch.stack(Vs), torch.stack(W0s), torch.stack(H0s)
    routes = {"plain": ({}, ()),
              "kernels_f32": ({"use_pallas": True},
                              ("w_update_fused", "h_update_fused")),
              "int8": ({"v_storage": "int8", "use_pallas": True},
                       ("w_update_fused_q", "h_update_fused_q")),
              "hals": ({"algorithm": "hals"}, ("hals_sweep",))}
    batched = {}
    for label, (knobs, kernels) in routes.items():
        cfg = NmfConfig(rank=rb, init_method=Initialization.COPY_EXISTING,
                        num_iterations=BATCH_ITERS, check_interval=10,
                        **knobs)
        # a one-iteration warm-up: the allocator's first blocks for the
        # route's operands stay out of the timed run
        compute_batched(Vs, dataclasses.replace(cfg, num_iterations=1),
                        W0=W0s, H0=H0s)
        torch.cuda.synchronize()
        before = snapshot()
        t0 = time.perf_counter()
        res = compute_batched(Vs, cfg, W0=W0s, H0=H0s)
        b_s = sync_s(t0)
        delta = add(before)
        solo_s, worst = 0.0, 0.0
        for i in range(BATCH):
            t0 = time.perf_counter()
            solo = nt.compute(Vs[i], cfg, W0=W0s[i], H0=H0s[i])
            solo_s += sync_s(t0)
            if label in ("plain", "kernels_f32"):
                d = max(rel_to_max(res.W[i], solo.W),
                        rel_to_max(res.H[i], solo.H))
            else:
                d = abs(res.error[i] - solo.error) / solo.error
            worst = max(worst, d)
            del solo
        limit = {"plain": E2E_RTOL, "kernels_f32": E2E_RTOL,
                 "int8": E2E_RTOL, "hals": HALS_E2E_RTOL}[label]
        extra = {}
        if label == "hals":
            one = dataclasses.replace(cfg, num_iterations=1)
            r1 = compute_batched(Vs, one, W0=W0s, H0=H0s)
            d1 = 0.0
            for i in range(BATCH):
                s1 = nt.compute(Vs[i], one, W0=W0s[i], H0=H0s[i])
                d1 = max(d1, rel_to_max(r1.W[i], s1.W),
                         rel_to_max(r1.H[i], s1.H))
            extra = {"one_iteration_WH_rel": f"{d1:.3e}",
                     "one_iteration_limit": HALS_STEP_RTOL}
            if not d1 <= HALS_STEP_RTOL:
                fail(f"batched HALS after one iteration: {d1:.3e}")
            del r1, s1
        # one launch per problem and half-step (2-D slices): each MU
        # kernel runs one half-step, #7 both
        per = 2 if label == "hals" else 1
        want = {k: per * BATCH_ITERS * BATCH for k in kernels}
        got = {k: delta[k] for k in kernels}
        say("23 (c) compute_batched", route=label, problems=BATCH,
            shape=f"{nb}x{nb}", rank=rb, iterations=BATCH_ITERS,
            compared="W/H" if label in ("plain", "kernels_f32")
            else "error", worst_rel=f"{worst:.3e}", limit=limit,
            launches=got, expected=want,
            batch_ms_per_iter=f"{b_s / BATCH_ITERS * 1e3:.3f}",
            solo_sum_ms_per_iter=f"{solo_s / BATCH_ITERS * 1e3:.3f}",
            **extra, card=card)
        if not worst <= limit:
            fail(f"compute_batched {label}: {worst:.3e} from the solo runs")
        if got != want:
            fail(f"compute_batched {label}: launches {got}, not {want}")
        batched[label] = res
    # #1-#4 and #7 against their twins on problem 0's final factors
    V0 = Vs[0]
    Wk, Hk = batched["kernels_f32"].W[0], batched["kernels_f32"].H[0]
    Vq0, sc0 = Q.quantize_v(V0)
    Gw, Gh = Hk @ Hk.T, Wk.T @ Wk
    twins = {
        "w_update_fused": (K.w_update_fused(V0, Wk, Hk, Gw),
                           K.w_update_fused_plain(V0, Wk, Hk, Gw)),
        "h_update_fused": (K.h_update_fused(V0, Wk, Hk, Gh),
                           K.h_update_fused_plain(V0, Wk, Hk, Gh)),
        "w_update_fused_q": (Q.w_update_fused_q(Vq0, sc0, Wk, Hk, Gw),
                             Q.w_update_fused_q_plain(Vq0, sc0, Wk, Hk, Gw)),
        "h_update_fused_q": (Q.h_update_fused_q(Vq0, sc0, Wk, Hk, Gh),
                             Q.h_update_fused_q_plain(Vq0, sc0, Wk, Hk, Gh)),
    }
    for name, (got, want) in twins.items():
        a, rel = rel_err(got, want)
        max_abs[name] = max(max_abs[name], a)
        say("23 kernel", kernel=name, operands="batched problem 0",
            max_abs=f"{a:.3e}", max_rel=f"{rel:.3e}", rtol=KERNEL_RTOL)
        if not rel <= KERNEL_RTOL:
            fail(f"{name} on the batched operands: {rel:.3e}")
    Wh, Hh = batched["hals"].W[0], batched["hals"].H[0]
    XHt, G = (V0 @ Hh.T).contiguous(), (Hh @ Hh.T).contiguous()
    got, want = HS.hals_sweep(XHt, G, Wh), HS.hals_sweep_plain(XHt, G, Wh)
    d7 = float((got - want).abs().max())
    say("23 kernel", kernel="hals_sweep", operands="batched problem 0",
        rel_to_max=f"{d7 / float(want.abs().max()):.3e}", bound=HALS_ATOL)
    if not d7 <= HALS_ATOL * float(want.abs().max()):
        fail("hals_sweep disagrees with its twin on the batched operands")
    max_abs["hals_sweep"] = max(max_abs["hals_sweep"], d7)
    del twins, got, want, XHt, G, Vq0, sc0, Wh, Hh

    # -- 23 (d): vectorized restarts -----------------------------------------
    for label, knobs, kernels in (
            ("kernels_f32", {"use_pallas": True},
             ("w_update_fused", "h_update_fused")),
            ("hals", {"algorithm": "hals"}, ("hals_sweep",))):
        kw = dict(num_runs=VEC_RUNS, num_iterations=BATCH_ITERS,
                  check_interval=10, seed=SEED, device=dev, **knobs)
        before = snapshot()
        t0 = time.perf_counter()
        vec = nt.nmf(V0, rb, vectorize_runs=True, **kw)
        v_s = sync_s(t0)
        delta = add(before)
        t0 = time.perf_counter()
        seq = nt.nmf(V0, rb, **kw)
        s_s = sync_s(t0)
        d_runs = max(abs(a - b) / b for a, b in zip(vec.run_errors,
                                                    seq.run_errors))
        srt = sorted(seq.run_errors)
        close = srt[1] - srt[0] <= 1e-4 * srt[0]
        if label == "hals":
            d_best = abs(vec.error - seq.error) / seq.error
            lim = HALS_E2E_RTOL
        else:
            d_best = max(rel_to_max(vec.W, seq.W), rel_to_max(vec.H, seq.H))
            lim = E2E_RTOL
        got = {k: delta[k] for k in kernels}
        per = 2 if label == "hals" else 1
        want = {k: per * BATCH_ITERS * VEC_RUNS for k in kernels}
        say("23 (d) vectorize_runs", route=label, runs=VEC_RUNS,
            run_errors=[f"{e:.7g}" for e in vec.run_errors],
            sequential=[f"{e:.7g}" for e in seq.run_errors],
            worst_rel=f"{d_runs:.3e}", limit=1e-4, best=vec.best_run,
            sequential_best=seq.best_run, two_runs_close=close,
            best_rel=f"{d_best:.3e}", best_limit=lim, launches=got,
            expected=want,
            vectorized_ms_per_iter=f"{v_s / BATCH_ITERS * 1e3:.3f}",
            sequential_ms_per_iter=f"{s_s / BATCH_ITERS * 1e3:.3f}",
            card=card)
        if not d_runs <= 1e-4:
            fail(f"vectorized {label}: run errors {d_runs:.3e} from the "
                 "sequential restarts'")
        if vec.best_run != seq.best_run and not close:
            fail(f"vectorized {label}: best run {vec.best_run}, sequential "
                 f"{seq.best_run}")
        if vec.best_run == seq.best_run and not d_best <= lim:
            fail(f"vectorized {label}: best run {d_best:.3e} off")
        if got != want:
            fail(f"vectorized {label}: launches {got}, not {want}")
        del vec, seq

    # -- 23 (e): checkpoint and resume ---------------------------------------
    cfg = NmfConfig(rank=rb, init_method=Initialization.COPY_EXISTING,
                    num_iterations=BATCH_ITERS, check_interval=10,
                    use_pallas=True)
    before = snapshot()
    full = nt.compute(V0, cfg, W0=W0s[0], H0=H0s[0])
    first = nt.compute(V0, dataclasses.replace(cfg, num_iterations=10),
                       W0=W0s[0], H0=H0s[0])
    CK.save(ck_dir, first.W, first.H, iteration=10, config=cfg)
    resumed = CK.resume(ck_dir, V0, cfg, device=dev)
    add(before)
    d_ck = max(rel_to_max(resumed.W, full.W), rel_to_max(resumed.H, full.H))
    say("23 (e) checkpoint", saved_at=10, resumed_to=BATCH_ITERS,
        resumed_iterations=resumed.num_iterations, WH_rel=f"{d_ck:.3e}",
        limit=1e-6)
    if not (d_ck <= 1e-6 and resumed.num_iterations == 10):
        fail(f"resume differs from the uninterrupted run: {d_ck:.3e}")
    del full, first, resumed, Vs, W0s, H0s, batched, V0, Wk, Hk
    torch.cuda.empty_cache()

    # -- 23 (f): rank selection and compat at config 1 -----------------------
    n1, m1, nnz1 = CONFIG1
    rng = np.random.default_rng(SEED + 23)
    config1 = np.zeros(n1 * m1, np.float32)
    config1[rng.choice(n1 * m1, nnz1, replace=False)] = rng.integers(
        1, 6, nnz1)
    config1 = config1.reshape(n1, m1)
    t0 = time.perf_counter()
    for k in RANKS:
        C, errs = MS.consensus_matrix(
            config1, NmfConfig(rank=k, num_iterations=100, seed=SEED),
            n_runs=4, device=dev)
        rho_k, disp = MS.cophenetic_correlation(C), MS.dispersion(C)
        sym = bool(np.array_equal(C, C.T))
        diag = bool(np.all(np.diag(C) == 1.0))
        in01 = bool(C.min() >= 0.0 and C.max() <= 1.0)
        say("23 (f) consensus", rank=k, runs=4, symmetric=sym,
            unit_diagonal=diag, in_0_1=in01, cophenetic=f"{rho_k:.6f}",
            dispersion=f"{disp:.6f}",
            mean_error=f"{np.mean(errs):.6g}")
        if not (sym and diag and in01 and -1.0 <= rho_k <= 1.0
                and 0.0 <= disp <= 1.0):
            fail(f"consensus at rank {k}: symmetric {sym}, diagonal "
                 f"{diag}, in [0, 1] {in01}, rho {rho_k}, dispersion {disp}")
    sel = MS.rank_selection(config1, RANKS, n_runs=4, num_iterations=100,
                            seed=SEED, device=dev)
    say("23 (f) rank_selection", ranks=sel.ranks,
        cophenetic=[f"{x:.6f}" for x in sel.cophenetic],
        dispersion=[f"{x:.6f}" for x in sel.dispersion],
        best_rank=sel.best_rank, seconds=f"{sync_s(t0):.2f}")
    if compat.initialize() != compat.ResultType.SUCCESS:
        fail("compat.initialize() did not succeed on the card")
    info = compat.device_info(0)
    count = compat.device_count()
    rc = compat.choose_device(0)
    res = compat.compute(compat.NmfDescription(
        input_matrix=config1, rank=32, num_iterations=100, seed=SEED))
    rmsd_zero = float(np.sqrt(np.mean(config1.astype(np.float64) ** 2)))
    compat.finalize()
    say("23 (f) compat", version=compat.version(), device_count=count,
        device_info=info, choose_device=rc, rmsd=f"{res.rmsd:.6f}",
        zero_model_rmsd=f"{rmsd_zero:.6f}", device=res.W.device)
    if count != torch.cuda.device_count() or \
            info["kind"] != torch.cuda.get_device_name(0) or rc != 0:
        fail(f"compat devices: count {count}, info {info}, choose {rc}")
    if not (res.W.device.type == "cuda" and res.rmsd < rmsd_zero):
        fail(f"compat.compute: RMSD {res.rmsd} on {res.W.device} (the zero "
             f"model's is {rmsd_zero})")

    # -- 23 (g): the CLI on config 1's ratings -------------------------------
    env = {k: v for k, v in os.environ.items() if k != "NMFTPU_PLATFORM"}
    with tempfile.TemporaryDirectory() as tmp:
        rows, cols = np.nonzero(config1)
        data = os.path.join(tmp, "u.data")
        with open(data, "w") as f:
            f.writelines(f"{u + 1}\t{i + 1}\t{int(config1[u, i])}\t"
                         f"{880_000_000 + j}\n"
                         for j, (u, i) in enumerate(zip(rows, cols)))
        bundle, jsonl = os.path.join(tmp, "bundle"), os.path.join(tmp,
                                                                  "m.jsonl")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "nmftpu_torch", data, "--rank", "32",
             "--iters", "100", "--eval-recall", "10", "--save", bundle,
             "--metrics", jsonl], cwd=str(HERE), env=env,
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"python -m nmftpu_torch exited {out.returncode}:\n"
                 f"{out.stderr[-3000:]}")
        summary = json.loads(out.stdout.strip().splitlines()[-1])
        records = [json.loads(x) for x in open(jsonl)]
        rec = Recommender.load(bundle, device=dev)
        top = rec.recommend([0, 1], k=10)
        say("23 (g) CLI", exit_code=out.returncode, summary=summary,
            jsonl_records=len(records), checks=100 // 10,
            loaded_users=rec.n_users, loaded_items=rec.n_items,
            table_device=rec.H.device, top10_shape=np.asarray(top[0]).shape,
            seconds=f"{cli_s:.2f}")
        if "recall@10" not in summary or len(records) != 100 // 10:
            fail(f"CLI: summary {summary}, {len(records)} JSONL records")
        if rec.H.device.type != "cuda":
            fail("Recommender.load did not load onto the card")

    # -- 23 (h): the C ABI from a pure-C host --------------------------------
    t0 = time.perf_counter()
    lib = capi.build()
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "test_capi")
        cc = subprocess.run(
            ["gcc", str(HERE / "native" / "test_capi.c"), "-I",
             str(capi.HERE), "-L", str(lib.parent), "-lnmftpu_torch",
             "-lm", "-o", exe], capture_output=True, text=True)
        if cc.returncode != 0:
            fail(f"native/test_capi.c did not compile against the port's "
                 f"header:\n{cc.stderr[-3000:]}")
        capi_env = capi.embed_env(env)
        t0 = time.perf_counter()
        out = subprocess.run([exe, str(HERE)], capture_output=True,
                             text=True, timeout=600, env=capi_env)
        run_s = time.perf_counter() - t0
    found = re.search(r"callback records=(\d+).*iters=(\d+)", out.stdout)
    say("23 (h) C ABI", library=lib.name, build_s=f"{build_s:.2f}",
        exit_code=out.returncode, seconds=f"{run_s:.2f}",
        stdout=" | ".join(out.stdout.strip().splitlines()))
    if out.returncode != 0 or "C ABI OK" not in out.stdout:
        fail(f"test_capi exited {out.returncode}:\n{out.stdout}\n"
             f"{out.stderr[-3000:]}")
    if not (found and int(found.group(1)) >= 3
            and int(found.group(2)) < 400):
        fail(f"test_capi's callback did not cancel the run: {out.stdout}")

    if min(launches.values()) < 1:
        fail(f"a kernel of phase 23's paths never launched: {launches}")
    say("23 launches", **launches)
    say("23 seconds", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return launches


# ---------------------------------------------------------------------------
# phase 24: the 2-D grid and sharded serving (slice 6a). The rank programs
# below run in the processes of the port's launcher (spawned: each imports
# this file as a module, so they may use its helpers)
# ---------------------------------------------------------------------------


def c4_tile(path: str) -> tuple[str, float, int]:
    """One device's share of config 4 from the port's generator, saved as
    (row, col, data) at `path`; run in a background process while the
    earlier phases use the card. Returns (path, seconds, nonzeros)."""
    from nmftpu_torch.data.synthetic import synthetic_powerlaw_sparse

    t0 = time.perf_counter()
    sp = synthetic_powerlaw_sparse(*C4_SHAPE, C4_DRAWS, seed=C4_SEED)
    np.savez(path, row=sp.row, col=sp.col, data=sp.data)
    return path, time.perf_counter() - t0, int(sp.nnz)


GRID_CASES = (("mu-frobenius", "ell"), ("mu-frobenius", "scatter"),
              ("mu-kl", "ell"), ("mu-kl", "scatter"), ("hals", "scatter"),
              ("ials", "scatter"))


def grid_config(kind: str, iters: int, rank: int = SPARSE_RANK,
                order: str = "WH"):
    """Phase 24's configs. One iteration in order "WH" takes the W half
    from (W0, H0), in order "HW" the H half: each half is held against
    its reference from the same inputs, as phase 22 holds them."""
    from nmftpu_torch.config import (Algorithm, Initialization, NmfConfig,
                                     Objective)

    knobs = {"mu-frobenius": {}, "mu-kl": dict(objective=Objective.KL),
             "hals": dict(algorithm=Algorithm.HALS),
             "ials": dict(algorithm=Algorithm.ALS,
                          alpha_confidence=40.0)}[kind]
    return NmfConfig(rank=rank, init_method=Initialization.COPY_EXISTING,
                     num_iterations=iters, check_interval=1,
                     update_order=order, **knobs)


def load_ratings(path):
    from nmftpu_torch.sparse import SparseCSR

    z = np.load(path)
    return SparseCSR(z["indptr"], z["indices"], z["data"],
                     tuple(int(x) for x in z["shape"]))


def grid_runs(mesh, sp, W0, H0, keep_factors: bool):
    """The cases of phase 24 (b) on `mesh` from W0/H0: one iteration in
    each order (its first half's factor kept where asked) and GRID_ITERS
    (not iALS), each run's #7 launches, staged bytes and seconds. Returns
    (results, plans)."""
    from nmftpu_torch.kernels import hals_sweep as HS
    from nmftpu_torch.parallel import STAGED_BYTES, prepare_sharded

    plans, out = {}, {}
    for kind, engine in GRID_CASES:
        if engine not in plans:
            t0 = time.perf_counter()
            plans[engine] = prepare_sharded(sp, grid_config(kind, 1),
                                            mesh=mesh, engine=engine,
                                            chunk=1 << 17)
            out[f"prepare-{engine}"] = time.perf_counter() - t0
        got = {}
        # the HW run first: it also warms the engine up for the timed pair
        runs = [(1, "HW"), (1, "WH")]
        if kind != "ials":
            runs.append((GRID_ITERS, "WH"))
        for iters, order in runs:
            hals, staged = HS.LAUNCHES["hals_sweep"], sum(STAGED_BYTES
                                                          .values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = plans[engine].run(grid_config(kind, iters, order=order),
                                    W0=W0, H0=H0)
            torch.cuda.synchronize()
            got[iters, order] = dict(
                secs=time.perf_counter() - t0, error=res.error,
                fro=res.frobenius_error, kl=res.kl_error,
                hals=HS.LAUNCHES["hals_sweep"] - hals,
                staged=sum(STAGED_BYTES.values()) - staged)
            if iters == 1 and keep_factors:
                got[order] = (res.W if order == "WH" else res.H).cpu().numpy()
            del res
        out[f"{kind}-{engine}"] = got
    return out, plans


def rel_host(X, Y, rows=1 << 20) -> float:
    """max |X - Y| / max |Y| for a host tensor X and a card tensor Y of
    one shape, over row panels (no second card-sized copy)."""
    diff = 0.0
    for lo in range(0, Y.shape[0], rows):
        d = (X[lo:lo + rows].to(Y.device) - Y[lo:lo + rows]).abs().max()
        diff = max(diff, float(d))
    return diff / float(Y.abs().max())


def h_half64(sp, W, H0, cols, eps, chunk=1 << 20):
    """The MU-Frobenius H half from (W, H0) in float64 on columns `cols`
    of the host COO sp: H0 ⊙ Wᵀv / (WᵀW H0 + eps), W on the card, its
    Gram summed over row panels. Returns (r, len(cols)) on the card."""
    dev, r = W.device, W.shape[1]
    G = torch.zeros((r, r), dtype=torch.float64, device=dev)
    for lo in range(0, W.shape[0], chunk):
        P = W[lo:lo + chunk].double()
        G += P.T @ P
    keep = np.flatnonzero(np.isin(sp.col, cols))
    slot = np.searchsorted(cols, sp.col[keep])
    num = torch.zeros((len(cols), r), dtype=torch.float64, device=dev)
    for lo in range(0, len(keep), chunk):
        k = keep[lo:lo + chunk]
        rows = torch.as_tensor(sp.row[k].astype(np.int64), device=dev)
        v = torch.as_tensor(sp.data[k].astype(np.float64), device=dev)
        num.index_add_(0, torch.as_tensor(slot[lo:lo + chunk], device=dev),
                       W[rows].double() * v[:, None])
    H0s = H0[:, torch.as_tensor(cols)].to(dev).double()
    return H0s * num.T / (G @ H0s + eps)


def grid_one_rank(c4_path, ratings_path, W0, H0):
    """Phase 24 (a), and the 1 x 1 runs and compute_sparse references of
    (b): one rank of the launcher's NCCL world, a 1 x 1 mesh."""
    import torch.distributed as dist

    from nmftpu_torch import sparse_ops as TS
    from nmftpu_torch.parallel import make_grid_mesh, prepare_sharded
    from nmftpu_torch.parallel.driver import _sharded_ops
    from nmftpu_torch.sparse import SparseCOO

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    mesh = make_grid_mesh((1, 1))
    out = {"backend": dist.get_backend(), "world": dist.get_world_size()}

    # (a) one device's share of config 4
    n, m = C4_SHAPE
    r = C4_RANK
    z = np.load(c4_path)
    sp = SparseCOO(row=z["row"], col=z["col"], data=z["data"], shape=C4_SHAPE)
    del z
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    scale = (float(sp.data.sum(dtype=np.float64)) / (n * m) / r) ** 0.5
    W0c = ((torch.rand(n, r, generator=gen, device=dev) + 1e-4) * scale).cpu()
    H0c = ((torch.rand(r, m, generator=gen, device=dev) + 1e-4) * scale).cpu()
    torch.cuda.empty_cache()
    cfg = grid_config("mu-frobenius", 1, rank=r)
    a = {"nnz": int(sp.nnz)}
    host, halves = {}, {}
    for engine in ("ell", "scatter"):
        t0 = time.perf_counter()
        plan = prepare_sharded(sp, cfg, mesh=mesh, balance=False,
                               chunk=1 << 17, engine=engine)
        torch.cuda.synchronize()
        got = {"prepare_s": time.perf_counter() - t0}
        torch.cuda.reset_peak_memory_stats()
        hw = plan.run(dataclasses.replace(cfg, update_order="HW"), W0=W0c,
                      H0=H0c, unpermute=False)
        H1 = hw.H.cpu()
        del hw
        t0 = time.perf_counter()
        res = plan.run(W0=W0c, H0=H0c, unpermute=False)
        torch.cuda.synchronize()
        got["run1_s"] = time.perf_counter() - t0
        got["error1"] = res.frobenius_error
        host[engine] = (res.W.cpu(), H1, res.H.cpu())
        halves[engine] = H1
        # one more iteration on the run's factors, timed by CUDA events
        ops = _sharded_ops(cfg, mesh, plan.engine, n, m, plan.nnz)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        W2, H2 = ops.update(plan.operand, (), res.W, res.H)
        end.record()
        end.synchronize()
        got["update_ms"] = start.elapsed_time(end)
        del res, W2, H2
        if engine == "ell":
            stamps = []
            res = plan.run(dataclasses.replace(cfg, num_iterations=2),
                           W0=W0c, H0=H0c, unpermute=False,
                           callback=lambda *a: stamps.append(
                               time.perf_counter()))
            got["iteration_with_check_ms"] = (stamps[1] - stamps[0]) * 1e3
            got["errors"] = res.stats.errors.tolist()
            del res
        got["peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
        a[engine] = got
        del plan, ops
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = TS.compute_sparse(sp, cfg, W0=W0c, H0=H0c, strategy="scatter",
                            device=dev)
    torch.cuda.synchronize()
    a["compute_sparse"] = dict(secs=time.perf_counter() - t0,
                               error1=ref.frobenius_error,
                               peak_GiB=torch.cuda.max_memory_allocated()
                               / 2**30)
    for engine, (Wx, _, Hw) in host.items():
        a[engine]["W_rel"] = rel_host(Wx, ref.W)
        # H after the grid's own W half
        a[engine]["H_after_W_rel"] = rel_host(Hw.T, ref.H.T)
    a["finite"] = bool(torch.isfinite(ref.W).all() and
                       torch.isfinite(ref.H).all())
    # each engine's H half from compute_sparse's own W half (ref.H's very
    # inputs), and all three against float64 on sampled columns: the
    # columns where ELL and compute_sparse differ most, the longest and
    # some at random
    for engine in ("ell", "scatter"):
        plan = prepare_sharded(sp, cfg, mesh=mesh, balance=False,
                               chunk=1 << 17, engine=engine)
        hw = plan.run(dataclasses.replace(cfg, update_order="HW"),
                      W0=ref.W, H0=H0c, unpermute=False)
        host[engine] = hw.H.cpu()
        del plan, hw
        torch.cuda.empty_cache()
    top = float(ref.H.abs().max())
    gap = (host["ell"].to(dev) - ref.H).abs().amax(dim=0)
    a["ell"]["H_from_reference_W_rel"] = float(gap.max()) / top
    a["scatter"]["H_from_reference_W_rel"] = rel_host(host["scatter"].T,
                                                      ref.H.T)
    col_nnz = np.bincount(sp.col, minlength=m)
    rng = np.random.default_rng(SEED + 24)
    cols = np.unique(np.concatenate([
        torch.topk(gap, 32).indices.cpu().numpy(),
        np.argsort(col_nnz)[-16:], rng.choice(m, 16, replace=False)]))
    del gap
    H64 = h_half64(sp, ref.W, H0c, cols, cfg.eps)
    f64 = {}
    for label, Hx in (("ell", host["ell"]), ("scatter", host["scatter"]),
                      ("compute_sparse", ref.H)):
        d = (Hx[:, torch.as_tensor(cols, device=Hx.device)].to(dev).double()
             - H64).abs().amax(dim=0) / top
        k = int(torch.argmax(d))
        f64[label] = (float(d[k]), int(col_nnz[cols[k]]))
    a["float64"] = f64
    a["float64_columns"] = len(cols)
    del ref, H64
    torch.cuda.empty_cache()
    ref = TS.compute_sparse(sp, dataclasses.replace(cfg, update_order="HW"),
                            W0=W0c, H0=H0c, strategy="scatter", device=dev)
    for engine, Hx in halves.items():
        a[engine]["H_rel"] = rel_host(Hx.T, ref.H.T)
    # the longest row and column: their sums set the reordering error
    a["longest"] = (int(np.bincount(sp.row).max()),
                    int(np.bincount(sp.col).max()))
    out["a"] = a
    del ref, host, halves, sp, W0c, H0c
    torch.cuda.empty_cache()

    # (b)'s references at config 2: the same cases on the 1 x 1 mesh, and
    # one iteration of compute_sparse on the same engine
    ratings = load_ratings(ratings_path)
    out["one"], _ = grid_runs(mesh, ratings, W0, H0, keep_factors=True)
    sparse_plans, refs = {}, {}
    for kind, engine in GRID_CASES:
        if engine not in sparse_plans:
            sparse_plans[engine] = TS.prepare_sparse(
                ratings, grid_config(kind, 1), strategy=engine, device=dev)
        wh = sparse_plans[engine].run(grid_config(kind, 1), W0=W0, H0=H0)
        hw = sparse_plans[engine].run(grid_config(kind, 1, order="HW"),
                                      W0=W0, H0=H0)
        refs[f"{kind}-{engine}"] = (wh.W.cpu().numpy(), hw.H.cpu().numpy(),
                                    wh.frobenius_error)
    out["sparse"] = refs
    return out


def grid_four_ranks(ratings_path, W0, H0):
    """Phase 24 (b): one rank of four sharing the card (gloo), a 2 x 2
    mesh, config 2."""
    import torch.distributed as dist

    from nmftpu_torch.kernels import hals_sweep as HS
    from nmftpu_torch.parallel import STAGED_BYTES, make_grid_mesh, psum
    from nmftpu_torch.sparse_ops import v_ht

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_grid_mesh(GRID_SHAPE)
    rank = dist.get_rank()
    ratings = load_ratings(ratings_path)
    out = {"rank": rank, "backend": dist.get_backend(),
           "coords": (mesh.get_local_rank("users"),
                      mesh.get_local_rank("items"))}
    out["cases"], plans = grid_runs(mesh, ratings, W0, H0,
                                    keep_factors=rank == 0)
    out["staged"] = dict(STAGED_BYTES)
    # #7 against its twin on this rank's own operands of a HALS W sweep
    plan = plans["scatter"]
    res = plan.run(grid_config("hals", 1), W0=W0, H0=H0, unpermute=False)
    local = plan.operand.local()
    XHt = psum(v_ht(local, res.H), mesh, "items")
    G = psum(res.H @ res.H.T, mesh, "items")
    got = HS.hals_sweep(XHt, G, res.W)
    want = HS.hals_sweep_plain(XHt, G, res.W)
    torch.cuda.synchronize()
    out["hals_twin"] = (float((got - want).abs().max()),
                        float(want.abs().max()), tuple(XHt.shape))
    return out


def serving_four_ranks(users):
    """Phase 24 (c): one rank of four sharing the card (gloo), a 1 x 4
    mesh, config 5 at full width. The ranks take turns to make phase 8's
    factors and keep their quarter of its int8 table."""
    import torch.distributed as dist

    from nmftpu_torch.kernels import count_above as CA
    from nmftpu_torch.kernels import mips_reservoir as MR
    from nmftpu_torch.parallel import make_grid_mesh
    from nmftpu_torch.serving import Recommender

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    mesh = make_grid_mesh(SERVE_GRID)
    rank, world = dist.get_rank(), dist.get_world_size()
    for turn in range(world):
        if turn == rank:
            W8, H8, train = serving_data(
                torch.Generator(device=dev).manual_seed(SEED + 8), dev)
            rec = Recommender(W8, H8, train=train, mesh=mesh,
                              method="reservoir", table_dtype="int8")
            exact = Recommender(W8, H8, train=train, mesh=mesh,
                                method="exact", table_dtype="int8")
            del W8, H8
            torch.cuda.empty_cache()
        dist.barrier()
    out = {"rank": rank, "m_local": int(rec.H.shape[1])}
    before = (MR.LAUNCHES["reservoir_scan"], CA.LAUNCHES["count_above"],
              CA.band_pairs())
    out["reservoir"] = rec.recommend(users, k=SERVE_K)
    out["exact"] = exact.recommend(users, k=SERVE_K + 1)
    out["certified"] = rec.recommend_certified(users, k=SERVE_K,
                                               fallback="exact")
    out["launches"] = (MR.LAUNCHES["reservoir_scan"] - before[0],
                       CA.LAUNCHES["count_above"] - before[1])
    out["band_pairs"] = CA.band_pairs() - before[2]
    out["ms"] = {
        "reservoir": event_ms(lambda: rec.recommend(users, k=SERVE_K), 2),
        "certified_exact": event_ms(lambda: rec.recommend_certified(
            users, k=SERVE_K, fallback="exact"), 2),
        "exact": event_ms(lambda: exact.recommend(users, k=SERVE_K), 1),
    }
    # #8 and #9 against their twins on this rank's own slice
    Wq = rec.W[torch.as_tensor(users, device=dev)]
    Wk = (Wq * rec._h_scale).contiguous()
    label = f"rank {rank} slice m={rec.H.shape[1]} b={len(users)} int8"
    a, cand, _ = check_reservoir(MR, label, Wk, rec.H, rec.H.shape[1], 4096)
    theta = cand.topk(SERVE_K, dim=1).values[:, -1].contiguous()
    d, _ = check_count(CA, label, Wq, rec.H, theta, rec._h_scale)
    out["twins"] = (a, d)
    return out


def grid_phase(nt, card, dev, ratings, c4, max_abs) -> dict:
    """Phase 24 (slice 6a): (a) one rank, NCCL, one device's share of
    config 4; (b) four ranks sharing the card on a 2 x 2 gloo mesh at
    config 2, against the 1 x 1 run and compute_sparse; (c) sharded
    serving of config 5 on four ranks. Every rank runs under the port's
    launcher, and any rank's failure fails the script. Returns the
    launches of #7, #8 and #9 on the ranks' main paths, and raises
    max_abs's entries to their errors against their twins on the ranks'
    operands."""
    import tempfile

    from nmftpu_torch.parallel import launch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="nmftpu_phase24_")
    try:
        c4_path, gen_s, c4_nnz = c4.result()
        n, m = ratings.shape
        r = SPARSE_RANK
        path = os.path.join(tmp, "ratings.npz")
        np.savez(path, indptr=ratings.indptr, indices=ratings.indices,
                 data=ratings.data, shape=np.array(ratings.shape))
        W0, H0 = config2_start(n, m, r,
                               float(ratings.data.sum(dtype=np.float64)), dev)
        W0, H0 = W0.cpu().numpy(), H0.cpu().numpy()
        torch.cuda.empty_cache()

        # -- (a) and (b)'s references: one rank, NCCL ----------------------
        t0 = time.perf_counter()
        one = launch(grid_one_rank, 1, args=(c4_path, path, W0, H0),
                     backend="nccl", timeout=GRID_TIMEOUT)[0]
        a = one["a"]
        # float32 sums of K terms in two orders: sqrt(K) 2^-24 apart each
        lim_w, lim_h = (max(GRID_STEP_RTOL, 8 * k ** 0.5 * 2.0 ** -24)
                        for k in a["longest"])
        say("24a config 4 share", shape=f"{C4_SHAPE[0]}x{C4_SHAPE[1]}",
            rank=C4_RANK, draws=C4_DRAWS, nnz=a["nnz"],
            generator_s=f"{gen_s:.1f}", backend=one["backend"],
            world=one["world"], seconds=f"{time.perf_counter() - t0:.1f}")
        for engine in ("ell", "scatter"):
            g = a[engine]
            say("24a engine", engine=engine, prepare_s=f"{g['prepare_s']:.1f}",
                run_1_iteration_s=f"{g['run1_s']:.2f}",
                update_ms=f"{g['update_ms']:.1f}",
                **({"iteration_with_check_ms":
                    f"{g['iteration_with_check_ms']:.1f}",
                    "errors": [f"{e:.6g}" for e in g["errors"]]}
                   if engine == "ell" else {}),
                error_1=f"{g['error1']:.6g}", W_rel=f"{g['W_rel']:.3e}",
                H_rel=f"{g['H_rel']:.3e}",
                H_after_own_W_half_rel=f"{g['H_after_W_rel']:.3e}",
                H_from_compute_sparse_W_half_rel=
                f"{g['H_from_reference_W_rel']:.3e}",
                H_from_compute_sparse_W_half_vs_float64=
                f"{a['float64'][engine][0]:.3e} (column of "
                f"{a['float64'][engine][1]} nonzeros)",
                longest_row_column=a["longest"],
                W_rtol=f"{lim_w:.3e}", H_rtol=f"{lim_h:.3e}",
                peak_GiB=f"{g['peak_GiB']:.1f}", card=card)
            e_rel = abs(g["error1"] - a["compute_sparse"]["error1"]) \
                / a["compute_sparse"]["error1"]
            # H after the W half: the whole iteration within lim_h of
            # compute_sparse's, or else the engine's H half from
            # compute_sparse's own W half within lim_h of float64 (where
            # the two engines differ, the grid's must be the nearer)
            h_ok = (g["H_after_W_rel"] <= lim_h
                    or a["float64"][engine][0] <= lim_h)
            if not (g["W_rel"] <= lim_w and g["H_rel"] <= lim_h and h_ok
                    and e_rel <= GRID_STEP_RTOL):
                fail(f"phase 24 (a) {engine}: one iteration differs from "
                     f"compute_sparse (W {g['W_rel']:.3e}, H "
                     f"{g['H_rel']:.3e}, H after the W half "
                     f"{g['H_after_W_rel']:.3e}, error {e_rel:.3e}; "
                     f"its H half from compute_sparse's W half "
                     f"{a['float64'][engine][0]:.3e} off float64 (limit "
                     f"{lim_h:.3e})")
        if not (a["finite"] and a["ell"]["errors"][1] < a["ell"]["errors"][0]):
            fail(f"phase 24 (a): non-finite factors or the error did not "
                 f"fall: {a['ell']['errors']}")
        cs = a["compute_sparse"]
        say("24a compute_sparse", engine="scatter", seconds=f"{cs['secs']:.1f}",
            error_1=f"{cs['error1']:.6g}", peak_GiB=f"{cs['peak_GiB']:.1f}",
            H_half_from_its_W_half_vs_float64=
            f"{a['float64']['compute_sparse'][0]:.3e} (column of "
            f"{a['float64']['compute_sparse'][1]} nonzeros)",
            float64_columns=a["float64_columns"])

        # -- (b) four ranks sharing the card, gloo, 2 x 2 ------------------
        t0 = time.perf_counter()
        four = launch(grid_four_ranks, GRID_RANKS, args=(path, W0, H0),
                      backend="gloo", timeout=GRID_TIMEOUT, threads=2)
        b_s = time.perf_counter() - t0
        # iALS's per-row solves: each half against float64 normal equations
        # on 64 users and 64 items (the most popular included), each row
        # within (SOLVE_FACTOR sqrt(r) + 4 sqrt(K)) kappa 2^-24: phase 22's
        # solve limit, plus the system's own float32 assembly (its Gram and
        # right-hand side are sums of the row's K nonzeros' terms, in any
        # order ~sqrt(K) 2^-24 from float64; config 2's values up to 5
        # give weights up to 200, so the head items' K ~ 10^4 reach kappa)
        csc = ratings.T.to_csr()
        rng = np.random.default_rng(SEED + 24)
        lines = []
        for csr_, count in ((ratings, n), (csc, m)):
            top = int(np.argmax(np.diff(csr_.indptr)))
            lines.append(np.concatenate([[top], rng.choice(
                np.setdiff1d(np.arange(count), [top]), 63, replace=False)]))
        H0d, W0d = torch.as_tensor(H0, device=dev), torch.as_tensor(W0,
                                                                    device=dev)
        want_w, kap_w = row_systems64(ratings, lines[0], H0d.T, 40.0, 0.0,
                                      False)
        want_h, kap_h = row_systems64(csc, lines[1], W0d, 40.0, 0.0, False)
        assembly = [4 * torch.as_tensor(np.diff(c.indptr)[idx], device=dev,
                                        dtype=torch.float64).sqrt() * 2.0**-24
                    for c, idx in ((ratings, lines[0]), (csc, lines[1]))]
        del csc, H0d, W0d
        hals = 0
        for name in (f"{k}-{e}" for k, e in GRID_CASES):
            got, ref1 = four[0]["cases"][name], one["one"][name]
            Ws, Hs, e_sparse = one["sparse"][name]
            tol = HALS_ATOL if name.startswith("hals") else GRID_STEP_RTOL
            dev1 = max(rel_to_max(got["WH"], ref1["WH"]),
                       rel_to_max(got["HW"], ref1["HW"]))
            devs = max(rel_to_max(got["WH"], Ws), rel_to_max(got["HW"], Hs))
            iters = 1 if name.startswith("ials") else GRID_ITERS
            e4 = abs(got[iters, "WH"]["error"] - ref1[iters, "WH"]["error"]) \
                / ref1[iters, "WH"]["error"]
            runs = [k for k in got if isinstance(k, tuple)]
            launched = [f["cases"][name][k]["hals"] for f in four
                        for k in runs]
            hals += sum(launched)
            # iALS: its one-iteration run, set-up and checks included
            ms = [((f["cases"][name][iters, "WH"]["secs"]
                    - f["cases"][name][1, "WH"]["secs"]) / (iters - 1)
                   if iters > 1 else f["cases"][name][1, "WH"]["secs"]) * 1e3
                  for f in four]
            say("24b grid 2x2", case=name, vs_1x1=f"{dev1:.3e}",
                vs_compute_sparse=f"{devs:.3e}",
                rtol=("per row, against float64 (below)"
                      if name.startswith("ials") else tol),
                error_after=iters,
                error=f"{got[iters, 'WH']['error']:.6g}",
                error_1x1=f"{ref1[iters, 'WH']['error']:.6g}",
                error_rel=f"{e4:.3e}", error_rtol=GRID_ERR_RTOL,
                hals_launches_per_rank=launched,
                staged_MB_rank0=f"{got[iters, 'WH']['staged'] / 2**20:.1f}",
                ms_per_iteration_per_rank=[f"{x:.1f}" for x in ms])
            if name.startswith("ials"):
                # the solves amplify the Grams' reordering by kappa, so
                # each sampled row is held per row: the 2 x 2 run, the
                # 1 x 1 run and compute_sparse against float64 (the
                # assembly term included; phase 22's limit without it
                # printed as the witness of where a miss comes from), and
                # the 2 x 2 run against the other two at twice the limit
                sel = {label: (torch.as_tensor(Wx[lines[0]], device=dev),
                               torch.as_tensor(Hx[:, lines[1]].T,
                                               device=dev))
                       for label, (Wx, Hx) in (
                           ("2x2", (got["WH"], got["HW"])),
                           ("1x1", (ref1["WH"], ref1["HW"])),
                           ("compute_sparse", (Ws, Hs)))}
                checks = {}
                for label, (Wx, Hx) in sel.items():
                    checks[label] = (
                        per_row_check(Wx, want_w, kap_w, r, assembly[0]),
                        per_row_check(Hx, want_h, kap_h, r, assembly[1]))
                    checks[f"{label}_phase22_limit"] = (
                        per_row_check(Wx, want_w, kap_w, r),
                        per_row_check(Hx, want_h, kap_h, r))
                for other in ("1x1", "compute_sparse"):
                    checks[f"2x2_vs_{other}"] = tuple(
                        per_row_check(sel["2x2"][h], sel[other][h].double(),
                                      kap, r, extra, scale=2.0)
                        for h, kap, extra in ((0, kap_w, assembly[0]),
                                              (1, kap_h, assembly[1])))
                say("24b ials rows", **{
                    f"{label}_{half}_worst_ratio_to_limit":
                    f"{c[0]:.3e} (rel {c[1]:.3e}, kappa {c[2]:.4g})"
                    for label, pair in checks.items()
                    for half, c in zip("WH", pair)})
                worst = {label: max(c[0] for c in pair)
                         for label, pair in checks.items()}
                held = [label for label in worst if "phase22" not in label]
                if max(worst[label] for label in held) > 1:
                    fail(f"phase 24 (b) iALS: a row is off its limit: "
                         f"{worst}")
                if worst["compute_sparse_phase22_limit"] <= 1 < max(
                        worst["1x1_phase22_limit"],
                        worst["2x2_phase22_limit"]):
                    fail("phase 24 (b) iALS: compute_sparse meets phase "
                         f"22's per-row limit and the grid does not: {worst}")
            elif not (dev1 <= tol and devs <= tol):
                fail(f"phase 24 (b) {name}: the 2 x 2 run differs (1 x 1 "
                     f"{dev1:.3e}, compute_sparse {devs:.3e})")
            if not e4 <= GRID_ERR_RTOL:
                fail(f"phase 24 (b) {name}: the 2 x 2 run's error differs "
                     f"from the 1 x 1 run's by {e4:.3e}")
            if name.startswith("hals") and launched != [2, 2, 2 * iters] * 4:
                fail(f"phase 24 (b): #7 launched {launched} times on the "
                     f"ranks, not 2 an iteration")
            errs = {f["cases"][name][iters, "WH"]["error"] for f in four}
            if len(errs) != 1:
                fail(f"phase 24 (b) {name}: the ranks disagree: {errs}")
        for f in four:
            diff, scale, shape = f["hals_twin"]
            max_abs["hals_sweep"] = max(max_abs["hals_sweep"], diff)
            say("24b hals_sweep twin", rank=f["rank"], coords=f["coords"],
                operands=shape, max_abs=f"{diff:.3e}",
                rel_to_max=f"{diff / scale:.3e}", bound=HALS_ATOL)
            if not diff <= HALS_ATOL * scale:
                fail(f"phase 24 (b) rank {f['rank']}: #7 disagrees with "
                     "its twin")
        ials = four[0]["cases"]["ials-scatter"][1, "WH"]["staged"]
        say("24b staging", backend=four[0]["backend"],
            STAGED_BYTES_per_rank=[f["staged"] for f in four],
            ials_one_iteration_staged_MB_rank0=f"{ials / 2**20:.1f}",
            prepare_s_rank0={k: f"{v:.1f}" for k, v in four[0]["cases"]
                             .items() if k.startswith("prepare")},
            seconds=f"{b_s:.1f}",
            note="four processes time-share one card: these times say "
                 "nothing about scaling", card=card)

        # -- (c) sharded serving of config 5, four ranks -------------------
        users = np.sort(np.random.default_rng(SEED).choice(
            SERVE_USERS, 512, replace=False))
        t0 = time.perf_counter()
        serve = launch(serving_four_ranks, GRID_RANKS, args=(users,),
                       backend="gloo", timeout=GRID_TIMEOUT, threads=2)
        c_s = time.perf_counter() - t0
        W8, H8, train = serving_data(
            torch.Generator(device=dev).manual_seed(SEED + 8), dev)
        oracle = nt.Recommender(W8, H8, train=train, method="exact",
                                table_dtype="int8", device=dev)
        s_o, i_o = oracle.recommend(users, k=SERVE_K + 1)
        del W8, H8, oracle
        torch.cuda.empty_cache()
        seen = [set(train.indices[train.indptr[u]:train.indptr[u + 1]]
                    .tolist()) for u in users]
        launched = [f["launches"] for f in serve]
        for f in serve:
            s, i = f["reservoir"]
            recall = np.mean([len(set(i[row].tolist())
                                  & set(i_o[row, :SERVE_K].tolist()))
                              / SERVE_K for row in range(len(users))])
            s_c, i_c, cert = f["certified"]
            s_x, i_x = f["exact"]
            violations = sum(len(set(i[row].tolist()) & seen[row])
                             + len(set(i_c[row].tolist()) & seen[row])
                             for row in range(len(users)))
            not_exact = rows_not_exact(s_c, i_c, s_o, i_o, SERVE_K)
            exact_differs = rows_not_exact(s_x[:, :SERVE_K],
                                           i_x[:, :SERVE_K], s_o, i_o,
                                           SERVE_K)
            a8, d9 = f["twins"]
            max_abs["reservoir_scan"] = max(max_abs["reservoir_scan"], a8)
            max_abs["count_above"] = max(max_abs["count_above"], d9)
            say("24c serve 1x4", rank=f["rank"], items_per_rank=f["m_local"],
                batch=len(users), k=SERVE_K, recall_at_100=f"{recall:.6f}",
                seen_violations=violations,
                certified_fraction=f"{cert.mean():.6f}",
                rows_not_exact=not_exact,
                exact_rows_unlike_unsharded=exact_differs,
                launches_reservoir_count=f["launches"],
                band_pairs=f["band_pairs"],
                ms={k: f"{v:.1f}" for k, v in f["ms"].items()})
            if not (recall >= RECALL_FLOOR and violations == 0
                    and not_exact == 0 and exact_differs == 0):
                fail(f"phase 24 (c) rank {f['rank']}: recall {recall:.6f}, "
                     f"{violations} seen violations, {not_exact} rows not "
                     f"exact, {exact_differs} exact rows unlike the "
                     "unsharded scan")
            if min(f["launches"]) < 1:
                fail(f"phase 24 (c) rank {f['rank']}: kernels not launched "
                     f"{f['launches']}")
        say("24c", seconds=f"{c_s:.1f}", card=card,
            note="four processes time-share one card: these times say "
                 "nothing about scaling")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("24", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return {"hals_sweep": hals,
            "reservoir_scan": sum(x[0] for x in launched),
            "count_above": sum(x[1] for x in launched)}


# phase 25: slice 6b. The rank programs below run in the processes of the
# port's launcher (spawned: each imports this file as a module).
# ---------------------------------------------------------------------------


def ring_config(kind: str, order: str, rank: int = SPARSE_RANK):
    """Phase 25 (a)'s configs, one iteration from W0/H0: order "WH" takes
    the W half from (W0, H0), "HW" the H half, as phase 24 holds them."""
    from nmftpu_torch.config import (Algorithm, Initialization, NmfConfig,
                                     Objective)

    knobs = {"mu-frobenius": {}, "mu-kl": dict(objective=Objective.KL),
             "beta-1.5": dict(objective=Objective.BETA, beta=1.5),
             "als": dict(algorithm=Algorithm.ALS),
             "gdcls": dict(algorithm=Algorithm.GDCLS),
             "nsnmf": dict(algorithm=Algorithm.NSNMF),
             "weighted": dict(alpha_confidence=C3_ALPHA)}[kind]
    return NmfConfig(rank=rank, init_method=Initialization.COPY_EXISTING,
                     num_iterations=1, check_interval=1, update_order=order,
                     **knobs)


def ring_limits(kind: str, K: int, kappa_w: float, kappa_h: float, r: int):
    """(W limit, H limit) of one ring half against compute_sparse's:
    scatter's float32 sums of up to K terms in another order, 8 sqrt(K)
    2^-24 (GRID_STEP_RTOL at least); a solved half also moves by its
    system's condition, (10 sqrt(r) + 8 sqrt(K)) kappa 2^-24."""
    base = max(GRID_STEP_RTOL, 8 * K ** 0.5 * 2.0 ** -24)

    def solved(kappa):
        return max(base, (10 * r ** 0.5 + 8 * K ** 0.5) * kappa * 2.0 ** -24)

    if kind == "als":
        return solved(kappa_w), solved(kappa_h)
    if kind == "gdcls":
        return base, solved(kappa_h)
    return base, base


def load_coo(path):
    from nmftpu_torch.sparse import SparseCOO

    z = np.load(path)
    return SparseCOO(z["row"], z["col"], z["data"],
                     tuple(int(x) for x in z["shape"]))


class CSRTiles:
    """Dense V as a view of a host CSR: V[rows, cols] (two slices) is the
    dense block, made on the card. What `driver.compute(mesh=)` reads of
    V is its shape and each rank's tile, so no rank holds V whole."""

    def __init__(self, csr, dev):
        self.csr, self.dev = csr, dev
        self.shape, self.ndim = csr.shape, 2

    def __getitem__(self, key):
        (r0, r1, _), (c0, c1, _) = (s.indices(n) for s, n in
                                    zip(key, self.shape))
        ip = self.csr.indptr
        lo, hi = int(ip[r0]), int(ip[r1])
        rows = np.repeat(np.arange(r1 - r0), np.diff(ip[r0:r1 + 1]))
        cols = self.csr.indices[lo:hi].astype(np.int64)
        keep = (cols >= c0) & (cols < c1)
        out = torch.zeros((r1 - r0, c1 - c0), device=self.dev)
        out[torch.as_tensor(rows[keep], device=self.dev),
            torch.as_tensor(cols[keep] - c0, device=self.dev)] = \
            torch.as_tensor(self.csr.data[lo:hi][keep], device=self.dev)
        return out


def dense_config(storage: str, iters: int, **knobs):
    from nmftpu_torch.config import Initialization, NmfConfig

    return NmfConfig(rank=knobs.pop("rank", SPARSE_RANK),
                     init_method=Initialization.COPY_EXISTING,
                     num_iterations=iters, check_interval=1,
                     v_storage=storage, **knobs)


# (b)'s 4096^2 runs: (mesh shape, label, knobs); the axis of size 1 makes
# a half local (#1-#4 whole), #5 takes the other; Jacobi int8 runs #6's
# dual entry per tile
DENSE_4096 = (((4, 1), "f32-pallas", dict(use_pallas=True)),
              ((1, 4), "f32-pallas", dict(use_pallas=True)),
              ((4, 1), "int8-pallas", dict(v_storage="int8",
                                           use_pallas=True)),
              ((1, 4), "int8-pallas", dict(v_storage="int8",
                                           use_pallas=True)),
              ((2, 2), "int8-jacobi", dict(v_storage="int8", use_pallas=True,
                                           mu_style="jacobi")))


def headline_v(dev):
    """Phase 4's V, W0, H0 (4096^2, rank 256), made again from its seed."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    V = synthetic_lowrank(4096, 4096, 256, gen, dev)
    W0 = torch.rand(4096, 256, generator=gen, device=dev) + 0.01
    H0 = torch.rand(256, 4096, generator=gen, device=dev) + 0.01
    return V, W0, H0


def all_launches():
    """Every kernel wrapper's count, by name."""
    from nmftpu_torch.kernels import count_above as CA
    from nmftpu_torch.kernels import dense_mu as K
    from nmftpu_torch.kernels import dual_numer as DN
    from nmftpu_torch.kernels import hals_sweep as HS
    from nmftpu_torch.kernels import mips_reservoir as MR
    from nmftpu_torch.kernels import quantized as Q
    from nmftpu_torch.kernels import sparse_ell_kernel as SEK

    out = {}
    for counts in (K.LAUNCHES, Q.LAUNCHES, DN.LAUNCHES, HS.LAUNCHES,
                   MR.LAUNCHES, CA.LAUNCHES, SEK.LAUNCHES):
        out.update(counts)
    return dict(out)


def launches_since(before):
    now = all_launches()
    return {k: now[k] - before.get(k, 0) for k in now}


class RecordedMuldiv:
    """Inside `with`, every #5 launch of the path also keeps a copy of
    its operands, so that `check` can hold the kernel against its twin on
    exactly the shapes and values the path gave it."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from nmftpu_torch.kernels import dense_mu as K

        self.real = real = K.fused_multiply_divide

        def spy(X, numer, denom, eps=1e-9):
            self.calls.append((X.clone(), numer.clone(), denom.clone(), eps))
            return real(X, numer, denom, eps)

        K.fused_multiply_divide = spy
        return self

    def __exit__(self, *exc):
        from nmftpu_torch.kernels import dense_mu as K

        K.fused_multiply_divide = self.real

    def check(self, where):
        """#5 against its twin on each recorded call, bit for bit (these
        launches come after the path's count is read). Returns
        (calls, max |kernel - twin|, shapes)."""
        from nmftpu_torch.kernels import dense_mu as K

        worst, shapes = 0.0, set()
        for X, numer, denom, eps in self.calls:
            got = K.fused_multiply_divide(X, numer, denom, eps)
            want = K.fused_multiply_divide_plain(X, numer, denom, eps)
            d = float((got - want).abs().max())
            if not torch.equal(got, want):
                fail(f"#5 differs from its twin by {d} on {where}'s "
                     f"operands {tuple(X.shape)}")
            worst = max(worst, d)
            shapes.add(tuple(X.shape))
        n = len(self.calls)
        self.calls = []
        return n, worst, sorted(shapes)


def ring_section(mesh, sp, W0, H0, kinds, refs, limits, rank, chunk=1 << 17):
    """(a) on `mesh`: one iteration in each order of each kind on the
    ring; rank 0 holds each half against compute_sparse's (refs, an npz
    path). Returns {kind: row}."""
    import torch.distributed as dist

    from nmftpu_torch.parallel import STAGED_BYTES, prepare_sharded

    ref = np.load(refs)
    t0 = time.perf_counter()
    plan = prepare_sharded(sp, ring_config(kinds[0], "WH", rank),
                           mesh=mesh, engine="ring", chunk=chunk)
    out = {"prepare_s": time.perf_counter() - t0}
    for kind in kinds:
        row = {}
        for order in ("HW", "WH"):
            staged = sum(STAGED_BYTES.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = plan.run(ring_config(kind, order, rank), W0=W0, H0=H0)
            torch.cuda.synchronize()
            row[order] = dict(secs=time.perf_counter() - t0,
                              error=res.error,
                              staged=sum(STAGED_BYTES.values()) - staged)
            if dist.get_rank() == 0:
                X = res.W if order == "WH" else res.H
                Y = torch.as_tensor(ref[f"{kind}-{order}"], device=X.device)
                row[order]["rel"] = float((X - Y).abs().max()
                                          / Y.abs().max())
                row[order]["limit"] = limits[kind][order == "HW"]
            del res
        out[kind] = row
    del plan
    torch.cuda.empty_cache()
    return out


def dense_section(mesh, ratings, W0, H0, save):
    """(b) at the ML-20M shape on `mesh`: MU Frobenius, float32 and int8 V,
    one iteration in each order, so that each half starts from (W0, H0)
    (the first rank saves the W of "WH" and the H of "HW" to `save`), and
    DENSE_ITERS (the errors)."""
    import torch.distributed as dist

    import nmftpu_torch as nt

    dev = torch.device("cuda")
    V = CSRTiles(ratings, dev)
    out = {}
    for storage in ("float32", "int8"):
        halves = {}
        for order in ("HW", "WH"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one = nt.driver.compute(V, dense_config(storage, 1,
                                                    update_order=order),
                                    W0=W0, H0=H0, mesh=mesh)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            halves[order] = (one.W if order == "WH" else one.H).cpu().numpy()
            del one
        if dist.get_rank() == 0:
            np.savez(f"{save}-{storage}.npz", W=halves["WH"],
                     H=halves["HW"])
        more = nt.driver.compute(V, dense_config(storage, DENSE_ITERS),
                                 W0=W0, H0=H0, mesh=mesh)
        out[storage] = dict(secs_one=secs, errors=list(more.stats.errors))
        del more
        torch.cuda.empty_cache()
    return out


def dense_4096_section(shapes_meshes, save, max_abs, muldiv):
    """(b) at 4096^2 / rank 256 (phase 4's V): DENSE_4096's runs, one
    iteration each (the first rank saves the factors), #5 against its
    twin on the operands each run gave it, and the kernels of the local
    halves against their twins on this rank's operands."""
    import torch.distributed as dist

    import nmftpu_torch as nt
    from nmftpu_torch.algorithms.registry import _quantize_v
    from nmftpu_torch.kernels import dense_mu as K
    from nmftpu_torch.kernels import dual_numer as DN
    from nmftpu_torch.kernels import quantized as Q
    from nmftpu_torch.linalg import dense as D
    from nmftpu_torch.parallel.dense_mesh import (
        DenseTile, MeshSums, _tile_of, block_shape)
    from nmftpu_torch.parallel.mesh import AXIS_ITEMS, AXIS_USERS

    dev = torch.device("cuda")
    V, W0, H0 = headline_v(dev)
    out = {}
    for shape, label, knobs in DENSE_4096:
        mesh = shapes_meshes[shape]
        kn = dict(knobs)
        cfg = dense_config(kn.pop("v_storage", "float32"), 1, rank=256,
                           **kn)
        before = all_launches()
        with RecordedMuldiv() as rec:
            res = nt.driver.compute(V, cfg, W0=W0, H0=H0, mesh=mesh)
        torch.cuda.synchronize()
        out[shape, label] = launches_since(before)
        muldiv[shape, label] = rec.check(f"{label} {shape}")
        if dist.get_rank() == 0:
            np.savez(f"{save}-{label}-{shape[0]}x{shape[1]}.npz",
                     W=res.W.cpu().numpy(), H=res.H.cpu().numpy())
        # the kernels against their twins on this rank's tile and blocks
        br, bc = block_shape(V.shape, shape)
        i, j = mesh.get_local_rank(AXIS_USERS), mesh.get_local_rank(AXIS_ITEMS)
        tile = DenseTile(V=_tile_of(V, slice(i * br, (i + 1) * br),
                                    slice(j * bc, (j + 1) * bc), (br, bc),
                                    torch.float32, dev),
                         shape=tuple(V.shape), coords=(i, j))
        Wb = W0[i * br:(i + 1) * br].contiguous()
        Hb = H0[:, j * bc:(j + 1) * bc].contiguous()
        sums = MeshSums(mesh)
        if cfg.v_storage == "int8":
            Vq, scale = _quantize_v(sums)(tile.V)
        Gw, Gh = H0 @ H0.T, W0.T @ W0
        pairs = {}
        if label == "f32-pallas" and shape == (4, 1):
            pairs["w_update_fused"] = (
                K.w_update_fused(tile.V, Wb, Hb, Gw),
                K.w_update_fused_plain(tile.V, Wb, Hb, Gw))
        if label == "f32-pallas" and shape == (1, 4):
            pairs["h_update_fused"] = (
                K.h_update_fused(tile.V, Wb, Hb, Gh),
                K.h_update_fused_plain(tile.V, Wb, Hb, Gh))
        if label == "int8-pallas" and shape == (4, 1):
            pairs["w_update_fused_q"] = (
                Q.w_update_fused_q(Vq, scale, Wb, Hb, Gw),
                Q.w_update_fused_q_plain(Vq, scale, Wb, Hb, Gw))
        if label == "int8-pallas" and shape == (1, 4):
            pairs["h_update_fused_q"] = (
                Q.h_update_fused_q(Vq, scale, Wb, Hb, Gh),
                Q.h_update_fused_q_plain(Vq, scale, Wb, Hb, Gh))
        if label == "int8-jacobi":
            s_w, WqT = D._quantize_wt(Wb, sums)
            s_h, Hq = D._quantize_h(Hb, sums)
            got = DN.dual_int8(Vq, WqT, Hq)
            want = DN.dual_int8_plain(Vq, WqT, Hq)
            pairs["dual_numerators_int8"] = (
                torch.cat([got[0].reshape(-1), got[1].reshape(-1)]).double(),
                torch.cat([want[0].reshape(-1), want[1].reshape(-1)])
                .double())
        torch.cuda.synchronize()
        for name, (got, want) in pairs.items():
            max_abs[name] = max(max_abs.get(name, 0.0),
                                float((got - want).abs().max()))
        n_calls, d, _ = muldiv[shape, label]
        if n_calls:
            max_abs["fused_multiply_divide"] = max(
                max_abs.get("fused_multiply_divide", 0.0), d)
        del res, tile, pairs
        torch.cuda.empty_cache()
    return out


def foldin_section(mesh, cold, max_abs):
    """(c): config 5's int8 table sharded over `mesh` (the ranks make
    phase 8's factors in turns), the cold users' fold-ins (ALS, MU, HALS)
    and recommend_from_history_batch at b = FOLD_B, #7 and #8 against
    their twins on this rank."""
    import torch.distributed as dist

    from nmftpu_torch.kernels import hals_sweep as HS
    from nmftpu_torch.kernels import mips_reservoir as MR
    from nmftpu_torch.serving import Recommender

    dev = torch.device("cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    for turn in range(world):
        if turn == rank:
            W8, H8, train = serving_data(
                torch.Generator(device=dev).manual_seed(SEED + 8), dev)
            rec = Recommender(W8, H8, train=train, mesh=mesh,
                              method="reservoir", table_dtype="int8")
            del W8, H8
            torch.cuda.empty_cache()
        dist.barrier()
    hists = list(cold[:FOLD_B])
    before = all_launches()
    t0 = time.perf_counter()
    prep = rec._prep()
    folded = {"als": rec.fold_in_batch(hists)}
    for rule in ("mu", "hals"):
        folded[rule] = rec.fold_in_batch(hists, algorithm=rule,
                                         num_iterations=COLD_ITERS)
    top = rec.recommend_from_history_batch(hists, k=SERVE_K)
    torch.cuda.synchronize()
    out = {"launches": launches_since(before),
           "secs": time.perf_counter() - t0, "m_local": int(rec.H.shape[1])}
    if rank == 0:
        out.update(G=prep.G.cpu().numpy(), folded=folded, top=top)
    # #7 and #8 against their twins on this rank's operands
    W = torch.as_tensor(folded["hals"], device=dev)
    N = torch.as_tensor(folded["als"], device=dev) @ prep.G
    got, want = HS.hals_sweep(N, prep.G, W), HS.hals_sweep_plain(N, prep.G, W)
    max_abs["hals_sweep"] = float((got - want).abs().max())
    if not max_abs["hals_sweep"] <= HALS_ATOL * float(want.abs().max()):
        fail(f"rank {rank}: #7 differs from its twin by "
             f"{max_abs['hals_sweep']:.3e} on the fold-in's operands")
    Wk = (torch.as_tensor(folded["als"], device=dev)
          * rec._h_scale).contiguous()
    a, _, _ = check_reservoir(MR, f"rank {rank} fold-in b={FOLD_B} int8",
                              Wk, rec.H, rec.H.shape[1], 4096)
    max_abs["reservoir_scan"] = a
    del rec, prep
    torch.cuda.empty_cache()
    return out


def minibatch_section(mesh, ratings_path, W0, H0):
    """(d): MiniBatchNMF(mesh=), KL, MB_BATCH-row panels, one epoch at
    config 2."""
    import scipy.sparse as sps

    from nmftpu_torch import sklearn_api as SK

    ratings = load_ratings(ratings_path)
    X = sps.csr_matrix((ratings.data, ratings.indices, ratings.indptr),
                       shape=ratings.shape)
    est = SK.MiniBatchNMF(n_components=SPARSE_RANK, init="custom",
                          beta_loss="kullback-leibler", batch_size=MB_BATCH,
                          max_iter=1, tol=0.0, max_no_improvement=None,
                          mesh=mesh)
    t0 = time.perf_counter()
    W = est.fit_transform(X, W=W0, H=H0)
    return {"secs": time.perf_counter() - t0, "W": W,
            "H": est.components_, "err": est.reconstruction_err_}


def _stand_in(kind, attrs):
    """An object of class name `kind` holding `attrs`: what the convert
    functions read of an nmftpu object."""
    return type(kind, (), dict(attrs))()


def config1_dense():
    """Config 1's shape as a dense V (the rank selections of phase 25)."""
    n1, m1, nnz1 = CONFIG1
    rng = np.random.default_rng(SEED + 23)
    config1 = np.zeros(n1 * m1, np.float32)
    config1[rng.choice(n1 * m1, nnz1, replace=False)] = rng.integers(
        1, 6, nnz1)
    return config1.reshape(n1, m1)


RANK_SELECTION = dict(ranks=(16, 32), n_runs=3, num_iterations=50,
                      seed=SEED)
# the mesh's rank selection against the unsharded one from the same
# draws: float32 sums in another order can flip a row's argmax in a near
# tie, which moves a consensus entry by 1/n_runs
RANK_SELECTION_RTOL = 1e-3


def surfaces_section(mesh, ratings_path, W0, H0, ck_dir, dev, muldiv):
    """(e): NMF(mesh=) at config 2, checkpoint.resume(mesh=) of phase
    23's checkpoint (its #5 operands recorded in `muldiv`),
    rank_selection(mesh=) at config 1, and the three conversions onto
    the mesh."""
    import scipy.sparse as sps
    import torch.distributed as dist

    import nmftpu_torch as nt
    from nmftpu_torch import checkpoint as CK
    from nmftpu_torch import convert
    from nmftpu_torch import minibatch as MB
    from nmftpu_torch import sklearn_api as SK
    from nmftpu_torch.serving import Recommender, quantize_table
    from nmftpu_torch.sparse import from_dense

    out = {}
    ratings = load_ratings(ratings_path)
    X = sps.csr_matrix((ratings.data, ratings.indices, ratings.indptr),
                       shape=ratings.shape)
    est = SK.NMF(n_components=SPARSE_RANK, init="custom", solver="mu",
                 max_iter=2, tol=0.0, strategy="ell", mesh=mesh)
    t0 = time.perf_counter()
    Wn = est.fit_transform(X, W=W0, H=H0)
    out["nmf"] = {"secs": time.perf_counter() - t0,
                  "err": est.reconstruction_err_,
                  "W": Wn if dist.get_rank() == 0 else None}
    V0, _, _ = headline_v(dev)
    cfg = dense_config("float32", BATCH_ITERS, rank=256, use_pallas=True)
    cfg = dataclasses.replace(cfg, check_interval=10)
    with muldiv:
        res = CK.resume(ck_dir, V0, cfg, mesh=mesh)
    out["resume"] = {"error": res.error, "iterations": res.num_iterations,
                     "W": res.W.cpu().numpy() if dist.get_rank() == 0
                     else None}
    del V0, res
    sel = nt.rank_selection(config1_dense(), mesh=mesh, **RANK_SELECTION)
    out["ranks"] = {"best": sel.best_rank,
                    "cophenetic": list(sel.cophenetic),
                    "dispersion": list(sel.dispersion)}
    # the conversions: stand-ins with an nmftpu object's attributes, made
    # from the port's own objects on one card
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    Wr = torch.rand(2048, 64, generator=gen, device=dev)
    Hr = torch.rand(64, 8192, generator=gen, device=dev)
    Hq, hs = quantize_table(Hr)
    seen = from_dense((torch.rand(2048, 8192, generator=gen, device=dev)
                       < 0.01).float().cpu().numpy()).to_csr()
    rec = convert.recommender_from_nmftpu(_stand_in("Recommender", {
        "W": Wr.cpu().numpy(), "H": Hq.cpu().numpy(), "_m_items": 8192,
        "table_dtype": "int8", "_h_scale": hs.cpu().numpy(),
        "_train_csr": seen, "block": 1024, "method": "exact",
        "reservoir_slots": 4096, "mesh": True}), device=dev, mesh=mesh)
    direct = Recommender.from_table(Wr, Hq, h_scale=hs, train=seen,
                                    block=1024, method="exact", device=dev)
    users = np.arange(64)
    s1, i1 = rec.recommend(users, k=10)
    s2, i2 = direct.recommend(users, k=11)
    out["convert_recommender"] = rows_not_exact(s1, i1, s2, i2, 10)
    Vmb = torch.rand(256, 4096, generator=gen, device=dev)
    H0m = torch.rand(16, 4096, generator=gen, device=dev) + 0.01
    W0m = torch.rand(128, 16, generator=gen, device=dev) + 0.01
    one = MB.OnlineNMF(16, batch_size=128, device=dev)
    one.partial_fit(Vmb[:128], H0=H0m)
    attrs = {k: getattr(one, k) for k in convert._ONLINE_PARAMS}
    attrs.update(rank=16, dtype=np.float32, rho=one.rho,
                 n_steps=one.n_steps, _shardings=True,
                 H=one.H.cpu().numpy(), _A=one._A.cpu().numpy(),
                 _B=one._B.cpu().numpy())
    moved = convert.online_state_from_nmftpu(_stand_in("OnlineNMF", attrs),
                                             device=dev, mesh=mesh)
    moved.partial_fit(Vmb[128:])
    one.partial_fit(Vmb[128:])
    a = moved.components()
    out["convert_online"] = float((a - one.H).abs().max()
                                  / one.H.abs().max())
    est1 = SK.MiniBatchNMF(n_components=16, init="custom", batch_size=128,
                           max_iter=1, tol=0.0, device=dev)
    est1.partial_fit(Vmb[:128].cpu().numpy(), W=W0m.cpu().numpy(),
                     H=H0m.cpu().numpy())
    ea = {k: getattr(est1, k) for k in SK.MiniBatchNMF._get_param_names()
          if k not in ("device", "mesh")}
    ea.update({k: getattr(est1, k) for k in convert._FITTED
               if hasattr(est1, k)})
    oa = {k: getattr(est1._online, k) for k in convert._ONLINE_PARAMS}
    oa.update(rank=16, dtype=np.float32, rho=est1._online.rho,
              n_steps=est1._online.n_steps, _shardings=True,
              H=est1._online.H.cpu().numpy(),
              _A=est1._online._A.cpu().numpy(),
              _B=est1._online._B.cpu().numpy())
    ea["_online"] = _stand_in("OnlineNMF", oa)
    est2 = convert.estimator_from_nmftpu(_stand_in("MiniBatchNMF", ea),
                                         device=dev, mesh=mesh)
    est2.partial_fit(Vmb[128:].cpu().numpy())
    est1.partial_fit(Vmb[128:].cpu().numpy())
    out["convert_estimator"] = float(
        np.abs(est2.components_ - est1.components_).max()
        / np.abs(est1.components_).max())
    return out


def mesh_four_ranks(paths, W0, H0, W3, H3, limits, cold):
    """Phase 25 on four ranks sharing the card (gloo): (a) the ring at
    config 2 and weighted MU at config 3, (b) dense V on 2 x 2, 4 x 1 and
    1 x 4, (c) the sharded fold-in on 1 x 4, (d) MiniBatchNMF and (e) the
    surfaces on 2 x 2. Every section's launches are read from 0 (a fresh
    process) around it."""
    import torch.distributed as dist

    from nmftpu_torch.parallel import STAGED_BYTES, make_grid_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    meshes = {s: make_grid_mesh(s) for s in ((2, 2), (1, 4), (4, 1))}
    rank = dist.get_rank()
    out = {"rank": rank, "backend": dist.get_backend()}
    max_abs = {}
    ratings = load_ratings(paths["ratings"])

    t0 = time.perf_counter()
    before = all_launches()
    out["ring"] = ring_section(meshes[1, 4], ratings, W0, H0, RING_KINDS,
                               paths["refs2"], limits["c2"], SPARSE_RANK)
    c3 = load_coo(paths["c3"])
    out["ring3"] = ring_section(meshes[1, 4], c3, W3, H3, ("weighted",),
                                paths["refs3"], limits["c3"], C3_RANK)
    del c3
    out["ring_launches"] = launches_since(before)
    out["ring_peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    out["ring_secs"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    before = all_launches()
    out["dense"] = dense_section(meshes[2, 2], ratings, W0, H0,
                                 paths["dense_save"])
    out["dense_launches"] = launches_since(before)
    out["dense_peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    out["muldiv"] = {}
    out["dense4096"] = dense_4096_section(meshes, paths["d4096_save"],
                                          max_abs, out["muldiv"])
    out["dense_secs"] = time.perf_counter() - t0
    del ratings
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out["foldin"] = foldin_section(meshes[1, 4], cold, max_abs)
    out["foldin_secs"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    before = all_launches()
    out["minibatch"] = minibatch_section(meshes[2, 2], paths["ratings"], W0,
                                         H0)
    if rank:
        out["minibatch"]["W"] = out["minibatch"]["H"] = None
    rec = RecordedMuldiv()
    out["surfaces"] = surfaces_section(meshes[2, 2], paths["ratings"], W0,
                                       H0, paths["ck23"], dev, rec)
    out["surfaces_launches"] = launches_since(before)
    out["muldiv"]["(e) resume"] = rec.check("(e) resume")
    out["surfaces_secs"] = time.perf_counter() - t0
    out["staged"] = dict(STAGED_BYTES)
    out["max_abs"] = max_abs
    return out


def mesh_one_rank(paths, W0, H0, W3, H3, limits):
    """Phase 25 under NCCL, one rank: the ring with p = 1 (no sends) and
    dense V at the ML-20M shape on a 1 x 1 mesh."""
    import torch.distributed as dist

    from nmftpu_torch.parallel import STAGED_BYTES, make_grid_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_grid_mesh((1, 1))
    ratings = load_ratings(paths["ratings"])
    out = {"backend": dist.get_backend()}
    before = all_launches()
    out["ring"] = ring_section(mesh, ratings, W0, H0, RING_KINDS,
                               paths["refs2"], limits["c2"], SPARSE_RANK)
    c3 = load_coo(paths["c3"])
    out["ring3"] = ring_section(mesh, c3, W3, H3, ("weighted",),
                                paths["refs3"], limits["c3"], C3_RANK)
    del c3
    torch.cuda.reset_peak_memory_stats()
    out["dense"] = dense_section(mesh, ratings, W0, H0,
                                 paths["dense_save"] + "-1x1")
    out["launches"] = launches_since(before)
    out["dense_peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    out["staged"] = dict(STAGED_BYTES)
    return out


def longest(coo_rows, coo_cols, n, m) -> int:
    return int(max(np.bincount(coo_rows, minlength=n).max(),
                   np.bincount(coo_cols, minlength=m).max()))


def ring_references(TS, sp, W0, H0, kinds, rank, path, dev):
    """compute_sparse's scatter engine, one iteration in each order of
    each kind from W0/H0 (the halves phase 25 (a) holds the ring to),
    saved to `path`; the Grams' conditions of W0 and H0."""
    refs = {}
    plan = TS.prepare_sparse(sp, ring_config(kinds[0], "WH", rank),
                             strategy="scatter", device=dev)
    Wd = torch.as_tensor(W0, device=dev)
    Hd = torch.as_tensor(H0, device=dev)
    for kind in kinds:
        for order in ("WH", "HW"):
            res = plan.run(ring_config(kind, order, rank), W0=Wd, H0=Hd)
            refs[f"{kind}-{order}"] = (res.W if order == "WH"
                                       else res.H).cpu().numpy()
            del res
    np.savez(path, **refs)
    kappa_w = float(torch.linalg.cond((Hd @ Hd.T).double()))
    kappa_h = float(torch.linalg.cond((Wd.T @ Wd).double()))
    del plan, Wd, Hd
    torch.cuda.empty_cache()
    return kappa_w, kappa_h


def mesh_phase(nt, card, dev, ratings, c3, ck_dir, max_abs) -> dict:
    """Phase 25 (slice 6b): the ring engine (a), dense V on a mesh (b),
    the sharded fold-in (c), MiniBatchNMF (d) and the surfaces (e) on
    four gloo ranks sharing the card, the ring and dense V on one NCCL
    rank, and dryrun_multichip; each against the unsharded run on the
    card. Returns the ranks' launches by kernel; raises max_abs's entries
    to the errors of the kernels against their twins on the ranks'
    operands."""
    import tempfile

    from nmftpu_torch import checkpoint as CK
    from nmftpu_torch import foldin as PF
    from nmftpu_torch import sklearn_api as SK
    from nmftpu_torch import sparse_ops as TS
    from nmftpu_torch.parallel import dryrun_multichip, launch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="nmftpu_phase25_")
    try:
        n, m = ratings.shape
        r = SPARSE_RANK
        paths = {"ratings": os.path.join(tmp, "ratings.npz"),
                 "c3": os.path.join(tmp, "c3.npz"),
                 "refs2": os.path.join(tmp, "refs2.npz"),
                 "refs3": os.path.join(tmp, "refs3.npz"),
                 "dense_save": os.path.join(tmp, "dense"),
                 "d4096_save": os.path.join(tmp, "d4096"), "ck23": ck_dir}
        np.savez(paths["ratings"], indptr=ratings.indptr,
                 indices=ratings.indices, data=ratings.data,
                 shape=np.array(ratings.shape))
        csr3 = c3["csr"]
        coo3 = csr3.to_coo()
        np.savez(paths["c3"], row=coo3.row, col=coo3.col, data=coo3.data,
                 shape=np.array(csr3.shape))
        W0, H0 = config2_start(n, m, r,
                               float(ratings.data.sum(dtype=np.float64)), dev)
        W0, H0 = W0.cpu().numpy(), H0.cpu().numpy()
        n3, m3 = csr3.shape
        # phase 16's start
        W3, H3 = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                             np.float32) for x in (c3["W0"], c3["H0"]))
        coo2 = ratings.to_coo()
        K2 = longest(coo2.row, coo2.col, n, m)
        K3 = longest(coo3.row, coo3.col, n3, m3)
        del coo2
        t0 = time.perf_counter()
        kw2, kh2 = ring_references(TS, ratings, W0, H0, RING_KINDS, r,
                                   paths["refs2"], dev)
        kw3, kh3 = ring_references(TS, csr3, W3, H3, ("weighted",),
                                   C3_RANK, paths["refs3"], dev)
        limits = {"c2": {k: ring_limits(k, K2, kw2, kh2, r)
                         for k in RING_KINDS},
                  "c3": {"weighted": ring_limits("weighted", K3, kw3, kh3,
                                                 C3_RANK)}}
        ref_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(SEED + 18)
        cold = distinct_items(COLD_USERS, gen, dev)
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        four = launch(mesh_four_ranks, MESH_RANKS,
                      args=(paths, W0, H0, W3, H3, limits, cold),
                      backend="gloo", timeout=MESH_TIMEOUT, threads=2)
        four_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        one = launch(mesh_one_rank, 1, args=(paths, W0, H0, W3, H3, limits),
                     backend="nccl", timeout=MESH_TIMEOUT)[0]
        one_s = time.perf_counter() - t0
        say("25 launches", four_gloo_ranks_s=f"{four_s:.1f}",
            one_nccl_rank_s=f"{one_s:.1f}", references_s=f"{ref_s:.1f}",
            card=card)
        f0 = four[0]
        for f in four:
            for name, a in f["max_abs"].items():
                max_abs[name] = max(max_abs[name], a)

        # -- (a) the ring ---------------------------------------------------
        for label, res, p in (("4 gloo ranks", f0, 4),
                              ("1 NCCL rank", one, 1)):
            for sect, K in (("ring", K2), ("ring3", K3)):
                for kind, row in res[sect].items():
                    if kind == "prepare_s":
                        continue
                    for order in ("HW", "WH"):
                        g = row[order]
                        half = "H" if order == "HW" else "W"
                        say("25a ring", ranks=label, p=p, kind=kind,
                            half=half, rel=f"{g['rel']:.3e}",
                            limit=f"{g['limit']:.3e}", longest=K,
                            ms_per_iteration=f"{1e3 * g['secs']:.1f}",
                            staged_MB=f"{g['staged'] / 2**20:.1f}",
                            error=f"{g['error']:.6g}")
                        if not g["rel"] <= g["limit"]:
                            fail(f"phase 25 (a) {label} {kind}: the {half} "
                                 f"half differs from compute_sparse's by "
                                 f"{g['rel']:.3e} > {g['limit']:.3e}")
        say("25a", prepare_s=f"{f0['ring']['prepare_s']:.1f}",
            seconds=f"{f0['ring_secs']:.1f}",
            peak_GiB_per_rank=[round(f["ring_peak_GiB"], 1) for f in four],
            ring_launches=sum(sum(f["ring_launches"].values())
                              for f in four), card=card,
            note="four processes time-share one card: these times say "
                 "nothing about scaling")

        # -- (b) dense V on the mesh -----------------------------------------
        V = CSRTiles(ratings, dev)
        for storage, rtol in (("float32", DENSE_F32_RTOL),
                              ("int8", DENSE_INT8_RTOL)):
            # each half from (W0, H0): the W of a "WH" step, the H of an
            # "HW" one (a step's second half would see a factor one
            # ulp apart, which int8 requantization can flip)
            ref_w = nt.driver.compute(V[:, :], dense_config(storage, 1),
                                      W0=W0, H0=H0).W
            ref_h = nt.driver.compute(V[:, :], dense_config(
                storage, 1, update_order="HW"), W0=W0, H0=H0).H
            refk = nt.driver.compute(V[:, :], dense_config(storage,
                                                           DENSE_ITERS),
                                     W0=W0, H0=H0)
            for tag, res in (("2x2 gloo", f0["dense"][storage]),
                             ("1x1 nccl", one["dense"][storage])):
                z = np.load(paths["dense_save"]
                            + ("-1x1" if tag == "1x1 nccl" else "")
                            + f"-{storage}.npz")
                dw = rel_host(torch.from_numpy(z["W"]), ref_w)
                dh = rel_host(torch.from_numpy(z["H"]), ref_h)
                derr = max(abs(a - b) / b for a, b in
                           zip(res["errors"], refk.stats.errors))
                say("25b ML-20M dense", mesh=tag, storage=storage,
                    W_rel=f"{dw:.3e}", H_rel=f"{dh:.3e}", rtol=rtol,
                    errors=[f"{e:.6g}" for e in res["errors"]],
                    errors_rel=f"{derr:.3e}", err_rtol=DENSE_ERR_RTOL,
                    first_iteration_s=f"{res['secs_one']:.2f}")
                if not (dw <= rtol and dh <= rtol):
                    fail(f"phase 25 (b) {tag} {storage}: a half differs "
                         f"from the unsharded run's (W {dw:.3e}, H "
                         f"{dh:.3e} > {rtol})")
                if not derr <= DENSE_ERR_RTOL:
                    fail(f"phase 25 (b) {tag} {storage}: the errors after "
                         f"{DENSE_ITERS} differ by {derr:.3e}")
            del ref_w, ref_h, refk
            torch.cuda.empty_cache()
        del V
        say("25b peak", peak_GiB_per_rank=[round(f["dense_peak_GiB"], 1)
                                           for f in four],
            one_rank_peak_GiB=round(one["dense_peak_GiB"], 1))
        V4, W04, H04 = headline_v(dev)
        b_launches = {}
        for f in four:
            for key in ("dense_launches",):
                for k, v in f[key].items():
                    b_launches[k] = b_launches.get(k, 0) + v
            for runs in f["dense4096"].values():
                for k, v in runs.items():
                    b_launches[k] = b_launches.get(k, 0) + v
        for shape, label, knobs in DENSE_4096:
            kn = dict(knobs)
            cfg = dense_config(kn.pop("v_storage", "float32"), 1, rank=256,
                               **kn)
            ref = nt.driver.compute(V4, cfg, W0=W04, H0=H04)
            z = np.load(f"{paths['d4096_save']}-{label}-{shape[0]}x"
                        f"{shape[1]}.npz")
            dw = rel_host(torch.from_numpy(z["W"]), ref.W)
            dh = rel_host(torch.from_numpy(z["H"]), ref.H)
            rtol = DENSE_INT8_RTOL if label == "int8-jacobi" \
                else DENSE_F32_RTOL
            ran = {k: sum(f["dense4096"][shape, label][k] for f in four)
                   for k in DENSE_KERNELS}
            say("25b 4096^2 r=256", mesh=f"{shape[0]}x{shape[1]}",
                run=label, W_rel=f"{dw:.3e}", H_rel=f"{dh:.3e}", rtol=rtol,
                launches={k: v for k, v in ran.items() if v})
            if not (dw <= rtol and dh <= rtol):
                fail(f"phase 25 (b) {label} {shape}: one iteration differs "
                     f"from the unsharded run (W {dw:.3e}, H {dh:.3e})")
            del ref
        del V4, W04, H04
        missing = [k for k in DENSE_KERNELS if b_launches.get(k, 0) < 1]
        say("25b launches", **{k: b_launches.get(k, 0)
                               for k in DENSE_KERNELS})
        if missing:
            fail(f"phase 25 (b): kernels never launched: {missing}")

        # -- (c) fold-in on the sharded table --------------------------------
        W8, H8, train = serving_data(
            torch.Generator(device=dev).manual_seed(SEED + 8), dev)
        rec = nt.Recommender(W8, H8, train=train, method="reservoir",
                             table_dtype="int8", device=dev)
        exact = nt.Recommender(W8, H8, train=train, method="exact",
                               table_dtype="int8", device=dev)
        del W8, H8
        torch.cuda.empty_cache()
        hists = list(cold[:FOLD_B])
        prep = rec._prep()
        g = f0["foldin"]
        g_rel = float(np.abs(g["G"] - prep.G.cpu().numpy()).max()
                      / np.abs(prep.G.cpu().numpy()).max())
        folded = {"als": rec.fold_in_batch(hists)}
        for rule in ("mu", "hals"):
            folded[rule] = rec.fold_in_batch(hists, algorithm=rule,
                                             num_iterations=COLD_ITERS)
        A, N, _, _, _ = foldin_system64(prep, rec._histories_csr(hists))
        W64 = torch.clamp(torch.linalg.solve(A, N.T).T, min=0.0)
        kappa = float(torch.linalg.cond(A))
        rel64 = float(np.abs(g["folded"]["als"] - W64.cpu().numpy()).max()
                      / float(W64.abs().max()))
        solve_lim = SOLVE_FACTOR * kappa * 2.0 ** -24
        d_rules = {rule: float(np.abs(g["folded"][rule] - folded[rule]).max()
                               / np.abs(folded[rule]).max())
                   for rule in folded}
        # the reservoir scan keeps C(k,3)/R^2 misses a row and scores on
        # bf16 products: its top-100 is held by recall against the exact
        # unsharded scan, and beside the unsharded reservoir scan's
        _, i_o = exact.recommend_from_history_batch(hists, k=SERVE_K)
        _, i_r = rec.recommend_from_history_batch(hists, k=SERVE_K)
        s, i = g["top"]

        def recall(ids, ref):
            return float(np.mean([len(set(ids[row].tolist())
                                      & set(ref[row].tolist())) / SERVE_K
                                  for row in range(len(hists))]))

        rec_exact, rec_res = recall(i, i_o), recall(i, i_r)
        seen = sum(len(set(i[row].tolist()) & set(hists[row].tolist()))
                   for row in range(len(hists)))
        c_launches = {}
        for f in four:
            for k, v in f["foldin"]["launches"].items():
                c_launches[k] = c_launches.get(k, 0) + v
        say("25c fold-in", items_per_rank=g["m_local"], batch=FOLD_B,
            gram_rel=f"{g_rel:.3e}", gram_rtol=1e-6,
            als_vs_float64=f"{rel64:.3e}", solve_limit=f"{solve_lim:.3e}",
            kappa=f"{kappa:.4g}",
            vs_unsharded={k: f"{v:.3e}" for k, v in d_rules.items()},
            fold_rtol=FOLD_RTOL, recall_at_100=f"{rec_exact:.6f}",
            recall_floor=RECALL_FLOOR,
            overlap_with_unsharded_reservoir=f"{rec_res:.6f}",
            history_violations=seen,
            launches={k: c_launches[k] for k in ("vht_int8", "hals_sweep",
                                                 "reservoir_scan")},
            seconds=f"{g['secs']:.1f}", card=card)
        if not g_rel <= 1e-6:
            fail(f"phase 25 (c): the sharded Gram differs by {g_rel:.3e}")
        if not rel64 <= solve_lim:
            fail(f"phase 25 (c): the ALS fold-in is {rel64:.3e} off the "
                 f"float64 solve, above {solve_lim:.3e}")
        if not max(d_rules.values()) <= FOLD_RTOL:
            fail(f"phase 25 (c): fold-ins differ from the unsharded ones: "
                 f"{d_rules}")
        if not (rec_exact >= RECALL_FLOOR and seen == 0):
            fail(f"phase 25 (c): recall@100 {rec_exact:.6f}, {seen} history "
                 "items returned")
        if min(c_launches[k] for k in ("vht_int8", "hals_sweep",
                                       "reservoir_scan")) < 1:
            fail(f"phase 25 (c): kernels not launched: {c_launches}")
        del rec, exact, prep, A, N, W64
        torch.cuda.empty_cache()

        # -- (d) MiniBatchNMF on four item shards --------------------------
        mb = f0["minibatch"]
        want = minibatch_section(None, paths["ratings"], W0, H0)
        dw = float(np.abs(mb["W"] - want["W"]).max() / np.abs(want["W"]).max())
        dh = float(np.abs(mb["H"] - want["H"]).max() / np.abs(want["H"]).max())
        derr = abs(mb["err"] - want["err"]) / want["err"]
        say("25d MiniBatchNMF", ranks=4, items_per_rank=m // 4,
            W_rel=f"{dw:.3e}", H_rel=f"{dh:.3e}", factor_rtol=1e-3,
            err=f"{mb['err']:.6g}", err_rel=f"{derr:.3e}",
            err_rtol=SURFACE_ERR_RTOL, seconds=f"{mb['secs']:.1f}",
            one_device_seconds=f"{want['secs']:.1f}", card=card)
        if not (dw <= 1e-3 and dh <= 1e-3 and derr <= SURFACE_ERR_RTOL):
            fail(f"phase 25 (d): MiniBatchNMF on the mesh differs (W "
                 f"{dw:.3e}, H {dh:.3e}, error {derr:.3e})")

        # -- (e) the surfaces ------------------------------------------------
        s = f0["surfaces"]
        import scipy.sparse as sps

        X = sps.csr_matrix((ratings.data, ratings.indices, ratings.indptr),
                           shape=ratings.shape)
        est = SK.NMF(n_components=r, init="custom", solver="mu",
                     max_iter=2, tol=0.0, strategy="ell", device=dev)
        Wn = est.fit_transform(X, W=W0, H=H0)
        d_nmf = abs(s["nmf"]["err"] - est.reconstruction_err_) \
            / est.reconstruction_err_
        dw_nmf = float(np.abs(s["nmf"]["W"] - Wn).max() / np.abs(Wn).max())
        V0, _, _ = headline_v(dev)
        cfg = dataclasses.replace(dense_config("float32", BATCH_ITERS,
                                               rank=256, use_pallas=True),
                                  check_interval=10)
        res = CK.resume(ck_dir, V0, cfg, device=dev)
        d_ck = abs(s["resume"]["error"] - res.error) / res.error
        dw_ck = rel_host(torch.from_numpy(s["resume"]["W"]), res.W)
        sel = s["ranks"]
        one_sel = nt.rank_selection(config1_dense(), device=dev,
                                    **RANK_SELECTION)
        d_coph = float(np.max(np.abs(np.subtract(sel["cophenetic"],
                                                 one_sel.cophenetic))
                              / np.abs(one_sel.cophenetic)))
        d_disp = float(np.max(np.abs(np.subtract(sel["dispersion"],
                                                 one_sel.dispersion))
                              / np.abs(one_sel.dispersion)))
        say("25e surfaces", nmf_2x2_err_rel=f"{d_nmf:.3e}",
            nmf_W_rel=f"{dw_nmf:.3e}", resume_2x2_err_rel=f"{d_ck:.3e}",
            resume_W_rel=f"{dw_ck:.3e}",
            resume_iterations=s["resume"]["iterations"],
            rank_selection_best=sel["best"],
            unsharded_best=one_sel.best_rank,
            cophenetic=[f"{x:.6f}" for x in sel["cophenetic"]],
            cophenetic_rel=f"{d_coph:.3e}", dispersion_rel=f"{d_disp:.3e}",
            rank_selection_rtol=RANK_SELECTION_RTOL,
            convert_recommender_rows_not_exact=s["convert_recommender"],
            convert_online_rel=f"{s['convert_online']:.3e}",
            convert_estimator_rel=f"{s['convert_estimator']:.3e}",
            seconds=f"{f0['surfaces_secs']:.1f}")
        if not (d_nmf <= SURFACE_ERR_RTOL and dw_nmf <= 1e-3):
            fail(f"phase 25 (e): NMF(mesh=) differs ({d_nmf:.3e}, "
                 f"{dw_nmf:.3e})")
        if not (d_ck <= SURFACE_ERR_RTOL and dw_ck <= 1e-3
                and s["resume"]["iterations"] == 10):
            fail(f"phase 25 (e): resume(mesh=) differs ({d_ck:.3e}, "
                 f"{dw_ck:.3e})")
        if not (sel["best"] == one_sel.best_rank
                and d_coph <= RANK_SELECTION_RTOL
                and d_disp <= RANK_SELECTION_RTOL):
            fail(f"phase 25 (e): rank selection on the mesh {sel} differs "
                 f"from the unsharded one {one_sel}")
        if not (s["convert_recommender"] == 0
                and s["convert_online"] <= 1e-4
                and s["convert_estimator"] <= 1e-5):
            fail("phase 25 (e): a conversion onto the mesh differs: "
                 f"{s['convert_recommender']}, {s['convert_online']}, "
                 f"{s['convert_estimator']}")
        del V0, res, est, X
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dry = dryrun_multichip(MESH_RANKS, device_type="cuda",
                               timeout=MESH_TIMEOUT)
        say("25e dryrun_multichip", ranks=MESH_RANKS, mesh=dry["mesh"],
            seconds=f"{time.perf_counter() - t0:.1f}")
        say("25 staging", backend=f0["backend"],
            STAGED_MB_per_rank=[{k: round(v / 2**20, 1) for k, v in
                                 f["staged"].items()} for f in four],
            one_rank_backend=one["backend"],
            one_rank_staged=one["staged"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("25", seconds=f"{time.perf_counter() - t_phase:.1f}")
    launches = {}
    for f in four:
        for key in ("ring_launches", "dense_launches", "surfaces_launches"):
            for k, v in f[key].items():
                launches[k] = launches.get(k, 0) + v
        for runs in f["dense4096"].values():
            for k, v in runs.items():
                launches[k] = launches.get(k, 0) + v
        for k, v in f["foldin"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for k, v in one["launches"].items():
        launches[k] = launches.get(k, 0) + v
    # every #5 launch of the phase was held against its twin on its own
    # operands
    checked = sum(n for f in four for n, _, _ in f["muldiv"].values())
    shapes = sorted({sh for f in four for _, _, shs in f["muldiv"].values()
                     for sh in shs})
    say("25 #5 on the path's operands", launches=launches.get(
        "fused_multiply_divide", 0), checked_bit_equal=checked,
        shapes=shapes)
    if checked != launches.get("fused_multiply_divide", 0):
        fail(f"phase 25: {launches.get('fused_multiply_divide', 0)} #5 "
             f"launches but {checked} checked against the twin")
    return launches


# ---------------------------------------------------------------------------
# phase 26: slice 16. The rank programs below run in the processes of the
# port's launcher, as phase 25's do.
# ---------------------------------------------------------------------------


def ials_config(solver: str, rank: int):
    """Phase 26 (b)'s iALS config: one iteration, W half first, from the
    caller's W0/H0."""
    from nmftpu_torch.config import Algorithm, Initialization, NmfConfig

    return NmfConfig(rank=rank, algorithm=Algorithm.ALS,
                     alpha_confidence=C3_ALPHA, als_solver=solver,
                     init_method=Initialization.COPY_EXISTING,
                     num_iterations=1, check_interval=1)


def ring_ials_runs(mesh, sp, W0, H0, rank, solvers, save):
    """One ring iALS iteration from (W0, H0) for each solver on `mesh`,
    timed by CUDA events; rank 0 saves the factors to `save`-<solver>.npz.
    Returns {solver: ms}."""
    import torch.distributed as dist

    from nmftpu_torch.parallel import prepare_sharded

    plan = prepare_sharded(sp, ials_config(solvers[0], rank), mesh=mesh,
                           engine="ring", chunk=1 << 17)
    out = {}
    for solver in solvers:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = plan.run(ials_config(solver, rank), W0=W0, H0=H0)
        end.record()
        end.synchronize()
        out[solver] = start.elapsed_time(end)
        if dist.get_rank() == 0:
            np.savez(f"{save}-{solver}.npz", W=res.W.cpu().numpy(),
                     H=res.H.cpu().numpy())
        del res
    del plan
    torch.cuda.empty_cache()
    return out


def slice16_one_rank(paths, W3, H3, W2, H2):
    """Phase 26 under NCCL, one rank: (b) ring iALS at config 3 with each
    solver (p = 1); (c) a ring and an ELL plan at config 2 prepared
    unmasked, each run with mask="observed"."""
    import dataclasses

    import torch.distributed as dist

    from nmftpu_torch.config import Initialization, NmfConfig
    from nmftpu_torch.parallel import make_grid_mesh, prepare_sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_grid_mesh((1, 1))
    out = {"backend": dist.get_backend()}
    c3 = load_coo(paths["c3"])
    out["ms"] = ring_ials_runs(mesh, c3, W3, H3, C3_RANK, SLICE16_SOLVERS,
                               paths["ring3"])
    del c3
    ratings = load_ratings(paths["ratings"])
    cfg = NmfConfig(rank=SPARSE_RANK, num_iterations=1, check_interval=1,
                    init_method=Initialization.COPY_EXISTING)
    out["refusals"] = {}
    for engine in ("ring", "ell"):
        plan = prepare_sharded(ratings, cfg, mesh=mesh, engine=engine)
        torch.cuda.synchronize()
        before, mem = all_launches(), torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        try:
            plan.run(dataclasses.replace(cfg, mask="observed"), W0=W2, H0=H2)
            refused = None
        except ValueError as e:
            refused = str(e)
        torch.cuda.synchronize()
        out["refusals"][engine] = dict(
            message=refused, ms=1e3 * (time.perf_counter() - t0),
            launches=sum(launches_since(before).values()),
            allocated=torch.cuda.memory_allocated() - mem,
            engine=plan.engine)
        del plan
        torch.cuda.empty_cache()
    return out


def slice16_four_ranks(paths, W2, H2):
    """Phase 26 (b) on four gloo ranks sharing the card: ring iALS with
    cg at config 2, one iteration (a 4-ring)."""
    from nmftpu_torch.parallel import make_grid_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    ratings = load_ratings(paths["ratings"])
    return ring_ials_runs(make_grid_mesh((1, MESH_RANKS)), ratings, W2, H2,
                          SPARSE_RANK, ("cg",), paths["ring2"])


def popular_sample(csr, csc, seed):
    """64 rows and 64 columns: the longest of each, and 63 more drawn
    without replacement (phase 22 (b)'s draw)."""
    n, m = csr.shape
    rng = np.random.default_rng(seed)
    u_top = int(np.argmax(np.diff(csr.indptr)))
    i_top = int(np.argmax(np.diff(csc.indptr)))
    rows = np.concatenate([[u_top], rng.choice(
        np.setdiff1d(np.arange(n), [u_top]), 63, replace=False)])
    cols = np.concatenate([[i_top], rng.choice(
        np.setdiff1d(np.arange(m), [i_top]), 63, replace=False)])
    return rows, cols


def hold_ials_halves(label, solver, csr, csc, rows, cols, W0, H0, ring,
                     scatter, r, steps):
    """One iteration of the ring against the scatter engine, per row:
    the W half at SOLVE_FACTOR sqrt(r) kappa_row 2^-24, the H half plus
    kappa_row times W's difference (kappa_row from the float64 system of
    the row). If cg misses that, each engine's cg rows are held against
    `steps` cg steps in float64 on its own rows' systems, as
    tests/test_torch_ials.py's test_cg_row_solver_matches holds a float32
    cg: the ring's worst row within the limit or at most twice the
    scatter engine's. Fails unless one form holds; returns the printed
    fields."""
    dev = W0.device
    Wr, Hr = (torch.as_tensor(x, device=dev) for x in ring)
    Ws, Hs = scatter
    ri, ci = (torch.as_tensor(x, device=dev) for x in (rows, cols))
    dW = float((Wr - Ws).abs().max() / Ws.abs().max())
    _, kap_w = row_systems64(csr, rows, H0.T, C3_ALPHA, 0.0, False)
    _, kap_h = row_systems64(csc, cols, Ws, C3_ALPHA, 0.0, False)
    cw = per_row_check(Wr[ri], Ws[ri].double(), kap_w, r)
    ch = per_row_check(Hr[:, ci].T, Hs[:, ci].T.double(), kap_h, r,
                       extra=dW)
    dH = float((Hr - Hs).abs().max() / Hs.abs().max())
    fields = {"W_worst_ratio": f"{cw[0]:.3e}",
              "W_rel_kappa": f"{cw[1]:.3e}/{cw[2]:.4g}",
              "H_worst_ratio": f"{ch[0]:.3e}",
              "H_rel_kappa": f"{ch[1]:.3e}/{ch[2]:.4g}",
              "W_rel_whole": f"{dW:.3e}", "H_rel_whole": f"{dH:.3e}"}
    if cw[0] <= 1.0 and ch[0] <= 1.0:
        fields["form"] = "ring against scatter"
        return fields
    if solver != "cg":
        fail(f"phase 26 (b) {label} {solver}: the ring differs from "
             f"compute_sparse beyond the per-row limit (W {cw}, H {ch})")
    want_w, kw = row_systems64(csr, rows, H0.T, C3_ALPHA, 0.0, False,
                               x0=W0[ri], cg_steps=steps)
    worst = {}
    for name, (W1, H1) in (("ring", (Wr, Hr)), ("scatter", (Ws, Hs))):
        want_h, kh = row_systems64(csc, cols, W1, C3_ALPHA, 0.0, False,
                                   x0=H0[:, ci].T, cg_steps=steps)
        worst[name] = max(per_row_check(W1[ri], want_w, kw, r)[0],
                          per_row_check(H1[:, ci].T, want_h, kh, r)[0])
    fields.update(form=f"each engine against {steps} float64 cg steps",
                  float64_cg_worst_ratio_ring=f"{worst['ring']:.3e}",
                  float64_cg_worst_ratio_scatter=f"{worst['scatter']:.3e}")
    if not worst["ring"] <= max(1.0, 2.0 * worst["scatter"]):
        fail(f"phase 26 (b) {label} cg: neither form holds (ring against "
             f"scatter W {cw}, H {ch}; against float64 cg steps, ring "
             f"{worst['ring']:.3e}, scatter {worst['scatter']:.3e})")
    return fields


def scatter_ials(nt, sp, W0, H0, rank, solvers, dev):
    """compute_sparse's scatter engine, one iteration from (W0, H0) per
    solver: {solver: ((W, H), ms)}."""
    plan = nt.prepare_sparse(sp, ials_config(solvers[0], rank),
                             strategy="scatter", device=dev)
    out = {}
    for solver in solvers:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = plan.run(ials_config(solver, rank), W0=W0, H0=H0)
        end.record()
        end.synchronize()
        out[solver] = ((res.W, res.H), start.elapsed_time(end))
    del plan
    torch.cuda.empty_cache()
    return out


def slice16_phase(nt, card, dev, ratings, c3) -> None:
    """Phase 26 (slice 16): (a) graft_entry.entry() on the card; (b) ring
    iALS with each solver at config 3 (one NCCL rank) and with cg at
    config 2 (four gloo ranks), against compute_sparse's scatter engine;
    (c) the ring and ELL plans' refusal of a masked run."""
    import tempfile

    from nmftpu_torch import graft_entry as GE
    from nmftpu_torch.parallel import launch

    t_phase = time.perf_counter()
    # -- (a) the twin of __graft_entry__.entry ------------------------------
    step, args = GE.entry()
    cstep, cargs = GE.entry(device="cpu")
    if any(a.device.type != "cuda" for a in args):
        fail(f"phase 26 (a): entry() placed its arguments on "
             f"{[a.device for a in args]}, not the card")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(args, cargs)):
        fail("phase 26 (a): entry()'s arguments differ from entry('cpu')'s")
    got, want = step(*args), cstep(*cargs)
    rels = [rel_to_max(g.cpu(), w) for g, w in zip(got, want)]
    ms = event_ms(lambda: step(*args), GRAFT_ITERS)
    say("26a graft_entry", shape="256x256", rank=32,
        W_rel=f"{rels[0]:.3e}", H_rel=f"{rels[1]:.3e}",
        error=f"{float(got[2]):.6g}", error_rel=f"{rels[2]:.3e}",
        rtol=GRAFT_RTOL, ms_per_step=f"{ms:.4f}",
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32, card=card)
    if not max(rels) <= GRAFT_RTOL:
        fail(f"phase 26 (a): the step on the card differs from the CPU's "
             f"by {rels} > {GRAFT_RTOL}")
    del step, args, got

    tmp = tempfile.mkdtemp(prefix="nmftpu_phase26_")
    os.environ["NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES"] = str(IALS_BUDGET)
    try:
        paths = {"ratings": os.path.join(tmp, "ratings.npz"),
                 "c3": os.path.join(tmp, "c3.npz"),
                 "ring3": os.path.join(tmp, "ring3"),
                 "ring2": os.path.join(tmp, "ring2")}
        np.savez(paths["ratings"], indptr=ratings.indptr,
                 indices=ratings.indices, data=ratings.data,
                 shape=np.array(ratings.shape))
        csr3 = c3["csr"]
        coo3 = csr3.to_coo()
        np.savez(paths["c3"], row=coo3.row, col=coo3.col, data=coo3.data,
                 shape=np.array(csr3.shape))
        del coo3
        W3, H3 = (torch.as_tensor(x, device=dev) for x in (c3["W0"],
                                                         c3["H0"]))
        n, m = ratings.shape
        W2, H2 = config2_start(n, m, SPARSE_RANK,
                               float(ratings.data.sum(dtype=np.float64)), dev)

        # -- (b) config 3, one NCCL rank, p = 1 -------------------------------
        t0 = time.perf_counter()
        one = launch(slice16_one_rank, 1, args=(
            paths, W3.cpu().numpy(), H3.cpu().numpy(), W2.cpu().numpy(),
            H2.cpu().numpy()), backend="nccl", timeout=MESH_TIMEOUT)[0]
        one_s = time.perf_counter() - t0
        ref3 = scatter_ials(nt, csr3, W3, H3, C3_RANK, SLICE16_SOLVERS, dev)
        csc3 = csr3.T.to_csr()
        rows3, cols3 = popular_sample(csr3, csc3, SEED + 222)
        steps = ials_config("cg", C3_RANK).cg_steps
        for solver in SLICE16_SOLVERS:
            z = np.load(f"{paths['ring3']}-{solver}.npz")
            fields = hold_ials_halves(
                "config 3", solver, csr3, csc3, rows3, cols3, W3, H3,
                (z["W"], z["H"]), ref3[solver][0], C3_RANK, steps)
            say("26b ring iALS config 3", ranks="1 NCCL", p=1,
                solver=solver, rank=C3_RANK, alpha=C3_ALPHA,
                ring_ms_per_iteration=f"{one['ms'][solver]:.1f}",
                scatter_ms_per_iteration=f"{ref3[solver][1]:.1f}",
                **fields, card=card)
        del ref3, csc3

        # -- (b) config 2, four gloo ranks, cg --------------------------------
        t0 = time.perf_counter()
        four = launch(slice16_four_ranks, MESH_RANKS, args=(
            paths, W2.cpu().numpy(), H2.cpu().numpy()), backend="gloo",
            timeout=MESH_TIMEOUT, threads=2)
        four_s = time.perf_counter() - t0
        ref2 = scatter_ials(nt, ratings, W2, H2, SPARSE_RANK, ("cg",), dev)
        csc2 = ratings.T.to_csr()
        rows2, cols2 = popular_sample(ratings, csc2, SEED + 226)
        z = np.load(f"{paths['ring2']}-cg.npz")
        fields = hold_ials_halves(
            "config 2", "cg", ratings, csc2, rows2, cols2, W2, H2,
            (z["W"], z["H"]), ref2["cg"][0], SPARSE_RANK, steps)
        say("26b ring iALS config 2", ranks="4 gloo", p=MESH_RANKS,
            solver="cg", rank=SPARSE_RANK, alpha=C3_ALPHA,
            ring_ms_per_iteration_per_rank=[f"{f['cg']:.1f}" for f in four],
            scatter_ms_per_iteration=f"{ref2['cg'][1]:.1f}", **fields,
            card=card, note="four processes time-share one card")
        del ref2, csc2

        # -- (c) the refusal -------------------------------------------------
        for engine, row in one["refusals"].items():
            say("26c masked run refused", plan_engine=row["engine"],
                refused=row["message"] is not None,
                message=(row["message"] or "")[:90],
                launches=row["launches"], allocated_bytes=row["allocated"],
                ms=f"{row['ms']:.3f}")
            if row["message"] is None or "mask='observed'" not in \
                    row["message"]:
                fail(f"phase 26 (c): the {engine} plan ran a masked config "
                     f"({row['message']!r})")
            if row["launches"] or row["allocated"] or row["engine"] != engine:
                fail(f"phase 26 (c): the {engine} plan launched work before "
                     f"refusing: {row}")
        say("26 launches", one_nccl_rank_s=f"{one_s:.1f}",
            four_gloo_ranks_s=f"{four_s:.1f}", backend=one["backend"])
    finally:
        os.environ.pop("NMFTPU_WEIGHTED_GRAM_BUDGET_BYTES", None)
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    say("26", seconds=f"{time.perf_counter() - t_phase:.1f}")


def row_solve_systems(rows, other, r, gen, dev, chunk=8192):
    """Seeded iALS-like per-row systems: G = Tᵀ T of the other side's
    (other, r) uniform factors T, dG_i = C3_ALPHA · Σ t tᵀ and rhs_i =
    (1 + C3_ALPHA) · Σ t over ROW_SOLVE_CLICKS rows t of T."""
    T = torch.rand(other, r, generator=gen, device=dev) + 0.1
    G = T.T @ T
    dG = torch.empty(rows, r, r, device=dev)
    rhs = torch.empty(rows, r, device=dev)
    for s in range(0, rows, chunk):
        e = min(s + chunk, rows)
        idx = torch.randint(0, other, (e - s, ROW_SOLVE_CLICKS),
                            generator=gen, device=dev)
        B = T[idx]
        torch.bmm(C3_ALPHA * B.transpose(1, 2), B, out=dG[s:e])
        rhs[s:e] = (1.0 + C3_ALPHA) * B.sum(1)
    return G, dG, rhs


def row_solve_f64(G, dG, rhs, idx, lam, eps):
    """The rows `idx`' ridged systems (linalg.dense._ridged with float32's
    floor) solved by float64 Cholesky and clamped; the largest condition
    number among them."""
    Gb = G.double()[None] + dG[idx].double()
    r = Gb.shape[-1]
    mean = torch.diagonal(Gb, dim1=-2, dim2=-1).sum(-1)[:, None, None] / r
    A = Gb + (lam + eps + max(eps, 100 * 2.0**-23) * mean) * torch.eye(
        r, dtype=torch.float64, device=Gb.device)
    x = torch.cholesky_solve(rhs[idx].double()[..., None],
                             torch.linalg.cholesky(A))[..., 0]
    ev = torch.linalg.eigvalsh(A)
    return torch.clamp(x, min=0.0), float((ev[:, -1] / ev[:, 0]).max())


def row_err(x, want) -> float:
    """The worst row's max |x - want| over its max |want|."""
    scale = want.abs().amax(1).clamp_min(1e-30)
    return float(((x.double() - want).abs().amax(1) / scale).max())


def row_solve_phase(card, dev) -> dict:
    """Phase 27: #12 (one launch for all rows of a half-step) against the
    plain path on config 3's two halves, and both against float64 on a
    row sample; ms by CUDA events beside the bound. Returns the W half's
    numbers for the kernel table."""
    from nmftpu_torch.kernels import row_solve as RS
    from nmftpu_torch.linalg import dense as D

    def solve_plain(G, dG, rhs, lam, eps):
        # the exact row solver's path off #12: panels of
        # _batched_solve_clamped
        return D._panel_solve(G, dG, rhs, lambda Gb, s, e:
                              D._batched_solve_clamped(Gb, rhs[s:e], lam,
                                                       eps))

    r, eps, lam = C3_RANK, 1e-9, ROW_SOLVE_LAMBDA
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    res = {}
    for half, rows, other in ROW_SOLVE_HALVES:
        G, dG, rhs = row_solve_systems(rows, other, r, gen, dev)
        got = RS.solve_rows(G, dG, rhs, lam, eps)
        plain = solve_plain(G, dG, rhs, lam, eps)
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and (got >= 0).all()):
            fail(f"#12 {half} half: a non-finite or negative solution")
        a = float((got - plain).abs().max())
        rel = a / float(plain.abs().max())
        idx = torch.randperm(rows, generator=gen, device=dev)[
            :ROW_SOLVE_SAMPLE]
        want, kappa = row_solve_f64(G, dG, rhs, idx, lam, eps)
        k_err, p_err = row_err(got[idx], want), row_err(plain[idx], want)
        del got, plain, want
        ms = abba_ms({
            "kernel": lambda: RS.solve_rows(G, dG, rhs, lam, eps),
            "plain": lambda: solve_plain(G, dG, rhs, lam, eps),
        }, iters=5)
        # each row's Cholesky and two triangular solves; its lower
        # triangle and right-hand side read once and x written once, G
        # once
        b_ms, b_by = bound(rows * (r**3 / 3 + 2 * r * r),
                           rows * (r * (r + 1) / 2 + 2 * r) * 4
                           + r * r * 4, F32_PEAK)
        say("27 row_solve", half=half, rows=rows, r=r,
            ms=f"{ms['kernel']:.4f}", plain_ms=f"{ms['plain']:.4f}",
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, library_ms="none",
            kernel_err_f64=f"{k_err:.3e}", plain_err_f64=f"{p_err:.3e}",
            kappa=f"{kappa:.4g}", vs_plain_max_abs=f"{a:.3e}",
            vs_plain_max_rel=f"{rel:.3e}", card=card)
        if not (k_err <= F64_FACTOR * p_err
                and k_err <= SOLVE_FACTOR * kappa * 2.0**-24):
            fail(f"#12 {half} half: error against float64 {k_err:.3e} "
                 f"over {F64_FACTOR} x the plain path's {p_err:.3e} or "
                 f"{SOLVE_FACTOR} kappa 2^-24 (kappa {kappa:.4g})")
        res[half] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=a)
        del G, dG, rhs
        torch.cuda.empty_cache()
    return {**res["W"],
            "max_abs_err": max(h["max_abs_err"] for h in res.values())}


def gram_rows64(csr, rows, table, alpha):
    """float64 Grams and right-hand sides of `rows` of a host CSR:
    sum_k 40 v t tᵀ and sum_k v (1 + 40 v) t over each row's nonzeros, t
    the `table` row of each column, the weights of float64 values."""
    T = table.double()
    G, h = [], []
    for i in rows:
        lo, hi = int(csr.indptr[i]), int(csr.indptr[i + 1])
        cols = torch.as_tensor(csr.indices[lo:hi].astype(np.int64),
                               device=T.device)
        v = torch.as_tensor(csr.data[lo:hi], device=T.device).double()
        t = T[cols]
        G.append((t * (alpha * v)[:, None]).T @ t)
        h.append((v * (1.0 + alpha * v)) @ t)
    return torch.stack(G), torch.stack(h)


def rows_err(x, want) -> float:
    """The largest over rows of max|x_i - want_i| / max|want_i|."""
    x, want = x.double().flatten(1), want.flatten(1)
    scale = want.abs().amax(1)
    keep = scale > 0
    return float(((x - want).abs().amax(1)[keep] / scale[keep]).max())


def ell_gram_phase(card, dev) -> dict:
    """Phase 28: #13 (one launch for all rows of a half-step, one more for
    the split rows) against the plain path on config 3's two halves, and
    both against float64 on a row sample; ms by CUDA events beside the
    bound. Returns the W half's numbers for the kernel table."""
    from nmftpu_torch import sparse_ell as SE
    from nmftpu_torch.data.synthetic import synthetic_powerlaw_sparse
    from nmftpu_torch.kernels import ell_gram as EG

    n, m, want_nnz = ELL_GRAM_SHAPE
    r, alpha = C3_RANK, C3_ALPHA
    t0 = time.perf_counter()
    sp = synthetic_powerlaw_sparse(n, m, want_nnz, alpha_user=0.9,
                                   alpha_item=0.9, seed=SEED + 28)
    sp.data[:] = 1.0
    csr, csc = sp.to_csr(), sp.T.to_csr()
    pair = SE.build_ell_pair(sp, device=dev)
    del sp
    make_s = time.perf_counter() - t0
    nnz = csr.nnz
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    scale = (nnz / (n * m) / r) ** 0.5
    W = (torch.rand(n, r, generator=gen, device=dev) + 0.1) * scale
    H = (torch.rand(r, m, generator=gen, device=dev) + 0.1) * scale
    rule = EG.ials_rule(alpha)
    rng = np.random.default_rng(SEED + 28)
    res = {}
    for half, ell, table, host, other in (
            ("W", pair.rows, H.T.contiguous(), csr, m),
            ("H", pair.cols, W, csc, n)):
        rows = ell.shape[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        units = EG.units_of(ell)
        torch.cuda.synchronize()
        index_s = time.perf_counter() - t0

        def kernel():
            return SE.grams_and_rhs_ell(ell, table, rule.weight, rule.value,
                                        rule=rule)

        def plain():
            return SE.grams_and_rhs_ell(ell, table, rule.weight, rule.value)

        before = EG.LAUNCHES["ell_gram"]
        g, h = kernel()
        launches = EG.LAUNCHES["ell_gram"] - before
        g2, h2 = kernel()
        torch.cuda.synchronize()
        bit_equal = bool(torch.equal(g, g2) and torch.equal(h, h2))
        del g2, h2
        symmetric = bool((g == g.transpose(1, 2)).all())
        lens = np.diff(host.indptr)
        idx = np.unique(np.concatenate([
            [int(np.argmax(lens))],
            rng.choice(rows, ELL_GRAM_SAMPLE - 1, replace=False)]))
        want_g, want_h = gram_rows64(host, idx, table, alpha)
        sel = torch.as_tensor(idx, device=dev)
        k_err = max(rows_err(g[sel], want_g), rows_err(h[sel], want_h))
        pg, ph = plain()
        p_err = max(rows_err(pg[sel], want_g), rows_err(ph[sel], want_h))
        a = max(float((g - pg).abs().max()), float((h - ph).abs().max()))
        rel = max(float((g - pg).abs().max() / pg.abs().max()),
                  float((h - ph).abs().max() / ph.abs().max()))
        del g, h, pg, ph, want_g, want_h
        torch.cuda.empty_cache()
        ms = abba_ms({"kernel": kernel, "plain": plain}, iters=3)
        # the lower triangles' FMAs and the right-hand sides'; every row's
        # full Gram and right-hand side written once, the stored values and
        # columns and the table read once
        b_ms, b_by = bound(nnz * (r * (r + 1) + 2 * r),
                           rows * (r * r + r) * 4 + nnz * 8 + other * r * 4,
                           F32_PEAK)
        say("28 ell_gram", half=half, rows=rows, nnz=nnz, r=r,
            units=units.units.shape[0], split_rows=units.splits.shape[0],
            partial_slots=units.slots,
            heaviest_row=int(lens.max()), index_s=f"{index_s:.3f}",
            launches=launches, ms=f"{ms['kernel']:.4f}",
            plain_ms=f"{ms['plain']:.4f}", bound_ms=f"{b_ms:.4f}",
            bound_by=b_by, library_ms="none",
            kernel_err_f64=f"{k_err:.3e}", plain_err_f64=f"{p_err:.3e}",
            vs_plain_max_abs=f"{a:.3e}", vs_plain_max_rel=f"{rel:.3e}",
            bit_equal=bit_equal, symmetric=symmetric, make_s=f"{make_s:.1f}",
            card=card)
        if launches != 1 + (units.splits.shape[0] > 0):
            fail(f"#13 {half} half: {launches} launches")
        if not (bit_equal and symmetric):
            fail(f"#13 {half} half: two calls differ ({not bit_equal}) or a "
                 f"Gram is not symmetric ({not symmetric})")
        if not k_err <= ELL_GRAM_F64_FACTOR * p_err:
            fail(f"#13 {half} half: error against float64 {k_err:.3e} over "
                 f"{ELL_GRAM_F64_FACTOR} x the plain path's {p_err:.3e}")
        res[half] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=a)
    del pair, W, H
    torch.cuda.empty_cache()
    return {**res["W"],
            "max_abs_err": max(h["max_abs_err"] for h in res.values())}


def ell_cg_phase(card, dev) -> dict:
    """Phase 29: #11's CG rule (one launch for every bucket) on the
    msd-clicks cell's clicks at r = 256, each half: the product with the
    half's own rows as directions against its twin, a matrix-free
    half-step on the kernel routes against float64 CG on a row sample
    (`cg_step_check`), and the ms of kernel and twin by CUDA events beside
    the bound. Returns the W half's numbers for the kernel table."""
    from benchmark.datagen import clicks
    from nmftpu_torch import sparse_ell as SE
    from nmftpu_torch.kernels import sparse_ell_kernel as SEK

    spec = json.loads((HERE / ELL_CG_CONFIG).read_text())
    r, alpha, lam = spec["rank"], spec["alpha"], spec["lambda_w"]
    t0 = time.perf_counter()
    coo = clicks.make(spec["data"], SEED + 29, dev)
    n, m, nnz = coo["n"], coo["m"], coo["nnz"]
    csr = clicks.host_csr(coo)
    del coo
    csc = csr.T.to_csr()
    pair = SE.build_ell_pair(csr, device=dev)
    make_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    scale = (nnz / (n * m) / r) ** 0.5
    W = (torch.rand(n, r, generator=gen, device=dev) + 0.1) * scale
    Hr = (torch.rand(m, r, generator=gen, device=dev) + 0.1) * scale
    kernels = dict(product=SEK.ell_cg, spmm=SEK.v_ht_ell_pallas)
    rng = np.random.default_rng(SEED + 29)
    res = {}
    for half, ell, table, own, host, other in (
            ("W", pair.rows, Hr, W, csr, m), ("H", pair.cols, W, Hr, csc, n)):
        rows = ell.shape[0]
        before = SEK.LAUNCHES["ell_cg"]
        got = SEK.ell_cg(ell, own, table, alpha)
        launches = SEK.LAUNCHES["ell_cg"] - before
        want = SE.cg_product_ell(ell, own, table, alpha)
        torch.cuda.synchronize()
        a = float((got - want).abs().max())
        rel = a / float(want.abs().max())
        del got, want
        step = SE.cg_half_ell(ell, table, own, lam, 1e-9, alpha,
                              ELL_CG_STEPS, **kernels)
        twin = SE.cg_half_ell(ell, table, own, lam, 1e-9, alpha,
                              ELL_CG_STEPS)
        lens = np.diff(host.indptr)
        idx = np.unique(np.concatenate([
            [int(np.argmax(lens))],
            rng.choice(rows, ELL_CG_SAMPLE - 1, replace=False)]))
        ratio, s_err, kappa, t_err = cg_step_check(
            step, [twin], host, idx, table, own, alpha, lam, ELL_CG_STEPS)
        del step, twin
        torch.cuda.empty_cache()
        ms = abba_ms({
            "kernel": lambda: SEK.ell_cg(ell, own, table, alpha),
            "plain": lambda: SE.cg_product_ell(ell, own, table, alpha),
        }, iters=3)
        # a product samples and sums at every nonzero (4·nnz·r) and reads
        # each value and column once, the table, the directions and the
        # output once
        b_ms, b_by = bound(4 * nnz * r, nnz * (4 + 4)
                           + (2 * rows + other) * r * 4, F32_PEAK)
        say("29 ell_cg", half=half, rows=rows, nnz=nnz, r=r,
            heaviest_row=int(lens.max()), launches=launches,
            ms=f"{ms['kernel']:.4f}", plain_ms=f"{ms['plain']:.4f}",
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, library_ms="none",
            vs_plain_max_abs=f"{a:.3e}", vs_plain_rel=f"{rel:.3e}",
            rtol=ELL_KL_RTOL, step_err_f64=f"{s_err:.3e}",
            twin_step_err_f64=f"{t_err:.3e}", kappa=f"{kappa:.4g}",
            step_ratio_to_limit=f"{ratio:.3e}", make_s=f"{make_s:.1f}",
            card=card)
        if launches != 1:
            fail(f"#11 CG rule {half} half: {launches} launches")
        if not rel <= ELL_KL_RTOL:
            fail(f"#11 CG rule {half} half: {rel:.3e} from its twin, over "
                 f"{ELL_KL_RTOL}")
        if not ratio <= 1.0:
            fail(f"#11 CG rule {half} half: the half-step's error against "
                 f"float64 CG {s_err:.3e} over {CG_F32_PER_KAPPA} kappa "
                 f"(kappa {kappa:.4g}; the twin's {t_err:.3e})")
        res[half] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=a)
    del pair, W, Hr
    torch.cuda.empty_cache()
    return {**res["W"],
            "max_abs_err": max(h["max_abs_err"] for h in res.values())}


def main() -> None:
    if not (HERE / "nmftpu_torch").is_dir():
        fail(f"no nmftpu_torch package beside {__file__}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    sys.path.insert(0, str(HERE))
    # phase 24's config-4 tile: the host generator runs in a process of its
    # own beside phases 2-23 (spawned, so it shares no CUDA state)
    import atexit
    import multiprocessing
    import tempfile

    c4_dir = tempfile.mkdtemp(prefix="nmftpu_c4_")
    atexit.register(shutil.rmtree, c4_dir, True)
    c4_pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    c4 = c4_pool.submit(c4_tile, os.path.join(c4_dir, "c4.npz"))

    import nmftpu_torch as nt
    from nmftpu_torch import native_loader as NL
    from nmftpu_torch.kernels import _build
    from nmftpu_torch.kernels import count_above as CA
    from nmftpu_torch.kernels import dense_mu as K
    from nmftpu_torch.kernels import mips_reservoir as MR
    from nmftpu_torch.kernels import quantized as Q
    from nmftpu_torch.linalg import dense as D
    from nmftpu_torch.retrieval.mips import _gather_scores
    from nmftpu_torch.serving import quantize_table

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = nvidia_smi_line()

    # -- 1. device ---------------------------------------------------------
    print(card, flush=True)
    say("1 device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # -- 2. build ----------------------------------------------------------
    # the kernels (nvcc) and, beside them, the native host library (g++),
    # which the sparse phases' CSR and ELL builds then go through
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(NL.build)
        lib_path = _build.build()
        if not (native.result() and NL.has_csr_build()
                and NL.has_ell_build()):
            fail(f"{NL.library_path()} did not build or load (make -C "
                 "native build/libnmftpu_io.so CXX=g++)")
    secs = time.perf_counter() - t0
    _build.load()
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".so.log")
             .read_text().splitlines() if "registers" in ln]
    say("2 build", library=lib_path.name, seconds=f"{secs:.2f}",
        native_library=NL.library_path(), ptxas=" | ".join(ptxas))
    check_tensor_cores(lib_path)

    # -- 3. each kernel against its plain twin -------------------------------
    max_abs = dict.fromkeys(REPLACES, 0.0)
    for n, m, r in KERNEL_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(SEED + n + m + r)
        V = 5.0 * torch.rand(n, m, generator=gen, device=dev)
        W = torch.rand(n, r, generator=gen, device=dev) + 0.05
        H = torch.rand(r, m, generator=gen, device=dev) + 0.05
        Vq, scale = Q.quantize_v(V)
        Gw, Gh = H @ H.T, W.T @ W
        exact = {"w": mu_exact("w", V, None, W, H, Gw),
                 "h": mu_exact("h", V, None, W, H, Gh),
                 "w_q": mu_exact("w", Vq, scale, W, H, Gw),
                 "h_q": mu_exact("h", Vq, scale, W, H, Gh)}
        cases = {
            "w_update_fused": (K.w_update_fused(V, W, H, Gw),
                               K.w_update_fused_plain(V, W, H, Gw)),
            "h_update_fused": (K.h_update_fused(V, W, H, Gh),
                               K.h_update_fused_plain(V, W, H, Gh)),
            "w_update_fused_q": (
                Q.w_update_fused_q(Vq, scale, W, H, Gw),
                Q.w_update_fused_q_plain(Vq, scale, W, H, Gw)),
            "h_update_fused_q": (
                Q.h_update_fused_q(Vq, scale, W, H, Gh),
                Q.h_update_fused_q_plain(Vq, scale, W, H, Gh)),
        }
        torch.cuda.synchronize()
        for name, (got, want) in cases.items():
            if got.shape != want.shape:
                fail(f"{name} {n}x{m} r={r}: shape {tuple(got.shape)}")
            a, rel = rel_err(got, want)
            max_abs[name] = max(max_abs[name], a)
            say("3 kernel", kernel=name, shape=f"{n}x{m}", rank=r,
                max_abs=f"{a:.3e}", max_rel=f"{rel:.3e}",
                rtol=KERNEL_RTOL)
            if not rel <= KERNEL_RTOL:
                fail(f"{name} {n}x{m} r={r}: max rel {rel:.3e} > "
                     f"{KERNEL_RTOL}")
            key = name[0] + ("_q" if name.endswith("_q") else "")
            f64_check("3", name, f"{n}x{m} r={r}", got, want, exact[key])
        del V, W, H, Vq, scale, Gw, Gh, cases, exact

    # the main path starts here: every count from zero
    for counts in (K.LAUNCHES, Q.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))

    # -- 4. end to end at the headline shape ---------------------------------
    n = m = 4096
    r = 256
    gen = torch.Generator(device=dev).manual_seed(SEED)
    V = synthetic_lowrank(n, m, r, gen, dev)
    W0 = torch.rand(n, r, generator=gen, device=dev) + 0.01
    H0 = torch.rand(r, m, generator=gen, device=dev) + 0.01
    Vq, scale = Q.quantize_v(V)
    V_dq = Vq.float() * scale
    common = dict(init="copy", W0=W0, H0=H0, num_iterations=50,
                  check_interval=10, device="cuda")
    runs = {
        "float32": (dict(use_pallas=True), V, K.LAUNCHES,
                    ("w_update_fused", "h_update_fused")),
        "int8": (dict(v_storage="int8", use_pallas=True), V, Q.LAUNCHES,
                 ("w_update_fused_q", "h_update_fused_q")),
    }
    plain_V = {"float32": V, "int8": V_dq}
    for label, (knobs, V_in, counts, names) in runs.items():
        before = {k: counts[k] for k in names}
        t0 = time.perf_counter()
        res = nt.nmf(V_in, r, **common, **knobs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ref = nt.nmf(plain_V[label], r, **common, use_pallas=False)
        launched = {k: counts[k] - before[k] for k in names}
        errs = res.stats.errors
        dw = float((res.W - ref.W).abs().max() / ref.W.abs().max())
        dh = float((res.H - ref.H).abs().max() / ref.H.abs().max())
        say("4 e2e 4096^2 r=256", v_storage=label, launches=launched,
            first_error=f"{errs[0]:.6g}", last_error=f"{errs[-1]:.6g}",
            iterations=res.num_iterations, W_rel=f"{dw:.3e}",
            H_rel=f"{dh:.3e}", rtol=E2E_RTOL, seconds=f"{secs:.3f}")
        if min(launched.values()) < 1:
            fail(f"{label}: kernels not launched: {launched}")
        if not errs[-1] < errs[0]:
            fail(f"{label}: error did not fall: {errs.tolist()}")
        if not (dw <= E2E_RTOL and dh <= E2E_RTOL):
            fail(f"{label}: factors differ from the plain path "
                 f"(W {dw:.3e}, H {dh:.3e} > {E2E_RTOL})")
        del res, ref

    # -- 5. end to end at the ML-20M shape (int8 kernels) --------------------
    n5, m5, r5, nnz = 138_493, 26_744, 64, 20_000_263
    gen5 = torch.Generator(device=dev).manual_seed(SEED + 5)
    t0 = time.perf_counter()
    R = synthetic_ratings(n5, m5, nnz, gen5, dev)
    got_nnz = int(torch.count_nonzero(R))
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    if got_nnz != nnz:
        fail(f"ML-20M-shaped V has {got_nnz} nonzeros, not {nnz}")
    before = dict(Q.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = nt.nmf(R, r5, init="random", seed=0, num_iterations=10,
                 check_interval=2, v_storage="int8", use_pallas=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = {k: Q.LAUNCHES[k] - before[k] for k in Q.LAUNCHES}
    errs = res.stats.errors
    finite = bool(torch.isfinite(res.W).all() and torch.isfinite(res.H).all())
    say("5 e2e ML-20M shape", shape=f"{n5}x{m5}", rank=r5, nnz=got_nnz,
        make_V_s=f"{make_s:.2f}", launches=launched,
        errors=[f"{e:.6g}" for e in errs], finite=finite,
        seconds=f"{secs:.3f}",
        peak_GiB=f"{torch.cuda.max_memory_allocated() / 2**30:.1f}")
    if not finite:
        fail("ML-20M shape: non-finite factors")
    if not errs[-1] < errs[0]:
        fail(f"ML-20M shape: error did not fall: {errs.tolist()}")
    if min(launched.values()) < 1:
        fail(f"ML-20M shape: kernels not launched: {launched}")

    # the main path ends here; the launches below only check the kernels
    main_path_launches = {k: v for k, v in {**K.LAUNCHES, **Q.LAUNCHES}
                          .items() if k in DENSE}
    if min(main_path_launches.values()) < 1:
        fail(f"a kernel of the path never launched: {main_path_launches}")

    # the kernels against their twins and float64 on this run's V (float32
    # and its Vq, scale) and final factors: the only shape with
    # n * m >= 2**31 (64-bit offsets) and whose H step splits its depth
    # (418 blocks over n = 138,493). quantize_v is deterministic, so this
    # Vq is the one the run used. Every term is nonnegative and most of V
    # is zero, so each sum has at most a column's or a row's nonzeros:
    # KERNEL_RTOL holds as in phase 3.
    Vq5, scale5 = Q.quantize_v(R)
    W5, H5 = res.W, res.H
    Gw, Gh = H5 @ H5.T, W5.T @ W5
    ml_cases = {
        "w_update_fused": (lambda: K.w_update_fused(R, W5, H5, Gw),
                           lambda: K.w_update_fused_plain(R, W5, H5, Gw),
                           ("w", R, None, Gw)),
        "h_update_fused": (lambda: K.h_update_fused(R, W5, H5, Gh),
                           lambda: K.h_update_fused_plain(R, W5, H5, Gh),
                           ("h", R, None, Gh)),
        "w_update_fused_q": (
            lambda: Q.w_update_fused_q(Vq5, scale5, W5, H5, Gw),
            lambda: Q.w_update_fused_q_plain(Vq5, scale5, W5, H5, Gw),
            ("w", Vq5, scale5, Gw)),
        "h_update_fused_q": (
            lambda: Q.h_update_fused_q(Vq5, scale5, W5, H5, Gh),
            lambda: Q.h_update_fused_q_plain(Vq5, scale5, W5, H5, Gh),
            ("h", Vq5, scale5, Gh)),
    }
    for name, (kernel, plain, (step, Vx, sx, G)) in ml_cases.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        a, rel = rel_err(got, want)
        max_abs[name] = max(max_abs[name], a)
        say("5 kernel", kernel=name, shape=f"{n5}x{m5}", rank=r5,
            max_abs=f"{a:.3e}", max_rel=f"{rel:.3e}", rtol=KERNEL_RTOL)
        if not rel <= KERNEL_RTOL:
            fail(f"{name} {n5}x{m5} r={r5}: max rel {rel:.3e} > "
                 f"{KERNEL_RTOL}")
        f64_check("5", name, f"{n5}x{m5} r={r5}", got, want,
                  mu_exact(step, Vx, sx, W5, H5, G))
        del got, want
    # the kernels' times at this shape (the kernels line keeps phase 6's)
    ml_ms = abba_ms({**{k: f[0] for k, f in ml_cases.items()},
                     **{k + "_plain": f[1] for k, f in ml_cases.items()}},
                    iters=2)
    for name in ml_cases:
        say("5 kernel timing", kernel=name, shape=f"{n5}x{m5} r={r5}",
            ms=f"{ml_ms[name]:.4f}", plain_ms=f"{ml_ms[name + '_plain']:.4f}",
            card=card)
    del ml_cases
    # the same ratings as a host CSR: config 2's sparse V for phases 10-12
    ratings = ratings_csr(R)
    del R, Vq5, scale5, res, W5, H5, Gw, Gh

    # -- 6. timing at 4096^2, r = 256 ----------------------------------------
    W, H = W0, H0
    Gw, Gh = H @ H.T, W.T @ W
    it_ms = abba_ms({
        "plain_f32": lambda: D.mu_update_frobenius(V, W, H),
        "kernel_f32": lambda: K.mu_update_frobenius_fused(V, W, H),
        "kernel_int8": lambda: Q.mu_update_frobenius_q(Vq, scale, W, H),
    }, iters=20)
    flops = 4 * n * m * r + 4 * (n + m) * r * r
    for path, ms in it_ms.items():
        say("6 timing", path=path, ms_per_iter=f"{ms:.4f}",
            TFLOP_s=f"{flops / ms / 1e9:.2f}", card=card)
    plain_ms = it_ms["plain_f32"]
    k_ms = abba_ms({
        "w_update_fused": lambda: K.w_update_fused(V, W, H, Gw),
        "h_update_fused": lambda: K.h_update_fused(V, W, H, Gh),
        "w_update_fused_q": lambda: Q.w_update_fused_q(Vq, scale, W, H, Gw),
        "h_update_fused_q": lambda: Q.h_update_fused_q(Vq, scale, W, H, Gh),
    }, iters=20)
    p_ms = abba_ms({
        "w_update_fused": lambda: K.w_update_fused_plain(V, W, H, Gw),
        "h_update_fused": lambda: K.h_update_fused_plain(V, W, H, Gh),
        "w_update_fused_q": lambda: Q.w_update_fused_q_plain(
            Vq, scale, W, H, Gw),
        "h_update_fused_q": lambda: Q.h_update_fused_q_plain(
            Vq, scale, W, H, Gh),
    }, iters=20)
    bounds = {}
    for name in DENSE:
        # V read once (float32 or int8), W, H, G read, one factor written;
        # the numerator and the Gram apply as the kernel runs them, on the
        # tensor cores in split tf32: three products of each float32
        # operand pair, two where V is int8 (exact in tf32); the
        # denominator's operands are float32, three products
        v_bytes = 1 if name.endswith("_q") else 4
        out = n * r if name.startswith("w") else r * m
        bounds[name] = bound((2 if name.endswith("_q") else 3) * 2 * n * m * r
                             + 3 * 2 * out * r,
                             v_bytes * n * m + 4 * (n * r + r * m + r * r
                                                    + out), TF32_PEAK)
        say("6 kernel timing", kernel=name, ms=f"{k_ms[name]:.4f}",
            plain_ms=f"{p_ms[name]:.4f}", bound_ms=f"{bounds[name][0]:.4f}",
            bound_by=bounds[name][1], card=card)

    # -- 7. serving kernels against their twins -----------------------------
    for b, r, m, slots, dtypes in ((37, 37, 10_007, 1024,
                                    ("bfloat16", "int8")),
                                   (512, 256, 1 << 20, 4096,
                                    ("bfloat16", "int8"))):
        gen = torch.Generator(device=dev).manual_seed(SEED + 7 + b)
        Wq = torch.rand(b, r, generator=gen, device=dev)
        Hf = torch.rand(r, m, generator=gen, device=dev)
        for td in dtypes:
            H, hs = ((Hf.to(torch.bfloat16), None) if td == "bfloat16"
                     else quantize_table(Hf))
            Wk = Wq if hs is None else Wq * hs
            label = f"b={b} r={r} m={m} R={slots} {td}"
            a, cand, _ = check_reservoir(MR, label, Wk, H, m, slots)
            max_abs["reservoir_scan"] = max(max_abs["reservoir_scan"], a)
            theta = cand.topk(SERVE_K, dim=1).values[:, -1].contiguous()
            d, _ = check_count(CA, label, Wq, H, theta, hs)
            max_abs["count_above"] = max(max_abs["count_above"], d)
        del Wq, Hf, H, hs, Wk, cand, theta
    # every item ties theta: one column repeated, theta its chain score
    # (row 0: -inf, every item counts); each pair goes through the band,
    # the default list of 4,096 overflows, and the count stays exact
    gen = torch.Generator(device=dev).manual_seed(SEED + 77)
    b, r, m = 37, 37, 10_007
    Wq = torch.rand(b, r, generator=gen, device=dev)
    col = torch.rand(r, 1, generator=gen, device=dev)
    for td in ("bfloat16", "int8"):
        H, hs = ((col.to(torch.bfloat16), None) if td == "bfloat16"
                 else quantize_table(col))
        H = H.expand(r, m).contiguous()
        theta = _gather_scores(Wq, H, torch.zeros(b, 1, dtype=torch.int32,
                                                  device=dev), hs)[:, 0]
        theta[0] = float("-inf")
        d, _ = check_count(CA, f"all ties b={b} r={r} m={m} {td}", Wq, H,
                           theta.contiguous(), hs, all_band=True)
        max_abs["count_above"] = max(max_abs["count_above"], d)
    del Wq, col, H, hs, theta

    gen8 = torch.Generator(device=dev).manual_seed(SEED + 8)
    t0 = time.perf_counter()
    W8, H8, train = serving_data(gen8, dev)
    torch.cuda.synchronize()
    say("8 data", users=SERVE_USERS, items=SERVE_ITEMS, rank=SERVE_RANK,
        seen_per_user=SERVE_SEEN, seconds=f"{time.perf_counter() - t0:.2f}")
    rng = np.random.default_rng(SEED)
    batches = {b: np.sort(rng.choice(SERVE_USERS, b, replace=False))
               for b in (512, 2048)}
    # the two tables phase 8 serves (int8 2.7 GB, bf16 5.4 GB); the
    # kernels are held against their twins on them, at every batch and
    # slot count phase 8 runs (R = 16384 is the escalation's)
    recs = {td: nt.Recommender(W8, H8, train=train, method="reservoir",
                               table_dtype=td)
            for td in ("int8", "bfloat16")}
    tc_err = dict.fromkeys(recs, 0.0)
    for td, b, slots in (("int8", 512, 4096), ("int8", 512, 16384),
                         ("int8", 2048, 4096),
                         ("bfloat16", 512, 4096), ("bfloat16", 512, 16384)):
        rec = recs[td]
        Wq = rec.W[torch.as_tensor(batches[b], device=dev)]
        Wk = Wq if rec._h_scale is None else Wq * rec._h_scale
        label = f"full table b={b} R={slots} {td}"
        a, cand, got = check_reservoir(MR, label, Wk, rec.H, SERVE_ITEMS,
                                       slots)
        max_abs["reservoir_scan"] = max(max_abs["reservoir_scan"], a)
        h_max = CA.table_h_max(rec.H, rec._h_max)
        tc_err[td] = max(tc_err[td], tensor_core_error(
            Wq, rec.H, rec._h_scale, h_max, got))
        theta = cand.topk(SERVE_K, dim=1).values[:, -1].contiguous()
        d, _ = check_count(CA, label, Wq, rec.H, theta, rec._h_scale,
                           rec._h_max)
        max_abs["count_above"] = max(max_abs["count_above"], d)
        if td == "int8" and b == 512 and slots == 4096:
            d = check_zero_queries(CA, rec, Wq, theta, card)
            max_abs["count_above"] = max(max_abs["count_above"], d)
        del Wq, Wk, cand, got, theta
    del rec
    # the band's constant against the tensor cores' largest error seen
    for td, err in tc_err.items():
        say("7 band", table=td, largest_tc_error_in_r_ulps_of_A=f"{err:.4g}",
            band_constant=CA.BAND_C, margin=f"{CA.BAND_C / err:.4g}"
            if err else "inf", required_margin=BAND_MARGIN)
        if not CA.BAND_C >= BAND_MARGIN * err:
            fail(f"{td}: the tensor cores' error {err:.4g} leaves the band "
                 f"constant {CA.BAND_C} less than {BAND_MARGIN}x margin")

    # -- 8. serving end to end at config 5 (the second main path) -----------
    for counts in (MR.LAUNCHES, CA.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))
    # the escalation's only fallback is a RuntimeWarning on out of device
    # memory; as an error here, no kernel leaves the measured path unseen
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        for td, rec in recs.items():
            serve_table(MR, CA, td, rec, train, batches, card)
    serve_launches = {**MR.LAUNCHES, **CA.LAUNCHES}
    if min(serve_launches.values()) < 1:
        fail(f"a serving kernel never launched: {serve_launches}")

    # -- 9. serving kernel timing at the phase-8 shape (int8, b = 512) ------
    Hq, hs = recs["int8"].H, recs["int8"]._h_scale
    del rec, H8
    torch.cuda.empty_cache()
    Wq = W8[torch.as_tensor(batches[512], device=dev)]
    Wk = (Wq * hs).contiguous()
    before = dict(MR.VARIANT_LAUNCHES)
    cand = MR.reservoir_scan(Wk, Hq, SERVE_ITEMS, 4096)[0]
    ran = {k: MR.VARIANT_LAUNCHES[k] - before[k] for k in before}
    say("9 variant", reservoir_scan=ran)
    if ran != {"tc": 1, "tc_unaligned": 0, "f32": 0, "merge": 0}:
        fail(f"phase 9 does not time the aligned tensor-core scan: {ran}")
    theta = cand.topk(SERVE_K, dim=1).values[:, -1].contiguous()
    band = CA.band_pairs()
    CA.count_above_fused(Wq, Hq, theta, h_scale=hs)
    band = CA.band_pairs() - band
    t_ms = abba_ms({
        "reservoir_scan": lambda: MR.reservoir_scan(Wk, Hq, SERVE_ITEMS,
                                                    4096),
        "reservoir_scan_plain": lambda: MR.reservoir_scan_plain(
            Wk, Hq, SERVE_ITEMS, 4096),
        "count_above": lambda: CA.count_above_fused(Wq, Hq, theta,
                                                    h_scale=hs),
        "count_above_plain": lambda: CA.count_above_fused_plain(
            Wq, Hq, theta, h_scale=hs),
    }, iters=3)
    flops = 2 * 512 * SERVE_RANK * SERVE_ITEMS
    # the int8 table read once, the queries, and the (score, id) slots or
    # the counts written once; the operands are bf16 queries and table
    # values exact in bf16, so the bf16 tensor-core peak bounds the work
    table_bytes = Hq.numel() * Hq.element_size()
    bounds["reservoir_scan"] = bound(
        flops, table_bytes + Wk.numel() * 4 + 512 * 2 * 4096 * 8, BF16_PEAK)
    bounds["count_above"] = bound(
        flops, table_bytes + Wq.numel() * 4 + hs.numel() * 4 + 512 * 8,
        BF16_PEAK)
    for name in ("reservoir_scan", "count_above"):
        k_ms[name], p_ms[name] = t_ms[name], t_ms[name + "_plain"]
        say("9 kernel timing", kernel=name, shape="b=512 r=256 m=10485760 "
            "int8", ms=f"{k_ms[name]:.3f}", plain_ms=f"{p_ms[name]:.3f}",
            TFLOP_s=f"{flops / k_ms[name] / 1e9:.2f}",
            bound_ms=f"{bounds[name][0]:.4f}", bound_by=bounds[name][1],
            **({"band_pairs_per_call": band} if name == "count_above"
               else {}), card=card)
    del Hq, hs, Wq, Wk, cand, theta, W8, train
    torch.cuda.empty_cache()

    # -- 18. cold users at config 5 (the tables of phase 8) ------------------
    cold_launches = cold_user_phase(nt, card, dev, recs, max_abs)
    del recs
    torch.cuda.empty_cache()

    # -- 19. dense beta MU at 4096^2, r = 256 (float32, bf16, int8 V) ---------
    beta_phase(nt, D, card, dev)

    # -- 10-12. sparse V at config 2's full width (ELL, densified) ----------
    ell = sparse_phases(nt, ratings, card, dev)
    max_abs["ell_rowsums"] = ell["max_abs_err"]
    k_ms["ell_rowsums"], p_ms["ell_rowsums"] = ell["ms"], ell["plain_ms"]
    bounds["ell_rowsums"] = (ell["bound_ms"], ell["bound_by"])
    library_ms = {"ell_rowsums": ell["library_ms"]}
    kl = ell["kl"]
    max_abs["ell_kl"] = kl["max_abs_err"]
    k_ms["ell_kl"], p_ms["ell_kl"] = kl["ms"], kl["plain_ms"]
    bounds["ell_kl"] = (kl["bound_ms"], kl["bound_by"])

    # -- 13-15. slice 4a: HALS, Jacobi and int8 x int8 MU ---------------------
    new = slice4a_phases(nt, card, dev, V, W0, H0, Vq, scale, plain_ms)
    for name, f in new.items():
        max_abs[name] = max(max_abs[name], f["max_abs_err"])
        k_ms[name], p_ms[name] = f["ms"], f["plain_ms"]
        bounds[name] = (f["bound_ms"], f["bound_by"])
        library_ms[name] = f["library_ms"]

    # -- 16-17. slice 8: config 3 on every engine, int8 densified, masked ---
    torch.cuda.empty_cache()
    s8 = slice8_phases(nt, card, dev, ratings)

    # -- 20. the native host layer; beta MU at config 2 on every engine -----
    torch.cuda.empty_cache()
    beta_engines_phase(nt, card, dev, ratings)

    # -- 21. slice 4b-i: the dense ALS family, GDCLS, nsNMF; the inits ------
    torch.cuda.empty_cache()
    family_launches = family_phase(nt, card, dev, V, W0, H0)
    # #6's one-sided entries: phase 15's launches and phase 17's
    for name, count in s8["launches"].items():
        new[name]["launches"] += count
        max_abs[name] = max(max_abs[name], s8["max_abs_err"])

    # -- 22. slices 4b-ii and 4c: every algorithm on sparse V, the inits ----
    torch.cuda.empty_cache()
    c3 = s8.pop("config3")
    s12 = sparse_algorithms_phase(nt, card, dev, ratings, c3, V, W0, H0)
    max_abs["hals_sweep"] = max(max_abs["hals_sweep"], s12["hals_max_abs"])

    # -- 23. slice 5: the sklearn facade, mini-batch, batched, vectorized,
    # checkpoint, model selection, compat, the CLI and the C ABI ----------
    del V, W0, H0, Vq, scale
    torch.cuda.empty_cache()
    ck_dir = tempfile.mkdtemp(prefix="nmftpu_ck23_")
    atexit.register(shutil.rmtree, ck_dir, True)
    s13 = surfaces_phase(nt, card, dev, ratings, max_abs, ck_dir)

    # -- 24. slice 6a: the 2-D grid (config 4's share, config 2 on four
    # ranks) and sharded serving (config 5 on four ranks) ---------------
    torch.cuda.empty_cache()
    s14 = grid_phase(nt, card, dev, ratings, c4, max_abs)
    c4_pool.shutdown()

    # -- 25. slice 6b: the ring, dense V on a mesh, the sharded fold-in,
    # MiniBatchNMF and the surfaces on a mesh ----------------------------
    torch.cuda.empty_cache()
    s15 = mesh_phase(nt, card, dev, ratings, c3, ck_dir, max_abs)

    # -- 26. slice 16: graft_entry on the card, ring iALS with each solver,
    # the ring and ELL plans' refusal of a masked run ---------------------
    torch.cuda.empty_cache()
    slice16_phase(nt, card, dev, ratings, c3)
    del ratings, c3

    # -- 27. #12 alone at config 3's two half-steps ---------------------------
    torch.cuda.empty_cache()
    rs = row_solve_phase(card, dev)
    max_abs["row_solve"] = rs["max_abs_err"]
    k_ms["row_solve"], p_ms["row_solve"] = rs["ms"], rs["plain_ms"]
    bounds["row_solve"] = (rs["bound_ms"], rs["bound_by"])

    # -- 28. #13 alone at config 3's two half-steps ---------------------------
    torch.cuda.empty_cache()
    eg = ell_gram_phase(card, dev)
    max_abs["ell_gram"] = eg["max_abs_err"]
    k_ms["ell_gram"], p_ms["ell_gram"] = eg["ms"], eg["plain_ms"]
    bounds["ell_gram"] = (eg["bound_ms"], eg["bound_by"])

    # -- 29. #11's CG rule on the msd-clicks cell's clicks at r = 256 -------
    torch.cuda.empty_cache()
    ec = ell_cg_phase(card, dev)
    max_abs["ell_cg"] = ec["max_abs_err"]
    k_ms["ell_cg"], p_ms["ell_cg"] = ec["ms"], ec["plain_ms"]
    bounds["ell_cg"] = (ec["bound_ms"], ec["bound_by"])

    if "jax" in sys.modules:
        fail("jax was imported")
    # a time below the least the card could take means a wrong bound
    below = {name: (k_ms[name], bounds[name][0]) for name in REPLACES
             if k_ms[name] < bounds[name][0]}
    if below:
        fail(f"kernels timed below their bound (ms, bound_ms): {below}")

    launches = {**main_path_launches, **serve_launches,
                "ell_rowsums": ell["launches"], "ell_kl": kl["launches"],
                # phase 22's ELL iALS run at config 3, the main path
                "row_solve": s12["row_solve"], "ell_gram": s12["ell_gram"],
                "ell_cg": s12["ell_cg"],
                **{name: f["launches"] for name, f in new.items()}}
    # #6's one-sided entry, #7 and #8 on the cold-user path (phase 18); the
    # one-sided entries on the int8 ALS family, GDCLS and nsNMF (phase 21)
    for name, count in cold_launches.items():
        launches[name] += count
    for name, count in family_launches.items():
        launches[name] += count
    # #7 on sparse HALS, the one-sided entries on the int8 densified family
    # (phase 22)
    for name, count in s12["launches"].items():
        launches[name] += count
    # #1-#4 and #7 on phase 23's surfaces
    for name, count in s13.items():
        launches[name] += count
    # #7, #8 and #9 on phase 24's ranks
    for name, count in s14.items():
        launches[name] += count
    # #1-#8 on phase 25's ranks (#5 first launched here)
    for name, count in s15.items():
        if name in launches:
            launches[name] += count
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": max_abs[name],
         "ms": k_ms[name], "plain_ms": p_ms[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library_ms.get(name)}
        for name in REPLACES
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
