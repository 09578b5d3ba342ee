#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card, and check them.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one NVIDIA Hopper card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA; imports nothing of JAX.  The
north-star model (5 eclipses, 2 bands, 128 points per eclipse, default
CVConfig widths) is built with synthetic data; the port's posterior and
ensemble sampler run at 1024 walkers in float32, and its gradient, HMC
and NUTS at 256 chains on the same model with the exposure widths a
.calib light curve gets (0.3 / 127 cycles); the GP flickering likelihood
runs on the same tree with use_gp on every eclipse, and on 10
complex-spot GP eclipses at 4096 walkers; parallel tempering at 4 rungs
x 256 walkers.  Every posterior call in this process runs eagerly (no
CUDA graph: the phases compare paths by patching module functions);
the phases' subprocesses take the graph route as the fit does.  Phases:

  1. device: the card, its power limit, the builds of K1 (contacts.cu),
     K1's backward (contacts_backward.cu), K2 (stream.cu) and K3 (gp.cu)
     from lfit_python_tpu_torch/ops/csrc/, in parallel, with the stack
     frame and registers of each instantiation from ptxas: K1's three
     (float32, float64, mixed precision), K1's backward (one pass each in
     float32 and float64), K2 and K3, whose frame must be 0: nothing in
     local memory (K3's are the forward kernel with and without the kept
     state and the reverse kernel, in both dtypes); and of K4-K6
     (roche.cu, float32 and float64), with no spill and no frame but the
     40 bytes sin / cos keep for arguments beyond 105615 in K4's float64
     one (ROCHE_FRAMES), and the warps an SM holds of each K4-K6
     instantiation (at least 8); and of K7, K8 and their backward kernels
     (sweeps.cu: float32 and float64; K7 with and without widths, K8 a
     thread a phase and a warp a (row, phase) pair), with no spill and no
     stack frame; and of K9 and K10 (wd_donor.cu: float32 and float64,
     K10 in its curve and distance modes), whose frames and spills are
     WD_DONOR_FRAMES (the arrays of sin / cos's slow path);
  2. K1 against its plain version on the contact rows one posterior
     evaluation hands it (5120 rows x 512 elements); the eclipsed share
     f, K1's operation count, its bound and its share of the bound; the
     device launches of one call of each wrapper (K1, K1 with its
     backward kernel, K2, K2 with sensitivities, K3 (one gp_kernel and no
     other device event), K3 with its reverse pass (at most 3 events), and
     K4, K5, K6 on the inputs that evaluation hands them (one event each),
     K7 and K8 on the disc rows and the donor rows that evaluation hands
     them, their backward kernels on those of one gradient evaluation of
     the GP widths model (one event each); K9 and K10 on the donor grid's
     and the white dwarf's inputs of that evaluation and K10's distance
     mode on the GP changepoints' (one event each)), read by the profiler;
  3. the posterior with K1 against the same posterior with the plain
     contact solver, at the same 1024 walkers, timed in turns; ms per
     evaluation, the stream scan (K2) alone, peak device memory, and the
     evaluation's device-busy share, launches (fewer than the 1222 with the
     donor grid and the white dwarf's sweep as eager chains) and device
     ms, with K9 and K10 once each;
  4. float32 flux parity against the port's own float64 plain path
     (64 walkers), and float64 fluxes against tests/golden/golden_v1.npz;
  5. the ensemble sampler: init_walkers and 3 run_sampler steps at 1024
     walkers, with the K1 and K2 launch counts read around the run;
  6. K2 against its plain version on the north-star stream inputs, bit
     for bit: the primal at 1024 walkers, with sensitivities at 256,
     float32 and float64; its bound and its time per RK4 step;
  7. the gradient on the widths model at 256 chains: ms per
     value_and_grad, peak memory, K1's backward kernel and K2's
     sensitivity launch counted once per evaluation; K1's backward kernel
     against its plain version (autograd on the edge residual) on that
     evaluation's contact rows, float64 and float32, its time, operations
     (counted by hand) and bound; the K1 path against the plain contact
     path with the float64 gradient as referee, float32 against float64,
     and where the device time goes;
  8. HMC on the widths model: init_hmc, warmup_hmc (4 steps) and run_hmc
     (3 steps) at 256 chains x 16 leapfrog steps, with the counts read
     around the run;
  9. K3 against its plain version on the series one evaluation of the GP
     model hands it (5120 series x 128 points), float32 (the float64 plain
     loop as referee) and float64; its time, the plain loop's, its bound
     and its chain floor; K3's reverse kernel against
     autograd on the plain loop on the series one gradient evaluation
     hands it (1280 series x 128 points), both dtypes, its time and bound;
 10. the GP posterior: at 1024 walkers with K3 and with the plain
     recursion in turns; the ensemble sampler on it; one evaluation of
     10 complex-spot GP eclipses at 4096 walkers; value_and_grad at 256
     chains on the GP model with exposure widths, with K3 and its
     reverse kernel and with the plain recursion under autograd in
     turns, float32 against float64; one hmc_step of 16 leapfrog steps;
 11. parallel tempering on the north-star model: init_pt and 3 pt_steps
     at 4 rungs x 256 walkers, each half's proposals one shared pass;
 12. NUTS on the widths model: 2 nuts_steps at max_depth 6 from phase
     8's adapted state, one gradient evaluation of all chains per leaf;
 13. the fit command, as a user runs it: lfit_python_tpu_torch.cli's
     main on examples/demo_input.dat (one simple-spot eclipse, 151
     points, its 1024 walkers, full resolution, float32) with --nburn 20
     --nprod 40 --checkpoint-every 20 into build/chip_fit/, then resumed
     to --nprod 60; the chain file's rows, the checkpoint steps, K1 and
     K2 twice per ensemble step, the last kept row's ln_prob column
     against the posterior evaluated afresh on those walkers, seconds
     per step and ln-prob evaluations per second; then those walkers
     and their first half (a half-step's 512) through the kernel path
     and the plain contact path (phase 3's limits), the first 256
     walkers' ln p and flux the same bits alone and in batches of 512
     and 1024, and K1 and K2 on the inputs the half's evaluation hands
     them against their plain versions (phase 2's and phase 6's limits);
     then light curves of 5 and 11 points (fewer than 16: flux sweep
     chunks and the donor normaliser with fewer than 16 outputs) at the
     default widths: a walker's ln p and flux the same bits alone, in 2,
     25 and 37, with the sweep's chunks at their default size and cut
     small;
 14. K1 in float64 and in mixed precision: the contact rows one
     evaluation of the float64 north-star posterior and of the precise
     float32 one (CVConfig.mixed_precision) hands K1 at 1024 walkers
     (5120 x 512), each instantiation against the plain version of its
     mode (phase 2's limits, and at most 1e-4 of the elements eclipsed in
     both above 1e-12 cycles in float64, above 1e-7 in mixed precision;
     the median and p99 printed), its time, the plain version's, its
     operations (float32 and float64 apart in the mixed mode) and bound,
     and the instructions it executes (counted from its SASS) with their
     time at the FP64, FP32 and MUFU issue rates; each posterior through
     K1 (one launch of its mode per evaluation) and through the plain
     solver, timed in turns
     (phase 3's limits), with its device-busy share; and the precise
     float32 fluxes through the mixed K1 against tests/golden/
     golden_v1.npz (every component within 1e-6 of the largest total,
     the JAX package's gate);
 15. the fit command's other branches through lfit_python_tpu_torch.cli's
     main, on copies of examples/demo_input.dat at full resolution under
     build/chip_fit_branches/: usePT = 1 with 4 rungs x 256 walkers
     (--nburn 4 --nprod 8 --checkpoint-every 4, resumed to 12; its
     evidence.json; K1 and K2 twice per PT step); --sampler hmc at 256
     chains (--nburn 4 --nprod 4 --checkpoint-every 2, resumed to 6) and
     --sampler nuts --nuts-max-depth 4 (--nburn 2 --nprod 2) on the demo
     light curve with exposure widths (K1, K1's backward kernel and K2
     with sensitivities once per gradient evaluation); --precise and
     --x64 at the demo's 1024 walkers (10 + 10 steps; K1 in that mode
     twice per step, K1 in float32 never); each exits 0, and its chain's
     last row's ln_prob agrees with a fresh evaluation (phase 13's limit);
     seconds per production step and evaluations (gradient evaluations,
     trajectories) per second.  Then each branch's kernels at its own
     shapes: that last row through the kernel path and the plain contact
     path (phase 3's limits; for --precise and --x64 also its first 512
     walkers, and K1 of that mode on the rows one evaluation of those 512
     hands it, phase 14's limits); for HMC and NUTS also the gradient of
     the two paths (phase 7's gate), and K1, K1's backward kernel and K2
     with sensitivities on the inputs one value_and_grad of the 256
     chains hands them, against their plain versions (phase 2's, 7's and
     6's limits).
  16. walker sharding (lfit_python_tpu_torch.parallel.mesh): in process, a
     one-rank NCCL group (so that the launch counters count), then
     cli.main fit --shard on the demo input (1024 walkers, --nburn 20
     --nprod 10) and --sampler hmc --shard --resume on phase 15's input
     (256 chains, from its checkpoint at production step 2 to 4: its
     warm-up reused); each chain file the same bytes as the first rows of
     the unsharded fit with the same seed (phases 13 and 15), K1 and K2
     launched on both paths (K1 = K2 per evaluation) and K1's backward
     kernel once per gradient evaluation on the HMC one; then an
     ensemble step (1024 walkers) and an hmc_step (256 chains, 4
     leapfrog steps) unsharded and sharded from one state and one
     generator state, in turns, the sharded state the same bits; the
     cost of one all-gather of a half-step's ln p (512 floats); then one
     `torchrun --nproc-per-node <device count>` subprocess fit --shard,
     its chain file compared the same way;
  17. the donor quadrature (CVConfig.n_donor_quad): the north-star model at
     1024 walkers in float32 with exact donor sums and with 256 nodes,
     timed in turns; the largest difference of the total flux against
     the largest total (limit 1e-6, the parity gate), the same -inf
     pattern, and each evaluation's K1 and K2 launches (one each);
  18. the host surface: cli fit on examples/demo_input.dat (--nburn 3
     --nprod 3) in a fresh process, once plain and once with --profile,
     --notify-file and --notify-cmd (the trace is the process's first
     profiler window, so it keeps every kernel record); the trace closes
     after cli.PROFILE_STEPS (4) of the 6 steps, and its contacts_kernel
     and stream_kernel events equal the K1 and K2 launches the wrappers
     counted in that window; one JSON line in
     the notify file and the subject through the command; chains.npz
     against the chain file (1e-10 relative); the plot line (matplotlib
     absent) or the PNGs; then ChainWriter(use_native=True) against the
     numpy writer on that production segment: the same bytes, both times;
  19. wdparams on the card: a synthetic input from the synthetic DA grid
     at Teff 15000 K, log g 8.0, parallax 5 mas with 1% errors, 64
     walkers, 200 + 400 steps; exit 0, the JAX package's keys, every
     median within 3 sigma of the truth; the ln p of 64 vectors on the
     card in float64 (the command's dtype) against float64 on the CPU
     (1e-12 x max(1, |ln p|)), the float32 distance printed beside it;
  20. compat.CV.calcFlux in float32 on the card, fast and precise, and
     plot_eclipse's evaluation (utils.plotting.eclipse_fluxes, float64)
     of the demo on the card, each against float64 on the CPU, over every
     phase of the total and the four components, of the largest total:
     precise within 1e-6 (the golden gate), fast within PERF.md section
     2's parity limits (median 1e-6, p99 1e-4, max 5e-2), the plot's
     float64 within 1e-10; one K1 launch (of the call's mode) and one K2
     launch a call;
  21. the posterior tools, each in its own process:
     tools/torch_ablate_posterior.py at 1024 walkers on the north star
     (and with --floor; every ablation's device kernels read by the
     profiler), tools/torch_accuracy_contacts.py (its p99 gate) and
     tools/torch_parity.py (PERF.md section 2's parity limits); their
     lines printed;
  22. K4-K6 (findi, xl1, the lobe radius) against their plain loops on
     the north star's solves (1024 walkers; 1024 radii) and a stress set
     of 8192 with infeasible pairs and a NaN q, float32 and float64: the
     same bits and NaN pattern; each kernel's time, its plain loop's, its
     bound and its chain floor (a model, per round) and the operations
     their groups execute (a model); K4-K6 built at each group depth d of
     tools/torch_roche_depths.py, their bits on the north star's solves
     and their times, launched back to back in turns; the float32, float64 and precise
     evaluations (1024 walkers) and value_and_grad (256 chains) through
     K4-K6 and through the plain loops: the same bits of ln p and flux (or
     gradient), K4 = K5 = 1 launch an evaluation (2 precise), and the
     device kernels of one evaluation either way (the forward one at least
     15000 fewer); the forward evaluation's ms either way, in turns.
     Phases 5, 8 and 14 count K4 = K5 = 1 per evaluation too, and every
     path of the kernels line launched K4, K5 and K6.
  23. K7 and K8 (the flux curves' sweeps: the disc and spot element
     curve, the donor sum) and their backward kernels against their plain
     versions on the rows one north-star evaluation (1024 walkers) and
     one gradient evaluation of the widths model (256 chains) hand them,
     and on a stress set (NaN intervals, non-eclipsed elements, phases on
     the contacts and the wrap, widths at the 1e-12 clamp; mu exactly 0
     and negative): the forward kernels the same bits in float32 and
     float64, the backward kernels within 1e-9 of the largest |gradient|
     of autograd on the plain forward in float64 and at PERF.md's float32
     gate, two launches the same bits; at each main call (the disc's and
     the spot's curves, the donor curve and its normaliser; of the
     gradient evaluation the disc's curve with widths and the backward
     kernels on the disc's rows, the donor curve's and its normaliser's)
     each kernel's time (traced in
     phase 2, and event-timed), its plain version's, its bound, and the
     torch.bmm of the materialised (rows, P, N) terms by the weights (the
     TPU's reduction alone, TF32 off), its operations' time at one an FP32
     lane and clock (the issue floor under --fmad=false); ptxas's
     registers, frame and spills of the 14 instantiations (0 bytes of
     frame and spill), and the instructions a term of the main ones from
     the build's SASS
     (tools/sweeps_sass_counts.py; SWEEPS_SASS_PER_TERM) with their time
     at the issue rate and each pipe's; the forward evaluation's and the
     gradient evaluation's device kernels, device time and peak memory
     through the kernels and through the plain sweeps, the host ms of the
     forward in turns.  Every path counts K7 = K8 = 2 per evaluation of
     K1 (K8 = 1 with the donor quadrature) and their backward kernels 2
     per gradient evaluation.
  24. K9 and K10 (the donor grid's radius solve, the white dwarf's
     sweep: wd_donor.cu) against their plain versions on the inputs one
     north-star evaluation hands them (1024 walkers x 384 directions;
     5120 rows x 128 phases; K10's distance mode on the GP changepoints')
     and on a stress set (q 0.03-3.5, inclinations 75-90 deg, phases
     across ingress, egress and mid-eclipse, rays that miss the donor,
     the inscribed-sphere guard), and at K10's row lengths
     (WD_PHASES: rows of fewer phases than a warp to the widths' 384) and
     K9's grids (DONOR_GRIDS), float32 and float64: the same bits;
     each kernel's time (traced in phase 2, and event-timed), its plain
     version's, its bound, ptxas's registers and frame; the float32,
     float64, precise and GP forward evaluations and value_and_grad
     through K9 / K10 and through the plain chains: the same bits, K9 = 1
     and K10 = 1 an evaluation (0 on a gradient or precise one, 2 more for
     the GP changepoints), the device kernels and device ms either way
     (the forward one at least 500 fewer); the forward evaluation's host
     ms either way, in turns.  Every path counts K9 once per evaluation
     of K1.

Every failed check raises, so the exit code is non-zero.  The last lines
are a JSON object describing each kernel (its launches on the main paths,
its error against its plain version, its time, its plain version's time,
its bound and what sets it), the card's name and power limit as
nvidia-smi gives them, and {"ok": true, "device": {...}}.

A kernel's bound is the least time the card could take for its work: the
larger of its bytes (each input read once, each output written once)
over the memory rate and its operations over the peak rate for their
type, with the peaks of one H100 SXM from NVIDIA's data sheet (3.35 TB/s;
67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor cores).
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
N_WALKERS = 1024
N_CHAINS = 256
N_LEAPFROG = 16
K1_SOURCE = "lfit_python_tpu_torch/ops/csrc/contacts.cu"
K1_REPLACES = "lfit_python_tpu/ops/pallas_contacts.py:352"
K1_GRAD_REPLACES = "lfit_python_tpu/ops/pallas_contacts.py:448"
# float64 and --precise take the JAX package's plain XLA solver
K1_MODE_REPLACES = ("lfit_python_tpu/ops/pallas_contacts.py:352 (the "
                    "JAX package runs float64 and --precise on "
                    "lfit_python_tpu/roche/geometry.py:259)")
K1_BWD_SOURCE = "lfit_python_tpu_torch/ops/csrc/contacts_backward.cu"
K2_SOURCE = "lfit_python_tpu_torch/ops/csrc/stream.cu"
K2_REPLACES = "lfit_python_tpu/roche/stream.py:278"
K3_SOURCE = "lfit_python_tpu_torch/ops/csrc/gp.cu"
K3_REPLACES = "lfit_python_tpu/ops/gp.py:88"
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
# operations, counted by hand from the kernel sources (each rsqrt, sqrt,
# divide and atan as one): K1 per element (setup and conjunction test)
# and per eclipsed element (bracket, 16 edge steps, atans); K2 per RK4
# step for the primal and for each of its two tangent columns
K1_OPS_ELEMENT = 287
K1_OPS_ECLIPSED = 3401
# K1 in mixed precision per eclipsed element, beside K1_OPS_ELEMENT for
# its float32 setup and conjunction test, counted from contacts.cu with
# every arithmetic operation, compare and select as one (an edge step is
# 240 so): float32, the bracket and edge start (68), 10 edge steps
# (2400) and per edge the tail's start (12) and 4 iterations of the ray
# minimum with its 3 Newton steps and 3 end values, the phase's sin and
# cos and the envelope derivative (339 each); float64, the element's
# position terms (8) and per edge 4 iterations of c with its sin and cos
# and the phase update (62 each)
K1_MIXED_OPS_ECLIPSED_F32 = 68 + 10 * 240 + 2 * (12 + 4 * 339)
K1_MIXED_OPS_ECLIPSED_F64 = 8 + 2 * 4 * 62
# What each K1 instantiation executes, beside the operations its bound
# counts: instructions of each class per element and what an eclipsed
# element adds, counted from the SASS of contacts.cu built by
# ops/_build.py (tools/k1_sass_counts.py: one thread's path, the loops
# at their trip counts, no slow path).  Phase 1 recounts them from the
# library it builds and fails if they differ.
K1_EXECUTED = {
    "contacts_kernel<f32>": {
        "element": dict(DFMA=0, DMUL=0, DADD=0, DSETP=0, MUFU=28, FP32=403,
                        CONV=0, OTHER=159),
        "eclipsed": dict(DFMA=0, DMUL=0, DADD=0, DSETP=0, MUFU=163, FP32=3698,
                         CONV=0, OTHER=698)},
    "contacts_kernel<f64>": {
        "element": dict(DFMA=200, DMUL=119, DADD=28, DSETP=47, MUFU=27,
                        FP32=11, CONV=0, OTHER=358),
        "eclipsed": dict(DFMA=1449, DMUL=990, DADD=368, DSETP=468, MUFU=163,
                         FP32=17, CONV=0, OTHER=2261)},
    "contacts_mixed_kernel": {
        "element": dict(DFMA=0, DMUL=0, DADD=0, DSETP=0, MUFU=28, FP32=400,
                        CONV=0, OTHER=173),
        "eclipsed": dict(DFMA=298, DMUL=121, DADD=75, DSETP=40, MUFU=273,
                         FP32=5169, CONV=80, OTHER=1460)}}
# per SM and clock on an H100: lanes of the FP64 pipe, the FP32 pipe and
# the special function unit, and instructions its four schedulers issue
SM_LANES = {"fp64": 64, "fp32": 128, "mufu": 16, "issue": 128}
# the phase error (cycles) that at most 1e-4 of the elements may pass
# against the plain version of the mode: float64 and the mixed mode keep
# their precision (measured 2.8e-17 and 0 before their redesign)
K1_TIGHT = {"float64": 1e-12, "mixed_precision": 1e-7}
K2_OPS_STEP = 180
K2_OPS_STEP_COLUMN = 248
# K1's backward.  What the function needs per eclipsed edge: the residual
# at its root once (33 for the setup, 2 + 3 x 56 for the clamped Newton
# steps in t, 3 x 24 for the end values, 6 selects: 281, and 40 for
# dc/dphi) and the cheapest exact adjoint of those 281, a reverse sweep at
# twice their count (the Newton iterate's own tangent is kept: nothing is
# dropped on the strength of the envelope theorem); per element, the
# never-eclipsed phase's atan2 gradient and the masks.  What
# contacts_backward_kernel executes, counted from its source: a reverse
# sweep on each eclipsed element's two edges (those of the others are
# skipped), 1188 per edge (216 for the forward's chord and 3 Newton steps,
# 133 for the end values, dc/dphi and the adjoint w, 839 for the sweep:
# the selects, 3 x 64 for the end values, 3 x 183 for the Newton steps
# with their terms recomputed, 82 for the chord and the angles), and 47
# per element
# K3 per point of a series (the divide, the log, sincospi, exp and each
# select as one): the recursion's 64 and the angle's and the decay's 7; its
# reverse kernel per point: the step's forward again without the log (42),
# the adjoint (112), the angle and the decay (7) and their adjoints folded
# into d c (10)
K3_OPS_POINT = 64 + 7
K3_BWD_OPS_POINT = 171
# K3's dependent chain per point, in cycles, counted from gp.cu's gp_step
# with assumed latencies (a float32 add or multiply 4 cycles, a float64 one
# 8, a select or clamp 4-8, the reciprocal estimate 20 / 28): the decay (2),
# S U (2), D (3) and its clamp, the reciprocal and its Newton step (2 /
# 4), the quotient and its correction (3), the update (3) and the mask's
# select.  P times that over the SM clock is the chain floor, a model
# number beside the measured time, not a measurement
K3_CHAIN_CYCLES = {"float32": 92, "float64": 172}
K1_BWD_OPS_EDGE = 321 + 2 * 281
K1_BWD_OPS_ELEMENT = 15
K1_BWD_EXECUTED_EDGE = 1188
K1_BWD_EXECUTED_ELEMENT = 47
# K4-K6 (roche.cu): the core geometry's bisections, port-only kernels
# where the TPU ran an XLA lax.fori_loop
ROCHE_SOURCE = "lfit_python_tpu_torch/ops/csrc/roche.cu"
ROCHE_REPLACES = {
    "findi": "lfit_python_tpu/roche/geometry.py:283 (findi's 54-step "
             "lax.fori_loop, :316; no pallas_call)",
    "xl1": "lfit_python_tpu/roche/geometry.py:114 (xl1's 64-step "
           "lax.fori_loop, :133; no pallas_call)",
    "lobe_radius": "lfit_python_tpu/roche/geometry.py:1140 (lobe_radius's "
                   "54-step lax.fori_loop, :1169; inscribed_radius :539; "
                   "no pallas_call)"}
# sin / cos in float64 keep an array in local memory for the Payne-Hanek
# reduction of |x| > 105615, which K4's angles never reach (ptxas of CUDA
# 12.8 for sm_90a): K4's float64 stack frame is that array and nothing
# else.  sinf / cosf kept one too (32 bytes) in a one-thread-a-solve K4;
# the group kernel's float32 build keeps none.  K5 and K6 have none
ROCHE_FRAMES = {"findi_kernel<f32>": 0, "findi_kernel<f64>": 40,
                "xl1_kernel<f32>": 0, "xl1_kernel<f64>": 0,
                "lobe_radius_kernel<f32>": 0, "lobe_radius_kernel<f64>": 0}
# K4-K6 run a group of 2^d lanes a solve, d set by these macros of
# roche.cu
ROCHE_DEPTH_MACROS = {"findi": "FINDI_DEPTH", "xl1": "XL1_DEPTH",
                      "lobe_radius": "LOBE_DEPTH"}
# K4-K6's blocks (128 threads: 4 warps); an SM holds at most 64 warps
# and 32 blocks, and allocates registers to a warp 256 at a time
ROCHE_GROUP_BLOCK_WARPS = 4
# operations per bisection step and per solve outside the loop, counted by
# hand from roche.cu (each divide, sqrt, rsqrt, sin and cos, compare and
# select as one): K4 a step 253 (the clearance's setup 25, 4 Newton steps
# of 41, 3 values of g of 19, the end selects 7), per solve 8 and the
# clearance at 90 deg once more; K5 14 a step, 5 a solve; K6 32, 5.  The
# bound counts this, the sequential algorithm's work, whatever runs it;
# the kernels' groups execute more: a round of r levels tests all 2^r - 1
# of its midpoints (a model, printed in phase 22: the replay of their
# paths and the walk not counted)
ROCHE_OPS = {"findi": (253, 8 + 253), "xl1": (14, 5), "lobe_radius": (32, 5)}
# the inputs of each solve (its output is one more number)
ROCHE_INPUTS = {"findi": 4, "xl1": 1, "lobe_radius": 6}
# each kernel's dependent chain per bisection step, counted from roche.cu:
# (adds, multiplies, compares and selects; divides; square roots; rsqrts;
# sin), and the latencies in cycles assumed for each (a float32 add 4, a
# float64 one 8; the IEEE divide and sqrt, the rsqrt with its fix-up and
# sinf's reduction and polynomial).  The chain floor is rounds x (chain +
# the deepest lane's replay of r - 1 levels and the walk's r, 3 dependent
# adds, multiplies or selects a level, + a ballot of ROCHE_BALLOT_CYCLES),
# K4's feasibility test in the last round.  Over the SM clock: a model number beside the measured time, not
# a measurement
ROCHE_CHAIN = {"findi": (88, 4, 1, 5, 1), "xl1": (8, 1, 0, 0, 0),
               "lobe_radius": (13, 1, 1, 0, 0)}
ROCHE_LATENCY = {"float32": (4, 40, 40, 20, 60),
                 "float64": (8, 100, 100, 60, 160)}
ROCHE_BALLOT_CYCLES = 20
# K4-K6 launches of one evaluation (forward or value_and_grad; K4 and K5
# twice in the precise mode): findi and xl1 once, and the inscribed radius
# once, a solve a walker, for the contact rows and the white dwarf's
# certain-occultation guard both
ROCHE_PER_EVAL = {"k4": 1, "k5": 1, "k6": 1}
# K7, K8 (sweeps.cu): the flux curves' sweeps and their backward kernels,
# port-only kernels where the TPU fused the (P, N) terms into a reduction
SWEEPS_SOURCE = "lfit_python_tpu_torch/ops/csrc/sweeps.cu"
SWEEPS_REPLACES = {
    "element_curve": "lfit_python_tpu/models/components.py:346 "
                     "(element_flux_curve: an XLA fusion into jnp.dot, :378; "
                     "visible_fraction_interval lfit_python_tpu/roche/"
                     "geometry.py:1119; no pallas_call)",
    "element_curve_backward": "lfit_python_tpu/models/components.py:346 "
                              "(jax.grad of element_flux_curve; no "
                              "pallas_call)",
    "donor_sum": "lfit_python_tpu/models/components.py:598 (donor_flux: an "
                 "XLA input fusion into jnp.sum, :626; no pallas_call)",
    "donor_sum_backward": "lfit_python_tpu/models/components.py:598 "
                          "(jax.grad of donor_flux; no pallas_call)"}
# K7 and K8 launches of one evaluation (forward, or the forward of a
# gradient evaluation): K7 for the disc and the spot, K8 for the donor
# curve and its quadrature normaliser; with n_donor_quad K8 once, the
# nodes.  A gradient evaluation launches each backward kernel as often
SWEEPS_PER_EVAL = {"k7": 2, "k8": 2}
SWEEPS_PER_GRAD = {"k7": 2, "k7_bwd": 2, "k8": 2, "k8_bwd": 2}
# operations per term (rows x P x N of them), one per PyTorch operation of
# the plain chain, counted from sweeps.cu: K7 without widths ph - pin,
# floor, the subtraction, the compare, its conversion, 1 - x, the product
# by w and the add of the sum (8); with widths hw - pin, remainder, dur -
# rel, clamp, minimum, rel + w, - 1, clamp, minimum, the sum, clamp,
# minimum, the divide, the select, 1 - frac, the product, the add (17);
# K8 the dot (5), clamp, the three products and the add of the weight,
# the product by the area and the add (12).  The backward's per term:
# without widths d w alone (vis, the product, the add: 8); with widths the
# overlap again (12), the visibility (3), and the adjoint by autograd's
# rules (21: g w, its negation, select and divide, the two minima's and
# three clamps' shares, d rel and d dur, the adds into d ph, d pin, d pout
# and d w and the product g vis); K8 the weight again (10), d a (2), g a,
# d mu (6), the clamp's share, d e and d n (12): 32
SWEEP_OPS = {"instant": 8, "widths": 17, "donor": 12}
SWEEP_BWD_OPS = {"instant": 8, "widths": 36, "donor": 32}
# instructions issued a term by the main paths' instantiations of K7, K8
# and their backward kernels, from the build's SASS
# (tools/sweeps_sass_counts.py: its main term loop's instructions over its
# terms a trip); after an edit of sweeps.cu that changes their code, run
# that tool on the card and paste its counts
SWEEPS_SASS_PER_TERM = {
    "element_curve_kernel<f32, instant>": 5.484,
    "element_curve_kernel<f64, instant>": 10.375,
    "element_curve_kernel<f32, widths>": 22.875,
    "element_curve_kernel<f64, widths>": 40.656,
    "element_curve_backward_kernel<f32, widths>": 56.25,
    "element_curve_backward_kernel<f64, widths>": 87.0,
    "donor_sum_kernel<f32, threads>": 14.156,
    "donor_sum_kernel<f64, threads>": 16.156,
    "donor_sum_kernel<f32, lanes>": 26.75,
    "donor_sum_kernel<f64, lanes>": 28.0,
    "donor_sum_backward_kernel<f32>": 23.25,
    "donor_sum_backward_kernel<f64>": 35.75}
# the instantiation of each main call, float32
SWEEP_SASS_OF = {"K7 element_curve disc": "element_curve_kernel<f32, instant>",
                 "K7 element_curve widths":
                 "element_curve_kernel<f32, widths>",
                 "K7 element_curve_backward disc":
                 "element_curve_backward_kernel<f32, widths>",
                 "K8 donor_sum curve": "donor_sum_kernel<f32, threads>",
                 "K8 donor_sum normaliser": "donor_sum_kernel<f32, lanes>",
                 "K8 donor_sum_backward curve":
                 "donor_sum_backward_kernel<f32>",
                 "K8 donor_sum_backward normaliser":
                 "donor_sum_backward_kernel<f32>"}
# K9, K10 (wd_donor.cu): the donor grid's radius solve and the white
# dwarf's sweep, port-only kernels where the TPU ran an XLA program with
# its loops fused
WD_DONOR_SOURCE = "lfit_python_tpu_torch/ops/csrc/wd_donor.cu"
WD_DONOR_REPLACES = {
    "donor_grid": "lfit_python_tpu/models/components.py:391 (donor_grid: "
                  "lax.fori_loops of 54 bisections in float64, :447, of 8 "
                  "bisections and 4 safeguarded Newton steps in float32, "
                  ":459, :473; no pallas_call)",
    "wd_curve": "lfit_python_tpu/models/components.py:145 (wd_flux; "
                "origin_shadow_distance lfit_python_tpu/roche/geometry.py:"
                "361, its 4 Newton steps unrolled :426; the edge fraction "
                ":58; no pallas_call)"}
# K9 and K10 launches of one evaluation: K9 the donor grid once (on a
# gradient evaluation its radius and slope alone), K10 the white dwarf's
# curve once on a forward evaluation (a gradient or precise one takes the
# plain chain) and, on a GP evaluation, once for each of the
# changepoints' two Newton steps (distance mode)
WD_DONOR_PER_EVAL = {"k9": 1, "k10": 1}
WD_DONOR_PER_GRAD = {"k9": 1, "k10": 0}
WD_GP_CHANGEPOINTS = 2
# ptxas's stack frame and spills (bytes, stores and loads) of each K9 /
# K10 instantiation (CUDA 12.8, sm_90a; K10's flag 0 the curve, 1 the
# distance mode): K10's frames are the arrays of sinf / cosf's and sin /
# cos's Payne-Hanek slow path (|x| > 48039 / 105615), which no angle of the
# sweep reaches; K9 calls no trig; nothing spills
WD_DONOR_FRAMES = {"donor_grid_kernel<f32>": (0, 0),
                   "donor_grid_kernel<f64>": (0, 0),
                   "wd_curve_kernel<f32, 0>": (32, 0),
                   "wd_curve_kernel<f32, 1>": (32, 0),
                   "wd_curve_kernel<f64, 0>": (40, 0),
                   "wd_curve_kernel<f64, 1>": (40, 0)}
# operations counted by hand from wd_donor.cu (each add, multiply, divide,
# sqrt, rsqrt, sin, cos, acos, compare and select as one): K9 a solve 5 to
# set up, a bisection step 25 (the lobe's F 20), a Newton step 54 (F 20,
# dF/dr 22), the midpoint 2, and the grid 51 (a forward evaluation's
# launch, the one timed) or the slope 22 (a recorded graph's): with the
# grid float32 474 (8 + 4 steps), float64 1408 (54 steps); K10 a point: the
# distance mode 314 (the set-up 32, 4 Newton steps of 41, 3 values of g of
# 18, the end selects 8, grad(Phi) across the sight line and d 56), the
# curve 354 (with the guard 8, x 5 and the edge fraction 27)
WD_DONOR_OPS = {"donor_grid": {"float32": 474, "float64": 1408},
                "wd_curve": 354, "wd_distance": 314}
# instructions issued a solve (K9) and a point (K10) on the north star's
# path by each instantiation, all-in (the loop's a point and what a lane
# runs outside it, over its points or solves), from the build's SASS
# (tools/wd_donor_sass_counts.py); after an edit of wd_donor.cu that
# changes their code, run that tool on the card and paste its counts
WD_DONOR_SASS_PER_POINT = {"donor_grid_kernel<f32>": 845.0,
                           "donor_grid_kernel<f64>": 3346.0,
                           "wd_curve_kernel<f32, 0>": 734.25,
                           "wd_curve_kernel<f32, 1>": 621.0,
                           "wd_curve_kernel<f64, 0>": 1177.25,
                           "wd_curve_kernel<f64, 1>": 907.0}
# the instantiation of each of phase 24's calls, by dtype
WD_SASS_OF = {"donor_grid": "donor_grid_kernel<{}>",
              "wd_curve": "wd_curve_kernel<{}, 0>",
              "wd_distance": "wd_curve_kernel<{}, 1>"}
# phase 24's other shapes: K10's row lengths (fewer phases than a warp, a
# warp's, between, the north star's 128 and around it, the widths' P *
# n_sub = 384) on 37 x 3 rows, not a multiple of a block's; K9's grids
# (n_lat, n_lon) of fewer directions than a block, a few, more than a
# block's chunk, on 13 walkers
WD_PHASES = (1, 2, 5, 31, 32, 33, 127, 128, 129, 384)
DONOR_GRIDS = ((6, 8), (5, 7), (3, 3), (32, 48))
NO_LIBRARY = "no single PyTorch call computes this function: {}"


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _sync_time(fn, reps):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _event_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_kernels(fn):
    """Device kernels of one profiled call of ``fn``: (busy us, kernel
    count, host-clock us of the call, {kernel name: device us})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = defaultdict(float)
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            n += 1
    return sum(by_name.values()), n, wall_us, by_name


def _busy_line(busy_us, n_kern, wall_us):
    if not n_kern:
        return "not measured (no device events traced)"
    return (f"{busy_us / wall_us:.1%} ({n_kern} kernels, {busy_us:.0f} us "
            f"on the device in {wall_us:.0f} us)")


def _bound(ops, nbytes, dtype="float32"):
    """(least ms the card could take, what sets it) for ``ops``
    operations of ``dtype`` moving ``nbytes`` bytes."""
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _stack_frames(ptxas_log):
    """{kernel entry: (stack-frame bytes, registers)} from an ``-Xptxas
    -v`` report."""
    return {e: (v["frame"], v.get("registers"))
            for e, v in _ptxas_entries(ptxas_log).items()}


def _ptxas_entries(ptxas_log):
    """{kernel entry: {"frame": stack-frame bytes, "spill": spilled bytes
    (stores and loads), "registers": n}} from an ``-Xptxas -v``
    report."""
    out, entry = {}, None
    for ln in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and entry is not None:
            out[entry] = {"frame": int(m.group(1)),
                          "spill": int(m.group(2)) + int(m.group(3))}
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry in out:
            out[entry]["registers"] = int(m.group(1))
            entry = None
    return out


def _executed(kernel, n_el, n_ecl):
    """The instructions ``kernel`` (a K1_EXECUTED key) executes on
    ``n_el`` elements of which ``n_ecl`` are eclipsed, and their least
    time (ms) at the FP64 pipe's rate (DFMA, DMUL, DADD, DSETP), the FP32
    pipe's, the special function unit's and the schedulers' (every
    instruction), full warps at the card's top SM clock."""
    import torch

    ex = K1_EXECUTED[kernel]
    tot = {c: n_el * v + n_ecl * ex["eclipsed"][c]
           for c, v in ex["element"].items()}
    per_s = (torch.cuda.get_device_properties(0).multi_processor_count
             * _sm_clock_hz() / 1e3)
    pipe = {"fp64": tot["DFMA"] + tot["DMUL"] + tot["DADD"] + tot["DSETP"],
            "fp32": tot["FP32"], "mufu": tot["MUFU"],
            "issue": sum(tot.values())}
    return {"instructions": tot, **{f"{k}_ms": v / (SM_LANES[k] * per_s)
                                    for k, v in pipe.items()}}


def _executed_line(kernel, ex, ms):
    e = K1_EXECUTED[kernel]
    return ("executes per element / per eclipsed one (SASS): "
            + ", ".join(f"{c} {e['element'][c]} / {e['eclipsed'][c]}"
                        for c in e["element"])
            + f"; at the FP64 pipe's rate {ex['fp64_ms']:.4f} ms, FP32 "
            f"{ex['fp32_ms']:.4f}, MUFU {ex['mufu_ms']:.4f}, issue "
            f"{ex['issue_ms']:.4f} (the kernel at {ms:.4f} ms)")


def _sm_clock_hz():
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])


def _roche_warps_per_sm(regs):
    """The warps an SM holds of a K4-K6 instantiation of ``regs``
    registers a thread, in whole blocks of ROCHE_GROUP_BLOCK_WARPS."""
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(32, 65536 // (per_warp * ROCHE_GROUP_BLOCK_WARPS),
                 64 // ROCHE_GROUP_BLOCK_WARPS)
    return blocks * ROCHE_GROUP_BLOCK_WARPS


def _roche_depth(name):
    """The group depth d (2^d lanes a solve) roche.cu builds K4 ("findi"),
    K5 ("xl1") or K6 ("lobe_radius") at."""
    return int(re.search(rf"#define {ROCHE_DEPTH_MACROS[name]} (\d+)",
                         (ROOT / ROCHE_SOURCE).read_text()).group(1))


def _short_entry(entry):
    """``kernel<f32>`` for a mangled template kernel's entry name."""
    m = re.search(r"\d([a-z_][a-z0-9_]*_kernel)I([fd])"
                  r"(?:Lb([01])|Li(\d+)ELi(\d+))?", entry)
    if not m:
        m = re.search(r"\d([a-z_][a-z0-9_]*_kernel)E", entry)
        return m.group(1) if m else entry[-44:]
    name, typ, flag, threads, blocks = m.groups()
    extra = ("" if flag is None else ", " + flag) + (
        "" if threads is None else f", {threads} threads, {blocks} blocks")
    return f"{name}<{'f32' if typ == 'f' else 'f64'}{extra}>"


def _launches_per_call(calls):
    """The device events of one warmed-up call of each of ``calls``
    ({name: fn}), in one profiled window, each call after a spin kernel
    that marks where its events start: ({name: [event names]}, {name:
    {event name: device us}}).

    Run it before any other profiled window of the process: after one
    window and many untraced launches, the next window has lost its first
    kernel records on the H100 (PERF.md)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    _check(sum("spin_kernel" in e.name for e in events) == len(calls)
           and "spin_kernel" in events[0].name,
           "the trace lost a marker: launches per call not read")
    out, device_us, order = {}, {}, iter(calls)
    for e in events:
        if "spin_kernel" in e.name:
            cur = next(order)
            out[cur], device_us[cur] = [], defaultdict(float)
        else:
            out[cur].append(e.name)
            device_us[cur][e.name] += e.time_range.elapsed_us()
    return out, device_us


def _check_launches(tag, names, kernel):
    """(launches of ``kernel``, device events) of one wrapper call whose
    device events are ``names``; fails unless it is one launch and no
    memory copy or set."""
    mine = sum(bool(re.search(rf"\b{kernel}\b", nm)) for nm in names)
    copies = sum(nm.startswith(("Memcpy", "Memset")) for nm in names)
    print(f"[2 launches] {tag}, one wrapper call: {mine} {kernel} launch, "
          f"{len(names)} device events in all (the rest PyTorch's own "
          f"kernels around it), {copies} copies or sets")
    _check(mine == 1 and copies == 0,
           f"a {tag} call is not one {kernel} launch without copies: "
           f"{[nm[:60] for nm in names]}")
    return mine, len(names)


@contextlib.contextmanager
def _roche_wrappers(roche, make):
    """Each K4-K6 wrapper of ``roche`` replaced by ``make(name, wrapper)``
    while the context lasts; yields {name: its replacement}."""
    with contextlib.ExitStack() as stack:
        yield {n: stack.enter_context(mock.patch.object(
            roche, f"{n}_kernel", make(n, getattr(roche, f"{n}_kernel"))))
            for n in ("findi", "xl1", "lobe_radius")}


@contextlib.contextmanager
def _sweep_wrappers(sweeps):
    """Each K7 / K8 wrapper of ``sweeps`` (forward and backward) wrapped
    by a recording mock while the context lasts; yields {name: mock}."""
    names = ("element_curve", "element_curve_backward", "donor_sum",
             "donor_sum_backward")
    with contextlib.ExitStack() as stack:
        yield {n: stack.enter_context(mock.patch.object(
            sweeps, f"{n}_kernel", wraps=getattr(sweeps, f"{n}_kernel")))
            for n in names}


@contextlib.contextmanager
def _wd_wrappers(wd_donor):
    """K9's and K10's wrappers (K10 in both modes) of ``wd_donor`` wrapped
    by recording mocks while the context lasts; yields {name: mock}."""
    names = ("donor_grid", "wd_curve", "wd_distance")
    with contextlib.ExitStack() as stack:
        yield {n: stack.enter_context(mock.patch.object(
            wd_donor, f"{n}_kernel", wraps=getattr(wd_donor, f"{n}_kernel")))
            for n in names}


# (tag, wrapper) of the K9 / K10 calls that phases 2 and 24 read: the
# donor grid and the white dwarf's curve of a forward evaluation, K10's
# distance mode of a GP one (its changepoints' first Newton step)
_WD_CALLS = (("K9 donor_grid", "donor_grid"), ("K10 wd_curve", "wd_curve"),
             ("K10 wd_distance", "wd_distance"))


SWEEP_ROWS = {"element_curve": ("disc", "spot"),
              "donor_sum": ("curve", "normaliser")}


def _cast(args, dtype):
    """``args`` with each floating tensor in ``dtype``."""
    import torch

    return tuple(a.to(dtype) if isinstance(a, torch.Tensor)
                 and a.is_floating_point() else a for a in args)


def _sweep_calls(fwd, bwd):
    """(tag, kernel name, arguments) of the calls of K7, K8 and their
    backward kernels that phases 2 and 23 read: the disc's and the spot's
    curves and the donor curve and its normaliser of a forward evaluation
    (``fwd``); of a gradient evaluation (``bwd``) the disc's curve with
    widths, and the disc's, the donor curve's and its normaliser's
    cotangents."""
    calls = [(f"K{k} {n} {row}", n, fwd[n][i])
             for k, n in ((7, "element_curve"), (8, "donor_sum"))
             for i, row in enumerate(SWEEP_ROWS[n])]

    def size(a):
        return a[0].shape[1] * a[2].shape[-1]
    # autograd runs the backward kernels in the reverse order: the larger
    # call (the disc's elements, the donor curve's phases) is the main one
    return calls + [
        ("K7 element_curve widths", "element_curve",
         max(bwd["element_curve"], key=size)),
        *((f"K{k} {n}_backward {SWEEP_ROWS[n][0]}", f"{n}_backward",
           max(bwd[f"{n}_backward"], key=size))
          for k, n in ((7, "element_curve"), (8, "donor_sum"))),
        ("K8 donor_sum_backward normaliser", "donor_sum_backward",
         min(bwd["donor_sum_backward"], key=size))]


def _walkers(start, n, seed, dtype, dev):
    import torch

    rng = np.random.default_rng(seed)
    pos = (start[None, :] + 0.001 * np.abs(start)[None, :]
           * rng.standard_normal((n, start.size)))
    return torch.tensor(pos, dtype=dtype, device=dev)


def _zero_counts(contacts, stream, gp):
    """Sets every kernel wrapper's launch count to 0 (K4-K10's too)."""
    from lfit_python_tpu_torch.ops import roche, sweeps, wd_donor

    contacts.LAUNCHES = contacts.BACKWARD_CALLS = 0
    contacts.BACKWARD_LAUNCHES = 0
    contacts.F64_LAUNCHES = contacts.MIXED_LAUNCHES = 0
    stream.LAUNCHES = stream.SENS_LAUNCHES = 0
    gp.LAUNCHES = gp.BACKWARD_LAUNCHES = 0
    roche.FINDI_LAUNCHES = roche.XL1_LAUNCHES = roche.LOBE_LAUNCHES = 0
    sweeps.CURVE_LAUNCHES = sweeps.CURVE_BACKWARD_LAUNCHES = 0
    sweeps.DONOR_LAUNCHES = sweeps.DONOR_BACKWARD_LAUNCHES = 0
    wd_donor.DONOR_GRID_LAUNCHES = wd_donor.WD_LAUNCHES = 0


def _counts(contacts, stream, gp):
    from lfit_python_tpu_torch.ops import roche, sweeps, wd_donor

    return {"k1": contacts.LAUNCHES, "k1_f64": contacts.F64_LAUNCHES,
            "k1_mixed": contacts.MIXED_LAUNCHES,
            "k1_bwd": contacts.BACKWARD_CALLS,
            "k1_bwd_kernel": contacts.BACKWARD_LAUNCHES,
            "k2": stream.LAUNCHES, "k2_sens": stream.SENS_LAUNCHES,
            "k3": gp.LAUNCHES, "k3_bwd": gp.BACKWARD_LAUNCHES,
            "k4": roche.FINDI_LAUNCHES, "k5": roche.XL1_LAUNCHES,
            "k6": roche.LOBE_LAUNCHES, "k7": sweeps.CURVE_LAUNCHES,
            "k7_bwd": sweeps.CURVE_BACKWARD_LAUNCHES,
            "k8": sweeps.DONOR_LAUNCHES,
            "k8_bwd": sweeps.DONOR_BACKWARD_LAUNCHES,
            "k9": wd_donor.DONOR_GRID_LAUNCHES, "k10": wd_donor.WD_LAUNCHES}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _k3_graph(fn, args, kw):
    """``fn`` (a segmented_matern32 function) recorded by autograd on
    ``args`` = (t, y, yerr, sigma2, c): (ln-likelihoods, the leaves y,
    sigma2 and c)."""
    import torch

    t, y, yerr, sigma2, c = args
    leaves = [a.detach().requires_grad_() for a in (y, sigma2, c)]
    with torch.enable_grad():
        ll = fn(t, leaves[0], yerr, leaves[1], leaves[2], **kw)
    return ll, leaves


def _k3_grads(fn, args, kw, cot):
    """The gradients of ``fn`` in y, sigma2 and c for the cotangent
    ``cot`` of its ln-likelihoods."""
    import torch

    ll, leaves = _k3_graph(fn, args, kw)
    return torch.autograd.grad(ll, leaves, cot)


def _k2_against_plain(stream, q, rd, x1, n_steps, with_sens):
    """K2 and its plain version on the same inputs: (max |d impact|,
    [max |d J| for jq, jx0, jrd], kernel ms, plain ms)."""
    import torch

    k = stream.stream_impacts_kernel(q, rd, x1, n_steps, with_sens=with_sens)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    p = stream._plain(q, rd, x1, n_steps, stream.plain._DT, with_sens)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    imp_err = (k[0] - p[0]).abs().max().item()
    jac_err = [(a - b).abs().max().item() for a, b in zip(k[1:], p[1:])]
    ms = _event_ms(lambda: stream.stream_impacts_kernel(
        q, rd, x1, n_steps, with_sens=with_sens), 5)
    return imp_err, jac_err, ms, plain_ms


def _k1_launches(contacts):
    """K1's launches in its three modes."""
    return contacts.LAUNCHES + contacts.F64_LAUNCHES + contacts.MIXED_LAUNCHES


def _k1_launches_of(c):
    """K1's launches in its three modes in the counts ``c``: the path's
    evaluations."""
    return c["k1"] + c["k1_f64"] + c["k1_mixed"]


def _paths_agree(tag, post, p, plain_path, contacts):
    """``post`` at walkers ``p`` through the kernel path and through the
    plain contact path (``plain_path(fn)``): the same -inf pattern and
    phase 3's limits on the model flux (max 2e-4, median 1e-6)."""
    import torch

    with torch.inference_mode():
        lk, fk = post(p), post.model_flux(p)
        before = _k1_launches(contacts)
        lpl, fpl = plain_path(lambda: (post(p), post.model_flux(p)))
    _check(_k1_launches(contacts) == before,
           f"{tag}: the plain path launched K1")
    fin = torch.isfinite(lk)
    _check(bool((fin == torch.isfinite(lpl)).all()),
           f"{tag}: finite/-inf pattern differs between the paths")
    _check(bool(fin.any()), f"{tag}: every walker is -inf")
    dflux = (fk - fpl).abs()[fin]
    f_max, f_med = dflux.max().item(), dflux.median().item()
    d_lp = (lk - lpl).abs()[fin].max().item()
    print(f"{tag}: {int(fin.sum())} of {len(p)} walkers finite in both "
          f"paths; model flux |kernel - plain| max {f_max:.3e} (limit "
          f"2e-4), median {f_med:.3e} (limit 1e-6); ln p |kernel - plain| "
          f"max {d_lp:.3e}")
    _check(f_max <= 2e-4 and f_med <= 1e-6,
           f"{tag}: the kernel path's fluxes disagree with the plain path's")
    return lk, fk


def _k1_at(tag, contacts, wrapper, fn, shape, tight=None):
    """Runs ``fn`` with the K1 wrapper ``wrapper`` recorded, and holds that
    wrapper, on the arguments of its one call, to the plain version of its
    mode: phase 2's limits (flags 1e-4, |dphi| 1e-5 cycles) and, where
    ``tight`` (cycles) is given, at most 1e-4 of the elements eclipsed in
    both with either |dphi| above it (K1_TIGHT: float64 and mixed hold
    their precision).  Returns (the arguments, the kernel's outputs,
    {flag_disagreement, max, median, p99 of |dphi| at the elements
    eclipsed in both, and the share above ``tight``})."""
    import torch

    kernel = getattr(contacts, wrapper)
    with mock.patch.object(contacts, wrapper, wraps=kernel) as rec:
        fn()
    _check(rec.call_count == 1,
           f"{tag}: {wrapper} called {rec.call_count} times, not once")
    args = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                 for a in rec.call_args.args)
    rows, n = args[2].shape
    _check((rows, n) == shape,
           f"{tag}: contact rows {rows} x {n}, expected {shape}")
    k_out = kernel(*args)
    p_out = contacts.element_intervals_plain(*args)
    torch.cuda.synchronize()
    flag_diff = (k_out[2] != p_out[2]).float().mean().item()
    both = k_out[2] & p_out[2]
    d_in, d_out = ((k_out[i] - p_out[i]).abs()[both].double()
                   for i in (0, 1))
    err = torch.cat([d_in, d_out])
    if err.numel() == 0:
        err = err.new_zeros(1)
    sample = err[torch.randperm(err.numel(), device=err.device)[:1 << 24]]
    stats = {"flag_disagreement": flag_diff, "max_abs_err": err.max().item(),
             "median_abs_err": err.median().item(),
             "p99_abs_err": torch.quantile(sample, 0.99).item()}
    line = ""
    if tight is not None:
        above = (torch.maximum(d_in, d_out) > tight).double()
        stats["share_above_tight"] = (above.mean().item() if above.numel()
                                      else 0.0)
        line = (f"; elements above {tight:.0e} cycles: "
                f"{int(above.sum().item())}, a share of "
                f"{stats['share_above_tight']:.3e} (limit 1e-4)")
    print(f"{tag}: {wrapper} on {rows} x {n} contacts ({int(both.sum())} "
          f"eclipsed in both) against its plain version: flag "
          f"disagreement {flag_diff:.3e} (limit 1e-4); |dphi| median "
          f"{stats['median_abs_err']:.3e}, p99 {stats['p99_abs_err']:.3e}, "
          f"max {stats['max_abs_err']:.3e} cycles (limit 1e-5){line}")
    _check(flag_diff <= 1e-4 and stats["max_abs_err"] <= 1e-5,
           f"{tag}: K1 disagrees with its plain version")
    if tight is not None:
        _check(stats["share_above_tight"] <= 1e-4,
               f"{tag}: K1 has lost its mode's precision against its plain "
               f"version")
    return args, k_out, stats


def _k1_backward_against_plain(tag, contacts, b32):
    """K1's backward kernel on ``b32`` (float32: the six inputs, both
    roots, the flags and both cotangents) against its plain version,
    autograd on the edge residual, with phase 7's gates: in float64 within
    1e-9 of max |g|; in float32 each entry within 1e-5 + 2e-3 |g| of the
    plain float32 backward, or no farther from the float64 plain backward
    than 3x the plain float32 backward's largest distance from it (two
    float32 evaluations that round their angles differently, sincospi(2
    phi) in the kernel and sin(2 pi phi) in PyTorch, differ by about as
    much as each errs against float64, most at near-grazing elements where
    1 / dcdphi is large); equal bits from run to run.  Returns (the
    float64 arguments, {output: float64 relative error}, the largest
    float32 |d g|)."""
    import torch

    b64 = [a if a.dtype == torch.bool else a.double() for a in b32]
    before = contacts.BACKWARD_LAUNCHES
    kb64 = contacts.contact_backward_kernel(*b64)
    kb32 = contacts.contact_backward_kernel(*b32)
    kb32_again = contacts.contact_backward_kernel(*b32)
    _check(contacts.BACKWARD_LAUNCHES == before + 3,
           f"{tag}: K1's backward wrapper did not launch its kernel")
    pb64 = contacts._contact_backward_plain(*b64)
    pb32 = contacts._contact_backward_plain(*b32)
    torch.cuda.synchronize()
    names = ("q", "incl", "px", "py", "x1", "pl1")
    rel64 = {}
    for nm, k, pl in zip(names, kb64, pb64):
        scale = pl.abs().max().item()
        rel64[nm] = ((k - pl).abs().max().item() / scale if scale > 0
                     else (k - pl).abs().max().item())
    rows, n = b32[2].shape
    print(f"{tag}: float64 kernel vs autograd on the edge residual, {rows} "
          f"x {n} contacts: max |d g| / max |g| "
          + ", ".join(f"{nm} {v:.2e}" for nm, v in rel64.items())
          + " (limit 1e-9 each)")
    _check(all(v <= 1e-9 for v in rel64.values()),
           f"{tag}: K1's float64 backward kernel disagrees with autograd")
    err, worst32 = 0.0, {}
    for nm, k, pl, ref, again in zip(names, kb32, pb32, pb64, kb32_again):
        _check(bool((torch.isfinite(k) == torch.isfinite(pl)).all()),
               f"{tag}: non-finite pattern of d {nm} differs")
        _check(torch.equal(k, again),
               f"{tag}: d {nm} differs from run to run")
        d = (k.double() - pl.double()).abs()
        lim = 1e-5 + 2e-3 * pl.double().abs()
        e_k, e_p = (k.double() - ref).abs(), (pl.double() - ref).abs()
        fails = (d > lim) & (e_k > 3.0 * e_p.max())
        worst32[nm] = dict(
            ratio=(d / lim).max().item(), outside=int((d > lim).sum()),
            coin=int(((d > lim) & (d > e_p)).sum()), fails=int(fails.sum()),
            rms_k=e_k.square().mean().sqrt().item(),
            rms_p=e_p.square().mean().sqrt().item(),
            max_k=e_k.max().item(), max_p=e_p.max().item())
        err = max(err, d.max().item())
    print(f"{tag}: float32 kernel vs the plain float32 backward, per "
          f"output: max |d g| / (1e-5 + 2e-3 |g|), entries outside it, of "
          f"those farther from plain than plain is from float64, and of "
          f"those farther from float64 than 3x plain's largest distance "
          f"from it (limit 0); rms and max distance from the float64 plain "
          f"backward, kernel / plain float32: "
          + "; ".join(
              f"{nm} {w['ratio']:.3f}, {w['outside']}, {w['coin']}, "
              f"{w['fails']}; rms {w['rms_k']:.3e} / {w['rms_p']:.3e}, max "
              f"{w['max_k']:.3e} / {w['max_p']:.3e}"
              for nm, w in worst32.items())
          + "; equal bits from run to run")
    _check(all(w["fails"] == 0 for w in worst32.values()),
           f"{tag}: K1's float32 backward kernel disagrees with the plain "
           "backward")
    return b64, rel64, err


def _grads_agree(tag, post, post64, p, plain_path, contacts):
    """``post.value_and_grad`` at ``p`` through the K1 path (the kernel
    and its backward kernel) and through the plain contact path (plain
    solver, plain backward), with ``post64``'s float64 gradient as
    referee: phase 7's gate (an entry outside |dg| <= 1e-5 + 2e-3 |g| must
    sit within the float32 plain path's own distance from float64 there:
    the chi^2 gradient is a sum of large cancelling terms, and its float32
    rounding, not K1, sets the small entries)."""
    import torch

    _, g_k = post.value_and_grad(p)
    before = contacts.BACKWARD_LAUNCHES
    _, g_p = plain_path(lambda: post.value_and_grad(p))
    _check(contacts.BACKWARD_LAUNCHES == before,
           f"{tag}: the plain contact path launched K1's backward kernel")
    _, g64 = post64.value_and_grad(p.to(torch.float64))
    g_k64, g_p64 = g_k.to(torch.float64), g_p.to(torch.float64)
    d_kp = (g_k64 - g_p64).abs()
    bound = 1e-5 + 2e-3 * g_p64.abs()
    outside = d_kp > bound
    unexplained = outside & (d_kp > (g_p64 - g64).abs())
    print(f"{tag}: K1 path (the kernel and its backward kernel) vs plain "
          f"contact path (plain solver, plain backward), {g_k.numel()} "
          f"entries: {int(outside.sum())} outside |dg| <= 1e-5 + 2e-3 |g|, "
          f"max |dg| / bound {(d_kp / bound).max().item():.3f}; of those, "
          f"{int(unexplained.sum())} (limit 0) farther apart than the plain "
          f"path is from the float64 gradient")
    _check(int(unexplained.sum()) == 0,
           f"{tag}: gradients of the K1 and plain paths disagree")
    return g_k, g64


def _gradient_kernels_at(tag, post, post64, p, plain_path, contacts,
                         stream):
    """A gradient sampler's chains ``p`` through the kernel path and the
    plain contact path, ln p and the gradient (phase 3's and phase 7's
    limits, ``post64`` the float64 referee), and K1, K1's backward kernel
    and K2 with sensitivities on the inputs one value_and_grad there hands
    them, against their plain versions (phase 2's, 7's and 6's limits)."""
    _paths_agree(tag, post, p, plain_path, contacts)
    _grads_agree(tag, post, post64, p, plain_path, contacts)
    with mock.patch.object(contacts, "contact_backward_kernel",
                           wraps=contacts.contact_backward_kernel) as rb, \
            mock.patch.object(stream, "stream_impacts_kernel",
                              wraps=stream.stream_impacts_kernel) as rs:
        # the demo's one eclipse: a contact row per chain
        _k1_at(tag, contacts, "element_intervals_kernel",
               lambda: post.value_and_grad(p), (len(p), 512))
    _check(rb.call_count == 1 and rs.call_count == 1,
           f"{tag}: K1's backward {rb.call_count}, K2 {rs.call_count} "
           "calls in one value_and_grad")
    _k1_backward_against_plain(
        tag, contacts, [a.detach() for a in rb.call_args.args])
    a2 = rs.call_args.args
    _check(len(a2) == 5 and a2[3] == post.stream_steps
           and a2[4] == stream.plain._DT
           and rs.call_args.kwargs == {"with_sens": True},
           f"{tag}: K2 called with {a2[3:]}, {rs.call_args.kwargs}")
    imp_err, jac, ms, plain_ms = _k2_against_plain(
        stream, *(a.detach() for a in a2[:3]), a2[3], True)
    print(f"{tag}: K2 with sensitivities on {a2[0].shape[0]} walkers x "
          f"{a2[1].shape[1]} radii, {a2[3]} steps, against its plain "
          f"version: max |d impact| {imp_err:.2e}, max |dJ|: jq "
          f"{jac[0]:.2e}, jx0 {jac[1]:.2e}, jrd {jac[2]:.2e} (limit 0: "
          f"bit for bit); kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
    _check(imp_err == 0.0 and all(j == 0.0 for j in jac),
           f"{tag}: K2 with sensitivities differs from its plain "
           "version")


def _stage_seconds(out_dir):
    """{(stage, step): first time} of a fit's metrics.jsonl."""
    t = {}
    for ln in (out_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(ln)
        t.setdefault((rec["stage"], rec["step"]), rec["t"])
    return t


def _fit_phase(dev, smi, contacts, stream, gp, plain_path):
    """Phase 13: the fit command on the demo input, and its resume; then
    K1 and K2 at the fit's own shapes against their plain versions
    (``plain_path(fn)`` runs ``fn`` with the plain contact solver).
    Returns the launch counts of the two runs together."""
    import contextlib
    import io
    import shutil

    import torch

    from lfit_python_tpu_torch import cli
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob
    from lfit_python_tpu_torch.sampling import ensemble
    from lfit_python_tpu_torch.utils.chains import read_chain
    from lfit_python_tpu_torch.utils.config import (build_model_from_config,
                                                    parse_input_dat)

    demo = ROOT / "examples" / "demo_input.dat"
    out_dir = ROOT / "build" / "chip_fit"
    shutil.rmtree(out_dir, ignore_errors=True)
    n_burn, n_prod, n_more, every = 20, 40, 60, 20
    cfg = parse_input_dat(demo)
    n_walk = int(cfg.get("nwalkers"))
    step_launches = {"k1": 0, "k2": 0, "steps": 0}
    real_step = ensemble.ensemble_step

    def counted_step(*a, **kw):
        k1, k2 = contacts.LAUNCHES, stream.LAUNCHES
        out = real_step(*a, **kw)
        step_launches["k1"] += contacts.LAUNCHES - k1
        step_launches["k2"] += stream.LAUNCHES - k2
        step_launches["steps"] += 1
        return out

    def fit(*extra):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with mock.patch.object(ensemble, "ensemble_step", counted_step), \
                contextlib.redirect_stdout(buf):
            rc = cli.main(["fit", str(demo), "--outdir", str(out_dir),
                           "--nburn", str(n_burn), "--checkpoint-every",
                           str(every), "--quiet", *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        total = re.search(r"^total ([\d.]+)s, ~(\d+) ln-prob evals/s$",
                          text, re.M)
        _check(rc == 0, f"fit {' '.join(extra)} exited {rc}: {text[-2000:]}")
        _check(total is not None, "the fit printed no total line")
        return wall, float(total.group(1)), int(total.group(2)), text

    _zero_counts(contacts, stream, gp)
    wall1, tot1, rate1, _ = fit("--nprod", str(n_prod))
    steps_first = step_launches["steps"]
    wall2, tot2, rate2, text2 = fit("--nprod", str(n_more), "--resume")
    c_fit = _counts(contacts, stream, gp)
    _check(f"at step {n_prod}" in text2, "the resume did not start at the "
           "last checkpoint")
    n_steps = step_launches["steps"]
    _check(steps_first == n_burn + n_prod and n_steps == n_burn + n_more,
           f"{steps_first} and {n_steps} ensemble steps, expected "
           f"{n_burn + n_prod} and {n_burn + n_more}")
    _check(step_launches["k1"] == 2 * n_steps
           and step_launches["k2"] == 2 * n_steps,
           f"K1 {step_launches['k1']}, K2 {step_launches['k2']} launches in "
           f"{n_steps} ensemble steps; 2 each per step expected")
    _check(c_fit["k1_bwd"] == c_fit["k1_bwd_kernel"] == c_fit["k2_sens"]
           == c_fit["k3"] == 0, "the fit ran a gradient or the GP")
    ckpts = sorted(int(p.stem.split("_")[1])
                   for p in out_dir.glob("checkpoint_*.npz"))
    _check(ckpts == [20, 40, 60], f"checkpoint steps {ckpts}")
    chain, lp, names = read_chain(out_dir / "chain_prod.txt")
    _check(chain.shape == (n_more, n_walk, len(names)),
           f"chain file of {chain.shape}, expected ({n_more}, {n_walk}, "
           f"{len(names)})")
    _check(bool(np.isfinite(lp).all()), "a non-finite ln_prob in the chain")
    # the last kept row's ln_prob column against a fresh evaluation: the
    # file keeps 11 significant digits (float32 positions exactly), and
    # float32 batches of other sizes round otherwise
    model = build_model_from_config(cfg).compile()
    post = make_ln_prob(model, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        fresh = post(torch.tensor(chain[-1], dtype=torch.float32,
                                  device=dev)).double().cpu().numpy()
    d_lp = np.abs(fresh - lp[-1])
    lim = 1e-5 * np.maximum(1.0, np.abs(lp[-1]))
    times = _stage_seconds(out_dir)
    # production seconds per step between the first run's two segment
    # ends (a segment's 20 steps, its chain rows and its checkpoint)
    s_step = (times["prod", 40] - times["prod", 20]) / (40 - 20)
    print(f"[13 fit] demo_input.dat: {n_walk} walkers, D = {len(names)}, "
          f"float32, full resolution: fit --nburn {n_burn} --nprod {n_prod} "
          f"--checkpoint-every {every} exited 0 in {wall1:.1f} s (its "
          f"total {tot1:.1f} s, ~{rate1} ln-prob evals/s); --resume --nprod "
          f"{n_more} exited 0 in {wall2:.1f} s (total {tot2:.1f} s, ~{rate2} "
          f"evals/s); {smi}")
    print(f"[13 fit] production {s_step:.3f} s per step, "
          f"{n_walk / s_step:.0f} ln-prob evals/s ({smi}); {n_steps} ensemble "
          f"steps launched K1 {step_launches['k1']} and K2 "
          f"{step_launches['k2']} times (2 each per step); the two runs "
          f"in all: K1 {c_fit['k1']}, K2 {c_fit['k2']} (inits included); "
          f"checkpoint steps {ckpts}; chain file {chain.shape[0]} x "
          f"{chain.shape[1]} rows")
    print(f"[13 fit] last kept row's ln_prob vs a fresh evaluation: max "
          f"|d| {d_lp.max():.3e} (limit 1e-5 x max(1, |ln p|), at most "
          f"{lim.max():.3e})")
    _check(bool((d_lp <= lim).all()),
           "the chain's ln_prob column disagrees with the posterior")

    # the same walkers, and their first half (a half-step's 512), through
    # the kernel path and the plain contact path: phase 3's limits
    pos_fit = torch.tensor(chain[-1], dtype=torch.float32, device=dev)
    half = pos_fit[:n_walk // 2]
    out = {len(p): _paths_agree(f"[13 fit] last kept row, {len(p)} walkers",
                                post, p, plain_path, contacts)
           for p in (pos_fit, half)}
    # a walker's float32 ln p and flux are the same bits in batches of
    # 256, 512 and 1024 (the chain is made in half-steps of 512)
    with torch.inference_mode():
        out[256] = post(pos_fit[:256]), post.model_flux(pos_fit[:256])
    same = all(torch.equal(out[n][i][:256], out[256][i])
               for n in (512, n_walk) for i in (0, 1))
    print(f"[13 fit] batch independence: ln p and model flux of the first "
          f"256 walkers evaluated alone, in 512 and in {n_walk}: "
          f"{'equal bits' if same else 'NOT the same bits'}")
    _check(same, "a walker's float32 ln p depends on its batch")
    # K1 and K2 on the inputs the half's evaluation hands them: phase 2's
    # and phase 6's limits
    with mock.patch.object(stream, "stream_impacts_kernel",
                           wraps=stream.stream_impacts_kernel) as r2, \
            torch.inference_mode():
        _k1_at("[13 fit] the half-step's K1", contacts,
               "element_intervals_kernel", lambda: post(half),
               (len(half), 512))
    _check(r2.call_count == 1,
           f"K2 called {r2.call_count} times in one evaluation")
    a2 = r2.call_args.args
    _check(len(a2) == 5 and a2[3] == post.stream_steps
           and a2[4] == stream.plain._DT, f"K2 called with {a2[3:]}")
    imp_err, _, k2_ms, k2_pms = _k2_against_plain(stream, *a2[:4], False)
    print(f"[13 fit] K2 on the half-step's {a2[0].shape[0]} walkers x "
          f"{a2[1].shape[1]} radii, {a2[3]} steps, against its plain "
          f"version: max |d impact| {imp_err:.2e} (limit 0: bit for bit); "
          f"kernel {k2_ms:.4f} ms, plain {k2_pms:.1f} ms")
    _check(imp_err == 0.0, "K2 differs from its plain version at the fit's "
           "shapes")
    _short_curves_batch_check(dev)
    return c_fit


def _k1_modes_phase(dev, smi, model, pos, contacts, stream, gp, plain_path):
    """Phase 14: K1 in float64 and in mixed precision on the contact rows
    one north-star evaluation at ``pos``' walkers hands it, against the
    plain version of each mode; each mode's posterior through K1 and
    through the plain solver; the precise fluxes through the mixed K1
    against golden_v1.npz.  Returns ({mode: results for the kernels
    line}, {path: launch counts})."""
    import torch

    from lfit_python_tpu_torch.models.cv import CVConfig, cv_fluxes
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob

    f32, f64 = torch.float32, torch.float64
    modes = {
        "float64": (make_ln_prob(model, dtype=f64, device=dev), pos.to(f64),
                    "element_intervals_kernel", "k1_f64", "posterior_f64"),
        "mixed_precision": (
            make_ln_prob(model, CVConfig(mixed_precision=True), dtype=f32,
                         device=dev), pos, "element_intervals_mixed_kernel",
            "k1_mixed", "posterior_precise")}
    results, paths = {}, {}
    for mode, (post, p, wrapper, key, path) in modes.items():
        kernel = getattr(contacts, wrapper)
        with torch.inference_mode():
            args, k_out, st = _k1_at(f"[14 {mode}]", contacts, wrapper,
                                     lambda: post(p), (len(p) * 5, 512),
                                     K1_TIGHT[mode])
        rows, n = args[2].shape
        ms = _event_ms(lambda: kernel(*args), 20)
        plain_ms = _event_ms(lambda: contacts.element_intervals_plain(*args),
                             3)
        n_el, n_ecl = rows * n, int(k_out[2].sum().item())
        # per element: px, py in (and their float64 pair in the mixed
        # mode), two phases and a flag out; per row its scalars
        if mode == "float64":
            ops = {"float64": n_el * K1_OPS_ELEMENT
                   + n_ecl * K1_OPS_ECLIPSED}
            nbytes = n_el * (8 + 8 + 8 + 8 + 1) + rows * 6 * 8
        else:
            ops = {"float32": n_el * K1_OPS_ELEMENT
                   + n_ecl * K1_MIXED_OPS_ECLIPSED_F32,
                   "float64": n_ecl * K1_MIXED_OPS_ECLIPSED_F64}
            nbytes = (n_el * (4 + 4 + 8 + 8 + 4 + 4 + 1)
                      + rows * (6 * 4 + 3 * 8))
        # the float32 and float64 units work side by side: the least time
        # is the larger of the two, or of the bytes
        bounds = [_bound(v, nbytes, dt) for dt, v in ops.items()]
        bound, by = max(bounds)
        print(f"[14 {mode}] time per call: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms ({plain_ms / ms:.1f}x); eclipsed share "
              f"{n_ecl / n_el:.6f}; operations "
              + ", ".join(f"{v / 1e9:.3f} G {dt}" for dt, v in ops.items())
              + f", {nbytes / 1e6:.1f} MB; bound {bound * 1e3:.1f} us (set "
              f"by {by}); the kernel at {bound / ms:.1%} of its bound; "
              f"{smi}")
        kname = ("contacts_kernel<f64>" if mode == "float64"
                 else "contacts_mixed_kernel")
        ex = _executed(kname, n_el, n_ecl)
        print(f"[14 {mode}] {_executed_line(kname, ex, ms)}")

        # the posterior through K1 and through the plain solver
        _zero_counts(contacts, stream, gp)
        with torch.inference_mode():
            lk = post(p)
        c = _counts(contacts, stream, gp)
        paths[path] = c
        _check(c[key] == 1 and c["k1"] == 0 and c["k2"] == 1,
               f"{mode}: one evaluation launched {c}")
        # findi and xl1 once, and once more in float64 in the precise mode
        n_core = 2 if mode == "mixed_precision" else 1
        _check(c["k4"] == c["k5"] == n_core
               and c["k6"] == ROCHE_PER_EVAL["k6"],
               f"{mode}: one evaluation launched K4 {c['k4']}, K5 "
               f"{c['k5']}, K6 {c['k6']} (K4 = K5 = {n_core} expected)")
        with torch.inference_mode():
            fk = post.model_flux(p)
            lpl, fpl = plain_path(lambda: (post(p), post.model_flux(p)))
        _check(contacts.LAUNCHES + contacts.F64_LAUNCHES
               + contacts.MIXED_LAUNCHES == 2,
               "the plain path launched K1")
        fin = torch.isfinite(lk)
        _check(bool((fin == torch.isfinite(lpl)).all()),
               f"{mode}: finite/-inf pattern differs between the paths")
        _check(int(fin.sum()) > len(p) // 2, f"{mode}: most walkers -inf")
        dflux = (fk - fpl).abs()[fin]
        f_max, f_med = dflux.max().item(), dflux.median().item()
        turns = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            def timed():
                return _sync_time(lambda: post(p), 2)
            turns[which].append(plain_path(timed) if which == "plain"
                                else timed())
        busy_us, n_kern, wall_us, _ = _device_kernels(lambda: post(p))
        print(f"[14 {mode}] posterior at {len(p)} walkers: "
              f"{int(fin.sum())} finite in both paths; model flux |kernel - "
              f"plain| max {f_max:.3e} (limit 2e-4), median {f_med:.3e} "
              f"(limit 1e-6); one evaluation: K1 ({mode}) {c[key]} launch, "
              f"K2 {c['k2']}; ms per eval in turns (plain, kernel, kernel, "
              f"plain): kernel path "
              f"{', '.join(f'{t:.1f}' for t in turns['kernel'])}, plain "
              f"path {', '.join(f'{t:.1f}' for t in turns['plain'])}; "
              f"device-busy "
              f"share {_busy_line(busy_us, n_kern, wall_us)}; {smi}")
        _check(f_max <= 2e-4 and f_med <= 1e-6,
               f"{mode}: the kernel path's fluxes disagree with the plain "
               f"path's")
        results[mode] = {
            "rows": rows, "elements": n, **st, "ms": ms,
            "plain_ms": plain_ms,
            "ops": ops, "bytes": nbytes, "bound_ms": bound, "bound_by": by,
            "executed": ex,
            "posterior_ms": min(turns["kernel"]),
            "posterior_plain_path_ms": min(turns["plain"]),
            "posterior_flux_max_abs_diff": f_max}

    # the precise float32 fluxes through the mixed K1 against the golden
    # float64 values: the JAX package's gate (tests/test_golden.py)
    golden = np.load(ROOT / "tests" / "golden" / "golden_v1.npz")
    cfg = CVConfig(n_disc_rad=8, n_disc_az=12, n_spot=12, n_donor_lat=8,
                   n_donor_lon=12, mixed_precision=True)
    simple = [0.1, 0.05, 0.08, 0.03, 0.15, 0.04, 0.44, 0.3, 0.01, 0.02,
              160.0, 0.2, 1.5, 0.0]
    phases = torch.linspace(-0.15, 0.15, 61, dtype=f64, device=dev).to(f32)
    worst = {}
    for tag, pars, cplx in (("simple", simple, False),
                            ("complex", simple + [2.0, 1.3, 80.0, 15.0],
                             True)):
        before = contacts.MIXED_LAUNCHES
        with torch.inference_mode():
            out = cv_fluxes(torch.tensor(pars, dtype=f32, device=dev),
                            phases, config=cfg._replace(complex_spot=cplx))
        _check(contacts.MIXED_LAUNCHES == before + 1,
               "the precise cv_fluxes did not launch the mixed K1 once")
        scale = float(np.max(np.abs(golden[f"{tag}_total"])))
        for name in ("total", "ywd", "ydisc", "yspot", "ysec"):
            got = getattr(out, name).double().cpu().numpy()
            worst[f"{tag}.{name}"] = float(
                np.max(np.abs(got - golden[f"{tag}_{name}"])) / scale)
    print(f"[14 golden] float32 cv_fluxes in mixed precision (the mixed K1) "
          f"against golden_v1.npz, relative to the largest total: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + " (limit 1e-6 each)")
    _check(max(worst.values()) < 1e-6,
           "the precise float32 fluxes miss the 1e-6 golden gate")
    results["mixed_precision"]["golden_max_rel_err"] = max(worst.values())
    return results, paths


def _fit_branches_phase(dev, smi, contacts, stream, gp, plain_path):
    """Phase 15: the fit command's tempered, HMC, NUTS, --precise and --x64
    branches on copies of the demo input (full resolution), through
    cli.main, each with its launch counts and its chain's last row against
    a fresh evaluation; then that row through the kernel path and the
    plain contact path (``plain_path(fn)``), and the kernels of the branch
    on the inputs one of its evaluations hands them against their plain
    versions.  Returns {path: launch counts}."""
    import contextlib
    import io
    import shutil

    import torch

    from lfit_python_tpu_torch import cli
    from lfit_python_tpu_torch.models.cv import CVConfig
    from lfit_python_tpu_torch.models.likelihood import (Posterior,
                                                         make_ln_prob)
    from lfit_python_tpu_torch.sampling import ensemble, pt
    from lfit_python_tpu_torch.utils.chains import read_chain
    from lfit_python_tpu_torch.utils.config import (build_model_from_config,
                                                    parse_input_dat)

    base = ROOT / "build" / "chip_fit_branches"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    demo = (ROOT / "examples" / "demo_input.dat").read_text()
    shutil.copy(ROOT / "examples" / "demo_ecl0.txt", base)
    # the demo light curve with exposure widths (the median sample
    # spacing, as a .calib file gets them): the gradient samplers'
    # contact phases then carry gradients, through K1's backward
    lc = np.loadtxt(ROOT / "examples" / "demo_ecl0.txt")
    width = np.median(np.abs(np.diff(lc[:, 0])))
    np.savetxt(base / "demo_ecl0_widths.txt",
               np.column_stack([lc, np.full(len(lc), width)]), fmt="%.17e")

    def write_input(name, walkers, extra="", data=None):
        text = demo.replace("nwalkers = 1024", f"nwalkers = {walkers}")
        if data is not None:
            text = text.replace("file_0 = demo_ecl0.txt", f"file_0 = {data}")
        path = base / f"{name}.dat"
        path.write_text(text + extra)
        return path

    step_counts = {"k1": 0, "k1_f64": 0, "k1_mixed": 0, "k2": 0, "steps": 0,
                   "grad_evals": 0}
    real = {"ens": ensemble.ensemble_step, "pt": pt.pt_step,
            "vg": Posterior.value_and_grad}

    def counting(fn, steps=True):
        def wrapped(*a, **kw):
            before = _counts(contacts, stream, gp)
            out = fn(*a, **kw)
            after = _counts(contacts, stream, gp)
            for k in ("k1", "k1_f64", "k1_mixed", "k2"):
                step_counts[k] += after[k] - before[k]
            step_counts["steps" if steps else "grad_evals"] += 1
            return out
        return wrapped

    def fit(inp, out_dir, *extra):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with mock.patch.object(ensemble, "ensemble_step",
                               counting(real["ens"])), \
                mock.patch.object(pt, "pt_step", counting(real["pt"])), \
                mock.patch.object(Posterior, "value_and_grad",
                                  counting(real["vg"], steps=False)), \
                contextlib.redirect_stdout(buf):
            rc = cli.main(["fit", str(inp), "--outdir", str(out_dir),
                           "--quiet", *extra])
        torch.cuda.synchronize()
        text = buf.getvalue()
        _check(rc == 0, f"fit {' '.join(extra)} exited {rc}: {text[-2000:]}")
        return time.perf_counter() - t0, text

    def prod_seconds_per_step(out_dir, a, b):
        t = _stage_seconds(out_dir)
        return (t["prod", b] - t["prod", a]) / (b - a)

    def last_row_check(tag, inp, out_dir, config, dtype, rows):
        chain, lp, names = read_chain(out_dir / "chain_prod.txt")
        _check(chain.shape == (rows,) + chain.shape[1:] and bool(
            np.isfinite(lp).all()), f"{tag}: chain file {chain.shape}, "
            "or a non-finite ln_prob")
        model = build_model_from_config(parse_input_dat(inp)).compile()
        post = make_ln_prob(model, config, dtype=dtype, device=dev)
        with torch.inference_mode():
            fresh = post(torch.tensor(chain[-1], dtype=dtype, device=dev))
        fresh = fresh.double().cpu().numpy()
        d = np.abs(fresh - lp[-1])
        lim = 1e-5 * np.maximum(1.0, np.abs(lp[-1]))
        _check(bool((d <= lim).all()), f"{tag}: the chain's ln_prob column "
               "disagrees with the posterior")
        return chain.shape, d.max(), post, torch.tensor(
            chain[-1], dtype=dtype, device=dev)

    paths, full = {}, CVConfig()

    # ---- tempered: 4 rungs x 256 walkers, resumed
    inp = write_input("pt", 256, "usePT = 1\nntemps = 4\n")
    out_dir = base / "pt"
    _zero_counts(contacts, stream, gp)
    for k in step_counts:
        step_counts[k] = 0
    wall1, _ = fit(inp, out_dir, "--nburn", "4", "--nprod", "8",
                   "--checkpoint-every", "4")
    s_step = prod_seconds_per_step(out_dir, 4, 8)
    ev = json.loads((out_dir / "evidence.json").read_text())
    wall2, text = fit(inp, out_dir, "--nburn", "4", "--nprod", "12",
                      "--checkpoint-every", "4", "--resume")
    paths["fit_pt"] = c = _counts(contacts, stream, gp)
    n = step_counts["steps"]
    _check("resumed from" in text and n == 4 + 8 + 4,
           f"PT: {n} steps, or no resume")
    _check(step_counts["k1"] == step_counts["k2"] == 2 * n,
           f"PT: K1 {step_counts['k1']}, K2 {step_counts['k2']} in {n} steps")
    _check(np.isfinite(ev["ln_evidence"]) and len(ev["betas"]) == 4,
           f"evidence.json: {ev}")
    shape, d, post, last = last_row_check("PT", inp, out_dir, full,
                                          torch.float32, 12)
    print(f"[15 fit pt] usePT = 1, 4 rungs x 256 walkers: --nburn 4 --nprod 8 "
          f"--checkpoint-every 4 exited 0 in {wall1:.1f} s, resumed to 12 "
          f"in {wall2:.1f} s; {s_step:.3f} s per production step "
          f"({4 * 256 / s_step:.0f} tempered proposals/s); {n} PT steps "
          f"launched K1 {step_counts['k1']}, K2 {step_counts['k2']} times (2 "
          f"each per step); ln evidence {ev['ln_evidence']:.3f} +- "
          f"{ev['dln_evidence']:.3f}; cold chain {shape}, last row vs a "
          f"fresh evaluation max |d| {d:.3e}; {smi}")
    _paths_agree("[15 fit pt] the cold chain's last row", post, last,
                 plain_path, contacts)

    # ---- HMC and NUTS: 256 chains on the light curve with widths
    for kind, extra, prod in (
            ("hmc", ["--nburn", "4", "--nprod", "4", "--checkpoint-every",
                     "2"], (2, 4)),
            ("nuts", ["--nuts-max-depth", "4", "--nburn", "2", "--nprod",
                      "2", "--checkpoint-every", "1"], (1, 2))):
        inp = write_input(kind, 256, data="demo_ecl0_widths.txt")
        out_dir = base / kind
        _zero_counts(contacts, stream, gp)
        for k in step_counts:
            step_counts[k] = 0
        wall1, text = fit(inp, out_dir, "--sampler", kind, *extra)
        s_step = prod_seconds_per_step(out_dir, *prod)
        n_rows = prod[1]
        wall2 = None
        if kind == "hmc":
            wall2, text2 = fit(inp, out_dir, "--sampler", kind, *extra[:3],
                               "6", *extra[4:], "--resume")
            _check("resumed from" in text2, "HMC: no resume")
            n_rows = 6
        paths[f"fit_{kind}"] = c = _counts(contacts, stream, gp)
        n_vg = step_counts["grad_evals"]
        _check(n_vg > 0 and c["k1"] == c["k1_bwd"] == c["k1_bwd_kernel"]
               == c["k2_sens"] == n_vg,
               f"{kind}: {n_vg} gradient evaluations launched {c}")
        shape, d, post, last = last_row_check(kind, inp, out_dir, full,
                                              torch.float32, n_rows)
        line = re.search(r"^(HMC|NUTS) total.*$", text, re.M).group(0)
        rate = (f"{256 * 16 / s_step:.0f} gradient evals/s" if kind == "hmc"
                else f"{256 / s_step:.2f} trajectories/s")
        print(f"[15 fit {kind}] --sampler {kind} {' '.join(extra)}, 256 "
              f"chains, widths {width:.6f} cycles: exited 0 in {wall1:.1f} s"
              + ("" if wall2 is None else f", resumed to 6 in {wall2:.1f} s")
              + f"; {s_step:.2f} s per production step ({rate}); the fit's "
              f"own line: '{line}'; {n_vg} gradient evaluations, each one "
              f"K1, one K1 backward kernel, one K2 with sensitivities "
              f"({c['k1_bwd_kernel']}, {c['k2_sens']}); chain {shape}, last "
              f"row vs a fresh evaluation max |d| {d:.3e}; {smi}")
        model = build_model_from_config(parse_input_dat(inp)).compile()
        _gradient_kernels_at(
            f"[15 fit {kind}] last row", post,
            make_ln_prob(model, full, dtype=torch.float64, device=dev), last,
            plain_path, contacts, stream)

    # ---- --precise and --x64 at the demo's 1024 walkers
    for tag, flag, key, cfg, dtype in (
            ("precise", "--precise", "k1_mixed",
             CVConfig(mixed_precision=True), torch.float32),
            ("x64", "--x64", "k1_f64", full, torch.float64)):
        inp = write_input(tag, 1024)
        out_dir = base / tag
        _zero_counts(contacts, stream, gp)
        for k in step_counts:
            step_counts[k] = 0
        wall, text = fit(inp, out_dir, flag, "--nburn", "10", "--nprod", "10",
                         "--checkpoint-every", "5")
        paths[f"fit_{tag}"] = c = _counts(contacts, stream, gp)
        n = step_counts["steps"]
        _check(n == 20 and step_counts[key] == 2 * n
               and step_counts["k2"] == 2 * n and c["k1"] == 0,
               f"{tag}: {n} steps launched {step_counts} ({c})")
        s_step = prod_seconds_per_step(out_dir, 5, 10)
        shape, d, post, last = last_row_check(tag, inp, out_dir, cfg, dtype,
                                              10)
        print(f"[15 fit {tag}] {flag}, 1024 walkers, --nburn 10 --nprod 10 "
              f"exited 0 in {wall:.1f} s; {s_step:.3f} s per production "
              f"step ({1024 / s_step:.0f} ln-prob evals/s); {n} ensemble "
              f"steps launched K1 ({key[3:]}) {step_counts[key]} and K2 "
              f"{step_counts['k2']} times (2 each per step), K1 float32 "
              f"{c['k1']}; chain {shape}, last row vs a fresh evaluation "
              f"max |d| {d:.3e}; {smi}")
        # the last row's walkers, and their first half (a half-step's
        # 512), through both paths; K1 of this mode on the half's rows
        half = last[:len(last) // 2]
        for p in (last, half):
            _paths_agree(f"[15 fit {tag}] last row, {len(p)} walkers", post,
                         p, plain_path, contacts)
        with torch.inference_mode():
            _k1_at(f"[15 fit {tag}] the half-step's K1", contacts,
                   "element_intervals_mixed_kernel" if key == "k1_mixed"
                   else "element_intervals_kernel", lambda: post(half),
                   (len(half), 512), K1_TIGHT["mixed_precision"
                                              if key == "k1_mixed"
                                              else "float64"])
    return paths


def _short_curves_batch_check(dev):
    """Phase 13's batch independence at fewer than 16 points a light
    curve: a walker's float32 ln p and flux the same bits alone, in 2, 25
    and 37, with the flux sweep's chunks at their default size and cut
    so that batches end in partial chunks (default widths)."""
    import torch

    from lfit_python_tpu_torch.examples import build_model
    from lfit_python_tpu_torch.models import components as comp
    from lfit_python_tpu_torch.models.cv import CVConfig
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob

    for n_points in (5, 11):
        model = build_model(n_eclipses=2, complex_spot=[False, True],
                            n_points=n_points, bands=("g",)).compile()
        post = make_ln_prob(model, CVConfig(), dtype=torch.float32,
                            device=dev)
        pos = _walkers(model.var_start(), 37, 6, torch.float32, dev)
        same = True
        for chunk in (comp._CHUNK_ELEMS, 1 << 14):
            with mock.patch.object(comp, "_CHUNK_ELEMS", chunk), \
                    torch.inference_mode():
                ref = post(pos), post.model_flux(pos)
                _check(bool(torch.isfinite(ref[0]).all()),
                       f"{n_points} points: a non-finite ln p")
                for n in (1, 2, 25):
                    got = post(pos[:n]), post.model_flux(pos[:n])
                    same &= all(torch.equal(g, r[:n])
                                for g, r in zip(got, ref))
        print(f"[13 fit] batch independence at {n_points} points (2 "
              f"eclipses, default widths): ln p and flux of walkers alone, "
              f"in 2 and 25 against the batch of 37, chunks of 2^25 and "
              f"2^14 elements: {'equal bits' if same else 'NOT equal'}")
        _check(same, f"a walker's float32 ln p depends on its batch at "
               f"{n_points} points")


def _torchrun_fit(n_ranks, argv, timeout=600):
    """The command line under ``torchrun --standalone`` at ``n_ranks``
    ranks, in a session of its own (killed whole on a timeout): (exit
    code, output, wall seconds)."""
    import os
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n_ranks}", "-m", "lfit_python_tpu_torch.cli",
           *argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(f"chip_smoke: torchrun fit timed out: "
                           f"{out[-2000:]}") from None
    return proc.returncode, out, time.perf_counter() - t0


def _in_turns(fns):
    """{name: [seconds, seconds]} of one call of each of ``fns`` in the
    order a, b, b, a (the card synchronized around each call)."""
    import torch

    out = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[k]()
        torch.cuda.synchronize()
        out[k].append(time.perf_counter() - t0)
    return out


def _turns_line(turns):
    (a, ta), (b, tb) = turns.items()
    return (f"{b} {min(tb):.4f} s ({[round(v, 4) for v in tb]}) against "
            f"{a} {min(ta):.4f} s ({[round(v, 4) for v in ta]}), least of "
            f"2 in turns, {min(tb) / min(ta) - 1:+.1%}")


def _shard_steps_in_turns(smi, mesh, inputs):
    """An ensemble step at 1024 walkers of the demo posterior and an
    hmc_step at 256 chains of the widths posterior, each unsharded and
    sharded over ``mesh``, from one state and one generator state, in
    turns; the sharded steps' outputs against the unsharded ones, bit for
    bit."""
    import torch

    from lfit_python_tpu_torch.models.likelihood import make_ln_prob
    from lfit_python_tpu_torch.parallel import mesh as pm
    from lfit_python_tpu_torch.sampling import ensemble, hmc
    from lfit_python_tpu_torch.utils.config import (build_model_from_config,
                                                    parse_input_dat)

    posts = {}
    for key, inp in inputs.items():
        model = build_model_from_config(parse_input_dat(inp)).compile()
        start = torch.as_tensor(model.var_start(), dtype=torch.float32,
                                device=mesh.device)
        posts[key] = (make_ln_prob(model, dtype=torch.float32,
                                   device=mesh.device),
                      start, 1e-3 * start.abs().clamp(min=1e-2))
    gen = torch.Generator(device=mesh.device).manual_seed(11)
    post, start, ball = posts["ens"]
    ens = ensemble.init_walkers(gen, start, ball, post, N_WALKERS)
    post_w, start_w, ball_w = posts["hmc"]
    hs = hmc.init_hmc(gen, start_w, ball_w, post_w, N_CHAINS)
    g0 = gen.get_state()
    # 4 leapfrog steps: the fit's step has 16, each the same gradient
    # evaluation
    steps = {
        "ensemble": {
            "unsharded": lambda: ensemble.ensemble_step(ens, post, gen),
            "sharded": lambda: ensemble.ensemble_step(
                ens, pm.sharded_batch_ln_prob(post, mesh), gen)},
        "hmc_step (4 leapfrog)": {
            "unsharded": lambda: hmc.hmc_step(hs, post_w, gen, 4),
            "sharded": lambda: hmc.hmc_step(
                hs, post_w, gen, 4, hmc.batch_trajectories(
                    post_w, 4, vg_fn=pm.sharded_value_and_grad(post_w,
                                                               mesh)))}}
    for tag, fns in steps.items():
        out = {}

        def run(k, fn=None):
            def go():
                gen.set_state(g0)
                out[k] = fn()
            return go

        turns = _in_turns({k: run(k, fn) for k, fn in fns.items()})
        state = {k: o[0] for k, o in out.items()}
        same = all(torch.equal(a, b) for a, b in zip(
            state["unsharded"][:2], state["sharded"][:2]))
        print(f"[16 shard] {tag}, one-rank NCCL group: "
              f"{_turns_line(turns)}; the sharded step's state "
              f"{'the same bits' if same else 'DIFFERS'}; {smi}")
        _check(same, f"{tag}: the sharded step differs from the unsharded")


def _shard_phase(dev, smi, contacts, stream, gp):
    """Phase 16: fit --shard in process on a one-rank NCCL group (the
    ensemble on the demo input; HMC on phase 15's input, resumed from its
    second production step) and under torchrun, each chain file against
    the unsharded fits of phases 13 and 15; then an ensemble step and an
    hmc_step unsharded and sharded in turns.  Returns {path: launch
    counts}."""
    import contextlib
    import io
    import shutil

    import torch
    import torch.distributed as dist

    from lfit_python_tpu_torch import cli
    from lfit_python_tpu_torch.parallel.mesh import walker_mesh

    base = ROOT / "build" / "chip_fit_shard"
    shutil.rmtree(base, ignore_errors=True)
    demo = ROOT / "examples" / "demo_input.dat"
    hmc_inp = ROOT / "build" / "chip_fit_branches" / "hmc.dat"
    unsharded = {"ens": ROOT / "build" / "chip_fit",
                 "hmc": ROOT / "build" / "chip_fit_branches" / "hmc"}
    ens_args = ["--nburn", "20", "--nprod", "10", "--checkpoint-every",
                "10", "--quiet", "--shard"]
    hmc_args = ["--sampler", "hmc", "--nburn", "4", "--nprod", "4",
                "--checkpoint-every", "2", "--quiet", "--shard", "--resume"]
    # the sharded HMC fit resumes phase 15's at its second production
    # step (its warm-up reused): that checkpoint and the chain's rows to it
    hmc_dir = base / "hmc"
    hmc_dir.mkdir(parents=True)
    shutil.copy(unsharded["hmc"] / "checkpoint_0000002.npz", hmc_dir)
    lines = (unsharded["hmc"] / "chain_prod.txt").read_text().splitlines(
        keepends=True)
    (hmc_dir / "chain_prod.txt").write_text("".join(lines[:1 + 2 * N_CHAINS]))

    def same_segment(tag, out_dir, ref_dir, n_rows, n_walk):
        got = (out_dir / "chain_prod.txt").read_text()
        ref = (ref_dir / "chain_prod.txt").read_text().splitlines(
            keepends=True)
        same = got == "".join(ref[:1 + n_rows * n_walk])
        print(f"[16 shard] {tag}: chain file {len(got)} bytes, {n_rows} x "
              f"{n_walk} rows, against the unsharded fit's first {n_rows} "
              f"rows: {'the same bytes' if same else 'DIFFER'}")
        _check(same, f"{tag}: the sharded chain differs from the unsharded")

    created = not dist.is_initialized()
    mesh = walker_mesh("cuda")
    _check(dist.get_backend() == "nccl" and mesh.world_size == 1,
           f"a one-rank NCCL group expected, got {dist.get_backend()} x "
           f"{mesh.world_size}")
    paths = {}
    try:
        for tag, inp, args, key in (
                ("fit_shard", demo, ens_args, "ens"),
                ("fit_hmc_shard", hmc_inp, hmc_args, "hmc")):
            out_dir = base / key
            buf = io.StringIO()
            _zero_counts(contacts, stream, gp)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["fit", str(inp), "--outdir", str(out_dir),
                               *args])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            paths[tag] = c = _counts(contacts, stream, gp)
            text = buf.getvalue()
            _check(rc == 0, f"{tag} exited {rc}: {text[-2000:]}")
            _check("--shard: 1 rank(s), nccl" in text, f"{tag}: {text[:300]}")
            if key == "ens":
                n_walk, n_rows = N_WALKERS, 10
                t = _stage_seconds(out_dir)
                what = (f"{(t['prod', 10] - t['burn', 20]) / 10:.3f} s per "
                        f"production step")
                _check(c["k1"] == c["k2"] >= 2 * 30,
                       f"{tag}: 30 ensemble steps launched {c}")
            else:
                n_walk, n_rows = N_CHAINS, 4
                what = "resumed at production step 2 to 4"
                _check("resumed from" in text, f"{tag}: no resume")
                _check(c["k1"] == c["k1_bwd_kernel"] == c["k2_sens"]
                       == c["k2"] == 2 * N_LEAPFROG,
                       f"{tag}: not one K1, K1 backward kernel and K2 with "
                       f"sensitivities per gradient evaluation: {c}")
            print(f"[16 shard] {tag}: cli.main fit {' '.join(args)} on a "
                  f"one-rank NCCL group exited 0 in {wall:.1f} s; {what}; "
                  f"launches: K1 {c['k1']}, K2 {c['k2']}, K1 backward "
                  f"kernel {c['k1_bwd_kernel']}, K2 with sensitivities "
                  f"{c['k2_sens']}; {smi}")
            same_segment(tag, out_dir, unsharded[key], n_rows, n_walk)

        _shard_steps_in_turns(smi, mesh, {"ens": demo, "hmc": hmc_inp})
        # what sharding adds to a half-step at world size 1: one
        # all-gather of its 512 ln p
        part = torch.randn(N_WALKERS // 2, device=dev)
        blocks = [torch.empty_like(part)]
        ms = _event_ms(lambda: dist.all_gather(blocks, part), 50)
        print(f"[16 shard] one all-gather of a half-step's {N_WALKERS // 2} "
              f"float32 ln p on the one-rank NCCL group: {ms * 1e3:.1f} us "
              f"(event-timed, 50 calls; {smi})")
    finally:
        if created:
            dist.destroy_process_group()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    n_ranks = torch.cuda.device_count()
    out_dir = base / "torchrun"
    rc, out, wall = _torchrun_fit(
        n_ranks, ["fit", str(demo), "--outdir", str(out_dir), *ens_args])
    _check(rc == 0, f"torchrun fit exited {rc}: {out[-3000:]}")
    _check(f"--shard: {n_ranks} rank(s), nccl, ranks started by torchrun"
           in out, f"torchrun fit: {out[:500]}")
    t = _stage_seconds(out_dir)
    print(f"[16 shard] torchrun --nproc-per-node {n_ranks} -m "
          f"lfit_python_tpu_torch.cli fit {' '.join(ens_args)} exited 0 in "
          f"{wall:.1f} s (its processes' start and kernel loads included); "
          f"{(t['prod', 10] - t['burn', 20]) / 10:.3f} s per production "
          f"step; {smi}")
    same_segment("torchrun fit_shard", out_dir, unsharded["ens"], 10,
                 N_WALKERS)
    return paths


def _donor_quad_phase(dev, smi, model, pos, contacts, stream, gp):
    """Phase 17: the north-star posterior at ``pos``' walkers with exact
    donor sums and with 256 quadrature nodes.  Returns {path: launch
    counts of one evaluation with the quadrature}."""
    import torch

    from lfit_python_tpu_torch.models.cv import CVConfig
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob

    posts = {n: make_ln_prob(model, CVConfig(n_donor_quad=n),
                             dtype=torch.float32, device=dev)
             for n in (0, 256)}
    out, counts = {}, {}
    with torch.inference_mode():
        for n, post in posts.items():
            _zero_counts(contacts, stream, gp)
            lp = post(pos)
            counts[n] = _counts(contacts, stream, gp)
            out[n] = lp, post.model_flux(pos)
        ms = {n: [] for n in posts}
        for n in (0, 256, 256, 0):
            ms[n].append(_sync_time(lambda: posts[n](pos), 2))
    f0, f256 = (out[n][1].double() for n in (0, 256))
    rel = ((f256 - f0).abs().amax() / f0.abs().amax()).item()
    same_inf = torch.equal(torch.isfinite(out[0][0]),
                           torch.isfinite(out[256][0]))
    print(f"[17 donor quad] north star, {len(pos)} walkers, float32: exact "
          f"donor sums {min(ms[0]):.1f} ms per evaluation "
          f"({[round(v, 1) for v in ms[0]]}), 256 nodes {min(ms[256]):.1f} "
          f"ms ({[round(v, 1) for v in ms[256]]}), in turns; largest "
          f"total-flux difference {rel:.3e} of the largest total (limit "
          f"1e-6); the same -inf pattern: {same_inf}; launches per "
          f"evaluation: K1 {counts[0]['k1']} / {counts[256]['k1']}, K2 "
          f"{counts[0]['k2']} / {counts[256]['k2']}; {smi}")
    _check(rel <= 1e-6, "the donor quadrature moves the flux by more than "
           "1e-6 of the largest total")
    _check(same_inf, "the donor quadrature changed the -inf pattern")
    _check(all(c["k1"] == c["k2"] == 1 for c in counts.values()),
           f"not one K1 and one K2 per evaluation: {counts}")
    _check(counts[0]["k7"] == counts[256]["k7"] == 2
           and counts[0]["k8"] == 2 and counts[256]["k8"] == 1,
           f"K7 twice and K8 twice (once with the quadrature: its nodes) "
           f"per evaluation: {counts}")
    return {"posterior_quad": counts[256]}


# The host surface's fit, run in a fresh process (its profiler window is
# the process's first, so the trace keeps every kernel record): the trace
# is taken by the CLI's own --profile, and the launch counters are read
# where its window opens and closes, and at the end.
_HOST_FIT = r"""
import contextlib, json, sys
from lfit_python_tpu_torch import cli
from lfit_python_tpu_torch.ops import contacts, roche, stream, sweeps, wd_donor
from lfit_python_tpu_torch.utils import tracing

real, span = tracing.trace_to, {}

@contextlib.contextmanager
def counted(logdir, steps=None):
    k1, k2 = contacts.LAUNCHES, stream.LAUNCHES
    with real(logdir, steps) as trace:
        close = trace.close

        def counted_close():
            if not trace.closed:
                span.update(k1=contacts.LAUNCHES - k1,
                            k2=stream.LAUNCHES - k2, path=str(trace.path),
                            steps=trace.done)
            close()

        trace.close = counted_close
        yield trace

tracing.trace_to = counted
rc = cli.main(sys.argv[1:])
print("HOST_FIT " + json.dumps(dict(
    rc=rc, k1_total=contacts.LAUNCHES, k2_total=stream.LAUNCHES,
    k4_total=roche.FINDI_LAUNCHES, k5_total=roche.XL1_LAUNCHES,
    k6_total=roche.LOBE_LAUNCHES, k7_total=sweeps.CURVE_LAUNCHES,
    k8_total=sweeps.DONOR_LAUNCHES, k9_total=wd_donor.DONOR_GRID_LAUNCHES,
    k10_total=wd_donor.WD_LAUNCHES, **span)))
sys.exit(rc)
"""


def _run_host_fit(argv, timeout=600):
    """``cli.main(argv)`` in a fresh process (``_HOST_FIT``): (exit code,
    output, wall seconds, its HOST_FIT record)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _HOST_FIT, *argv],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    rec = re.search(r"^HOST_FIT (\{.*\})$", proc.stdout, re.M)
    return proc.returncode, out, wall, (json.loads(rec.group(1)) if rec
                                        else {})


def _trace_kernel_counts(path, names):
    """{name: number of device kernel events in the Chrome trace at
    ``path`` whose name holds ``name`` as a word}."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    pats = {n: re.compile(rf"\b{n}\b") for n in names}
    out = dict.fromkeys(names, 0)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for n, pat in pats.items():
            if pat.search(e.get("name", "")):
                out[n] += 1
    return out


def _host_surface_phase(dev, smi):
    """Phase 18: the demo fit with --profile and both notification
    channels in a fresh process (and once unprofiled, for the step time
    beside it); its trace, notifications, chains.npz and plot line; then
    the native chain writer against the numpy one.  Returns the profiled
    fit's launch counts."""
    import shutil

    from lfit_python_tpu_torch import cli
    from lfit_python_tpu_torch.utils.chains import ChainWriter, read_chain

    demo = ROOT / "examples" / "demo_input.dat"
    base = ROOT / "build" / "chip_host"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    note, subject = base / "notify.jsonl", base / "subject.txt"
    n_steps = 6             # more than the PROFILE_STEPS that are traced
    common = ["fit", str(demo), "--nburn", "3", "--nprod", "3", "--quiet"]
    rc0, out0, wall0, _ = _run_host_fit(
        common + ["--outdir", str(base / "plain")])
    _check(rc0 == 0, f"the unprofiled host fit exited {rc0}: {out0[-2000:]}")
    out_dir = base / "out"
    rc, out, wall, rec = _run_host_fit(common + [
        "--outdir", str(out_dir), "--profile", str(base / "trace"),
        "--notify-file", str(note), "--notify-cmd", f"cat > {subject}"])
    _check(rc == 0 and rec.get("rc") == 0,
           f"the profiled host fit exited {rc}: {out[-3000:]}")
    totals = {}
    for tag, text in (("unprofiled", out0), ("profiled", out)):
        m = re.search(r"^total ([\d.]+)s, ~(\d+) ln-prob evals/s$", text,
                      re.M)
        _check(m is not None, f"the {tag} fit printed no total line")
        totals[tag] = float(m.group(1))
    trace = Path(rec.get("path", ""))
    _check(trace.is_file(), f"no trace file at {trace}")
    t0 = time.perf_counter()
    in_trace = _trace_kernel_counts(trace, ("contacts_kernel",
                                            "stream_kernel"))
    parse_s = time.perf_counter() - t0
    t_plain, t_prof = totals["unprofiled"], totals["profiled"]
    print(f"[18 host] fit demo_input.dat --nburn 3 --nprod 3 (1024 walkers, "
          f"float32): unprofiled {wall0:.1f} s wall (its total {t_plain:.2f} "
          f"s, {t_plain / n_steps:.3f} s a step), with --profile "
          f"{wall:.1f} s wall (total {t_prof:.2f} s, {t_prof / n_steps:.3f} "
          f"s a step, {rec['steps']} of its {n_steps} steps traced and the "
          f"trace written within it); each in a fresh process; {smi}")
    size = trace.stat().st_size / 2**20
    print(f"[18 host] trace {trace.name}: {size:.1f} MiB "
          f"({size / rec['steps']:.1f} MiB a step), parsed in "
          f"{parse_s:.1f} s; contacts_kernel {in_trace['contacts_kernel']}, "
          f"stream_kernel {in_trace['stream_kernel']} device events; the "
          f"wrappers counted K1 {rec['k1']}, K2 {rec['k2']} launches in the "
          f"traced window (K1 {rec['k1_total']}, K2 {rec['k2_total']} in the "
          f"process)")
    _check(rec["steps"] == cli.PROFILE_STEPS < n_steps,
           f"the trace closed after {rec['steps']} steps")
    _check(in_trace["contacts_kernel"] == rec["k1"] > 0
           and in_trace["stream_kernel"] == rec["k2"] > 0,
           "the trace's K1 / K2 events are not the fit's launches")
    lines = note.read_text().splitlines()
    _check(len(lines) == 1 and json.loads(lines[0])["subject"].startswith(
        "lfit_python_tpu_torch fit finished"), f"notify file: {lines}")
    got = subject.read_text()
    _check(got.startswith("lfit_python_tpu_torch fit finished"),
           f"notify command got {got!r}")
    chain, lp, names = read_chain(out_dir / "chain_prod.txt")
    with np.load(out_dir / "chains.npz") as z:
        arrays = {k: z[k] for k in z.files}
    _check(set(arrays) == {*names, "ln_prob"}, f"chains.npz {sorted(arrays)}")
    rel = max(np.abs(arrays[n] - chain[:, :, i].T).max()
              / np.abs(chain[:, :, i]).max() for i, n in enumerate(names))
    rel = max(rel, np.abs(arrays["ln_prob"] - lp.T).max()
              / np.abs(lp).max())
    plots = sorted(p.name for p in out_dir.glob("*.png"))
    no_mpl = "plots: not made (matplotlib is not installed)" in out
    print(f"[18 host] notifications: 1 JSON line in {note.name}, the "
          f"subject through the command; chains.npz {chain.shape[1]} "
          f"walkers x {chain.shape[0]} draws x {len(names)} parameters "
          f"against the chain file: max relative {rel:.2e} (limit 1e-10); "
          + ("plots: matplotlib is not installed here" if no_mpl
             else f"plots {plots}"))
    _check(rel <= 1e-10, "chains.npz disagrees with the chain file")
    _check(no_mpl or {"corner.png", "eclipse_0.png"} <= set(plots),
           "neither the plots nor the matplotlib line")

    # the native chain writer against numpy's on one production segment
    from lfit_python_tpu_torch import native as native_io

    t0 = time.perf_counter()
    native_io.load()
    build_s = time.perf_counter() - t0
    times = {}
    for native in (False, True):
        path = base / f"segment_{'native' if native else 'numpy'}.txt"
        with ChainWriter(path, names, use_native=native) as w:
            t0 = time.perf_counter()
            w.append(chain, lp)
            times[native] = time.perf_counter() - t0
    same = ((base / "segment_native.txt").read_bytes()
            == (base / "segment_numpy.txt").read_bytes())
    n_rows = chain.shape[0] * chain.shape[1]
    print(f"[18 host] one production segment ({n_rows} rows x "
          f"{len(names) + 2} columns): numpy "
          f"{times[False] * 1e3:.1f} ms, native {times[True] * 1e3:.1f} ms "
          f"(its g++ build and load before, {build_s:.2f} s); the same "
          f"bytes: {same}")
    _check(same, "the native chain writer wrote other bytes")
    counts = dict.fromkeys(("k1", "k1_f64", "k1_mixed", "k1_bwd",
                            "k1_bwd_kernel", "k2", "k2_sens", "k3",
                            "k3_bwd", "k7_bwd", "k8_bwd"), 0)
    counts.update({k: rec[f"{k}_total"]
                   for k in ("k1", "k2", "k4", "k5", "k6", "k7", "k8", "k9",
                             "k10")})
    return counts


WD_TRUTH = {"teff": 15000.0, "logg": 8.0, "plax": 5.0}
WD_BANDS = {"u": 3560.0, "g": 4770.0, "r": 6230.0, "i": 7620.0,
            "z": 9130.0}


def _wdparams_phase(dev, smi):
    """Phase 19: wdparams on the card on a synthetic input made from the
    synthetic grid at WD_TRUTH with 1% errors; the medians against the
    truth, the JSON keys, and the card's ln p against float64 on the
    CPU."""
    import contextlib
    import io
    import shutil

    import torch

    from lfit_python_tpu_torch import cli
    from lfit_python_tpu_torch.post import wdparams as wdp

    out_dir = ROOT / "build" / "chip_wd"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    lams = list(WD_BANDS.values())
    interp = wdp.GridInterpolator(*wdp.synthetic_da_grid(lams))
    mags = interp(torch.tensor([WD_TRUTH["teff"]], dtype=torch.float64),
                  torch.tensor([WD_TRUTH["logg"]], dtype=torch.float64))
    dist = 1000.0 / WD_TRUTH["plax"]
    flux = 3631e3 * 10 ** (-0.4 * (mags[0].numpy()
                                   + 5 * np.log10(dist / 10)))
    inp = out_dir / "wd_input.dat"
    inp.write_text(
        "teff = 15000 uniform 6000 90000 1\n"
        "logg = 8.0 uniform 6.5 9.5 1\n"
        "plax = 5.0 gauss 5.0 0.5 1\n"
        + "".join(f"flux_{b} = {f:.8e} {0.01 * f:.8e} {lam:.0f}\n"
                  for (b, lam), f in zip(WD_BANDS.items(), flux)))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["wdparams", str(inp), "--outdir", str(out_dir / "out"),
                       "--nwalkers", "64", "--nburn", "200", "--nprod",
                       "400"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check(rc == 0, f"wdparams exited {rc}: {buf.getvalue()[-2000:]}")
    report = json.loads((out_dir / "out" / "wdparams.json").read_text())
    _check(set(report) == {"grid", "params", "best", "derived",
                           "mean_acceptance"}, f"keys {sorted(report)}")
    pulls = {}
    for row in report["params"]:
        truth = WD_TRUTH[row["name"]]
        sigma = row["upper"] if truth > row["median"] else row["lower"]
        pulls[row["name"]] = (row["median"] - truth) / sigma
    # ln p of 64 vectors around the truth: the card against the CPU
    parsed = wdp.read_wd_input(inp)
    rng = np.random.default_rng(19)
    v = np.array(list(WD_TRUTH.values())) * (
        1 + 0.003 * rng.standard_normal((64, 3)))
    lp = {}
    for dt, d in ((torch.float64, dev), (torch.float64, "cpu"),
                  (torch.float32, dev)):
        fn = wdp.make_wd_ln_prob(parsed, interp, dt, d)
        with torch.inference_mode():
            lp[dt, str(d)] = fn(torch.tensor(v, dtype=dt, device=d)) \
                .double().cpu().numpy()
    ref = lp[torch.float64, "cpu"]
    scale = np.maximum(1.0, np.abs(ref))
    d64 = (np.abs(lp[torch.float64, str(dev)] - ref) / scale).max()
    d32 = (np.abs(lp[torch.float32, str(dev)] - ref) / scale).max()
    print(f"[19 wdparams] 64 walkers, 200 + 400 steps, float64 on the card: "
          f"exit 0 in {wall:.2f} s wall; mean acceptance "
          f"{report['mean_acceptance']:.3f}; medians "
          + ", ".join(f"{r['name']} {r['median']:.5g} (+{r['upper']:.3g} "
                      f"-{r['lower']:.3g}; pull {pulls[r['name']]:+.2f})"
                      for r in report["params"])
          + f"; {smi}")
    print(f"[19 wdparams] ln p of 64 vectors (0.3% around the truth): the "
          f"card's float64 against float64 on the CPU, max {d64:.2e} x "
          f"max(1, |ln p|) (limit 1e-12); the card's float32 {d32:.2e} (the "
          f"command runs float64; float32's magnitudes carry ~1e-6 mag)")
    _check(all(abs(p) <= 3.0 for p in pulls.values()),
           f"a median is more than 3 sigma from the truth: {pulls}")
    _check(d64 <= 1e-12, "the card's wdparams ln p disagrees with the CPU's")


def _compat_phase(dev, smi, contacts, stream, gp):
    """Phase 20: compat.CV.calcFlux on the card in float32 (fast and
    precise) against float64 on the CPU, and plot_eclipse's evaluation
    (utils.plotting.eclipse_fluxes, float64) of the demo on the card
    against the CPU; one K1 launch a call.  Returns {path: launch
    counts}."""
    import torch

    from lfit_python_tpu_torch.compat import CV
    from lfit_python_tpu_torch.models.cv import CVConfig
    from lfit_python_tpu_torch.utils.config import (build_model_from_config,
                                                    parse_input_dat)
    from lfit_python_tpu_torch.utils.plotting import eclipse_fluxes

    pars = np.array([0.1, 0.05, 0.08, 0.03, 0.15, 0.04, 0.44, 0.3, 0.011,
                     0.025, 160.0, 0.2, 1.5, 0.0, 1.0, 1.0, 90.0, 0.0])
    phase = np.linspace(-0.1, 0.1, 256)
    comps = ("ywd", "ydisc", "yspot", "ysec")

    def components(cv, total):
        return {"total": total, **{c: getattr(cv, c) for c in comps}}

    def stats(got, ref):
        """(median, p99, max) over every phase of the total and the four
        components of |got - ref| / the largest total."""
        err = np.concatenate([np.abs(got[k] - ref[k]) for k in ref])
        err /= np.abs(ref["total"]).max()
        return np.median(err), np.quantile(err, 0.99), err.max()

    counts, errs = {}, {}
    for mode, cfg in (("fast", CVConfig(complex_spot=True)),
                      ("precise", CVConfig(complex_spot=True,
                                           mixed_precision=True))):
        ref_cv = CV(pars, cfg, device="cpu", dtype=torch.float64)
        ref = components(ref_cv, ref_cv.calcFlux(pars, phase))
        cv = CV(pars, cfg, device=dev, dtype=torch.float32)
        _zero_counts(contacts, stream, gp)
        got = components(cv, cv.calcFlux(pars, phase))
        counts[mode] = _counts(contacts, stream, gp)
        errs[mode] = stats(got, ref)
    model = build_model_from_config(parse_input_dat(
        ROOT / "examples" / "demo_input.dat")).compile()
    full = model.full_from_var(model.var_start())
    ref = eclipse_fluxes(model, full, 0, device="cpu")._asdict()
    _zero_counts(contacts, stream, gp)
    got = eclipse_fluxes(model, full, 0, device=dev)._asdict()
    counts["plot"] = _counts(contacts, stream, gp)
    errs["plot"] = stats(got, ref)
    # fast float32: PERF.md section 2's parity limits (it has graze flips);
    # precise float32: the golden gate; plot (float64): float64's own
    limits = {"fast": (1e-6, 1e-4, 5e-2), "precise": (None, None, 1e-6),
              "plot": (None, None, 1e-10)}

    def fmt(mode):
        med, p99, mx = errs[mode]
        lim = limits[mode]
        return (f"median {med:.2e}, p99 {p99:.2e}, max {mx:.2e} (limits "
                + " / ".join("-" if v is None else f"{v:g}" for v in lim)
                + ")")

    print(f"[20 compat] CV.calcFlux (18 parameters, 256 phases) float32 on "
          f"the card against float64 on the CPU, every phase of the total "
          f"and the four components, of the largest total: fast {fmt('fast')}"
          f"; precise {fmt('precise')}")
    print(f"[20 compat] plot_eclipse's evaluation of the demo (float64 on "
          f"the card against the CPU, {len(ref['total'])} phases): "
          f"{fmt('plot')}; K1 launches per call: fast {counts['fast']['k1']}, "
          f"precise {counts['precise']['k1_mixed']}, plot "
          f"{counts['plot']['k1_f64']}; K2 {counts['fast']['k2']} / "
          f"{counts['precise']['k2']} / {counts['plot']['k2']}; {smi}")
    for mode, lim in limits.items():
        _check(all(v is None or e <= v for e, v in zip(errs[mode], lim)),
               f"{mode} fluxes: {fmt(mode)}")
    for mode, key in (("fast", "k1"), ("precise", "k1_mixed"),
                      ("plot", "k1_f64")):
        c = counts[mode]
        _check(c["k1"] + c["k1_f64"] + c["k1_mixed"] == 1 and c[key] == 1
               and c["k2"] == 1,
               f"{mode}: not one K1 and one K2 launch: {counts[mode]}")
    merged = {k: counts["fast"][k] + counts["precise"][k]
              for k in counts["fast"]}
    return {"compat": merged, "plot_eclipse": counts["plot"]}


def _tool(args, timeout=600):
    """``python3 tools/<args>`` in its own process: (exit code, output,
    wall seconds, its last line as JSON)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1])
    except (IndexError, ValueError):
        last = None
    return proc.returncode, proc.stdout + proc.stderr, wall, last


def _tools_phase(smi):
    """Phase 21: the ablation (default and --floor, 1024 walkers), the
    contact solvers' stress accuracy and the flux parity tools, each in
    its own process; their lines printed, accuracy held to its p99 gate,
    parity to PERF.md section 2's limits (each tool exits 1 where its
    gate fails); K1 launched by each tool, and traced in the ablation's
    full evaluation."""
    for args in (["tools/torch_ablate_posterior.py", "--reps", "3"],
                 ["tools/torch_ablate_posterior.py", "--reps", "3",
                  "--floor"],
                 ["tools/torch_accuracy_contacts.py"],
                 ["tools/torch_parity.py"]):
        rc, out, wall, last = _tool(args)
        tag = " ".join(a.replace("tools/", "") for a in args)
        for ln in out.strip().splitlines()[:-1]:
            print(f"[21 tools] {tag}: {ln}")
        print(f"[21 tools] {tag}: exit {rc} in {wall:.1f} s; {smi}")
        _check(rc == 0 and last is not None,
               f"{tag} exited {rc}: {out[-3000:]}")
        if "ablate" in tag:
            rows = {r["name"]: r for r in last["rows"]}
            _check(all(r["device_kernels"] for r in rows.values()),
                   f"{tag}: an ablation traced no device kernels")
            _check("--floor" in tag or rows["full"]["k1_kernels"] > 0,
                   f"{tag}: the full evaluation traced no contacts_kernel")
            if "--floor" not in tag:
                k = {n: r["device_kernels"] for n, r in rows.items()}
                stages = {"the white dwarf's sweep": k["full"] - k["no_wd"],
                          "the donor grid": k["no_donor"] - k["no_dgrid"]}
                print(f"[21 tools] {tag}: device kernels of the full "
                      f"evaluation {k['full']} (1222 with the eager "
                      f"chains); of it "
                      + ", ".join(f"{n} {v}" for n, v in stages.items())
                      + f" (376 and 559 as eager chains; at most 5 each "
                      f"through K10 and K9); {smi}")
                _check(all(v <= 5 for v in stages.values()),
                       f"{tag}: a stage kept more than 5 launches: {stages}")
        elif "accuracy" in tag:
            _check(last["k1_launches"] > 0, f"{tag}: K1 was not launched")
        else:
            _check(all(last[m]["k1_launches"] > 0
                       for m in ("fast", "precise")),
                   f"{tag}: K1 was not launched in each mode")


def _rounds(iters, depth):
    """The levels of each round of roche.cu's k-section at group depth
    ``depth``: rounds of ``depth`` and a short last one, at least one."""
    full, rest = divmod(iters, depth)
    return [depth] * full + [rest] * (rest > 0 or full == 0)


def _roche_executed_ops(name, solves, iters, depth):
    """The operations K4's, K5's or K6's groups execute at group depth
    ``depth`` (a model: ROCHE_OPS's for each of the 2^r - 1 midpoints a
    round of r levels tests, and each solve's own; the replay of their
    paths and the walk not counted)."""
    per_step, per_solve = ROCHE_OPS[name]
    return solves * (sum(2 ** r - 1 for r in _rounds(iters, depth))
                     * per_step + per_solve)


def _roche_chain_ms(name, iters, depth, dtype, clock):
    """(K4-K6's chain floor in ms, how it was modelled): ROCHE_CHAIN's
    latency for each round at group depth ``depth`` with the deepest
    lane's replay, the walk and the ballot (ROCHE_CHAIN)."""
    lat = ROCHE_LATENCY[dtype]
    chain = sum(c * t for c, t in zip(ROCHE_CHAIN[name], lat))
    rounds = _rounds(iters, depth)
    cycles = sum(chain + 3 * lat[0] * (2 * r - 1) + ROCHE_BALLOT_CYCLES
                 for r in rounds)
    return (cycles / clock * 1e3,
            f"{len(rounds)} rounds at d {depth}, each {chain} cycles of "
            f"evaluation + 3 x {lat[0]} a replayed or walked level + "
            f"{ROCHE_BALLOT_CYCLES} for the ballot: {cycles} cycles at "
            f"{clock / 1e9:.2f} GHz")


def _same_bits(a, b):
    """(the same NaN pattern and the same values elsewhere, max |a - b|
    over the entries finite in both)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    same = bool(torch.equal(na, nb)) and bool(torch.equal(a[~na], b[~nb]))
    fin = torch.isfinite(a) & torch.isfinite(b)
    d = (a - b).abs()[fin]
    return same, (d.max().item() if d.numel() else 0.0)


def _roche_phase(dev, smi, model, pos, roche_args, roche_us, contacts,
                 stream, gp):
    """Phase 22: K4-K6 against their plain loops, bit for bit, on the
    north star's solves (``roche_args``: phase 2's recorded inputs, 1024
    walkers) and a stress set of 8192, float32 and float64; each kernel's
    time, its plain loop's, its bound and its chain floor; K4-K6 built at
    each group depth of tools/torch_roche_depths.py, their bits and times
    on the north star's solves; the float32,
    float64 and precise posteriors and the gradient through the kernels
    and through the plain loops (equal bits), the launches of one
    evaluation of each; and the device kernels of one forward, precise
    and gradient evaluation either way.  Returns {name: results for the
    kernels line}."""
    import torch

    from lfit_python_tpu_torch.examples import build_model, with_calib_widths
    from lfit_python_tpu_torch.models.cv import CVConfig
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob
    from lfit_python_tpu_torch.ops import roche
    from lfit_python_tpu_torch.roche import geometry as tg

    f32, f64 = torch.float32, torch.float64
    loops = {"findi": tg._findi_loop, "xl1": tg._xl1_loop,
             "lobe_radius": tg._lobe_loop}
    iters = {"findi": tg._FINDI_ITERS, "xl1": tg._XL1_ITERS,
             "lobe_radius": tg._LOBE_ITERS}
    wrappers = {n: getattr(roche, f"{n}_kernel") for n in loops}

    def plain_loops():
        return _roche_wrappers(roche, lambda n, _: loops[n])

    def stress(dtype, n=8192):
        """q 0.03-3 and dphi 0.005-0.15, the last three (0.05, 0.2),
        (0.05, 0.25) infeasible and a NaN q; half the radii along the pole,
        half along random unit directions."""
        rng = np.random.default_rng(22)
        q = torch.tensor(np.r_[rng.uniform(0.03, 3.0, n - 3),
                               0.05, 0.05, np.nan], dtype=dtype, device=dev)
        dphi = torch.tensor(np.r_[rng.uniform(0.005, 0.15, n - 3),
                                  0.2, 0.25, 0.04], dtype=dtype, device=dev)
        d = rng.standard_normal((n, 3))
        d[: n // 2] = (0.0, 0.0, 1.0)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d = torch.tensor(d, dtype=dtype, device=dev)
        x1 = tg.xl1(q)
        pl1 = tg.l1_potential(q, x1)
        return {"findi": (q, 0.5 * dphi, x1, pl1), "xl1": (q,),
                "lobe_radius": (q, x1, pl1, *(d[:, k].contiguous()
                                              for k in range(3)))}

    sets = {(f32, "north star"): roche_args,
            (f64, "north star"): {n: tuple(a.to(f64) for a in args)
                                  for n, args in roche_args.items()},
            (f32, "stress"): stress(f32), (f64, "stress"): stress(f64)}
    out = {n: {"max_abs_err": 0.0} for n in loops}
    for (dtype, tag), inputs in sets.items():
        line = []
        for n, args in inputs.items():
            k, p = wrappers[n](*args), loops[n](*args)
            torch.cuda.synchronize()
            same, err = _same_bits(k, p)
            n_nan = int(torch.isnan(p).sum())
            line.append(f"{n} {'the same bits' if same else 'DIFFER'} "
                        f"(max |d| {err:.1e}, {n_nan} NaN of {p.numel()})")
            _check(same, f"K4-K6: {n} differs from its plain loop on the "
                   f"{tag} set in {dtype}: max |d| {err}")
            out[n]["max_abs_err"] = max(out[n]["max_abs_err"], err)
        print(f"[22 roche] {tag} set, {str(dtype)[6:]}: kernel against its "
              f"plain loop: " + "; ".join(line))

    # K4-K6 at each group depth, each a build of its own (the kept depths
    # and those measured beside them), launched back to back in turns
    import torch_roche_depths

    kept = {n: _roche_depth(n) for n in ROCHE_DEPTH_MACROS}
    by_depth = torch_roche_depths.measure(
        torch_roche_depths.build(), roche_args, traced=False)
    for n in ROCHE_DEPTH_MACROS:
        for dt in ("float32", "float64"):
            rows = {int(lb[1:]): r[f"{n}_{dt}"]
                    for lb, r in by_depth.items()}
            _check(all(r["same_bits"] for r in rows.values()),
                   f"{n} built at d {sorted(rows)} differs from its plain "
                   f"loop in {dt}: {rows}")
            print(f"[22 roche] {n}_kernel, {rows[kept[n]]['solves']} "
                  f"solves, {dt}, by group depth (tools/torch_roche_depths"
                  f".py builds; the same bits at each), us a launch back to "
                  f"back, median of {len(rows[kept[n]]['us_turns'])} turns: "
                  + ", ".join(f"d {d} {r['us']:.2f}"
                              for d, r in sorted(rows.items()))
                  + f"; roche.cu keeps d {kept[n]}, the fastest here d "
                  f"{min(rows, key=lambda d: rows[d]['us'])}; {smi}")

    # times, bounds and chain floors at the north star's shapes
    clock = _sm_clock_hz()
    for n, args in roche_args.items():
        r = out[n]
        r["solves"] = args[0].numel()
        for dtype in (f32, f64):
            a = sets[dtype, "north star"][n]
            ms = _event_ms(lambda: wrappers[n](*a), 20)
            plain_ms = _event_ms(lambda: loops[n](*a), 3, warmup=1)
            per_step, per_solve = ROCHE_OPS[n]
            ops = r["solves"] * (iters[n] * per_step + per_solve)
            nbytes = (r["solves"] * (ROCHE_INPUTS[n] + 1)
                      * a[0].element_size())
            bound, by = _bound(ops, nbytes, str(dtype)[6:])
            dt = str(dtype)[6:]
            res = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": by, "ops": ops, "bytes": nbytes}
            depth = kept[n]
            floor_ms, how = _roche_chain_ms(n, iters[n], depth, dt, clock)
            executed = _roche_executed_ops(n, r["solves"], iters[n], depth)
            res["chain_floor_ms"] = floor_ms
            # the chain floor against the traced time where there is one:
            # an event-timed loop of wrapper calls is host-paced
            traced_ms = roche_us[n] / 1e3 if dtype == f32 else None
            if dtype == f32:
                r.update(res)
                r["traced_us"] = roche_us[n]
            else:
                r["float64"] = res
            print(f"[22 roche] {n}_kernel, {r['solves']} solves, "
                  f"{dt}: {ms:.4f} ms a call (event-timed"
                  + (f"; {roche_us[n]:.1f} us traced in phase 2"
                     if dtype == f32 else "")
                  + f"), plain loop {plain_ms:.2f} ms "
                  f"({plain_ms / ms:.0f}x); {ops / 1e6:.2f} M operations, "
                  f"{nbytes} bytes: bound {bound * 1e3:.3f} us (set by {by}; "
                  f"the kernel at {bound / ms:.2%} of it); executed at d "
                  f"{depth} (a model: every midpoint of a round, "
                  f"ROCHE_OPS's evaluations) {executed / 1e6:.2f} M"
                  + f"; chain floor (a model: {how}) "
                  f"{floor_ms * 1e3:.1f} us, the kernel at "
                  + (f"{traced_ms / floor_ms:.1f}x it traced"
                     if traced_ms else f"{ms / floor_ms:.1f}x it event-timed")
                  + f"; {smi}")

    # the posteriors and the gradient, through the kernels and the loops
    model_w = with_calib_widths(build_model(
        n_eclipses=5, complex_spot=[False] * 5, n_points=128,
        bands=("g", "r"))).compile()
    posw = pos[:N_CHAINS]
    evals = {
        "float32": (make_ln_prob(model, dtype=f32, device=dev), pos),
        "float64": (make_ln_prob(model, dtype=f64, device=dev), pos.to(f64)),
        "precise": (make_ln_prob(model, CVConfig(mixed_precision=True),
                                 dtype=f32, device=dev), pos),
        "value_and_grad": (make_ln_prob(model_w, dtype=f32, device=dev),
                           posw)}
    kernels = {}
    for tag, (post, p) in evals.items():
        def once(post=post, p=p, vg=tag == "value_and_grad"):
            """One evaluation: ln p, or ln p and its gradient."""
            if vg:
                return post.value_and_grad(p)
            with torch.inference_mode():
                return (post(p),)

        def outputs(post=post, p=p, vg=tag == "value_and_grad"):
            if vg:
                return once()
            with torch.inference_mode():
                return post(p), post.model_flux(p)
        once()
        _zero_counts(contacts, stream, gp)
        once()
        c = _counts(contacts, stream, gp)
        with plain_loops():
            once()
            c_plain = _counts(contacts, stream, gp)
        got = outputs()
        with plain_loops():
            ref = outputs()
        torch.cuda.synchronize()
        same = [_same_bits(a, b)[0] for a, b in zip(got, ref)]
        with plain_loops():
            before = _device_kernels(once)
        after = _device_kernels(once)
        kernels[tag] = (before[1], after[1])
        n_core = 2 if tag == "precise" else 1
        print(f"[22 roche] {tag} evaluation at {p.shape[0]} walkers: ln p "
              f"{'and flux' if tag != 'value_and_grad' else 'and gradient'} "
              f"through K4-K6 and through the plain loops: "
              f"{'the same bits' if all(same) else 'DIFFER'}; launches K4 "
              f"{c['k4']}, K5 {c['k5']}, K6 {c['k6']} (K4 = K5 = {n_core} "
              f"expected; on the plain loops "
              f"{sum(c_plain[k] - c[k] for k in ('k4', 'k5', 'k6'))}"
              f"); device kernels {before[1]} with the plain loops, "
              f"{after[1]} with K4-K6 ({before[1] - after[1]} fewer); device "
              f"ms {before[0] / 1e3:.1f} -> {after[0] / 1e3:.1f}; host-clock "
              f"us of the traced call {before[2]:.0f} -> {after[2]:.0f}")
        _check(all(same), f"{tag}: K4-K6 and the plain loops disagree")
        mine = ("k4", "k5", "k6")
        _check(c["k4"] == c["k5"] == n_core
               and c["k6"] == ROCHE_PER_EVAL["k6"]
               and all(c_plain[k] == c[k] for k in mine),
               f"{tag}: launches {c}, with the plain loops {c_plain}")
    _check(kernels["float32"][0] - kernels["float32"][1] >= 15000,
           f"the forward evaluation's device kernels fell by "
           f"{kernels['float32'][0] - kernels['float32'][1]} (< 15000)")

    # the forward evaluation's host time, in turns
    post, p = evals["float32"]
    turns = {"plain": [], "kernel": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        ctx = plain_loops() if path == "plain" else contextlib.nullcontext()
        with ctx:
            turns[path].append(_sync_time(lambda: post(p), 3))
    print(f"[22 roche] north-star forward evaluation, {N_WALKERS} walkers, "
          f"float32, ms: K4-K6 {min(turns['kernel']):.1f} (turns "
          f"{turns['kernel'][0]:.1f}, {turns['kernel'][1]:.1f}), plain loops "
          f"{min(turns['plain']):.1f} (turns {turns['plain'][0]:.1f}, "
          f"{turns['plain'][1]:.1f}); {smi}")
    for n in out:
        out[n]["eval_device_kernels"] = {t: {"plain_loops": b, "kernels": a}
                                         for t, (b, a) in kernels.items()}
    return out


def _curve_stress(dev, dtype, R=64, P=128, N=992, widths=True, seed=23):
    """K7's stress rows: non-eclipsed elements (dur 0), NaN intervals (not
    eclipsed in row 0, eclipsed in row 1), an interval across the wrap at
    1; phases on the contacts, a float either side and a cycle on; widths
    at and below the 1e-12 clamp, and 0."""
    import torch

    rng = np.random.default_rng(seed)
    pin = rng.uniform(-0.06, 0.04, (R, N))
    pout = pin + rng.uniform(0.0, 0.05, (R, N))
    ecl = rng.uniform(size=(R, N)) < 0.75
    mid = 0.5 * (pin + pout)
    pin, pout = np.where(ecl, pin, mid), np.where(ecl, pout, mid)
    pin[:, 1], pout[:, 1], ecl[:, 1] = 0.96, 1.02, True
    pin[0, 2] = pout[0, 2] = np.nan
    ecl[0, 2] = False
    pin[1, 3], ecl[1, 3] = np.nan, True
    w = rng.uniform(0.0, 1.0, (R, N))
    w /= w.sum(-1, keepdims=True)
    ph = rng.uniform(-0.15, 0.15, (R, P))
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    pin, pout = pin.astype(np_dt), pout.astype(np_dt)
    for r in range(R):
        vals = [x for n in range(6) for v in (pin[r, n], pout[r, n])
                for x in (v, np.nextafter(v, np_dt(-1)),
                          np.nextafter(v, np_dt(2)), v + np_dt(1))
                if np.isfinite(x)][:P]
        ph[r, :len(vals)] = vals
    wd = None
    if widths:
        wd = np.full((R, P), 0.3 / 127)
        wd[:, :3] = (1e-12, 1e-13, 0.0)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)
    return (t(ph), None if wd is None else t(wd), t(pin), t(pout),
            torch.tensor(ecl, device=dev), t(w))


def _donor_stress(dev, dtype, G=64, E=5, P=128, N=384, seed=23):
    """K8's stress rows: directions at P phases for E rows of each of G
    grids, the first along the pole; unit normals, one perpendicular to
    the pole (mu exactly 0), one facing away (mu < 0), a zero one."""
    import torch

    rng = np.random.default_rng(seed)
    th = np.deg2rad(rng.uniform(70.0, 88.0, (G * E, 1)))
    ph = 2 * np.pi * rng.uniform(-0.5, 0.5, (G * E, P))
    e = np.stack([np.sin(th) * np.cos(ph), -np.sin(th) * np.sin(ph),
                  np.cos(th) * np.ones_like(ph)], axis=-1)
    e[:, 0] = (0.0, 0.0, 1.0)
    n = rng.standard_normal((G, N, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:, 0], n[:, 1], n[:, 2] = (1.0, 0.0, 0.0), (0.0, 0.0, -1.0), 0.0
    a = rng.uniform(1e-4, 3e-3, (G, N))
    return tuple(torch.tensor(x, dtype=dtype, device=dev) for x in (e, n, a))


def _sweep_work(name, a):
    """(operations, bytes, terms) of one call of the sweep kernel ``name``
    on the arguments ``a``: SWEEP_OPS / SWEEP_BWD_OPS a term (rows x P x
    N), each input read once and each output written once."""
    isz = a[0].element_size()
    if name.startswith("element_curve"):
        ph, wd, pin = a[0], a[1], a[2]
        (R, P), N = ph.shape, pin.shape[1]
        W = wd is not None
        mode = "widths" if W else "instant"
        if name == "element_curve":
            ops = SWEEP_OPS[mode]
            nbytes = isz * (R * P * (2 + W) + 3 * R * N) + R * N
        else:
            ops = SWEEP_BWD_OPS[mode]
            nbytes = (isz * (R * P * (2 + 2 * W) + 3 * R * N
                             + R * N * (1 + 2 * W)) + R * N)
    else:
        e, areas = a[0], a[2]
        (R, P), (G, N) = e.shape[:2], areas.shape
        if name == "donor_sum":
            ops, nbytes = SWEEP_OPS["donor"], isz * (4 * R * P + 4 * G * N)
        else:
            ops = SWEEP_BWD_OPS["donor"]
            nbytes = isz * (7 * R * P + 8 * G * N)
    terms = R * P * N
    return terms * ops, nbytes, terms


def _sweep_library_ms(name, a):
    """The yardstick of a sweep kernel: one torch.bmm, TF32 off, of the
    (rows, P, N) terms, materialised beforehand (not timed), by the
    weights (the forward's reduction over N) or by the cotangent (the
    backward's over P, for d w or d area): the TPU's reduction alone."""
    import torch

    from lfit_python_tpu_torch.models import components as comp

    with torch.no_grad():
        if name.startswith("element_curve"):
            ph, wd, pin, pout, ecl, w = a[:6]
            if wd is None:
                d = ph[:, :, None] - pin[:, None, :]
                t = 1.0 - ((d - torch.floor(d))
                           < (pout - pin)[:, None, :]).to(ph.dtype)
                del d
            else:
                t = comp.visible_fraction_interval(
                    ph[:, :, None], wd[:, :, None], pin[:, None, :],
                    pout[:, None, :], ecl[:, None, :])
            rhs = w[:, :, None]
        else:
            e, nrm, areas, u = a[:4]
            R, G = e.shape[0], areas.shape[0]
            rows = torch.arange(R, device=e.device) // (R // G)
            n = nrm[rows]
            mu = torch.clamp(torch.einsum("rpk,rnk->rpn", e, n), min=0.0)
            t = mu * (1.0 - u) + u * mu * mu
            del mu, n
            rhs = areas[rows][:, :, None].contiguous()
        if name.endswith("_backward"):
            g = a[6] if name.startswith("element_curve") else a[4]
            lhs = g[:, None, :].contiguous()
            ms = _event_ms(lambda: torch.bmm(lhs, t), 5)
        else:
            ms = _event_ms(lambda: torch.bmm(t, rhs), 5)
        del t
    torch.cuda.empty_cache()
    return ms


def _sweeps_phase(dev, smi, model, pos, start, sweep_args, sweep_us,
                  registers):
    """Phase 23: K7, K8 and their backward kernels against their plain
    versions on the rows one north-star evaluation (``sweep_args``:
    phase 2's recorded inputs, 1024 walkers) and one gradient evaluation
    of the widths model (256 chains) hand them, and on a stress set,
    float32 and float64: the forward kernels the same bits, the backward
    kernels at PERF.md's gates, two launches the same bits; times, plain
    times, bounds and the bmm yardstick; the forward and the gradient
    evaluation through the kernels and through the plain sweeps.  Returns
    {kernel name: results for the kernels line}."""
    import torch

    from lfit_python_tpu_torch.examples import build_model, with_calib_widths
    from lfit_python_tpu_torch.models import components as comp
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob
    from lfit_python_tpu_torch.ops import _build, sweeps

    f32, f64 = torch.float32, torch.float64
    issue_per_s = (torch.cuda.get_device_properties(0).multi_processor_count
                   * SM_LANES["fp32"] * _sm_clock_hz())
    plain = {"element_curve": comp._element_curve_plain,
             "donor_sum": comp._donor_sum_plain,
             "element_curve_backward": sweeps._curve_backward_plain,
             "donor_sum_backward": sweeps._donor_backward_plain}
    wrap = {n: getattr(sweeps, f"{n}_kernel") for n in plain}

    # the gradient evaluation of the widths model at 256 chains (phase 7's
    # walkers): the rows and cotangents it hands the kernels
    model_w = with_calib_widths(build_model(
        n_eclipses=5, complex_spot=[False] * 5, n_points=128,
        bands=("g", "r"))).compile()
    lpw = make_ln_prob(model_w, dtype=f32, device=dev)
    posw = _walkers(start, N_CHAINS, 1, f32, dev)
    with _sweep_wrappers(sweeps) as rec:
        lpw.value_and_grad(posw)
    grad_args = {n: [tuple(a.detach() if isinstance(a, torch.Tensor) else a
                           for a in c.args) for c in r.call_args_list]
                 for n, r in rec.items()}
    _check([len(v) for v in grad_args.values()] == [2, 2, 2, 2],
           f"the gradient evaluation's K7 / K8 calls: "
           f"{ {n: len(v) for n, v in grad_args.items()} }")
    gen = torch.Generator(device=dev).manual_seed(23)

    def stress(dtype):
        c = [_curve_stress(dev, dtype, widths=w) for w in (False, True)]
        d = _donor_stress(dev, dtype)
        dn = _donor_stress(dev, dtype, P=1)
        g = [torch.randn(x[0].shape, generator=gen, dtype=f64,
                         device=dev).to(dtype) for x in c]
        gd = torch.randn(d[0].shape[:2], generator=gen, dtype=f64,
                         device=dev).to(dtype)
        gdn = torch.randn(dn[0].shape[:2], generator=gen, dtype=f64,
                          device=dev).to(dtype)
        return {"element_curve": c,
                "donor_sum": [(*d, 0.9), (*dn, 0.9)],
                "element_curve_backward": [(*x, gx) for x, gx in zip(c, g)],
                "donor_sum_backward": [(*d, 0.9, gd), (*dn, 0.9, gdn)]}

    out = {n: {"max_abs_err": 0.0} for n in plain}
    sets = {"north star": sweep_args, "gradient evaluation": grad_args}
    # the forward kernels: the plain versions' bits, two launches alike
    for tag in ("north star", "gradient evaluation", "stress"):
        for dtype in (f32, f64):
            line = []
            src = stress(dtype) if tag == "stress" else sets[tag]
            for n in ("element_curve", "donor_sum"):
                for a in src[n]:
                    a = _cast(a, dtype)
                    k, k2, p = wrap[n](*a), wrap[n](*a), plain[n](*a)
                    same, err = _same_bits(k, p)
                    again = _same_bits(k, k2)[0]
                    n_nan = int(torch.isnan(p).sum())
                    line.append(f"{n} {tuple(a[0].shape[:2])} x "
                                f"{a[2].shape[-1]}: "
                                + ("the same bits" if same else "DIFFER")
                                + f", {n_nan} NaN; two launches "
                                + ("alike" if again else "DIFFER"))
                    _check(same and again, f"{n} differs from its plain "
                           f"version (or from itself) on the {tag} rows in "
                           f"{dtype}: max |d| {err}")
                    out[n]["max_abs_err"] = max(out[n]["max_abs_err"], err)
            print(f"[23 sweeps] {tag} rows, {str(dtype)[6:]}, against the "
                  f"plain version: " + "; ".join(line))
    # the backward kernels: float64 within 1e-9 of the largest |gradient|
    # of autograd on the plain forward, float32 at PERF.md's gate
    for tag in ("gradient evaluation", "stress"):
        src32 = stress(f32) if tag == "stress" else grad_args
        for n in ("element_curve_backward", "donor_sum_backward"):
            for a in src32[n]:
                a64 = _cast(a, f64)
                k64, p64 = wrap[n](*a64), plain[n](*a64)
                k32, k32b, p32 = wrap[n](*a), wrap[n](*a), plain[n](*a)
                rel, gate, again = [], [], True
                for x64, y64, x32, x32b, y32 in zip(k64, p64, k32, k32b,
                                                    p32):
                    if y64 is None:
                        _check(x64 is None and x32 is None, f"{n}: a "
                               "cotangent the plain version does not make")
                        continue
                    scale = max(float(torch.nan_to_num(y64).abs().max()),
                                1e-300)
                    rel.append(float(torch.nan_to_num(x64 - y64).abs().max())
                               / scale)
                    _check(torch.equal(torch.isnan(x64), torch.isnan(y64))
                           and torch.equal(torch.isnan(x32),
                                           torch.isnan(y32)),
                           f"{n}: the NaN pattern differs ({tag})")
                    again = again and _same_bits(x32, x32b)[0]
                    x32, y32 = torch.nan_to_num(x32), torch.nan_to_num(y32)
                    y64 = torch.nan_to_num(y64)
                    near = (x32 - y32).abs() <= 1e-5 + 2e-3 * y32.abs()
                    lim = float((y32.double() - y64).abs().max())
                    far = float((x32.double() - y64).abs().max())
                    gate.append((bool(near.all()), far, lim,
                                 float((x32 - y32).abs().max())))
                    ok = near | ((x32.double() - y64).abs() <= lim)
                    _check(bool(ok.all()), f"{n}, {tag} rows: float32 "
                           f"outside the gate (farthest from float64 {far}, "
                           f"plain float32 {lim})")
                _check(max(rel) <= 1e-9 and again, f"{n}, {tag} rows: "
                       f"float64 max |d| / max |g| {rel}, or two launches "
                       f"differ")
                out[n]["max_abs_err"] = max(out[n]["max_abs_err"],
                                            max(g[3] for g in gate))
                out[n].setdefault("max_rel_err_float64", 0.0)
                out[n]["max_rel_err_float64"] = max(
                    out[n]["max_rel_err_float64"], max(rel))
                print(f"[23 sweeps] {n}, {tag} rows "
                      f"{tuple(a[0].shape[:2])} x {a[2].shape[-1]}: float64 "
                      f"max |d| / max |g| "
                      + ", ".join(f"{r:.1e}" for r in rel)
                      + " (limit 1e-9); float32 within 1e-5 + 2e-3 |g| of "
                      "plain float32: "
                      + ", ".join("all" if a_ else f"no (farthest from "
                                  f"float64 {f:.1e}, plain {lim_:.1e})"
                                  for a_, f, lim_, _ in gate)
                      + "; two launches the same bits")

    # times, bounds and the bmm yardstick at the main paths' shapes
    for tag, n, a in _sweep_calls(sweep_args, grad_args):
        row = tag.split()[-1]
        ms = _event_ms(lambda: wrap[n](*a), 20)
        ms64 = _event_ms(lambda: wrap[n](*_cast(a, f64)), 10)
        plain_ms = _event_ms(lambda: plain[n](*a), 3, warmup=1)
        ops, nbytes, terms = _sweep_work(n, a)
        bound, by = _bound(ops, nbytes)
        # built with --fmad=false no counted operation fuses: each takes
        # an issue slot of an FP32 lane
        floor_ms = ops / issue_per_s * 1e3
        traced, traced64 = sweep_us[tag], sweep_us[f"{tag} float64"]
        lib_ms = _sweep_library_ms(n, a)
        res = {"rows": a[0].shape[0], "phases": a[0].shape[1],
               "elements": a[2].shape[-1], "terms": terms,
               "ms": ms, "traced_us": traced, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "ops": ops,
               "bytes": nbytes, "library_ms": lib_ms, "float64_ms": ms64,
               "traced_float64_us": traced64, "issue_floor_ms": floor_ms}
        first = row == SWEEP_ROWS[n.replace("_backward", "")][0]
        if first:
            out[n].update(res)
        else:
            out[n][row] = res
        print(f"[23 sweeps] {tag}: {res['rows']} x {res['phases']} x "
              f"{res['elements']} ({terms / 1e6:.1f} M terms), float32: "
              f"{traced:.1f} us traced in phase 2 (float64 {traced64:.1f}), "
              f"{ms:.4f} ms a call event-timed (float64 {ms64:.4f}); plain "
              f"{plain_ms:.2f} ms ({plain_ms / ms:.0f}x); {ops / 1e9:.3f} "
              f"GFLOP, {nbytes / 1e6:.1f} MB: bound {bound * 1e3:.2f} us "
              f"(set by {by}; the kernel at "
              f"{bound * 1e3 / max(traced, 1e-9):.1%} of it traced); at one "
              f"operation an FP32 lane and clock {floor_ms * 1e3:.2f} us "
              f"({floor_ms * 1e3 / max(traced, 1e-9):.1%}); torch.bmm of "
              f"the materialised terms (the reduction alone, TF32 off) "
              f"{lib_ms:.4f} ms; {smi}")
    for n in out:
        out[n]["registers"] = {e: r for e, r in registers["sweeps"].items()
                               if e.startswith(f"{n}_kernel")}
    # every instantiation: nothing in local memory
    entries = {_short_entry(e): v for e, v in _ptxas_entries(
        _build.PTXAS_LOGS["sweeps"].read_text()).items()
        if re.search(r"\d(element_curve|donor_sum)\w*_kernelI", e)}
    print("[23 sweeps] ptxas, K7, K8 and their backward kernels: "
          + ", ".join(f"{e} {v['registers']} registers, {v['frame']} bytes "
                      f"stack frame, {v['spill']} bytes spilled"
                      for e, v in sorted(entries.items())))
    _check(len(entries) == 14 and not any(v["frame"] or v["spill"]
                                          for v in entries.values()),
           f"a sweep kernel keeps something in local memory: {entries}")
    # what each issues a term, from the build's SASS, and that count's
    # time at the schedulers' rate (a warp instruction a scheduler and
    # clock) and at each pipe's (the tool's LANES: the ALU and FP64 pipes
    # take two clocks a warp instruction)
    sys.path.insert(0, str(ROOT / "tools"))
    import sweeps_sass_counts

    sass = sweeps_sass_counts.counts(sweeps_sass_counts.built_sass())
    issue = {k: sass[k].get("issue_cycles_per_term")
             for k in SWEEPS_SASS_PER_TERM}
    print("[23 sweeps] instructions a term (SASS, tools/sweeps_sass_counts"
          ".py): " + ", ".join(f"{k} {v} ({sass[k]['per_term']})"
                               for k, v in issue.items()))
    _check(issue == SWEEPS_SASS_PER_TERM, "SWEEPS_SASS_PER_TERM is not "
           f"this build's count: {issue}")
    warp_clocks = issue_per_s / SM_LANES["fp32"] * 4   # warp issue slots/s
    for tag, kernel in SWEEP_SASS_OF.items():
        name = tag.split()[1]
        res = out[name] if tag.endswith(("disc", "curve")) else \
            out[name][tag.split()[-1]]
        cyc = sass[kernel]["cycles_per_term"]
        at = {"issue": issue[kernel], **cyc}
        res["sass_per_term"] = sass[kernel]["per_term"]
        res["sass_ms"] = {k: res["terms"] / 32 * c / warp_clocks * 1e3
                          for k, c in at.items()}
        print(f"[23 sweeps] {tag}: {kernel}'s {res['terms'] / 1e6:.1f} M "
              f"terms at the issue rate "
              f"{res['sass_ms']['issue'] * 1e3:.1f} us, "
              + ", ".join(f"{k} pipe {v * 1e3:.1f} us"
                          for k, v in res["sass_ms"].items() if k != "issue")
              + f"; traced {res['traced_us']:.1f} us; {smi}")

    # the forward and the gradient evaluation through the kernels and
    # through the plain sweeps
    lp32 = make_ln_prob(model, dtype=f32, device=dev)

    def plain_sweeps():
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(
            sweeps, "element_curve", comp._element_curve_plain))
        stack.enter_context(mock.patch.object(
            sweeps, "donor_sum", comp._donor_sum_plain))
        return stack

    def fwd():
        with torch.inference_mode():
            return lp32(pos)

    def vg():
        return lpw.value_and_grad(posw)

    evals = {}
    for tag, fn in (("forward", fwd), ("value_and_grad", vg)):
        res = {}
        for path in ("plain", "kernels"):
            ctx = plain_sweeps() if path == "plain" else contextlib.nullcontext()
            with ctx:
                fn()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                c0 = (sweeps.CURVE_LAUNCHES, sweeps.DONOR_LAUNCHES)
                got = fn()
                torch.cuda.synchronize()
                launched = (sweeps.CURVE_LAUNCHES - c0[0],
                            sweeps.DONOR_LAUNCHES - c0[1])
                peak = torch.cuda.max_memory_allocated()
                busy, n_k, wall, by_name = _device_kernels(fn)
            res[path] = {"kernels": n_k, "device_ms": busy / 1e3,
                         "busy": busy / wall, "peak_gib": peak / 2**30,
                         "out": got, "launched": launched,
                         "traced": [any(f"{k}_kernel" in nm for nm in by_name)
                                    for k in ("element_curve", "donor_sum")]}
        a, b = res["kernels"], res["plain"]
        first = (lambda o: o[0]) if tag == "value_and_grad" else (
            lambda o: o)
        same = _same_bits(first(a["out"]), first(b["out"]))[0]
        n_walk = pos.shape[0] if tag == "forward" else posw.shape[0]
        print(f"[23 sweeps] one {tag} evaluation ({n_walk} walkers), plain "
              f"sweeps -> K7 / K8: device kernels "
              f"{b['kernels']} -> {a['kernels']} ({b['kernels'] - a['kernels']}"
              f" fewer), device ms {b['device_ms']:.2f} -> "
              f"{a['device_ms']:.2f}, busy share {b['busy']:.1%} -> "
              f"{a['busy']:.1%}, peak memory {b['peak_gib']:.2f} -> "
              f"{a['peak_gib']:.2f} GiB; K7 / K8 launched {a['launched']} "
              f"(plain sweeps {b['launched']}), in the trace {a['traced']} "
              f"(plain sweeps {b['traced']}); ln p "
              + ("the same bits" if same else "DIFFERS") + f"; {smi}")
        _check(same, f"{tag}: ln p through K7 / K8 differs from the plain "
               "sweeps")
        if tag == "forward":
            _check(a["launched"] == (2, 2) and b["launched"] == (0, 0)
                   and a["traced"] == [True, True]
                   and b["traced"] == [False, False],
                   f"the forward evaluation: K7 / K8 launched "
                   f"{a['launched']} (plain sweeps {b['launched']}), in the "
                   f"trace {a['traced']} (plain sweeps {b['traced']})")
            _check(b["kernels"] - a["kernels"] >= 250,
                   f"the forward evaluation's device kernels fell by "
                   f"{b['kernels'] - a['kernels']} (< 250)")
        evals[tag] = {p: {k: v for k, v in r.items() if k != "out"}
                      for p, r in res.items()}

    # the forward evaluation's host time, in turns
    turns = {"plain": [], "kernels": []}
    for path in ("plain", "kernels", "kernels", "plain"):
        ctx = plain_sweeps() if path == "plain" else contextlib.nullcontext()
        with ctx:
            turns[path].append(_sync_time(fwd, 3))
    print(f"[23 sweeps] north-star forward evaluation, {N_WALKERS} walkers, "
          f"float32, ms: K7 / K8 {min(turns['kernels']):.1f} (turns "
          f"{turns['kernels'][0]:.1f}, {turns['kernels'][1]:.1f}), plain "
          f"sweeps {min(turns['plain']):.1f} (turns {turns['plain'][0]:.1f}, "
          f"{turns['plain'][1]:.1f}); {smi}")
    out["element_curve"]["evaluations"] = evals
    out["element_curve"]["forward_ms_in_turns"] = {p: min(t) for p, t in
                                                   turns.items()}
    return out


def _wd_stress(dev, dtype, W=1024, E=2, P=128, seed=24):
    """K9's and K10's stress inputs, {wrapper: (args, kwargs)}: W walkers
    with q 0.03-3.5 (both ends exact) along the north star's 16 x 24
    directions, and W x E rows at inclinations 75-90 deg (75, 80, 85 and
    90 exact; rays that miss the donor at every phase among them), rwd
    0.005-0.03 (every seventh row 0.2, the next 1e-4) and phases across
    ingress, egress and mid-eclipse ([-0.15, 0.15], and 0, +-0.5, +-1e-7,
    0.25, 0.9), the inscribed-sphere guard's certain occultation among
    them."""
    import torch

    from lfit_python_tpu_torch.models import components as comp
    from lfit_python_tpu_torch.roche import geometry as tg

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    q = t(np.r_[rng.uniform(0.03, 3.5, W - 2), 0.03, 3.5])
    x1 = tg.xl1(q)
    pl1 = tg.l1_potential(q, x1)
    r_ins = tg.inscribed_radius(q, x1, pl1)
    incl = rng.uniform(75.0, 90.0, W)
    incl[:4] = (75.0, 80.0, 85.0, 90.0)
    rwd = rng.uniform(0.005, 0.03, (W, E))
    rwd.flat[::7] = 0.2
    rwd.flat[1::7] = 1e-4
    ulimb = rng.uniform(0.1, 0.6, (W, E))
    base = np.r_[np.linspace(-0.15, 0.15, P - 8), 0.0, 0.5, -0.5, 1e-7,
                 -1e-7, 0.25, 0.9, 0.03]
    ph = t(base[None, None, :] + rng.uniform(-0.003, 0.003, (W, E, 1)))
    per_walker = [a[:, None, None] for a in (q, t(incl), x1, pl1, r_ins)]
    qw, iw, xw, pw, rw = per_walker
    return {"donor_grid": ((q, x1, pl1, *comp._directions(16, 24, dtype,
                                                          dev)),
                           {"grid": True}),
            "wd_curve": ((qw, iw, ph, t(rwd)[..., None], t(ulimb)[..., None],
                          xw, pw, rw), {}),
            "wd_distance": ((qw, iw, ph, xw, pw), {})}


def _wd_shapes(dev, dtype):
    """[(wrapper, args, kwargs)] of phase 24's other shapes: K10 in both
    modes at each of WD_PHASES (the stress set's first 37 walkers x 3
    eclipses and its first P phases; at P = 1 rows whose parameters vary
    along the last axis, a point each, as the GP changepoints' are) and
    K9 in both modes at each of DONOR_GRIDS (its first 13 walkers)."""
    from lfit_python_tpu_torch.models import components as comp

    st = _wd_stress(dev, dtype, W=37, E=3, P=max(WD_PHASES) + 8)
    curve = st["wd_curve"][0]
    out = []
    for P in WD_PHASES:
        args = list(curve)
        args[2] = args[2][..., :P].contiguous()
        if P == 1:
            args = [a[..., 0].expand(37, 3).contiguous() for a in args]
        out += [("wd_curve", tuple(args), {}),
                ("wd_distance", (args[0], args[1], args[2], args[5],
                                 args[6]), {})]
    q, x1, pl1 = (a[:13] for a in st["donor_grid"][0][:3])
    for grid in DONOR_GRIDS:
        out.append(("donor_grid", (q, x1, pl1,
                                   *comp._directions(*grid, dtype, dev)),
                    {"grid": True}))
    return out


def _wd_outputs(fn, name, args, kwargs):
    """The outputs of a K9 / K10 wrapper or plain version as a tuple: K9's
    in both modes, the radius and its slope (a recorded graph's launch)
    and the grid (a forward evaluation's)."""
    if name == "donor_grid":
        r, slope, _ = fn(*args, grid=False)
        return (r, slope, *fn(*args, grid=True)[2])
    out = fn(*args, **kwargs)
    return out if isinstance(out, tuple) else (out,)


def _wd_plain_fns():
    """{wrapper name: its plain version}, called as the wrapper is."""
    from lfit_python_tpu_torch.models import components as comp
    from lfit_python_tpu_torch.roche import geometry as tg

    def donor_grid(q, x1, pl1, dx, dy, dz, d_omega, grid=True):
        r, slope = comp._donor_radius_loop(q, x1, pl1, dx, dy, dz)
        if not grid:
            return r, slope, None
        return None, None, comp._donor_grid_plain(
            r, (q / (1.0 + q))[:, None], dx, dy, dz, d_omega)

    return {"donor_grid": donor_grid, "wd_curve": comp._wd_curve_plain,
            "wd_distance": tg._shadow_distance_plain}


def _broadcast_shape(args):
    import torch

    return torch.broadcast_shapes(*(a.shape for a in args))


def _wd_work(name, args, dtype):
    """(operations, bytes) of one K9 (with its grid, as a forward
    evaluation launches it) / K10 call: WD_DONOR_OPS a solve or a point;
    each input read once (a per-row parameter once a row), each output
    written once (K9: the grid's 7 values a solve)."""
    isz = 4 if dtype == "float32" else 8
    if name == "donor_grid":
        W, N = args[0].numel(), args[3].numel()
        return (W * N * WD_DONOR_OPS[name][dtype],
                isz * (3 * W + 4 * N + 7 * W * N))
    n = math.prod(_broadcast_shape(args))
    n_out = 2 if name == "wd_distance" else 1
    return (n * WD_DONOR_OPS[name],
            isz * (sum(a.numel() for a in args) + n_out * n))


def _wd_donor_phase(dev, smi, model, pos, wd_args, wd_us, registers,
                    contacts, stream, gp):
    """Phase 24: K9 and K10 (both modes) against their plain versions, bit
    for bit, on the north star's inputs (``wd_args``: phase 2's recorded
    calls) and a stress set (``_wd_stress``), float32 and float64; each
    call's time (traced in phase 2, ``wd_us``; event-timed), its plain
    version's, its bound and ptxas's registers; the forward (float32,
    float64, precise, GP) and gradient evaluations through K9 / K10 and
    through the plain chains: the same bits, the launches of each, the
    device kernels and device ms either way; the forward evaluation's
    host ms in turns.  Returns {name: results for the kernels line}."""
    import torch

    from lfit_python_tpu_torch.examples import build_model, with_calib_widths
    from lfit_python_tpu_torch.models.cv import CVConfig
    from lfit_python_tpu_torch.models.likelihood import make_ln_prob
    from lfit_python_tpu_torch.ops import wd_donor
    from lfit_python_tpu_torch.roche import geometry as tg

    f32, f64 = torch.float32, torch.float64
    plain = _wd_plain_fns()
    kernels = {n: getattr(wd_donor, f"{n}_kernel") for n in plain}

    def plain_chains():
        return mock.patch.object(tg, "_on_card", lambda t: False)

    sets = {}
    for dtype in (f32, f64):
        sets[dtype, "north star"] = {n: (_cast(a, dtype), kw)
                                     for n, (a, kw) in wd_args.items()}
        sets[dtype, "stress"] = _wd_stress(dev, dtype)
    out = {n: {"max_abs_err": 0.0} for n in plain}
    for (dtype, tag), inputs in sets.items():
        line = []
        for n, (args, kw) in inputs.items():
            k = _wd_outputs(kernels[n], n, args, kw)
            p = _wd_outputs(plain[n], n, args, kw)
            torch.cuda.synchronize()
            res = [_same_bits(a, b) for a, b in zip(k, p)]
            same = len(k) == len(p) and all(r[0] for r in res)
            err = max(r[1] for r in res)
            n_nan = sum(int(torch.isnan(b).sum()) for b in p)
            what = ""
            if n == "wd_curve":
                f = p[0]
                what = (f"; visible {int((f == 1).sum())}, occulted "
                        f"{int((f == 0).sum())}, partial "
                        f"{int(((f > 0) & (f < 1)).sum())}")
                _check(tag == "north star" or all(
                    int(c.sum()) for c in (f == 1, f == 0, (f > 0) & (f < 1))),
                       f"the stress set lacks a kind of point: {what}")
            elif n == "wd_distance":
                miss = int((p[1] == 10.0).sum())
                what = f"; rays missing the donor {miss}"
                _check(tag == "north star" or miss > 0,
                       "the stress set has no ray that misses the donor")
            line.append(f"{n} {'the same bits' if same else 'DIFFER'} "
                        f"(max |d| {err:.1e}, {n_nan} NaN of "
                        f"{sum(b.numel() for b in p)}{what})")
            _check(same, f"K9 / K10: {n} differs from its plain version on "
                   f"the {tag} set in {dtype}: max |d| {err}")
            key = "wd_curve" if n == "wd_distance" else n
            out[key]["max_abs_err"] = max(out[key]["max_abs_err"], err)
        print(f"[24 wd_donor] {tag} set, {str(dtype)[6:]}: kernel against "
              f"its plain version: " + "; ".join(line))

    # K10's row lengths and K9's grids
    for dtype in (f32, f64):
        worst, calls = 0.0, _wd_shapes(dev, dtype)
        for n, args, kw in calls:
            k = _wd_outputs(kernels[n], n, args, kw)
            p = _wd_outputs(plain[n], n, args, kw)
            torch.cuda.synchronize()
            res = [_same_bits(a, b) for a, b in zip(k, p)]
            _check(len(k) == len(p) and all(r[0] for r in res),
                   f"K9 / K10: {n} differs from its plain version at "
                   f"shape {tuple(_broadcast_shape(args[:3]))} in {dtype}")
            err = max(r[1] for r in res)
            worst = max(worst, err)
            key = "wd_curve" if n == "wd_distance" else n
            out[key]["max_abs_err"] = max(out[key]["max_abs_err"], err)
        print(f"[24 wd_donor] K10 at rows of {WD_PHASES} phases (37 x 3 "
              f"rows; both modes) and K9 at grids {DONOR_GRIDS} (13 "
              f"walkers; both modes), {str(dtype)[6:]}: {len(calls)} calls "
              f"against their plain versions: the same bits (max |d| "
              f"{worst:.1e})")

    # times and bounds at the north star's shapes; the issue floor (each
    # counted operation an FP32 lane's issue slot: --fmad=false fuses
    # none) and the build's SASS at the issue rate and each pipe's
    sys.path.insert(0, str(ROOT / "tools"))
    import wd_donor_sass_counts

    sass = wd_donor_sass_counts.counts(wd_donor_sass_counts.built_sass())
    issue_per_s = (torch.cuda.get_device_properties(0).multi_processor_count
                   * SM_LANES["fp32"] * _sm_clock_hz())
    warp_clocks = issue_per_s / SM_LANES["fp32"] * 4   # warp issue slots/s
    for tag, n in _WD_CALLS:
        for dtype in (f32, f64):
            dt = str(dtype)[6:]
            args, kw = sets[dtype, "north star"][n]
            ms = _event_ms(lambda: kernels[n](*args, **kw), 20)
            plain_ms = _event_ms(lambda: plain[n](*args, **kw), 3, warmup=1)
            traced = wd_us[tag + ("" if dtype == f32 else " float64")]
            ops, nbytes = _wd_work(n, args, dt)
            bound, by = _bound(ops, nbytes, dt)
            size = (f"{args[0].numel()} walkers x {args[3].numel()} "
                    "directions" if n == "donor_grid" else
                    f"{math.prod(_broadcast_shape(args))} points")
            count = sass[WD_SASS_OF[n].format("f32" if dtype == f32
                                              else "f64")]
            points = ops / (WD_DONOR_OPS[n][dt] if n == "donor_grid"
                            else WD_DONOR_OPS[n])
            at = {"issue": count["issue_cycles"], **count["cycles"]}
            res = {"ms": ms, "plain_ms": plain_ms, "traced_us": traced,
                   "bound_ms": bound, "bound_by": by, "ops": ops,
                   "bytes": nbytes, "issue_floor_ms": ops / issue_per_s * 1e3,
                   "sass_per_" + count["per"]: count["counts"],
                   "sass_outside_per_lane": count["outside"],
                   "sass_ms": {k: points / 32 * c / warp_clocks * 1e3
                               for k, c in at.items()}}
            print(f"[24 wd_donor] {tag}_kernel, {size}, {dt}: {traced:.1f} "
                  f"us traced in phase 2, {ms:.4f} ms a call event-timed "
                  f"(host-paced below ~0.1 ms); plain {plain_ms:.3f} ms "
                  f"({plain_ms * 1e3 / max(traced, 1e-9):.0f}x the traced "
                  f"time); {ops / 1e6:.1f} M operations, {nbytes / 1e6:.2f} "
                  f"MB: bound {bound * 1e3:.2f} us (set by {by}; the kernel "
                  f"at {bound * 1e3 / max(traced, 1e-9):.1%} of it traced); "
                  f"issue floor {res['issue_floor_ms'] * 1e3:.2f} us (the "
                  f"kernel at "
                  f"{res['issue_floor_ms'] * 1e3 / max(traced, 1e-9):.1%} "
                  f"of it); its SASS, {count['issue_cycles']} instructions "
                  f"a {count['per']} all-in ({count['loop_issue_cycles']} "
                  f"in its loop), at the issue rate "
                  f"{res['sass_ms']['issue'] * 1e3:.2f} us, "
                  + ", ".join(f"{k} pipe {v * 1e3:.2f} us"
                              for k, v in res["sass_ms"].items()
                              if k != "issue") + f"; {smi}")
            if n == "wd_distance":
                out["wd_curve"].setdefault("distance", {})[dt] = res
            elif dtype == f32:
                out[n].update(res)
            else:
                out[n]["float64"] = res
    print("[24 wd_donor] ptxas registers: " + ", ".join(
        f"{e} {r}" for e, r in sorted(registers["wd_donor"].items())))

    # the evaluations through K9 / K10 and through the plain chains
    model_w = with_calib_widths(build_model(
        n_eclipses=5, complex_spot=[False] * 5, n_points=128,
        bands=("g", "r"))).compile()
    model_gp = build_model(n_eclipses=5, complex_spot=[False] * 5,
                           use_gp=True, n_points=128,
                           bands=("g", "r")).compile()
    pos_gp = _walkers(model_gp.var_start(), N_WALKERS, 0, f32, dev)
    evals = {
        "float32": (make_ln_prob(model, dtype=f32, device=dev), pos,
                    WD_DONOR_PER_EVAL),
        "float64": (make_ln_prob(model, dtype=f64, device=dev), pos.to(f64),
                    WD_DONOR_PER_EVAL),
        "precise": (make_ln_prob(model, CVConfig(mixed_precision=True),
                                 dtype=f32, device=dev), pos,
                    {"k9": 1, "k10": 0}),
        "gp": (make_ln_prob(model_gp, dtype=f32, device=dev), pos_gp,
               {"k9": 1, "k10": 1 + WD_GP_CHANGEPOINTS}),
        "value_and_grad": (make_ln_prob(model_w, dtype=f32, device=dev),
                           pos[:N_CHAINS], WD_DONOR_PER_GRAD)}
    device = {}
    for tag, (post, p, want) in evals.items():
        vg = tag == "value_and_grad"

        def once(post=post, p=p, vg=vg):
            """One evaluation: ln p, or ln p and its gradient."""
            if vg:
                return post.value_and_grad(p)
            with torch.inference_mode():
                return (post(p),)

        def outputs(post=post, p=p, vg=vg):
            if vg:
                return once()
            with torch.inference_mode():
                return post(p), post.model_flux(p)
        once()
        _zero_counts(contacts, stream, gp)
        once()
        c = _counts(contacts, stream, gp)
        got = outputs()
        with plain_chains():
            _zero_counts(contacts, stream, gp)
            once()
            c_plain = _counts(contacts, stream, gp)
            ref = outputs()
            before = _device_kernels(once)
        after = _device_kernels(once)
        torch.cuda.synchronize()
        same = all(_same_bits(a, b)[0] for a, b in zip(got, ref))
        device[tag] = {"plain_chains": {"kernels": before[1],
                                        "device_ms": before[0] / 1e3},
                       "kernels": {"kernels": after[1],
                                   "device_ms": after[0] / 1e3}}
        print(f"[24 wd_donor] {tag} evaluation at {p.shape[0]} walkers: "
              f"{'ln p and gradient' if vg else 'ln p and flux'} through "
              f"K9 / K10 and through the plain chains: "
              f"{'the same bits' if same else 'DIFFER'}; launches K9 "
              f"{c['k9']}, K10 {c['k10']} (expected {want['k9']}, "
              f"{want['k10']}; the plain chains {c_plain['k9']}, "
              f"{c_plain['k10']}); device kernels {before[1]} -> {after[1]} "
              f"({before[1] - after[1]} fewer), device ms "
              f"{before[0] / 1e3:.3f} -> {after[0] / 1e3:.3f}; host-clock us "
              f"of the traced call {before[2]:.0f} -> {after[2]:.0f}; {smi}")
        _check(same, f"{tag}: K9 / K10 and the plain chains disagree")
        _check(all(c[k] == v for k, v in want.items())
               and c_plain["k9"] == c_plain["k10"] == 0,
               f"{tag}: launches {c}, with the plain chains {c_plain}")
    fwd = device["float32"]
    _check(fwd["plain_chains"]["kernels"] - fwd["kernels"]["kernels"] >= 500,
           f"the forward evaluation's device kernels fell by "
           f"{fwd['plain_chains']['kernels'] - fwd['kernels']['kernels']} "
           f"(< 500)")

    # the forward evaluation's host time, in turns
    post, p, _ = evals["float32"]
    turns = {"plain": [], "kernels": []}
    for path in ("plain", "kernels", "kernels", "plain"):
        ctx = plain_chains() if path == "plain" else contextlib.nullcontext()
        with ctx:
            turns[path].append(_sync_time(lambda: post(p), 3))
    print(f"[24 wd_donor] north-star forward evaluation, {N_WALKERS} "
          f"walkers, float32, ms: K9 / K10 {min(turns['kernels']):.1f} "
          f"(turns {turns['kernels'][0]:.1f}, {turns['kernels'][1]:.1f}), "
          f"plain chains {min(turns['plain']):.1f} (turns "
          f"{turns['plain'][0]:.1f}, {turns['plain'][1]:.1f}); {smi}")
    out["donor_grid"]["evaluations"] = device
    out["donor_grid"]["forward_ms_in_turns"] = {k: min(v)
                                                for k, v in turns.items()}
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    import lfit_python_tpu_torch

    pkg_root = Path(lfit_python_tpu_torch.__file__).resolve().parent.parent
    _check(pkg_root == ROOT,
           f"the port was imported from {pkg_root}, not this checkout")
    from lfit_python_tpu_torch.examples import build_model, with_calib_widths
    from lfit_python_tpu_torch.models.cv import CVConfig, cv_fluxes
    from lfit_python_tpu_torch.models.likelihood import (make_ln_prob,
                                                         make_ln_prob_parts)
    from lfit_python_tpu_torch.ops import (_build, contacts, gp, roche, stream,
                                           sweeps, wd_donor)
    from lfit_python_tpu_torch.roche.geometry import xl1
    from lfit_python_tpu_torch.sampling.ensemble import (init_walkers,
                                                         run_sampler)
    from lfit_python_tpu_torch.sampling.hmc import (hmc_step, init_hmc,
                                                    run_hmc, warmup_hmc)
    from lfit_python_tpu_torch.sampling.nuts import nuts_step
    from lfit_python_tpu_torch.sampling.pt import init_pt, pt_step

    _check("jax" not in sys.modules, "the port imported jax")
    # every posterior call here runs eagerly: the phases hold the kernels
    # to their plain versions by patching module functions on one
    # posterior, which a CUDA graph captured before the patch would not
    # see (the graph route is held by tests/test_torch_cuda.py and the
    # benchmark); the phases' fresh processes replay as the fit does
    from lfit_python_tpu_torch.models import graphs
    mock.patch.object(graphs, "routable", lambda var: False).start()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    f32, f64 = torch.float32, torch.float64
    smi = _smi()

    # ---- 1. device and builds -----------------------------------------
    print(f"[1 device] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(7) as pool:       # one nvcc per source, at once
        for fut in [pool.submit(contacts._kernel_fn),
                    pool.submit(contacts._backward_kernel_fn),
                    pool.submit(stream._kernel), pool.submit(gp._kernel),
                    pool.submit(roche._kernel), pool.submit(sweeps._kernel),
                    pool.submit(wd_donor._kernel)]:
            fut.result()
    build_s = time.perf_counter() - t0
    for name in ("contacts", "contacts_backward", "stream", "gp", "roche",
                 "sweeps", "wd_donor"):
        nvcc_s = _build.BUILD_SECONDS.get(name)
        print(f"[1 device] {name}.cu nvcc "
              f"{'cached' if nvcc_s is None else f'{nvcc_s:.2f} s'}")
        for ln in _build.PTXAS_LOGS[name].read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[1 device] ptxas {name}: {ln.strip()}")
    print(f"[1 device] K1, K1's backward, K2, K3, K4-K6, K7, K8 with "
          f"their backward kernels and K9, K10 built and loaded in "
          f"{build_s:.2f} s")
    registers = {}
    for tag, name, n_inst in (("K1", "contacts", 3),
                              ("K1's backward", "contacts_backward", 2),
                              ("K2", "stream", 4), ("K3", "gp", 6),
                              ("K7, K8 and their backward kernels", "sweeps",
                               14)):
        frames = _stack_frames(_build.PTXAS_LOGS[name].read_text())
        registers[name] = {_short_entry(e): r for e, (_, r) in frames.items()}
        print(f"[1 device] {tag} stack frames (bytes) and registers, ptxas: "
              + ", ".join(f"{_short_entry(e)} {b} bytes, {r} registers"
                          for e, (b, r) in sorted(frames.items())))
        _check(len(frames) == n_inst
               and not any(b for b, _ in frames.values()),
               f"a {tag} instantiation keeps an array in local memory")
    _check(not any(int(v) for v in re.findall(
        r"(\d+) bytes spill", _build.PTXAS_LOGS["sweeps"].read_text())),
           "a K7 / K8 instantiation spills")
    # K4-K6: no spill, and no stack frame but the one sin / cos keep for
    # arguments beyond 105615 (ROCHE_FRAMES)
    log = _build.PTXAS_LOGS["roche"].read_text()
    frames = {_short_entry(e): v for e, v in _stack_frames(log).items()}
    registers["roche"] = {e: r for e, (_, r) in frames.items()}
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill", log)]
    print("[1 device] K4-K6 stack frames (bytes) and registers, ptxas: "
          + ", ".join(f"{e} {b} bytes, {r} registers"
                      for e, (b, r) in sorted(frames.items()))
          + f"; spill stores and loads {sum(spills)} bytes; the float64 "
          f"findi kernel's frame is sin / cos's slow-path array (|x| > "
          f"105615, never reached)")
    _check({e: b for e, (b, _) in frames.items()} == ROCHE_FRAMES
           and not any(spills),
           f"roche.cu's stack frames {frames} are not {ROCHE_FRAMES}, or it "
           f"spills")
    occupancy = {e: _roche_warps_per_sm(r)
                 for e, r in registers["roche"].items()}
    print("[1 device] K4-K6 warps an SM (128-thread blocks, from "
          "ptxas's registers): " + ", ".join(
              f"{e} {w}" for e, w in sorted(occupancy.items()))
          + "; groups of 2^d lanes a solve, " + ", ".join(
              f"{n} d {_roche_depth(n)}" for n in ROCHE_DEPTH_MACROS))
    _check(all(w >= 8 for w in occupancy.values()),
           f"a K4-K6 instantiation fits fewer than 8 warps an SM: "
           f"{occupancy}")
    # K9 and K10: frames and spills as WD_DONOR_FRAMES
    wd_frames = {_short_entry(e): (v["frame"], v["spill"], v["registers"])
                 for e, v in _ptxas_entries(
                     _build.PTXAS_LOGS["wd_donor"].read_text()).items()}
    registers["wd_donor"] = {e: r for e, (_, _, r) in wd_frames.items()}
    print("[1 device] K9 and K10 stack frames, spills (bytes) and "
          "registers, ptxas: " + ", ".join(
              f"{e} {f} / {sp} bytes, {r} registers"
              for e, (f, sp, r) in sorted(wd_frames.items()))
          + "; K10's frames are sin / cos's slow-path arrays (never "
          "reached)")
    _check({e: (f, sp) for e, (f, sp, _) in wd_frames.items()}
           == WD_DONOR_FRAMES, f"wd_donor.cu's stack frames and spills "
           f"{wd_frames} are not {WD_DONOR_FRAMES}")

    sys.path.insert(0, str(ROOT / "tools"))
    from k1_sass_counts import built_sass, counts
    k1_counted = {k: {c: v[c] for c in ("element", "eclipsed")}
                  for k, v in counts(built_sass()).items()}
    print(f"[1 device] K1 executes, from its SASS: {json.dumps(k1_counted)}")
    _check(k1_counted == K1_EXECUTED, "K1_EXECUTED is not this build's "
           "count (tools/k1_sass_counts.py)")
    import wd_donor_sass_counts

    wd_sass = {k: v["issue_cycles"] for k, v in wd_donor_sass_counts.counts(
        wd_donor_sass_counts.built_sass()).items()}
    print("[1 device] K9 / K10 instructions a solve / a point on the north "
          "star's path (SASS, tools/wd_donor_sass_counts.py): "
          + json.dumps(wd_sass))
    _check(wd_sass == WD_DONOR_SASS_PER_POINT, "WD_DONOR_SASS_PER_POINT is "
           "not this build's count (tools/wd_donor_sass_counts.py)")

    # ---- the north-star model and 1024 walkers around its start -------
    t0 = time.perf_counter()
    model = build_model(n_eclipses=5, complex_spot=[False] * 5,
                        n_points=128, bands=("g", "r")).compile()
    start = model.var_start()
    pos = _walkers(start, N_WALKERS, 0, f32, dev)
    lp32 = make_ln_prob(model, dtype=f32, device=dev)
    print(f"[model] 5 eclipses x 128 points, 2 bands, D = {start.size}; "
          f"built on the host in {time.perf_counter() - t0:.1f} s")
    _check(make_ln_prob(model, dtype=f32).flux.device.type == "cuda",
           "make_ln_prob does not default to the card")

    # ---- 2. K1 vs plain on the main path's own contact rows -----------
    with mock.patch.object(contacts, "element_intervals_kernel",
                           wraps=contacts.element_intervals_kernel) as rec, \
            _roche_wrappers(roche, lambda n, w: mock.MagicMock(
                wraps=w)) as rec_roche, \
            _sweep_wrappers(sweeps) as rec_sweeps, \
            _wd_wrappers(wd_donor) as rec_wd:
        lp_kernel = lp32(pos)
    _check(rec.call_count == 1, f"K1 called {rec.call_count} times per eval")
    # K9's and K10's inputs on the main path: the donor grid, the white
    # dwarf's curve (K10's distance mode: the GP evaluation's below)
    _check([rec_wd[n].call_count for n in rec_wd] == [1, 1, 0],
           f"K9 / K10 calls per eval: "
           f"{ {n: r.call_count for n, r in rec_wd.items()} }")
    wd_args = {n: (r.call_args.args, r.call_args.kwargs)
               for n, r in rec_wd.items() if r.call_count}
    _check(tuple(wd_args["donor_grid"][0][0].shape) == (N_WALKERS,)
           and wd_args["donor_grid"][1].get("grid") is True
           and tuple(wd_args["wd_curve"][0][2].shape) == (N_WALKERS, 5, 128),
           "K9 / K10 inputs of the north star (K9 to write the grid): "
           f"{wd_args['donor_grid'][1]}, "
           f"{[tuple(a.shape) for a in wd_args['wd_curve'][0]]}")
    # K7's and K8's inputs on the main path: the disc and the spot, the
    # donor curve and its normaliser
    sweep_args = {n: [c.args for c in r.call_args_list]
                  for n, r in rec_sweeps.items()}
    _check([len(sweep_args[n]) for n in ("element_curve", "donor_sum")]
           == [2, 2] and tuple(sweep_args["element_curve"][0][0].shape)
           == (N_WALKERS * 5, 128),
           f"K7 / K8 calls per eval: "
           f"{ {n: len(a) for n, a in sweep_args.items()} }")
    # K4-K6's inputs on the main path: the first call of each
    roche_args = {name: r.call_args_list[0].args
                  for name, r in rec_roche.items()}
    _check(all(r.call_count >= 1 for r in rec_roche.values())
           and tuple(roche_args["findi"][0].shape) == (N_WALKERS,),
           f"K4-K6 calls per eval: "
           f"{ {n: r.call_count for n, r in rec_roche.items()} }")
    args = rec.call_args.args
    rows, n = args[2].shape
    _check((rows, n) == (N_WALKERS * 5, 512),
           f"contact rows {rows} x {n}, expected 5120 x 512")
    k_out = contacts.element_intervals_kernel(*args)
    p_out = contacts.element_intervals_plain(*args)
    torch.cuda.synchronize()
    flag_diff = (k_out[2] != p_out[2]).float().mean().item()
    both = k_out[2] & p_out[2]
    err_in = (k_out[0] - p_out[0]).abs()[both].max().item()
    err_out = (k_out[1] - p_out[1]).abs()[both].max().item()
    k1_err = max(err_in, err_out)
    n_ecl = int(both.sum().item())
    print(f"[2 K1] {rows} x {n} contacts, {n_ecl} eclipsed in both; flag "
          f"disagreement {flag_diff:.3e} (limit 1e-4); max |dphi| "
          f"{k1_err:.3e} cycles (limit 1e-5)")
    _check(flag_diff <= 1e-4, "K1 eclipsed flags disagree with plain")
    _check(k1_err <= 1e-5, "K1 contact phases disagree with plain")
    k1_ms = _event_ms(lambda: contacts.element_intervals_kernel(*args), 20)
    k1_plain_ms = _event_ms(lambda: contacts.element_intervals_plain(*args), 5)
    n_el, n_ecl_k = rows * n, int(k_out[2].sum().item())
    f_ecl = n_ecl_k / n_el
    k1_ops = n_el * K1_OPS_ELEMENT + n_ecl_k * K1_OPS_ECLIPSED
    # px, py in; phi_in, phi_out, eclipsed out; six scalars per row
    k1_bytes = n_el * (4 + 4 + 4 + 4 + 1) + rows * 6 * 4
    k1_bound, k1_by = _bound(k1_ops, k1_bytes)
    print(f"[2 K1] time per call: kernel {k1_ms:.4f} ms, plain "
          f"{k1_plain_ms:.4f} ms ({k1_plain_ms / k1_ms:.1f}x)")
    print(f"[2 K1] eclipsed share f = {f_ecl:.6f} ({n_ecl_k} of {n_el}); "
          f"{k1_ops / 1e9:.3f} GFLOP ({K1_OPS_ELEMENT} per element + "
          f"{K1_OPS_ECLIPSED} per eclipsed one), {k1_bytes / 1e6:.1f} MB; "
          f"bound {k1_bound * 1e3:.1f} us (set by {k1_by}); the kernel at "
          f"{k1_bound / k1_ms:.1%} of its bound")
    k1_ex = _executed("contacts_kernel<f32>", n_el, n_ecl_k)
    print(f"[2 K1] {_executed_line('contacts_kernel<f32>', k1_ex, k1_ms)}")
    with torch.inference_mode():
        cvp = model.cv_params(model.full_from_var(pos))
        q = cvp[:, 0, 4].contiguous()
        x1 = xl1(q)
        rd = (cvp[..., 6] * x1[:, None]).contiguous()
    n_steps = lp32.stream_steps
    sub = [t[:N_CHAINS] for t in (q, rd, x1)]
    # the GP model (the same tree, use_gp on every eclipse) and the series
    # one evaluation of it hands K3
    gp_spec = dict(n_eclipses=5, complex_spot=[False] * 5, use_gp=True,
                   n_points=128, bands=("g", "r"))
    model_gp = build_model(**gp_spec).compile()
    start_gp = model_gp.var_start()
    pos_gp = _walkers(start_gp, N_WALKERS, 0, f32, dev)
    lp_gp32 = make_ln_prob(model_gp, dtype=f32, device=dev)
    with mock.patch.object(gp, "segmented_matern32_kernel",
                           wraps=gp.segmented_matern32_kernel) as rec, \
            _wd_wrappers(wd_donor) as rec_wd:
        lp_gp_kernel = lp_gp32(pos_gp)
    _check(rec.call_count == 1, f"K3 called {rec.call_count} times per eval")
    _check([rec_wd[n].call_count for n in rec_wd]
           == [1, 1, WD_GP_CHANGEPOINTS],
           f"K9 / K10 calls per GP eval: "
           f"{ {n: r.call_count for n, r in rec_wd.items()} }")
    wd_args["wd_distance"] = (rec_wd["wd_distance"].call_args_list[0].args,
                              {})
    gp_args, gp_kw = rec.call_args.args, rec.call_args.kwargs
    n_w, n_e, n_p = gp_args[1].shape
    _check((n_w, n_e, n_p) == (N_WALKERS, 5, 128),
           f"GP series {n_w} x {n_e} x {n_p}, expected 1024 x 5 x 128")
    # the GP model with exposure widths, and the series one gradient
    # evaluation of it hands K3 and its reverse kernel
    model_gpw = with_calib_widths(build_model(**gp_spec)).compile()
    lp_gpw = make_ln_prob(model_gpw, dtype=f32, device=dev)
    pos_gpw = _walkers(start_gp, N_CHAINS, 1, f32, dev)
    with mock.patch.object(gp, "segmented_matern32_kernel",
                           wraps=gp.segmented_matern32_kernel) as rec, \
            mock.patch.object(contacts, "element_intervals_diff",
                              wraps=contacts.element_intervals_diff) as rec_c, \
            _sweep_wrappers(sweeps) as rec_sweeps:
        lp_gpw.value_and_grad(pos_gpw)
    sweep_bwd_args = {n: [c.args for c in r.call_args_list]
                      for n, r in rec_sweeps.items()}
    _check([len(sweep_bwd_args[n]) for n in (
        "element_curve", "element_curve_backward", "donor_sum",
        "donor_sum_backward")] == [2, 2, 2, 2]
           and sweep_bwd_args["element_curve_backward"][0][1] is not None,
           f"K7 / K8 and their backward kernels per gradient eval: "
           f"{ {n: len(a) for n, a in sweep_bwd_args.items()} }")
    _check(rec.call_count == 1, "K3 not called once per gradient evaluation")
    _check(rec_c.call_count == 1, "element_intervals_diff not called once")
    ga = [a.detach() for a in rec.call_args.args]
    gk = rec.call_args.kwargs
    # that evaluation's contact rows, for one forward and backward of K1
    crow_p = [a.detach() for a in rec_c.call_args.args]
    _check(tuple(crow_p[2].shape) == (N_CHAINS * 5, 512) and crow_p[2].is_cuda,
           f"gradient contact rows {tuple(crow_p[2].shape)}, expected "
           f"1280 x 512")
    leaves_p = [a.requires_grad_() for a in crow_p[:6]]
    cot_p = torch.ones_like(crow_p[2])

    def k1_fwd_bwd():
        with torch.enable_grad():
            pin, pout, _ = contacts.element_intervals_diff(*leaves_p,
                                                           crow_p[6])
        torch.autograd.grad([pin, pout], leaves_p, [cot_p, cot_p])

    _check(tuple(ga[1].shape) == (N_CHAINS, 5, 128) and ga[1].is_cuda,
           f"gradient GP series {tuple(ga[1].shape)}, expected 256 x 5 x 128")
    cot_g = torch.ones(ga[1].shape[:2], dtype=f32, device=dev)

    def k3_fwd_bwd():
        _k3_grads(gp.segmented_matern32_kernel, ga, gk, cot_g)

    events, device_us = _launches_per_call({
        "K3 with its reverse pass": k3_fwd_bwd,
        "K1 with its backward": k1_fwd_bwd,
        "K1": lambda: contacts.element_intervals_kernel(*args),
        "K2": lambda: stream.stream_impacts_kernel(q, rd, x1, n_steps),
        "K2 with sensitivities": lambda: stream.stream_impacts_kernel(
            *sub, n_steps, with_sens=True),
        "K3": lambda: gp.segmented_matern32_kernel(*gp_args, **gp_kw),
        **{f"K{k} {name}": (lambda name=name: getattr(
            roche, f"{name}_kernel")(*roche_args[name]))
           for k, name in ((4, "findi"), (5, "xl1"), (6, "lobe_radius"))},
        **{tag: (lambda name=name, a=a: getattr(
            sweeps, f"{name}_kernel")(*a))
           for tag, name, a in _sweep_calls(sweep_args, sweep_bwd_args)},
        **{f"{tag} float64": (lambda name=name, a=_cast(a, f64): getattr(
            sweeps, f"{name}_kernel")(*a))
           for tag, name, a in _sweep_calls(sweep_args, sweep_bwd_args)},
        **{f"{tag}{d}": (lambda name=name, a=(_cast(wd_args[name][0], dt),
                                              wd_args[name][1]):
                         getattr(wd_donor, f"{name}_kernel")(*a[0], **a[1]))
           for tag, name in _WD_CALLS
           for d, dt in (("", f32), (" float64", f64))}})
    k1_launch = _check_launches("K1", events["K1"], "contacts_kernel")
    roche_launch, roche_us = {}, {}
    for k, name in ((4, "findi"), (5, "xl1"), (6, "lobe_radius")):
        tag = f"K{k} {name}"
        roche_launch[name] = _check_launches(tag, events[tag],
                                             f"{name}_kernel")
        roche_us[name] = sum(device_us[tag].values())
        _check(roche_launch[name][1] == 1, f"a {tag} call runs device "
               f"kernels besides {name}_kernel: "
               f"{[nm[:60] for nm in events[tag]]}")
    sweep_launch, sweep_us = {}, {}
    for tag, name in [(t + d, n) for t, n, _ in _sweep_calls(
            sweep_args, sweep_bwd_args) for d in ("", " float64")]:
        sweep_launch[tag] = _check_launches(tag, events[tag],
                                            f"{name}_kernel")
        sweep_us[tag] = sum(device_us[tag].values())
        _check(sweep_launch[tag][1] == 1, f"a {tag} call runs device "
               f"kernels besides {name}_kernel: "
               f"{[nm[:60] for nm in events[tag]]}")
    wd_launch, wd_us = {}, {}
    for tag, name in _WD_CALLS:
        kernel = "donor_grid_kernel" if name == "donor_grid" else (
            "wd_curve_kernel")
        for d in ("", " float64"):
            wd_launch[tag + d] = _check_launches(tag + d, events[tag + d],
                                                 kernel)
            wd_us[tag + d] = sum(device_us[tag + d].values())
            _check(wd_launch[tag + d][1] == 1, f"a {tag + d} call runs "
                   f"device kernels besides {kernel}: "
                   f"{[nm[:60] for nm in events[tag + d]]}")
    k2_launch = {sens: _check_launches(tag, events[tag], "stream_kernel")
                 for sens, tag in ((False, "K2"),
                                   (True, "K2 with sensitivities"))}
    k3_launch = _check_launches("K3", events["K3"], "gp_kernel")
    _check(k3_launch[1] == 1, "a K3 call runs device kernels besides "
           f"gp_kernel: {[nm[:60] for nm in events['K3']]}")
    ev = events["K1 with its backward"]
    k1_bwd_launch = [sum(bool(re.search(rf"\b{k}\b", nm)) for nm in ev)
                     for k in ("contacts_kernel", "contacts_backward_kernel")]
    k1_bwd_events = len(ev)
    k1_bwd_copies = sum(nm.startswith(("Memcpy", "Memset")) for nm in ev)
    print(f"[2 launches] K1 with its backward, one forward and backward of "
          f"element_intervals_diff: {k1_bwd_launch[0]} contacts_kernel and "
          f"{k1_bwd_launch[1]} contacts_backward_kernel launch, "
          f"{k1_bwd_events} device events in all, {k1_bwd_copies} copies or "
          f"sets; the events: "
          + ", ".join(f"{nm[:48]} {us:.1f} us" for nm, us in
                      device_us["K1 with its backward"].items()))
    _check(k1_bwd_launch == [1, 1] and k1_bwd_copies == 0,
           "a K1 forward and backward is not one launch of each kernel "
           f"without copies: {[nm[:60] for nm in ev]}")
    ev = events["K3 with its reverse pass"]
    k3_bwd_launch = [sum(bool(re.search(rf"\b{k}\b", nm)) for nm in ev)
                     for k in ("gp_kernel", "gp_backward_kernel")]
    print(f"[2 launches] K3 with its reverse pass, one forward and backward "
          f"of the wrapper: {k3_bwd_launch[0]} gp_kernel and "
          f"{k3_bwd_launch[1]} gp_backward_kernel launch, {len(ev)} device "
          f"events in all (limit 3: the kernels make the angles and the "
          f"decay themselves; the rest PyTorch's), "
          f"{sum(nm.startswith(('Memcpy', 'Memset')) for nm in ev)} copies "
          f"or sets: " + ", ".join(nm[:40] for nm in ev))
    _check(k3_bwd_launch == [1, 1], "a K3 forward and backward is not one "
           f"launch of each kernel: {[nm[:60] for nm in ev]}")
    _check(len(ev) <= 3, f"a K3 forward and backward is {len(ev)} device "
           "events, more than 3")
    k3_bwd_events = len(ev)

    def traced_us(call, kernel):
        return sum(us for nm, us in device_us[call].items()
                   if re.search(rf"\b{kernel}\b", nm))

    # device time of the kernels alone, as the profiler traced them (a
    # loop of such short calls timed with events reads the host's pace)
    k3_us = {"forward": traced_us("K3", "gp_kernel"),
             "forward_recorded": traced_us("K3 with its reverse pass",
                                           "gp_kernel"),
             "backward": traced_us("K3 with its reverse pass",
                                   "gp_backward_kernel"),
             "call": sum(device_us["K3"].values()),
             "forward_backward_call": sum(
                 device_us["K3 with its reverse pass"].values())}
    k1_bwd_us = traced_us("K1 with its backward", "contacts_backward_kernel")
    print(f"[2 launches] K1's backward as traced: contacts_backward_kernel "
          f"{k1_bwd_us:.1f} us, contacts_kernel "
          f"{traced_us('K1 with its backward', 'contacts_kernel'):.1f} us, of "
          f"{sum(device_us['K1 with its backward'].values()):.1f} us for the "
          f"forward and backward call")
    print(f"[2 launches] K3's device time as traced: gp_kernel on {n_w * n_e} "
          f"series {k3_us['forward']:.1f} us of the call's "
          f"{k3_us['call']:.1f} us; on {N_CHAINS * 5} series with the state "
          f"kept {k3_us['forward_recorded']:.1f} us, gp_backward_kernel "
          f"{k3_us['backward']:.1f} us, of {k3_us['forward_backward_call']:.1f}"
          f" us for the forward and backward call")

    # ---- 3. posterior: kernel path vs plain path ----------------------
    def plain_path(fn):
        with mock.patch.object(contacts, "element_intervals_kernel",
                               contacts.element_intervals_plain), \
                mock.patch.object(contacts, "element_intervals_mixed_kernel",
                                  contacts.element_intervals_plain), \
                mock.patch.object(contacts, "contact_backward_kernel",
                                  contacts._contact_backward_plain):
            return fn()

    lp_plain = plain_path(lambda: lp32(pos))
    fin_k, fin_p = torch.isfinite(lp_kernel), torch.isfinite(lp_plain)
    _check(bool((fin_k == fin_p).all()), "finite/-inf pattern differs")
    _check(int(fin_k.sum()) > N_WALKERS // 2, "most walkers are -inf")
    fk = lp32.model_flux(pos)
    fp = plain_path(lambda: lp32.model_flux(pos))
    dflux = (fk - fp).abs()[fin_k]
    f_max, f_med = dflux.max().item(), dflux.median().item()
    print(f"[3 posterior] {int(fin_k.sum())}/{N_WALKERS} walkers finite "
          f"in both paths; model flux |kernel - plain| max {f_max:.3e} "
          f"(limit 2e-4), median {f_med:.3e} (limit 1e-6)")
    _check(f_max <= 2e-4 and f_med <= 1e-6, "posterior fluxes disagree")

    # host-clock times drift within a run: the two paths in turns (plain,
    # kernel, kernel, plain), the least of each
    torch.cuda.reset_peak_memory_stats()
    turns = {"plain": [], "kernel": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        def run():
            return _sync_time(lambda: lp32(pos), 2)
        turns[path].append(plain_path(run) if path == "plain" else run())
    peak = torch.cuda.max_memory_allocated()
    ms_kernel, ms_plain = min(turns["kernel"]), min(turns["plain"])
    ms_stream = _event_ms(lambda: stream.stream_impacts_kernel(
        q, rd, x1, n_steps), 5)
    busy_us, n_kern, wall_us, _ = _device_kernels(lambda: lp32(pos))
    _zero_counts(contacts, stream, gp)
    lp32(pos)
    c_eval = _counts(contacts, stream, gp)
    print(f"[3 posterior] one evaluation at {N_WALKERS} walkers: {n_kern} "
          f"device kernels (1222 with the eager chains), {busy_us / 1e3:.3f} "
          f"device ms; K9 "
          f"{c_eval['k9']} and K10 {c_eval['k10']} launches (the donor grid, "
          f"the white dwarf's curve); {smi}")
    _check(n_kern < 1222 and all(c_eval[k] == v for k, v in
                                 WD_DONOR_PER_EVAL.items()),
           f"the forward evaluation: {n_kern} device kernels (not fewer "
           f"than 1222), K9 / K10 launches {c_eval['k9']} / "
           f"{c_eval['k10']}")
    print(f"[3 posterior] ms per eval at {N_WALKERS} walkers: kernel path "
          f"{ms_kernel:.1f} (turns {turns['kernel'][0]:.1f}, "
          f"{turns['kernel'][1]:.1f}), plain contact path {ms_plain:.1f} "
          f"(turns {turns['plain'][0]:.1f}, {turns['plain'][1]:.1f}); "
          f"stream scan (K2, {n_steps} steps) alone {ms_stream:.3f} ms = "
          f"{ms_stream / ms_kernel:.1%} of the kernel path; peak device "
          f"memory {peak / 2**30:.2f} GiB; device-busy share of one eval "
          f"{_busy_line(busy_us, n_kern, wall_us)}")

    # ---- 4. f32 parity vs the f64 plain path; f64 vs golden ------------
    # identical f32-representable parameter vectors in both precisions
    sub32 = pos[:64]
    sub64 = sub32.to(f64)
    lp64 = make_ln_prob(model, dtype=f64, device=dev)
    f_64 = lp64.model_flux(sub64)
    f_32 = lp32.model_flux(sub32).to(f64)
    ok = torch.isfinite(lp64(sub64))
    scale = f_64.abs().amax(dim=-1, keepdim=True)
    rel = ((f_32 - f_64).abs() / scale)[ok].flatten().cpu().numpy()
    print(f"[4 parity] f32 kernel path vs f64 plain path, {int(ok.sum())} "
          f"walkers x 5 eclipses x 128 phases, relative flux error: median "
          f"{np.median(rel):.2e}, p99 {np.percentile(rel, 99):.2e}, max "
          f"{rel.max():.2e}")
    # median and p99 against the 1e-6 gate's scale; the max is a graze
    # flip: one element's contact phase within f32 error of a data phase
    # moves that element's whole weight at that phase (a bright-spot
    # element carries up to ~2e-2 of the peak flux)
    _check(np.median(rel) < 1e-6 and np.percentile(rel, 99) < 1e-4
           and rel.max() < 5e-2, "f32 parity")
    golden = np.load(ROOT / "tests" / "golden" / "golden_v1.npz")
    cfg = CVConfig(n_disc_rad=8, n_disc_az=12, n_spot=12, n_donor_lat=8,
                   n_donor_lon=12)
    simple = [0.1, 0.05, 0.08, 0.03, 0.15, 0.04, 0.44, 0.3, 0.01, 0.02,
              160.0, 0.2, 1.5, 0.0]
    phases = torch.linspace(-0.15, 0.15, 61, dtype=f64, device=dev)
    worst = 0.0
    for tag, pars, cplx in (("simple", simple, False),
                            ("complex", simple + [2.0, 1.3, 80.0, 15.0],
                             True)):
        with torch.inference_mode():
            out = cv_fluxes(torch.tensor(pars, dtype=f64, device=dev),
                            phases, config=cfg._replace(complex_spot=cplx))
        for name in ("total", "ywd", "ydisc", "yspot", "ysec"):
            ref = golden[f"{tag}_{name}"]
            got = getattr(out, name).cpu().numpy()
            worst = max(worst, float(np.max(
                np.abs(got - ref) / np.maximum(np.abs(ref), 1e-12))))
    print(f"[4 golden] f64 cv_fluxes on the card vs golden_v1.npz: max "
          f"relative error {worst:.2e} (limit 1e-9)")
    _check(worst <= 1e-9, "f64 fluxes drifted from golden")

    # ---- 5. the ensemble sampler: a main path --------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    start_t = torch.tensor(start, dtype=f32, device=dev)
    scatter = 1e-3 * torch.clamp(start_t.abs(), min=1e-2)
    _zero_counts(contacts, stream, gp)
    t0 = time.perf_counter()
    state = init_walkers(gen, start_t, scatter, lp32, N_WALKERS)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    c_init = _counts(contacts, stream, gp)
    n_ens = 3
    t0 = time.perf_counter()
    state, chain, chain_lp, acc = run_sampler(state, lp32, n_ens, gen)
    torch.cuda.synchronize()
    s_step = (time.perf_counter() - t0) / n_ens
    c_ens = _counts(contacts, stream, gp)
    k1_steps = c_ens["k1"] - c_init["k1"]
    k2_steps = c_ens["k2"] - c_init["k2"]
    acc_mean = acc.mean().item()
    print(f"[5 sampler] init_walkers {t_init:.2f} s ({c_init['k1']} K1, "
          f"{c_init['k2']} K2 launches); {n_ens} steps at {s_step:.3f} "
          f"s/step; acceptance {acc_mean:.3f}; launches in the steps: K1 "
          f"{k1_steps}, K2 {k2_steps} (2 each per step expected)")
    _check(bool(torch.isfinite(state.log_prob).all()), "non-finite log_prob")
    _check(0.0 < acc_mean < 1.0, "acceptance fraction outside (0, 1)")
    _check(k1_steps == 2 * n_ens, "K1 did not launch once per half-step")
    _check(k2_steps == 2 * n_ens, "K2 did not launch once per half-step")
    _check(c_ens["k4"] - c_init["k4"] == c_ens["k5"] - c_init["k5"]
           == 2 * n_ens, "K4 / K5 did not launch once per half-step")
    _check(c_ens["k6"] - c_init["k6"] == 2 * n_ens * ROCHE_PER_EVAL["k6"],
           "K6 did not launch once per half-step")
    _check(all(c_ens[k] - c_init[k] == 2 * n_ens * v
               for k, v in WD_DONOR_PER_EVAL.items()),
           f"K9 / K10 not once per half-step: {_delta(c_ens, c_init)}")
    _check(all(c_ens[k] - c_init[k] == 2 * n_ens * v
               for k, v in SWEEPS_PER_EVAL.items())
           and c_ens["k7_bwd"] == c_ens["k8_bwd"] == 0,
           f"K7 / K8 not twice per half-step: {_delta(c_ens, c_init)}")
    _check(c_ens["k1_bwd"] == 0 and c_ens["k1_bwd_kernel"] == 0
           and c_ens["k2_sens"] == 0,
           "the ensemble path ran a gradient")
    _check(tuple(chain.shape) == (n_ens, N_WALKERS, start.size),
           "chain shape")

    # ---- 6. K2 vs plain on the north-star stream inputs ----------------
    k2, k2_bound = {}, {}
    n_rad = rd.shape[1]
    for dt in (f32, f64):
        for w, sens in ((N_WALKERS, False), (N_CHAINS, True)):
            a = [t[:w].to(dt).contiguous() for t in (q, rd, x1)]
            k2[dt, sens] = _k2_against_plain(stream, *a, n_steps, sens)
            imp_err, jac, ms, pms = k2[dt, sens]
            name, isz = str(dt)[6:], a[0].element_size()
            ops = w * n_steps * (K2_OPS_STEP
                                 + (2 * K2_OPS_STEP_COLUMN if sens else 0))
            nbytes = isz * (w * (2 + n_rad) + w * n_rad * 2 * (4 if sens
                                                               else 1))
            k2_bound[dt, sens] = _bound(ops, nbytes, name)
            jtxt = ("; max |dJ|: jq {:.2e}, jx0 {:.2e}, jrd {:.2e}"
                    .format(*jac) if sens else "")
            print(f"[6 K2] {name} {w} walkers x {n_rad} radii, {n_steps} "
                  f"steps{', sensitivities' if sens else ''}: max "
                  f"|d impact| {imp_err:.2e}{jtxt}; kernel {ms:.4f} ms "
                  f"({ms / n_steps * 1e6:.1f} ns per step), plain "
                  f"{pms:.1f} ms ({pms / ms:.0f}x); bound "
                  f"{k2_bound[dt, sens][0] * 1e3:.2f} us ({ops / 1e9:.3f} "
                  f"G{name} ops, set by {k2_bound[dt, sens][1]}): the kernel "
                  f"at {k2_bound[dt, sens][0] / ms:.2%} of its bound")
            # the same operations in the same order: bit for bit
            _check(imp_err == 0.0,
                   f"K2 impacts differ from plain ({dt}, sens={sens})")
            _check(all(j == 0.0 for j in jac),
                   f"K2 Jacobians differ from plain ({dt})")

    # ---- 7. the gradient on the widths model ---------------------------
    model_w = with_calib_widths(build_model(
        n_eclipses=5, complex_spot=[False] * 5, n_points=128,
        bands=("g", "r"))).compile()
    lpw = make_ln_prob(model_w, dtype=f32, device=dev)
    _check(lpw.width is not None, "the widths model has no widths")
    width = float(np.asarray(model_w.data_width).max())
    posw = _walkers(start, N_CHAINS, 1, f32, dev)
    lpw.value_and_grad(posw)                          # warm the allocator
    _zero_counts(contacts, stream, gp)
    lp_g, g_k = lpw.value_and_grad(posw)
    c_one = _counts(contacts, stream, gp)
    print(f"[7 grad] widths model (width {width:.6f} cycles), {N_CHAINS} "
          f"chains: one value_and_grad launched K1 {c_one['k1']}, K1 "
          f"backward {c_one['k1_bwd']} (its kernel "
          f"{c_one['k1_bwd_kernel']}), K2 {c_one['k2']} (with "
          f"sensitivities {c_one['k2_sens']})")
    _check(c_one == {"k1": 1, "k1_f64": 0, "k1_mixed": 0, "k1_bwd": 1,
                     "k1_bwd_kernel": 1, "k2": 1, "k2_sens": 1, "k3": 0,
                     "k3_bwd": 0, **ROCHE_PER_EVAL, **SWEEPS_PER_GRAD,
                     **WD_DONOR_PER_GRAD},
           "K1's backward kernel or K2's sensitivities not once per "
           "evaluation")
    _check(bool(torch.isfinite(lp_g).all()), "a chain's ln p is not finite")
    _check(bool(torch.isfinite(g_k).all()), "a gradient is not finite")
    _check(bool((g_k.abs().amax(dim=-1) > 0).all()), "a zero gradient row")
    torch.cuda.reset_peak_memory_stats()
    vg_turns, fwd_turns = [], []
    for _ in range(2):
        vg_turns.append(_sync_time(lambda: lpw.value_and_grad(posw), 1))
        fwd_turns.append(_sync_time(lambda: lpw(posw), 1))
    peak_g = torch.cuda.max_memory_allocated()
    vg_ms, fwd_ms = min(vg_turns), min(fwd_turns)
    print(f"[7 grad] ms per value_and_grad {vg_ms:.1f} (turns "
          f"{vg_turns[0]:.1f}, {vg_turns[1]:.1f}); forward alone "
          f"{fwd_ms:.1f} ms; peak device memory {peak_g / 2**30:.2f} GiB")

    # K1's backward alone, on the main path's own contact rows
    with mock.patch.object(contacts, "element_intervals_diff",
                           wraps=contacts.element_intervals_diff) as rec:
        lpw.value_and_grad(posw)
    _check(rec.call_count == 1, "element_intervals_diff not called once")
    crow = [a.detach() for a in rec.call_args.args]
    cot = torch.randn(crow[2].shape, generator=torch.Generator(
        device=dev).manual_seed(1), dtype=f32, device=dev)

    def k1_fwd(bwd):
        leaves = [a.clone().requires_grad_() for a in crow[:6]]
        with torch.enable_grad():
            pin, pout, _ = contacts.element_intervals_diff(*leaves, crow[6])
            if bwd:
                torch.autograd.grad((pin * cot + pout * cot).sum(), leaves)

    k1_bwd_ms = _event_ms(lambda: k1_fwd(True), 5) - _event_ms(
        lambda: k1_fwd(False), 5)
    k1_ecl = contacts.element_intervals_kernel(*crow)
    n_ecl_g = int(k1_ecl[2].sum().item())
    n_el_g = crow[2].numel()
    bwd_ops = 2 * n_ecl_g * K1_BWD_OPS_EDGE + n_el_g * K1_BWD_OPS_ELEMENT
    # the kernel sweeps the edges of eclipsed elements and of those with a
    # non-finite input
    row_ok = (torch.isfinite(crow[0]) & torch.isfinite(crow[1])
              & torch.isfinite(crow[4]))[:, None]
    swept = k1_ecl[2] | ~(row_ok & torch.isfinite(crow[2])
                          & torch.isfinite(crow[3])
                          & torch.isfinite(k1_ecl[0])
                          & torch.isfinite(k1_ecl[1]))
    n_swept = int(swept.sum().item())
    bwd_ops_run = (2 * n_swept * K1_BWD_EXECUTED_EDGE
                   + n_el_g * K1_BWD_EXECUTED_ELEMENT)
    # px, py, both phases, both cotangents and the flags in; d px, d py out
    bwd_bytes = n_el_g * (6 * 4 + 1 + 2 * 4)
    k1_bwd_bound, k1_bwd_by = _bound(bwd_ops, bwd_bytes)
    k1_bwd_run_bound, _ = _bound(bwd_ops_run, bwd_bytes)

    # the backward kernel against its plain version (autograd on the edge
    # residual) on those rows, at the roots K1 found, with that cotangent
    # on both edges: float64 (the kernel's arithmetic), then float32 (what
    # the main paths run) with the float64 plain backward as referee
    b32 = [*crow[:6], k1_ecl[0], k1_ecl[1], k1_ecl[2], cot, cot]
    b64, rel64, k1_bwd_err = _k1_backward_against_plain(
        "[7 K1 backward]", contacts, b32)
    k1_bwd_kernel_ms = _event_ms(
        lambda: contacts.contact_backward_kernel(*b32), 20)
    k1_bwd_kernel64_ms = _event_ms(
        lambda: contacts.contact_backward_kernel(*b64), 20)
    k1_bwd_plain_ms = _event_ms(
        lambda: contacts._contact_backward_plain(*b32), 3, 1)
    print(f"[7 grad] K1's backward on {crow[2].shape[0]} x "
          f"{crow[2].shape[1]} contacts: the backward pass of "
          f"element_intervals_diff {k1_bwd_ms:.3f} ms = "
          f"{k1_bwd_ms / vg_ms:.2%} of a gradient evaluation; "
          f"contacts_backward_kernel alone {k1_bwd_kernel_ms:.4f} ms in an "
          f"event-timed loop ({k1_bwd_us:.1f} us traced in phase 2), float64 "
          f"{k1_bwd_kernel64_ms:.4f} ms; its plain version "
          f"{k1_bwd_plain_ms:.2f} ms ({k1_bwd_plain_ms / k1_bwd_kernel_ms:.0f}"
          f"x); {n_ecl_g} eclipsed; the function needs {bwd_ops / 1e9:.3f} "
          f"GFLOP ({K1_BWD_OPS_EDGE} per eclipsed edge + "
          f"{K1_BWD_OPS_ELEMENT} per element), {bwd_bytes / 1e6:.1f} MB: "
          f"bound {k1_bwd_bound * 1e3:.1f} us (set by {k1_bwd_by}), the "
          f"kernel at {k1_bwd_bound / k1_bwd_kernel_ms:.2%} of it "
          f"({k1_bwd_bound * 1e3 / max(k1_bwd_us, 1e-9):.2%} of its traced "
          f"time); the "
          f"kernel executes {bwd_ops_run / 1e9:.3f} GFLOP "
          f"({K1_BWD_EXECUTED_EDGE} per edge of the {n_swept} elements it "
          f"sweeps in reverse mode + {K1_BWD_EXECUTED_ELEMENT} per element), "
          f"ptxas registers {registers['contacts_backward']}, "
          f"{k1_bwd_run_bound * 1e3:.1f} us at the peak rate: "
          f"{k1_bwd_run_bound / k1_bwd_kernel_ms:.1%} of that")

    # the gradient on the K1 path against the plain contact path, with
    # the float64 gradient as referee
    lpw64 = make_ln_prob(model_w, dtype=f64, device=dev)
    g_k, g64 = _grads_agree("[7 grad]", lpw, lpw64, posw, plain_path,
                            contacts)
    g_k64 = g_k.to(f64)

    # float32 against float64
    cos = ((g_k64 * g64).sum(-1) / (g_k64.norm(dim=-1) * g64.norm(dim=-1)))
    relc = ((g_k64 - g64).abs() / g64.abs().clamp(min=1e-30)).median(
        dim=0).values
    frac_ok = (cos >= 0.999).double().mean().item()
    print(f"[7 grad] f32 vs f64 at {N_CHAINS} chains: per-component median "
          f"relative error: median {relc.median().item():.2e}, max "
          f"{relc.max().item():.2e}; cosine min {cos.min().item():.6f}, "
          f"median {cos.median().item():.8f}; {frac_ok:.0%} of chains at "
          f"cosine >= 0.999 (limit 95%)")
    _check(frac_ok >= 0.95, "f32 gradients point away from f64")

    # where one gradient evaluation's device time goes
    busy_g, n_kg, wall_g, by_name = _device_kernels(
        lambda: lpw.value_and_grad(posw))
    print(f"[7 grad] device-busy share of one value_and_grad "
          f"{_busy_line(busy_g, n_kg, wall_g)}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[7 grad]   {us:9.0f} us  {us / max(busy_g, 1):5.1%}  "
              f"{name[:90]}")

    # ---- 8. HMC on the widths model: a main path -----------------------
    genh = torch.Generator(device=dev)
    genh.manual_seed(0)
    scat_h = torch.tensor(1e-3 * np.abs(start) + 1e-6, dtype=f32, device=dev)
    _zero_counts(contacts, stream, gp)
    t0 = time.perf_counter()
    hs = init_hmc(genh, start_t, scat_h, lpw, N_CHAINS)
    pos0 = hs.positions.clone()
    hs = warmup_hmc(hs, lpw, 4, genh, n_leapfrog=N_LEAPFROG)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    c_warm = _counts(contacts, stream, gp)
    n_hmc = 3
    t0 = time.perf_counter()
    hs, hchain, hchain_lp, hacc, hdiv = run_hmc(hs, lpw, n_hmc, genh,
                                                n_leapfrog=N_LEAPFROG)
    torch.cuda.synchronize()
    s_hmc = (time.perf_counter() - t0) / n_hmc
    c_hmc = _counts(contacts, stream, gp)
    per = {k: (c_hmc[k] - c_warm[k]) / n_hmc for k in c_hmc}
    moved = (hs.positions != pos0).any(dim=-1).double().mean().item()
    print(f"[8 hmc] {N_CHAINS} chains x {N_LEAPFROG} leapfrog: init + 4 "
          f"warmup steps {t_warm:.1f} s; {n_hmc} steps at {s_hmc:.2f} "
          f"s/step ({N_CHAINS * N_LEAPFROG / s_hmc:.0f} chain-gradients/s); "
          f"acceptance {hacc.mean().item():.3f}; divergences "
          f"{hdiv.mean().item():.3f}; adapted step size "
          f"{hs.step_size.item():.3e}; per step: K1 {per['k1']:.0f}, K1 "
          f"backward {per['k1_bwd']:.0f} (its kernel "
          f"{per['k1_bwd_kernel']:.0f}), K2 {per['k2']:.0f} (16 each "
          f"expected); chains moved {moved:.0%}")
    _check(per["k1"] == per["k1_bwd"] == per["k1_bwd_kernel"] == per["k2"]
           == per["k2_sens"] == N_LEAPFROG,
           "not one K1, K1 backward kernel and K2 per leapfrog")
    _check(per["k4"] == per["k5"] == N_LEAPFROG
           and per["k6"] == N_LEAPFROG * ROCHE_PER_EVAL["k6"],
           f"not one K4, K5 and K6 per leapfrog: {per}")
    _check(all(per[k] == N_LEAPFROG * v for k, v in SWEEPS_PER_GRAD.items()),
           f"K7, K8 and their backward kernels not twice per leapfrog: "
           f"{per}")
    _check(all(per[k] == N_LEAPFROG * v
               for k, v in WD_DONOR_PER_GRAD.items()),
           f"K9 not once and K10 not 0 times per leapfrog: {per}")
    _check(bool(torch.isfinite(hs.positions).all()), "non-finite positions")
    _check(bool(torch.isfinite(hs.log_prob).all()), "non-finite log_prob")
    _check(bool(torch.isfinite(hchain_lp).all()), "non-finite chain_lp")
    _check(moved > 0.5, "the chains did not move")
    _check(tuple(hchain.shape) == (n_hmc, N_CHAINS, start.size),
           "HMC chain shape")

    # ---- 9. K3 vs plain on the GP model's own series --------------------
    k3 = {}
    n_ser = n_w * n_e
    sm_hz = _sm_clock_hz()
    # the float64 plain loop, from which the float32 paths' distances are
    # printed
    ll_ref = gp.segmented_matern32_plain(*[a.double() for a in gp_args],
                                         **gp_kw)
    for dt in (f32, f64):
        name = str(dt)[6:]
        t_, y_, yerr_, s2_, c_ = [a.to(dt) for a in gp_args]
        prep = gp._prepare(t_, y_, yerr_, s2_, c_, gp_kw["reset"],
                           gp_kw["mask"])
        t_, yerr_, s2_, c_, reset_, mask_ = prep
        # the kernel on the prepared inputs, against the plain loop on the
        # angles and the decay PyTorch makes from the same t and c
        rec_k = (t_, y_, yerr_, s2_, c_, reset_, mask_)
        rec_in = (y_, s2_, *gp._angles_decay(t_, c_), reset_, yerr_, mask_)
        call = (t_, y_, yerr_, s2_, c_)
        ll_k = gp._recursion_kernel(*rec_k)
        ll_p = gp._recursion_plain(*rec_in)
        ll_kw = gp.segmented_matern32_kernel(*call, **gp_kw)
        ll_pw = gp.segmented_matern32_plain(*call, **gp_kw)
        torch.cuda.synchronize()
        _check(bool(torch.isfinite(ll_p).all() & torch.isfinite(ll_pw).all()),
               "plain GP ln-like not finite")
        d_abs = max((ll_k - ll_p).abs().max().item(),
                    (ll_kw - ll_pw).abs().max().item())
        d_rel = max(((ll_k - ll_p).abs() / ll_p.abs()).max().item(),
                    ((ll_kw - ll_pw).abs() / ll_pw.abs()).max().item())
        # float32, printed beside the gate: each path's largest distance
        # from the float64 plain loop
        far = torch.maximum((ll_k.double() - ll_ref).abs(),
                            (ll_kw.double() - ll_ref).abs()).max().item()
        plain_far = (ll_pw.double() - ll_ref).abs().max().item()
        kernel_ms = _event_ms(lambda: gp._recursion_kernel(*rec_k), 20)
        ms = _event_ms(lambda: gp.segmented_matern32_kernel(*call, **gp_kw),
                       20)
        plain_ms = _event_ms(lambda: gp.segmented_matern32_plain(
            *call, **gp_kw), 2, 1)
        isz = y_.element_size()
        # what the function needs: y, sigma2 and reset per point and c per
        # series; t, yerr and mask per eclipse point; one ln-likelihood
        # out per series (the angles and the decay follow from t and c)
        nbytes = (n_ser * n_p * (2 * isz + 1) + n_ser * isz
                  + n_e * n_p * (2 * isz + 1) + n_ser * isz)
        ops = n_ser * n_p * K3_OPS_POINT
        bound = _bound(ops, nbytes, name)
        chain_ms = n_p * K3_CHAIN_CYCLES[name] / sm_hz * 1e3
        k3[dt] = dict(err=d_abs, rel=d_rel, ms=ms, plain_ms=plain_ms,
                      kernel_ms=kernel_ms, bound=bound, ops=ops,
                      nbytes=nbytes)
        gate = (f"max |d ll| {d_abs:.3e} (limit 1e-5 x {n_p} = "
                f"{1e-5 * n_p:.2e}); from the float64 plain loop the kernel "
                f"{far:.3e}, the float32 plain loop {plain_far:.3e}"
                if dt == f32 else f"max relative {d_rel:.3e} (limit 1e-11)")
        print(f"[9 K3] {name} {n_ser} series x {n_p} points, the kernel on "
              f"the prepared inputs and the whole wrapper against their "
              f"plain versions: {gate}; max |ll| "
              f"{ll_p.abs().max().item():.1f}; the wrapper's call "
              f"({k3_launch[1]} device event) {ms:.4f} ms, the kernel on "
              f"the prepared inputs {kernel_ms:.4f} ms "
              f"({kernel_ms / n_p * 1e6:.0f} ns per point), plain "
              f"{plain_ms:.1f} ms ({plain_ms / ms:.0f}x); bound "
              f"{bound[0] * 1e3:.2f} us ({ops / 1e9:.3f} G{name} ops, "
              f"{nbytes / 1e6:.1f} MB, set by {bound[1]}): the call at "
              f"{bound[0] / ms:.2%} of its bound; the chain floor "
              f"{chain_ms * 1e3:.2f} us ({n_p} x {K3_CHAIN_CYCLES[name]} "
              f"cycles at {sm_hz / 1e6:.0f} MHz, a model); ptxas registers "
              f"{registers['gp']}")
        _check(d_abs <= 1e-5 * n_p if dt == f32 else d_rel <= 1e-11,
               f"K3 disagrees with its plain version ({name})")

    # K3's reverse kernel against autograd on the plain loop, on the series
    # one gradient evaluation hands it
    k3b = {}
    n_ser_g = ga[1].shape[0] * ga[1].shape[1]
    gen_c = torch.Generator(device=dev)
    gen_c.manual_seed(0)
    cot64 = torch.randn(ga[1].shape[:2], generator=gen_c, dtype=f64,
                        device=dev)
    g_ref = None
    for dt in (f64, f32):
        name = str(dt)[6:]
        call = [a.to(dt) for a in ga]
        cot = cot64.to(dt)
        g_k = _k3_grads(gp.segmented_matern32_kernel, call, gk, cot)
        g_p = _k3_grads(gp.segmented_matern32_plain, call, gk, cot)
        if dt == f64:
            g_ref = g_p
        _check(all(bool(torch.isfinite(g).all()) for g in g_k + g_p),
               f"a K3 gradient is not finite ({name})")
        d_abs = [(a - b).abs().max().item() for a, b in zip(g_k, g_p)]
        scale = [b.abs().max().item() for b in g_p]
        rel = max(d / sc for d, sc in zip(d_abs, scale))
        # float32: the plain loop's own distance from float64 as referee
        d_ref = [(b.double() - r).abs().max().item()
                 for b, r in zip(g_p, g_ref)]
        within = all(d <= 1e-3 * sc or d <= dr
                     for d, sc, dr in zip(d_abs, scale, d_ref))
        ll_w, leaves_w = _k3_graph(gp.segmented_matern32_kernel, call, gk)
        ll_pl, leaves_pl = _k3_graph(gp.segmented_matern32_plain, call, gk)
        t_, yerr_, s2_, c_, reset_, mask_ = gp._prepare(
            call[0], call[1], call[2], call[3], call[4], gk["reset"],
            gk["mask"])
        # the reverse kernel alone: its launch on a forward's kept state
        tensors = gp._checked(t_, call[1], yerr_, s2_, c_, reset_, mask_)
        state = torch.empty((5, n_p, n_ser_g), dtype=dt, device=dev)
        gp._forward(tensors, state)
        ms = _event_ms(lambda: torch.autograd.grad(
            ll_w, leaves_w, cot, retain_graph=True), 20)
        kernel_ms = _event_ms(lambda: gp._backward(tensors, state, cot), 20)
        plain_ms = _event_ms(lambda: torch.autograd.grad(
            ll_pl, leaves_pl, cot, retain_graph=True), 2, 1)
        fwd_ms = _event_ms(lambda: _k3_graph(gp.segmented_matern32_kernel,
                                             call, gk), 20)
        del ll_w, leaves_w, ll_pl, leaves_pl, tensors, state
        isz = call[1].element_size()
        # in: y, sigma2, reset per point, c and the cotangent per series,
        # t, yerr, mask per eclipse point; out: d y, d sigma2 per point
        # and d c per series
        nbytes = (n_ser_g * n_p * (2 * isz + 1) + 2 * n_ser_g * isz
                  + n_e * n_p * (2 * isz + 1)
                  + n_ser_g * n_p * 2 * isz + n_ser_g * isz)
        ops = n_ser_g * n_p * K3_BWD_OPS_POINT
        bound = _bound(ops, nbytes, name)
        k3b[dt] = dict(err=max(d_abs), rel=rel, ms=ms, kernel_ms=kernel_ms,
                       plain_ms=plain_ms, fwd_ms=fwd_ms, bound=bound, ops=ops,
                       nbytes=nbytes)
        gate = ("limit 1e-9" if dt == f64 else
                "limit 1e-3, or closer to the plain loop than that is to "
                f"float64: {within}")
        print(f"[9 K3 reverse] {name} {n_ser_g} series x {n_p} points, "
              f"gradients in y, sigma2 and c against autograd on the plain "
              f"loop: max |d g| / max |g| {rel:.3e} ({gate}); max |d g| "
              f"{[f'{d:.3e}' for d in d_abs]} at max |g| "
              f"{[f'{sc:.3e}' for sc in scale]}; the backward pass of the "
              f"wrapper (gp_backward_kernel, which writes d c itself, and "
              f"autograd's sum of d sigma2 over what came in broadcast) "
              f"{ms:.4f} ms, gp_backward_kernel alone "
              f"{kernel_ms:.4f} ms ({kernel_ms / n_p * 1e6:.0f} ns per "
              f"point), autograd on the plain loop {plain_ms:.1f} ms "
              f"({plain_ms / ms:.0f}x); the recorded forward {fwd_ms:.4f} ms; "
              f"bound {bound[0] * 1e3:.2f} us ({ops / 1e9:.3f} G{name} ops, "
              f"{nbytes / 1e6:.1f} MB, set by {bound[1]}): the backward at "
              f"{bound[0] / ms:.2%} of its bound")
        _check(rel <= 1e-9 if dt == f64 else within,
               f"K3's reverse kernel disagrees with autograd on the plain "
               f"loop ({name})")

    # ---- 10. the GP posterior ------------------------------------------
    def plain_gp(fn):
        with mock.patch.object(gp, "segmented_matern32_kernel",
                               gp.segmented_matern32_plain):
            return fn()

    before = gp.LAUNCHES
    lp_gp_plain = plain_gp(lambda: lp_gp32(pos_gp))
    _check(gp.LAUNCHES == before, "the plain GP path launched K3")
    fin_k, fin_p = torch.isfinite(lp_gp_kernel), torch.isfinite(lp_gp_plain)
    _check(bool((fin_k == fin_p).all()), "GP finite/-inf pattern differs")
    _check(int(fin_k.sum()) > N_WALKERS // 2, "most GP walkers are -inf")
    d_lp = (lp_gp_kernel - lp_gp_plain).abs()[fin_k].max().item()
    print(f"[10 gp] {int(fin_k.sum())}/{N_WALKERS} walkers finite with K3 "
          f"and with the plain recursion; max |d ln p| {d_lp:.3e} (limit "
          f"1e-2: 5 series x 1e-5 x 128 points and the float32 sum at "
          f"|ln p| ~ {lp_gp_plain[fin_p].abs().max().item():.0f})")
    _check(d_lp <= 1e-2, "GP posterior: K3 path and plain path disagree")
    torch.cuda.reset_peak_memory_stats()
    turns = {"plain": [], "kernel": [], "chi2": []}
    for path in ("plain", "kernel", "chi2", "chi2", "kernel", "plain"):
        if path == "chi2":
            turns[path].append(_sync_time(lambda: lp32(pos), 2))
        else:
            def run():
                return _sync_time(lambda: lp_gp32(pos_gp), 2)
            turns[path].append(plain_gp(run) if path == "plain" else run())
    peak_gp = torch.cuda.max_memory_allocated()
    gp_ms, gp_plain_ms = min(turns["kernel"]), min(turns["plain"])
    chi2_ms = min(turns["chi2"])
    busy_us, n_kern, wall_us, _ = _device_kernels(lambda: lp_gp32(pos_gp))
    _, n_kern_p, _, _ = plain_gp(lambda: _device_kernels(
        lambda: lp_gp32(pos_gp)))
    print(f"[10 gp] ms per GP eval at {N_WALKERS} walkers: with K3 "
          f"{gp_ms:.1f} (turns {turns['kernel'][0]:.1f}, "
          f"{turns['kernel'][1]:.1f}), with the plain recursion "
          f"{gp_plain_ms:.1f} (turns {turns['plain'][0]:.1f}, "
          f"{turns['plain'][1]:.1f}): the plain recursion is "
          f"{(gp_plain_ms - gp_ms) / gp_plain_ms:.1%} of that evaluation; "
          f"the chi^2 model in the same turns {chi2_ms:.1f}; peak device "
          f"memory {peak_gp / 2**30:.2f} GiB; device kernels per eval "
          f"{n_kern} with K3, {n_kern_p} with the plain recursion; "
          f"device-busy share {_busy_line(busy_us, n_kern, wall_us)}")

    # the ensemble sampler on the GP model: the GP main path
    gen_gp = torch.Generator(device=dev)
    gen_gp.manual_seed(0)
    start_gp_t = torch.tensor(start_gp, dtype=f32, device=dev)
    scat_gp = 1e-3 * torch.clamp(start_gp_t.abs(), min=1e-2)
    _zero_counts(contacts, stream, gp)
    st_gp = init_walkers(gen_gp, start_gp_t, scat_gp, lp_gp32, N_WALKERS)
    c_gp_init = _counts(contacts, stream, gp)
    t0 = time.perf_counter()
    st_gp, _, _, acc_gp = run_sampler(st_gp, lp_gp32, 2, gen_gp)
    torch.cuda.synchronize()
    s_gp_step = (time.perf_counter() - t0) / 2
    c_gp_ens = _counts(contacts, stream, gp)
    per = _delta(c_gp_ens, c_gp_init)
    print(f"[10 gp] ensemble sampler on the GP model: init_walkers "
          f"{c_gp_init['k3']} K3 launches; 2 steps at {s_gp_step:.3f} "
          f"s/step, acceptance {acc_gp.mean().item():.3f}; launches in the "
          f"steps: K1 {per['k1']}, K2 {per['k2']}, K3 {per['k3']} (4 each "
          f"expected)")
    _check(per["k1"] == per["k2"] == per["k3"] == 4,
           "not one K1, K2 and K3 per half-step on the GP model")
    _check(bool(torch.isfinite(st_gp.log_prob).all()),
           "non-finite GP log_prob")

    # config 5: 10 complex-spot GP eclipses at 4096 walkers
    t0 = time.perf_counter()
    model_c5 = build_model(n_eclipses=10, complex_spot=True, use_gp=True,
                           n_points=128, bands=("g", "r")).compile()
    prior_c5, _, lp_c5 = make_ln_prob_parts(model_c5, dtype=f32, device=dev)
    pos_c5 = _walkers(model_c5.var_start(), 4096, 0, f32, dev)
    t_build = time.perf_counter() - t0
    with mock.patch.object(gp, "segmented_matern32_kernel",
                           wraps=gp.segmented_matern32_kernel) as rec:
        lp_c5(pos_c5)                                 # warm the allocator
    c5_args, c5_kw = rec.call_args.args, rec.call_args.kwargs
    n_ser_c5 = c5_args[1].shape[0] * c5_args[1].shape[1]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _zero_counts(contacts, stream, gp)
    t0 = time.perf_counter()
    out_c5 = lp_c5(pos_c5)
    torch.cuda.synchronize()
    c5_ms = (time.perf_counter() - t0) * 1e3
    c_gp_c5 = _counts(contacts, stream, gp)
    peak_c5 = torch.cuda.max_memory_allocated()
    _check(c_gp_c5 == {"k1": 1, "k1_f64": 0, "k1_mixed": 0, "k1_bwd": 0,
                       "k1_bwd_kernel": 0, "k2": 1, "k2_sens": 0, "k3": 1,
                       "k3_bwd": 0, **ROCHE_PER_EVAL, **SWEEPS_PER_EVAL,
                       "k7_bwd": 0, "k8_bwd": 0, "k9": 1,
                       "k10": 1 + WD_GP_CHANGEPOINTS},
           f"config-5 evaluation launches: {c_gp_c5}")
    prior_ok = torch.isfinite(prior_c5(pos_c5))
    k3_c5_ms = _event_ms(lambda: gp.segmented_matern32_kernel(
        *c5_args, **c5_kw), 10)
    print(f"[10 gp] config 5 (10 complex-spot GP eclipses, D = "
          f"{pos_c5.shape[1]}, 4096 walkers; model built in {t_build:.1f} "
          f"s): one evaluation {c5_ms:.1f} ms, peak device memory "
          f"{peak_c5 / 2**30:.2f} GiB; {int(prior_ok.sum())}/4096 walkers "
          f"with a finite prior, ln p finite exactly there: "
          f"{bool((torch.isfinite(out_c5) == prior_ok).all())}; K3's call "
          f"on its {n_ser_c5} series "
          f"{k3_c5_ms:.4f} ms")
    _check(tuple(c5_args[1].shape) == (4096, 10, 128), "config-5 GP series")
    _check(bool((torch.isfinite(out_c5) == prior_ok).all()),
           "config 5: ln p not finite exactly where the prior is")
    _check(int(prior_ok.sum()) > 2048, "config 5: most walkers are -inf")
    del out_c5, c5_args, c5_kw, lp_c5, prior_c5, pos_c5

    # the gradient on the GP model with exposure widths
    lp_gpw.value_and_grad(pos_gpw)                    # warm the allocator
    _zero_counts(contacts, stream, gp)
    lp_gg, g_gp = lp_gpw.value_and_grad(pos_gpw)
    c_gp_vg = _counts(contacts, stream, gp)
    _check(c_gp_vg == {"k1": 1, "k1_f64": 0, "k1_mixed": 0, "k1_bwd": 1,
                       "k1_bwd_kernel": 1, "k2": 1, "k2_sens": 1, "k3": 1,
                       "k3_bwd": 1, **ROCHE_PER_EVAL, **SWEEPS_PER_GRAD,
                       "k9": 1, "k10": WD_GP_CHANGEPOINTS},
           f"GP value_and_grad launches: {c_gp_vg}")
    _check(bool(torch.isfinite(lp_gg).all()), "a GP chain's ln p not finite")
    _check(bool(torch.isfinite(g_gp).all()), "a GP gradient is not finite")
    _check(bool((g_gp.abs().amax(dim=-1) > 0).all()), "a zero GP gradient")
    before = _counts(contacts, stream, gp)
    _, g_gp_plain = plain_gp(lambda: lp_gpw.value_and_grad(pos_gpw))
    after = _counts(contacts, stream, gp)
    _check((after["k3"], after["k3_bwd"]) == (before["k3"], before["k3_bwd"]),
           "the plain GP gradient path launched K3")
    cos_kp = torch.nn.functional.cosine_similarity(
        g_gp.double(), g_gp_plain.double(), dim=-1)
    print(f"[10 gp] GP gradient with K3 and its reverse kernel against the "
          f"plain recursion under autograd, {N_CHAINS} chains: cosine min "
          f"{cos_kp.min().item():.8f} (limit 0.9999)")
    _check(cos_kp.min().item() >= 0.9999,
           "GP gradient: K3 path and plain path disagree")

    torch.cuda.reset_peak_memory_stats()
    turns = {"plain": [], "kernel": [], "chi2": []}
    for path in ("plain", "kernel", "chi2", "chi2", "kernel", "plain"):
        if path == "chi2":
            turns[path].append(_sync_time(
                lambda: lpw.value_and_grad(posw), 1))
        else:
            def run():
                return _sync_time(lambda: lp_gpw.value_and_grad(pos_gpw), 1)
            turns[path].append(plain_gp(run) if path == "plain" else run())
    peak_gg = torch.cuda.max_memory_allocated()
    gp_vg_ms, gp_vg_plain_ms = min(turns["kernel"]), min(turns["plain"])
    chi_vg_ms = min(turns["chi2"])
    rec_share = (gp_vg_plain_ms - gp_vg_ms) / gp_vg_plain_ms
    k3_share = (k3b[f32]["fwd_ms"] + k3b[f32]["ms"]) / gp_vg_ms
    print(f"[10 gp] value_and_grad on the GP widths model, {N_CHAINS} "
          f"chains: with K3 and its reverse kernel {gp_vg_ms:.1f} ms (turns "
          f"{turns['kernel'][0]:.1f}, {turns['kernel'][1]:.1f}), with the "
          f"plain recursion under autograd {gp_vg_plain_ms:.1f} ms (turns "
          f"{turns['plain'][0]:.1f}, {turns['plain'][1]:.1f}): the plain "
          f"recursion is {rec_share:.1%} of that evaluation; K3's recorded "
          f"forward and backward (phase 9) are {k3_share:.2%} of the "
          f"evaluation with K3; the chi^2 widths model in the same turns "
          f"{chi_vg_ms:.1f} ms; peak device memory "
          f"{peak_gg / 2**30:.2f} GiB")
    lp_gpw64 = make_ln_prob(model_gpw, dtype=f64, device=dev)
    _, g_gp64 = lp_gpw64.value_and_grad(pos_gpw.to(f64))
    g_gp_d = g_gp.to(f64)
    cos_gp = ((g_gp_d * g_gp64).sum(-1)
              / (g_gp_d.norm(dim=-1) * g_gp64.norm(dim=-1)))
    frac_gp = (cos_gp >= 0.999).double().mean().item()
    print(f"[10 gp] f32 vs f64 GP gradient at {N_CHAINS} chains: cosine "
          f"min {cos_gp.min().item():.6f}, median "
          f"{cos_gp.median().item():.8f}; {frac_gp:.0%} of chains at "
          f"cosine >= 0.999 (limit 95%)")
    _check(frac_gp >= 0.95, "f32 GP gradients point away from f64")
    del lp_gpw64, g_gp64

    # one HMC step on it
    gen_gh = torch.Generator(device=dev)
    gen_gh.manual_seed(0)
    scat_gh = torch.tensor(1e-3 * np.abs(start_gp) + 1e-6, dtype=f32,
                           device=dev)
    hs_gp = init_hmc(gen_gh, start_gp_t, scat_gh, lp_gpw, N_CHAINS,
                     step_size=1e-4)
    _zero_counts(contacts, stream, gp)
    t0 = time.perf_counter()
    hs_gp2, acc_gh, _, div_gh = hmc_step(hs_gp, lp_gpw, gen_gh,
                                         n_leapfrog=N_LEAPFROG)
    torch.cuda.synchronize()
    s_gp_hmc = time.perf_counter() - t0
    c_gp_hmc = _counts(contacts, stream, gp)
    # the GP path's launches: the sampler's run, the config-5 evaluation,
    # one value_and_grad and the HMC step, each read after a run that
    # started from counts of 0 (not the timing turns)
    c_gp = {k: c_gp_ens[k] + c_gp_c5[k] + c_gp_vg[k] + c_gp_hmc[k]
            for k in c_gp_ens}
    print(f"[10 gp] one hmc_step of {N_LEAPFROG} leapfrog on the GP widths "
          f"model: {s_gp_hmc:.2f} s; acceptance {acc_gh.item():.3f}, "
          f"divergences {div_gh.item():.3f}; launches: K1 "
          f"{c_gp_hmc['k1']}, K1 backward {c_gp_hmc['k1_bwd']} (its kernel "
          f"{c_gp_hmc['k1_bwd_kernel']}), K2 with "
          f"sensitivities {c_gp_hmc['k2_sens']}, K3 {c_gp_hmc['k3']}, K3's "
          f"reverse kernel {c_gp_hmc['k3_bwd']} (16 each expected)")
    _check(c_gp_hmc == {**dict.fromkeys(c_gp_hmc, N_LEAPFROG),
                        "k1_f64": 0, "k1_mixed": 0,
                        **{k: N_LEAPFROG * v for k, v in
                           {**ROCHE_PER_EVAL, **SWEEPS_PER_GRAD}.items()},
                        "k10": N_LEAPFROG * WD_GP_CHANGEPOINTS},
           "GP hmc_step: not one K1, K1 backward kernel, K2, K3 and K3 "
           "reverse kernel per leapfrog")
    _check(bool(torch.isfinite(hs_gp2.positions).all()
                & torch.isfinite(hs_gp2.log_prob).all()),
           "GP hmc_step: non-finite state")
    _check(c_gp["k3"] >= 6 + 1 + N_LEAPFROG
           and c_gp["k3_bwd"] == 1 + N_LEAPFROG,
           "the GP path did not launch K3 and its reverse kernel")
    del lp_gpw, hs_gp, hs_gp2

    # ---- 11. parallel tempering on the north-star model ----------------
    n_temps, w_pt = 4, 256
    pt_prior, pt_like, post_pt = make_ln_prob_parts(model, dtype=f32,
                                                    device=dev)
    gen_pt = torch.Generator(device=dev)
    gen_pt.manual_seed(0)
    _zero_counts(contacts, stream, gp)
    t0 = time.perf_counter()
    pts = init_pt(gen_pt, start_t, scatter, pt_prior, pt_like, w_pt, n_temps)
    torch.cuda.synchronize()
    t_pt_init = time.perf_counter() - t0
    c_pt_init = _counts(contacts, stream, gp)
    n_pt = 3
    accs, rungs = [], []
    t0 = time.perf_counter()
    for _ in range(n_pt):
        pts, (a_pt, rung_ll) = pt_step(pts, pt_prior, pt_like, gen_pt)
        accs.append(a_pt)
        rungs.append(rung_ll)
    torch.cuda.synchronize()
    s_pt = (time.perf_counter() - t0) / n_pt
    c_pt = _counts(contacts, stream, gp)
    per = _delta(c_pt, c_pt_init)
    acc_pt = torch.stack(accs).mean().item()
    half = pts.positions[:, :w_pt // 2].reshape(-1, start.size)
    parts_turns, fused_turns = [], []
    for _ in range(2):
        parts_turns.append(_sync_time(lambda: post_pt.parts(half), 2))
        fused_turns.append(_sync_time(lambda: post_pt(half), 2))
    parts_ms, fused_ms = min(parts_turns), min(fused_turns)
    pt_rate = n_temps * w_pt / s_pt
    fused_rate = N_WALKERS / (ms_kernel / 1e3)
    print(f"[11 pt] {n_temps} rungs x {w_pt} walkers, betas "
          f"{[round(b, 4) for b in pts.betas.tolist()]}: init_pt "
          f"{t_pt_init:.2f} s ({c_pt_init['k1']} K1, {c_pt_init['k2']} K2 "
          f"launches); {n_pt} steps at {s_pt:.3f} s/step = {pt_rate:.0f} "
          f"tempered proposals/s; acceptance {acc_pt:.3f}; per-rung mean "
          f"ln-likelihood {[round(v, 1) for v in rungs[-1].tolist()]}; "
          f"launches in the steps: K1 {per['k1']}, K2 {per['k2']} (2 each "
          f"per step expected), K3 {per['k3']}")
    print(f"[11 pt] cost of a tempered proposal against the fused "
          f"posterior: on one half's {half.shape[0]} proposals, parts "
          f"{parts_ms:.1f} ms against the fused ln_prob {fused_ms:.1f} ms = "
          f"{parts_ms / fused_ms:.3f}x; by the rates (phase 3's "
          f"{fused_rate:.0f} evals/s at {N_WALKERS} walkers over the "
          f"steps' {pt_rate:.0f}/s, the reference's pt_cost_vs_fused) "
          f"{fused_rate / pt_rate:.3f}x")
    _check(per["k1"] == per["k2"] == 2 * n_pt,
           "PT: not one K1 and one K2 per half-step")
    _check(c_pt["k1_bwd"] == 0 and c_pt["k1_bwd_kernel"] == 0
           and c_pt["k2_sens"] == 0 and c_pt["k3"] == 0,
           "the PT path ran a gradient or the GP")
    _check(bool(torch.isfinite(pts.ln_like[0]).all()
                & torch.isfinite(pts.ln_prior[0]).all()),
           "PT: non-finite cold rung")
    _check(0.0 < acc_pt < 1.0, "PT acceptance outside (0, 1)")
    _check(bool(torch.isfinite(torch.stack(rungs)).all()),
           "PT: non-finite rung ln-likelihood")
    _check(tuple(pts.positions.shape) == (n_temps, w_pt, start.size),
           "PT state shape")

    # ---- 12. NUTS on the widths model, from phase 8's adapted state ----
    max_depth, n_nuts = 6, 2
    pos_n0 = hs.positions.clone()
    _zero_counts(contacts, stream, gp)
    depths, divs, astats = [], [], []
    with mock.patch.object(lpw, "value_and_grad",
                           wraps=lpw.value_and_grad) as rec:
        t0 = time.perf_counter()
        ns = hs
        for _ in range(n_nuts):
            ns, astat, _, div_n, depth_n = nuts_step(ns, lpw, genh,
                                                     max_depth=max_depth)
            depths.append(depth_n)
            divs.append(div_n)
            astats.append(astat)
        torch.cuda.synchronize()
        s_nuts = (time.perf_counter() - t0) / n_nuts
        leaves = rec.call_count
    c_nuts = _counts(contacts, stream, gp)
    moved_n = (ns.positions != pos_n0).any(dim=-1).double().mean().item()
    mean_depth = torch.stack(depths).mean().item()
    print(f"[12 nuts] {N_CHAINS} chains, max_depth {max_depth}, step size "
          f"{ns.step_size.item():.3e}: {n_nuts} steps at {s_nuts:.2f} "
          f"s/step ({N_CHAINS / s_nuts:.1f} trajectories/s); mean depth "
          f"{mean_depth:.2f} (per step "
          f"{[round(d.item(), 2) for d in depths]}); {leaves} leaves built "
          f"({leaves / n_nuts:.1f} per step, one gradient evaluation of "
          f"all chains each); accept statistic "
          f"{torch.stack(astats).mean().item():.3f}; divergence share "
          f"{torch.stack(divs).mean().item():.3f}; launches: K1 "
          f"{c_nuts['k1']}, K1 backward {c_nuts['k1_bwd']} (its kernel "
          f"{c_nuts['k1_bwd_kernel']}), K2 with "
          f"sensitivities {c_nuts['k2_sens']}; chains moved {moved_n:.0%}")
    _check(leaves >= n_nuts, "NUTS built no leaf")
    _check(c_nuts["k1"] == c_nuts["k1_bwd"] == c_nuts["k1_bwd_kernel"]
           == c_nuts["k2_sens"] == c_nuts["k2"] == leaves,
           "NUTS: not one K1, K1 backward kernel and K2 per leaf")
    _check(bool(torch.isfinite(ns.positions).all()
                & torch.isfinite(ns.log_prob).all()),
           "NUTS: non-finite state")
    _check(moved_n > 0.5, "the NUTS chains did not move")
    _check(ns.step == hs.step + n_nuts, "NUTS step counter")

    # ---- 13. the fit command on the demo input, and its resume --------
    c_fit = _fit_phase(dev, smi, contacts, stream, gp, plain_path)

    # ---- 14. K1 in float64 and in mixed precision -----------------------
    k1_modes, c_modes = _k1_modes_phase(dev, smi, model, pos, contacts,
                                        stream, gp, plain_path)

    # ---- 15. the fit command's other branches ---------------------------
    c_branches = _fit_branches_phase(dev, smi, contacts, stream, gp,
                                     plain_path)

    # ---- 16. walker sharding ---------------------------------------------
    c_shard = _shard_phase(dev, smi, contacts, stream, gp)

    # ---- 17. the donor quadrature ----------------------------------------
    c_quad = _donor_quad_phase(dev, smi, model, pos, contacts, stream, gp)

    # ---- 18. the host surface: --profile, notifications, arviz, native --
    c_host = _host_surface_phase(dev, smi)

    # ---- 19. wdparams on the card ----------------------------------------
    _wdparams_phase(dev, smi)

    # ---- 20. compat and plot_eclipse's evaluation ------------------------
    c_compat = _compat_phase(dev, smi, contacts, stream, gp)

    # ---- 21. the posterior tools -----------------------------------------
    _tools_phase(smi)

    # ---- 22. the core geometry's bisections K4-K6 ------------------------
    t0 = time.perf_counter()
    k_roche = _roche_phase(dev, smi, model, pos, roche_args, roche_us,
                           contacts, stream, gp)
    print(f"[22 roche] phase 22 took {time.perf_counter() - t0:.1f} s")

    # ---- 23. the flux curves' sweeps K7, K8 and their backward kernels --
    t0 = time.perf_counter()
    k_sweeps = _sweeps_phase(dev, smi, model, pos, start, sweep_args,
                             sweep_us, registers)
    print(f"[23 sweeps] phase 23 took {time.perf_counter() - t0:.1f} s")

    # ---- 24. the donor grid's radius solve K9, the white dwarf's K10 -----
    t0 = time.perf_counter()
    k_wd = _wd_donor_phase(dev, smi, model, pos, wd_args, wd_us, registers,
                           contacts, stream, gp)
    print(f"[24 wd_donor] phase 24 took {time.perf_counter() - t0:.1f} s")

    k2_ms, k2_pms = k2[f32, False][2:]
    paths = {"ensemble": c_ens, "hmc": c_hmc, "gp": c_gp, "pt": c_pt,
             "nuts": c_nuts, "fit": c_fit, **c_modes, **c_branches,
             **c_shard, **c_quad, "fit_profiled": c_host, **c_compat}
    f32_paths = ("ensemble", "hmc", "gp", "pt", "nuts", "fit", "fit_pt",
                 "fit_hmc", "fit_nuts", "fit_shard", "fit_hmc_shard",
                 "posterior_quad", "fit_profiled", "compat")

    def by_path(key):
        return {name: c[key] for name, c in paths.items()}

    for key, on in (("k1", f32_paths), ("k2", paths), ("k3", ("gp",)),
                    ("k3_bwd", ("gp",)),
                    ("k1_bwd_kernel", ("hmc", "gp", "nuts", "fit_hmc",
                                       "fit_nuts", "fit_hmc_shard")),
                    ("k1_f64", ("posterior_f64", "fit_x64",
                                "plot_eclipse")),
                    ("k1_mixed", ("posterior_precise", "fit_precise",
                                  "compat")),
                    ("k4", paths), ("k5", paths), ("k6", paths),
                    ("k7", paths), ("k8", paths),
                    ("k7_bwd", ("hmc", "gp", "nuts", "fit_hmc", "fit_nuts",
                                "fit_hmc_shard")),
                    ("k8_bwd", ("hmc", "gp", "nuts", "fit_hmc", "fit_nuts",
                                "fit_hmc_shard")),
                    ("k9", paths),
                    ("k10", ("ensemble", "gp", "pt", "fit", "fit_pt",
                             "fit_x64", "fit_shard", "posterior_f64",
                             "posterior_quad", "fit_profiled", "compat",
                             "plot_eclipse"))):
        for name in on:
            _check(paths[name][key] > 0,
                   f"the {name} path never launched {key.upper()}")
    # K7 and K8 a fixed count per evaluation on every path (an evaluation
    # is one launch of K1 in its mode), their backward kernels per
    # gradient evaluation (one launch of K1's backward kernel)
    for name, c in paths.items():
        evals = _k1_launches_of(c)
        want = {"k7": 2 * evals,
                "k8": (1 if name == "posterior_quad" else 2) * evals,
                "k7_bwd": 2 * c["k1_bwd_kernel"],
                "k8_bwd": 2 * c["k1_bwd_kernel"], "k9": evals}
        _check(all(c[k] == v for k, v in want.items()),
               f"the {name} path: K7 / K8 / K9 launches "
               f"{ {k: c[k] for k in want} }, expected {want}")
    print("[23 sweeps] launches by path (K7, K7 backward, K8, K8 backward): "
          + ", ".join(f"{n} {c['k7']}/{c['k7_bwd']}/{c['k8']}/{c['k8_bwd']}"
                      for n, c in paths.items())
          + "; every path K7 = 2 and K8 = 2 an evaluation (K8 = 1 with the "
          "donor quadrature), each backward kernel 2 a gradient evaluation")
    print("[24 wd_donor] launches by path (K9, K10): "
          + ", ".join(f"{n} {c['k9']}/{c['k10']}" for n, c in paths.items())
          + "; every path K9 = 1 an evaluation; K10 1 a forward evaluation "
          "(0 on a gradient or precise one), 2 more a GP evaluation")

    def k1_mode(mode, key):
        r = k1_modes[mode]
        return {"route": "cuda", "source": K1_SOURCE,
                "replaces": K1_MODE_REPLACES,
                "launches": sum(by_path(key).values()),
                "launches_by_path": {n: v for n, v in by_path(key).items()
                                     if v},
                "registers": registers["contacts"], **r}
    print(json.dumps({"kernels": [
        {"name": "contacts", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES,
         "launches": sum(by_path("k1").values()),
         "launches_by_path": by_path("k1"),
         "device_launches_per_call": k1_launch[0],
         "device_events_per_call": k1_launch[1],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "ops": k1_ops,
         "executed": k1_ex, "eclipsed_share": f_ecl, "library_ms": None,
         "float64": k1_mode("float64", "k1_f64"),
         "mixed_precision": k1_mode("mixed_precision", "k1_mixed"),
         "library_ms_reason": NO_LIBRARY.format(
             "a fixed-iteration safeguarded Newton solve of each element's "
             "eclipse contact phases"),
         "gradient": {
             "route": "torch.autograd.Function whose backward launches "
                      "the kernel contacts_backward (listed below)",
             "replaces": K1_GRAD_REPLACES,
             "backward_calls": sum(by_path("k1_bwd").values()),
             "backward_calls_by_path": by_path("k1_bwd"),
             "backward_ms": k1_bwd_ms}},
        {"name": "contacts_backward", "route": "cuda",
         "source": K1_BWD_SOURCE,
         "replaces": K1_GRAD_REPLACES + " (contacts_op_diff: a plain-XLA "
                     "JVP around the pallas_call)",
         "launches": sum(by_path("k1_bwd_kernel").values()),
         "launches_by_path": by_path("k1_bwd_kernel"),
         "device_launches_per_call": k1_bwd_launch[1],
         "device_events_per_forward_backward": k1_bwd_events,
         "rows": crow[2].shape[0], "elements": crow[2].shape[1],
         "max_abs_err": k1_bwd_err, "max_rel_err_float64": max(
             rel64.values()),
         "ms": k1_bwd_kernel_ms, "plain_ms": k1_bwd_plain_ms,
         "kernel_only_traced_us": k1_bwd_us,
         "backward_pass_ms": k1_bwd_ms,
         "bound_ms": k1_bwd_bound, "bound_by": k1_bwd_by, "ops": bwd_ops,
         "bytes": bwd_bytes, "ops_executed": bwd_ops_run,
         "executed_ops_at_peak_ms": k1_bwd_run_bound,
         "elements_swept": n_swept,
         "registers": registers["contacts_backward"],
         "library_ms": None,
         "library_ms_reason": NO_LIBRARY.format(
             "the implicit-function-theorem gradient of those contact "
             "phases through a clamped Newton residual"),
         "float64": {"ms": k1_bwd_kernel64_ms}},
        {"name": "stream", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES + " (an XLA lax.scan, no pallas_call)",
         "launches": sum(by_path("k2").values()),
         "launches_by_path": by_path("k2"),
         "device_launches_per_call": k2_launch[False][0],
         "device_events_per_call": k2_launch[False][1],
         "max_abs_err": k2[f32, False][0], "ms": k2_ms, "plain_ms": k2_pms,
         "ms_per_step": k2_ms / n_steps,
         "bound_ms": k2_bound[f32, False][0],
         "bound_by": k2_bound[f32, False][1], "library_ms": None,
         "library_ms_reason": NO_LIBRARY.format(
             "a 4352-step RK4 scan with first-crossing records"),
         "sensitivities": {
             "launches": sum(by_path("k2_sens").values()),
             "launches_by_path": by_path("k2_sens"), "walkers": N_CHAINS,
             "max_abs_err": k2[f32, True][0],
             "max_abs_err_jacobians": max(k2[f32, True][1]),
             "ms": k2[f32, True][2], "plain_ms": k2[f32, True][3],
             "bound_ms": k2_bound[f32, True][0],
             "bound_by": k2_bound[f32, True][1],
             "device_launches_per_call": k2_launch[True][0],
             "device_events_per_call": k2_launch[True][1]},
         "float64": {
             "ms": k2[f64, False][2], "bound_ms": k2_bound[f64, False][0],
             "sens_ms": k2[f64, True][2],
             "sens_bound_ms": k2_bound[f64, True][0]}},
        {"name": "gp", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES + " (an XLA lax.scan, no pallas_call)",
         "launches": sum(by_path("k3").values()),
         "launches_by_path": by_path("k3"),
         "device_launches_per_call": k3_launch[0],
         "device_events_per_call": k3_launch[1],
         "series": n_ser, "points": n_p,
         "max_abs_err": k3[f32]["err"], "ms": k3[f32]["ms"],
         "plain_ms": k3[f32]["plain_ms"],
         "kernel_only_ms": k3[f32]["kernel_ms"],
         "kernel_only_traced_us": k3_us["forward"],
         "call_traced_us": k3_us["call"],
         "ns_per_point_kernel_only": k3_us["forward"] / n_p * 1e3,
         "bound_ms": k3[f32]["bound"][0], "bound_by": k3[f32]["bound"][1],
         "ops": k3[f32]["ops"], "bytes": k3[f32]["nbytes"],
         "registers": registers["gp"],
         "library_ms": None,
         "library_ms_reason": NO_LIBRARY.format(
             "a semi-separable Cholesky recursion with segment resets"),
         "config5": {"series": n_ser_c5, "ms": k3_c5_ms},
         "float64": {
             "max_rel_err": k3[f64]["rel"], "ms": k3[f64]["ms"],
             "kernel_only_ms": k3[f64]["kernel_ms"],
             "plain_ms": k3[f64]["plain_ms"],
             "bound_ms": k3[f64]["bound"][0],
             "bound_by": k3[f64]["bound"][1]}},
        {"name": "gp_backward", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES + " (the reverse of an XLA lax.scan under "
                     "jax.grad, no pallas_call)",
         "launches": sum(by_path("k3_bwd").values()),
         "launches_by_path": by_path("k3_bwd"),
         "device_launches_per_call": k3_bwd_launch[1],
         "device_events_per_forward_backward": k3_bwd_events,
         "series": n_ser_g, "points": n_p,
         "max_abs_err": k3b[f32]["err"], "max_rel_err": k3b[f32]["rel"],
         "ms": k3b[f32]["ms"], "plain_ms": k3b[f32]["plain_ms"],
         "kernel_only_ms": k3b[f32]["kernel_ms"],
         "recorded_forward_ms": k3b[f32]["fwd_ms"],
         "kernel_only_traced_us": k3_us["backward"],
         "forward_kernel_keeping_state_traced_us": k3_us["forward_recorded"],
         "forward_backward_call_traced_us": k3_us["forward_backward_call"],
         "bound_ms": k3b[f32]["bound"][0], "bound_by": k3b[f32]["bound"][1],
         "ops": k3b[f32]["ops"], "bytes": k3b[f32]["nbytes"],
         "library_ms": None,
         "library_ms_reason": NO_LIBRARY.format(
             "the adjoint of that recursion"),
         "value_and_grad_ms": gp_vg_ms,
         "value_and_grad_plain_recursion_ms": gp_vg_plain_ms,
         "plain_recursion_share_of_value_and_grad": rec_share,
         "share_of_value_and_grad": k3_share, "chains": N_CHAINS,
         "float64": {
             "max_rel_err": k3b[f64]["rel"], "ms": k3b[f64]["ms"],
             "kernel_only_ms": k3b[f64]["kernel_ms"],
             "plain_ms": k3b[f64]["plain_ms"],
             "bound_ms": k3b[f64]["bound"][0],
             "bound_by": k3b[f64]["bound"][1]}},
        *({"name": n, "route": "cuda", "source": ROCHE_SOURCE,
           "replaces": ROCHE_REPLACES[n],
           "launches": sum(by_path(key).values()),
           "launches_by_path": by_path(key),
           "device_launches_per_call": roche_launch[n][0],
           "device_events_per_call": roche_launch[n][1],
           "registers": {e: r for e, r in registers["roche"].items()
                         if e.startswith(f"{n}_kernel")},
           "library_ms": None,
           "library_ms_reason": NO_LIBRARY.format(what),
           **{k: v for k, v in k_roche[n].items() if k != "chain_floor_ms"},
           "float64": {k: v for k, v in k_roche[n]["float64"].items()
                       if k != "chain_floor_ms"}}
          for n, key, what in (
              ("findi", "k4", "a fixed-iteration bisection of a clamped-"
               "Newton ray clearance over the inclination"),
              ("xl1", "k5", "a fixed-iteration bisection of dPhi/dx on the "
               "line of centres"),
              ("lobe_radius", "k6", "a fixed-iteration bisection of the "
               "Roche potential along a direction"))),
        *({"name": n, "route": "cuda", "source": SWEEPS_SOURCE,
           "replaces": SWEEPS_REPLACES[n],
           "launches": sum(by_path(key).values()),
           "launches_by_path": by_path(key),
           "device_launches_per_call": sweep_launch[tag][0],
           "device_events_per_call": sweep_launch[tag][1],
           "library_call": "torch.bmm of the materialised (rows, P, N) "
                           "terms by the " + what + " (TF32 off): the "
                           "reduction alone, not the terms",
           **k_sweeps[n]}
          for n, key, tag, what in (
              ("element_curve", "k7", "K7 element_curve disc", "weights"),
              ("element_curve_backward", "k7_bwd",
               "K7 element_curve_backward disc", "cotangent (d w)"),
              ("donor_sum", "k8", "K8 donor_sum curve", "areas"),
              ("donor_sum_backward", "k8_bwd", "K8 donor_sum_backward curve",
               "cotangent (d area, per row)"))),
        *({"name": n, "route": "cuda", "source": WD_DONOR_SOURCE,
           "replaces": WD_DONOR_REPLACES[n],
           "launches": sum(by_path(key).values()),
           "launches_by_path": by_path(key),
           "device_launches_per_call": wd_launch[tag][0],
           "device_events_per_call": wd_launch[tag][1],
           "registers": {e: r for e, r in registers["wd_donor"].items()
                         if e.startswith(f"{n}_kernel")},
           "library_ms": None,
           "library_ms_reason": NO_LIBRARY.format(what),
           **k_wd[n]}
          for n, key, tag, what in (
              ("donor_grid", "k9", "K9 donor_grid", "a fixed-iteration "
               "bisection and safeguarded Newton solve of the Roche "
               "potential along each direction, and the grid's normals "
               "and areas there"),
              ("wd_curve", "k10", "K10 wd_curve", "a clamped-Newton ray "
               "clearance, its shadow distance and a limb-darkened edge "
               "fraction at each phase"))),
    ]}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
