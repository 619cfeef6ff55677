#!/usr/bin/env python3
"""Drive cmad_tpu_torch's J2+Voce return-map path, the Hosford notch deck
and the elastic notch once on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels of ``cmad_tpu_torch/csrc`` (one nvcc per
source, started together, into ``build/cmad_tpu_torch/``): the four J2
return maps, their f32 history with 1-12 Newton iterations (the roofline
experiment's kernel R), and the reproducible sums ``segment_sum_tile``
(a block per tile of short segments, staged in shared memory; with the CSR
product ``csr_matvec`` as its entry for CG), ``segment_sum_block`` (one
block per segment) and ``coarse_pair_sum`` (the two-level coarse pairs'
products and sums). It checks each against its plain PyTorch version
on the card, drives the port's public entry points at the headline sizes
and checks the answers against the plain path and against the yield
condition, and prints timings of the kernel and plain paths measured with
CUDA events beside each kernel's bound (its bytes, and its operations as
the built library's SASS counts them). The paths driven:

- the SoA history drive at 2,097,152 points x 64 steps and the FE
  dispatch chain at 4,194,304 points x 8 steps (``j2_soa_history``,
  ``j2_soa_step``);
- the material-point models' batched return map,
  ``make_batched_return_map(model, specialize=True)``, at 4,194,304
  points x 2 chained steps for the rate form (``j2_aos_step``) and the
  total form (``j2_total_step``);
- the generic implicit-function Newton, ``make_batched_return_map(model)``,
  at 1,048,576 points x 2 steps, and its gradient against autograd
  through the plain radial return;
- the FE J2 primal on the notch (``examples/notch_hosford.yaml`` with J2,
  the stepped driver, CG with the two-level preconditioner), built from
  the deck as a dict by ``cli/fe_common.build_fe_problem_from_deck`` and
  driven by ``fe_primal_drive``, 4 steps, f64: on 480 tets at a fixed CG
  rtol of 1e-10 against the same drive on the CPU (plain step,
  sparse-direct solves); on 47,628 tets with the linear solver of the
  deck's at-scale records (rtol 1e-6, at most 2000 iterations, the
  Eisenstat-Walker forcing term) against cmad_tpu's ||U|| and max |alpha|
  after each step; on 153,600 tets, the same solver, timed only. Each
  counts its ``j2_soa_step`` launches against the assemblies its Newton
  and line searches made, and the last two time an assembly, K1 at the
  FE shape (on the device, from a CUDA graph: warm, on the same inputs
  again, and cold, rotating through copies of them larger than the L2;
  beside its launch floor, an empty kernel on its grid; and on an
  all-elastic and an all-plastic set of the same size), the two-level
  setup and one CG solve;
- determinism: the 47,628-tet drive a second time in the same process,
  bit for bit the same U history, Newton path and CG counts; then the
  segment sum on each of the FE path's six plans, on the kernel the plan
  picks and on every other path that takes its width, against
  ``index_add_`` on the CPU bit for bit; ``csr_matvec`` on the step's first
  Newton system against ``csr_matvec_plain`` on the CPU bit for bit and
  against PyTorch's CSR product to a tolerance; and ``coarse_pair_sum`` on
  the step's first K against ``coarse_matrix`` on the CPU bit for bit, each
  timed on the device, warm and cold, beside the PyTorch calls it replaces
  (with the kernels' int32 indices where PyTorch takes them);
- the FE J2 stepped gradient of the notch calibration
  (``benchmarks/notch_hosford/calibrate_scale.py``: a truth at Y = 2.0
  from the port's primal, then J and dJ/dc at Y = 2.6 under the log
  transform, ``fe_displacement_match``), through ``build_fe_stepped_vg``:
  on 480 tets at a Newton tolerance of 1e-12, the card (CG at 1e-10)
  against the CPU (plain step, direct) and against a central difference
  on the card; on 47,628 tets with the records' solver against
  cmad_tpu's CPU f64 numbers, twice, bit for bit, with the forward and
  reverse sweeps' time split and the segment sums' launches per plan;
- the FE second derivatives (``benchmarks/notch_hosford/
  hessian_scale.py``: d2J/dY2 at Y = 2.3, Y active with no transform): on
  480 tets at a Newton tolerance of 1e-12, the card's stepped Hessian (CG
  at 1e-10) against the CPU's (plain step, direct), the card's scan
  Hessian (the trajectory's double backward), a central difference of the
  card's gradient and ``J_dot`` against ``grad . v``; on 47,628 tets with
  the records' solver, the truth through the ``primal`` command (Exodus
  out, read back by ``read_results``) and the ``hessian`` command twice,
  bit for bit, against cmad_tpu's CPU f64 Hessian and a central
  difference of the card's gradient, with the sweeps' time split, the
  Newton and CG counts and each kernel's launches in one evaluation;
- the FE commands (``cli/fe_subcommands.py``) at 480 tets with the deck
  as a dict: ``primal`` (Exodus and a restart written, the restart
  resumed), ``objective``, ``gradient`` and ``hessian`` through both
  drivers and ``calibrate`` from Y = 2.6, each file against the library
  call's number bit for bit;
- the roofline experiment (``ops/roofline.py``): the f32 history at
  2,097,152 points x 16 steps, Newton iterations 1-12 at 8 steps a
  launch and 1-16 steps a launch at 8 iterations, each row against the
  plain drive;
- the Hosford path (``examples/notch_hosford.yaml`` as written: Hosford
  with a = 100, the total form): the reduced 4-dof Newton through
  ``make_batched_return_map(model, specialize=True)`` at 1,048,576 points
  x 2 steps against the generic 7-dof Newton (mp-hosford); the deck as
  written through the ``primal`` command at 480 tets with its Exodus
  output, against the library drive bit for bit (and, on the J2 deck,
  ``fe_load_match`` in write mode and one ``objective`` for each of
  ``fe_displacement_l2``, ``fe_load_match`` and ``fe_weighted_sum``; in
  fe-cli); at 480 tets, the load in two steps, Newton at 1e-12, the card
  (the point-batch block, CG at 1e-10) against the CPU, and the stepped
  gradient and Hessian against central differences and the scan Hessian
  (fe-hosford-small); at 47,628 tets with the records' solver and Newton
  cap 50 the primal against cmad_tpu's CPU f64 ||U|| and max |alpha|,
  its last two steps again, bit for bit, with the local Newton's
  iterations per step and an assembly's host and device time, and one
  gradient against cmad_tpu's (fe-hosford). No TPU kernel lies on this
  path: it runs the segment sums and ``csr_matvec``, and never
  ``j2_soa_step``;
- the closed-form elastic model on the generic per-point block (the
  notch's mesh, BCs, E = 1000 and nu = 0.25 with ``type: elastic``): at
  47,628 tets with the records' solver, isotropic linear and neo-Hookean,
  ||U|| per step against cmad_tpu's, the linear one's U(t_k) against k/4
  U(t_4), each drive twice bit for bit, an assembly's host and device
  time beside the J2 block's (fe-elastic); the elastic calibration
  (``fe_load_match`` against the truth's reactions, E and nu active at
  1300 and 0.3): J and dJ/dc at 47,628 tets against cmad_tpu's and the
  card's central difference, and at 480 tets the 2x2 stepped Hessian
  against the central difference of the card's gradient and the scan
  Hessian (fe-elastic-grad); the J2 notch at 480 tets with the local
  residual's ``print convergence: true`` through the generic COUPLED
  block and its 7-dof Newton, K1 never launched, against the J2 block's
  drive (fe-print); and in fe-cli the elastic deck's ``primal`` with
  Exodus (the closed-form Cauchy stress) and restart output, bit for bit
  against the library drive. These run the segment sums and
  ``csr_matvec``, never ``j2_soa_step``.

Before the paths, ``j2_soa_step`` is held to its plain version at
1,000,003 points (f64, f32, and on the wide view), at the FE dispatch's
shape, and in f64 on the two materials outside the range of its f32 Newton
phase (``range_scalars``), one step from rest, also against the yield
condition.

It prints one line per phase (each with its wall seconds), the card's
name and power limit, a JSON line with one entry per kernel (``ms``,
``plain_ms`` and ``library_ms`` warm, as the path runs them; beside them
``cold_ms``, ``plain_cold_ms`` and ``library_cold_ms``, each call's inputs
read from device memory, from which the FE kernels' share of their byte
bound is taken), then the
final JSON line ``{"ok": true, "device": {...}}``. Any failed check
raises, and the script exits non-zero; without a CUDA device it exits
non-zero at once.
"""
from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the material of the repo's benchmark (bench.py): E, nu, Y, S, D
MATERIAL = {
    "rotation matrix": np.eye(3),
    "elastic": {"E": 200e3, "nu": 0.3},
    "plastic": {
        "effective stress": {"J2": 0.0},
        "flow stress": {"initial yield": {"Y": 200.0},
                        "hardening": {"voce": {"S": 200.0, "D": 20.0}}}}}

N_STEP = 1_000_003          # parity of j2_soa_step (not a multiple of 8)
N_HIST = 262_147            # parity of j2_soa_history
# the history's edges: one point, a part of a warp, one block of
# j2_soa_history (256 threads) +- 1, and the odd N above; T shorter than
# the one-step-ahead prefetch, and two long histories
N_HIST_EDGES = (1, 33, 255, 257, N_HIST)
T_HIST = (0, 1, 2, 13, 64)
# the f64 history outside the range of its f32 Newton phase: T_RANGE steps
# of the headline's increment size (1.5e-3, so that dg is large enough
# that two f64 iterations from 0 do not reach the fixed point), N_HIST
# points, the materials of range_scalars
T_RANGE = 8
RANGE_SCALE = 1e37
AOS_TILE = 128  # points per block of both AoS kernels (kAosTile, kTotalTile)
N_DRIVE, T_DRIVE = 2_097_152, 64   # the history-drive headline
N_FE, FE_STEPS, FE_Q = 4_194_304, 8, 8
N_MP = 4_194_304            # the batched return map (bench.py:355)
N_GENERIC = N_MP // 4       # the generic Newton (bench.py:650-664)
N_GRAD = 65_536
ROUNDS, REPS = 3, 5         # timing: best of 3 rounds of 5 chained calls

# bounds: per state row, max|kernel - plain| <= bound * max(1, max|row|)
STEP_BOUND = {"float64": 1e-11, "float32": 1e-5}   # nvcc contracts FMAs
HIST_BOUND = {"float64": 1e-10, "float32": 1e-4}   # error grows over T
# the f64 history on a material scaled by RANGE_SCALE against the scaled
# output on the unscaled one: both converge to the f64 fixed point
RANGE_BOUND = 1e-13
GRAD_RTOL = 1e-8
YIELD_TOL = 1e-9            # |phi - Y - H(alpha)| <= YIELD_TOL * Y
# generic Newton vs radial return: the Newton stops once ||r|| < abs_tol
# (1e-14 in f64), and its stress rows are scaled by 1 / (2 mu), so it
# resolves the stress to about 2 mu abs_tol = 1.5e-9 (the CPU tests'
# atol 1e-9 holds at 256 points; 65,536 points on the CPU reach 9.8e-10)
GENERIC_TOL_FACTOR = 2.0    # bound = GENERIC_TOL_FACTOR * 2 mu * abs_tol
# the generic Newton's implicit-function gradient vs autograd through
# the plain radial return's 8 unrolled scalar iterations: both converge
# to f64 rounding, measured 1e-13 on the CPU at 4096 points
MP_GRAD_RTOL = 1e-9

# the card's peaks (NVIDIA H100 SXM data sheet, dense, outside the
# tensor cores): bytes/s and operations/s. The operations of each kernel,
# per elastic update and added per plastic update, are read from the
# built library's SASS (cmad_tpu_torch/ops/_sass.py: DFMA and FFMA 2,
# DADD, DMUL, FADD and FMUL 1)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"fp64": 34e12, "fp32": 67e12}


def segsum_bytes(summed: int, width: int, n_segments: int, perm: bool,
                 scale: bool, index_bytes: int = 4) -> int:
    """The bytes a segment sum must move: each summed entry's values (8 B
    a column), perm entry and scale read once, the offsets once, and each
    output written once. ``index_bytes`` 4, the least a per-entry index
    needs at these sizes (the tile path reads int32), is the bound; 8 the
    count of int64 indices, the bound before."""
    return (summed * (8 * width + index_bytes * perm + 8 * scale)
            + n_segments * 8 * width + index_bytes * (n_segments + 1))


def csr_tensor(indptr, cols, data, n: int):
    """The ``(n, n)`` PyTorch CSR matrix ``(indptr, cols, data)``: the
    library call (cuSPARSE on the card) timed beside ``csr_matvec``."""
    import warnings

    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "sparse CSR support is beta"
        return torch.sparse_csr_tensor(indptr, cols, data, (n, n),
                                       check_invariants=False)


def csr_bytes(nnz: int, n: int, index_bytes: int = 4) -> int:
    """The bytes of y = A x for an (n, n) CSR matrix: each value and
    column index read once, x and the row pointer once, y written once
    (``index_bytes`` as :func:`segsum_bytes`)."""
    return nnz * (8 + index_bytes) + 16 * n + index_bytes * (n + 1)

# the gradient phase's active parameters: E, Y, S, D
GRAD_FLAGS = {
    "rotation matrix": False, "elastic": {"E": True, "nu": False},
    "plastic": {"effective stress": {"J2": False},
                "flow stress": {"initial yield": {"Y": True},
                                "hardening": {"voce": {"S": True,
                                                       "D": True}}}}}
GRAD_TRANSFORMS = {
    "rotation matrix": None, "elastic": {"E": None, "nu": None},
    "plastic": {"effective stress": {"J2": None},
                "flow stress": {"initial yield": {"Y": None},
                                "hardening": {"voce": {"S": None,
                                                       "D": None}}}}}

SOURCE = "cmad_tpu_torch/csrc/j2_radial_return.cu"
PALLAS = "cmad_tpu/ops/pallas_radial_return.py"

# the FE J2 primal on the notch: examples/notch_hosford.yaml with the J2
# effective stress, the stepped driver and the linear solver of every
# at-scale record of this deck (benchmarks/notch_hosford/
# calibrate_scale.py:86-106, measure_scale.py:63-66, hessian_scale.py:
# 67-70), as a dict (the deck path needs PyYAML, which the GPU host lacks)
MESHES = Path(__file__).resolve().parent / "examples" / "meshes"
FE_SMALL_MESH = "notch_h0.080.exo"   # 480 tets, 495 dofs
FE_MESH = "notch_h0.015.exo"         # 47,628 tets, 29,040 dofs
FE_LARGE_MESH = "notch_h0.010.exo"   # 153,600 tets, 88,209 dofs
# the deck's cap of 15 Newton iterations leaves step 1 of the 47,628-tet
# notch at ||R|| = 2.99e-3 in cmad_tpu (f64, sparse-direct solves); with
# 50 every step converges in both packages (the port: in at most 20)
FE_MAX_ITERS = 50
# the records' linear solver: CG with the two-level preconditioner, rtol
# 1e-6, at most 2000 iterations, and the Eisenstat-Walker forcing term
# (each solve's rtol follows the Newton's contraction, down to 1e-6)
FE_RECORDS = {"type": "cg", "rtol": 1.0e-6, "max iters": 2000,
              "adaptive rtol": True, "preconditioner": {"type": "two_level"}}
# fe-notch-small's solver: the same CG at a fixed rtol 1e-10, 10 n at most
FE_CG_TIGHT = {"type": "cg", "rtol": 1e-10, "max iters": None,
               "preconditioner": {"type": "two_level"}}
FE_DIRECT = {"type": "direct"}
# cmad_tpu on the CPU in f64 with sparse-direct solves, the same deck:
# ||U|| and max |alpha| after each of the 4 steps
# (tools/fe_notch_reference.py --mesh notch_h0.015.exo --max-iters 50,
# jax 0.9.0)
FE_REF_U_NORMS = (0.7609226673826566, 1.5289882558798078,
                  2.158390610204209, 2.7566431903009647)
FE_REF_ALPHA_MAX = (0.07123925805427708, 0.12625392664911547,
                    0.1632297793524226, 0.19545436581399595)
FE_REF_RTOL = 1e-6
# 480 tets: the card (K1, two-level CG) against the CPU (plain step,
# sparse-direct solves), max|U_gpu - U_cpu| / max|U_cpu| over the steps.
# Both Newtons stop at the deck's 1e-8 relative residual, on their own
# paths, so their answers differ by about that much over K's conditioning
# (2.4e-7 on an H100)
FE_SMALL_BOUND = 1e-5
# K1 reads 7 rows of xi and 6 of de and writes 8 rows of xi': 21 x 8 B
BYTES_PER_K1_POINT = 168
GRAPH_REPS = 20     # K1 launches per CUDA graph, timed on the device
# K1's launch floor: an empty kernel on K1's grid in the same CUDA graph.
# At the FE notch's shape that grid is one block of K1_THREADS threads
# (csrc: kStepThreads) for each K1_THREADS points: fewer blocks than fill
# the card at K1's occupancy, so every block takes one round
K1_THREADS = 128
FLOOR_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_run(int grid, int threads, void* stream) {
  empty_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
# cold timings (cold_ms) rotate through copies of a call's inputs that
# add up to more than COLD_L2_FACTOR x the H100's 50 MB L2: a warm time
# (graph_ms, the same inputs again) of a call whose inputs fit in the L2
# reads them from there, and beat the HBM byte bound (the CSR dedup, 28 MB:
# 149% of it)
L2_BYTES = 50 * 2**20
COLD_L2_FACTOR = 2

# the FE gradient of the notch calibration
# (benchmarks/notch_hosford/calibrate_scale.py:86-160): the truth is the
# primal at the deck's Y = 2.0; J and dJ/dc at Y = 2.6, Y active under the
# log transform about 2.0 (Y = 2.0 exp(c), so dJ/dY = dJ/dc / Y), against
# the truth's displacements (fe_displacement_match, the records' weight)
GRAD_Y_TRUTH, GRAD_Y = 2.0, 2.6
GRAD_WEIGHT = 1.0e6
# fe-grad-small's global Newton tolerance: the deck's 1e-8 leaves J with
# the Newton's stopping noise (on the CPU, a central difference at h = 1e-5
# in c was off by 2.8e-3, and the 1e-8 direct and records' solvers
# differed by 6.1e-7 in J); at 1e-12 a central difference at h = 1e-4 is
# within 1.0e-9 of the gradient and CG at 1e-10 within 3.4e-12 of the
# direct solves (both on the CPU)
GRAD_SMALL_TOL = 1e-12
GRAD_SMALL_H = 1e-4
# card (cg + two_level at 1e-10) vs CPU (plain step, direct), relative:
# 1.4e-12 in J and 3.4e-12 in the gradient on the CPU's own pair; the
# card's other summation orders get three orders of margin
GRAD_SMALL_J_RTOL, GRAD_SMALL_G_RTOL = 1e-9, 1e-8
# the card's gradient vs its central difference: the truncation error at
# h = 1e-4 is about 1e-8 (1.2e-6 at h = 1e-3, quadratic in h), and J's
# Newton noise at 1e-12 adds 1e-9
GRAD_FD_RTOL = 1e-6
# cmad_tpu on the CPU in f64 with sparse-direct solves, the same deck with
# Newton cap 50 (tools/fe_notch_reference.py --mesh notch_h0.015.exo
# --max-iters 50 --gradient, jax 0.9.0): J and dJ/dc at Y = 2.6
FE_GRAD_REF_J = 1.0050916436682982
FE_GRAD_REF_DJ_DC = 8.14695779185205
# fe-grad against it: both Newtons stop at the deck's 1e-8 relative
# residual on their own paths, the card's truth is its own primal (CG at
# 1e-6) and its transpose solves stop at CG's static 1e-6: at 480 tets the
# records' solver and direct solves, each with its own truth, differed by
# 6.1e-7 in J and 3.1e-7 in dJ/dc (CPU); the bounds leave an order of
# magnitude for J and three for the gradient, whose transpose solve's
# 1e-6 error enters it directly
FE_GRAD_J_RTOL, FE_GRAD_G_RTOL = 1e-5, 1e-3
# the Hessian of the notch calibration (benchmarks/notch_hosford/
# hessian_scale.py): the same truth, then d2J/dY2 at Y = 2.3, Y active with
# no transform, fe_displacement_match at the records' weight, the stepped
# driver
HESS_Y = 2.3
# cmad_tpu on the CPU in f64 with sparse-direct solves, Newton cap 50
# (tools/fe_notch_reference.py --mesh notch_h0.015.exo --max-iters 50
# --hessian, jax 0.9.0; the Hessian took 483 s on the CPU host): H, and J
# and dJ/dY from its stepped gradient
FE_HESS_REF_H = 5.43592770340472
FE_HESS_REF_J = 0.2604293207775305
FE_HESS_REF_DJ_DY = 1.7095399560198516
# the TPU record (benchmarks/notch_hosford/hessian_scale_47628_tpu.json:
# TPU, f32, the deck's Newton cap of 15), printed beside ours as context
HESS_TPU_RECORD = 5.435303688049316
# fe-hessian against cmad_tpu: the card's truth is its own primal (CG at
# 1e-6), its Newton stops at 1e-8 on its own path and its transpose solves
# at CG's 1e-6; H against a central difference of the card's gradient at h
# = 1e-3 in Y, whose truncation and gradient noise (a 1e-6 solve over 2h)
# are each about 1e-3 of H
HESS_REF_RTOL, HESS_FD_H, HESS_FD_RTOL = 1e-3, 1e-3, 1e-2
# fe-hessian-small (480 tets, Newton at 1e-12, CG at 1e-10): card vs CPU
# (plain step, direct), the scan vs the stepped Hessian, and J_dot (the
# tangent sweep's dJ along v) vs grad . v, relative; H vs the card's
# central difference at h = 1e-4 in Y
HESS_SMALL_RTOL, HESS_SMALL_FD_RTOL, HESS_JDOT_RTOL = 1e-7, 1e-5, 1e-8
# fe-cli's calibration from Y = 2.6 (calibrate_scale.py's start and
# optimizer; the TPU record at 480 tets: Y 1.999789 after 30 evaluations,
# benchmarks/notch_hosford/calibrate_scale_480_tpu.json, context only)
CAL_Y_RTOL = 1e-3
CAL_TPU_RECORD = (1.999789, 30)
# the Hosford notch (examples/notch_hosford.yaml as written: a = 100, the
# total form): cmad_tpu on the CPU in f64 with sparse-direct solves, the
# stepped driver, Newton cap 50 (tools/fe_notch_reference.py --mesh
# notch_h0.015.exo --max-iters 50 --effective-stress hosford --gradient,
# jax 0.9.0; the drive took 1284 s and the gradient 1012 s on the CPU
# host): ||U|| and max |alpha| after each step, and J and dJ/dc of the
# notch calibration at Y = 2.6 (GRAD_Y) against the drive at Y = 2.0
FE_HOSFORD_REF_U_NORMS = (0.7867706196622157, 1.5136325048601345,
                          2.0870794364606446, 2.653241683812782)
FE_HOSFORD_REF_ALPHA_MAX = (0.06548113765968518, 0.11197884642607306,
                            0.14088400008567625, 0.1662051122245803)
FE_HOSFORD_GRAD_REF_J = 1.2474083586164162
FE_HOSFORD_GRAD_REF_DJ_DC = 9.079995240406618
# the at-scale records' final ||U|| (benchmarks/notch_hosford/
# scale_ours_47628_two_level_stepped.json: TPU, f32; scale_reference_47628
# .json: the original cmad on a host CPU, f64, SuperLU), printed beside
# ours as context, not as a gate
HOSFORD_TPU_RECORD_U = 2.653198003768921
HOSFORD_REFERENCE_U = 2.6531950649818503
# fe-hosford-small (480 tets, Newton 1e-12, CG at 1e-10) card vs CPU
# (plain path, direct): both Newtons converge to 1e-12 from the same
# start, so U agrees to about that over K's conditioning (2.3e-14 at the
# deck's 1e-8 in a first run on an H100)
HOSFORD_SMALL_BOUND = 1e-9
# mp-hosford: the reduced return map on the benchmark's material with the
# deck's Hosford (a = 100) at 1,048,576 points x 2 steps, each Newton
# capped at MP_HOSFORD_ITERS (the benchmark's increments; at 65,536
# points on the CPU the slowest point took 23)
MP_HOSFORD_ITERS = 100
HOSFORD_MATERIAL = {**MATERIAL, "plastic": {
    **MATERIAL["plastic"], "effective stress": {"hosford": {"a": 100.0}}}}
# examples/notch_hosford.yaml as written, as a dict (the GPU host has no
# PyYAML); tests/cli/test_torch_cli.py holds it equal to the file
NOTCH_HOSFORD_DECK = {
    "problem": {"type": "fe", "name": "notch_hosford"},
    "discretization": {"mesh file": "meshes/notch_h0.080.exo",
                       "build coordinate sidesets": True,
                       "num steps": 4, "step size": 1.0},
    "residuals": {
        "global residual": {
            "type": "small_disp_equilibrium", "def_type": "full_3d",
            "nonlinear max iters": 15, "nonlinear absolute tol": 1.0e-8,
            "nonlinear relative tol": 1.0e-8},
        "local residual": {
            "type": "small_elastic_plastic", "nonlinear max iters": 500,
            "nonlinear absolute tol": 1.0e-12,
            "nonlinear relative tol": 1.0e-12,
            "line search": {"max evals": 100},
            "materials": {"block_1": {
                "elastic": {"E": 1000.0, "nu": 0.25},
                "plastic": {
                    "effective stress": {"hosford": {"a": 100.0}},
                    "flow stress": {
                        "initial yield": {"Y": 2.0},
                        "hardening": {"voce": {"S": 10.0, "D": 2.0}}}}}}}},
    "dirichlet bcs": {"expression": {
        "sym_x": ["equilibrium", 0, "xmin_sides", "0.0"],
        "sym_y": ["equilibrium", 1, "ymin_sides", "0.0"],
        "sym_z": ["equilibrium", 2, "zmin_sides", "0.0"],
        "load_y": ["equilibrium", 1, "ymax_sides", "0.01 * t"]}},
    "output": {"path": "results", "exodus filename": "notch_primal.exo",
               "global residual": ["u"],
               "local residual": {"block_1": ["cauchy", "alpha"]}},
}
# the elastic notch: examples/notch_hosford.yaml's mesh, BCs, E and nu
# with the closed-form elastic model (type: elastic, def_type: full_3d),
# the records' solver, Newton cap 50. cmad_tpu on the CPU in f64 with
# sparse-direct solves (tools/fe_notch_reference.py --mesh
# notch_h0.015.exo --max-iters 50 --model elastic --elastic-stress
# {isotropic_linear,neohookean} --gradient, jax 0.9.0): ||U|| after each
# of the 4 steps, and J and dJ/dc of the elastic calibration (E and nu
# active at ELASTIC_START, E under the log transform about 1000: c = [log(E
# / 1000), nu]; fe_load_match against the reaction of the drive at
# ELASTIC_TRUTH on ymax_sides, component 1)
FE_ELASTIC_REF_U_NORMS = {
    "isotropic_linear": (0.564591204869381, 1.1291824097387488,
                         1.693773614608117, 2.2583648194774852),
    "neohookean": (0.5645590635461878, 1.1290474931164274,
                   1.6934558646930136, 2.2577748998837612),
}
ELASTIC_TRUTH = {"E": 1000.0, "nu": 0.25}
ELASTIC_START = {"E": 1300.0, "nu": 0.3}
FE_ELASTIC_GRAD_REF_J = 0.5550530645164995
FE_ELASTIC_GRAD_REF_DJ_DC = (4.808114624721396, 0.018320759599080805)
# the linear material's U(t_k) against k/4 U(t_4): both are the Newton's
# answer to the deck's 1e-8 relative residual (with CG at 1e-6 under the
# forcing term; at 480 tets on the CPU they differ by 9.9e-14)
ELASTIC_LINEAR_BOUND = 1e-6
# fe-elastic-grad at 47,628 tets: the card's gradient against its central
# difference in c at h = ELASTIC_FD_H (J is quadratic-like in c: the
# truncation is ~h^2 of the gradient; the Newton's stopping noise in J,
# ~1e-8 of it, over 2h adds ~1e-5)
ELASTIC_FD_H, ELASTIC_FD_RTOL = 1e-3, 1e-3
# fe-print: the J2 notch at 480 tets with the local residual's 'print
# convergence: true' (the generic block, the 7-dof Newton) against the J2
# block's drive of the same deck, both with the global Newton at 1e-12
# and CG at 1e-10: they differ by the local Newton's tolerance (1e-12) on
# each point's state (1.9e-11 in U on the CPU with direct solves)
FE_PRINT_BOUND = 1e-9
SEGSUM_SOURCE = "cmad_tpu_torch/csrc/segment_sum.cu"
# R: the roofline experiment's kernel, at its shapes (ops/roofline.py)
ROOFLINE = "benchmarks/local_kernels/roofline_experiment.py"


def grad_deck(mesh: str, solver: dict, data_file, tol=None,
              effective_stress: str = "J2") -> dict:
    """The notch deck at Y = GRAD_Y, Y active under the log transform
    about GRAD_Y_TRUTH, with fe_displacement_match against ``data_file``
    (:func:`save_displacements`)."""
    deck = notch_deck(mesh, solver, effective_stress)
    deck["residuals"]["local residual"]["materials"]["block_1"][
        "plastic"]["flow stress"]["initial yield"] = {
            "Y": {"value": GRAD_Y, "active": True,
                  "transform": {"log": GRAD_Y_TRUTH}}}
    deck["qoi"] = {"name": "fe_displacement_match",
                   "data_file": str(data_file), "weight": GRAD_WEIGHT}
    if tol is not None:
        deck["residuals"]["global residual"].update(
            {"nonlinear absolute tol": tol, "nonlinear relative tol": tol})
    return deck


def hess_deck(mesh: str, solver: dict, data_file, tol=None,
              driver: str = "stepped", effective_stress: str = "J2") -> dict:
    """:func:`grad_deck` with Y = HESS_Y active and no transform (the
    Hessian in Y), through ``driver``."""
    deck = grad_deck(mesh, solver, data_file, tol, effective_stress)
    deck["residuals"]["local residual"]["materials"]["block_1"][
        "plastic"]["flow stress"]["initial yield"] = {
            "Y": {"value": HESS_Y, "active": True}}
    deck["residuals"]["global residual"]["driver"] = driver
    return deck


def save_displacements(state, path: Path) -> Path:
    """A drive's U history, (steps + 1, nodes, 3), saved to ``path``: the
    truth of :func:`grad_deck`."""
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.stack(state.U_history).reshape(
        len(state.U_history), -1, 3))
    return path


def notch_deck(mesh: str, solver: dict, effective_stress: str = "J2"
               ) -> dict:
    """The notch deck on ``mesh`` (a file of examples/meshes) with the
    effective stress ``"J2"`` (swapped in) or ``"hosford"`` (the deck's,
    a = 100)."""
    es = {"J2": {"J2": {}}, "hosford": {"hosford": {"a": 100.0}}}
    return {
        "problem": {"type": "fe", "name": "notch_hosford"},
        "discretization": {"mesh file": str(MESHES / mesh),
                           "build coordinate sidesets": True,
                           "num steps": 4, "step size": 1.0},
        "residuals": {
            "global residual": {
                "type": "small_disp_equilibrium", "def_type": "full_3d",
                "driver": "stepped", "nonlinear max iters": FE_MAX_ITERS,
                "nonlinear absolute tol": 1.0e-8,
                "nonlinear relative tol": 1.0e-8},
            "local residual": {
                "type": "small_elastic_plastic",
                "nonlinear max iters": 500,
                "nonlinear absolute tol": 1.0e-12,
                "nonlinear relative tol": 1.0e-12,
                "line search": {"max evals": 100},
                "materials": {"block_1": {
                    "elastic": {"E": 1000.0, "nu": 0.25},
                    "plastic": {
                        "effective stress": es[effective_stress],
                        "flow stress": {
                            "initial yield": {"Y": 2.0},
                            "hardening": {"voce": {"S": 10.0,
                                                   "D": 2.0}}}}}}}},
        "dirichlet bcs": {"expression": {
            "sym_x": ["equilibrium", 0, "xmin_sides", "0.0"],
            "sym_y": ["equilibrium", 1, "ymin_sides", "0.0"],
            "sym_z": ["equilibrium", 2, "zmin_sides", "0.0"],
            "load_y": ["equilibrium", 1, "ymax_sides", "0.01 * t"]}},
        "linear solver": dict(solver),
    }


def elastic_deck(mesh: str, solver: dict, elastic_stress: str) -> dict:
    """The notch deck with the closed-form elastic model (the deck's E
    and nu) and the Cauchy stress ``elastic_stress``."""
    deck = notch_deck(mesh, solver)
    local = deck["residuals"]["local residual"]
    local.update({"type": "elastic", "elastic_stress": elastic_stress,
                  "materials": {"block_1": {"elastic": dict(
                      ELASTIC_TRUTH)}}})
    return deck


def elastic_grad_deck(mesh: str, solver: dict, data_file,
                      tol=None) -> dict:
    """:func:`elastic_deck` (isotropic linear) with E and nu active at
    ELASTIC_START (E under the log transform about ELASTIC_TRUTH's) and
    fe_load_match against ``data_file``, the truth's y reaction on
    ymax_sides after each step."""
    deck = elastic_deck(mesh, solver, "isotropic_linear")
    deck["residuals"]["local residual"]["materials"]["block_1"] = {
        "elastic": {"E": {"value": ELASTIC_START["E"], "active": True,
                          "transform": {"log": ELASTIC_TRUTH["E"]}},
                    "nu": {"value": ELASTIC_START["nu"], "active": True}}}
    deck["qoi"] = {"name": "fe_load_match", "sideset": "ymax_sides",
                   "components": [1], "data_file": str(data_file),
                   "weight": 1.0}
    if tol is not None:
        deck["residuals"]["global residual"].update(
            {"nonlinear absolute tol": tol, "nonlinear relative tol": tol})
    return deck


def fe_converged(log, nls) -> bool:
    """Every step of the solver log met the Newton's stopping rule."""
    return all(e["final_residual"] < nls["abs tol"]
               or e["final_residual"] < nls["rel tol"] * e["initial_residual"]
               for e in log)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def row_error(out, ref) -> tuple[float, float]:
    """(max abs error, max row-scaled error) over state rows 0-6."""
    diff = (out[:7] - ref[:7]).abs().amax(dim=1)
    scale = ref[:7].abs().amax(dim=1).clamp(min=1.0)
    return float(diff.max()), float((diff / scale).max())


def check_rows(phase, label, out, ref, bound, quiet=False) -> float:
    import torch

    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{phase} {label}: bad output {tuple(out.shape)}")
    if bool((out[7] != 0).any()):
        raise RuntimeError(f"{phase} {label}: pad row is not zero")
    abs_err, rel_err = row_error(out, ref)
    if not quiet:
        say(phase, f"{label}: max_abs_err={abs_err:.3e} "
                   f"max_row_scaled_err={rel_err:.3e} bound={bound:g}")
    if not rel_err <= bound:
        raise RuntimeError(f"{phase} {label}: {rel_err} > {bound}")
    return abs_err


def check_cols(phase, label, out, ref, bound) -> float:
    """Per column of (N, ...) arrays: max|out - ref| <= bound *
    max(1, max|ref column|). Returns the max abs error."""
    import torch

    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{phase} {label}: bad output {tuple(out.shape)}")
    a, b = out.reshape(out.shape[0], -1), ref.reshape(ref.shape[0], -1)
    diff = (a - b).abs().amax(dim=0)
    scale = b.abs().amax(dim=0).clamp(min=1.0)
    abs_err, rel_err = float(diff.max()), float((diff / scale).max())
    say(phase, f"{label}: max_abs_err={abs_err:.3e} "
               f"max_col_scaled_err={rel_err:.3e} bound={bound:g}")
    if not rel_err <= bound:
        raise RuntimeError(f"{phase} {label}: {rel_err} > {bound}")
    return abs_err


def bound_ms(nbytes: float, counts: dict, updates: float,
             plastic_updates: float):
    """The least time the card could take: (ms, "bytes" or
    "operations", bytes ms, operations ms), with the operations of
    ``counts`` (one kernel's entry of ``_sass.library_counts``); the f64
    and f32 pipes run side by side."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max((counts["elastic"][k] * updates
                 + counts["plastic"][k] * plastic_updates)
                / PEAK_OPS[k] * 1e3 for k in PEAK_OPS)
    if t_bytes >= t_ops:
        return t_bytes, "bytes", t_bytes, t_ops
    return t_ops, "operations", t_bytes, t_ops


def range_scalars(sc):
    """The two materials of the out-of-f32-range history cases, as
    [mu, lam, Y, S, D], from the headline's f64 ``sc``: (a) mu, lam, Y
    and S x RANGE_SCALE, so that trial stresses reach about 1e39 with dg
    unchanged; (b) moderate stresses, with S = 1e5 and D = 4e33: S D =
    4e38, beyond f32's 3.4e38."""
    mu, lam, Y, S, D = sc.tolist()
    k = RANGE_SCALE
    return {"a: scaled 1e37": sc.new_tensor([mu * k, lam * k, Y * k, S * k, D]),
            "b: S D 4e38": sc.new_tensor([mu, lam, Y, 1e5, 4e33])}


def yield_residual(out, plastic, sc) -> float:
    """max |phi - Y - S (1 - exp(-D alpha))| / Y over the ``plastic``
    points of an (8, N) state."""
    import torch

    _mu, _lam, Y, S, D = (float(v) for v in sc.tolist())
    p = (out[0] + out[3] + out[5]) / 3.0
    phi = torch.sqrt(1.5 * ((out[0] - p) ** 2 + (out[3] - p) ** 2
                            + (out[5] - p) ** 2
                            + 2.0 * (out[1] ** 2 + out[2] ** 2
                                     + out[4] ** 2)))
    resid = (phi - Y - S * (1.0 - torch.exp(-D * out[6])))[plastic]
    return float(resid.abs().max()) / Y


def mises_3x3(s):
    """von Mises stress of (..., 3, 3) tensors."""
    import torch

    tr = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1) / 3.0
    d = s - tr[..., None, None] * torch.eye(3, dtype=s.dtype,
                                            device=s.device)
    return torch.sqrt(1.5 * (d * d).sum(dim=(-2, -1)))


def best_ms(fn, x0, sync) -> float:
    """Best of ROUNDS rounds of REPS chained calls (each call's output
    is the next one's input), ms per call, CUDA events around each round
    after one warm-up call."""
    import torch

    fn(x0)
    sync()
    best = math.inf
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        st = x0
        start.record()
        for _ in range(REPS):
            st = fn(st)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / REPS)
    return best


def _replay_ms(calls, sync, keep=False) -> float:
    """Device ms per call of the ``calls`` (each a function of no
    arguments), captured in this order in one CUDA graph and replayed,
    best of ROUNDS replays after a warm-up, so that the launches run back
    to back without the host's dispatch. With ``keep`` what the calls
    return is kept until the graph is gone, so that no two calls share an
    output; without, each call's output is freed for the next one's, as on
    a path that drops it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in dict.fromkeys(calls):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    sync()
    graph = torch.cuda.CUDAGraph()
    kept = []
    with torch.cuda.graph(graph):
        for fn in calls:
            out = fn()
            if keep:
                kept.append(out)
            del out
    graph.replay()
    sync()
    best = math.inf
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / len(calls))
    del graph, kept
    return best


def graph_ms(fn, sync) -> float:
    """Device ms per call of ``fn()``, GRAPH_REPS calls in one CUDA graph
    (:func:`_replay_ms`): warm, the inputs of one call in the L2 for the
    next, as a path that calls it on the same inputs runs it."""
    return _replay_ms([fn] * GRAPH_REPS, sync)


def _tensors(a) -> list:
    """The tensors of ``a``: a tensor, a dataclass of tensors (a segment
    plan) or a tuple of these."""
    import dataclasses

    import torch

    if isinstance(a, torch.Tensor):
        return [a]
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return [v for f in dataclasses.fields(a)
                for v in _tensors(getattr(a, f.name))]
    if isinstance(a, tuple):
        return [v for x in a for v in _tensors(x)]
    return []


def _fresh(a):
    """``a`` with every tensor in it copied to new device memory."""
    import dataclasses

    import torch

    if isinstance(a, torch.Tensor):
        return a.clone()
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return dataclasses.replace(a, **{
            f.name: _fresh(getattr(a, f.name))
            for f in dataclasses.fields(a)})
    if isinstance(a, tuple):
        return tuple(_fresh(x) for x in a)
    return a


def cold_ms(fn, args: tuple, sync, nbytes: int | None = None) -> float:
    """Device ms per call of ``fn(*args)`` with its inputs cold in the L2:
    copies of ``args`` whose ``nbytes`` (the bytes a call reads; by
    default every tensor in ``args``) add up to more than COLD_L2_FACTOR
    times the L2 (at least two copies), called in turn in one CUDA graph
    of at least GRAPH_REPS calls (:func:`_replay_ms`), so that each call
    reads its inputs from device memory and writes outputs of its own, as
    the byte bound counts them. Pass ``nbytes`` where ``args`` hold
    tensors the call does not read (a plan's other index arrays): counted,
    they would leave too few copies to push the read ones out of the L2."""
    if nbytes is None:
        nbytes = sum(t.numel() * t.element_size() for t in _tensors(args))
    copies = max(2, COLD_L2_FACTOR * L2_BYTES // max(nbytes, 1) + 1)
    sets = [args] + [_fresh(args) for _ in range(copies - 1)]
    calls = [lambda a=a: fn(*a) for a in sets]
    reps = copies * math.ceil(GRAPH_REPS / copies)
    return _replay_ms([calls[i % copies] for i in range(reps)], sync,
                      keep=True)


def start_floor_build(nvcc: str, flags, out: Path):
    """nvcc on FLOOR_SRC into ``out``/floor.so, started, not waited for:
    ``(process, library path)``."""
    out.mkdir(parents=True, exist_ok=True)
    src = out / "floor.cu"
    src.write_text(FLOOR_SRC)
    lib = out / "floor.so"
    return subprocess.Popen([nvcc, *flags, "-shared", "-o", str(lib),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def load_floor(proc, lib: Path):
    """The library FLOOR_SRC built into, its entry declared."""
    import ctypes

    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the launch floor's kernel:\n{log}")
    floor = ctypes.CDLL(str(lib))
    floor.empty_run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    floor.empty_run.restype = ctypes.c_int
    return floor


def main() -> int:
    import torch
    from torch.utils.checkpoint import checkpoint

    # ---------------- 1. device ----------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs "
                         "only on a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cmad_tpu_torch.config import newton_tols
    from cmad_tpu_torch.fem.xi_carrier import pack_xi, unpack_xi
    from cmad_tpu_torch.models.global_fields import GlobalFieldsAtPoint
    from cmad_tpu_torch.models.nonlinear_solver import (
        make_newton_solve_with_stats,
    )
    from cmad_tpu_torch.models.small_elastic_plastic import (
        SmallElasticPlastic,
    )
    from cmad_tpu_torch.models.small_rate_elastic_plastic import (
        SmallRateElasticPlastic,
    )
    from cmad_tpu_torch.ops import _build, _sass
    from cmad_tpu_torch.ops import cuda_radial_return as cuda_rr
    from cmad_tpu_torch.ops.j2_radial_return import (
        j2_voce_scalars,
        make_j2_radial_return,
        make_j2_radial_return_total,
        pack_state_soa,
        soa_step_scalars,
        strain_increment_soa,
        unpack_state_soa,
    )
    from cmad_tpu_torch.ops.j2_soa_ad import make_soa_step_ad
    from cmad_tpu_torch.ops.return_map import (
        make_batched_return_map,
        make_j2_history_drive,
    )
    from cmad_tpu_torch.parameters.parameters import (
        Parameters,
        parameters_from_numpy,
    )

    clock = [time.perf_counter()]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        say(phase, f"wall {now - clock[0]:.1f} s")
        clock[0] = now

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    say("device", f"{kind}, {count} visible, torch {torch.__version__}, "
                  f"CUDA {torch.version.cuda}")
    sync = torch.cuda.synchronize
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = (torch.float64, torch.float32)
    params = {dt: parameters_from_numpy(MATERIAL, dtype=dt, device=dev)
              for dt in dtypes}
    scalars = {dt: j2_voce_scalars(params[dt].values, dt) for dt in dtypes}

    def increment(n, dtype):
        """The benchmark's strain increment: symmetric, 1.5e-3 std."""
        eps = 1.5e-3 * torch.randn((n, 3, 3), generator=gen, device=dev,
                                   dtype=dtype)
        eps = 0.5 * (eps + eps.transpose(1, 2))
        return strain_increment_soa(eps, torch.zeros_like(eps))

    def zero_state(n, dtype):
        return pack_state_soa(torch.zeros((n, 7), device=dev, dtype=dtype))

    def plain_drive(xi, de_hist, sc, plastic_updates=None):
        """The plain step looped over the history; appends each step's
        count of plastic points to ``plastic_updates`` if given."""
        for t in range(de_hist.shape[0]):
            new = soa_step_scalars(xi, de_hist[t], sc)
            if plastic_updates is not None:
                plastic_updates.append(int((new[6] > xi[6]).sum()))
            xi = new
        return xi

    def advanced(n, dtype):
        """A mixed state: three plain steps of a tenth of the increment
        from rest, so that alpha > 0 on part of the points; returns the
        state and the next increment."""
        de = 0.1 * increment(n, dtype)
        xi = plain_drive(zero_state(n, dtype), de.expand(3, 8, n),
                         scalars[dtype])
        return xi, de

    # ---------------- 2. build ----------------
    t0 = time.perf_counter()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    floor_build = start_floor_build(_build._nvcc(), _build.NVCC_FLAGS, work)
    path, log = _build.build()
    _build.load_library()
    floor_lib = load_floor(*floor_build)
    say("build", f"{time.perf_counter() - t0:.2f} s -> {path.name}"
                 f"{' (cached)' if not log else ''}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say("build", line.strip())
    ops = _sass.library_counts(path)
    for kname, c in sorted(ops.items()):
        say("build", f"{kname} SASS operations per update: elastic "
                     f"{c['elastic']}, a plastic update adds {c['plastic']}; "
                     f"{c['mnemonics']}")
    lap("build")

    results = {}

    # ---------------- 3. parity-step ----------------
    for dt in dtypes:
        name = str(dt).split(".")[-1]
        xi, de = advanced(N_STEP, dt)
        out = cuda_rr.soa_step_scalars_cuda(xi, de, scalars[dt])
        ref = soa_step_scalars(xi, de, scalars[dt])
        frac = float((out[6] > xi[6]).double().mean())
        say("parity-step", f"{name} N={N_STEP}: plastic fraction {frac:.4f}, "
                           f"alpha>0 before the step on "
                           f"{float((xi[6] > 0).double().mean()):.4f}")
        if not 0.0 < frac < 1.0:
            raise RuntimeError("parity-step: the step is not mixed")
        check_rows("parity-step", f"{name} N={N_STEP}", out, ref,
                   STEP_BOUND[name])
        n8 = N_STEP - N_STEP % 8
        xw, dw = xi[:, :n8].contiguous(), de[:, :n8].contiguous()
        wide = cuda_rr._to_wide(cuda_rr.soa_step_scalars_cuda(
            cuda_rr._from_wide(cuda_rr._to_wide(xw)),
            cuda_rr._from_wide(cuda_rr._to_wide(dw)), scalars[dt]))
        narrow = cuda_rr.soa_step_scalars_cuda(xw, dw, scalars[dt])
        if not torch.equal(cuda_rr._from_wide(wide), narrow) or \
                cuda_rr._to_wide(xw).data_ptr() != xw.data_ptr():
            raise RuntimeError("parity-step: the wide view differs")
        say("parity-step", f"{name} wide (64, {n8 // 8}) view: bit-identical")
        del xi, de, out, ref, xw, dw, wide, narrow
    # f64 outside the range of the step's f32 Newton phase, one step from
    # rest on the materials of range_scalars: against the plain step and
    # the yield condition, (a) also against RANGE_SCALE times the step on
    # the headline material (which takes the f32 phase)
    sc64 = scalars[torch.float64]
    xi, de = zero_state(N_HIST, torch.float64), increment(N_HIST,
                                                         torch.float64)
    unscaled = cuda_rr.soa_step_scalars_cuda(xi, de, sc64)
    for label, sc in range_scalars(sc64).items():
        out = cuda_rr.soa_step_scalars_cuda(xi, de, sc)
        check_rows("parity-step", f"float64 {label} N={N_HIST} vs the plain "
                   f"step", out, soa_step_scalars(xi, de, sc),
                   STEP_BOUND["float64"])
        plastic = out[6] > xi[6]
        if not bool(plastic.any()):
            raise RuntimeError(f"parity-step: {label}: no point yields")
        resid = yield_residual(out, plastic, sc)
        say("parity-step", f"float64 {label}: {int(plastic.sum())} of "
                           f"{N_HIST} points yield; max |phi - Y - H(alpha)| "
                           f"/ Y {resid:.3e} (bound {YIELD_TOL:g})")
        if not resid <= YIELD_TOL:
            raise RuntimeError(f"parity-step: {label}: yield condition "
                               f"missed")
        if label.startswith("a"):
            k = out.new_tensor([RANGE_SCALE] * 6 + [1.0, 1.0])[:, None]
            check_rows("parity-step", f"float64 {label} vs {RANGE_SCALE:g} "
                       f"x the headline material's", out, k * unscaled,
                       RANGE_BOUND)
        del out
    del xi, de, unscaled
    # the step at the FE dispatch's shape
    xi, de = advanced(N_FE, torch.float64)
    results["step_err"] = check_rows(
        "parity-step", f"float64 N={N_FE}",
        cuda_rr.soa_step_scalars_cuda(xi, de, scalars[torch.float64]),
        soa_step_scalars(xi, de, scalars[torch.float64]),
        STEP_BOUND["float64"])
    del xi, de
    sync()
    lap("parity-step")

    # ---------------- 4. parity-history ----------------
    def history_input(n, t_steps, dtype, std=1.5e-3 / 16):
        de_hist = torch.zeros((t_steps, 8, n), device=dev, dtype=dtype)
        de_hist[:, :6] = std * torch.randn(
            (t_steps, 6, n), generator=gen, device=dev, dtype=dtype)
        return de_hist

    for dt in dtypes:
        name = str(dt).split(".")[-1]
        worst = 0.0
        for n in N_HIST_EDGES:
            for T in T_HIST:
                xi0 = zero_state(n, dt)
                de_hist = history_input(n, T, dt)
                out = cuda_rr.soa_history_cuda(xi0, de_hist, scalars[dt])
                ref = plain_drive(xi0, de_hist, scalars[dt])
                if n == N_HIST and T >= 13:
                    say("parity-history", f"{name} N={n} T={T}: plastic "
                                          f"fraction "
                                          f"{float((out[6] > 0).double().mean()):.4f}")
                    check_rows("parity-history", f"{name} N={n} T={T}", out,
                               ref, HIST_BOUND[name])
                else:
                    abs_err = check_rows("parity-history", f"{name} N={n} "
                                         f"T={T}", out, ref,
                                         HIST_BOUND[name], quiet=True)
                    worst = max(worst, abs_err)
                del xi0, de_hist, out, ref
        say("parity-history", f"{name}: N in {N_HIST_EDGES} x T in {T_HIST}: "
                              f"all within {HIST_BOUND[name]:g}, max abs "
                              f"err {worst:.3e} at the short edges")
        # against T chained j2_soa_step launches, and the yield condition
        # on the points that yield in the last step
        T = T_HIST[-1]
        xi0 = zero_state(N_HIST, dt)
        de_hist = history_input(N_HIST, T, dt)
        out = cuda_rr.soa_history_cuda(xi0, de_hist, scalars[dt])
        before = cuda_rr.soa_history_cuda(xi0, de_hist[:T - 1], scalars[dt])
        xs = xi0
        for t in range(T):
            xs = cuda_rr.soa_step_scalars_cuda(xs, de_hist[t], scalars[dt])
        diff = float((out - xs).abs().max())
        say("parity-history", f"{name} N={N_HIST} T={T}: j2_soa_history vs "
                              f"{T} chained j2_soa_step launches: max abs "
                              f"diff {diff:.3e} (bit-identical: "
                              f"{bool(torch.equal(out, xs))})")
        check_rows("parity-history", f"{name} j2_soa_history vs chained "
                   f"j2_soa_step", out, xs, HIST_BOUND[name])
        if dt == torch.float64:
            plastic = out[6] > before[6]
            resid = yield_residual(out, plastic, scalars[dt])
            say("parity-history", f"{name} N={N_HIST} T={T}: "
                                  f"{int(plastic.sum())} points yield in "
                                  f"the last step; max |phi - Y - "
                                  f"H(alpha)| / Y {resid:.3e} (bound "
                                  f"{YIELD_TOL:g})")
            if not resid <= YIELD_TOL:
                raise RuntimeError("parity-history: yield condition missed")
        del xi0, de_hist, out, before, xs
    # f64 outside the range of the kernel's f32 Newton phase: against the
    # plain loop and the yield condition; (a) also against RANGE_SCALE
    # times the kernel's output on the headline material
    dt = torch.float64
    xi0 = zero_state(N_HIST, dt)
    de_hist = history_input(N_HIST, T_RANGE, dt, std=1.5e-3)
    unscaled = cuda_rr.soa_history_cuda(xi0, de_hist, scalars[dt])
    for label, sc in range_scalars(scalars[dt]).items():
        out = cuda_rr.soa_history_cuda(xi0, de_hist, sc)
        before = cuda_rr.soa_history_cuda(xi0, de_hist[:-1], sc)
        check_rows("parity-history", f"float64 {label} N={N_HIST} "
                   f"T={T_RANGE} vs the plain loop", out,
                   plain_drive(xi0, de_hist, sc), HIST_BOUND["float64"])
        plastic = out[6] > before[6]
        if not bool(plastic.any()):
            raise RuntimeError(f"parity-history: {label}: no point yields")
        resid = yield_residual(out, plastic, sc)
        say("parity-history", f"float64 {label}: {int(plastic.sum())} "
                              f"points yield in the last step; max |phi - "
                              f"Y - H(alpha)| / Y {resid:.3e} (bound "
                              f"{YIELD_TOL:g})")
        if not resid <= YIELD_TOL:
            raise RuntimeError(f"parity-history: {label}: yield condition "
                               f"missed")
        if label.startswith("a"):
            k = out.new_tensor([RANGE_SCALE] * 6 + [1.0, 1.0])[:, None]
            check_rows("parity-history", f"float64 {label} vs "
                       f"{RANGE_SCALE:g} x the headline material's",
                       out, k * unscaled, RANGE_BOUND)
        del out, before
    del xi0, de_hist, unscaled
    sync()
    lap("parity-history")

    # ---------------- 5. history-drive (main path) ----------------
    cuda_rr.reset_launch_counts()
    hist_plastic: list[int] = []
    drive = make_j2_history_drive(params[torch.float64])
    drive_wide = make_j2_history_drive(params[torch.float64], layout="wide")
    timings = {}
    for dt in dtypes:
        name = str(dt).split(".")[-1]
        pv, sc = params[dt].values, scalars[dt]
        de = increment(N_DRIVE, dt)
        # headline: every point yields; mixed: about 57% do; elastic:
        # none does, which times the bytes alone
        for regime, factor in (("headline", 1.0),
                               ("mixed", 0.045 * 8 / T_DRIVE),
                               ("elastic", 1e-3)):
            de_hist = (factor * de).expand(T_DRIVE, 8, N_DRIVE).contiguous()
            xi0 = zero_state(N_DRIVE, dt)
            out = drive(xi0, de_hist, pv)
            headline64 = name == "float64" and regime == "headline"
            ref = plain_drive(xi0, de_hist, sc,
                              hist_plastic if headline64 else None)
            frac = float((out[6] > 0).double().mean())
            if (regime == "elastic") != (frac == 0.0):
                raise RuntimeError(f"history-drive: {regime} regime has "
                                   f"plastic fraction {frac}")
            label = f"{name} {regime} N={N_DRIVE} T={T_DRIVE}"
            err = check_rows("history-drive", label, out, ref,
                             HIST_BOUND[name])
            if headline64:
                results["hist_err"] = err
            # the TPU's wide kernels K7/K8 are this launch on a view
            wide = drive_wide(cuda_rr._to_wide(xi0), cuda_rr._to_wide(de_hist),
                              pv)
            if not torch.equal(cuda_rr._from_wide(wide), out):
                raise RuntimeError("history-drive: layout='wide' differs")
            say("history-drive", f"{label}: layout='wide' bit-identical")
            del out, ref, wide
            # every drive from xi0, so that each timed call is the regime
            ms = best_ms(lambda _x: drive(xi0, de_hist, pv), xi0, sync)
            plain = best_ms(lambda _x: plain_drive(xi0, de_hist, sc), xi0,
                            sync)
            ups = N_DRIVE * T_DRIVE / (ms * 1e-3)
            plain_ups = N_DRIVE * T_DRIVE / (plain * 1e-3)
            timings[("drive", name, regime)] = (ms, plain)
            say("history-drive", f"{label}: plastic fraction {frac:.4f}; "
                                 f"kernel {ms:.3f} ms/drive = {ups:.4g} "
                                 f"updates/s; plain {plain:.3f} ms/drive = "
                                 f"{plain_ups:.4g} updates/s")
            del de_hist, xi0
            sync()
            torch.cuda.empty_cache()
        del de
    lap("history-drive")

    # ---------------- 6. fe-dispatch (main path) ----------------
    step_ad = make_soa_step_ad()
    E = N_FE // FE_Q
    dt = torch.float64
    xi_aos = torch.zeros((E, FE_Q, 7), device=dev, dtype=dt)
    de = increment(N_FE, dt)

    def fe_chain(x_aos, de_, sc_, step):
        xc = pack_xi(x_aos)
        for _ in range(FE_STEPS):
            xc = step(xc, de_, sc_)
        return unpack_xi(xc, E, FE_Q)

    def plain_ckpt(xc, de_, sc_):
        # recompute each plain step in the backward pass: the graph of
        # 8 unrolled steps at this size would hold ~30 GB
        return checkpoint(
            soa_step_scalars, xc, de_, sc_, use_reentrant=False)

    with torch.no_grad():
        out = fe_chain(xi_aos, de, scalars[dt], step_ad)
        ref = fe_chain(xi_aos, de, scalars[dt], soa_step_scalars)
    if out.shape != (E, FE_Q, 7):
        raise RuntimeError(f"fe-dispatch: shape {tuple(out.shape)}")
    frac = float((out[..., 6] > 0).double().mean())
    def pad(a):  # (E, Q, 7) -> (8, N) rows, for the row check
        return torch.cat([a.reshape(-1, 7).T, a.new_zeros((1, N_FE))])

    check_rows("fe-dispatch", f"forward float64 N={N_FE} x {FE_STEPS} steps "
                              f"(plastic fraction {frac:.4f})",
               pad(out), pad(ref), HIST_BOUND["float64"])
    del out, ref

    w = torch.randn((E, FE_Q, 7), generator=gen, device=dev, dtype=dt)
    grads = []
    for step in (step_ad, plain_ckpt):
        de_g = de.clone().requires_grad_(True)
        sc_g = scalars[dt].clone().requires_grad_(True)
        loss = (w * fe_chain(xi_aos, de_g, sc_g, step)).sum()
        grads.append(torch.autograd.grad(loss, (de_g, sc_g)))
        del loss, de_g, sc_g
    (k_de, k_sc), (p_de, p_sc) = grads
    de_err = float((k_de - p_de).abs().max() / p_de.abs().max())
    sc_err = float(((k_sc - p_sc).abs() / p_sc.abs()).max())
    say("fe-dispatch", f"grad of a weighted sum: de rel err {de_err:.3e}, "
                       f"scalars rel err {sc_err:.3e} (rtol {GRAD_RTOL:g}); "
                       f"d/d[mu, lam, Y, S, D] = "
                       f"{[float(f'{v:.6e}') for v in k_sc.tolist()]}")
    if not (de_err <= GRAD_RTOL and sc_err <= GRAD_RTOL):
        raise RuntimeError("fe-dispatch: gradients disagree")
    del grads, k_de, k_sc, p_de, p_sc, w

    with torch.no_grad():
        ms = best_ms(lambda x: fe_chain(x, de, scalars[dt], step_ad),
                     xi_aos, sync)
        plain = best_ms(lambda x: fe_chain(x, de, scalars[dt],
                                           soa_step_scalars), xi_aos, sync)
        updates = N_FE * FE_STEPS
        say("fe-dispatch", f"forward chain N={N_FE} x {FE_STEPS}: kernel "
                           f"{ms:.3f} ms = {updates / (ms * 1e-3):.4g} "
                           f"updates/s; plain {plain:.3f} ms = "
                           f"{updates / (plain * 1e-3):.4g} updates/s")
        xc0 = pack_xi(xi_aos)
        step_ms = best_ms(lambda x: step_ad(x, de, scalars[dt]), xc0, sync)
        step_plain = best_ms(lambda x: soa_step_scalars(x, de, scalars[dt]),
                             xc0, sync)
        step_plastic = int((soa_step_scalars(xc0, de, scalars[dt])[6] > 0)
                           .sum())
        say("fe-dispatch", f"one step N={N_FE}: kernel {step_ms:.4f} ms, "
                           f"plain {step_plain:.4f} ms")
        timings[("fe", "float64")] = (ms, plain)
        timings[("step", "float64")] = (step_ms, step_plain)
    launches = cuda_rr.launch_counts()
    del xi_aos, de, xc0
    sync()
    torch.cuda.empty_cache()
    lap("fe-dispatch")

    # ---------------- 7. consistency ----------------
    dt = torch.float64
    mu, lam, Y, S, D = (float(v) for v in scalars[dt].tolist())
    xi, de = advanced(N_STEP, dt)
    out = cuda_rr.soa_step_scalars_cuda(xi, de, scalars[dt])
    tr = de[0] + de[3] + de[5]
    trial = torch.stack([xi[r] + 2.0 * mu * de[r]
                         + (lam * tr if r in (0, 3, 5) else 0.0)
                         for r in range(6)])

    def mises(s):
        p = (s[0] + s[3] + s[5]) / 3.0
        return torch.sqrt(1.5 * ((s[0] - p) ** 2 + (s[3] - p) ** 2
                                 + (s[5] - p) ** 2
                                 + 2.0 * (s[1] ** 2 + s[2] ** 2
                                          + s[4] ** 2)))

    f_trial = mises(trial) - Y - S * (1.0 - torch.exp(-D * xi[6]))
    plastic = out[6] > xi[6]
    sure = f_trial.abs() > YIELD_TOL * Y
    if bool((plastic != (f_trial > 0))[sure].any()):
        raise RuntimeError("consistency: yield classification differs")
    resid = (mises(out[:6]) - Y - S * (1.0 - torch.exp(-D * out[6])))[plastic]
    max_resid = float(resid.abs().max())
    row_scale = trial.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    el_err = float(((out[:6] - trial).abs() / row_scale)[:, ~plastic]
                   .max()) if bool((~plastic).any()) else 0.0
    el_alpha = bool(torch.equal(out[6][~plastic], xi[6][~plastic]))
    say("consistency", f"N={N_STEP}: {int(plastic.sum())} plastic, "
                       f"{int((~plastic).sum())} elastic; max |phi - Y - "
                       f"H(alpha)| on plastic points {max_resid:.3e} "
                       f"(bound {YIELD_TOL * Y:g}); elastic points: trial "
                       f"stress to {el_err:.3e}, alpha unchanged: {el_alpha}")
    if not (max_resid <= YIELD_TOL * Y and el_err <= 1e-12 and el_alpha):
        raise RuntimeError("consistency: the return map misses the oracle")
    del xi, de, out, trial
    sync()
    lap("consistency")

    # ---------------- 8. parity-aos, parity-total ----------------
    def sym_grad(n, dtype):
        """The benchmark's displacement gradient (bench.py:404-411):
        symmetric, N(0, 1.5e-3)."""
        g = 1.5e-3 * torch.randn((n, 3, 3), generator=gen, device=dev,
                                 dtype=dtype)
        return (0.5 * (g + g.transpose(1, 2))).contiguous()

    def aos_zero(n, dtype):
        return torch.zeros((n, 7), device=dev, dtype=dtype)

    aos_kernel = {
        "rate": lambda x, g, g0, sc: cuda_rr.aos_step_cuda(x, g, g0, sc),
        "total": lambda x, g, g0, sc: cuda_rr.total_step_cuda(x, g, sc)}
    aos_plain = {"rate": make_j2_radial_return,
                 "total": make_j2_radial_return_total}
    for form, phase in (("rate", "parity-aos"), ("total", "parity-total")):
        errs = []
        for dt in dtypes:
            name = str(dt).split(".")[-1]
            plain = aos_plain[form](params[dt])
            pv, sc = params[dt].values, scalars[dt]
            g = sym_grad(N_STEP, dt)
            z, g2, x0 = torch.zeros_like(g), (1.7 * g).contiguous(), \
                aos_zero(N_STEP, dt)
            k1 = aos_kernel[form](x0, g, z, sc)
            p1 = plain(x0, g, z, pv)
            k2 = aos_kernel[form](k1[0], g2, g, sc)
            p2 = plain(p1[0], g2, g, pv)
            fracs = [float((k[0][:, 6] > x[:, 6]).double().mean())
                     for k, x in ((k1, x0), (k2, k1[0]))]
            say(phase, f"{name} N={N_STEP}: plastic fraction {fracs[0]:.4f} "
                       f"(step 1), {fracs[1]:.4f} (step 2: 1.7 g from g)")
            if not 0.0 < fracs[0] < 1.0:
                raise RuntimeError(f"{phase}: step 1 is not mixed")
            for label, a, b in (("step 1 xi", k1[0], p1[0]),
                                ("step 1 sigma", k1[1], p1[1]),
                                ("step 2 xi", k2[0], p2[0]),
                                ("step 2 sigma", k2[1], p2[1])):
                err = check_cols(phase, f"{name} {label}", a, b,
                                 STEP_BOUND[name])
                if name == "float64":
                    errs.append(err)
            if not all(torch.equal(k[1], k[1].transpose(1, 2))
                       for k in (k1, k2)):
                raise RuntimeError(f"{phase}: sigma is not symmetric")
            say(phase, f"{name}: sigma exactly symmetric")
            del g, z, g2, x0, k1, k2, p1, p2
        results[f"{form}_err"] = max(errs)
        # ragged last tiles (N = tile - 1, tile + 1, 2 tile + 1), and
        # inputs that start one row into their storage (56 B into xi,
        # 72 B into grad_u), for both forms
        for dt in dtypes:
            name = str(dt).split(".")[-1]
            plain = aos_plain[form](params[dt])
            pv, sc = params[dt].values, scalars[dt]
            for n in (AOS_TILE - 1, AOS_TILE + 1, 2 * AOS_TILE + 1):
                for offset in (0, 1):
                    m = n + offset
                    g = sym_grad(m, dt)[offset:]
                    g0 = (0.3 * sym_grad(m, dt))[offset:]
                    if form == "rate":
                        x0 = unpack_state_soa(advanced(m, dt)[0])
                    else:  # a plastic strain and alpha from one step
                        x0 = plain(aos_zero(m, dt), 0.8 * sym_grad(m, dt),
                                   torch.zeros_like(g0), pv)[0]
                    x0 = x0.contiguous()[offset:]
                    if offset and (x0.data_ptr() % 16 == 0
                                   or g.data_ptr() % 16 == 0):
                        raise RuntimeError(f"{phase}: the view is "
                                           f"16 B aligned")
                    k1 = aos_kernel[form](x0, g, g0, sc)
                    p1 = plain(x0, g, g0, pv)
                    frac = float((k1[0][:, 6] > x0[:, 6]).double().mean())
                    for label, a, b in (("xi", k1[0], p1[0]),
                                        ("sigma", k1[1], p1[1])):
                        check_cols(phase, f"{name} N={n} offset {offset} "
                                   f"(plastic fraction {frac:.3f}) row "
                                   f"{label}", a, b, STEP_BOUND[name])
                    if not torch.equal(k1[1], k1[1].transpose(1, 2)):
                        raise RuntimeError(f"{phase}: N={n} offset "
                                           f"{offset}: sigma is not "
                                           f"symmetric")
            say(phase, f"{name}: sigma exactly symmetric at N = "
                       f"{AOS_TILE - 1}, {AOS_TILE + 1}, {2 * AOS_TILE + 1}, "
                       f"offsets 0 and 1")
        sync()
        lap(phase)

    # ---------------- 9. mp-batched (main path) ----------------
    # the material-point models through make_batched_return_map, built
    # the way a user builds them: Parameters on its default device (the
    # card)
    mp_models = {"rate": SmallRateElasticPlastic,
                 "total": SmallElasticPlastic}
    mp_kernel = {"rate": "j2_aos_step", "total": "j2_total_step"}
    mp_g = {dt: sym_grad(N_MP, dt) for dt in dtypes}
    mp_runs = {}
    cuda_rr.reset_launch_counts()
    for form, cls in mp_models.items():
        for dt in dtypes:
            model = cls(Parameters(MATERIAL, dtype=dt))
            step = make_batched_return_map(model, specialize=True)
            pv, g = model.parameters.values, mp_g[dt]
            z, g2, x0 = torch.zeros_like(g), (1.7 * g).contiguous(), \
                aos_zero(N_MP, dt)
            before = cuda_rr.launch_counts()
            xi1, s1 = step(x0, g, z, pv)
            xi2, s2 = step(xi1, g2, g, pv)
            expect = {**before,
                      mp_kernel[form]: before[mp_kernel[form]] + 2}
            if cuda_rr.launch_counts() != expect:
                raise RuntimeError(f"mp-batched: {form} launched "
                                   f"{cuda_rr.launch_counts()}, expected "
                                   f"{expect}")
            mp_runs[(form, dt)] = (model, step, xi1, s1, xi2, s2)
    sync()
    mp_launches = cuda_rr.launch_counts()
    say("mp-batched", f"main path launches (4 calls per kernel: 2 chained "
                      f"steps x f64, f32): {mp_launches}")

    for (form, dt), (model, step, xi1, s1, xi2, s2) in mp_runs.items():
        name = str(dt).split(".")[-1]
        label = f"{form} {name} N={N_MP}"
        pv, g = model.parameters.values, mp_g[dt]
        z, g2, x0 = torch.zeros_like(g), (1.7 * g).contiguous(), \
            aos_zero(N_MP, dt)
        plain = aos_plain[form](model.parameters)
        p1 = plain(x0, g, z, pv)
        p2 = plain(p1[0], g2, g, pv)
        for what, a, b in (("step 1 xi", xi1, p1[0]),
                           ("step 1 sigma", s1, p1[1]),
                           ("step 2 xi", xi2, p2[0]),
                           ("step 2 sigma", s2, p2[1])):
            check_cols("mp-batched", f"{label} {what}", a, b,
                       STEP_BOUND[name])
        del p1, p2
        plastic1 = int((xi1[:, 6] > 0).sum())
        if name == "float64":
            mu, lam, Y, S, D = (float(v) for v in
                                j2_voce_scalars(pv, dt).tolist())
            for k, (xp, x, sg) in enumerate(((x0, xi1, s1),
                                             (xi1, xi2, s2)), start=1):
                plastic = x[:, 6] > xp[:, 6]
                resid = (mises_3x3(sg) - Y
                         - S * (1.0 - torch.exp(-D * x[:, 6])))[plastic]
                worst = float(resid.abs().max())
                say("mp-batched", f"{label} step {k}: {int(plastic.sum())} "
                                  f"plastic points, max |phi - Y - "
                                  f"H(alpha)| {worst:.3e} (bound "
                                  f"{YIELD_TOL * Y:g})")
                if not worst <= YIELD_TOL * Y:
                    raise RuntimeError("mp-batched: yield condition missed")
        sc = j2_voce_scalars(pv, dt)
        ms = best_ms(lambda x: aos_kernel[form](x, g, z, sc)[0], x0, sync)
        entry = best_ms(lambda x: step(x, g, z, pv)[0], x0, sync)
        plain_t = best_ms(lambda x: plain(x, g, z, pv)[0], x0, sync)
        say("mp-batched", f"{label}: kernel {ms:.4f} ms "
                          f"({N_MP / (ms * 1e-3):.4g} updates/s), entry "
                          f"point {entry:.4f} ms, plain {plain_t:.4f} ms")
        timings[("mp", form, name)] = (ms, entry, plain_t, plastic1)
        del model, step, xi1, s1, xi2, s2, z, g2, x0
    del mp_runs
    sync()
    torch.cuda.empty_cache()
    lap("mp-batched")

    # ---------------- 10. mp-generic ----------------
    dt = torch.float64
    model = SmallRateElasticPlastic(Parameters(MATERIAL, dtype=dt))
    pv = model.parameters.values
    g = mp_g[dt][:N_GENERIC].contiguous()
    z, g2, x0 = torch.zeros_like(g), (1.7 * g).contiguous(), \
        aos_zero(N_GENERIC, dt)
    generic = make_batched_return_map(model)
    special = make_batched_return_map(model, specialize=True)

    def two_steps(step):
        xi1, s1 = step(x0, g, z, pv)
        xi2, s2 = step(xi1, g2, g, pv)
        return xi1, s1, xi2, s2

    sync()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        gen_out = two_steps(generic)
        sync()
        peak = torch.cuda.max_memory_allocated()
        gen_ms = math.inf
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            two_steps(generic)
            end.record()
            end.synchronize()
            gen_ms = min(gen_ms, start.elapsed_time(end))
        spec_out = two_steps(special)
    worst = max(float((a - b).abs().max())
                for a, b in zip(gen_out, spec_out, strict=True))
    over = sum(int(((a - b).abs() > 1e-9).any(dim=-1).reshape(-1).sum())
               for a, b in zip(gen_out[::2], spec_out[::2], strict=True))
    mu = float(j2_voce_scalars(pv, dt)[0])
    generic_atol = GENERIC_TOL_FACTOR * 2.0 * mu * newton_tols("mp_local",
                                                                 dt)[0]
    stats = make_newton_solve_with_stats(model.residual_fun,
                                         in_dims=(0, None, 0, 0))

    def fields(gu):
        return GlobalFieldsAtPoint({"u": gu.new_zeros(gu.shape[:-1])},
                                   {"u": gu})

    it1 = stats(x0, x0, pv, fields(g), fields(z))[1]
    it2 = stats(gen_out[0], gen_out[0], pv, fields(g2), fields(g))[1]
    max_it = int(max(it1.max(), it2.max()))
    gen_ups = 2 * N_GENERIC / (gen_ms * 1e-3)
    say("mp-generic", f"float64 N={N_GENERIC} x 2 steps: "
                      f"{gen_ms:.1f} ms = {gen_ups:.4g} updates/s; "
                      f"most Newton iterations of a point {max_it} "
                      f"(step 1 mean {float(it1.double().mean()):.3f}, "
                      f"step 2 mean {float(it2.double().mean()):.3f}); "
                      f"peak memory {peak / 2**30:.2f} GiB; max |generic - "
                      f"radial return| {worst:.3e} (atol {generic_atol:.3g} "
                      f"= {GENERIC_TOL_FACTOR:g} x 2 mu x abs_tol; "
                      f"{over} point-steps past 1e-9)")
    if not worst <= generic_atol:
        raise RuntimeError("mp-generic: the Newton disagrees with the "
                           "radial return")
    del gen_out, spec_out, it1, it2, generic, special
    sync()
    torch.cuda.empty_cache()
    lap("mp-generic")

    # ---------------- 11. mp-gradient ----------------
    gp = Parameters(MATERIAL, GRAD_FLAGS, GRAD_TRANSFORMS, dtype=dt)
    model = SmallRateElasticPlastic(gp)
    a0 = torch.tensor(gp.flat_active_values(), dtype=dt, device=dev)
    g = mp_g[dt][:N_GRAD].contiguous()
    z, x0 = torch.zeros_like(g), aos_zero(N_GRAD, dt)
    w = torch.randn((N_GRAD, 3, 3), generator=gen, device=dev, dtype=dt)
    grads = []
    for step in (make_batched_return_map(model),
                 make_j2_radial_return(gp)):
        a = a0.clone().requires_grad_(True)
        _, sg = step(x0, g, z, gp.tree_with_flat_active(a))
        grads.append(torch.autograd.grad((w * sg).sum(), a)[0])
    got, ref = grads
    rel = float(((got - ref).abs() / ref.abs()).max())
    say("mp-gradient", f"float64 N={N_GRAD}: d/d[E, D, S, Y] of a weighted "
                       f"sum of sigma, implicit-function rule "
                       f"{[float(f'{v:.10e}') for v in got.tolist()]} vs "
                       f"autograd through the plain radial return: max rel "
                       f"err {rel:.3e} (rtol {MP_GRAD_RTOL:g})")
    if not (bool(torch.isfinite(got).all()) and rel <= MP_GRAD_RTOL):
        raise RuntimeError("mp-gradient: gradients disagree")
    del model, g, z, x0, w, grads
    sync()
    lap("mp-gradient")

    # ---------------- 12. mp-hosford ----------------
    # the reduced 4-dof Hosford Newton through make_batched_return_map
    # (specialize=True) on the benchmark's material with the deck's
    # Hosford (a = 100), the benchmark's increments over 2 chained steps,
    # against the generic 7-dof Newton on the same model; each point's
    # iterations from the same reduced solve with its log on
    from cmad_tpu_torch.ops.hosford_return import (
        make_hosford_strain_solve,
        strain_rows,
    )
    model = SmallElasticPlastic(Parameters(HOSFORD_MATERIAL, dtype=dt))
    pv = model.parameters.values
    g = mp_g[dt][:N_GENERIC].contiguous()
    z, g2, x0 = torch.zeros_like(g), (1.7 * g).contiguous(), \
        aos_zero(N_GENERIC, dt)
    reduced = make_batched_return_map(model, max_iters=MP_HOSFORD_ITERS,
                                      specialize=True)
    generic = make_batched_return_map(model, max_iters=MP_HOSFORD_ITERS)

    def two_steps(step):
        xi1, s1 = step(x0, g, z, pv)
        xi2, s2 = step(xi1, g2, g, pv)
        return xi1, s1, xi2, s2

    def timed_two_steps(step):
        sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = two_steps(step)
        sync()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    with torch.no_grad():
        two_steps(reduced)           # the first call's one-time costs
        red_out, red_s, red_peak = timed_two_steps(reduced)
        gen_out, gen_s, gen_peak = timed_two_steps(generic)
        solve = make_hosford_strain_solve(model, max_iters=MP_HOSFORD_ITERS)

        def fields(gu):
            return GlobalFieldsAtPoint({"u": gu.new_zeros(gu.shape[:-1])},
                                       {"u": gu})

        iters = [solve.iterations(xi_p, pv, strain_rows(
            "total", fields(gu), fields(gu_p)))
            for xi_p, gu, gu_p in ((x0, g, z), (red_out[0], g2, g))]
    capped = [int((it >= MP_HOSFORD_ITERS).sum()) for it in iters]
    done = (iters[0] < MP_HOSFORD_ITERS) & (iters[1] < MP_HOSFORD_ITERS)
    worst = {name: float((a - b).abs()[done].max())
             for name, a, b in zip(("xi1", "sigma1", "xi2", "sigma2"),
                                   red_out, gen_out, strict=True)}
    mu = float(j2_voce_scalars(pv, dt)[0])
    red_atol = GENERIC_TOL_FACTOR * 2.0 * mu * newton_tols("mp_local", dt)[0]
    plastic = [int((red_out[0][:, 6] > 0).sum()),
               int((red_out[2][:, 6] > red_out[0][:, 6]).sum())]
    it_mean = [round(float(it.double().mean()), 4) for it in iters]
    say("mp-hosford", f"float64 N={N_GENERIC} x 2 steps, a = 100, at most "
                      f"{MP_HOSFORD_ITERS} Newton iterations: reduced "
                      f"{red_s * 1e3:.1f} ms = "
                      f"{2 * N_GENERIC / red_s:.4g} updates/s (host clock "
                      f"around synchronized work), peak memory "
                      f"{red_peak / 2**30:.2f} GiB; generic 7-dof "
                      f"{gen_s * 1e3:.1f} ms = "
                      f"{2 * N_GENERIC / gen_s:.4g} updates/s, peak "
                      f"{gen_peak / 2**30:.2f} GiB; plastic points per step "
                      f"{plastic}; most iterations of a point "
                      f"{[int(it.max()) for it in iters]} (mean "
                      f"{it_mean}), points at the cap {capped}; max "
                      f"|reduced - "
                      f"generic| over the points that converged "
                      f"{ {k: f'{v:.3e}' for k, v in worst.items()} } "
                      f"(sigma atol {red_atol:.3g} = {GENERIC_TOL_FACTOR:g} "
                      f"x 2 mu x abs_tol)")
    if not (all(bool(torch.isfinite(t).all()) for t in red_out)
            and worst["sigma1"] <= red_atol and worst["sigma2"] <= red_atol
            and min(plastic) > 0 and int(done.sum()) > 0):
        raise RuntimeError("mp-hosford: the reduced and generic Newtons "
                           "disagree")
    del model, g, z, g2, x0, red_out, gen_out, iters, done, mp_g
    sync()
    torch.cuda.empty_cache()
    lap("mp-hosford")

    # ---------------- the FE J2 primal and gradient on the notch ---------
    from cmad_tpu_torch.cli import fe_subcommands as fs
    from cmad_tpu_torch.cli.fe_common import (
        build_fe_J_of_params_flat,
        build_fe_problem_from_deck,
        build_fe_stepped_hessian_fn,
        build_fe_stepped_vg,
        fe_params_overlay,
        fe_primal_drive,
        nonlinear_settings,
    )
    from cmad_tpu_torch.fem.stepped_adjoint import build_fe_stepped_hvp
    from cmad_tpu_torch.io.exodus import read_results
    from cmad_tpu_torch.io.results import FieldSpec
    from cmad_tpu_torch.models.var_types import VarType
    from cmad_tpu_torch.ops import roofline as rl
    from cmad_tpu_torch.ops import segment_sum as segsum
    from cmad_tpu_torch.fem.assembly import (
        assemble_global,
        gather_element_U,
        params_by_block_from_models,
    )
    from cmad_tpu_torch.fem.j2_block import soa_step_inputs
    from cmad_tpu_torch.fem.nonlinear_solver import (
        get_two_level_pattern,
        solve_linear,
    )
    from cmad_tpu_torch.fem.sparse_solve import (
        _csr_operator,
        _embedded_bc_enforce,
        _embedded_residual,
    )
    from cmad_tpu_torch.fem.two_level import (
        coarse_matrix,
        make_two_level_preconditioner,
    )
    from cmad_tpu_torch.fem.xi_carrier import pack_xi_by_block
    from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode
    from cmad_tpu_torch.qois.fe_load_match import FELoadMatch

    def reset_counts():
        cuda_rr.reset_launch_counts()
        segsum.reset_launch_counts()

    def read_counts():
        return {**cuda_rr.launch_counts(), **segsum.launch_counts()}

    def fe_drive(phase, bundle, k1_per_assembly=1, **resume):
        """The deck's primal from its bundle with the kernels' launches
        counted from 0: (state, log, per-step stats, launches, peak
        bytes). The J2 block launches j2_soa_step once per assembly; the
        point-batch block (Hosford, ``k1_per_assembly=0``) never.
        ``resume`` (``t_schedule``, ``U_init``, ``xi_init_by_block``)
        drives the rest of the schedule from a stored state."""
        sync()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        stats: list = []
        state, log = fe_primal_drive(bundle, stats, **resume)
        sync()
        k1 = read_counts()
        peak = torch.cuda.max_memory_allocated()
        implied = sum(s["assemblies"] for s in stats)
        say(phase, f"j2_soa_step launches {k1['j2_soa_step']}; assemblies "
                   f"implied by the Newton and line-search iterations "
                   f"(each Newton start, each probe, each step's residual "
                   f"pair) {implied}; all kernels {k1}")
        if k1["j2_soa_step"] != k1_per_assembly * implied \
                or implied < len(stats) \
                or not all(k1[k] for k in ("segment_sum_tile",
                                           "segment_sum_block",
                                           "coarse_pair_sum", "csr_matvec")):
            raise RuntimeError(f"{phase}: launches {k1}, assemblies "
                               f"{implied}")
        nls = nonlinear_settings(bundle)
        for k, (s, e) in enumerate(zip(stats, log, strict=True), start=1):
            cg = s.get("cg_iters", [])
            say(phase, f"step {k}: wall {s['wall_s']:.3f} s, "
                       f"{s['newton_iters']} Newton iterations, "
                       f"{s['assemblies']} assemblies, CG iterations per "
                       f"solve {cg} (mean {np.mean(cg) if cg else 0:.1f}); "
                       f"||R|| {e['initial_residual']:.6e} -> "
                       f"{e['final_residual']:.3e}")
        if not fe_converged(log, nls):
            raise RuntimeError(f"{phase}: a step missed the deck's "
                               f"tolerance: {log}")
        U = np.stack(state.U_history)
        if not np.isfinite(U).all():
            raise RuntimeError(f"{phase}: non-finite U")
        return state, log, stats, k1, peak

    def ms_of(fn) -> float:
        """Best of ROUNDS rounds of REPS calls of ``fn()``, ms per call."""
        return best_ms(lambda _x: fn(), None, sync)

    def step_floor(n):
        """An empty kernel on K1's grid for n points at the FE notch's
        shape (K1_THREADS): its launch floor."""
        rc = floor_lib.empty_run(-(-n // K1_THREADS), K1_THREADS,
                                 torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch floor: CUDA error {rc}")

    def k1_sets(phase, n, sc):
        """j2_soa_step at the FE shape on two sets beside the notch's own
        inputs: every point elastic, and every point plastic, from rest
        (the increment scaled so that each point's trial Mises stress is
        below Y / 2, or above 2 Y), against the plain step and timed warm
        and cold on the device."""
        mu, Y = float(sc[0]), float(sc[2])
        x0 = zero_state(n, sc.dtype)
        de = increment(n, sc.dtype)
        p = (de[0] + de[3] + de[5]) / 3.0
        phi = 2.0 * mu * torch.sqrt(1.5 * (
            (de[0] - p) ** 2 + (de[3] - p) ** 2 + (de[5] - p) ** 2
            + 2.0 * (de[1] ** 2 + de[2] ** 2 + de[4] ** 2)))
        for label, k, want in (("all-elastic", 0.5 * Y / float(phi.max()), 0),
                               ("all-plastic", 2.0 * Y / float(phi.min()),
                                n)):
            dk = k * de
            out = cuda_rr.soa_step_scalars_cuda(x0, dk, sc)
            check_rows(phase, f"j2_soa_step {label} N={n}", out,
                       soa_step_scalars(x0, dk, sc), STEP_BOUND["float64"])
            plastic = int((out[6] > 0).sum())
            if plastic != want:
                raise RuntimeError(f"{phase}: the {label} set has {plastic} "
                                   f"plastic points of {n}")
            warm = graph_ms(
                lambda dk=dk: cuda_rr.soa_step_scalars_cuda(x0, dk, sc), sync)
            cold = cold_ms(cuda_rr.soa_step_scalars_cuda, (x0, dk, sc), sync)
            say(phase, f"j2_soa_step {label} N={n} ({plastic} plastic): "
                       f"device {cold:.4f} ms cold, {warm:.4f} ms warm")

    def traced_device_ms(fn):
        """(device ms, kernels) of one call of ``fn``, from the CUDA
        kernel events of one traced call."""
        from torch.profiler import ProfilerActivity, profile

        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        kernels = [ev for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA]
        return (sum(ev.time_range.elapsed_us() for ev in kernels) * 1e-3,
                len(kernels))

    def fe_unit_times(phase, bundle, state, stats, with_floor=False,
                      trace=False):
        """Times of the step's parts at the last step of the drive: one
        assembly with its embedded-BC pair (and its device time from one
        traced call, with ``trace``), K1 alone and its plain version
        (with their parity; device times from a CUDA graph, warm and cold,
        K1's launch floor ``with_floor``, and K1's wrapper timed from the
        host), the two-level setup and one two-level CG solve of the
        step's first Newton system at the solver's rtol floor."""
        fe = bundle.fe_problem
        ka = fe.kernel_arrays
        dtp = fe.dtype
        params = params_by_block_from_models(fe)
        k = len(state.U_history) - 1
        t = float(state.t_history[k])
        U_prev = torch.as_tensor(state.U_at(k - 1), dtype=dtp, device=dev)
        U = torch.as_tensor(state.U_at(k), dtype=dtp, device=dev)
        xi_prev = pack_xi_by_block(
            fe, {"block_1": torch.as_tensor(state.xi_at(k - 1, "block_1"),
                                            dtype=dtp, device=dev)})
        presc = ka.prescribed_indices
        pv = torch.as_tensor(fe.dof_map.evaluate_prescribed_values(
            ka.dbc_arrays, t), dtype=dtp, device=dev)

        def assemble(Ux):
            K, R, xi = assemble_global(fe, ka, params, Ux, U_prev, t,
                                       xi_prev_by_block=xi_prev)
            K_data, K_ii = _embedded_bc_enforce(K, presc)
            return _embedded_residual(R, K, Ux, presc, pv, K_ii), K_data, xi

        with torch.no_grad():
            asm_ms = ms_of(lambda: assemble(U))
            asm_dev = (traced_device_ms(lambda: assemble(U)) if trace
                       else None)
            # K1 at the main path's shape, on the step's own inputs
            gradN = ka.geometry_cache["block_1"]["per_elem"]["grad_N_phys"][0]
            xs, ds, sc = soa_step_inputs(
                "total", params["block_1"],
                gather_element_U(U, ka, "block_1")[0],
                gather_element_U(U_prev, ka, "block_1")[0], gradN,
                xi_prev["block_1"])
            out = cuda_rr.soa_step_scalars_cuda(xs, ds, sc)
            k1_err = check_rows(phase, f"j2_soa_step on the last step's "
                                f"inputs, N={xs.shape[1]}", out,
                                soa_step_scalars(xs, ds, sc),
                                STEP_BOUND["float64"])
            k1_plastic = int((out[6] > xs[6]).sum())
            k1_ms = graph_ms(
                lambda: cuda_rr.soa_step_scalars_cuda(xs, ds, sc), sync)
            k1_cold = cold_ms(cuda_rr.soa_step_scalars_cuda, (xs, ds, sc),
                              sync)
            k1_floor = (graph_ms(lambda: step_floor(xs.shape[1]), sync)
                        if with_floor else None)
            k1_plain = graph_ms(lambda: soa_step_scalars(xs, ds, sc), sync)
            k1_plain_cold = cold_ms(soa_step_scalars, (xs, ds, sc), sync)
            k1_host = ms_of(
                lambda: cuda_rr.soa_step_scalars_cuda(xs, ds, sc))
            k1_sets(phase, xs.shape[1], sc)
            # the step's first Newton system
            r0, K0, _ = assemble(U_prev)
            lss = bundle.resolved["linear solver"]
            sp = fe.embedded_sparsity
            pattern = get_two_level_pattern(fe)

            def setup():
                unique = _csr_operator(K0, sp)[0]
                return make_two_level_preconditioner(
                    pattern, unique, sp.rows, sp.col_indices,
                    unique[sp.diag_idx])

            setup_ms = ms_of(setup)
            floor = {**lss, "adaptive rtol": False}
            solve_stats: dict = {}
            solve_linear(K0, fe, ka, -r0, floor, stats=solve_stats)
            iters = solve_stats["cg_iters"][0]
            solve_ms = ms_of(lambda: solve_linear(K0, fe, ka, -r0, floor))
        n = xs.shape[1]
        b_ms, by, t_bytes, t_ops = bound_ms(
            BYTES_PER_K1_POINT * n, ops["j2_soa_step<double>"], n, k1_plastic)
        per_iter = (solve_ms - setup_ms) / max(iters, 1)
        floor_note = ("" if k1_floor is None else
                      f"; launch floor (an empty kernel on its grid, "
                      f"{-(-n // K1_THREADS)} blocks of {K1_THREADS}, the "
                      f"same graph) {k1_floor:.4f} ms, so "
                      f"{k1_cold - k1_floor:.4f} ms cold above it")
        say(phase, f"one assembly (the J2 block with K1, the COO dedup, the "
                   f"embedded-BC pair) {asm_ms:.4f} ms; j2_soa_step "
                   f"N={n} ({k1_plastic} plastic): device {k1_cold:.4f} ms "
                   f"per launch cold, {k1_ms:.4f} ms warm (the same inputs "
                   f"again, {GRAPH_REPS} launches in a CUDA graph)"
                   f"{floor_note}; plain device {k1_plain_cold:.4f} ms "
                   f"cold, {k1_plain:.4f} warm; through the wrapper from the host {k1_host:.4f} ms "
                   f"(host dispatch included); bound {b_ms:.4f} ms ({by}; "
                   f"bytes {t_bytes:.4f} ms at {BYTES_PER_K1_POINT} B per "
                   f"point, operations {t_ops:.4f} ms) = "
                   f"{b_ms / k1_cold:.1%} of the cold time")
        if asm_dev is not None:
            say(phase, f"one assembly traced: device {asm_dev[0]:.3f} ms in "
                       f"{asm_dev[1]} kernels, {asm_dev[0] / asm_ms:.1%} of "
                       f"its host time")
        say(phase, f"one linear solve (cg + two_level, rtol "
                   f"{floor['rtol']:g}, max iters {floor['max iters']}) of "
                   f"the step's first Newton system: "
                   f"{solve_ms:.3f} ms for {iters} CG iterations; two-level "
                   f"setup {setup_ms:.3f} ms (coarse dim "
                   f"{pattern.coarse_dim}), {per_iter:.4f} ms per CG "
                   f"iteration")
        n_asm = sum(s["assemblies"] for s in stats)
        n_solves = sum(len(s.get("cg_iters", [])) for s in stats)
        n_cg = sum(sum(s.get("cg_iters", [])) for s in stats)
        wall = sum(s["wall_s"] for s in stats)
        est_asm = n_asm * asm_ms * 1e-3
        est_k1 = n_asm * k1_host * 1e-3
        est_solve = (n_solves * setup_ms + n_cg * per_iter) * 1e-3
        say(phase, f"where the drive's {wall:.3f} s go (counts x the unit "
                   f"times above): {n_asm} assemblies {est_asm:.3f} s "
                   f"(of which K1's wrapper {est_k1:.4f} s), {n_solves} "
                   f"linear solves "
                   f"with {n_cg} CG iterations {est_solve:.3f} s ("
                   f"{est_solve / max(n_solves, 1) * 1e3:.2f} ms per solve), "
                   f"the rest "
                   f"(line-search bookkeeping, host) "
                   f"{wall - est_asm - est_solve:.3f} s")
        return {"k1_ms": k1_ms, "k1_cold": k1_cold, "k1_plain": k1_plain,
                "k1_plain_cold": k1_plain_cold, "k1_err": k1_err,
                "k1_bound": (b_ms, by, t_bytes, t_ops), "n": n,
                "asm_ms": asm_ms, "asm_dev": asm_dev}

    # ---------------- fe-notch-small ----------------
    bundle = build_fe_problem_from_deck(notch_deck(FE_SMALL_MESH,
                                                   FE_CG_TIGHT))
    if bundle.fe_problem.device.type != "cuda":
        raise RuntimeError("fe-notch-small: the entry point left the card")
    gpu_state, _log, _stats, _k1, _peak = fe_drive("fe-notch-small", bundle)
    cpu_bundle = build_fe_problem_from_deck(
        notch_deck(FE_SMALL_MESH, FE_DIRECT), device="cpu")
    cpu_state, cpu_log = fe_primal_drive(cpu_bundle)
    if not fe_converged(cpu_log, nonlinear_settings(cpu_bundle)):
        raise RuntimeError("fe-notch-small: the CPU drive did not converge")
    U_gpu, U_cpu = np.stack(gpu_state.U_history), np.stack(cpu_state.U_history)
    small_rel = float(np.abs(U_gpu - U_cpu).max() / np.abs(U_cpu).max())
    say("fe-notch-small", f"480 tets x 4 steps, card (j2_soa_step, cg + "
                          f"two_level) vs CPU (plain step, direct): "
                          f"max|U_gpu - U_cpu| / max|U_cpu| {small_rel:.3e} "
                          f"(bound {FE_SMALL_BOUND:g}); ||U|| per step "
                          f"{[float(f'{np.linalg.norm(u):.10f}') for u in gpu_state.U_history[1:]]}")
    if not small_rel <= FE_SMALL_BOUND:
        raise RuntimeError("fe-notch-small: card and CPU disagree")
    del bundle, cpu_bundle, gpu_state, cpu_state
    lap("fe-notch-small")

    # ---------------- fe-notch ----------------
    t0 = time.perf_counter()
    bundle = build_fe_problem_from_deck(notch_deck(FE_MESH, FE_RECORDS))
    fe = bundle.fe_problem
    say("fe-notch", f"{FE_MESH}: {fe.mesh.connectivity.shape[0]} tets, "
                    f"{fe.mesh.nodes.shape[0]} nodes, "
                    f"{fe.dof_map.num_total_dofs} dofs; problem built in "
                    f"{time.perf_counter() - t0:.2f} s (host)")
    t0 = time.perf_counter()
    state, log, stats, fe_counts, peak = fe_drive("fe-notch", bundle)
    drive_s = time.perf_counter() - t0
    norms = [float(np.linalg.norm(u)) for u in state.U_history[1:]]
    alphas = [float(np.abs(state.xi_at(k, "block_1")[..., 6]).max())
              for k in range(1, len(state.U_history))]
    worst = max(max(abs(a - b) / b for a, b in zip(norms, FE_REF_U_NORMS,
                                                    strict=True)),
                max(abs(a - b) / b for a, b in zip(alphas, FE_REF_ALPHA_MAX,
                                                    strict=True)))
    say("fe-notch", f"4 steps in {drive_s:.3f} s ({drive_s / 4:.3f} s per "
                    f"step), peak memory {peak / 2**30:.3f} GiB; ||U|| per "
                    f"step {norms}, max |alpha| {alphas}; against cmad_tpu "
                    f"(CPU f64, direct) {list(FE_REF_U_NORMS)}: max rel "
                    f"err {worst:.3e} (bound {FE_REF_RTOL:g})")
    if not worst <= FE_REF_RTOL:
        raise RuntimeError("fe-notch: the drive misses cmad_tpu's answer")
    fe_k1 = fe_unit_times("fe-notch", bundle, state, stats, with_floor=True,
                          trace=True)
    say("fe-notch", f"j2_soa_step launches per step "
                    f"{[s['assemblies'] for s in stats]} at N = "
                    f"{fe_k1['n']}")
    sync()
    torch.cuda.empty_cache()
    lap("fe-notch")

    # ---------------- determinism ----------------
    # the same drive again in this process: bit for bit the same U
    # history, Newton path and CG counts
    state2, _log2, stats2, _c2, _p2 = fe_drive("determinism", bundle)
    paths = [[s["newton_iters"] for s in st] for st in (stats, stats2)]
    cgs = [[s.get("cg_iters", []) for s in st] for st in (stats, stats2)]
    same_U = np.array_equal(np.stack(state.U_history),
                            np.stack(state2.U_history))
    say("determinism", f"47,628 tets, two drives: Newton iterations per "
                       f"step {paths[0]} and {paths[1]}; CG iterations "
                       f"equal: {cgs[0] == cgs[1]}; U histories "
                       f"bit-identical: {same_U}")
    if not (same_U and paths[0] == paths[1] and cgs[0] == cgs[1]):
        raise RuntimeError("determinism: two drives of the notch differ")
    del state2
    # segment_sum on every plan of the FE path at this size against its
    # plain version, index_add_ on the CPU, bit for bit, on the kernel the
    # plan picks (segment_path) and on every other path that takes its
    # width; on its own path timed on the device (CUDA graph) warm and cold
    # beside index_add_ on the card with the tile path's int32 index. The
    # kernels line reports the assembly's dedup plan (segment_sum_tile,
    # 47,628 x 144 COO entries) and the two-level restriction
    # (segment_sum_block, every CG iteration)
    ka = fe.kernel_arrays
    two = get_two_level_pattern(fe).on(dev, torch.float64)
    plans = {"residual scatter": (ka.eq_plan_by_block["block_1"][0], ()),
             "COO dedup": (ka.coo_dedup_plan, ()),
             "COO rows": (ka.coo_row_plan, ()),
             "CSR dedup": (fe.embedded_sparsity.dedup_plan, ()),
             "two-level restriction": (two["agg_plan"], (6,)),
             "coarse pairs": (two["pair_plan"], (6, 6))}
    # each plan by its shape, for fe-grad's launches per plan
    plan_labels = {(plan.n_entries, plan.n_segments,
                    int(np.prod(width, dtype=np.int64))): label
                   for label, (plan, width) in plans.items()}
    for label, (plan, width) in plans.items():
        vals = torch.randn((plan.n_entries, *width), generator=gen,
                           device=dev, dtype=torch.float64)
        scale = (torch.randn(plan.n_entries, generator=gen, device=dev,
                             dtype=torch.float64)
                 if label == "two-level restriction" else None)
        w = int(np.prod(width, dtype=np.int64))
        path = segsum.segment_path(plan, w)
        seg_out = segsum.segment_sum(vals, plan, scale)
        if plan.target is None:      # entries outside every segment
            idx, src = plan.sorted_target, vals[plan.perm]
        else:
            idx, src = plan.target, vals
        if scale is not None:
            src = src * scale.reshape(-1, *([1] * len(width)))
        cpu_ref = torch.zeros(seg_out.shape, dtype=torch.float64).index_add_(
            0, idx.cpu(), src.cpu())
        seg_equal = bool(torch.equal(seg_out.cpu(), cpu_ref))
        others = [p_ for p_ in ("tile", "block") if p_ != path
                  and (p_ != "block" or w <= segsum.BLOCK_MAX_WIDTH)]
        for other in others:
            if not torch.equal(segsum.segment_sum_cuda(
                    vals, plan, scale, path=other).cpu(), cpu_ref):
                raise RuntimeError(f"determinism: segment_sum's {other} "
                                   f"path ({label}) differs from the CPU")
        # the entries the plan sums (the CSR dedup leaves the prescribed
        # rows and columns out), each value, index and output once
        summed = int(plan.sorted_target.shape[0])
        shape = (summed, w, plan.n_segments, plan.perm is not None,
                 scale is not None)
        seg_warm = graph_ms(lambda: segsum.segment_sum(vals, plan, scale),
                            sync)
        seg_ms = cold_ms(segsum.segment_sum, (vals, plan, scale), sync,
                         segsum_bytes(*shape))
        idx32 = idx.to(torch.int32)

        def index_add(idx_, src_, shape=seg_out.shape):
            return src_.new_zeros(shape).index_add_(0, idx_, src_)

        lib_warm = graph_ms(lambda: index_add(idx32, src), sync)
        lib_ms = cold_ms(index_add, (idx32, src), sync)
        seg_bound, seg_bound64 = (max(
            segsum_bytes(*shape, index_bytes=ib) / HBM_BYTES_PER_S,
            summed * w * (1 + (scale is not None)) / PEAK_OPS["fp64"]) * 1e3
            for ib in (4, 8))
        say("determinism", f"segment_sum, {label} ({plan.n_entries} entries "
                           f"x {w} into {plan.n_segments}, longest "
                           f"{plan.max_length}): {path} path; card vs "
                           f"index_add_ on the CPU bit-identical: "
                           f"{seg_equal}, through the {' and '.join(others)} "
                           f"path too; device time {seg_ms:.4f} ms "
                           f"cold ({seg_warm:.4f} warm), index_add_ (int32) "
                           f"on the card {lib_ms:.4f} ms cold ({lib_warm:.4f} "
                           f"warm); bound {seg_bound:.4f} ms (bytes, int32 "
                           f"indices; {seg_bound64:.4f} with int64) = "
                           f"{seg_bound / seg_ms:.1%} of the cold time")
        if not seg_equal:
            raise RuntimeError(f"determinism: segment_sum ({label}) differs "
                               f"from the CPU")
        if label in ("COO dedup", "two-level restriction"):
            # the plain version is index_add_ (on the CPU); on the card it
            # is the library call too
            results["segsum" if label == "COO dedup" else "segsum_block"] = (
                float((seg_out.cpu() - cpu_ref).abs().max()),
                (seg_warm, seg_ms), (lib_warm, lib_ms), (lib_warm, lib_ms),
                seg_bound)
        del vals, scale, seg_out, cpu_ref, src
    # the CG's product on the step's first Newton system: csr_matvec
    # against its plain version on the CPU (csr_matvec_plain: each row in
    # ascending column order) bit for bit, and against PyTorch's CSR product
    # (cuSPARSE) to a tolerance; the plain version and cuSPARSE with the
    # kernel's int32 indices timed beside it
    sp = fe.embedded_sparsity
    K0 = _embedded_bc_enforce(assemble_global(
        fe, ka, params_by_block_from_models(fe),
        torch.zeros(sp.n, dtype=torch.float64, device=dev),
        torch.zeros(sp.n, dtype=torch.float64, device=dev), 1.0,
        xi_prev_by_block=pack_xi_by_block(fe, {
            "block_1": torch.as_tensor(state.xi_at(0, "block_1"),
                                       device=dev)}))[0],
        ka.prescribed_indices)[0]
    unique = segsum.segment_sum(K0, sp.dedup_plan)
    x = torch.randn(sp.n, generator=gen, device=dev, dtype=torch.float64)
    crow32, col32 = sp.csr.rows.offsets, sp.csr.cols
    A = csr_tensor(crow32, col32, unique, sp.n)
    y = segsum.csr_matvec_cuda(sp.csr, unique, x)
    y_plain = segsum.csr_matvec_plain(
        segsum.csr_plan(sp.indptr_np, sp.col_indices_np, "cpu"),
        unique.cpu(), x.cpu())
    csr_equal = bool(torch.equal(y.cpu(), y_plain))
    y_lib = A @ x
    csr_err = float((y.cpu() - y_plain).abs().max())
    csr_rel = float((y - y_lib).abs().max()) / float(y_lib.abs().max())
    csr_warm = graph_ms(lambda: segsum.csr_matvec_cuda(sp.csr, unique, x),
                        sync)
    nnz = sp.num_unique
    read = csr_bytes(nnz, sp.n)
    csr_ms = cold_ms(segsum.csr_matvec_cuda, (sp.csr, unique, x), sync,
                     read)
    plain_warm = graph_ms(lambda: segsum.csr_matvec_plain(sp.csr, unique, x),
                          sync)
    plain_cold = cold_ms(segsum.csr_matvec_plain, (sp.csr, unique, x), sync,
                         read)
    csr_lib_warm = graph_ms(lambda: A @ x, sync)
    csr_lib = cold_ms(lambda ip, ci, u, xx: csr_tensor(
        ip, ci, u, sp.n) @ xx, (crow32, col32, unique, x), sync)
    csr_bound, csr_bound64 = (max(
        csr_bytes(nnz, sp.n, index_bytes=ib) / HBM_BYTES_PER_S,
        2 * nnz / PEAK_OPS["fp64"]) * 1e3 for ib in (4, 8))
    say("determinism", f"csr_matvec ({sp.n} rows, {nnz} nonzeros, "
                       f"{int(sp.csr.rows.tiles.shape[0]) - 1} tiles) vs "
                       f"csr_matvec_plain on the CPU bit-identical: "
                       f"{csr_equal}; vs PyTorch's CSR product: max rel err "
                       f"{csr_rel:.3e} (bound {STEP_BOUND['float64']:g}, "
                       f"summation order); device {csr_ms:.4f} ms cold "
                       f"({csr_warm:.4f} warm), its plain version on the "
                       f"card {plain_cold:.4f} ms cold ({plain_warm:.4f} "
                       f"warm), cuSPARSE (int32) {csr_lib:.4f} ms cold "
                       f"({csr_lib_warm:.4f} warm); bound {csr_bound:.4f} ms "
                       f"(bytes, int32 indices; {csr_bound64:.4f} with "
                       f"int64) = {csr_bound / csr_ms:.1%} of the cold time")
    if not (csr_equal and csr_rel <= STEP_BOUND["float64"]):
        raise RuntimeError("determinism: csr_matvec disagrees")
    results["csr"] = (csr_err, (csr_warm, csr_ms), (plain_warm, plain_cold),
                      (csr_lib_warm, csr_lib), csr_bound)
    # the coarse-pair contraction on the same K: the fused kernel
    # (coarse_pair_sum) against coarse_matrix on the CPU bit for bit, and
    # timed beside the composition it replaces (the (nnz, 6, 6) products
    # materialized by PyTorch, then segment_sum) and beside index_add_ of
    # the materialized products on the card
    pattern = get_two_level_pattern(fe)
    pair_plan = two["pair_plan"]
    pair_args = (unique, two["order"], sp.rows, sp.col_indices,
                 two["P_vals"], pair_plan)
    S = segsum.coarse_pair_sum(*pair_args)
    S_plain = segsum.coarse_pair_sum_plain(*pair_args)
    A_card = coarse_matrix(pattern, unique, sp.rows, sp.col_indices)
    A_cpu = coarse_matrix(pattern, unique.cpu(), sp.rows.cpu(),
                          sp.col_indices.cpu())
    pair_equal = (bool(torch.equal(A_card.cpu(), A_cpu))
                  and bool(torch.equal(S.cpu(), S_plain.cpu())))
    pair_warm = graph_ms(lambda: segsum.coarse_pair_sum(*pair_args), sync)
    pair_ms = cold_ms(segsum.coarse_pair_sum, pair_args, sync)
    composed_ms = graph_ms(lambda: segsum.coarse_pair_sum_plain(*pair_args),
                           sync)
    composed_cold = cold_ms(segsum.coarse_pair_sum_plain, pair_args, sync)
    cm_ms = graph_ms(lambda: coarse_matrix(pattern, unique, sp.rows,
                                           sp.col_indices), sync)
    r_o, c_o = sp.rows[two["order"]], sp.col_indices[two["order"]]
    block = (unique[two["order"]][:, None, None]
             * two["P_vals"][r_o][:, :, None]
             * two["P_vals"][c_o][:, None, :])
    pair_lib = graph_ms(lambda: block.new_zeros(S.shape).index_add_(
        0, pair_plan.sorted_target, block), sync)
    del block, r_o, c_o
    # each of order, unique, rows, cols read once per entry (8 B), P once,
    # the plan's offsets and schedule (int32), the sums written once; 42
    # products and 36 adds per entry
    n_pairs = pair_plan.n_segments
    pair_bytes = (8 * (4 * nnz + two["P_vals"].numel() + 36 * n_pairs)
                  + 4 * (2 * n_pairs + 1))
    pair_bound = max(pair_bytes / HBM_BYTES_PER_S,
                     78 * nnz / PEAK_OPS["fp64"]) * 1e3
    say("determinism", f"coarse_pair_sum ({nnz} entries into {n_pairs} "
                       f"coarse pairs x 36, longest {pair_plan.max_length}) "
                       f"on the step's first K: coarse_matrix on the card "
                       f"vs on the CPU bit-identical: {pair_equal}; device "
                       f"time {pair_ms:.4f} ms cold ({pair_warm:.4f} warm), "
                       f"the composition it replaces "
                       f"(PyTorch's products, then segment_sum) "
                       f"{composed_cold:.4f} ms cold ({composed_ms:.4f} "
                       f"warm), index_add_ of the "
                       f"materialized products on the card {pair_lib:.4f} "
                       f"ms; coarse_matrix as a whole {cm_ms:.4f} ms; "
                       f"bound {pair_bound:.4f} ms (bytes) = "
                       f"{pair_bound / pair_ms:.1%} of the cold time")
    if not pair_equal:
        raise RuntimeError("determinism: coarse_pair_sum differs from the "
                           "CPU's coarse_matrix")
    results["pair"] = (float((S.cpu() - S_plain.cpu()).abs().max()),
                       (pair_warm, pair_ms), (composed_ms, composed_cold),
                       (None, None), pair_bound)
    del K0, unique, x, A, y, y_lib, y_plain, S, S_plain, A_card, A_cpu
    sync()
    lap("determinism")

    # ---------------- fe-grad-small ----------------

    def save_truth(state_t, name):
        return save_displacements(state_t, work / name)

    tight = notch_deck(FE_SMALL_MESH, FE_CG_TIGHT)
    tight["residuals"]["global residual"].update(
        {"nonlinear absolute tol": GRAD_SMALL_TOL,
         "nonlinear relative tol": GRAD_SMALL_TOL})
    truth_small = save_truth(
        fe_primal_drive(build_fe_problem_from_deck(tight))[0],
        "u_truth_480.npy")
    vgs = {}
    for where, solver in (("card", FE_CG_TIGHT), ("cpu", FE_DIRECT)):
        b = build_fe_problem_from_deck(
            grad_deck(FE_SMALL_MESH, solver, truth_small, GRAD_SMALL_TOL),
            device="cuda" if where == "card" else "cpu")
        p0, s0, ts, vg = build_fe_stepped_vg(b)
        J, g = vg(p0, s0, ts)
        vgs[where] = (p0, s0, ts, vg, J, float(g[0]))
    p0, s0, ts, vg, J_card, g_card = vgs["card"]
    J_cpu, g_cpu = vgs["cpu"][4], vgs["cpu"][5]
    Jp, _ = vg(p0 + GRAD_SMALL_H, s0, ts)
    Jm, _ = vg(p0 - GRAD_SMALL_H, s0, ts)
    fd = (Jp - Jm) / (2 * GRAD_SMALL_H)
    rel = {"J": abs(J_card - J_cpu) / abs(J_cpu),
           "grad": abs(g_card - g_cpu) / abs(g_cpu),
           "fd": abs(g_card - fd) / abs(fd)}
    say("fe-grad-small", f"480 tets, Newton tol {GRAD_SMALL_TOL:g}: card "
                         f"(cg + two_level 1e-10) J {J_card!r} dJ/dc "
                         f"{g_card!r} (dJ/dY {g_card / GRAD_Y!r}); CPU "
                         f"(plain step, direct) J {J_cpu!r} dJ/dc {g_cpu!r}: "
                         f"rel diff J {rel['J']:.3e} (bound "
                         f"{GRAD_SMALL_J_RTOL:g}), dJ/dc {rel['grad']:.3e} "
                         f"(bound {GRAD_SMALL_G_RTOL:g}); central difference "
                         f"on the card at h = {GRAD_SMALL_H:g} {fd!r}: rel "
                         f"diff {rel['fd']:.3e} (bound {GRAD_FD_RTOL:g})")
    if not (rel["J"] <= GRAD_SMALL_J_RTOL and rel["grad"] <= GRAD_SMALL_G_RTOL
            and rel["fd"] <= GRAD_FD_RTOL and g_card != 0.0):
        raise RuntimeError("fe-grad-small: the gradient misses its bounds")
    del vgs, vg
    lap("fe-grad-small")

    # ---------------- fe-grad (main path) ----------------
    # the truth is fe-notch's drive (the deck's Y = 2.0, the records'
    # solver); the gradient at Y = 2.6 with the records' solver, twice
    truth = save_truth(state, "u_truth_47628.npy")
    del bundle, fe, state
    sync()
    torch.cuda.empty_cache()
    gbundle = build_fe_problem_from_deck(grad_deck(FE_MESH, FE_RECORDS,
                                                   truth))
    p0, s0, ts, vg = build_fe_stepped_vg(gbundle)
    runs = []
    for k in range(2):
        gstats: dict = {}
        sync()
        reset_counts()
        t0 = time.perf_counter()
        J, g = vg(p0, s0, ts, stats=gstats)
        sync()
        wall = time.perf_counter() - t0
        if k == 0:
            grad_counts = read_counts()
            # the segment sums' launches by plan, as their wrapper counts
            # them where it launches
            per_plan = {
                f"{plan_labels.get(key[:3], key[:3])} ({key[3]})": v
                for key, v in segsum.plan_launches.items()}
        runs.append((J, g.copy(), gstats, wall))
    say("fe-grad", f"segment_sum launches per plan and path in a gradient "
                   f"evaluation: {per_plan}")
    if sum(per_plan.values()) != (grad_counts["segment_sum_tile"]
                                  + grad_counts["segment_sum_block"]):
        raise RuntimeError(f"fe-grad: the plans' launches {per_plan} do not "
                           f"add up to {grad_counts}")
    (J, g, gstats, wall), (J2, g2, _gs2, wall2) = runs
    ref_rel = (abs(J - FE_GRAD_REF_J) / abs(FE_GRAD_REF_J),
               abs(float(g[0]) - FE_GRAD_REF_DJ_DC) / abs(FE_GRAD_REF_DJ_DC))
    fwd, rev = gstats["forward"], gstats["reverse"]
    say("fe-grad", f"47,628 tets, the records' solver: J {J!r}, dJ/dc "
                   f"{float(g[0])!r} (dJ/dY {float(g[0]) / GRAD_Y!r}); "
                   f"cmad_tpu (CPU f64, direct) J {FE_GRAD_REF_J!r}, dJ/dc "
                   f"{FE_GRAD_REF_DJ_DC!r}: rel diff J {ref_rel[0]:.3e} "
                   f"(bound {FE_GRAD_J_RTOL:g}), dJ/dc {ref_rel[1]:.3e} "
                   f"(bound {FE_GRAD_G_RTOL:g}); two runs bit-identical: "
                   f"J {J == J2}, gradient {np.array_equal(g, g2)}; "
                   f"{wall:.3f} s and {wall2:.3f} s; launches {grad_counts}")
    for k, (f, r) in enumerate(zip(fwd, rev[::-1], strict=True), start=1):
        say("fe-grad", f"step {k}: forward {f['wall_s']:.3f} s ("
                       f"{f['newton_iters']} Newton iterations, "
                       f"{f['assemblies']} assemblies, CG per solve "
                       f"{f.get('cg_iters', [])}, QoI {f['qoi_s']:.4f} s); "
                       f"reverse {r['wall_s']:.3f} s (the rule's assembly "
                       f"at U* and its transposes {r['assembly_s']:.3f} s, "
                       f"transpose solve {r['solve_s']:.3f} s with CG "
                       f"iterations {r['cg_iters']}, the QoI and the rest "
                       f"{r['rest_s']:.3f} s)")
    f_wall = sum(f["wall_s"] for f in fwd)
    r_wall = sum(r["wall_s"] for r in rev)
    say("fe-grad", f"forward sweep {f_wall:.3f} s, reverse sweep "
                   f"{r_wall:.3f} s: assemblies "
                   f"{sum(r['assembly_s'] for r in rev):.3f} s, transpose "
                   f"solves {sum(r['solve_s'] for r in rev):.3f} s "
                   f"({sum(sum(r['cg_iters']) for r in rev)} CG iterations), "
                   f"the QoI and the rest {sum(r['rest_s'] for r in rev):.3f} "
                   f"s")
    if not (np.isfinite(J) and np.isfinite(g).all() and float(g[0]) != 0.0
            and ref_rel[0] <= FE_GRAD_J_RTOL and ref_rel[1] <= FE_GRAD_G_RTOL
            and J == J2 and np.array_equal(g, g2)):
        raise RuntimeError("fe-grad: the gradient misses cmad_tpu's or is "
                           "not reproducible")
    if not all(grad_counts[k] > 0 for k in (
            "j2_soa_step", "segment_sum_tile", "segment_sum_block",
            "coarse_pair_sum", "csr_matvec")):
        raise RuntimeError(f"fe-grad: a kernel never ran: {grad_counts}")
    del gbundle, vg, runs
    sync()
    torch.cuda.empty_cache()
    lap("fe-grad")

    # ---------------- fe-hessian-small ----------------
    # 480 tets at a Newton tolerance of 1e-12: the card's stepped Hessian
    # (CG at 1e-10) against the CPU's (plain step, direct), the card's
    # scan Hessian, a central difference of the card's gradient and J_dot
    hs = {}
    for where, solver in (("card", FE_CG_TIGHT), ("cpu", FE_DIRECT)):
        b = build_fe_problem_from_deck(
            hess_deck(FE_SMALL_MESH, solver, truth_small, GRAD_SMALL_TOL),
            device="cuda" if where == "card" else "cpu")
        p0, s0, ts, hess = build_fe_stepped_hessian_fn(b)
        t0 = time.perf_counter()
        J_h, g_h, H_h, asym_h = hess.with_gradient(p0, s0, ts)
        hs[where] = (b, p0, s0, ts, J_h, float(g_h[0]), float(H_h[0, 0]),
                     asym_h, time.perf_counter() - t0)
    b, p0, s0, ts, J_c, g_c, H_c, asym_c, wall_c = hs["card"]
    H_cpu, wall_cpu = hs["cpu"][6], hs["cpu"][8]
    t0 = time.perf_counter()
    H_scan = float(fs.fe_hessian(build_fe_problem_from_deck(hess_deck(
        FE_SMALL_MESH, FE_CG_TIGHT, truth_small, GRAD_SMALL_TOL,
        driver="scan")))[0][0, 0])
    wall_scan = time.perf_counter() - t0
    _q, _s, _t, vg = build_fe_stepped_vg(b)
    gp = float(vg(p0 + GRAD_SMALL_H, s0, ts)[1][0])
    gm = float(vg(p0 - GRAD_SMALL_H, s0, ts)[1][0])
    fd = (gp - gm) / (2 * GRAD_SMALL_H)
    fe_s = b.fe_problem
    hvp = build_fe_stepped_hvp(
        fe_s, fe_params_overlay(fe_s)[1], b.qoi,
        nonlinear_solver_settings=nonlinear_settings(b),
        linear_solver_settings=b.resolved["linear solver"])
    (_J, g_v, hv), jdot = hvp._with_jdot(p0, s0, ts, np.ones(1))
    rel = {"cpu": abs(H_c - H_cpu) / abs(H_cpu),
           "scan": abs(H_scan - H_c) / abs(H_c),
           "fd": abs(H_c - fd) / abs(fd),
           "jdot": abs(jdot - float(g_v[0])) / abs(float(g_v[0])),
           "hv": abs(float(hv[0]) - H_c) / abs(H_c)}
    say("fe-hessian-small", f"480 tets, Newton tol {GRAD_SMALL_TOL:g}, Y "
                            f"{HESS_Y}: card stepped (cg + two_level 1e-10)"
                            f" d2J/dY2 {H_c!r} ({wall_c:.3f} s, J {J_c!r}, "
                            f"dJ/dY {g_c!r}); CPU stepped (plain step, "
                            f"direct) {H_cpu!r} ({wall_cpu:.3f} s): rel "
                            f"diff {rel['cpu']:.3e} (bound "
                            f"{HESS_SMALL_RTOL:g}); card scan {H_scan!r} "
                            f"({wall_scan:.3f} s): rel diff "
                            f"{rel['scan']:.3e} (bound {HESS_SMALL_RTOL:g}); "
                            f"central difference of the card's gradient at "
                            f"h = {GRAD_SMALL_H:g} {fd!r}: rel diff "
                            f"{rel['fd']:.3e} (bound {HESS_SMALL_FD_RTOL:g});"
                            f" J_dot {jdot!r} vs grad . v {float(g_v[0])!r}:"
                            f" rel diff {rel['jdot']:.3e} (bound "
                            f"{HESS_JDOT_RTOL:g}); Hv vs H rel diff "
                            f"{rel['hv']:.3e}; max_asym {asym_c:.3e}")
    if not (rel["cpu"] <= HESS_SMALL_RTOL and rel["scan"] <= HESS_SMALL_RTOL
            and rel["fd"] <= HESS_SMALL_FD_RTOL
            and rel["jdot"] <= HESS_JDOT_RTOL
            and rel["hv"] <= HESS_SMALL_RTOL and H_c > 0.0):
        raise RuntimeError("fe-hessian-small: the Hessian misses its bounds")
    del hs, b, vg, hvp, fe_s
    lap("fe-hessian-small")

    # ---------------- fe-hessian (main path) ----------------
    # hessian_scale.py's path with the records' solver: the truth at Y =
    # 2.0 through the primal command (Exodus out, read back), then the
    # hessian command at Y = 2.3, twice, bit for bit
    hess_dir = work / "fe_hessian"
    truth_deck = notch_deck(FE_MESH, FE_RECORDS)
    truth_deck["output"] = {"exodus filename": "truth.exo",
                            "global residual": ["u"]}
    t0 = time.perf_counter()
    fs.run_primal_fe(truth_deck, hess_dir / "truth")
    primal_s = time.perf_counter() - t0
    exo = read_results(hess_dir / "truth" / "truth.exo",
                       nodal_field_specs=[FieldSpec("u", VarType.VECTOR)])
    u_exo = exo.nodal["u"]
    exo_norms = [float(np.linalg.norm(u)) for u in u_exo[1:]]
    exo_rel = max(abs(a - b) / b for a, b in zip(exo_norms, FE_REF_U_NORMS,
                                                  strict=True))
    u_data = hess_dir / "u_data.npy"
    np.save(u_data, u_exo)
    say("fe-hessian", f"truth (primal command, {primal_s:.3f} s with the "
                      f"Exodus write; read back {u_exo.shape}): ||U|| per "
                      f"step {exo_norms}, rel err {exo_rel:.3e} against "
                      f"cmad_tpu (bound {FE_REF_RTOL:g})")
    if not exo_rel <= FE_REF_RTOL:
        raise RuntimeError("fe-hessian: the truth misses cmad_tpu's")
    hdeck = hess_deck(FE_MESH, FE_RECORDS, u_data)
    hdeck["output"] = {"write exodus": False}
    hruns = []
    for k in range(2):
        hstats: dict | None = {} if k == 0 else None
        sync()
        reset_counts()
        t0 = time.perf_counter()
        fs.run_hessian_fe(hdeck, hess_dir / f"hess{k}", stats=hstats)
        sync()
        wall = time.perf_counter() - t0
        if k == 0:
            hess_counts = read_counts()
        hruns.append((np.load(hess_dir / f"hess{k}" / "hess.npy"), wall,
                      hstats))
    (H_arr, hwall, hstats), (H_arr2, hwall2, _) = hruns
    H = float(H_arr[0, 0])
    gb = build_fe_problem_from_deck(hdeck)
    p0, s0, ts, vg = build_fe_stepped_vg(gb)
    J_h, g_h = vg(p0, s0, ts)
    gp = float(vg(p0 + HESS_FD_H, s0, ts)[1][0])
    gm = float(vg(p0 - HESS_FD_H, s0, ts)[1][0])
    fd = (gp - gm) / (2 * HESS_FD_H)
    rel = {"ref": abs(H - FE_HESS_REF_H) / FE_HESS_REF_H,
           "fd": abs(H - fd) / abs(fd),
           "J": abs(J_h - FE_HESS_REF_J) / FE_HESS_REF_J,
           "g": abs(float(g_h[0]) - FE_HESS_REF_DJ_DY) / FE_HESS_REF_DJ_DY}
    fwd, tan, rev = hstats["forward"], hstats["tangent"], hstats["reverse"]
    f_wall = sum(f["wall_s"] for f in fwd)
    t_wall = sum(t["wall_s"] for t in tan)
    r_wall = sum(r["wall_s"] for r in rev)
    say("fe-hessian", f"47,628 tets, the records' solver: d2J/dY2 {H!r}; "
                      f"cmad_tpu (CPU f64, direct) {FE_HESS_REF_H!r}: rel "
                      f"diff {rel['ref']:.3e} (bound {HESS_REF_RTOL:g}); "
                      f"central difference of the card's gradient at h = "
                      f"{HESS_FD_H:g} {fd!r}: rel diff {rel['fd']:.3e} "
                      f"(bound {HESS_FD_RTOL:g}); the TPU record (TPU, f32, "
                      f"Newton cap 15; context only) {HESS_TPU_RECORD!r}; "
                      f"two runs bit-identical {np.array_equal(H_arr, H_arr2)}"
                      f"; {hwall:.3f} s and {hwall2:.3f} s per hessian "
                      f"command; J {J_h!r} dJ/dY {float(g_h[0])!r} vs "
                      f"cmad_tpu {FE_HESS_REF_J!r} {FE_HESS_REF_DJ_DY!r}: "
                      f"rel diff {rel['J']:.3e}, {rel['g']:.3e} (bounds "
                      f"{FE_GRAD_J_RTOL:g}, {FE_GRAD_G_RTOL:g})")
    say("fe-hessian", f"one Hessian evaluation: primal sweep {f_wall:.3f} s"
                      f" (Newton {[f['newton_iters'] for f in fwd]}, CG "
                      f"iterations {sum(sum(f.get('cg_iters', [])) for f in fwd)}"
                      f"), tangent sweep {t_wall:.3f} s (tangent forward "
                      f"{f_wall + t_wall:.3f} s), reverse sweep "
                      f"{r_wall:.3f} s (re-solve Newton "
                      f"{[r['newton_iters'] for r in rev]}, their CG "
                      f"iterations {sum(sum(r['newton_cg_iters']) for r in rev)}"
                      f", the rule's transpose solves' CG iterations "
                      f"{sum(sum(r['cg_iters']) for r in rev)}); launches "
                      f"{hess_counts}")
    for k, (f, t_, r) in enumerate(zip(fwd, tan, rev[::-1], strict=True),
                                   start=1):
        say("fe-hessian", f"step {k}: primal {f['wall_s']:.3f} s, tangent "
                          f"{t_['wall_s']:.3f} s, reverse {r['wall_s']:.3f} "
                          f"s (assembly {r['assembly_s']:.3f} s, transpose "
                          f"solves {r['solve_s']:.3f} s, CG {r['cg_iters']})")
    if not (rel["ref"] <= HESS_REF_RTOL and rel["fd"] <= HESS_FD_RTOL
            and rel["J"] <= FE_GRAD_J_RTOL and rel["g"] <= FE_GRAD_G_RTOL
            and np.array_equal(H_arr, H_arr2) and np.isfinite(H)):
        raise RuntimeError("fe-hessian: the Hessian misses its bounds or is "
                           "not reproducible")
    if not all(hess_counts[k] > 0 for k in (
            "j2_soa_step", "segment_sum_tile", "segment_sum_block",
            "coarse_pair_sum", "csr_matvec")):
        raise RuntimeError(f"fe-hessian: a kernel never ran: {hess_counts}")
    del gb, vg, hruns
    sync()
    torch.cuda.empty_cache()
    lap("fe-hessian")

    # ---------------- fe-cli ----------------
    # every FE command at 480 tets with the deck as a dict: each file
    # against the library call's number, bit for bit
    cli = work / "fe_cli"
    cli_t: dict[str, float] = {}

    def command(name, run, deck, out, **kw):
        sync()
        t0 = time.perf_counter()
        run(deck, cli / out, **kw)
        sync()
        cli_t[f"{name} ({out})"] = time.perf_counter() - t0
        return cli / out

    reset_counts()
    base = notch_deck(FE_SMALL_MESH, FE_RECORDS)
    base["output"] = {"write restart": True}
    out = command("primal", fs.run_primal_fe, base, "primal")
    solver_log = json.loads((out / "solver.json").read_text())
    U_exo = read_results(out / "notch_hosford.exo").nodal
    ckpt = np.load(out / "restart.npz")
    # the library call on the same deck: every file holds its numbers
    lib_bundle = build_fe_problem_from_deck(base)
    lib_state, lib_log = fe_primal_drive(lib_bundle)
    n_t = len(lib_state.t_history)
    U_hist = np.stack([np.stack([U_exo[f"u_{c}"][k] for c in "xyz"],
                                axis=1).reshape(-1) for k in range(n_t)])
    primal_same = {
        "exodus U history": (len(U_exo["u_x"]) == n_t and np.array_equal(
            U_hist, np.stack([lib_state.U_at(k) for k in range(n_t)]))),
        "restart U": np.array_equal(ckpt["U"], lib_state.U_at(n_t - 1)),
        "restart xi": all(
            np.array_equal(ckpt[f"xi__{b}"], lib_state.xi_at(n_t - 1, b))
            for b in lib_bundle.fe_problem.models_by_block),
        "solver.json": solver_log == lib_log,
    }
    if not (all(primal_same.values()) and fe_converged(
            solver_log, nonlinear_settings(lib_bundle))):
        raise RuntimeError(f"fe-cli: the primal's files differ from "
                           f"fe_primal_drive ({primal_same}), or a step "
                           "did not converge")
    del lib_bundle, lib_state
    longer = notch_deck(FE_SMALL_MESH, FE_RECORDS)
    longer["discretization"]["num steps"] = 6
    longer["output"] = {"write restart": True, "write exodus": False}
    resumed = {**longer, "restart": {"file": str(out / "restart.npz")}}
    full = np.load(command("primal", fs.run_primal_fe, longer, "full")
                   / "restart.npz")
    res = np.load(command("primal", fs.run_primal_fe, resumed, "resumed")
                  / "restart.npz")
    restart_same = (np.array_equal(full["U"], res["U"])
                    and np.array_equal(full["xi__block_1"],
                                       res["xi__block_1"]))
    data = cli / "primal" / "notch_hosford.exo"
    checks = {"restart resumed == straight 6 steps": restart_same,
              **{f"primal {k}": v for k, v in primal_same.items()}}
    for driver in ("stepped", "scan"):
        deck = grad_deck(FE_SMALL_MESH, FE_RECORDS, data)
        deck["residuals"]["global residual"]["driver"] = driver
        deck["output"] = {"write exodus": False}
        bundle_c = build_fe_problem_from_deck(deck)
        J_f = json.loads((command("objective", fs.run_objective_fe, deck,
                                  f"objective_{driver}") / "J.json")
                         .read_text())["J"]
        checks[f"objective {driver}"] = J_f == fs.fe_objective(bundle_c)
        g_f = np.load(command("gradient", fs.run_gradient_fe, deck,
                              f"gradient_{driver}") / "grad.npy")
        x0, vg_c = fs.fe_value_and_grad(bundle_c)
        checks[f"gradient {driver}"] = np.array_equal(g_f, vg_c(x0)[1])
        hdeck = hess_deck(FE_SMALL_MESH, FE_RECORDS, data, driver=driver)
        hdeck["output"] = {"write exodus": False}
        H_f = np.load(command("hessian", fs.run_hessian_fe, hdeck,
                              f"hessian_{driver}") / "hess.npy")
        checks[f"hessian {driver}"] = np.array_equal(
            H_f, fs.fe_hessian(build_fe_problem_from_deck(hdeck))[0])
        say("fe-cli", f"{driver}: J {J_f!r}, grad {g_f.tolist()}, hessian "
                      f"(Y {HESS_Y}) {H_f.tolist()}")
    cdeck = grad_deck(FE_SMALL_MESH, FE_RECORDS, data)
    cdeck["optimizer"] = {"algorithm": "L-BFGS-B",
                          "options": {"maxiter": 100, "ftol": 1.0e-14,
                                      "gtol": 1.0e-10}}
    cdeck["output"] = {"write exodus": False}
    out = command("calibrate", fs.run_calibrate_fe, cdeck, "calibrate")
    fit = json.loads((out / "active_params.json").read_text())
    hist = json.loads((out / "opt_history.json").read_text())["history"]
    status = json.loads((out / "opt_status.json").read_text())
    Y_fit = fit["block_1.plastic.flow_stress.initial_yield.Y"]
    x0, vg_c = fs.fe_value_and_grad(build_fe_problem_from_deck(cdeck))
    checks["calibrate's first J"] = hist[0]["J"] == vg_c(x0)[0]
    # the elastic notch (the generic CLOSED_FORM block) through the primal
    # command with Exodus and restart output: U, the closed-form Cauchy
    # stress per element, the restart's U and (initial, echoed) state and
    # solver.json against fe_primal_drive and the writer's evaluation,
    # bit for bit
    from cmad_tpu_torch.fem.postprocess import evaluate_cauchy_at_ips
    from cmad_tpu_torch.io.results import ip_average_to_element

    edeck = elastic_deck(FE_SMALL_MESH, FE_RECORDS, "isotropic_linear")
    edeck["output"] = {"write restart": True}
    out = command("primal", fs.run_primal_fe, edeck, "primal_elastic")
    e_exo = read_results(out / "notch_hosford.exo")
    e_ckpt = np.load(out / "restart.npz")
    ebundle = build_fe_problem_from_deck(edeck)
    e_state, e_log = fe_primal_drive(ebundle)
    n_t = len(e_state.t_history)
    e_geom = ebundle.fe_problem.geometry_cache
    e_cauchy = np.stack([ip_average_to_element(evaluate_cauchy_at_ips(
        ebundle.fe_problem, e_state, k, "block_1"), e_geom, "block_1")
        for k in range(n_t)])
    checks["elastic primal u"] = np.array_equal(
        np.stack([np.stack([e_exo.nodal[f"u_{c}"][k] for c in "xyz"],
                           axis=1).reshape(-1) for k in range(n_t)]),
        np.stack([e_state.U_at(k) for k in range(n_t)]))
    checks["elastic primal cauchy"] = all(
        np.array_equal(e_exo.element[f"cauchy_{c}"]["block_1"],
                       e_cauchy[..., i])
        for i, c in enumerate(("xx", "xy", "xz", "yy", "yz", "zz")))
    checks["elastic restart"] = (
        np.array_equal(e_ckpt["U"], e_state.U_at(n_t - 1))
        and np.array_equal(e_ckpt["xi__block_1"],
                           e_state.xi_at(n_t - 1, "block_1")))
    checks["elastic solver.json"] = json.loads(
        (out / "solver.json").read_text()) == e_log
    e_norms = [float(np.linalg.norm(e_state.U_at(k)))
               for k in range(1, n_t)]
    say("fe-cli", f"the elastic notch (480 tets): ||U|| per step "
                  f"{e_norms}, element sigma_yy at the last step in "
                  f"[{e_cauchy[-1, :, 3].min():.6e}, "
                  f"{e_cauchy[-1, :, 3].max():.6e}]")
    del ebundle, e_state
    # examples/notch_hosford.yaml as written (480 tets, the deck's Newton
    # cap, the default direct solve, Exodus with u, cauchy and alpha), from
    # a copy of its directory: the primal's file against the library drive
    # and the Cauchy stress the writer evaluates, bit for bit; then
    # fe_load_match in write mode (the y reaction on ymax_sides after each
    # step) and one objective for each of fe_displacement_l2,
    # fe_load_match (against 1.1 x that reaction) and fe_weighted_sum of
    # the two, each J.json against the QoI summed over one library drive
    from cmad_tpu_torch.fem.postprocess import evaluate_cauchy_at_ips
    from cmad_tpu_torch.io.results import ip_average_to_element

    ex = cli / "examples"
    (ex / "meshes").mkdir(parents=True, exist_ok=True)
    shutil.copy(MESHES / FE_SMALL_MESH, ex / "meshes" / FE_SMALL_MESH)
    here = Path.cwd()
    os.chdir(ex)
    try:
        sync()
        t0 = time.perf_counter()
        fs.run_primal_fe(copy.deepcopy(NOTCH_HOSFORD_DECK))
        sync()
        cli_t["primal (notch_hosford.yaml)"] = time.perf_counter() - t0
        exo = read_results(ex / "results" / "notch_primal.exo")
        hbundle = build_fe_problem_from_deck(
            copy.deepcopy(NOTCH_HOSFORD_DECK))
        h_state, h_log = fe_primal_drive(hbundle)
        n_t = len(h_state.t_history)
        geom = hbundle.fe_problem.geometry_cache

        def per_elem(per_ip):
            """The writer's integration-weighted IP mean per element."""
            return ip_average_to_element(per_ip, geom, "block_1")

        cauchy = np.stack([per_elem(evaluate_cauchy_at_ips(
            hbundle.fe_problem, h_state, k, "block_1"))
            for k in range(n_t)])
        order = ("xx", "xy", "xz", "yy", "yz", "zz")
        checks["notch_hosford.yaml primal u"] = np.array_equal(
            np.stack([np.stack([exo.nodal[f"u_{c}"][k] for c in "xyz"],
                               axis=1).reshape(-1) for k in range(n_t)]),
            np.stack([h_state.U_at(k) for k in range(n_t)]))
        checks["notch_hosford.yaml primal alpha"] = np.array_equal(
            exo.element["alpha"]["block_1"],
            np.stack([per_elem(h_state.xi_at(k, "block_1")[..., 6:7])[:, 0]
                      for k in range(n_t)]))
        checks["notch_hosford.yaml primal cauchy"] = all(
            np.array_equal(exo.element[f"cauchy_{c}"]["block_1"],
                           cauchy[..., i]) for i, c in enumerate(order))
        hos_alpha = float(exo.element["alpha"]["block_1"][-1].max())
    finally:
        os.chdir(here)
    # the three QoIs through the commands on fe-cli's J2 deck: the QoIs do
    # not depend on the material model, and a J2 command takes half a
    # second where a Hosford one takes 15-25 (the local Newton)
    series = cli / "reaction.csv"
    write = notch_deck(FE_SMALL_MESH, FE_RECORDS)
    write["qoi"] = {"name": "fe_load_match", "sideset": "ymax_sides",
                    "components": [1], "output_file": str(series)}
    write["output"] = {"write exodus": False}
    command("primal", fs.run_primal_fe, write, "reaction")
    reaction = np.loadtxt(series, delimiter=",")
    np.save(cli / "reaction.npy", 1.1 * reaction.reshape(-1, 1))
    load = {"name": "fe_load_match", "sideset": "ymax_sides",
            "components": [1], "data_file": str(cli / "reaction.npy")}
    qois = {"fe_displacement_l2": {"name": "fe_displacement_l2"},
            "fe_load_match": load,
            "fe_weighted_sum": {"name": "fe_weighted_sum", "terms": [
                {"name": "fe_displacement_l2", "term_weight": 2.0},
                {**load, "term_weight": 0.5}]}}
    j2_state, _j2_log = fe_primal_drive(build_fe_problem_from_deck(
        notch_deck(FE_SMALL_MESH, FE_RECORDS)))
    qoi_J = {}
    for name, section in qois.items():
        deck = notch_deck(FE_SMALL_MESH, FE_RECORDS)
        deck["qoi"] = section
        deck["output"] = {"write exodus": False}
        J_f = json.loads((command("objective", fs.run_objective_fe, deck,
                                  f"objective_{name}") / "J.json")
                         .read_text())["J"]
        qb = build_fe_problem_from_deck(deck)
        lib = fs.accumulate_qoi_over_history(qb, j2_state, qb.qoi)
        checks[f"objective {name}"] = J_f == lib
        qoi_J[name] = J_f
    checks["reaction written after every step"] = (
        reaction.shape == (5,) and reaction[0] == 0.0
        and bool(np.all(np.diff(reaction) > 0.0)))
    h_norms = [float(np.linalg.norm(h_state.U_at(k))) for k in range(1, n_t)]
    say("fe-cli", f"examples/notch_hosford.yaml (480 tets, Hosford a = 100)"
                  f": ||U|| per step {h_norms}"
                  f", max alpha {hos_alpha!r}, Newton {h_log}; on the "
                  f"J2 deck the ymax_sides y reaction per step "
                  f"{reaction.tolist()}, J per QoI {qoi_J}")
    del hbundle, h_state, j2_state
    cli_counts = read_counts()
    say("fe-cli", f"calibrate from Y {GRAD_Y}: Y {Y_fit!r} after "
                  f"{len(hist)} evaluations ({status['nit']} iterations, "
                  f"J {hist[0]['J']:.6e} -> {hist[-1]['J']:.6e}, "
                  f"{status['message']}); the TPU record (TPU, f32; context "
                  f"only) Y {CAL_TPU_RECORD[0]} after {CAL_TPU_RECORD[1]}")
    say("fe-cli", f"command walls (s): "
                  f"{ {k: round(v, 3) for k, v in cli_t.items()} }; files "
                  f"vs the library calls, bit for bit: {checks}; launches "
                  f"{cli_counts}")
    if not (all(checks.values())
            and abs(Y_fit - GRAD_Y_TRUTH) <= CAL_Y_RTOL * GRAD_Y_TRUTH
            and all(cli_counts[k] > 0 for k in (
                "j2_soa_step", "segment_sum_tile", "segment_sum_block",
                "coarse_pair_sum", "csr_matvec"))):
        raise RuntimeError(f"fe-cli: {checks}, Y {Y_fit}, launches "
                           f"{cli_counts}")
    lap("fe-cli")

    # ---------------- fe-hosford-small ----------------
    # the deck's Hosford (a = 100) on 480 tets, its load in two steps, at
    # a Newton tolerance of 1e-12: the card (the point-batch block, cg +
    # two_level at 1e-10) against the CPU (the plain path, direct solves);
    # then, against that drive's U, d2J/dY2 at Y = HESS_Y (no transform)
    # from the stepped Hessian, against a central difference of the card's
    # gradient (whose J's central difference checks the gradient) and the
    # scan Hessian
    def two_steps(deck):
        """The deck's load in two steps of twice the size (t = 2, 4): the
        depth cut that holds this phase's time."""
        deck["discretization"].update({"num steps": 2, "step size": 2.0})
        return deck

    hos = two_steps(notch_deck(FE_SMALL_MESH, FE_CG_TIGHT, "hosford"))
    hos["residuals"]["global residual"].update(
        {"nonlinear absolute tol": GRAD_SMALL_TOL,
         "nonlinear relative tol": GRAD_SMALL_TOL})
    hb = build_fe_problem_from_deck(hos)
    t0 = time.perf_counter()
    gpu_h, _log_h, _st_h, small_counts, _pk = fe_drive(
        "fe-hosford-small", hb, k1_per_assembly=0)
    card_s = time.perf_counter() - t0
    cb = build_fe_problem_from_deck(
        {**copy.deepcopy(hos), "linear solver": dict(FE_DIRECT)},
        device="cpu")
    t0 = time.perf_counter()
    cpu_h, cpu_log = fe_primal_drive(cb)
    cpu_s = time.perf_counter() - t0
    if not fe_converged(cpu_log, nonlinear_settings(cb)):
        raise RuntimeError("fe-hosford-small: the CPU drive did not "
                           "converge")
    U_gpu, U_cpu = np.stack(gpu_h.U_history), np.stack(cpu_h.U_history)
    small_rel = float(np.abs(U_gpu - U_cpu).max() / np.abs(U_cpu).max())
    small_norms = [float(np.linalg.norm(u)) for u in gpu_h.U_history[1:]]
    say("fe-hosford-small", f"480 tets x 2 steps (t = 2, 4), Newton tol "
                            f"{GRAD_SMALL_TOL:g}: card (point-batch block, "
                            f"cg + two_level 1e-10) {card_s:.3f} s vs CPU "
                            f"(plain path, direct) {cpu_s:.3f} s: "
                            f"max|U_gpu - U_cpu| / max|U_cpu| "
                            f"{small_rel:.3e} (bound {HOSFORD_SMALL_BOUND:g});"
                            f" ||U|| per step {small_norms}")
    if not small_rel <= HOSFORD_SMALL_BOUND:
        raise RuntimeError("fe-hosford-small: card and CPU disagree")
    truth_hs = save_truth(gpu_h, "u_truth_hosford_480.npy")
    del hb, cb, gpu_h, cpu_h
    hb = build_fe_problem_from_deck(two_steps(hess_deck(
        FE_SMALL_MESH, FE_CG_TIGHT, truth_hs, GRAD_SMALL_TOL,
        effective_stress="hosford")))
    p0, s0, ts, hess = build_fe_stepped_hessian_fn(hb)
    t0 = time.perf_counter()
    J_h, g_h, H_h, asym_h = hess.with_gradient(p0, s0, ts)
    hess_s = time.perf_counter() - t0
    g_h, H_h = float(g_h[0]), float(H_h[0, 0])
    _q, _s, _t, vg = build_fe_stepped_vg(hb)
    Jp, gp = vg(p0 + GRAD_SMALL_H, s0, ts)
    Jm, gm = vg(p0 - GRAD_SMALL_H, s0, ts)
    fd_g = (Jp - Jm) / (2 * GRAD_SMALL_H)
    fd_H = (float(gp[0]) - float(gm[0])) / (2 * GRAD_SMALL_H)
    t0 = time.perf_counter()
    H_scan = float(fs.fe_hessian(build_fe_problem_from_deck(two_steps(
        hess_deck(FE_SMALL_MESH, FE_CG_TIGHT, truth_hs, GRAD_SMALL_TOL,
                  driver="scan", effective_stress="hosford"))))[0][0, 0])
    scan_s = time.perf_counter() - t0
    rel = {"grad": abs(g_h - fd_g) / abs(fd_g),
           "fd": abs(H_h - fd_H) / abs(fd_H),
           "scan": abs(H_scan - H_h) / abs(H_h)}
    say("fe-hosford-small", f"Y {HESS_Y}: J {J_h!r}, dJ/dY {g_h!r}, central "
                            f"difference of J at h = {GRAD_SMALL_H:g} "
                            f"{fd_g!r}: rel diff {rel['grad']:.3e} (bound "
                            f"{GRAD_FD_RTOL:g}); stepped d2J/dY2 {H_h!r} "
                            f"({hess_s:.3f} s, max_asym {asym_h:.3e}); "
                            f"central difference of the card's gradient "
                            f"{fd_H!r}: rel diff {rel['fd']:.3e} (bound "
                            f"{HESS_SMALL_FD_RTOL:g}); scan Hessian "
                            f"{H_scan!r} ({scan_s:.3f} s): rel diff "
                            f"{rel['scan']:.3e} (bound {HESS_SMALL_RTOL:g})")
    if not (rel["grad"] <= GRAD_FD_RTOL and rel["fd"] <= HESS_SMALL_FD_RTOL
            and rel["scan"] <= HESS_SMALL_RTOL and g_h != 0.0
            and H_h > 0.0):
        raise RuntimeError("fe-hosford-small: the derivatives miss their "
                           "bounds")
    del hb, hess, vg
    lap("fe-hosford-small")

    # ---------------- fe-hosford (this slice's main path) ----------------
    # examples/notch_hosford.yaml's Hosford at the records' size (47,628
    # tets) with the records' solver and Newton cap 50: the primal against
    # cmad_tpu's ||U|| and max |alpha| per step, its last two steps again
    # bit for bit; the local Newton's iterations per step; an assembly's
    # host and device time; then one gradient of the notch calibration
    # against cmad_tpu's
    t0 = time.perf_counter()
    bundle = build_fe_problem_from_deck(notch_deck(FE_MESH, FE_RECORDS,
                                                   "hosford"))
    fe = bundle.fe_problem
    say("fe-hosford", f"{FE_MESH}: {fe.mesh.connectivity.shape[0]} tets, "
                      f"{fe.dof_map.num_total_dofs} dofs, the point-batch "
                      f"block (reduced Hosford Newton); problem built in "
                      f"{time.perf_counter() - t0:.2f} s (host)")
    local = fe.evaluators_by_block["block_1"]["local_solve"].newton
    local.log = []
    t0 = time.perf_counter()
    state, log, stats, hos_counts, peak = fe_drive("fe-hosford", bundle,
                                                   k1_per_assembly=0)
    drive_s = time.perf_counter() - t0
    solves, local.log = local.log, None
    first = 0
    for k, st in enumerate(stats, start=1):
        mine = solves[first:first + st["assemblies"]]
        first += st["assemblies"]
        mean = sum(float(m[1]) for m in mine) / sum(m[2] for m in mine)
        say("fe-hosford", f"step {k}: local Newton (one per assembly, "
                          f"{len(mine)}): most iterations of a point "
                          f"{max(m[0] for m in mine)}, mean {mean:.4f}"
                          f" per point per assembly, slowest point's "
                          f"iterations per assembly {[m[0] for m in mine]}")
    if first != len(solves):
        raise RuntimeError(f"fe-hosford: {len(solves)} local solves for "
                           f"{first} assemblies")
    norms = [float(np.linalg.norm(u)) for u in state.U_history[1:]]
    alphas = [float(np.abs(state.xi_at(k, "block_1")[..., 6]).max())
              for k in range(1, len(state.U_history))]
    worst = max(max(abs(a - b) / b for a, b in zip(
        norms, FE_HOSFORD_REF_U_NORMS, strict=True)), max(
        abs(a - b) / b for a, b in zip(alphas, FE_HOSFORD_REF_ALPHA_MAX,
                                       strict=True)))
    say("fe-hosford", f"4 steps in {drive_s:.3f} s ({drive_s / 4:.3f} s per "
                      f"step), peak memory {peak / 2**30:.3f} GiB; ||U|| per "
                      f"step {norms}, max |alpha| {alphas}; against "
                      f"cmad_tpu (CPU f64, direct, Newton cap 50) "
                      f"{list(FE_HOSFORD_REF_U_NORMS)}, "
                      f"{list(FE_HOSFORD_REF_ALPHA_MAX)}: max rel err "
                      f"{worst:.3e} (bound {FE_REF_RTOL:g}); the records' "
                      f"final ||U|| (context only, the deck's Newton cap "
                      f"15): TPU f32 {HOSFORD_TPU_RECORD_U!r}, the "
                      f"original cmad f64 {HOSFORD_REFERENCE_U!r}")
    if not worst <= FE_REF_RTOL:
        raise RuntimeError("fe-hosford: the drive misses cmad_tpu's answer")
    # one assembly at the last step (the point-batch block, the COO dedup,
    # the embedded-BC pair): host clock around synchronized work, best of
    # 2, and its kernels' device time from one traced call
    from torch.profiler import ProfilerActivity, profile

    ka, params = fe.kernel_arrays, params_by_block_from_models(fe)
    t = float(state.t_history[-1])
    U_prev = torch.as_tensor(state.U_at(3), dtype=fe.dtype, device=dev)
    U = torch.as_tensor(state.U_at(4), dtype=fe.dtype, device=dev)
    xi_prev = {"block_1": torch.as_tensor(state.xi_at(3, "block_1"),
                                          dtype=fe.dtype, device=dev)}

    def assemble():
        K, R, _xi = assemble_global(fe, ka, params, U, U_prev, t,
                                    xi_prev_by_block=xi_prev)
        K_data, K_ii = _embedded_bc_enforce(K, ka.prescribed_indices)
        return K_data, K_ii, R

    with torch.no_grad():
        host = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            assemble()
            sync()
            host.append(time.perf_counter() - t0)
        local.log = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            assemble()
            sync()
        asm_iters, local.log = local.log[0][0], None
    kernels = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    asm_dev = sum(ev.time_range.elapsed_us() for ev in kernels) * 1e-3
    asm_host = min(host) * 1e3
    say("fe-hosford", f"one point-batch assembly at step 4 ({asm_iters} "
                      f"local iterations of the slowest point): host "
                      f"{asm_host:.2f} ms (best of 2, "
                      f"{[round(h * 1e3, 2) for h in host]}), device "
                      f"{asm_dev:.2f} ms in {len(kernels)} kernels "
                      f"(traced), so the device is busy "
                      f"{asm_dev / asm_host:.1%} of it")
    # the drive again from its own state at t = 2 (steps 3 and 4; step 1
    # alone takes 60-65% of a drive): bit for bit the same U, xi, Newton
    # path and CG counts
    state2, _log2, stats2, _c2, _p2 = fe_drive(
        "fe-hosford", bundle, k1_per_assembly=0,
        t_schedule=state.t_history[2:], U_init=state.U_at(2),
        xi_init_by_block={"block_1": state.xi_at(2, "block_1")})
    paths = [[s["newton_iters"] for s in st] for st in (stats[2:], stats2)]
    cgs = [[s.get("cg_iters", []) for s in st] for st in (stats[2:], stats2)]
    same_U = np.array_equal(np.stack(state.U_history[2:]),
                            np.stack(state2.U_history))
    same_xi = all(np.array_equal(state.xi_at(k, "block_1"),
                                 state2.xi_at(k - 2, "block_1"))
                  for k in (3, 4))
    say("fe-hosford", f"steps 3-4 again from the drive's state at t = 2: "
                      f"Newton iterations per step {paths[0]} and "
                      f"{paths[1]}; CG iterations equal: {cgs[0] == cgs[1]};"
                      f" U bit-identical: {same_U}; xi bit-identical: "
                      f"{same_xi}")
    if not (same_U and same_xi and paths[0] == paths[1]
            and cgs[0] == cgs[1]):
        raise RuntimeError("fe-hosford: the repeated steps differ")
    truth_h = save_truth(state, "u_truth_hosford_47628.npy")
    del bundle, fe, state, state2, U, U_prev, xi_prev, prof
    sync()
    torch.cuda.empty_cache()
    gbundle = build_fe_problem_from_deck(grad_deck(
        FE_MESH, FE_RECORDS, truth_h, effective_stress="hosford"))
    p0, s0, ts, vg = build_fe_stepped_vg(gbundle)
    gstats: dict = {}
    sync()
    reset_counts()
    t0 = time.perf_counter()
    J, g = vg(p0, s0, ts, stats=gstats)
    sync()
    hgrad_s = time.perf_counter() - t0
    hgrad_counts = read_counts()
    ref_rel = (abs(J - FE_HOSFORD_GRAD_REF_J) / abs(FE_HOSFORD_GRAD_REF_J),
               abs(float(g[0]) - FE_HOSFORD_GRAD_REF_DJ_DC)
               / abs(FE_HOSFORD_GRAD_REF_DJ_DC))
    fwd, rev = gstats["forward"], gstats["reverse"]
    say("fe-hosford", f"gradient at Y {GRAD_Y} (log transform about "
                      f"{GRAD_Y_TRUTH}), the records' solver: J {J!r}, "
                      f"dJ/dc {float(g[0])!r}; cmad_tpu (CPU f64, direct) "
                      f"J {FE_HOSFORD_GRAD_REF_J!r}, dJ/dc "
                      f"{FE_HOSFORD_GRAD_REF_DJ_DC!r}: rel diff J "
                      f"{ref_rel[0]:.3e} (bound {FE_GRAD_J_RTOL:g}), dJ/dc "
                      f"{ref_rel[1]:.3e} (bound {FE_GRAD_G_RTOL:g}); "
                      f"{hgrad_s:.3f} s (forward "
                      f"{sum(f['wall_s'] for f in fwd):.3f} s: Newton "
                      f"{[f['newton_iters'] for f in fwd]}, assemblies "
                      f"{[f['assemblies'] for f in fwd]}; reverse "
                      f"{sum(r['wall_s'] for r in rev):.3f} s: the rule's "
                      f"assemblies {sum(r['assembly_s'] for r in rev):.3f} "
                      f"s, transpose solves "
                      f"{sum(r['solve_s'] for r in rev):.3f} s); launches "
                      f"{hgrad_counts}")
    say("fe-hosford", f"launches on this path: the primal {hos_counts}, the "
                      f"gradient {hgrad_counts}")
    if not (np.isfinite(J) and float(g[0]) != 0.0
            and ref_rel[0] <= FE_GRAD_J_RTOL
            and ref_rel[1] <= FE_GRAD_G_RTOL):
        raise RuntimeError("fe-hosford: the gradient misses cmad_tpu's")
    if hgrad_counts["j2_soa_step"] != 0 or not all(
            hgrad_counts[k] > 0 for k in ("segment_sum_tile",
                                          "segment_sum_block",
                                          "coarse_pair_sum", "csr_matvec")):
        raise RuntimeError(f"fe-hosford: the gradient's launches "
                           f"{hgrad_counts}")
    del gbundle, vg
    sync()
    torch.cuda.empty_cache()
    lap("fe-hosford")

    # ---------------- fe-elastic (this slice's main path) ----------------
    # the notch with the closed-form elastic model (E = 1000, nu = 0.25)
    # at 47,628 tets, the records' solver, Newton cap 50, once per Cauchy
    # stress: ||U|| per step against cmad_tpu's; for the linear one,
    # U(t_k) against k/4 U(t_4); the drive again, bit for bit; one
    # assembly's host and device time against the J2 block's (fe-notch).
    # The generic CLOSED_FORM block runs no TPU kernel: the path launches
    # the segment sums and csr_matvec, never j2_soa_step
    el_counts = {}
    for stress in ("isotropic_linear", "neohookean"):
        t0 = time.perf_counter()
        bundle = build_fe_problem_from_deck(elastic_deck(FE_MESH, FE_RECORDS,
                                                         stress))
        fe = bundle.fe_problem
        if (fe.modes_by_block != {"block_1": GlobalResidualMode.CLOSED_FORM}
                or fe.state_blocks()
                or "local_solve" in fe.evaluators_by_block["block_1"]):
            raise RuntimeError("fe-elastic: the block is not the generic "
                               "CLOSED_FORM block")
        say("fe-elastic", f"{stress}: {FE_MESH}, "
                          f"{fe.mesh.connectivity.shape[0]} tets, the "
                          f"generic CLOSED_FORM block; problem built in "
                          f"{time.perf_counter() - t0:.2f} s (host)")
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            runs.append((*fe_drive("fe-elastic", bundle, k1_per_assembly=0),
                         time.perf_counter() - t0))
        (state, _log, stats, counts, peak, drive_s), \
            (state2, _log2, stats2, _c2, _p2, drive2_s) = runs
        el_counts[stress] = counts
        same = (np.array_equal(np.stack(state.U_history),
                               np.stack(state2.U_history))
                and [s["newton_iters"] for s in stats]
                == [s["newton_iters"] for s in stats2]
                and [s.get("cg_iters") for s in stats]
                == [s.get("cg_iters") for s in stats2])
        norms = [float(np.linalg.norm(u)) for u in state.U_history[1:]]
        ref = FE_ELASTIC_REF_U_NORMS[stress]
        worst = max(abs(a - b) / b for a, b in zip(norms, ref, strict=True))
        say("fe-elastic", f"{stress}: 4 steps in {drive_s:.3f} s and "
                          f"{drive2_s:.3f} s ({drive_s / 4:.3f} s per step), "
                          f"peak memory {peak / 2**30:.3f} GiB; ||U|| per "
                          f"step {norms}; against cmad_tpu (CPU f64, "
                          f"direct, Newton cap 50) {list(ref)}: max rel err "
                          f"{worst:.3e} (bound {FE_REF_RTOL:g}); the two "
                          f"drives' U, Newton and CG iterations "
                          f"bit-identical: {same}")
        if not (worst <= FE_REF_RTOL and same):
            raise RuntimeError(f"fe-elastic: {stress} misses cmad_tpu's "
                               f"answer or its drives differ")
        if stress != "isotropic_linear":
            del bundle, fe, state, state2
            continue
        U_hist = np.stack(state.U_history)
        lin = max(float(np.abs(U_hist[k] - k / 4 * U_hist[4]).max())
                  for k in range(1, 5)) / float(np.abs(U_hist[4]).max())
        # one assembly at step 4 (the generic block, the COO dedup, the
        # embedded-BC pair): host clock around synchronized work, and its
        # kernels' device time from one traced call
        ka, params = fe.kernel_arrays, params_by_block_from_models(fe)
        U4, U3 = (torch.as_tensor(state.U_at(k), dtype=fe.dtype, device=dev)
                  for k in (4, 3))

        def assemble_el():
            K, R, _xi = assemble_global(fe, ka, params, U4, U3,
                                        float(state.t_history[4]))
            return _embedded_bc_enforce(K, ka.prescribed_indices), R

        with torch.no_grad():
            el_asm = ms_of(assemble_el)
            el_dev, el_kernels = traced_device_ms(assemble_el)
        j2_dev, j2_kernels = fe_k1["asm_dev"]
        say("fe-elastic", f"isotropic_linear: max_k |U(t_k) - k/4 U(t_4)| "
                          f"/ max|U(t_4)| {lin:.3e} (bound "
                          f"{ELASTIC_LINEAR_BOUND:g}); one assembly at step "
                          f"4: host {el_asm:.3f} ms, device {el_dev:.3f} ms "
                          f"in {el_kernels} kernels (traced), busy "
                          f"{el_dev / el_asm:.1%}; the J2 block's (fe-notch:"
                          f" K1): host {fe_k1['asm_ms']:.3f} ms, device "
                          f"{j2_dev:.3f} ms in {j2_kernels} kernels")
        if not lin <= ELASTIC_LINEAR_BOUND:
            raise RuntimeError("fe-elastic: U is not linear in the load")
        el_truth = (bundle, state)
        del fe, state2, U4, U3
    sync()
    torch.cuda.empty_cache()
    lap("fe-elastic")

    # ---------------- fe-elastic-grad ----------------
    # the elastic calibration: the truth is fe-elastic's isotropic linear
    # drive, its y reaction on ymax_sides after each step the data
    # (fe_load_match's write mode; fe_displacement_match would see no E:
    # the displacement of one linear material under displacement loading
    # does not depend on it); J and dJ/dc at E = 1300, nu = 0.3 with the
    # records' solver against cmad_tpu's and the card's central difference
    # (forward drives); at 480 tets, Newton 1e-12 and CG at 1e-10, the 2x2
    # stepped Hessian against the central difference of the card's
    # gradient and the scan Hessian
    def reaction_data(bundle_t, state_t, name):
        fe_t = bundle_t.fe_problem
        series = work / f"{name}.csv"
        FELoadMatch(fe_t, bundle_t.t_schedule.tolist(), "ymax_sides", [1],
                    output_file=str(series)).write_primal_outputs(fe_t,
                                                                  state_t)
        data = np.loadtxt(series, delimiter=",").reshape(-1, 1)
        np.save(work / f"{name}.npy", data)
        return work / f"{name}.npy", data[:, 0]

    data_file, reactions = reaction_data(*el_truth, "reaction_elastic_47628")
    del el_truth
    gbundle = build_fe_problem_from_deck(elastic_grad_deck(
        FE_MESH, FE_RECORDS, data_file))
    p0, s0, ts, vg = build_fe_stepped_vg(gbundle)
    gstats = {}
    sync()
    reset_counts()
    t0 = time.perf_counter()
    J, g = vg(p0, s0, ts, stats=gstats)
    sync()
    egrad_s = time.perf_counter() - t0
    egrad_counts = read_counts()
    _pf, s_init, J_of = build_fe_J_of_params_flat(gbundle)
    fd = []
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(2):
            e = torch.zeros_like(p0)
            e[i] = ELASTIC_FD_H
            fd.append((float(J_of(p0 + e, s_init)) - float(J_of(p0 - e,
                                                                 s_init)))
                      / (2 * ELASTIC_FD_H))
    fd_s = time.perf_counter() - t0
    rel = {"J": abs(J - FE_ELASTIC_GRAD_REF_J) / abs(FE_ELASTIC_GRAD_REF_J),
           "grad": max(abs(float(g[i]) - FE_ELASTIC_GRAD_REF_DJ_DC[i])
                       / abs(FE_ELASTIC_GRAD_REF_DJ_DC[i]) for i in range(2)),
           "fd": max(abs(float(g[i]) - fd[i]) / abs(fd[i])
                     for i in range(2))}
    fwd, rev = gstats["forward"], gstats["reverse"]
    say("fe-elastic-grad", f"47,628 tets, the records' solver: truth "
                           f"reactions per step {reactions.tolist()}; at E "
                           f"{ELASTIC_START['E']}, nu {ELASTIC_START['nu']}"
                           f": J {J!r}, dJ/dc {g.tolist()}; cmad_tpu (CPU "
                           f"f64, direct) J {FE_ELASTIC_GRAD_REF_J!r}, dJ/dc"
                           f" {list(FE_ELASTIC_GRAD_REF_DJ_DC)}: rel diff J "
                           f"{rel['J']:.3e} (bound {FE_GRAD_J_RTOL:g}), "
                           f"dJ/dc {rel['grad']:.3e} (bound "
                           f"{FE_GRAD_G_RTOL:g}); the card's central "
                           f"difference at h = {ELASTIC_FD_H:g} {fd} "
                           f"({fd_s:.3f} s): rel diff {rel['fd']:.3e} "
                           f"(bound {ELASTIC_FD_RTOL:g}); {egrad_s:.3f} s "
                           f"(forward {sum(f['wall_s'] for f in fwd):.3f} "
                           f"s: Newton {[f['newton_iters'] for f in fwd]}; "
                           f"reverse {sum(r['wall_s'] for r in rev):.3f} s:"
                           f" assemblies "
                           f"{sum(r['assembly_s'] for r in rev):.3f} s, "
                           f"transpose solves "
                           f"{sum(r['solve_s'] for r in rev):.3f} s); "
                           f"launches {egrad_counts}")
    if not (rel["J"] <= FE_GRAD_J_RTOL and rel["grad"] <= FE_GRAD_G_RTOL
            and rel["fd"] <= ELASTIC_FD_RTOL
            and egrad_counts["j2_soa_step"] == 0
            and all(egrad_counts[k] > 0 for k in (
                "segment_sum_tile", "segment_sum_block", "coarse_pair_sum",
                "csr_matvec"))):
        raise RuntimeError("fe-elastic-grad: the gradient misses its bounds")
    del gbundle, vg, J_of
    sync()
    torch.cuda.empty_cache()
    small = elastic_deck(FE_SMALL_MESH, FE_CG_TIGHT, "isotropic_linear")
    small["residuals"]["global residual"].update(
        {"nonlinear absolute tol": GRAD_SMALL_TOL,
         "nonlinear relative tol": GRAD_SMALL_TOL})
    sb = build_fe_problem_from_deck(small)
    data_small, _r = reaction_data(sb, fe_primal_drive(sb)[0],
                                   "reaction_elastic_480")
    hdeck = elastic_grad_deck(FE_SMALL_MESH, FE_CG_TIGHT, data_small,
                              GRAD_SMALL_TOL)
    hb = build_fe_problem_from_deck(hdeck)
    p0, s0, ts, hess = build_fe_stepped_hessian_fn(hb)
    t0 = time.perf_counter()
    J_h, g_h, H_h, asym_h = hess.with_gradient(p0, s0, ts)
    hess_s = time.perf_counter() - t0
    _q, _s, _t, vg = build_fe_stepped_vg(hb)
    fd_H = np.zeros((2, 2))
    for i in range(2):
        e = torch.zeros_like(p0)
        e[i] = GRAD_SMALL_H
        fd_H[:, i] = (vg(p0 + e, s0, ts)[1] - vg(p0 - e, s0, ts)[1]) \
            / (2 * GRAD_SMALL_H)
    hdeck["residuals"]["global residual"]["driver"] = "scan"
    t0 = time.perf_counter()
    H_scan = fs.fe_hessian(build_fe_problem_from_deck(hdeck))[0]
    scan_s = time.perf_counter() - t0
    scale = float(np.abs(H_h).max())
    rel = {"fd": float(np.abs(H_h - fd_H).max()) / scale,
           "scan": float(np.abs(H_scan - H_h).max()) / scale}
    say("fe-elastic-grad", f"480 tets, Newton tol {GRAD_SMALL_TOL:g}: J "
                           f"{J_h!r}, dJ/dc {np.asarray(g_h).tolist()}; "
                           f"stepped Hessian {H_h.tolist()} ({hess_s:.3f} "
                           f"s, max_asym {asym_h:.3e}); central difference "
                           f"of the card's gradient at h = "
                           f"{GRAD_SMALL_H:g} {fd_H.tolist()}: rel diff "
                           f"{rel['fd']:.3e} (bound {HESS_SMALL_FD_RTOL:g});"
                           f" scan Hessian {H_scan.tolist()} "
                           f"({scan_s:.3f} s): rel diff {rel['scan']:.3e} "
                           f"(bound {HESS_SMALL_RTOL:g})")
    if not (rel["fd"] <= HESS_SMALL_FD_RTOL
            and rel["scan"] <= HESS_SMALL_RTOL and scale > 0.0):
        raise RuntimeError("fe-elastic-grad: the Hessian misses its bounds")
    del sb, hb, hess, vg
    lap("fe-elastic-grad")

    # ---------------- fe-print ----------------
    # the J2 notch at 480 tets with the local residual's 'print
    # convergence: true': the generic COUPLED block and its 7-dof Newton,
    # each local iteration printed (counted here, not echoed), K1 never
    # launched; against the J2 block's drive of the same deck without
    # printing, both with the global Newton at 1e-12 and CG at 1e-10
    def print_deck(on):
        deck = notch_deck(FE_SMALL_MESH, FE_CG_TIGHT)
        deck["residuals"]["global residual"].update(
            {"nonlinear absolute tol": GRAD_SMALL_TOL,
             "nonlinear relative tol": GRAD_SMALL_TOL})
        deck["residuals"]["local residual"]["print convergence"] = on
        return deck

    pb = build_fe_problem_from_deck(print_deck(True))
    ev = pb.fe_problem.evaluators_by_block["block_1"]
    if "local_solve" not in ev or "xi_carrier" in ev:
        raise RuntimeError("fe-print: the block is not the generic COUPLED "
                           "block")
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        p_state, _pl, p_stats, print_counts, _pk = fe_drive(
            "fe-print", pb, k1_per_assembly=0)
    print_s = time.perf_counter() - t0
    lines = printed.getvalue().splitlines()
    for line in lines:
        if line.startswith("[fe-print]"):
            print(line, flush=True)
    n_local = sum("abs ||C|| =" in ln for ln in lines)
    t0 = time.perf_counter()
    j_state, _jl, j_stats, _jc, _jp = fe_drive(
        "fe-print", build_fe_problem_from_deck(print_deck(False)))
    j2_s = time.perf_counter() - t0
    U_p, U_j = np.stack(p_state.U_history), np.stack(j_state.U_history)
    print_rel = float(np.abs(U_p - U_j).max() / np.abs(U_j).max())
    say("fe-print", f"480 tets x 4 steps, Newton tol {GRAD_SMALL_TOL:g}: "
                    f"the generic COUPLED block (7-dof Newton, printing) "
                    f"{print_s:.3f} s, {sum(s['assemblies'] for s in p_stats)}"
                    f" assemblies, {n_local} local-iteration lines printed; "
                    f"the J2 block (K1) {j2_s:.3f} s; max|U_print - U_J2| / "
                    f"max|U_J2| {print_rel:.3e} (bound {FE_PRINT_BOUND:g}); "
                    f"launches {print_counts}")
    if not (print_rel <= FE_PRINT_BOUND and n_local > 0
            and print_counts["j2_soa_step"] == 0):
        raise RuntimeError("fe-print: the printing drive misses the J2 "
                           "block's")
    del pb, p_state, j_state
    lap("fe-print")

    # ---------------- fe-notch-large ----------------
    t0 = time.perf_counter()
    bundle = build_fe_problem_from_deck(notch_deck(FE_LARGE_MESH,
                                                   FE_RECORDS))
    fe = bundle.fe_problem
    say("fe-notch-large", f"{FE_LARGE_MESH}: "
                          f"{fe.mesh.connectivity.shape[0]} tets, "
                          f"{fe.dof_map.num_total_dofs} dofs; problem built "
                          f"in {time.perf_counter() - t0:.2f} s (host)")
    t0 = time.perf_counter()
    state, log, stats, _k1, peak = fe_drive("fe-notch-large", bundle)
    drive_s = time.perf_counter() - t0
    norms = [float(np.linalg.norm(u)) for u in state.U_history[1:]]
    say("fe-notch-large", f"4 steps in {drive_s:.3f} s ({drive_s / 4:.3f} "
                          f"s per step), peak memory {peak / 2**30:.3f} GiB; "
                          f"||U|| per step {norms}")
    if not all(b > a for a, b in zip([0.0] + norms, norms)):
        raise RuntimeError("fe-notch-large: ||U|| does not grow with the "
                           "load")
    fe_unit_times("fe-notch-large", bundle, state, stats)
    del bundle, fe, state
    sync()
    torch.cuda.empty_cache()
    lap("fe-notch-large")

    # ---------------- roofline (R) ----------------
    # the roofline experiment's sweeps on the f32 history at its shapes,
    # N 2,097,152 x T 16: Newton iterations 1-12 at 8 steps a launch, 1-16
    # steps a launch at 8 iterations; every row against the plain drive
    t0 = time.perf_counter()
    xi_r, de_r, sc_r = rl.roofline_data(device=dev)
    say("roofline", f"data (rng(0), the experiment's recipe) in "
                    f"{time.perf_counter() - t0:.2f} s")
    reset_counts()
    rows_r = rl.sweep(xi_r, de_r, sc_r, reps=REPS, rounds=ROUNDS,
                      bound=HIST_BOUND["float32"])
    sync()
    r_launches = read_counts()["j2_soa_history_iters"]
    for row in rows_r:
        say("roofline", f"iters {row['newton_iters']:2d} t_steps "
                        f"{row['t_steps']:2d}: {row['ms']:.4f} ms per drive "
                        f"({row['launches']} launches), "
                        f"{row['updates_per_s']:.4g} updates/s, "
                        f"{row['bytes_per_update']:.2f} B/update, "
                        f"{row['gb_per_s']:.1f} GB/s = "
                        f"{row['byte_bound_share']:.1%} of the byte bound; "
                        f"vs plain: max abs err {row['max_abs_err']:.3e}, "
                        f"row-scaled {row['max_row_scaled_err']:.3e} (bound "
                        f"{HIST_BOUND['float32']:g}); "
                        f"{row['plastic_updates']} plastic updates")
    head = next(r for r in rows_r
                if r["newton_iters"] == 8 and r["t_steps"] == 8)
    r_plain = best_ms(lambda x: rl.plain_drive(x, de_r, sc_r, 8), xi_r, sync)
    r_bound = bound_ms(rl.bytes_per_update(8) * rl.N * rl.T,
                       ops["j2_soa_history<float, 8>"], rl.N * rl.T,
                       head["plastic_updates"])
    results["roofline"] = (max(r["max_abs_err"] for r in rows_r),
                           head["ms"], r_plain)
    say("roofline", f"iters 8, t_steps 8: kernel {head['ms']:.4f} ms, plain "
                    f"{r_plain:.4f} ms per drive; bound {r_bound[0]:.4f} ms "
                    f"({r_bound[1]}; bytes {r_bound[2]:.4f} ms, operations "
                    f"{r_bound[3]:.4f} ms); {r_launches} launches in the "
                    f"sweeps")
    del xi_r, de_r, sc_r
    sync()
    torch.cuda.empty_cache()
    lap("roofline")

    # ---------------- launches ----------------
    # the FE kernels' counts are fe-grad's first gradient's (its forward
    # Newton, reverse assemblies and transpose solves) plus fe-hessian's
    # first Hessian evaluation's (the hessian command)
    fe_main = {k: grad_counts[k] + hess_counts[k] for k in (
        "j2_soa_step", "segment_sum_tile", "segment_sum_block",
        "coarse_pair_sum", "csr_matvec")}
    main_path = {"j2_soa_history": launches["j2_soa_history"],
                 "j2_aos_step": mp_launches["j2_aos_step"],
                 "j2_total_step": mp_launches["j2_total_step"],
                 "j2_soa_history_iters": r_launches, **fe_main}
    # the Hosford path (fe-hosford's primal and gradient at 47,628 tets)
    # runs the FE kernels but not j2_soa_step
    hosford_path = {k: hos_counts.get(k, 0) + hgrad_counts.get(k, 0)
                    for k in main_path}
    # the elastic path (fe-elastic's two primals + fe-elastic-grad's
    # gradient at 47,628 tets) likewise
    elastic_path = {k: sum(c.get(k, 0) for c in el_counts.values())
                    + egrad_counts.get(k, 0) for k in main_path}
    say("launches", f"main paths (fe-grad + fe-hessian; history-drive; "
                    f"mp-batched; roofline): {main_path}; fe-grad "
                    f"{grad_counts}; fe-hessian {hess_counts}; fe-notch's "
                    f"primal launched "
                    f"{fe_counts}; fe-dispatch launched j2_soa_step "
                    f"{launches['j2_soa_step']} times; the Hosford path "
                    f"(fe-hosford's primal + gradient) {hosford_path}; the "
                    f"elastic path (fe-elastic's primals + fe-elastic-"
                    f"grad's gradient) {elastic_path}")
    if not all(v > 0 for v in main_path.values()):
        raise RuntimeError(f"launches: a kernel never ran: {main_path}")

    # bounds from this run's shapes and data (f64): bytes each input read
    # once and each output written once; operations from the SASS counts
    # and the plastic updates this run's data produced. j2_soa_step is
    # reported at the FE notch's shape, the fe-dispatch shape in a line
    step_ms, step_plain = timings[("step", "float64")]
    b_ms, by, t_bytes, t_ops = bound_ms(
        BYTES_PER_K1_POINT * N_FE, ops["j2_soa_step<double>"], N_FE,
        step_plastic)
    say("launches", f"j2_soa_step at the fe-dispatch shape N={N_FE}: "
                    f"bound {b_ms:.4f} ms ({by}; bytes {t_bytes:.4f} ms, "
                    f"operations {t_ops:.4f} ms); kernel {step_ms:.4f} ms "
                    f"= {b_ms / step_ms:.1%} of the bound, plain "
                    f"{step_plain:.4f} ms, max abs err {results['step_err']:.3e}")
    drive_ms, drive_plain = timings[("drive", "float64", "headline")]
    bounds = {
        "j2_soa_step": fe_k1["k1_bound"],
        "j2_soa_history": bound_ms(
            (48 * T_DRIVE + 120) * N_DRIVE, ops["j2_soa_history<double, 8>"],
            N_DRIVE * T_DRIVE, sum(hist_plastic)),
        "j2_soa_history_iters": r_bound,
        "segment_sum_tile": (results["segsum"][4], "bytes"),
        "segment_sum_block": (results["segsum_block"][4], "bytes"),
        "coarse_pair_sum": (results["pair"][4], "bytes"),
        "csr_matvec": (results["csr"][4], "bytes"),
    }
    # (name, source, replaces, max abs err, (ms, cold ms), (plain ms, plain
    # cold ms), (library ms, library cold ms)): warm, as the path runs it,
    # and cold (cold_ms), timed the same way for the kernel, its plain
    # version and the library call. The kernels outside the FE path run on
    # inputs larger than twice the L2, so every call of theirs reads its
    # inputs from device memory: their time is their cold time
    rows = [("j2_soa_step", SOURCE, f"{PALLAS}:173", fe_k1["k1_err"],
             (fe_k1["k1_ms"], fe_k1["k1_cold"]),
             (fe_k1["k1_plain"], fe_k1["k1_plain_cold"]), (None, None)),
            ("j2_soa_history", SOURCE, f"{PALLAS}:464", results["hist_err"],
             (drive_ms,) * 2, (drive_plain,) * 2, (None, None))]
    for form, kname, line, nbytes in (("rate", "j2_aos_step", 40, 328),
                                      ("total", "j2_total_step", 624, 256)):
        ms, _entry, plain_t, plastic1 = timings[("mp", form, "float64")]
        bounds[kname] = bound_ms(nbytes * N_MP, ops[f"{kname}<double>"],
                                 N_MP, plastic1)
        rows.append((kname, SOURCE, f"{PALLAS}:{line}",
                     results[f"{form}_err"], (ms,) * 2, (plain_t,) * 2,
                     (None, None)))
    r_err, r_ms, r_plain = results["roofline"]
    rows += [("j2_soa_history_iters", SOURCE, f"{ROOFLINE}:40", r_err,
              (r_ms,) * 2, (r_plain,) * 2, (None, None)),
             ("segment_sum_tile", SEGSUM_SOURCE,
              "index_add_ (no Pallas kernel): cmad_tpu_torch/fem/"
              "assembly.py, sparse_solve.py", *results["segsum"][:4]),
             ("segment_sum_block", SEGSUM_SOURCE,
              "index_add_ (no Pallas kernel): cmad_tpu_torch/fem/"
              "two_level.py _apply_PT; JAX: cmad_tpu/fem/two_level.py:269",
              *results["segsum_block"][:4]),
             ("coarse_pair_sum", SEGSUM_SOURCE,
              "PyTorch product + segment_sum (no Pallas kernel): "
              "cmad_tpu_torch/fem/two_level.py coarse_matrix; JAX: "
              "cmad_tpu/fem/two_level.py:314", *results["pair"][:4]),
             ("csr_matvec", SEGSUM_SOURCE,
              "torch.sparse_csr_tensor @ x (no Pallas kernel): "
              "cmad_tpu_torch/fem/sparse_solve.py", *results["csr"][:4])]
    for kname, _src, _rep, _err, (ms, cold), _plain, _lib in rows:
        b_ms, by = bounds[kname][:2]
        say("launches", f"{kname}: bound {b_ms:.4f} ms ({by}); kernel "
                        f"{cold:.4f} ms cold ({ms:.4f} warm) = "
                        f"{b_ms / cold:.1%} of the bound")

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_path[kname],
         "hosford_launches": hosford_path[kname],
         "elastic_launches": elastic_path[kname], "max_abs_err": err,
         "ms": ms,
         "plain_ms": plain_t, "bound_ms": bounds[kname][0],
         "bound_by": bounds[kname][1], "library_ms": lib, "cold_ms": cold,
         "plain_cold_ms": plain_cold, "library_cold_ms": lib_cold}
        for kname, src, rep, err, (ms, cold), (plain_t, plain_cold),
        (lib, lib_cold) in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
