#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (aligator_tpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, in order;
any failed check raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels of ``aligator_tpu_torch/csrc`` with nvcc, one
   process per library (K1 one per shape of ``fused_riccati.DOMAIN_SAMPLES``),
   in parallel, with ptxas's registers and spills for each; the two K1
   shapes that take nvcc one to two minutes build in a background thread
   while the phases run, and are checked after the θ sensitivities
   (phase 10); a worker
   process (CPU only) meanwhile solves the free-dynamics and contact paths'
   CPU references (phases 11 and 12);
3. kernels: each kernel (K1 fused Riccati, K2 SPD solve, K3 fused backward
   sweep, K4 forward substitution, K5 contact-dynamics derivative rows) held
   against its plain PyTorch version on the card, at the main paths' shapes
   (fp32) and at the test shapes (fp64), and timed beside its memory/compute
   bound and, where one PyTorch call computes the same function, that call;
   K1 at each sample of its domain in fp64 (built a shape a library, all in
   the build phase), its time alone and its whole step (from the LQ problem
   to the returned tensors, at most three device operations) at the SE(2)
   shape and at cartpole's over 101 knots;
   K2 at every shape the paths launch (the LQ loop's at batch 16 and 256,
   the contact KKT's at both walk batches, the parallel legs' θ sweep, the
   associative leaves and gain recovery), K5 at both walk batches, at the
   Solo's 4 contacts and past its old cap at 20 and 40 contacts; K3 and
   K4 also print their shared memory, registers and resident blocks per SM
   at the main shapes, and K3 its time at batches of 132 to 1024 (1 to 7.8
   scenarios for each of the 132 SMs); K2 and K4 also at the free-dynamics
   reaches' shapes (fp64) and K1 at the acrobot's; K2 (with the
   differentiable solve's tangent and adjoint launches), K4 and K5 (without
   and with position references) at the contact paths' shapes (fp64); the
   free-dynamics kernel
   (``csrc/free_fd.cu``, the forward dynamics of ``model.aba``) on every
   robot builder against its plain version and timed at the three paths'
   shapes and, with an armature, on the Panda read from MJCF and the FFSR; the stability of K2 in fp32 (condition 1e5, both routes) and of
   K3 on nearly singular KKT systems in a rotated control basis (fp32 at μ
   = 1e-4 and 1e-5, fp64 at 1e-8), each held to 10 times the backward
   error of the plain Cholesky solves (and K3 in fp32 to 10 times the
   plain sweep's gap to fp64);
4. the SE(2)-car path: batched ProxDDP (N=50, batch 32768, fp32, the
   ``bench.py`` configuration) on the card, with the plain versions patched
   to raise and the kernels' launch counts read around it, the converged
   fraction, solves/s, a device-time
   breakdown, and the first 256 scenarios solved again on the CPU;
5. the medium-dim paths, fp32 at the bench configurations: humanoid-dims
   ProxDDP (nx=36, N=100, batch 1024; K3 and K4), dense LQR-56 ProxDDP
   (batch 256; K2 and K4) and LQR-56 FDDP (K2). Each runs with the plain
   versions patched to raise, its launch counts read around it and checked
   against the route, then prints its converged fraction and solves/s and
   solves its first 16 scenarios again on the CPU;
6. the whole-body Talos-walk path (``bench_talos.py`` protocol: N=32, fp32,
   ProxDDP 4x4 budget; K5, K2 and K4) at batch 16 and 256, with the plain
   versions patched to raise, launch counts checked per Newton step, solves/s
   and a breakdown; then 2 scenarios solved on the card and again on the
   CPU in fp64 and checked, and 2 scenarios solved on the card in fp32 step
   by step against the JAX package's fp32 solve of them (a committed
   reference: which Newton steps are rejected, infeasibilities per step);
7. the parallel-in-time LQ solvers, with the plain
   versions patched to raise and launch counts checked against the route:
   (a) the latency of one LQ
   solve (N = 128, 512 and 2048 at B = 1 as ``bench_latency.py:91`` runs
   them, and N = 2048 at B = 1024; nx = 4, nu = 2, nc = 0, fp32, mu = 1e-3;
   the ``bench.py:297-310`` protocol) by the serial solve (K1), the
   associative scan (one refinement step) and 8 parallel legs (at B = 1
   only), by the chained method of ``bench_latency.chained_latency``, with each fp32
   solution's KKT error in fp64 and its distance to the fp64 CPU serial
   solve; (b) humanoid-dims ProxDDP on ``linear_solver='parallel'`` (4
   legs) at the bench's batch, solves/s beside the serial route's, and 16
   scenarios again on the CPU in fp64; (c) ProxDDP on
   ``linear_solver='associative'`` on the double-integrator LQR with
   ``|u| <= 0.2`` (N = 100, batch 4096, fp64), the Newton steps on each
   route counted, against ``'serial_scan'`` on the card and 16 scenarios on
   the CPU, and the same problem in fp32 below the mu floor, where every
   step takes the serial solve;
8. the cartpole (``examples/cartpole.py``: N = 100, |u| <= 25, float64,
   ``rollout='nonlinear'``, the published options) at batch 1024, with the
   plain versions patched to raise and K1's launches checked against the
   Newton steps: solves/s, the converged fraction (held to a floor from
   the JAX package's CPU solve of the same initial states), the
   iterations, a device-time breakdown of a solve cut to 1 iteration, and
   the first 16 scenarios again on the CPU for 4 iterations (the solve's
   path is chaotic: rounding differences part card and CPU after ~6); then
   at batch 64 the implicit midpoint rule (K1 with general E; its horizon
   cut to N = 20, two Newton steps a stage in the rollout, its budget cut
   to 120 iterations, its converged fraction held to a floor likewise, and
   a breakdown) and
   ``hessian_approx='exact'`` (cut to 20 iterations), each with its CPU
   check; then the float32 run at batch 1024, cut to 20 iterations, whose
   converged fraction within them gates nothing. Every line-search trial
   is a CUDA-graph replay: a trial that falls back to eager execution
   fails the script;
9. inverse LQR (``examples/inverse_lqr.py``): 16 demonstrations and 100
   Adam steps (the published fit takes 300) through ``gar.diff.solve`` on
   the card and again on the CPU (the final loss and the first step's gradient compared), K2's launches
   checked against the forward and adjoint solves' per-stage loops, ms a
   step at 16 and 4096 demonstrations and a breakdown of one step;
10. the θ sensitivities of the double-integrator family
   (``examples/theta_family.py``, N = 20, float64) without and with the
   active box |u| <= 0.12, at 4096 random θ: ``th_grad`` and ``th_hess``
   against the CPU's on the first 512, 4 scenarios against central finite
   differences of converged values, K2's launches in the θ backward, ms a
   harvest and a breakdown of one; then K1 at the two shapes built in the
   background, against its plain version (fp64);
11. the free multibody dynamics (``examples/ur5_reach.py``, N = 40, batch
   1024; ``examples/dual_ffsr_reach.py``, the dual-arm free-floating space
   robot, N = 60, batch 256; ``examples/acrobot.py``, N = 120, batch 1024;
   float64, the published options, ``rollout='nonlinear'``, the budgets
   cut to 50, 40 and 130 iterations for the script's time), with the
   plain versions patched to raise and the launch counts checked against
   the route (K2 twice a stage and K4 once a Newton step on the reaches,
   K1 once a Newton step on the acrobot, the free-dynamics kernel once a
   stage of every rollout on all three): solves/s, the converged
   fraction and the iterations, the first 16 scenarios' converged count
   held to the JAX package's less one (``tests/data/torch_free_ref.npz``),
   those 16 again on the CPU for 4 iterations, held at each iteration to
   1e-9 or to 100 times the distance between two CPU solves an ulp apart
   in their initial states, whichever is larger (these solves magnify any
   rounding), the same 16 on the card with ``model.aba`` in place of the
   free-dynamics kernel held likewise (the witness that the kernel's
   rounding is no larger than any other), and a device-time breakdown of
   an FFSR solve cut to 1 iteration;
12. the contact paths (float64, the published options): the UR10 payload
   throw (``examples/ur10_ballistic.py``: the arm and a free-flying payload,
   a 6D grasp as a loop constraint with position references, released at
   40% of the horizon; N = 80, dt = 0.025, linear rollout, its 400
   iterations cut to 120 for the script's time,
   filter line search, from its warm start) at 64 targets, and the Solo
   jump (``examples/solo_jump.py``: 4 point feet under a stance, flight,
   landing schedule, N = 28, its 60 iterations cut to 30,
   ``rollout='nonlinear'``) at
   256 initial states, with the plain versions patched to raise and the
   launch counts checked against the route (the throw: K2 for the per-stage
   loop, the loop constraint's KKT and its implicit tangents, and the
   trials' dynamics, K4; the jump: K5, K2, K4): solves/s, frac_converged,
   the iterations, a device-time breakdown of one iteration, the first
   scenarios' converged count (4 throws, 64 jumps) held to the JAX
   package's less one (``tests/data/torch_contact_ref.npz``) and the first
   4 of each against the CPU over 4
   iterations as in phase 11; the throw's payload landing error (held to
   1e-3 on the converged first 4) and torque-box violation, the jump's peak
   base height;
13. the UR5 table reach (``examples/ur5_table.py``: the end effector's
   capsule above a table plane and its sphere clear of a box on the table,
   N = 30, dt = 0.05, |τ| <= 80, ``ProxDDPConfig(tol=1e-4, mu_init=1e-2,
   max_iters=100)``, linear rollout) at 1024 perturbed starts, float64,
   with the plain versions patched to raise and the launch counts checked
   against the route (K2 twice a stage and K4 once a Newton step, the
   free-dynamics kernel once a trial and once a derivative evaluation):
   solves/s, frac_converged, the first 16 scenarios' converged count held
   to the JAX package's less one (``tests/data/torch_collision_ref.npz``),
   those 16 against the CPU over 4 iterations as in phase 11, the end
   effector's lowest height held to the table's on the converged
   trajectories and the final end-effector error;
14. receding-horizon MPC (``examples/mpc_se2.py``, ``bench_mpc.py``'s
   protocol: a cold solve, then 20 chained warm cycles at 2 iterations,
   float32): the SE(2) car at batch 1 and 4096, humanoid dims at 1 and
   128, with the plain versions patched to raise and the launches checked
   against the route (K1; K3 and K4): ms a cycle of one scenario by the
   delta of 20 and 5 chained cycles, scenario-cycles/s of a batch, the
   share of cycles primal-feasible at 1e-4, at batch 1 the host syncs,
   kernels and device-busy share of one cycle, the first 16 scenarios'
   first 4 cycles against the CPU (counts and flags equal, trajectories
   within 1e-3);
15. the centroidal paths (float64, the published options and budgets):
   the wheeled inverted pendulum (``examples/wheeled_inverted_pendulum.py``,
   N = 100, RK2, nonlinear rollout) at 1024 initial states, the
   centroidal gait (N = 90), the Solo kinodynamics (T = 64) and the
   continuous gait (T = 210) at 256, with the plain versions patched to
   raise and the launches checked against the route (K1; K2 2N a Newton
   step; K3 and K4): solves/s, frac_converged, the first 16 scenarios'
   converged count held to the JAX package's less one
   (``tests/data/torch_centroidal_ref.npz``), each converged scenario's
   physical checks (``solution_checks``: the CoM target, forces in the
   friction cone on active contacts and none on swing ones, the pendulum
   upright at its goal within its torque bound), the first 2 scenarios
   against the CPU over 4 iterations as in phase 11;
16. the Panda reach on a Panda read from MJCF (``examples/panda_reach.py``
   with ``real_model=True``): ``model_to_mjcf`` writes the nominal Panda
   with its flange named ``attachment`` and Menagerie's armature 0.1 on its
   7 dofs to a temporary file, ``make_panda_real`` reads it back through
   ``load_mjcf`` (the model held to the one written: every table to 1e-12,
   the armature equal); N = 50, dt = 0.02, the capsule post, the published
   ``ProxDDPConfig`` with its 300 iterations cut to the fixture's budget,
   float64, 256 starts about the home posture, with the plain versions
   patched to raise and the launches checked against the route (K2 twice
   a stage and K4 once a Newton step, the free-dynamics kernel with its
   armature section once a stage of every rollout): solves/s,
   frac_converged, the iterations, a breakdown of one iteration, the first
   16 starts' converged count held to the JAX package's less one
   (``tests/data/torch_ingest_ref.npz``), the first 4 against the CPU over
   4 iterations as in phase 11, the elbow's and the flange's least
   clearance to the post and the final flange error;
17. the mesh helpers and the sharded parallel-in-time solve over
   ``torch.distributed`` (``parallel/mesh.py``, ``gar.parallel.
   solve_sharded``), after the build so that no rank builds: a world of
   one on NCCL, ``batched_solve`` of ``bench_scaling.py``'s SE(2) problem
   (N = 50, fp32, 4 × 4 budget) at 4096 scenarios; four gloo processes
   sharing the card (spawned; NCCL takes one rank a GPU), the same at 4 ×
   4096 (each rank's K1 launches, iterations and controls against one
   process solving the whole batch) and ``solve_sharded`` at
   ``bench_scaling.py``'s medium dims (N = 511, nx = 36, nu = 12, fp32, 4
   legs: one all-gather a rank, KKT in fp64 beside the serial solve on
   the card); ms a solve for each world beside the one-process figures.
   Ranks sharing one card measure the code path, not scaling;
18. a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line last.

Without a CUDA device it exits non-zero before printing any result.
"""

import collections
import contextlib
import dataclasses
import json
import math
import multiprocessing
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings
from types import SimpleNamespace

import numpy as np
import torch

H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores
H100_FP64_FLOP_PER_S = 34e12  # fp64 outside the tensor cores (data sheet)

BATCH = 32768
NSTEPS = 50
SEED = 0
# K1 domain samples whose nvcc runs take minutes (done 77 and 138 s after
# the build's start, every other library within 17 s, on an H100 machine):
# built in the background, checked after the θ sensitivities
K1_SLOW_SHAPES = ((8, 8, 16, False), (8, 8, 32, True))
# max|kernel - plain| / max(1, max|plain|), float32: the plain version's own
# float32 error against float64 reaches 1e-4 on the multipliers at
# mu_dyn = 1e-4 (cancellation in lam0 = (g0 + G0 x0)/mu_dyn), so two float32
# evaluations in different orders may differ by twice that
FP32_TOL = 5e-4
FP64_TOL = 1e-9  # the same, float64
CPU_CHECK_SCENARIOS = 256
CPU_TRAJ_TOL = 1e-3  # fp32 card vs fp32 CPU solve, max abs over xs and us
MIN_FRAC_CONVERGED = 0.99

# medium-dim paths (bench.py:156-213, bench_lqr.py:22-81)
HUMANOID_BATCH = 1024
LQR_BATCH = 256
MEDIUM_NSTEPS = 100
MEDIUM_CPU_SCENARIOS = 16
# fp32 card vs fp32 CPU solve of the same scenarios, max |Δ| over xs and us
# relative to max(1, max |xs|, max |us|): the K3/K2 sums run in another order
# than the CPU's, over 100 stages and up to 4 Newton steps
MEDIUM_CPU_TRAJ_TOL = 1e-3
# kernel vs plain version, max error relative to max(1, output scale)
K2_FP32_TOL = 1e-4  # well-conditioned SPD systems (eigenvalues >= 1)
# K3/K4 at the main shapes with random convex knots over 100 stages and
# mu_eq down to 1e-3: both float32 results are compared with the float64
# plain sweep for context
K3_FP32_TOL = 1e-3
K4_FP32_TOL = 1e-4
K5_FP32_TOL = 1e-3
K5_MANY_CONTACTS = (20, 40)  # past the kernel's old cap of 16 contacts

# whole-body path (bench_talos.py:43-89)
TALOS_T_DS, TALOS_T_SS = 4, 10  # N = 32
TALOS_BATCHES = (16, 256)
TALOS_CPU_SCENARIOS = 2
# timed batches at each walk batch (5, then 3 for later phases' time)
TALOS_TIMED = 2
# card vs CPU, both float64, max |Δ| over xs and us relative to their scale.
# In float32 the reduced KKT of a Newton step can come out indefinite (its
# condition number is above 1/eps of float32), so which step is rejected
# depends on the order of the sums: the card's float32 solve is held
# against the JAX package's float32 solve instead, step by step, its
# infeasibilities within this relative error
TALOS_CPU_TRAJ_TOL = 1e-6
TALOS_FP32_TOL = 1e-4

# parallel-in-time phase (bench.py:297-324, bench_latency.py)
LAT_N, LAT_DIMS, LAT_MU = 2048, (4, 2, 0), 1e-3
LAT_NS = (128, 512, LAT_N)  # bench_latency.py:91
LAT_BATCHES = (1, 1024)
LAT_LEGS = 8
LAT_CPU_SCENARIOS = 2
# each fp32 solution, evaluated in fp64: its KKT residuals (max norm), and
# its distance to the fp64 CPU serial solve relative to that solve's scale.
# The port's float32 solves on the CPU reach 5.4e-5 / 7.6e-6 (serial),
# 9.4e-7 / 1.9e-7 (associative, one refinement step) and 7.3e-6 / 1.4e-6
# (8 legs) on this problem
LAT_KKT_TOL = 1e-3
LAT_DIST_TOL = 1e-4
PAR_LEGS = 4
ASSOC_BATCH, ASSOC_NSTEPS, ASSOC_U_BOUND = 4096, 100, 0.2
ASSOC_TOL = 1e-6  # card 'associative' vs card 'serial_scan' and vs the CPU, fp64

# cartpole with the nonlinear rollout (examples/cartpole.py, float64)
CART_BATCH = 1024
# frac_converged floor, fp64: the JAX package's CPU solve of the first 256
# of these initial states converges 227 (0.887; 13 of the first 16)
CART_MIN_FRAC = 0.85
CART_VARIANT_BATCH = 64  # the implicit midpoint rule and 'exact' Hessians
# the midpoint rule: N = 20 (a trial is ~500 operations a stage, so the
# published N = 100 to convergence would take minutes), two Newton steps a
# stage in the rollout (with one, the JAX package's solve reaches the
# 300-iteration budget on every scenario tried, at N = 20 and 100; with two
# it converges 63 of these 64 initial states at N = 20, 0.984); floor
# below that
CART_MIDPOINT_NSTEPS = 20
CART_MIDPOINT_NEWTON = 2
CART_MIDPOINT_MIN_FRAC = 0.9
# its budget cut 300 -> 120 for the time limit (the MPC and centroidal
# phases): on the card every scenario that converges does so within 90
# iterations and one runs to the budget, which set the solve's time
CART_MIDPOINT_ITERS = 120
CART_EXACT_ITERS = 20
# the fp32 run's depth: its converged fraction within these iterations is
# read beside fp64's within the same (each iteration ~0.3 s, host-bound);
# cut from 150 to 40 to make room for the free-dynamics phase, then to 20
# for the MPC and centroidal phases
CART_FP32_ITERS = 20
# the depth of the profiled solve (fp64, batch 1024): the profiler's
# processing of a solve's ~64,000 kernels an iteration takes ~10 s an
# iteration on an H100 (PERF.md §6); 2 before the ingested Panda's phase
CART_PROFILE_ITERS = 1
CART_CPU_SCENARIOS = 16
# card vs CPU, both float64, over the CPU run's first CART_CPU_ITERS
# iterations: the history rows and the iterate reached, max |Δ| relative to
# max(1, max |ref|). The swing-up is chaotic in the solver's path: two CPU
# solves whose initial states differ by 1e-15 relative part by 1.6e-5 at
# iteration 6 and by 29% in their trajectories at iteration 30
# (tools/torch_cartpole_divergence.py), as the card's and the CPU's did
# (on an H100: 27% in the history at 30 iterations, 2.0 in the
# trajectories at 300; PERF.md §6), so only the first iterations can agree
CART_CPU_ITERS = 4
CART_CPU_TOL = 1e-6
# free multibody dynamics (examples/ur5_reach.py, examples/dual_ffsr_reach.py,
# examples/acrobot.py), float64, the published options
FREE_BATCHES = {"ur5": 1024, "ffsr": 256, "acrobot": 1024}
# the JAX package's solve of the first 16 scenarios of each batch at the
# published size (tools/torch_free_fixture.py): each path's converged count
# on them is held to JAX's less one
FREE_REF = "tests/data/torch_free_ref.npz"
FREE_NSTEPS = {"ur5": 40, "ffsr": 60, "acrobot": 120}
# iteration budgets cut for the script's time limit, which the contact
# phase after them also needs: the FFSR reach 120 -> 60 -> 50 (JAX
# converges 6 of the first 16 within 50, 10 within 60), the UR5 reach 100
# -> 50, the acrobot 250 -> 150 -> 130 (the MPC and centroidal phases' time;
# JAX converges 11 of the first 16 within 130, 13 within 150); for the
# ingested Panda's phase the FFSR 50 -> 40 (JAX converges 1 of the first
# 16 within 40); the first 16
# scenarios are then held to the JAX package's count of those that
# converged within the cut budget, less one
FREE_MAX_ITERS = {"ffsr": 40, "ur5": 50, "acrobot": 130}
FREE_CPU_SCENARIOS = 16
# card vs CPU, relative, by iteration: these solves magnify any difference
# of rounding from their first Newton step. Two CPU solves of the first 16
# scenarios whose initial states differ by one ulp (x0 and x0·(1 + 1e-15))
# part by 5.4e-10, 1.6e-8, 5.4e-7 (UR5) and 4.5e-8, 5.1e-7, 2.5e-7 (FFSR)
# in their history rows after 1, 2, 3 iterations, as far as the card and
# the CPU do (UR5 3.7e-10, 1.2e-8, 3.0e-7; FFSR 3.0e-7, 1.3e-6, 6.9e-7 on an
# H100), and the CPU with its forward dynamics summed in another order
# parts from itself alike (tools/torch_free_divergence.py; PERF.md §6). So
# each iteration's rows and the iterate after CART_CPU_ITERS iterations are
# held to FREE_CPU_TOL or to FREE_SPREAD_FACTOR times the largest distance
# between the CPU solve from x0 and those from x0·(1 ± FREE_SPREAD_EPS),
# measured in the same run, whichever is larger; a fault parts them by
# orders of magnitude more
FREE_CPU_TOL = 1e-9
FREE_SPREAD_EPS = 1e-15
FREE_SPREAD_FACTOR = 100
# the depth of the FFSR's profiled solve (~157,000 device kernels an
# iteration, PERF.md §5)
FREE_PROFILE_ITERS = 1
# the free-dynamics kernel against its plain version, fp32: the FFSR's mass
# matrix has condition numbers ~1e4 to 1e5, so two fp32 evaluations in
# different orders differ by ~cond·eps
FREE_FD_FP32_TOL = 1e-2
# inverse LQR (examples/inverse_lqr.py)
# phase 12, the contact paths (fp64, the published options): the UR10
# payload throw (examples/ur10_ballistic.py, N = 80, dt = 0.025, 400
# iterations, linear rollout, filter line search, from its warm start) at
# B = 64 targets, the Solo jump (examples/solo_jump.py, stance, flight,
# landing = 10, 8, 10, 60 iterations, nonlinear rollout) at B = 256 initial
# states; the first 4 throws and 64 jumps against the JAX package's
# converged count (the jumps part beyond ~10 iterations: over 16 the count
# moved by one with 1e-14 changes in K2's solutions;
# tests/data/torch_contact_ref.npz,
# tools/torch_contact_fixture.py) and the first 4 of each, over
# CART_CPU_ITERS iterations, against the CPU as the free paths are
UR10_BATCH, UR10_NSTEPS, UR10_DT = 64, 80, 0.025
SOLO_BATCH, SOLO_PHASES = 256, (10, 8, 10)
CONTACT_REF = "tests/data/torch_contact_ref.npz"
CONTACT_CPU_SCENARIOS = 4
UR10_LANDING_TOL = 1e-3  # tests/test_ballistic.py's bound
# the throw's budget cut 400 -> 320 for the script's time limit (with the
# UR5 table phase after it), then to 200 (the MPC and centroidal phases):
# its first 4 are held to the JAX package's count of those that converged
# within the cut budget (scenario 0 at 302), less one, which within 320
# was 0 already (the card converged none of the first 4 there, 2 of the 64
# at 265 and 288 iterations); the jump's 60 -> 40 (JAX converges 19 of
# the first 64 within 40, as within 60); for the ingested Panda's phase
# the throw's 200 -> 120 and the jump's 40 -> 30
CONTACT_MAX_ITERS = {"ur10": 120, "solo": 30}
CONTACT_PROFILE_ITERS = 1
# phase 13, the UR5 table reach (examples/ur5_table.py: N = 30, dt = 0.05,
# |tau| <= 80, the table plane and the box; ProxDDPConfig(tol=1e-4,
# mu_init=1e-2, max_iters=100), linear rollout) at B = 1024 perturbed starts,
# float64; the first 16 against the JAX package's converged count
# (tests/data/torch_collision_ref.npz, tools/torch_collision_fixture.py) and,
# over CART_CPU_ITERS iterations, against the CPU as the free paths are
TABLE_BATCH, TABLE_NSTEPS = 1024, 30
TABLE_REF = "tests/data/torch_collision_ref.npz"
TABLE_CPU_SCENARIOS = 16
TABLE_Q0 = (0.0, -1.2, 1.6, 0.0, 0.0, 0.0)  # examples/ur5_table.py's start
TABLE_PROFILE_ITERS = 2
# phase 16, the Panda reach on a Panda read from MJCF (examples/panda_reach.py,
# real_model=True, on the armature Panda that write_panda_mjcf writes; N =
# 50, dt = 0.02, the post; ProxDDPConfig(tol=1e-4, mu_init=1e-2,
# rollout="nonlinear"), its 300 iterations cut to the fixture's
# full_budget for the script's time; the JAX package converges none of
# the first 16 within it, nor within 300 from the home posture) at B =
# 256 starts, float64; the first 16 against the JAX package's converged
# count (tests/data/torch_ingest_ref.npz, tools/torch_ingest_fixture.py),
# the first 4 over CART_CPU_ITERS iterations against the CPU as the free
# paths are
PANDA_BATCH, PANDA_NSTEPS = 256, 50
PANDA_REF = "tests/data/torch_ingest_ref.npz"
PANDA_CPU_SCENARIOS = 4
PANDA_PROFILE_ITERS = 1
INV_DEMOS = (16, 4096)
INV_STEPS = 100  # cut from 300 (the published fit) for the free-dynamics phase
INV_TIMED_STEPS = 5  # 10 before the MPC and centroidal phases
INV_LOSS_TOL = 1e-6  # final loss, card vs CPU, relative
INV_GRAD_TOL = 1e-8  # first step's gradient, card vs CPU, relative
# θ sensitivities (examples/theta_family.py)
SENS_BATCH = 4096
# the first scenarios solved and harvested again on the CPU: all 4096 of
# the box case take 195 s on the card machine's CPU, 512 take 37.6 s
# (PERF.md §6), 14% of them running to the 300-iteration budget
SENS_CPU_SCENARIOS = 128
SENS_TOL = 1e-8  # th_grad, th_hess card vs CPU, relative to max(1, scale)
SENS_FD_SCENARIOS = 4


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- phase 1


def device_phase():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


# ---------------------------------------------------------------- phase 2


def _print_build_log(variants):
    from aligator_tpu_torch import _build

    for v in variants:
        secs, log = _build.BUILD_LOG[_build.label(v)]
        print(f"[build] {_build.label(v)}: built {secs:.1f} s after the start")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {_build.label(v)}: {line.strip()}")


class BackgroundBuild:
    """``_build.build(variants)`` in a thread; ``join()`` waits for it and
    raises what it raised."""

    def __init__(self, variants):
        self.variants, self.error = variants, None
        self.thread = threading.Thread(target=self._run, name="nvcc-background")
        self.t0 = time.perf_counter()
        self.thread.start()

    def _run(self):
        from aligator_tpu_torch import _build

        try:
            _build.build(self.variants)
        except BaseException as err:  # re-raised by join()
            self.error = err
        self.secs = time.perf_counter() - self.t0

    def join(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        print(f"[build] background: {len(self.variants)} libraries in {self.secs:.1f} s")
        _print_build_log(self.variants)


def build_phase():
    """Build every library, then start the K1 shapes of K1_SLOW_SHAPES in
    the background (returns their :class:`BackgroundBuild`)."""
    from aligator_tpu_torch import _build

    from aligator_tpu_torch.gar import fused_riccati as fr

    # K1 is built a shape at a time: its domain samples and the latency
    # phase's shape, with the others
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu") if p.stem != fr._SOURCE)
    shapes = [s for s in dict.fromkeys(list(fr.DOMAIN_SAMPLES) + [(*LAT_DIMS, True)])
              if s not in K1_SLOW_SHAPES]
    variants = names + [fr.variant(*s) for s in shapes]
    t0 = time.perf_counter()
    _build.build(variants)
    dt = time.perf_counter() - t0
    # after the others: a build holds the build lock until its last library
    late = BackgroundBuild([fr.variant(*s) for s in K1_SLOW_SHAPES])
    print(f"[build] {len(variants)} libraries ({names} and K1 at "
          f"{len(variants) - len(names)} shapes) in {dt:.1f} s; K1 at {K1_SLOW_SHAPES} "
          f"building in the background")
    _print_build_log(variants)
    return late


# ---------------------------------------------------------------- phase 3


def cast(problem, dtype):
    """The LQ problems with every tensor cast to ``dtype``."""
    return problem.map(lambda t: t.to(dtype))


def abs_err(got, ref):
    return (got - ref).abs().max().item() if ref.numel() else 0.0


def rel_err(got, ref):
    if ref.numel() == 0:
        return 0.0
    return abs_err(got, ref) / max(1.0, ref.abs().max().item())


def cuda_time_ms(fn, reps):
    """Median device time of ``fn`` over ``reps`` calls, CUDA events."""
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


def k1_flops_per_stage(nx, nu, nc, explicit):
    """Approximate flop count of one backward stage plus its forward step."""
    n, m, c = nx, nu, nc
    f = 0
    if not explicit:
        f += 4 * n ** 3 + 4 * n ** 3 + 2 * n ** 2  # Gauss-Jordan, Ptilde, ptilde
        f += 2 * n ** 2 + 2 * n ** 3  # yff, Afb
    f += n ** 2 + n ** 3 // 3 + 2 * n ** 2 + (n + 1) * 2 * n ** 2  # Schur solve
    f += 2 * n ** 3 + 2 * m * n ** 2 + 2 * n ** 3 + 2 * m * m * n + 2 * m * n ** 2
    f += 2 * n ** 2 + 2 * m * n  # qhat, rhat
    f += m * m * (1 + 3 * c) + m ** 3 // 3 + m * (1 + 3 * c) + 2 * m * m
    f += n * (m * (1 + 3 * c) + 2 * m * m) + c * (2 * m + 1) * (n + 1)
    f += 2 * n * m + 2 * n ** 2 + 2 * n * n * m + 2 * n ** 3 + 3 * n + 2 * n ** 2
    f += (n * n + n) * (2 * m + 2 * c + 1) + n * n
    f += 2 * m * n + 2 * c * n + 4 * n ** 2  # forward step
    return f


def k1_bound(B, T, nx, nu, nc, explicit, itemsize):
    """K1's bound and what sets it: each knot, G0, g0 and mu word read once,
    each solution and gain word written once, and the flops of
    :func:`k1_flops_per_stage`."""
    knots = (2 * nx * nx + 2 * nx * nu + nu * nu + 2 * nx + nu + nc * (nx + nu + 1)
             + (0 if explicit else nx * nx))
    gains = nu + nu * nx + nc + nc * nx + 2 * nx + 2 * nx * nx
    nbytes = B * itemsize * (T * (knots + gains + 2 * nx + nu + nc) + nx * nx + nx + 2)
    return bound(nbytes, B * T * k1_flops_per_stage(nx, nu, nc, explicit),
                 fp64=itemsize == 8)


def k1_timing(shape, T, B, dtype=torch.float32):
    """K1 at one shape: the kernel alone (profiler), the whole step from the
    LQ problem to the returned tensors (CUDA events over back-to-back
    calls), the kernels that step launches, the plain version and the
    bound."""
    from torch.profiler import ProfilerActivity, profile

    from aligator_tpu_torch.gar import fused_riccati as fr

    nx, nu, nc, expl = shape
    prob, mud, mue = k1_problem(B, T, nx, nu, nc, expl, dtype, SEED + 30)

    def step():
        return fr.launch(prob, mud, mue, expl)

    k_ms = kernel_ms(step, 25, "fused_riccati_kernel")
    whole_ms = avg_time_ms(step, 25)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    launched = {ev.key[:60]: ev.count for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA}
    plain_ms = cuda_time_ms(lambda: fr.solve_plain(prob, mud, mue, expl), 3)
    bnd, by = k1_bound(B, T, nx, nu, nc, expl, prob.knots.Q.element_size())
    print(f"[kernel] fused_riccati {str(dtype)[6:]} {shape} B={B} T={T}: kernel {k_ms:.4f} ms, "
          f"whole step {whole_ms:.4f} ms ({sum(launched.values())} device "
          f"operations: {launched}), plain {plain_ms:.3f} ms; bound {bnd:.4f} ms "
          f"({by}), kernel/bound {k_ms / bnd:.2f}")
    check(sum(launched.values()) <= 3, f"the K1 step launched {launched}")
    return dict(kernel_ms=k_ms, whole_ms=whole_ms, plain_ms=plain_ms,
                bound_ms=bnd, bound_by=by, launched=launched)


def k1_domain_check(shapes):
    """K1 against its plain version at ``shapes`` (domain samples), fp64, a
    batch no block size divides; the data of every sample drawn from one
    stream in the order of ``DOMAIN_SAMPLES``, whichever are checked."""
    from aligator_tpu_torch.gar import fused_riccati as fr
    from aligator_tpu_torch.gar.lqr_problem import random_convex_problem

    rng = np.random.default_rng(SEED)
    for (nx, nu, nc, expl) in fr.DOMAIN_SAMPLES:
        B, T = 1000, 11
        prob = random_convex_problem(rng, B, T - 1, nx, nu, nc, not expl,
                                     torch.float64, "cuda")
        mud = torch.tensor(10 ** rng.uniform(-3, -1, B), device="cuda")
        mue = torch.tensor(10 ** rng.uniform(-3, -1, B), device="cuda")
        if (nx, nu, nc, expl) not in shapes:
            continue
        got = fr.solve(prob, mud, mue, expl)
        ref = fr.solve_plain(prob, mud, mue, expl)
        torch.cuda.synchronize()
        errs = _compare(got, ref)
        worst = max(errs.values())
        print(f"[kernel] fused_riccati fp64 (nx,nu,nc,explicit)={(nx, nu, nc, expl)} "
              f"B={B} T={T}: max rel err {worst:.3e}, max abs err "
              f"{max(_compare(got, ref, abs_err).values()):.3e} (tol {FP64_TOL:g})")
        check(worst <= FP64_TOL, f"fp64 kernel vs plain {errs}")


def k1_slow_phase(late):
    """The K1 shapes built in the background, once built."""
    late.join()
    k1_domain_check(K1_SLOW_SHAPES)


def kernel_phase():
    from aligator_tpu_torch.gar import fused_riccati as fr

    k1_domain_check([s for s in fr.DOMAIN_SAMPLES if s not in K1_SLOW_SHAPES])
    # the main path's shape: SE(2) car LQ subproblem, fp32, general E
    main = (3, 2, 0, False)
    T, B = NSTEPS + 1, BATCH
    prob, mud, mue = k1_problem(B, T, *main, torch.float32, SEED + 30)
    got = fr.solve(prob, mud, mue, False)
    ref = fr.solve_plain(prob, mud, mue, False)
    torch.cuda.synchronize()
    errs = _compare(got, ref)
    worst = max(errs.values())
    print("[kernel] fused_riccati fp32 se2car shape B=%d T=%d rel errs %s" % (
        B, T, {k: f"{v:.2e}" for k, v in errs.items()}))
    # context: both float32 results against the float64 plain solve on the
    # same (float32-rounded) data
    p64 = cast(prob, torch.float64)
    ref64 = fr.solve_plain(p64, mud.double(), mue.double(), False)
    for name, res32 in (("kernel", got), ("plain", ref)):
        e = _compare(_to64(res32), ref64)
        print(f"[kernel] fused_riccati fp32 {name} vs fp64 plain: max rel err "
              f"{max(e.values()):.2e} ({max(e, key=e.get)})")
    max_abs = max(_compare(got, ref, abs_err).values())
    del p64, ref64, prob, got, ref
    check(all(math.isfinite(v) for v in errs.values()), "non-finite kernel output")
    check(worst <= FP32_TOL, f"fp32 kernel vs plain: {worst:.3e} > {FP32_TOL}")

    # times at the main shape and at cartpole's over a longer horizon
    # and at the nonlinear-rollout phase's shapes, float64: the cartpole with
    # RK2 (E = -I) and with the implicit midpoint rule (general E)
    times = {"se2car": k1_timing(main, T, B),
             "cartpole": k1_timing((4, 1, 1, True), 2 * NSTEPS + 1, B),
             "cartpole_rk2_fp64": k1_timing((4, 1, 1, True), 101, CART_BATCH,
                                            torch.float64),
             "cartpole_midpoint_fp64": k1_timing((4, 1, 1, False), CART_MIDPOINT_NSTEPS + 1,
                                                 CART_VARIANT_BATCH, torch.float64),
             "acrobot_fp64": k1_timing((4, 1, 1, False), FREE_NSTEPS["acrobot"] + 1,
                                       FREE_BATCHES["acrobot"], torch.float64)}
    # the MPC phase's SE(2) shape at its batches (the wheeled inverted
    # pendulum's, (4, 1, 1, E = -I) fp64 at 1024 and T = 101, is the
    # cartpole's above)
    for b in MPC_PATHS["se2"]:
        times[f"se2_mpc_B{b}"] = k1_timing(main, T, b)
    t = times["se2car"]
    return dict(
        name="fused_riccati", route="cuda",
        source="aligator_tpu_torch/csrc/fused_riccati.cu",
        replaces="aligator_tpu/gar/pallas_riccati.py:171",
        max_abs_err=max_abs, ms=t["kernel_ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
    ), times


def _to64(res):
    return (*(t.double() for t in res[:4]), {k: v.double() for k, v in res[4].items()})


def _compare(got, ref, err=rel_err):
    names = ("xs", "us", "vs", "lams")
    errs = {n: err(g, r) for n, g, r in zip(names, got[:4], ref[:4])}
    errs.update({k: err(got[4][k], ref[4][k]) for k in ref[4]})
    return errs


def avg_time_ms(fn, reps):
    """Mean device time per call of ``fn`` over ``reps`` back-to-back calls,
    CUDA events (host overhead shows where it starves the device)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps, kernel_name):
    """Device time per launch of the CUDA kernel named ``kernel_name`` over
    ``reps`` calls of ``fn`` (torch.profiler): the kernel alone, without
    the wrapper's host time, averaged over the launches the profiler
    recorded. The profiler's activity buffer can drop a record now and
    then, so up to a tenth of the launches may be missing; more than
    ``reps`` means the name matched another kernel. Falls back to CUDA
    events over the whole call if the profiler records no device time
    for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and kernel_name in ev.key:
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            total_us += dev_us
            count += ev.count
    if count == 0 or total_us == 0:
        print(f"[kernel] profiler saw no {kernel_name}: timing whole calls")
        return avg_time_ms(fn, reps)
    check(count <= reps, f"{kernel_name}: {count} launches profiled, {reps} made")
    if count < reps - max(1, reps // 10):
        print(f"[kernel] {kernel_name}: the profiler recorded {count} of {reps} launches, "
              "too few to trust: timing whole calls")
        return avg_time_ms(fn, reps)
    if count < reps:
        print(f"[kernel] {kernel_name}: the profiler recorded {count} of {reps} "
              "launches; time averaged over those")
    return total_us / count / 1e3


def bound(nbytes, flops, fp64=False):
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = flops / (H100_FP64_FLOP_PER_S if fp64 else H100_FP32_FLOP_PER_S) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def spd_batch(M, n, r, dtype, seed):
    """SPD systems A = G G'/n + I and right-hand sides, drawn on the card."""
    g = _gen(seed)
    G = torch.randn((M, n, n), generator=g, device="cuda", dtype=torch.float64)
    A = G @ G.mT / n + torch.eye(n, device="cuda", dtype=torch.float64)
    R = torch.randn((M, n, r), generator=g, device="cuda", dtype=torch.float64)
    return A.to(dtype), R.to(dtype)


def convex_knots(B, N, nx, nu, nc, dtype, seed):
    """Random convex LQ knots with the law of
    ``lqr_problem.random_convex_problem`` (E = -I), drawn on the card (the
    main shapes are too large to draw on the host quickly), plus a random
    SPD terminal value and per-scenario mu (mu_eq log-uniform in [1e-3,
    1e-1], mu_dyn = 1e-3 mu_eq as the solver scales it)."""
    from aligator_tpu_torch.gar.lqr_problem import LQRKnots

    g = _gen(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float64)

    T, n = N + 1, nx + nu
    root = randn(B, T, n, n + 2)
    joint = root @ root.mT / (n + 2)
    del root
    eye = torch.eye(nx, device="cuda", dtype=torch.float64)
    a = dict(
        Q=joint[..., :nx, :nx], S=joint[..., :nx, nx:],
        R=joint[..., nx:, nx:] + 0.1 * torch.eye(nu, device="cuda", dtype=torch.float64),
        q=randn(B, T, nx), r=randn(B, T, nu), A=randn(B, T, nx, nx) / math.sqrt(nx),
        B=randn(B, T, nx, nu) / math.sqrt(nu), E=-eye.expand(B, T, nx, nx),
        f=0.1 * randn(B, T, nx), C=randn(B, T, nc, nx), D=randn(B, T, nc, nu),
        d=randn(B, T, nc),
    )
    kn = LQRKnots(**{k: v.to(dtype).contiguous() for k, v in a.items()})
    del a, joint
    G = randn(B, nx, nx)
    P = (G @ G.mT / nx + eye).to(dtype)
    p = randn(B, nx).to(dtype)
    mue = 10 ** (torch.rand(B, generator=g, device="cuda", dtype=torch.float64) * 2 - 3)
    return kn, P, p, (1e-3 * mue).to(dtype), mue.to(dtype)


def k1_problem(B, T, nx, nu, nc, explicit, dtype, seed):
    """B random LQ problems over T knots with the law of
    ``lqr_problem.random_convex_problem`` (E = -I, or -I + 0.1 N(0, 1)
    unless ``explicit``; G0 = I), drawn on the card, and per-scenario mu_dyn
    and mu_eq log-uniform in [1e-4, 1e-1]."""
    from aligator_tpu_torch.gar.lqr_problem import LQRProblem

    kn = convex_knots(B, T - 1, nx, nu, nc, torch.float64, seed)[0]
    g = _gen(seed + 1)
    if not explicit:
        kn.E = kn.E + 0.1 * torch.randn(kn.E.shape, generator=g, device="cuda",
                                        dtype=torch.float64)
    kn.R[:, -1] = torch.eye(nu, device="cuda", dtype=torch.float64)
    for k in ("S", "r", "D", "A", "B", "E", "f"):
        getattr(kn, k)[:, -1] = 0.0
    kn = kn.map(lambda t: t.to(dtype))
    G0 = torch.eye(nx, dtype=dtype, device="cuda").expand(B, nx, nx).contiguous()
    g0 = torch.randn((B, nx), generator=g, device="cuda", dtype=torch.float64).to(dtype)
    mus = 10 ** (3 * torch.rand((2, B), generator=g, device="cuda",
                                dtype=torch.float64) - 4)
    return LQRProblem(knots=kn, G0=G0, g0=g0), mus[0].to(dtype), mus[1].to(dtype)


def k2_phase():
    from aligator_tpu_torch.gar import spd_solve as sp

    # the register routes (4 x 4 and 4 x 8 tiles) and, past 256 tiles, the
    # memory routes: shared memory ((64, 65), (64, 128), (96, 97)), and the
    # global workspace past it ((200, 201) and (320, 321) in fp64)
    for i, (n, r) in enumerate(((12, 1), (24, 13), (56, 57), (22, 57), (64, 64),
                                (28, 84), (12, 84), (64, 65), (64, 128), (96, 97),
                                (200, 201), (320, 321))):
        A, R = spd_batch(130, n, r, torch.float64, SEED + i)
        err = rel_err(sp.spd_solve(A, R), sp.spd_solve_plain(A, R))
        print(f"[kernel] spd_solve fp64 M=130 n={n} r={r}: max rel err {err:.3e} "
              f"(tol {FP64_TOL:g})")
        check(err <= FP64_TOL, f"spd_solve fp64 n={n} r={r}: {err}")

    # every shape the paths launch: the per-stage loop's Schur solve and
    # reduced KKT (n = 56 and 22, r = 57) at the LQR-56 and walk-256 batch
    # and at the walk's batch 16; the contact-KKT pair (mass matrix n = 28,
    # Delassus n = 12, r = 3 nv = 84) at K = B N for both walk batches
    n_walk = 2 * TALOS_T_SS + 3 * TALOS_T_DS
    f32, f64 = torch.float32, torch.float64
    shapes = [("LQ loop", M, n, 57, f32) for M in (LQR_BATCH, TALOS_BATCHES[0])
              for n in (56, 22)]
    shapes += [("contact KKT", b * n_walk, n, 84, f32) for b in TALOS_BATCHES
               for n in (28, 12)]
    # the parallel-in-time phase: the legs' θ sweeps (Schur n = nx and
    # reduced KKT n = nu against nx + 1 + nth columns; one leg and three in a
    # group at humanoid dims, one and seven at the latency shape), the
    # associative leaves' R̄ solve (nu against 2 nx + 1) and its gain
    # recovery (nx against nx + 1, nu against nx + 1)
    h, (lx, lu, _) = HUMANOID_BATCH, LAT_DIMS
    shapes += [("θ sweep", M, n, 73, f32) for M in (h, 3 * h) for n in (36, 12)]
    shapes += [("θ sweep", M, n, 2 * lx + 1, f32) for M in (1024, 7 * 1024)
               for n in (lx, lu)]
    M_lqr = ASSOC_BATCH * ASSOC_NSTEPS
    shapes += [("assoc leaves", M_lqr, 1, 5, f64), ("assoc gains", M_lqr, 2, 3, f64),
               ("assoc gains", M_lqr, 1, 3, f64)]
    M_lat = LAT_BATCHES[-1] * LAT_N
    shapes += [("assoc leaves", M_lat, lu, 2 * lx + 1, f32),
               ("assoc gains", M_lat, lx, lx + 1, f32),
               ("assoc gains", M_lat, lu, lx + 1, f32)]
    # gar.diff.solve's per-stage loop at the inverse-LQR shape (Schur n =
    # nx = 4, reduced KKT n = nu = 2, each against nx + 1 = 5 columns) at 16
    # and 4096 demonstrations; the θ backward of the sensitivities (n = 2
    # and 1 against nx + 1 + nth = 5 columns) at 4096 scenarios, whose n = 2
    # solve has the inverse LQR's shape at 4096
    shapes += [("inverse LQR", M, n, 5, f64) for M in INV_DEMOS for n in (4, 2)]
    shapes += [("θ harvest", SENS_BATCH, 1, 5, f64)]
    # the free-dynamics reaches' per-stage loops (Schur n = ndx and reduced
    # KKT n = nu, each against ndx + 1 columns): the UR5 at 1024, the FFSR
    # at 256
    shapes += [("UR5 loop", FREE_BATCHES["ur5"], n, 13, f64) for n in (12, 6)]
    shapes += [("FFSR loop", FREE_BATCHES["ffsr"], n, 41, f64) for n in (40, 14)]
    # the contact paths (fp64): the UR10 throw's loop-constraint KKT at K =
    # B N (mass matrix n = nv = 12 against [Jcᵀ | τ − b], r = 7, and its
    # implicit tangents folded into r = 7 x 30 directions; Delassus n = 6
    # against 1 and 30), its per-stage loop (n = ndx 24 and nu 6, r = 25);
    # the Solo jump's contact-KKT derivative solves at K = B N (n = nv = 14
    # and nc = 12 against 3 nv = 42) and its per-stage loop (n = 28 and 8, r
    # = 29)
    K_ur, K_solo = UR10_BATCH * UR10_NSTEPS, SOLO_BATCH * sum(SOLO_PHASES)
    ntan = 2 * 12 + 6
    shapes += [("UR10 loop KKT", K_ur, 12, 7, f64), ("UR10 loop KKT", K_ur, 6, 1, f64),
               ("UR10 KKT tangents", K_ur, 12, 7 * ntan, f64),
               ("UR10 KKT tangents", K_ur, 6, ntan, f64)]
    shapes += [("UR10 LQ loop", UR10_BATCH, n, 25, f64) for n in (24, 6)]
    shapes += [("Solo contact KKT", K_solo, n, 42, f64) for n in (14, 12)]
    shapes += [("Solo LQ loop", SOLO_BATCH, n, 29, f64) for n in (28, 8)]
    # the centroidal gait's per-stage loop (fp64, Schur n = ndx = 9 and
    # reduced KKT n = nu = 12, each against ndx + 1 = 10 columns) at its
    # batch; the memory routes past n = 64, where the JAX package solves in
    # XLA (shared memory at n = 96, the global workspace at 200 and 320)
    shapes += [("centroidal loop", CENTROIDAL_BATCHES["centroidal"], n, 10, f64)
               for n in (9, 12)]
    shapes += [("large n", 64, n, n + 1, f64) for n in (96, 200, 320)]
    # the reach on the Panda read from MJCF: its per-stage loop (n = ndx 14
    # and nu 7, against ndx + 1 = 15 columns) at its batch
    shapes += [("Panda loop", PANDA_BATCH, n, 15, f64) for n in (14, 7)]
    by_shape = {}
    for i, (what, M, n, r, dtype) in enumerate(shapes):
        A, R = spd_batch(M, n, r, dtype, SEED + 10 + i)
        X = sp.spd_solve(A, R)
        ref = sp.spd_solve_plain(A, R)
        ref64 = sp.spd_solve_plain(A.double(), R.double())
        torch.cuda.synchronize()
        err = rel_err(X, ref)
        tol = K2_FP32_TOL if dtype == f32 else FP64_TOL
        check(torch.isfinite(X).all().item(), "non-finite spd_solve output")
        check(err <= tol, f"spd_solve {dtype} M={M} n={n} r={r}: {err}")
        reps = 10 if n > 64 else 200 if M <= 512 else 50
        ms = kernel_ms(lambda: sp.launch(A, R), reps, "spd_solve_kernel")
        call_ms = avg_time_ms(lambda: sp.spd_solve(A, R), reps)
        plain_ms = avg_time_ms(lambda: sp.spd_solve_plain(A, R), 20)
        lib_ms = avg_time_ms(lambda: torch.linalg.solve(A, R), 20)
        # A's lower triangle, R, X
        nbytes = A.element_size() * M * (n * (n + 1) // 2 + 2 * n * r)
        flops = M * (n ** 3 / 3 + 2 * n * n * r)
        bms, by = bound(nbytes, flops, fp64=dtype == f64)
        print(f"[kernel] spd_solve {str(dtype)[6:]} {what} M={M} n={n} r={r}: vs plain "
              f"{err:.2e} (tol {tol:g}), vs fp64 plain: kernel "
              f"{rel_err(X.double(), ref64):.2e}, plain {rel_err(ref.double(), ref64):.2e}; "
              f"kernel {ms:.4f} ms (wrapper call {call_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, torch.linalg.solve {lib_ms:.4f} ms; bound "
              f"{bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP; "
              f"kernel {ms / bms:.1f}x)")
        by_shape[f"M={M} n={n} r={r}"] = dict(
            ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
            bound_by=by, nbytes=nbytes, flops=flops, max_abs_err=abs_err(X, ref))
        del A, R, X, ref, ref64

    spd_solve_diff_check(sp)
    spd_solve_conditioning_check(sp)
    fp32_cond = spd_solve_fp32_conditioning_check(sp)

    # the kernel line: one stage of the LQR-56 loop, both solves
    pair = [by_shape[f"M={LQR_BATCH} n={n} r=57"] for n in (56, 22)]
    tot = {k: sum(p[k] for p in pair)
           for k in ("ms", "call_ms", "plain_ms", "library_ms", "nbytes", "flops")}
    bms, by = bound(tot["nbytes"], tot["flops"])
    print(f"[kernel] spd_solve, one LQR-56 stage (both solves): kernel "
          f"{tot['ms']:.4f} ms, bound {bms:.4f} ms ({by})")
    return dict(
        name="spd_solve", route="cuda", source="aligator_tpu_torch/csrc/spd_solve.cu",
        replaces="aligator_tpu/gar/pallas_spd.py:33",
        max_abs_err=max(v["max_abs_err"] for v in by_shape.values()),
        ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bms, bound_by=by,
        library_ms=tot["library_ms"],
    ), dict(wrapper_call_ms=tot["call_ms"], by_shape=by_shape, fp32_conditioning=fp32_cond)


def spd_solve_conditioning_check(sp):
    """K2 in fp64 on nearly singular SPD systems (eigenvalues log-spaced
    from 1 down to 1e-10, the conditioning of a Delassus matrix of
    redundant contacts at μ = 1e-8), at the Solo's Delassus shape (n = 12,
    r = 42): its backward error max |A X − R| / (max |A| max |X|) beside
    the plain Cholesky solve's, held to 1e-12 (block Gauss-Jordan reached
    ~1e-6 relative in X there, a block LU elimination 4.7e-14)."""
    M, n, r = 4096, 12, 42
    A, R = conditioned_spd(M, n, r, 1e-10, SEED + 92)

    def backward_err(X):
        res = (A @ X - R).abs().flatten(1).amax(1)
        return (res / (A.abs().flatten(1).amax(1) * X.abs().flatten(1).amax(1))).max().item()

    X, Xp = sp.spd_solve(A, R), sp.spd_solve_plain(A, R)
    torch.cuda.synchronize()
    e, ep = backward_err(X), backward_err(Xp)
    print(f"[kernel] spd_solve fp64 M={M} n={n} r={r}, condition 1e10: backward error "
          f"kernel {e:.2e}, plain (Cholesky) {ep:.2e} (tol 1e-12); forward gap "
          f"{rel_err(X, Xp):.2e}")
    check(e <= 1e-12, f"spd_solve on nearly singular systems: backward error {e}")


def conditioned_spd(M, n, r, lam_min, seed):
    """SPD systems with eigenvalues log-spaced from 1 down to ``lam_min``
    (condition 1 / lam_min) in random orthogonal bases, and right-hand
    sides, float64, drawn on the card."""
    g = _gen(seed)
    Q = torch.linalg.qr(torch.randn((M, n, n), generator=g, device="cuda",
                                    dtype=torch.float64))[0]
    lam = torch.logspace(0, math.log10(lam_min), n, device="cuda", dtype=torch.float64)
    A = (Q * lam) @ Q.mT
    R = torch.randn((M, n, r), generator=g, device="cuda", dtype=torch.float64)
    return 0.5 * (A + A.mT), R


def spd_backward_errors(A, X, R):
    """Per system, in float64: max|A X − R| / (max|A| max|X| + max|R|)."""
    A, X, R = A.double(), X.double(), R.double()

    def nrm(t):
        return t.abs().flatten(1).amax(1)

    return nrm(A @ X - R) / (nrm(A) * nrm(X) + nrm(R))


# K2 in fp32 on nearly singular systems (condition 1e5): (M, n, r) of the
# LQR-56 per-stage loop (n = 56 on 4 x 8 register tiles, n = 22 on 4 x 4),
# the Delassus shape on the register route and the shared-memory route
K2_FP32_COND_SHAPES = ((256, 56, 57), (256, 22, 57), (4096, 12, 42), (256, 64, 65))
STABILITY_FACTOR = 10  # the kernels' backward error or gap against the plain version's


def spd_solve_fp32_conditioning_check(sp):
    """K2 in fp32 on systems of condition 1e5 (eigenvalues log-spaced from
    1 down to 1e-5) at K2_FP32_COND_SHAPES: the largest backward error of
    its solutions beside the plain Cholesky solve's on the same systems,
    held to STABILITY_FACTOR times it."""
    out = {}
    for i, (M, n, r) in enumerate(K2_FP32_COND_SHAPES):
        A, R = conditioned_spd(M, n, r, 1e-5, SEED + 94 + i)
        A, R = A.float(), R.float()
        X, Xp = sp.spd_solve(A, R), sp.spd_solve_plain(A, R)
        check(bool(torch.isfinite(X).all()) and bool(torch.isfinite(Xp).all()),
              f"spd_solve fp32 ({M}, {n}, {r}) at condition 1e5: a failed factorization")
        e = spd_backward_errors(A, X, R).max().item()
        ep = spd_backward_errors(A, Xp, R).max().item()
        print(f"[kernel] spd_solve fp32 M={M} n={n} r={r}, condition 1e5: backward error "
              f"kernel {e:.2e}, plain (Cholesky) {ep:.2e} (ratio {e / ep:.2f}, tol "
              f"{STABILITY_FACTOR}x)")
        out[f"{M}x{n}x{r}"] = dict(kernel=e, plain=ep)
        check(e <= STABILITY_FACTOR * ep,
              f"spd_solve fp32 ({M}, {n}, {r}): backward error {e} against {ep}")
    return out


# K3 at small mu: the humanoid shape, 4 of its 12 controls seen by neither
# the dynamics nor the constraints, the controls in a random orthogonal
# basis (its reduced KKT matrix has eigenvalues of order 1/mu beside ones of
# order 1, condition ~4e5 and ~4e6 in fp32, ~4e9 in fp64, the near-null
# directions mixed into every pivot block; at mu = 1e-6 the fp32 system,
# condition ~4e7, is past what fp32 factors: the plain Cholesky fails on
# nearly every scenario. The Schur matrix I + mu P has every eigenvalue >= 1
# and stays well conditioned)
K3_COND_CASES = ((torch.float32, 1e-4), (torch.float32, 1e-5), (torch.float64, 1e-8))
K3_COND_DIMS = (256, 16, 36, 12, 12)  # B, N, nx, nu, nc


def k3_conditioning_check(fs):
    """K3 on nearly singular reduced KKT systems (K3_COND_CASES), mu_dyn =
    mu_eq = mu: the largest backward errors of each stage's Schur and KKT
    solves (:func:`fused_stage.stage_backward_errors`) beside the plain
    sweep's (Cholesky) in the same precision, held to STABILITY_FACTOR
    times them; in fp32 also the gap of its factors to the fp64 plain
    sweep beside the fp32 plain sweep's gap, held likewise."""
    from aligator_tpu_torch.gar import lqr_problem

    B, N, nx, nu, nc = K3_COND_DIMS
    out = {}
    for dtype, mu in K3_COND_CASES:
        kn = lqr_problem.random_convex_problem(
            np.random.default_rng(SEED + 97), B, N, nx, nu, nc, dtype=dtype,
            device="cuda", null_controls=4).knots
        P, p = kn.Q[:, N].contiguous(), kn.q[:, N].contiguous()
        m = torch.full((B,), mu, dtype=dtype, device="cuda")
        got = fs.sweep(kn, P, p, m, m)
        ref = fs.sweep_plain(kn, P, p, m, m)
        eb = fs.stage_backward_errors(kn, P, p, m, m, got)
        ebp = fs.stage_backward_errors(kn, P, p, m, m, ref)
        check(all(bool(torch.isfinite(v).all()) for v in (*got.values(), *ref.values())),
              f"fused_stage sweep {dtype} mu={mu:g}: non-finite factors")
        tag = "fp32" if dtype == torch.float32 else "fp64"
        row = {k: dict(kernel=eb[k].max().item(), plain=ebp[k].max().item())
               for k in ("schur", "kkt")}
        line = ", ".join(f"{k} kernel {v['kernel']:.2e} plain {v['plain']:.2e}"
                         for k, v in row.items())
        if dtype == torch.float32:
            ref64 = fs.sweep_plain(kn.map(torch.Tensor.double), P.double(), p.double(),
                                   m.double(), m.double())
            row["gap"] = dict(
                kernel=max(rel_err(got[k].double(), ref64[k]) for k in fs.FACTOR_FIELDS),
                plain=max(rel_err(ref[k].double(), ref64[k]) for k in fs.FACTOR_FIELDS))
            line += (f"; gap to the fp64 plain sweep kernel {row['gap']['kernel']:.2e} "
                     f"plain {row['gap']['plain']:.2e}")
        else:
            row["gap"] = dict(kernel=max(rel_err(got[k], ref[k]) for k in fs.FACTOR_FIELDS),
                              plain=0.0)
            line += f"; gap to the plain sweep {row['gap']['kernel']:.2e}"
        print(f"[kernel] fused_stage sweep {tag} mu={mu:g} (B,N,nx,nu,nc)={K3_COND_DIMS}, "
              f"4 null controls: backward error {line} (tol {STABILITY_FACTOR}x)")
        out[f"{tag}_mu{mu:g}"] = row
    for case, row in out.items():
        for k in ("schur", "kkt") + (("gap",) if case.startswith("fp32") else ()):
            check(row[k]["kernel"] <= STABILITY_FACTOR * row[k]["plain"],
                  f"fused_stage sweep {case} {k}: {row[k]}")
    return out


def spd_solve_diff_check(sp):
    """The differentiable SPD solve on the card at the UR10 loop KKT's
    shape (K = 512, n = 12, r = 7): its forward, its forward-mode tangents
    under ``jacfwd`` (30 directions folded into one launch) and its
    reverse mode each one K2 launch, against ``torch.func`` through the
    plain Cholesky solve on the same card."""
    from aligator_tpu_torch import _build
    from aligator_tpu_torch._linalg import chol_solve

    A, R = spd_batch(512, 12, 7, torch.float64, SEED + 90)
    P = torch.linalg.cholesky(A)
    d = torch.randn((30, 12, 12), generator=_gen(SEED + 91), device="cuda",
                    dtype=torch.float64)

    def f(solve):
        # A(z) = (P + Σ z_i d_i)(P + Σ z_i d_i)ᵀ, R(z) = R (1 + Σ z_i): one
        # tangent basis shared by every system
        def fn(z):
            L = P + torch.einsum("i,ijk->jk", z, d)
            return solve(L @ L.mT, R * (1 + z.sum()))
        return fn

    z = torch.zeros(30, device="cuda", dtype=torch.float64)
    before = _build.LAUNCHES["spd_solve"]
    J = torch.func.jacfwd(f(sp.spd_solve_diff))(z)
    fwd_launches = _build.LAUNCHES["spd_solve"] - before
    J_ref = torch.func.jacfwd(f(chol_solve))(z)
    Pg, Rg = P.clone().requires_grad_(), R.clone().requires_grad_()
    before = _build.LAUNCHES["spd_solve"]
    g = torch.autograd.grad(sp.spd_solve_diff(Pg @ Pg.mT, Rg).sin().sum(), (Pg, Rg))
    rev_launches = _build.LAUNCHES["spd_solve"] - before
    Pg, Rg = P.clone().requires_grad_(), R.clone().requires_grad_()
    g_ref = torch.autograd.grad(chol_solve(Pg @ Pg.mT, Rg).sin().sum(), (Pg, Rg))
    torch.cuda.synchronize()
    err = max([rel_err(J, J_ref)] + [rel_err(a, b) for a, b in zip(g, g_ref)])
    print(f"[kernel] spd_solve_diff fp64 K=512 n=12 r=7: jacfwd over 30 directions "
          f"{fwd_launches} launches (forward and the folded tangents), reverse mode "
          f"{rev_launches} (forward and the adjoint solve); vs torch.func through the "
          f"Cholesky solve {err:.2e} (tol {FP64_TOL:g})")
    check(fwd_launches == 2 and rev_launches == 2, "spd_solve_diff launches")
    check(err <= FP64_TOL, f"spd_solve_diff: {err}")


def k3_flops_per_stage(n, m, c):
    """Flops of one K3 stage per scenario, counted from the kernel's loops
    (a multiply-add is 2)."""
    n1 = n + 1
    return (n ** 3 / 3 + 2 * n * n * n1  # Schur factor and solve
            + 2 * n * n * n1 + 2 * n * m * n1  # [A'V | A'vx], [B'V | B'vx]
            + 2 * n ** 3 + 2 * n * n * m  # Qhat, Shat
            + 2 * m * m * (n + c) + 2 * m * n * (n + c + 1)  # reduced KKT
            + m ** 3 / 3 + 2 * m * m * n1  # its factor and solve
            + 2 * c * m * n1 + 2 * n * m * n1 + 2 * n * n * n1  # Z, panels
            + 2 * n * n1 * (m + c)  # value update
            + 2 * n ** 3 + 6 * n * n)  # L, Afb, lff, yff


def k3_phase():
    from aligator_tpu_torch.gar import fused_stage as fs

    for i, (N, nx, nu, nc) in enumerate(((6, 13, 4, 3), (4, 16, 5, 0),
                                         (5, 36, 12, 12), (3, 44, 20, 0))):
        kn, P, p, md, me = convex_knots(100, N, nx, nu, nc, torch.float64, SEED + i)
        got = fs.sweep(kn, P, p, md, me)
        ref = fs.sweep_plain(kn, P, p, md, me)
        err = max(rel_err(got[k], ref[k]) for k in fs.FACTOR_FIELDS)
        print(f"[kernel] fused_stage sweep fp64 B=100 (N,nx,nu,nc)={(N, nx, nu, nc)}: "
              f"max rel err {err:.3e} (tol {FP64_TOL:g})")
        check(err <= FP64_TOL, f"fused_stage sweep fp64 {err}")
        one = fs.stage({k: getattr(kn, k)[:, N - 1] for k in fs.STAGE_FIELDS},
                       P, p, md, me)
        err = max(rel_err(one[k], ref[k][:, N - 1]) for k in fs.FACTOR_FIELDS)
        check(err <= FP64_TOL, f"fused_stage stage fp64 {err}")

    conditioning = k3_conditioning_check(fs)

    B, N, nx, nu, nc = HUMANOID_BATCH, MEDIUM_NSTEPS, 36, 12, 12
    kn, P, p, md, me = convex_knots(B, N, nx, nu, nc, torch.float32, SEED + 20)
    got = fs.sweep(kn, P, p, md, me)
    ref = fs.sweep_plain(kn, P, p, md, me)
    torch.cuda.synchronize()
    errs = {k: rel_err(got[k], ref[k]) for k in fs.FACTOR_FIELDS}
    worst = max(errs.values())
    print(f"[kernel] fused_stage sweep fp32 B={B} N={N} (nx,nu,nc)={(nx, nu, nc)}: "
          f"vs plain {worst:.2e} ({max(errs, key=errs.get)}; tol {K3_FP32_TOL:g})")
    kn64 = kn.map(torch.Tensor.double)
    ref64 = fs.sweep_plain(kn64, P.double(), p.double(), md.double(), me.double())
    for name, res in (("kernel", got), ("plain", ref)):
        e = max(rel_err(res[k].double(), ref64[k]) for k in fs.FACTOR_FIELDS)
        print(f"[kernel] fused_stage sweep fp32 {name} vs fp64 plain: {e:.2e}")
    del kn64, ref64
    check(all(torch.isfinite(v).all().item() for v in got.values()),
          "non-finite fused_stage output")
    check(worst <= K3_FP32_TOL, f"fused_stage sweep fp32 {worst}")
    max_abs = max(abs_err(got[k], ref[k]) for k in fs.FACTOR_FIELDS)
    del got, ref

    info = fs.kernel_info("sweep", torch.float32, B, N + 1, nx, nu, nc)
    print(f"[kernel] fused_stage sweep fp32 (nx,nu,nc)={(nx, nu, nc)}: "
          f"{info['smem_bytes']} B of shared memory and {info['threads']} threads a "
          f"block, {info['registers']} registers a thread, {info['blocks_per_sm']} "
          f"resident blocks per SM")

    def sweep_bound(Bs):
        stage_words = (2 * nx * nx + 2 * nx * nu + nu * nu + 2 * nx + nu
                       + nc * (nx + nu + 1))
        factor_words = (nu * (nx + 1) + nc * (nx + 1) + 2 * nx + 3 * nx * nx + nx)
        nbytes = 4 * Bs * (N * (stage_words + factor_words) + nx * nx + nx + 2)
        flops = Bs * N * k3_flops_per_stage(nx, nu, nc)
        return nbytes, flops, *bound(nbytes, flops)

    # by batch: 1, 2, 4 and 7.8 blocks for each of the 132 SMs
    by_batch = {}
    for Bs in (132, 264, 528, B):
        sub = kn.map(lambda t: t[:Bs])
        args = (sub, P[:Bs], p[:Bs], md[:Bs], me[:Bs])
        ms_b = kernel_ms(lambda: fs.sweep(*args), 5, "sweep_kernel")
        bms_b = sweep_bound(Bs)[2]
        by_batch[Bs] = dict(ms=ms_b, bound_ms=bms_b)
        print(f"[kernel] fused_stage sweep fp32 B={Bs} N={N}: kernel {ms_b:.4f} ms "
              f"({ms_b / N * 1e3:.2f} us per stage), bound {bms_b:.4f} ms "
              f"({ms_b / bms_b:.1f}x)")
    # the centroidal paths' shapes, fp64 at 256: the continuous gait (N =
    # 210, (21, 12), nc = 41) and the kinodynamics (N = 64, (25, 20), nc = 20)
    centroidal = {}
    for (Bc, Nc, nxc, nuc, ncc) in ((CENTROIDAL_BATCHES["continuous"], 210, 21, 12, 41),
                                    (CENTROIDAL_BATCHES["kinodynamics"], 64, 25, 20, 20)):
        knc, Pc, pc, mdc, mec = convex_knots(Bc, Nc, nxc, nuc, ncc, torch.float64,
                                             SEED + 30 + nxc)
        gotc = fs.sweep(knc, Pc, pc, mdc, mec)
        refc = fs.sweep_plain(knc, Pc, pc, mdc, mec)
        errc = max(rel_err(gotc[k], refc[k]) for k in fs.FACTOR_FIELDS)
        check(errc <= FP64_TOL, f"fused_stage sweep nx={nxc}: {errc}")
        msc = kernel_ms(lambda: fs.sweep(knc, Pc, pc, mdc, mec), 5, "sweep_kernel")
        plainc = avg_time_ms(lambda: fs.sweep_plain(knc, Pc, pc, mdc, mec), 1)
        sw = (2 * nxc * nxc + 2 * nxc * nuc + nuc * nuc + 2 * nxc + nuc
              + ncc * (nxc + nuc + 1))
        fw = (nuc * (nxc + 1) + ncc * (nxc + 1) + 2 * nxc + 3 * nxc * nxc + nxc)
        nbc = 8 * Bc * (Nc * (sw + fw) + nxc * nxc + nxc + 2)
        flc = Bc * Nc * k3_flops_per_stage(nxc, nuc, ncc)
        bmc, byc = bound(nbc, flc, fp64=True)
        print(f"[kernel] fused_stage sweep fp64 B={Bc} N={Nc} (nx,nu,nc)={(nxc, nuc, ncc)}: "
              f"vs plain {errc:.2e} (tol {FP64_TOL:g}); kernel {msc:.4f} ms, plain "
              f"{plainc:.3f} ms; bound {bmc:.4f} ms ({byc}; kernel {msc / bmc:.1f}x)")
        centroidal[f"B={Bc} nx={nxc}"] = dict(ms=msc, plain_ms=plainc, bound_ms=bmc,
                                              bound_by=byc, err=errc)
        del knc, gotc, refc
    ms = by_batch[B]["ms"]
    plain_ms = avg_time_ms(lambda: fs.sweep_plain(kn, P, p, md, me), 2)
    nbytes, flops, bms, by = sweep_bound(B)
    print(f"[kernel] fused_stage sweep fp32 B={B} N={N}: kernel {ms:.4f} ms "
          f"({ms / N * 1e3:.2f} us per stage), plain {plain_ms:.3f} ms; bound "
          f"{bms:.4f} ms ({by}: {nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP)")
    return dict(
        name="fused_stage_sweep", route="cuda",
        source="aligator_tpu_torch/csrc/fused_stage.cu",
        replaces="aligator_tpu/gar/pallas_stage.py:140", max_abs_err=max_abs,
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
    ), dict(occupancy=info, by_batch=by_batch, conditioning=conditioning,
            centroidal=centroidal)


def random_gains(B, T, nx, nu, nc, dtype, seed):
    g = _gen(seed)
    shapes = dict(kff=(nu,), K=(nu, nx), zff=(nc,), Z=(nc, nx), lff=(nx,),
                  L=(nx, nx), yff=(nx,), Afb=(nx, nx))
    gains = {k: (torch.randn((B, T) + s, generator=g, device="cuda",
                             dtype=torch.float64) / math.sqrt(nx)).to(dtype)
             for k, s in shapes.items()}
    x0 = torch.randn((B, nx), generator=g, device="cuda", dtype=torch.float64)
    lam0 = torch.randn((B, nx), generator=g, device="cuda", dtype=torch.float64)
    return gains, x0.to(dtype), lam0.to(dtype)


def k4_phase():
    from aligator_tpu_torch.gar import fused_stage as fs

    # the test shapes, fp64: 13 gives slices that are not 16-byte aligned,
    # (56, 22, 22) is the walk's, 160 a stage larger than the ring
    for i, (nx, nu, nc) in enumerate(((13, 4, 3), (13, 4, 0), (36, 12, 12), (56, 22, 0),
                                      (56, 22, 22), (160, 7, 2))):
        gains, x0, lam0 = random_gains(100, 11, nx, nu, nc, torch.float64, SEED + i)
        err = max(rel_err(a, b) for a, b in zip(fs.forward(gains, x0, lam0),
                                                fs.forward_plain(gains, x0, lam0)))
        print(f"[kernel] fused_stage forward fp64 B=100 T=11 (nx,nu,nc)="
              f"{(nx, nu, nc)}: max rel err {err:.3e} (tol {FP64_TOL:g})")
        check(err <= FP64_TOL, f"fused_stage forward fp64 {err}")

    out = {}
    # the medium-dim paths' shapes in fp32, the free-dynamics reaches' in
    # fp64 (UR5 at 1024, T = 41; FFSR at 256, T = 61) and the contact paths'
    # (UR10 throw at 64, T = 81; Solo jump at 256, T = 29)
    T_med = MEDIUM_NSTEPS + 1
    f32, f64 = torch.float32, torch.float64
    for i, (B, T, nx, nu, nc, dt) in enumerate((
            (HUMANOID_BATCH, T_med, 36, 12, 12, f32), (LQR_BATCH, T_med, 56, 22, 0, f32),
            (FREE_BATCHES["ur5"], FREE_NSTEPS["ur5"] + 1, 12, 6, 6, f64),
            (FREE_BATCHES["ffsr"], FREE_NSTEPS["ffsr"] + 1, 40, 14, 14, f64),
            (UR10_BATCH, UR10_NSTEPS + 1, 24, 6, 12, f64),
            (SOLO_BATCH, sum(SOLO_PHASES) + 1, 28, 8, 0, f64),
            # the continuous gait (T = 211, nc = 41) and the kinodynamics
            # (T = 65, nc = 20) at 256
            (CENTROIDAL_BATCHES["continuous"], 211, 21, 12, 41, f64),
            (CENTROIDAL_BATCHES["kinodynamics"], 65, 25, 20, 20, f64),
            # the reach on the Panda read from MJCF (T = 51, nc = 7 + 2) at 256
            (PANDA_BATCH, PANDA_NSTEPS + 1, 14, 7, 9, f64))):
        gains, x0, lam0 = random_gains(B, T, nx, nu, nc, dt, SEED + 10 + i)
        got = fs.forward(gains, x0, lam0)
        ref = fs.forward_plain(gains, x0, lam0)
        g64 = {k: v.double() for k, v in gains.items()}
        ref64 = fs.forward_plain(g64, x0.double(), lam0.double())
        torch.cuda.synchronize()
        err = max(rel_err(a, b) for a, b in zip(got, ref))
        tol = K4_FP32_TOL if dt == f32 else FP64_TOL
        name = str(dt)[6:]
        print(f"[kernel] fused_stage forward {name} B={B} T={T} (nx,nu,nc)={(nx, nu, nc)}: "
              f"vs plain {err:.2e} (tol {tol:g}); vs fp64 plain: kernel "
              f"{max(rel_err(a.double(), b) for a, b in zip(got, ref64)):.2e}, plain "
              f"{max(rel_err(a.double(), b) for a, b in zip(ref, ref64)):.2e}")
        check(all(torch.isfinite(t).all().item() for t in got), "non-finite forward")
        check(err <= tol, f"fused_stage forward {name} {err}")
        info = fs.kernel_info("forward", dt, B, T, nx, nu, nc)
        print(f"[kernel] fused_stage forward {name} B={B} (nx,nu,nc)={(nx, nu, nc)}: "
              f"{info['smem_bytes']} B of shared memory and {info['threads']} threads a "
              f"block, {info['registers']} registers a thread, {info['blocks_per_sm']} "
              f"resident blocks per SM")
        ms = kernel_ms(lambda: fs.forward(gains, x0, lam0), 20, "forward_kernel")
        plain_ms = avg_time_ms(lambda: fs.forward_plain(gains, x0, lam0), 3)
        # the library yardstick: one stage as one batched GEMM plus bias over
        # the stacked [K; Z; L; Afb], times the T stages
        W = torch.cat([gains["K"][:, 0], gains["Z"][:, 0], gains["L"][:, 0],
                       gains["Afb"][:, 0]], 1)
        bias = torch.cat([gains[k][:, 0] for k in ("kff", "zff", "lff", "yff")],
                         1)[..., None]
        xcol = x0[..., None]
        stage_lib_ms = avg_time_ms(lambda: torch.baddbmm(bias, W, xcol), 200)
        rows_t, rows_dyn = nu + nc, 2 * nx
        nbytes = x0.element_size() * B * (T * rows_t * (nx + 1) + (T - 1) * rows_dyn * (nx + 1)
                                          + 2 * nx + T * (2 * nx + nu + nc))
        flops = 2 * B * nx * (T * rows_t + (T - 1) * rows_dyn)
        bms, by = bound(nbytes, flops, fp64=dt == f64)
        print(f"[kernel] fused_stage forward {name} B={B} T={T}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, baddbmm {stage_lib_ms:.4f} ms per stage "
              f"({T * stage_lib_ms:.4f} ms for T stages); bound {bms:.4f} ms ({by}: "
              f"{nbytes / 1e9:.4f} GB; kernel {ms / bms:.1f}x)")
        out[(B, nx)] = dict(ms=ms, plain_ms=plain_ms, library_ms=T * stage_lib_ms,
                            bound_ms=bms, bound_by=by, occupancy=info, max_abs_err=max(
                                abs_err(a, b) for a, b in zip(got, ref)))
    main = out[(HUMANOID_BATCH, 36)]
    return dict(
        name="fused_stage_forward", route="cuda",
        source="aligator_tpu_torch/csrc/fused_stage.cu",
        replaces="aligator_tpu/gar/pallas_stage.py:440",
        max_abs_err=max(v["max_abs_err"] for v in out.values()),
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    ), {f"B={B} nx={nx}": {k: v[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "occupancy")}
        for (B, nx), v in out.items()}


def free_fd_flops(model):
    """Flops of the free-dynamics kernel for one state, counted from its
    loops (a multiply-add is 2): per joint the local and world transforms,
    the world inertia, momenta and forces and the 6x6 spatial inertia and
    its subtree sum; per dof its axis, velocity and bias terms and I_c S;
    per related dof pair one 6-term product; the Cholesky factor and its two
    substitutions; with an armature its nv additions to M's diagonal."""
    nj, nv = model.njoints, model.nv
    pairs = 0
    vfirst, nvj = [], []
    i_v = 0
    for t in model.joint_types:
        vfirst.append(i_v)
        nvj.append(6 if t == "freeflyer" else 1)
        i_v += nvj[-1]
    for i in range(nj):
        j = i
        while j >= 0:
            pairs += nvj[i] * nvj[j]
            j = model.parents[j]
    return (nj * (60 + 45 + 30 + 15 + 90 + 60 + 60 + 40 + 108 + 42)
            + nv * (30 + 12 + 36 + 72 + 12) + 12 * pairs
            + nv ** 3 // 3 + 2 * nv * nv + (nv if model.armature is not None else 0))


def free_fd_states(model, B, seed, dtype):
    """B random states of a model on the card: the neutral configuration
    moved by 0.5·N(0, 1) along the tangent, v and tau N(0, 1)."""
    g = _gen(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float64)

    q = model.configuration_space().integrate(model.neutral(torch.float64, "cuda")[None],
                                              0.5 * randn(B, model.nv))
    return q.to(dtype), randn(B, model.nv).to(dtype), randn(B, model.nv).to(dtype)


def free_fd_phase():
    """The free-dynamics kernel against its plain version (model.aba) on
    every robot builder in fp64 (B = 1000, no block size divides it) and on
    the FFSR in fp32, then timed at the free-dynamics paths' shapes (one
    stage of the rollout: the acrobot and the UR5 at 1024, the FFSR at
    256), with an armature (the Panda read from MJCF, the FFSR; B = 256)
    and past the register route."""
    from aligator_tpu_torch.modelling.multibody import free_fd, robots

    names = ("make_pendulum", "make_double_pendulum", "make_ur5", "make_ur10", "make_panda",
             "make_dual_arm_ffsr", "make_free_sphere", "make_ur10_with_payload")
    worst_abs = 0.0
    for i, name in enumerate(names):
        m = getattr(robots, name)(device="cuda")
        q, v, tau = free_fd_states(m, 1000, SEED + 40 + i, torch.float64)
        got, ref = free_fd.free_fd(m, q, v, tau), free_fd.free_fd_plain(m, q, v, tau)
        err = rel_err(got, ref)
        worst_abs = max(worst_abs, abs_err(got, ref))
        print(f"[kernel] free_fd fp64 {name[5:]} (nj={m.njoints}, nv={m.nv}) B=1000: "
              f"max rel err {err:.3e} (tol {FP64_TOL:g})")
        check(err <= FP64_TOL, f"free_fd fp64 {name}: {err}")
    m32 = robots.make_dual_arm_ffsr(dtype=torch.float32, device="cuda")
    q, v, tau = free_fd_states(m32, 1000, SEED + 50, torch.float32)
    got, ref = free_fd.free_fd(m32, q, v, tau), free_fd.free_fd_plain(m32, q, v, tau)
    ref64 = free_fd.free_fd_plain(m32.to(torch.float64), q.double(), v.double(), tau.double())
    err = rel_err(got, ref)
    print(f"[kernel] free_fd fp32 dual_arm_ffsr B=1000: vs plain {err:.2e} (tol "
          f"{FREE_FD_FP32_TOL:g}); vs fp64 plain: kernel {rel_err(got.double(), ref64):.2e}, "
          f"plain {rel_err(ref.double(), ref64):.2e}")
    check(err <= FREE_FD_FP32_TOL, f"free_fd fp32: {err}")

    by_shape = {}
    for case, name in (("acrobot", "make_double_pendulum"), ("ur5", "make_ur5"),
                       ("ffsr", "make_dual_arm_ffsr")):
        B = FREE_BATCHES[case]
        m = getattr(robots, name)(**({"l1": 0.5, "l2": 0.5} if case == "acrobot" else {}),
                                  device="cuda")
        q, v, tau = free_fd_states(m, B, SEED + 60, torch.float64)
        got, ref = free_fd.free_fd(m, q, v, tau), free_fd.free_fd_plain(m, q, v, tau)
        worst_abs = max(worst_abs, abs_err(got, ref))
        ms = kernel_ms(lambda: free_fd.launch(m, q, v, tau), 50, "free_fd_kernel")
        plain_ms = avg_time_ms(lambda: free_fd.free_fd_plain(m, q, v, tau), 20)
        nbytes = 8 * B * (m.nq + 3 * m.nv)
        flops = B * free_fd_flops(m)
        bms, by = bound(nbytes, flops, fp64=True)
        print(f"[kernel] free_fd fp64 {case} B={B} (nj={m.njoints}, nv={m.nv}): vs plain "
              f"{rel_err(got, ref):.2e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
              f"{bms:.5f} ms ({by}: {nbytes / 1e3:.1f} KB, {flops / 1e6:.2f} MFLOP; kernel "
              f"{ms / bms:.0f}x)")
        by_shape[case] = dict(B=B, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                              nbytes=nbytes, flops=flops)
    # with an armature (its section of the model table, added to M's
    # diagonal): the Panda read from MJCF (Menagerie's 0.1 a joint) and the
    # FFSR with the fork's 10 on its 14 arm dofs, at B = 256
    from aligator_tpu_torch.examples import panda_reach

    ffsr = robots.make_dual_arm_ffsr(device="cuda")
    arm = torch.full((ffsr.nv,), 10.0, dtype=torch.float64, device="cuda")
    arm[:6] = 0.0
    for case, m in (("panda_armature", panda_reach.armature_panda(device="cuda")),
                    ("ffsr_armature", dataclasses.replace(ffsr, armature=arm))):
        B = 256
        q, v, tau = free_fd_states(m, B, SEED + 73, torch.float64)
        got, ref = free_fd.free_fd(m, q, v, tau), free_fd.free_fd_plain(m, q, v, tau)
        err = rel_err(got, ref)
        worst_abs = max(worst_abs, abs_err(got, ref))
        moved = rel_err(free_fd.free_fd_plain(dataclasses.replace(m, armature=None), q, v, tau),
                        ref)
        ms = kernel_ms(lambda: free_fd.launch(m, q, v, tau), 50, "free_fd_kernel")
        plain_ms = avg_time_ms(lambda: free_fd.free_fd_plain(m, q, v, tau), 20)
        nbytes = 8 * B * (m.nq + 3 * m.nv)
        flops = B * free_fd_flops(m)
        bms, by = bound(nbytes, flops, fp64=True)
        print(f"[kernel] free_fd fp64 {case} B={B} (nj={m.njoints}, nv={m.nv}, armature "
              f"{m.armature.max().item():g}): vs plain {err:.2e} (tol {FP64_TOL:g}; without "
              f"the armature the result moves by {moved:.1e}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; bound {bms:.5f} ms ({by}; kernel {ms / bms:.0f}x)")
        check(err <= FP64_TOL and moved > 1e-6, f"free_fd {case}: {err}, moved {moved}")
        by_shape[case] = dict(B=B, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                              nbytes=nbytes, flops=flops, err=err)
    # past the register route's 16 joints and 24 dofs: the global workspace
    # (a fixed chain of 40 links; a free-flyer chain of 65 joints, 70 dofs)
    for case, (n_rev, ff) in (("chain40", (40, False)), ("chain65", (64, True))):
        B = 1024
        m = robots.make_chain(n_rev, ff, device="cuda")
        q, v, tau = free_fd_states(m, B, SEED + 70, torch.float64)
        got, ref = free_fd.free_fd(m, q, v, tau), free_fd.free_fd_plain(m, q, v, tau)
        err = rel_err(got, ref)
        # the long chains' mass matrices magnify rounding: the limit is also
        # 100 times the plain version's distance from itself one ulp away
        spread = max(rel_err(free_fd.free_fd_plain(m, q * s, v, tau), ref)
                     for s in (1.0 + FREE_SPREAD_EPS, 1.0 - FREE_SPREAD_EPS))
        tol = max(FP64_TOL, FREE_SPREAD_FACTOR * spread)
        worst_abs = max(worst_abs, abs_err(got, ref))
        ms = kernel_ms(lambda: free_fd.launch(m, q, v, tau), 10, "free_fd_kernel")
        plain_ms = avg_time_ms(lambda: free_fd.free_fd_plain(m, q, v, tau), 5)
        nbytes = 8 * B * (m.nq + 3 * m.nv)
        flops = B * free_fd_flops(m)
        bms, by = bound(nbytes, flops, fp64=True)
        print(f"[kernel] free_fd fp64 {case} B={B} (nj={m.njoints}, nv={m.nv}; global "
              f"workspace): vs plain {err:.2e} (tol {tol:.1e}: 1e-9 or 100x the one-ulp "
              f"spread {spread:.1e}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; bound {bms:.5f} ms ({by}; kernel {ms / bms:.0f}x)")
        check(err <= tol, f"free_fd {case}: {err}")
        by_shape[case] = dict(B=B, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                              nbytes=nbytes, flops=flops, err=err)
    # the FFSR's exploding-trial states: the base at |q| ~ 5e9 m, where the
    # plain version (model.aba) now works at the first joint too
    m = robots.make_dual_arm_ffsr(device="cuda")
    q, v, tau = free_fd_states(m, 1024, SEED + 71, torch.float64)
    q[:, :3] += 5e9 * torch.sign(torch.randn((1024, 3), generator=_gen(SEED + 72),
                                             device="cuda", dtype=torch.float64))
    got, ref = free_fd.free_fd(m, q, v, tau), free_fd.free_fd_plain(m, q, v, tau)
    err = rel_err(got, ref)
    print(f"[kernel] free_fd fp64 dual_arm_ffsr, base at |q| ~ 5e9 m (exploding trials): "
          f"kernel vs plain {err:.2e} (tol 1e-9)")
    check(bool(torch.isfinite(ref).all()) and err <= 1e-9, f"free_fd far: {err}")
    main = by_shape["ffsr"]
    return dict(
        name="free_fd", route="cuda", source="aligator_tpu_torch/csrc/free_fd.cu",
        replaces="aligator_tpu/modelling/multibody/model.py:575",
        max_abs_err=worst_abs, ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=None,
    ), by_shape


def k5_flops(model, bodies, dims, active, kp=0.0):
    """Flops that K5's function needs on these inputs, summed over the
    ``active.shape[0]`` instances: the kernel's
    arithmetic (a multiply-add is 2) counted only where it is not a product
    with zero, and no product with a 0/1 mask. A[b, k] marks the dofs that
    move body b, D[k, j] the dof pairs with joint(j) ⪯ joint(k): a pair
    table entry is needed where D is 1, a body's contraction over k, its
    per-direction algebra and its accumulator entries where A[b] (and D) are
    1. An inactive contact (``active`` (K, ncont) is 0) has zero rows and a
    zero force, so it costs nothing."""
    from aligator_tpu_torch.modelling.multibody import model as rbd

    top = rbd.topology(model.joint_types, model.parents)
    A, D = top["A"] != 0, top["D"] != 0
    nv = A.shape[1]
    pairs = int(D.sum())

    def support(b):
        a = A[b]
        dirs = a | D[a].any(0)  # directions j whose derivatives are nonzero
        na, nj, npair = int(a.sum()), int(dirs.sum()), int(D[a].sum())
        # dAG, dAvG: per (j, component) and pair, an add and a multiply-add
        return na, nj, 18 * npair + 6 * na, npair

    # pair tables SxS and G (144 a pair), CVS, and the subtree term
    flops = 144 * pairs + 30 * nv + 12 * pairs
    for b in range(A.shape[0]):
        na, nj, contraction, _ = support(b)
        # 798 a direction: the 6-vector algebra of df, dfv; f_b; the two
        # accumulators (a dot6 and an add each, per (k, j)); F
        flops += contraction + 798 * nj + 36 + 24 * na * nj + 6 * na
    total = float(flops) * active.shape[0]
    act = (active != 0).sum(0).tolist()  # instances with each contact active
    for c, (b, dim) in enumerate(zip(bodies, dims)):
        na, nj, contraction, npair = support(b)
        # the kp·dp term of the position references: 6 more a direction
        per_dir = (243 if dim == 6 else 231) + (6 if kp else 0)
        # pdot and F_c; per (k, j) the J' lam transport (6) and, where D is
        # 1, the SxS . F_c term (12)
        one = contraction + per_dir * nj + 24 + 3 * (dim == 6) + 6 * na * nj + 12 * npair
        total += float(one) * act[c]
    return total


def k5_inputs(model, x0s, active, N, dq, dv, seed):
    """K = B N instances at the main path's shapes: the Talos states around
    the batch of initial states (q ⊕ dq, v + dv from a seed), the schedule's
    contact activity and random torques."""
    g = _gen(seed)
    B, nq, nv = x0s.shape[0], model.nq, model.nv
    dt = x0s.dtype

    def randn(*shape, scale):
        return scale * torch.randn(shape, generator=g, device="cuda",
                                   dtype=torch.float64).to(dt)

    q = model.configuration_space().integrate(
        x0s[:, None, :nq].expand(B, N, nq), randn(B, N, nv, scale=dq))
    v = x0s[:, None, nq:] + randn(B, N, nv, scale=dv)
    act = active.expand(B, N, active.shape[-1])
    tau = randn(B, N, nv, scale=5.0)
    return q, v, tau, act


def k5_phase():
    from aligator_tpu_torch.examples.talos_walk import create_talos_walk_problem
    from aligator_tpu_torch.modelling.multibody import contact, fd_rows, humanoid, quadruped

    def rows_check(model, q, v, tau, act, frames, dims, kd, dtype, tol, label):
        out = contact.cfd_internals(model, q, v, tau, frames, act, prox_mu=1e-9,
                                    kd=kd, contact_dims=dims)
        args = (model, q, v, out["a"], out["lam"], act, frames, dims)
        got = fd_rows.fd_rows(*args, kd=kd)
        ref = fd_rows.fd_rows_plain(*args, kd=kd)
        torch.cuda.synchronize()
        errs = [rel_err(g_, r_) for g_, r_ in zip(got, ref)]
        print(f"[kernel] fd_rows {label} K={q.shape[:-1].numel()}: max rel err "
              f"{max(errs):.3e} (tol {tol:g})")
        check(all(torch.isfinite(t).all().item() for t in got), f"fd_rows {label} non-finite")
        check(max(errs) <= tol, f"fd_rows {label}: {errs}")
        return args, got, ref

    # the test shapes, fp64: the humanoid's 2x6D and the quadruped's 4x3D
    # contacts, an inactive contact in every third instance
    rng = np.random.default_rng(SEED)
    for name in ("humanoid", "quadruped"):
        if name == "humanoid":
            m = humanoid.make_humanoid(device="cuda")
            q0 = humanoid.half_sitting(m)
            frames, dims, kd = (m.frame_id("left_sole"), m.frame_id("right_sole")), (6, 6), 50.0
        else:
            m = quadruped.make_quadruped(device="cuda")
            q0 = quadruped.standing_configuration(m)
            frames, dims, kd = tuple(m.frame_id(f"foot{k}") for k in range(4)), (3,) * 4, 10.0
        K, nv = 37, m.nv
        t = lambda a: torch.tensor(a, device="cuda")  # noqa: E731
        q = m.configuration_space().integrate(q0[None], t(0.05 * rng.standard_normal((K, nv))))
        act = np.ones((K, len(frames)))
        act[::3, 0] = 0.0
        rows_check(m, q, t(0.2 * rng.standard_normal((K, nv))),
                   t(2.0 * rng.standard_normal((K, nv))), t(act), frames, dims, kd,
                   torch.float64, FP64_TOL, f"fp64 {name} {len(dims)}x{dims[0]}D")

    # the main path's shapes: Talos, K = B N instances for both walk
    # batches, fp32
    from aligator_tpu_torch.modelling.multibody.derivatives import fd_rows_inputs

    problem, model, sched = create_talos_walk_problem(TALOS_T_DS, TALOS_T_SS,
                                                      dtype=torch.float32, device="cuda")
    N = problem.nsteps
    ode = problem.stages.dynamics.ode
    bodies = tuple(model.frame_parents[f] for f in ode.contact_frames)
    by_batch, max_abs = {}, 0.0
    for B in TALOS_BATCHES:
        x0s = torch.tensor(talos_x0s(problem.x0[0].cpu().numpy(), model.nq, B),
                           device="cuda")
        q, v, tau, act = k5_inputs(model, x0s, sched, N, 0.05, 0.2, SEED + 40)
        args, got, ref = rows_check(model, q, v, tau, act, ode.contact_frames,
                                    ode.contact_dims, ode.kd, torch.float32, K5_FP32_TOL,
                                    f"fp32 talos B={B} N={N}")
        if B == TALOS_BATCHES[0]:
            args64 = ((model.to(torch.float64),) + tuple(a.double() for a in args[1:6])
                      + args[6:])
            ref64 = fd_rows.fd_rows_plain(*args64, kd=ode.kd)
            for label, res in (("kernel", got), ("plain", ref)):
                e = max(rel_err(a.double(), b) for a, b in zip(res, ref64))
                print(f"[kernel] fd_rows fp32 {label} vs fp64 plain: {e:.2e}")
            del ref64
        max_abs = max(max_abs, max(abs_err(a, b) for a, b in zip(got, ref)))
        del got, ref

        inputs = fd_rows_inputs(model, q, v, args[3], ode.contact_frames)
        inputs.update(v=v, lam=args[4], act=act)
        launch = lambda: fd_rows.launch(model, inputs, bodies,  # noqa: E731
                                        ode.contact_dims, ode.kd, 0.0)
        ms = kernel_ms(launch, 20, "fd_rows_kernel")
        call_ms = avg_time_ms(lambda: fd_rows.fd_rows(*args, kd=ode.kd), 10)
        plain_ms = avg_time_ms(lambda: fd_rows.fd_rows_plain(*args, kd=ode.kd), 3)
        K, nv, nb = B * N, model.nv, model.njoints
        ncont, nc = len(bodies), sum(ode.contact_dims)
        in_words = 4 * nv * 6 + nv + 5 * nb * 6 + nb * 36 + nc + 4 * ncont
        out_words = 2 * nv * nv + 2 * nc * nv
        nbytes = 4 * (K * (in_words + out_words) + nb * nv + nv * nv)
        flops = k5_flops(model, bodies, ode.contact_dims, act.reshape(K, ncont).cpu())
        bms, by = bound(nbytes, flops)
        print(f"[kernel] fd_rows fp32 K={K}: kernel {ms:.4f} ms (wrapper call with its "
              f"input preparation {call_ms:.4f} ms), plain {plain_ms:.4f} ms; bound "
              f"{bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; "
              f"kernel {ms / bms:.1f}x)")
        by_batch[K] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bms,
                           bound_by=by, flops_per_instance=flops / K)
        del inputs, args
    by_batch.update(k5_solo_rows())
    by_batch.update(k5_chain_rows())
    main = by_batch[TALOS_BATCHES[0] * N]
    return dict(
        name="fd_rows", route="cuda", source="aligator_tpu_torch/csrc/fd_rows.cu",
        replaces="aligator_tpu/modelling/multibody/pallas_tensors.py:87",
        max_abs_err=max_abs, **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                                     "bound_by")},
        library_ms=None,
    ), dict(by_K=by_batch)


def k5_chain_cases(dtype):
    """K5's cases on free-flyer ``robots.make_chain`` models: past its old
    bounds of nv, nb, nc <= 64 (nv = 70, nb = 65, ten 3D contacts: the
    working set exceeds a block's shared memory and takes the global
    workspace), and past its old cap of 16 contacts (20 and 40 contacts on
    the chains of 20 and 40 links, a frame at every body, the last contact
    6D). Yields ``(label, model, frames, dims)``."""
    from aligator_tpu_torch.modelling.multibody import robots

    model = robots.make_chain(64, True, dtype=dtype, device="cuda")
    yield ("chain nv=70 nb=65, 10 3D contacts", model,
           tuple(model.frame_id(f"f{b}") for b in range(3, 43, 4)), (3,) * 10)
    for ncont in K5_MANY_CONTACTS:
        model = robots.make_chain(ncont, True, dtype=dtype, device="cuda", frame_stride=1)
        yield (f"{ncont} contacts nv={model.nv}", model, tuple(range(1, ncont + 1)),
               (3,) * (ncont - 1) + (6,))


def k5_chain_rows():
    """K5 on :func:`k5_chain_cases`, fp64 and fp32 at K = 512, against its
    plain version, timed beside its bound."""
    from aligator_tpu_torch.modelling.multibody import contact, fd_rows
    from aligator_tpu_torch.modelling.multibody.derivatives import fd_rows_inputs

    rows = {}
    for dtype, tol in ((torch.float64, FP64_TOL), (torch.float32, 1e-3)):
        for label, model, frames, dims in k5_chain_cases(dtype):
            bodies = tuple(model.frame_parents[f] for f in frames)
            g = _gen(SEED + 43)
            K, nv, nb = 512, model.nv, model.njoints
            q = model.configuration_space().integrate(
                model.neutral(torch.float64, "cuda")[None],
                0.1 * torch.randn((K, nv), generator=g, device="cuda", dtype=torch.float64))
            v, tau = (torch.randn((K, nv), generator=g, device="cuda", dtype=torch.float64)
                      for _ in range(2))
            q, v, tau = q.to(dtype), (0.2 * v).to(dtype), tau.to(dtype)
            act = torch.ones((K, len(frames)), dtype=dtype, device="cuda")
            act[::3, 0] = 0.0
            out = contact.cfd_internals(model, q, v, tau, frames, act, prox_mu=1e-6,
                                        kd=10.0, contact_dims=dims)
            args = (model, q, v, out["a"], out["lam"], act, frames, dims)
            got = fd_rows.fd_rows(*args, kd=10.0)
            ref = fd_rows.fd_rows_plain(*args, kd=10.0)
            torch.cuda.synchronize()
            err = max(rel_err(a, b) for a, b in zip(got, ref))
            check(all(torch.isfinite(t).all().item() for t in got),
                  f"fd_rows {label} non-finite")
            check(err <= tol, f"fd_rows {label} {dtype}: {err}")
            inputs = fd_rows_inputs(model, q, v, out["a"], frames)
            inputs.update(v=v, lam=out["lam"], act=act)
            ms = kernel_ms(lambda: fd_rows.launch(model, inputs, bodies, dims, 10.0, 0.0),
                           5, "fd_rows_kernel")
            plain_ms = avg_time_ms(lambda: fd_rows.fd_rows_plain(*args, kd=10.0), 2)
            nc, ncont, w = sum(dims), len(frames), torch.finfo(dtype).bits // 8
            in_words = 4 * nv * 6 + nv + 5 * nb * 6 + nb * 36 + nc + 4 * ncont
            out_words = 2 * nv * nv + 2 * nc * nv
            nbytes = w * (K * (in_words + out_words) + nb * nv + nv * nv)
            flops = k5_flops(model, bodies, dims, act.reshape(K, ncont).cpu())
            bms, by = bound(nbytes, flops, fp64=dtype == torch.float64)
            name = str(dtype)[6:]
            print(f"[kernel] fd_rows {name} {label} K={K}: vs plain {err:.2e} (tol "
                  f"{tol:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
                  f"{bms:.4f} ms ({by}; kernel {ms / bms:.1f}x)")
            rows[f"{label} {name} K={K}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                                 bound_by=by, err=err)
            del got, ref, inputs, out, args
    return rows


def k5_solo_rows():
    """K5 at the Solo jump's shape (fp64, K = B N = 7168 over its schedule,
    the flight's contacts inactive), without position references (the
    path's) and with them (kp = 50), against its plain version, timed
    beside its bound."""
    from aligator_tpu_torch.examples.solo_jump import create_solo_jump_problem
    from aligator_tpu_torch.modelling.multibody import contact, fd_rows
    from aligator_tpu_torch.modelling.multibody.derivatives import fd_rows_inputs

    prob, model, _ = create_solo_jump_problem(*SOLO_PHASES, device="cuda")
    ode, N = prob.stages.dynamics.ode, prob.nsteps
    frames, dims = ode.contact_frames, (3,) * len(ode.contact_frames)
    bodies = tuple(model.frame_parents[f] for f in frames)
    x0s = torch.tensor(solo_x0s(SOLO_BATCH, prob.x0[0].cpu().numpy()), device="cuda")
    q, v, tau, act = k5_inputs(model, x0s, ode.active, N, 0.05, 0.2, SEED + 41)
    out = contact.cfd_internals(model, q, v, tau, frames, act, prox_mu=ode.prox_mu,
                                kd=ode.kd, contact_dims=dims)
    args = (model, q, v, out["a"], out["lam"], act, frames, dims)
    K, nv, nb = q.shape[:-1].numel(), model.nv, model.njoints
    ncont, nc = len(bodies), sum(dims)
    rows = {}
    for kp in (0.0, 50.0):
        kw = dict(kd=ode.kd, kp=kp, has_prefs=kp != 0)
        got = fd_rows.fd_rows(*args, **kw)
        ref = fd_rows.fd_rows_plain(*args, **kw)
        torch.cuda.synchronize()
        err = max(rel_err(a, b) for a, b in zip(got, ref))
        check(all(torch.isfinite(t).all().item() for t in got), "fd_rows solo non-finite")
        check(err <= FP64_TOL, f"fd_rows solo kp={kp}: {err}")
        inputs = fd_rows_inputs(model, q, v, out["a"], frames)
        inputs.update(v=v, lam=out["lam"], act=act)
        ms = kernel_ms(lambda: fd_rows.launch(model, inputs, bodies, dims, ode.kd, kp),
                       20, "fd_rows_kernel")
        call_ms = avg_time_ms(lambda: fd_rows.fd_rows(*args, **kw), 10)
        plain_ms = avg_time_ms(lambda: fd_rows.fd_rows_plain(*args, **kw), 3)
        in_words = 4 * nv * 6 + nv + 5 * nb * 6 + nb * 36 + nc + 4 * ncont
        out_words = 2 * nv * nv + 2 * nc * nv
        nbytes = 8 * (K * (in_words + out_words) + nb * nv + nv * nv)
        flops = k5_flops(model, bodies, dims, act.reshape(K, ncont).cpu(), kp)
        bms, by = bound(nbytes, flops, fp64=True)
        print(f"[kernel] fd_rows fp64 Solo K={K} kp={kp:g}: vs plain {err:.2e} (tol "
              f"{FP64_TOL:g}); kernel {ms:.4f} ms (wrapper call {call_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms; bound {bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP; kernel {ms / bms:.1f}x)")
        rows[f"solo K={K} kp={kp:g}"] = dict(
            ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            flops_per_instance=flops / K, max_abs_err=max(abs_err(a, b)
                                                          for a, b in zip(got, ref)))
        del got, ref, inputs
    return rows


# ---------------------------------------------------------------- phase 4


def bench_x0s(batch):
    """Randomized parking scenarios around the nominal initial state, drawn
    as bench.py draws them (numpy in place of jax.random)."""
    rng = np.random.default_rng(SEED)
    d_p = 0.2 * rng.standard_normal((batch, 2))
    d_th = 0.2 * rng.standard_normal(batch)
    th = 0.15355 + d_th
    return np.stack(
        [0.7 + d_p[:, 0], -0.1 + d_p[:, 1], np.cos(th), np.sin(th)], -1
    ).astype(np.float32)


def slice_phase():
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples.se2_car import create_se2_problem

    cfg = at.solvers.ProxDDPConfig(
        tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4, rollout="linear",
        ls_max_steps=6, ls_strategy="filter",
    )
    x0s = bench_x0s(BATCH)
    problem = create_se2_problem(nsteps=NSTEPS, dtype=torch.float32, device="cuda")
    problem = dataclasses.replace(problem, x0=torch.tensor(x0s, device="cuda"))

    # the counted run: launch counts read just around the main path, with
    # the plain versions patched to raise
    with plain_versions_raise():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = at.solvers.solve(problem, cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = launch_counts()
    steps = int(res.newton_steps.max().item())
    print(f"[slice] first solve {first_s:.3f} s, launches {launches}, "
          f"iterations with a Newton step {steps}")
    # K1 once per Newton iteration, so at least once
    check(1 <= steps <= cfg.max_iters, f"Newton iterations {steps}")
    want = {"fused_riccati": steps, "spd_solve": 0, "fused_stage_sweep": 0,
            "fused_stage_forward": 0, "fd_rows": 0, "free_fd": 0}
    check(launches == want, f"SE(2) launches {launches} != {want}")

    finite = torch.isfinite(res.us).flatten(1).all(1) & torch.isfinite(res.xs).flatten(1).all(1)
    conv = finite & (res.prim_infeas <= cfg.tol) & (res.dual_infeas <= cfg.tol)
    frac = conv.float().mean().item()
    check(bool(finite.all()), "non-finite solutions")
    print(f"[slice] frac_converged {frac:.6f}; num_iters histogram "
          f"{torch.bincount(res.num_iters.long()).tolist()}; "
          f"max prim {res.prim_infeas.max().item():.3e} "
          f"max dual {res.dual_infeas.max().item():.3e}")
    check(frac >= MIN_FRAC_CONVERGED, f"frac_converged {frac} < {MIN_FRAC_CONVERGED}")

    # solves/s as bench.py counts it: median of timed batches after one
    # warm-up, each ended by a host readback
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        r = at.solvers.solve(problem, cfg)
        float(r.us.sum() + r.prim_infeas.sum() + r.dual_infeas.sum())
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(f"[slice] batch times (s) {[round(t, 4) for t in times]}; "
          f"median {med:.4f} s -> {BATCH / med:.1f} solves/s")

    breakdown = profile_solve(lambda: at.solvers.solve(problem, cfg))

    # the first scenarios again on the CPU, plain path
    n = CPU_CHECK_SCENARIOS
    cpu_problem = create_se2_problem(nsteps=NSTEPS, dtype=torch.float32, device="cpu")
    cpu_problem = dataclasses.replace(cpu_problem, x0=torch.tensor(x0s[:n]))
    t0 = time.perf_counter()
    rc = at.solvers.solve(cpu_problem, cfg)
    cpu_s = time.perf_counter() - t0
    same_iters = bool((rc.num_iters == res.num_iters[:n].cpu()).all())
    same_conv = bool((rc.conv == res.conv[:n].cpu()).all())
    dx = (rc.xs - res.xs[:n].cpu()).abs().max().item()
    du = (rc.us - res.us[:n].cpu()).abs().max().item()
    print(f"[slice] cpu check ({n} scenarios, {cpu_s:.1f} s): num_iters equal "
          f"{same_iters}, conv equal {same_conv}, max|dxs| {dx:.3e}, "
          f"max|dus| {du:.3e} (tol {CPU_TRAJ_TOL:g})")
    check(same_iters and same_conv, "card and CPU iteration counts differ")
    check(max(dx, du) <= CPU_TRAJ_TOL, "card and CPU trajectories differ")
    return launches, dict(frac_converged=frac, solves_per_sec=BATCH / med,
                          batch_s=med, breakdown=breakdown)


def profile_solve(run, tag="profile"):
    """Device time by kernel over one call of ``run`` (a solve;
    torch.profiler), and the share of its wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity only: host-side op events are not read, and at the
    # whole-body path's ~10^5 ops a solve their processing took minutes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"[{tag}] one solve: wall {wall_ms:.1f} ms (profiled), device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{sum(r[1] for r in rows)} kernel launches")
    for ms, count, key in rows[:12]:
        print(f"[{tag}]   {ms:9.3f} ms {count:6d}x  {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=sum(r[1] for r in rows),
                top=[(round(ms, 3), c, k[:60]) for ms, c, k in rows[:5]])


# ---------------------------------------------------------------- phase 5


PLAIN_VERSIONS = (
    ("gar.spd_solve", "spd_solve_plain"), ("gar.fused_stage", "sweep_plain"),
    ("gar.fused_stage", "stage_plain"), ("gar.fused_stage", "forward_plain"),
    ("gar.riccati", "backward_plain"), ("gar.riccati", "forward_plain"),
    ("gar.fused_riccati", "solve_plain"), ("modelling.multibody.fd_rows", "fd_rows_plain"),
    ("modelling.multibody.free_fd", "free_fd_plain"),
)


@contextlib.contextmanager
def plain_versions_raise():
    """Replace every plain version by a function that raises: a card solve
    inside the block must not reach one."""
    import importlib

    saved = []
    for mod_name, fn_name in PLAIN_VERSIONS:
        mod = importlib.import_module(f"aligator_tpu_torch.{mod_name}")
        saved.append((mod, fn_name, getattr(mod, fn_name)))

        def boom(*args, _name=f"{mod_name}.{fn_name}", **kwargs):
            raise AssertionError(f"{_name} was reached on the card")

        setattr(mod, fn_name, boom)
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


KERNEL_NAMES = ("fused_riccati", "spd_solve", "fused_stage_sweep", "fused_stage_forward",
                "fd_rows", "free_fd")


def launch_counts():
    from aligator_tpu_torch import _build

    return {k: _build.LAUNCHES[k] for k in KERNEL_NAMES}


def reset_counts():
    from aligator_tpu_torch import _build

    _build.LAUNCHES.clear()


def medium_path(label, make, x0s, solve, expected, min_frac=None,
                expect_iters=None, timed=3, cpu_scenarios=MEDIUM_CPU_SCENARIOS,
                cpu_make=None):
    """Drive one path on the card at full batch, then its first
    ``cpu_scenarios`` scenarios on the CPU. ``make(device, x0s)`` builds the
    problem (``cpu_make(x0s)`` the CPU's, if given), ``solve`` runs the
    solver, ``expected(result)`` gives the launch counts the route implies."""
    problem = make("cuda", x0s)
    with plain_versions_raise():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(problem)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = launch_counts()
        want = expected(res)
        print(f"[{label}] first solve {first_s:.3f} s, launches {launches}, "
              f"expected {want}")
        check(launches == want, f"{label}: launches {launches} != {want}")
        for name, n in want.items():
            check(n == 0 or launches[name] >= 1, f"{label}: {name} not launched")

        finite = (torch.isfinite(res.us).flatten(1).all(1)
                  & torch.isfinite(res.xs).flatten(1).all(1))
        check(bool(finite.all()), f"{label}: non-finite solutions")
        check(bool(torch.isfinite(res.prim_infeas).all() & torch.isfinite(res.dual_infeas).all()),
              f"{label}: non-finite infeasibilities")
        conv = finite & res.conv
        frac = conv.float().mean().item()
        hist = torch.bincount(res.num_iters.long()).tolist()
        print(f"[{label}] frac_converged {frac:.6f}; num_iters histogram {hist}; "
              f"max prim {res.prim_infeas.max().item():.3e} "
              f"max dual {res.dual_infeas.max().item():.3e}")
        if min_frac is not None:
            check(frac >= min_frac, f"{label}: frac_converged {frac} < {min_frac}")
        if expect_iters is not None:
            check(bool((res.num_iters == expect_iters).all()),
                  f"{label}: num_iters {hist}")

        # solves/s as bench.py counts it: median of timed batches after the
        # warm-up above, each ended by a host readback
        times = []
        for _ in range(timed):
            t0 = time.perf_counter()
            r = solve(problem)
            float(r.us.sum() + r.prim_infeas.sum() + r.dual_infeas.sum())
            times.append(time.perf_counter() - t0)
        breakdown = profile_solve(lambda: solve(problem), f"{label} profile")
    batch = x0s.shape[0]
    med = statistics.median(times)
    print(f"[{label}] batch times (s) {[round(t, 4) for t in times]}; median "
          f"{med:.4f} s -> {batch / med:.1f} solves/s")

    n = cpu_scenarios
    if n:
        t0 = time.perf_counter()
        rc = solve(cpu_make(x0s[:n]) if cpu_make else make("cpu", x0s[:n]))
        cpu_s = time.perf_counter() - t0
        same_iters = bool((rc.num_iters == res.num_iters[:n].cpu()).all())
        same_conv = bool((rc.conv == res.conv[:n].cpu()).all())
        scale = max(1.0, rc.xs.abs().max().item(), rc.us.abs().max().item())
        dx = (rc.xs - res.xs[:n].cpu()).abs().max().item() / scale
        du = (rc.us - res.us[:n].cpu()).abs().max().item() / scale
        print(f"[{label}] cpu check ({n} scenarios, {cpu_s:.1f} s): num_iters equal "
              f"{same_iters}, conv equal {same_conv}, rel max|dxs| {dx:.3e}, "
              f"max|dus| {du:.3e} (tol {MEDIUM_CPU_TRAJ_TOL:g})")
        check(same_iters and same_conv, f"{label}: card and CPU iteration counts differ")
        check(max(dx, du) <= MEDIUM_CPU_TRAJ_TOL,
              f"{label}: card and CPU trajectories differ")
    return launches, dict(frac_converged=frac, solves_per_sec=batch / med,
                          batch_s=med, batch_times=times, num_iters_hist=hist,
                          max_prim=res.prim_infeas.max().item(),
                          max_dual=res.dual_infeas.max().item(),
                          first_solve_s=first_s, breakdown=breakdown)


def medium_phases():
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples import medium_dims

    N = MEDIUM_NSTEPS
    out, counts = {}, {}

    rng = np.random.default_rng(3)
    hx0 = np.zeros(36)
    hx0[0] = 0.5
    hx0s = (hx0 + 0.1 * rng.standard_normal((HUMANOID_BATCH, 36))).astype(np.float32)

    def make_humanoid(dev, x0s):
        prob = medium_dims.make_humanoid_dims_problem(N, torch.float32, dev)
        return dataclasses.replace(prob, x0=torch.tensor(x0s, device=dev))

    hcfg = at.solvers.ProxDDPConfig(tol=1e-3, mu_init=1e-3, max_iters=4,
                                    max_al_iters=4, rollout="linear", ls_max_steps=6)

    def humanoid_counts(res):
        steps = int(res.newton_steps.max().item())
        return {"fused_riccati": 0, "spd_solve": 0, "fused_stage_sweep": steps,
                "fused_stage_forward": steps, "fd_rows": 0, "free_fd": 0}

    counts["humanoid"], out["humanoid"] = medium_path(
        "humanoid", make_humanoid, hx0s, lambda p: at.solvers.solve(p, hcfg),
        humanoid_counts, min_frac=MIN_FRAC_CONVERGED)

    rng = np.random.default_rng(7)
    lx0s = (1.0 + 0.1 * rng.standard_normal((LQR_BATCH, 56))).astype(np.float32)

    def make_lqr(dev, x0s):
        prob = medium_dims.make_dense_lqr(56, 22, N, torch.float32, dev)
        return dataclasses.replace(prob, x0=torch.tensor(x0s, device=dev))

    pcfg = at.solvers.ProxDDPConfig(tol=1e-7, mu_init=1e-9, max_iters=2,
                                    rollout="linear")

    def prox_counts(res):
        steps = int(res.newton_steps.max().item())
        return {"fused_riccati": 0, "spd_solve": 2 * N * steps,
                "fused_stage_sweep": 0, "fused_stage_forward": steps, "fd_rows": 0, "free_fd": 0}

    counts["lqr56_proxddp"], out["lqr56_proxddp"] = medium_path(
        "lqr56_proxddp", make_lqr, lx0s, lambda p: at.solvers.solve(p, pcfg),
        prox_counts, expect_iters=2)

    fcfg = at.solvers.FDDPConfig(tol=1e-7, max_iters=2)

    def fddp_counts(res):
        iters = int(res.num_iters.max().item())
        return {"fused_riccati": 0, "spd_solve": N * (iters + 1),
                "fused_stage_sweep": 0, "fused_stage_forward": 0, "fd_rows": 0, "free_fd": 0}

    counts["lqr56_fddp"], out["lqr56_fddp"] = medium_path(
        "lqr56_fddp", make_lqr, lx0s, lambda p: at.solvers.fddp.solve(p, fcfg),
        fddp_counts, expect_iters=2)
    return counts, out


# ---------------------------------------------------------------- phase 6


def talos_x0s(x0, nq, batch):
    """``batch`` copies of the nominal state ``x0`` with the velocities
    perturbed by 0.01 N(0, 1) (numpy, SEED), as bench_talos.py perturbs
    them; float32."""
    rng = np.random.default_rng(SEED)
    x0s = np.repeat(np.asarray(x0, np.float64)[None], batch, 0)
    x0s[:, nq:] += 0.01 * rng.standard_normal((batch, x0s.shape[1] - nq))
    return x0s.astype(np.float32)


def talos_phases():
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples.talos_walk import create_talos_walk_problem

    cfg = at.solvers.ProxDDPConfig(tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4,
                                   rollout="linear", ls_max_steps=6,
                                   force_initial_condition=True)
    nominal, model, _ = create_talos_walk_problem(TALOS_T_DS, TALOS_T_SS,
                                                  dtype=torch.float32, device="cpu")
    N = nominal.nsteps

    def make(dev, x0s, dtype=torch.float32):
        prob, _, _ = create_talos_walk_problem(TALOS_T_DS, TALOS_T_SS, dtype=dtype,
                                               device=dev)
        return dataclasses.replace(prob, x0=torch.tensor(x0s, dtype=dtype, device=dev))

    def counts(res):
        # per outer iteration and once more for the final refresh: one
        # derivative evaluation (K5 + the two contact-KKT K2 solves); per
        # Newton step: the 2N K2 solves of the Riccati loop and one K4 sweep
        loops = int(res.num_iters.max().item())
        steps = int(res.newton_steps.max().item())
        want = {"fused_riccati": 0, "spd_solve": 2 * (loops + 1) + 2 * N * steps,
                "fused_stage_sweep": 0, "fused_stage_forward": steps,
                "fd_rows": loops + 1, "free_fd": 0}
        got = launch_counts()
        if steps:
            print(f"[talos] outer iterations {loops}, Newton steps {steps}; per "
                  f"Newton step, less the final refresh: K5 "
                  f"{(got['fd_rows'] - 1) / steps:g}, K2 {(got['spd_solve'] - 2) / steps:g}, "
                  f"K4 {got['fused_stage_forward'] / steps:g}, K1 "
                  f"{got['fused_riccati']}, K3 {got['fused_stage_sweep']}")
        return want

    out, cnt = {}, {}
    for batch in TALOS_BATCHES:
        x0s = talos_x0s(nominal.x0[0].numpy(), model.nq, batch)
        cnt[batch], out[batch] = medium_path(
            f"talos{batch}", make, x0s, lambda p: at.solvers.solve(p, cfg), counts,
            cpu_scenarios=0, timed=TALOS_TIMED)
        check(cnt[batch]["fd_rows"] >= 1, "K5 was not launched on the Talos path")
    out["cpu_check"] = talos_cpu_check(make, x0s[:TALOS_CPU_SCENARIOS], cfg)
    out["fp32_check"] = talos_fp32_check(make, cfg)
    return cnt, out


def talos_cpu_check(make, x0s, cfg):
    """The first scenarios solved again on the CPU, float64 on both sides
    (the card with the plain versions patched to raise)."""
    import aligator_tpu_torch as at

    def rel(a, b, scale):
        return (a.cpu() - b.cpu()).abs().max().item() / scale

    with plain_versions_raise():
        gpu = at.solvers.solve(make("cuda", x0s, torch.float64), cfg)
    t0 = time.perf_counter()
    cpu = at.solvers.solve(make("cpu", x0s, torch.float64), cfg)
    cpu_s = time.perf_counter() - t0
    same = all(bool((getattr(cpu, k) == getattr(gpu, k).cpu()).all())
               for k in ("num_iters", "al_iter", "conv"))
    scale = max(1.0, cpu.xs.abs().max().item(), cpu.us.abs().max().item())
    dx, du = rel(gpu.xs, cpu.xs, scale), rel(gpu.us, cpu.us, scale)
    print(f"[talos] cpu check fp64 ({len(x0s)} scenarios, {cpu_s:.1f} s): "
          f"num_iters/al_iter/conv equal {same}, rel max|dxs| {dx:.3e}, max|dus| "
          f"{du:.3e} (tol {TALOS_CPU_TRAJ_TOL:g})")
    check(same, "talos: card and CPU iteration counts differ")
    check(max(dx, du) <= TALOS_CPU_TRAJ_TOL, "talos: card and CPU trajectories differ")
    return dict(same_iters=same, rel_dxs=dx, rel_dus=du)


TALOS_FP32_ULPS = (0.0, 1.0, -1.0)  # x0 scaled by 1 + k·2^-23 (one fp32 ulp)


def talos_fp32_check(make, cfg):
    """The float32 solve on the card, step by step, against the JAX
    package's float32 solve of the same 2 scenarios
    (``tests/data/torch_talos_fp32_ref.npz``, written by
    ``tools/torch_talos_fp32_fixture.py``): solved with 0..4 iterations from
    x0 and from x0·(1 ± 2^-23), the three in one batch; the infeasibilities
    after each step and which steps the line search rejected (iterate
    unchanged) must be the JAX package's from x0, or from one of the two
    one ulp away. The card's pattern flips within one or two fp32 ulps of
    x0 (measured: step 2 accepted at x0 since the multibody dynamics work
    at the first joint, steps 1 and 2 accepted at x0·(1 + 2·2^-23) before),
    while JAX and the port on the CPU reject all four steps at x0 ± 1 ulp:
    the rejections follow the order of the fp32 sums."""

    import pathlib

    import aligator_tpu_torch as at

    path = pathlib.Path(__file__).resolve().parent / "tests/data/torch_talos_fp32_ref.npz"
    with np.load(path) as f:
        ref = {k: f[k] for k in f.files}
    nb = len(ref["x0"])
    x0s = np.concatenate([(ref["x0"].astype(np.float64) * (1.0 + k * 2.0 ** -23))
                          .astype(np.float32) for k in TALOS_FP32_ULPS])
    prob = make("cuda", x0s)
    prim, dual, rejected, prev = [], [], [], None
    with plain_versions_raise():
        for k in range(cfg.max_iters + 1):
            res = at.solvers.solve(prob, dataclasses.replace(cfg, max_iters=k))
            prim.append(res.prim_infeas.cpu().numpy())
            dual.append(res.dual_infeas.cpu().numpy())
            if prev is not None:
                rejected.append(((res.xs == prev.xs).flatten(1).all(1)
                                 & (res.us == prev.us).flatten(1).all(1)).cpu().numpy())
            prev = res
    prim, dual, rejected = (np.stack(a, 1) for a in (prim, dual, rejected))
    iters, al = res.num_iters.cpu().numpy(), res.al_iter.cpu().numpy()
    groups = []
    for g, ulp in enumerate(TALOS_FP32_ULPS):
        sl = slice(g * nb, (g + 1) * nb)
        err = float(max(np.abs(prim[sl] - ref["prim"]).max() / np.abs(ref["prim"]).max(),
                        np.abs(dual[sl] - ref["dual"]).max() / np.abs(ref["dual"]).max()))
        same = (np.array_equal(iters[sl], ref["num_iters"])
                and np.array_equal(al[sl], ref["al_iter"]))
        match = same and np.array_equal(rejected[sl], ref["rejected"]) and \
            err <= TALOS_FP32_TOL
        groups.append(dict(ulps=ulp, rejected=rejected[sl].tolist(), prim=prim[sl].tolist(),
                           rel_err=err, counts_equal=same, matches_jax=bool(match)))
        print(f"[talos] fp32 card from x0·(1 {ulp:+g}·2^-23) vs JAX fp32 from x0 ({nb} "
              f"scenarios): rejected steps {rejected[sl].tolist()} (JAX "
              f"{ref['rejected'].tolist()}), prim per step {prim[sl].tolist()}, rel err of "
              f"prim/dual {err:.2e} (tol {TALOS_FP32_TOL:g}), num_iters/al_iter equal {same}")
    check(any(g["matches_jax"] for g in groups),
          "talos fp32: from x0 and one ulp away the card rejects other Newton steps than "
          "JAX, or its infeasibilities differ")
    return dict(groups=groups)


# ---------------------------------------------------------------- phase 7


def route_steps():
    from aligator_tpu_torch.solvers import proxddp

    return {k: int(v) for k, v in proxddp.ROUTE_STEPS.items()}


def reset_route_steps():
    from aligator_tpu_torch.solvers import proxddp

    for k in proxddp.ROUTE_STEPS:
        proxddp.ROUTE_STEPS[k] = 0


def chained_latency_ms(solve, prob, k_lo=1, k_hi=3, reps=3, slow_s=0.1):
    """Per-solve latency by the chained method of
    ``bench_latency.chained_latency``: k solves back to back, each problem's
    q perturbed by the previous solve's mean control (a data dependency, so
    the solves cannot overlap), host clock to a synchronize; the latency is
    the slope (t(k_hi) - t(k_lo)) / (k_hi - k_lo) of the best of ``reps``
    runs, which cancels the fixed overhead of a run. A solve slower than
    ``slow_s`` in the warm-up (the parallel legs, 1.3 s; the associative
    scan at B = 1024, 0.56 s) is timed from one run of each length: the
    spread of so long a run is small beside it."""
    q0 = prob.knots.q

    def run(k, i):
        q = q0 + i * 1e-7
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            pr = dataclasses.replace(prob, knots=dataclasses.replace(prob.knots, q=q))
            us = solve(pr)[1]
            q = q0 * (1.0 + 1e-7 * torch.tanh(us.mean()))
        float(q.sum())
        return time.perf_counter() - t0

    if run(k_lo, 0) / k_lo > slow_s:  # warm-up
        reps = 1
    else:
        run(k_hi, 0)
    t_lo = min(run(k_lo, i) for i in range(1, reps + 1))
    t_hi = min(run(k_hi, i) for i in range(1, reps + 1))
    return 1e3 * (t_hi - t_lo) / (k_hi - k_lo)


def lat_cases():
    """(N, B) of the latency phase: one problem at each of bench_latency.py's
    horizons, and the batch of 1024 at N = 2048 as bench.py runs it."""
    return [(N, B) for N in LAT_NS for B in LAT_BATCHES if B == 1 or N == LAT_N]


def latency_phase(card):
    """(a): one long-horizon LQ solve by the serial solve (K1), the
    associative scan and the parallel legs, at N = 128, 512 and 2048
    (bench_latency.py's horizons, one problem), and by the first two at B =
    1024 at N = 2048, on ``card`` (nvidia-smi's name and power limit)."""
    from aligator_tpu_torch.gar import associative, lqr_problem, parallel, riccati

    nx, nu, nc = LAT_DIMS
    solvers = {
        "serial": lambda p: riccati.solve_and_gains(p, LAT_MU, LAT_MU, True),
        "associative": lambda p: associative.solve(p, LAT_MU, LAT_MU, refine_steps=1),
        f"parallel{LAT_LEGS}": lambda p: parallel.solve(p, LAT_MU, LAT_MU, LAT_LEGS, True),
    }
    out, counted = {}, []
    for N, B in lat_cases():
        prob = k1_problem(B, N + 1, nx, nu, nc, True, torch.float32, SEED + 40)[0]
        n = min(B, LAT_CPU_SCENARIOS)
        cpu64 = prob.map(lambda t: t[:n].cpu().double())
        ref = riccati.solve(cpu64, LAT_MU, LAT_MU, True)
        scale = max(r.abs().max().item() for r in ref if r.numel())
        for name, solve in solvers.items():
            if B > 1 and name.startswith("parallel"):
                continue  # the legs at one problem only (2 s a solve)
            with plain_versions_raise():
                reset_counts()
                sol = solve(prob)
                torch.cuda.synchronize()
                launches = launch_counts()
                ms = chained_latency_ms(solve, prob)
            counted.append(launches)
            got = [t[:n].cpu().double() for t in sol[:4]]
            kkt = max(e.max().item() for e in lqr_problem.kkt_error(
                cpu64, *got, LAT_MU, LAT_MU))
            dist = max((g - r).abs().max().item() for g, r in zip(got, ref)
                       if r.numel()) / scale
            finite = all(bool(torch.isfinite(t).all()) for t in sol[:4])
            print(f"[latency] B={B} N={N} {name}: {ms:.3f} ms a solve (chained), "
                  f"launches a solve {dict((k, v) for k, v in launches.items() if v)}; "
                  f"fp32 solution in fp64 ({n} scenarios): KKT {kkt:.3e} (bound "
                  f"{LAT_KKT_TOL:g}), distance to the fp64 CPU serial solve "
                  f"{dist:.3e} (bound {LAT_DIST_TOL:g})")
            check(finite, f"latency {name} N={N} B={B}: non-finite solution")
            check(kkt <= LAT_KKT_TOL, f"latency {name} N={N} B={B}: KKT {kkt}")
            check(dist <= LAT_DIST_TOL, f"latency {name} N={N} B={B}: distance {dist}")
            out[f"N{N}_B{B}_{name}"] = dict(ms=ms, launches=launches, kkt=kkt, dist=dist)
        key = f"N{N}_B{B}_"
        ser = out[key + "serial"]["ms"]
        legs = out.get(key + f"parallel{LAT_LEGS}")
        print(f"[latency] {card}, N={N} B={B}: serial {ser:.3f} ms, associative "
              f"{out[key + 'associative']['ms']:.3f} ms "
              f"(speedup {ser / out[key + 'associative']['ms']:.2f})"
              + (f", parallel {legs['ms']:.3f} ms (speedup {ser / legs['ms']:.2f})"
                 if legs else ""))
        del prob, sol
    # K1 once a serial solve; K2 three times an associative solve and again
    # for its refinement; the legs' θ sweeps 2 K2 launches a stage of each
    # leg group, their forward below K4's nx
    for N, B in lat_cases():
        lens = sorted(set(parallel.get_work(N + 1, LAT_LEGS)[1]))
        want = {"serial": dict(fused_riccati=1), "associative": dict(spd_solve=6),
                f"parallel{LAT_LEGS}": dict(spd_solve=sum(2 * (L - 1) for L in lens))}
        for name, w in want.items():
            if f"N{N}_B{B}_{name}" not in out:
                continue
            got = {k: v for k, v in out[f"N{N}_B{B}_{name}"]["launches"].items() if v}
            check(got == w, f"latency {name} N={N} B={B}: launches {got} != {w}")
    return counted, out


def parallel_humanoid_phase(serial_sps, card):
    """(b): humanoid-dims ProxDDP on linear_solver='parallel'."""
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples import medium_dims
    from aligator_tpu_torch.gar.parallel import get_work

    N = MEDIUM_NSTEPS
    rng = np.random.default_rng(3)
    hx0 = np.zeros(36)
    hx0[0] = 0.5
    hx0s = (hx0 + 0.1 * rng.standard_normal((HUMANOID_BATCH, 36))).astype(np.float32)

    def make(dev, x0s, dtype=torch.float32):
        prob = medium_dims.make_humanoid_dims_problem(N, dtype, dev)
        return dataclasses.replace(prob, x0=torch.tensor(x0s, dtype=dtype, device=dev))

    cfg = at.solvers.ProxDDPConfig(tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4,
                                   rollout="linear", ls_max_steps=6,
                                   linear_solver="parallel", parallel_legs=PAR_LEGS)
    lens = sorted(set(get_work(N + 1, PAR_LEGS)[1]))

    def counts(res):
        # per Newton step and leg group: 2 K2 launches a stage of the θ
        # sweep, one K4 forward
        steps = int(res.newton_steps.max().item())
        return {"fused_riccati": 0, "spd_solve": steps * sum(2 * (L - 1) for L in lens),
                "fused_stage_sweep": 0, "fused_stage_forward": steps * len(lens),
                "fd_rows": 0, "free_fd": 0}

    launches, res = medium_path(
        "humanoid_parallel", make, hx0s, lambda p: at.solvers.solve(p, cfg), counts,
        min_frac=MIN_FRAC_CONVERGED,
        cpu_make=lambda x0s: make("cpu", x0s, torch.float64))
    print(f"[humanoid_parallel] {card}: {res['solves_per_sec']:.1f} solves/s on "
          f"'parallel' ({PAR_LEGS} legs), {serial_sps:.1f} on 'serial' in this run")
    return launches, res


def associative_phase():
    """(c): ProxDDP on linear_solver='associative' on the double-integrator
    LQR with a control bound, fp64, against 'serial_scan' on the card and
    the CPU; then fp32 below the μ floor."""
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples.lqr import make_lqr_problem

    rng = np.random.default_rng(SEED)
    x0s = np.array([1.0, 0.0]) + 0.1 * rng.standard_normal((ASSOC_BATCH, 2))

    def make(dev, dtype=torch.float64, n=None):
        prob = make_lqr_problem(ASSOC_NSTEPS, dtype, ASSOC_U_BOUND, device=dev)
        return dataclasses.replace(prob, x0=torch.tensor(x0s[:n], dtype=dtype, device=dev))

    def cfg(route, **kw):
        opts = dict(tol=1e-6, mu_init=1e-2, max_iters=20, rollout="linear")
        return at.solvers.ProxDDPConfig(**{**opts, **kw}, linear_solver=route)

    def counted(prob, c):
        with plain_versions_raise():
            reset_counts()
            reset_route_steps()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = at.solvers.solve(prob, c)
            torch.cuda.synchronize()
            return res, launch_counts(), route_steps(), time.perf_counter() - t0

    prob = make("cuda")
    res, launches, routes, secs = counted(prob, cfg("associative"))
    base, base_launches, base_routes, base_secs = counted(prob, cfg("serial_scan"))
    steps = int(res.newton_steps.max().item())
    conv = res.conv.float().mean().item()
    diff = max((getattr(res, k) - getattr(base, k)).abs().max().item()
               for k in ("xs", "us", "lams"))
    print(f"[assoc] 'associative' B={ASSOC_BATCH} N={ASSOC_NSTEPS} fp64: {secs:.3f} s, "
          f"frac_converged {conv:.4f}, num_iters histogram "
          f"{torch.bincount(res.num_iters.long()).tolist()}, Newton steps by route "
          f"{routes}, launches {launches}; 'serial_scan' {base_secs:.3f} s, "
          f"launches {base_launches}; max |associative - serial_scan| over xs, us, "
          f"lams {diff:.3e} (tol {ASSOC_TOL:g})")
    check(routes["associative"] > 0, "no Newton step took the associative route")
    check(routes["associative"] + routes["associative_fallback"]
          == int(res.newton_steps.sum().item()), f"route counts {routes}")
    check(torch.equal(res.num_iters, base.num_iters) and torch.equal(res.conv, base.conv),
          "associative and serial_scan iteration counts differ")
    check(diff <= ASSOC_TOL, f"associative vs serial_scan: {diff}")
    # 3 K2 launches a solve and 3 for its refinement on the scan; a
    # scenario under the floor adds the serial solve's 2N
    fallback = routes["associative_fallback"] > 0
    check(launches["spd_solve"] >= 6 * steps and launches["fused_riccati"] == 0
          and launches["fused_stage_sweep"] == 0 and launches["fused_stage_forward"] == 0
          and (fallback or launches["spd_solve"] == 6 * steps),
          f"associative launches {launches}")

    n = MEDIUM_CPU_SCENARIOS
    cpu = at.solvers.solve(make("cpu", n=n), cfg("associative"))
    same = all(torch.equal(getattr(cpu, k), getattr(res, k)[:n].cpu())
               for k in ("num_iters", "al_iter", "conv"))
    cdiff = max((getattr(cpu, k) - getattr(res, k)[:n].cpu()).abs().max().item()
                for k in ("xs", "us", "lams"))
    print(f"[assoc] cpu check ({n} scenarios, fp64): num_iters/al_iter/conv equal "
          f"{same}, max |card - cpu| {cdiff:.3e} (tol {ASSOC_TOL:g})")
    check(same and cdiff <= ASSOC_TOL, "associative: card and CPU differ")

    # float32 below the floor: every Newton step takes the serial solve
    p32 = make("cuda", torch.float32)
    r32, l32, routes32, _ = counted(p32, cfg("associative", mu_init=1e-4))
    b32, _, _, _ = counted(p32, cfg("serial_scan", mu_init=1e-4))
    equal = all(torch.equal(getattr(r32, k), getattr(b32, k))
                for k in ("xs", "us", "vs", "lams", "K", "kff", "num_iters", "conv"))
    print(f"[assoc] fp32 mu_init 1e-4: Newton steps by route {routes32}, launches "
          f"{l32}; equal to 'serial_scan' {equal}")
    check(routes32["associative"] == 0 and routes32["associative_fallback"] > 0,
          f"fp32 below the floor: route counts {routes32}")
    check(equal, "fp32 below the floor: results differ from serial_scan's")
    return [launches, l32], dict(
        secs=secs, serial_scan_secs=base_secs, frac_converged=conv, routes=routes,
        routes_fp32=routes32, diff_serial_scan=diff, diff_cpu=cdiff)


def parallel_in_time_phases(serial_sps, card):
    counted, latency = latency_phase(card)
    hl, humanoid = parallel_humanoid_phase(serial_sps, card)
    al, assoc = associative_phase()
    return counted + [hl] + al, dict(latency=latency, humanoid_parallel=humanoid,
                                     associative=assoc)


# ---------------------------------------------------------------- phase 8


def cart_x0s(batch):
    """Initial states 0 + 0.1·N(0, 1) around the hanging cartpole."""
    return 0.1 * np.random.default_rng(SEED + 8).standard_normal((batch, 4))


def rel_traj_err(a, b):
    """max |Δ| over xs and us relative to max(1, max |xs|, max |us|) of b."""
    scale = max(1.0, b.xs.abs().max().item(), b.us.abs().max().item())
    return max((a.xs - b.xs).abs().max().item(), (a.us - b.us).abs().max().item()) / scale


def col_rel(a, b):
    """max |a - b| over the last axis' columns, each relative to max(1, max
    |b|) of its column; equal entries (inf merits before the first step)
    count as 0, a finite against a non-finite as inf."""
    d = torch.where(a == b, 0.0, (a - b).abs()).flatten(0, -2)
    scale = torch.where(torch.isfinite(b), b.abs(), 0.0).flatten(0, -2)
    return (d.amax(0) / scale.amax(0).clamp(min=1.0)).max().item()


def solve_gaps(res, ref, n, k):
    """How far the first ``n`` scenarios of ``res`` (any depth, its history
    recorded) are from ``ref``, a solve of them cut to ``k`` iterations:
    the history rows of each of the first ``k`` iterations, the iterate
    after ``k`` iterations (``res``'s result where it stopped by then), and
    whether the iteration counts and convergence flags agree."""
    ran = res.num_iters[:n].cpu()
    done = ran <= k
    hk = min(k, res.history.shape[1] - 1)
    xs = torch.where(done[:, None, None], res.xs[:n].cpu(), res.history_xs[:n, hk].cpu())
    us = torch.where(done[:, None, None], res.us[:n].cpu(), res.history_us[:n, hk].cpu())
    by_iter = [col_rel(res.history[:n, i:i + 1].cpu(), ref.history[:, i:i + 1])
               for i in range(k)]
    same = bool((ref.num_iters == torch.clamp(ran, max=k)).all()
                and (ref.conv == (res.conv[:n].cpu() & done)).all())
    return by_iter, max(col_rel(xs, ref.xs), col_rel(us, ref.us)), same


def spread_limits(runs, k):
    """The free paths' limits (FREE_CPU_TOL or FREE_SPREAD_FACTOR times the
    spread) from the CPU solve from x0, ``runs[0]``, and those from the
    perturbed initial states, ``runs[1:]``: one for each iteration's history
    rows, one for the iterate."""
    gaps = [solve_gaps(r, runs[0], len(r.xs), k)[:2] for r in runs[1:]]
    by_iter = [max(g[0][i] for g in gaps) for i in range(k)]
    traj = max(g[1] for g in gaps)
    lim = [max(FREE_CPU_TOL, FREE_SPREAD_FACTOR * e) for e in by_iter + [traj]]
    return dict(spread_by_iter=by_iter, spread_traj=traj, tol_by_iter=lim[:-1],
                tol_traj=lim[-1])


@contextlib.contextmanager
def free_fd_by_plain():
    """The free-dynamics kernel's launcher replaced by ``model.aba`` in
    PyTorch: the card's rollout without the kernel (the witness run)."""
    from aligator_tpu_torch.modelling.multibody import free_fd

    launch = free_fd.launch
    free_fd.launch = free_fd.free_fd_plain
    try:
        yield
    finally:
        free_fd.launch = launch


def nonlinear_run(label, make, cfg, batch, want, cpu_n, profile=False, min_frac=None,
                  cpu_refs=None, profile_iters=CART_PROFILE_ITERS, init=None, witness=True,
                  keep=False):
    """One ProxDDP solve on the card (the nonlinear rollout, or the linear
    one), the plain versions patched to raise, its history recorded; its
    launch counts held to ``want(newton_steps, trials, N, iterations)``, its
    converged fraction to ``min_frac`` where given; with ``profile`` a
    profiled solve cut to ``profile_iters`` iterations; the first ``cpu_n``
    scenarios against the CPU over at most CART_CPU_ITERS iterations.
    Without ``cpu_refs`` they are solved again on the CPU here and held to
    CART_CPU_TOL. With ``cpu_refs`` (the free and contact paths: the CPU
    solves from x0 and from the perturbed initial states,
    :func:`free_cpu_refs`) each iteration is held to its
    :func:`spread_limits`, and so is, with ``witness``, a witness solve of
    the same scenarios on the card with ``model.aba`` in place of the
    free-dynamics kernel. ``make(device, n)`` builds the problem of the
    first ``n`` scenarios; ``init(problem)`` gives the solve's warm start
    (keyword arguments); with ``keep`` the card's result is returned as
    ``out["result"]``."""
    import aligator_tpu_torch as at

    cfg = dataclasses.replace(cfg, record_history=True, record_history_trajs=bool(cpu_n))
    from aligator_tpu_torch.solvers import proxddp

    def solve(problem, cfg):
        return at.solvers.solve(problem, cfg, **(init(problem) if init else {}))

    problem = make("cuda", batch)
    kw = init(problem) if init else {}
    with plain_versions_raise():
        reset_counts()
        proxddp.NONLINEAR_TRIALS = proxddp.LINEAR_TRIALS = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = at.solvers.solve(problem, cfg, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launch_counts()
    steps = int(res.newton_steps.max())
    trials = proxddp.NONLINEAR_TRIALS + proxddp.LINEAR_TRIALS
    want = want(steps, trials, problem.nsteps, int(res.num_iters.max()))
    finite = (torch.isfinite(res.us).flatten(1).all(1)
              & torch.isfinite(res.xs).flatten(1).all(1))
    frac = (finite & res.conv).float().mean().item()
    it = res.num_iters.float()
    iters = dict(min=int(it.min()), median=float(it.median()), max=int(it.max()),
                 mean=float(it.mean()))
    edges = np.linspace(0, cfg.max_iters, 11).round().astype(int)
    hist = np.histogram(res.num_iters.cpu().numpy(), bins=edges)[0]
    print(f"[{label}] batch {batch} N {problem.nsteps} {str(res.xs.dtype)[6:]}: one solve "
          f"{secs:.2f} s -> {batch / secs:.1f} solves/s; frac_converged {frac:.6f} "
          f"(floor {min_frac}); iterations {iters}, histogram "
          f"{dict(zip((f'{a}-{b}' for a, b in zip(edges, edges[1:])), hist.tolist()))}; "
          f"Newton steps {steps}, line-search trials {trials}; launches {launches}")
    check(launches == want, f"{label}: launches {launches} != {want}")
    check(bool(finite.all()), f"{label}: non-finite solutions")
    if min_frac is not None:
        check(frac >= min_frac, f"{label}: frac_converged {frac} < {min_frac}")
    out = dict(batch=batch, nsteps=problem.nsteps, solve_s=secs,
               solves_per_sec=batch / secs, frac_converged=frac, iters=iters,
               iter_histogram=dict(edges=edges.tolist(), counts=hist.tolist()),
               newton_steps=steps, trials=trials, max_iters=cfg.max_iters,
               conv=res.conv.cpu(),
               num_iters=res.num_iters.cpu())
    if keep:
        out["result"] = res
    if profile:
        out["breakdown"] = profile_solve(
            lambda: solve(problem, dataclasses.replace(
                cfg, max_iters=profile_iters, record_history=False,
                record_history_trajs=False)),
            f"{label} profile ({profile_iters} iterations)")
    if not cpu_n:
        return launches, out
    k = min(cfg.max_iters, CART_CPU_ITERS)
    fmt = lambda es: [f"{e:.1e}" for e in es]  # noqa: E731
    if cpu_refs is None:
        t0 = time.perf_counter()
        rc = solve(make("cpu", cpu_n), dataclasses.replace(cfg, max_iters=k))
        cpu_s = time.perf_counter() - t0
        by_iter, err_traj, same = solve_gaps(res, rc, cpu_n, k)
        print(f"[{label}] cpu check ({cpu_n} scenarios, {k} iterations, {cpu_s:.1f} s): "
              f"num_iters and conv equal {same}; history rows rel err by iteration "
              f"{fmt(by_iter)}, iterate rel err {err_traj:.3e} (tol {CART_CPU_TOL:g})")
        check(same, f"{label}: card and CPU iteration counts differ")
        check(max(by_iter + [err_traj]) <= CART_CPU_TOL, f"{label}: card and CPU solves differ")
        out.update(cpu_iters=k, cpu_hist_by_iter=by_iter, cpu_traj_rel_err=err_traj,
                   cpu_s=cpu_s)
        return launches, out

    rc = cpu_refs[0]
    lim = spread_limits(cpu_refs, k)
    print(f"[{label}] cpu spread ({cpu_n} scenarios, {k} iterations, x0 against x0·(1 ± "
          f"{FREE_SPREAD_EPS:g}) on the CPU, {rc.secs:.1f} s a solve): history rows by "
          f"iteration {fmt(lim['spread_by_iter'])}, iterate {lim['spread_traj']:.1e}; "
          f"limits {fmt(lim['tol_by_iter'])}, {lim['tol_traj']:.1e}")
    gaps = {}
    runs = {"card": ("the kernels", res)}
    if witness:
        with free_fd_by_plain():
            runs["witness"] = ("model.aba in PyTorch on the card",
                               solve(make("cuda", cpu_n), dataclasses.replace(cfg, max_iters=k)))
    for name, (what, r) in runs.items():
        by_iter, err_traj, same = solve_gaps(r, rc, cpu_n, k)
        gaps[name] = dict(by_iter=by_iter, traj=err_traj, same=same)
        print(f"[{label}] cpu check, {name} ({what}): "
              f"num_iters and conv equal {same}; history rows rel err by iteration "
              f"{fmt(by_iter)}, iterate rel err {err_traj:.3e}")
        check(same, f"{label} ({name}): card and CPU iteration counts differ")
        check(all(e <= t for e, t in zip(by_iter, lim["tol_by_iter"]))
              and err_traj <= lim["tol_traj"], f"{label} ({name}): card and CPU solves differ")
    out.update(cpu_iters=k, cpu_s=rc.secs, cpu_spread=lim, cpu_gaps=gaps)
    return launches, out


def free_fd_launches(trials, nsteps, iters):
    """The free-dynamics kernel's launches in a solve: once a stage of every
    nonlinear rollout (each trial and the warm-up before the trial graph's
    capture) and once for all stages of every derivative evaluation (each
    iteration and the final refresh: the dynamics residual)."""
    return nsteps * (trials + 1) + iters + 1


def k1_only(steps, trials, nsteps, iters, free_fd=False):
    """The launch counts of a path on K1 once a Newton step and, with
    ``free_fd``, the free-dynamics kernel (:func:`free_fd_launches`)."""
    return {"fused_riccati": steps, "spd_solve": 0, "fused_stage_sweep": 0,
            "fused_stage_forward": 0, "fd_rows": 0,
            "free_fd": free_fd_launches(trials, nsteps, iters) if free_fd else 0}


def cartpole_run(label, batch, integrator="rk2", dtype=torch.float64, nsteps=100,
                 cpu_n=CART_CPU_SCENARIOS, profile=False, min_frac=None, **opts):
    """:func:`nonlinear_run` on the cartpole (K1 once a Newton step,
    nothing else)."""
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples.cartpole import (SOLVE_OPTIONS,
                                                      create_cartpole_problem)

    x0s = cart_x0s(batch)

    def make(dev, n):
        prob = create_cartpole_problem(nsteps=nsteps, dtype=dtype, device=dev,
                                       integrator=integrator)
        return dataclasses.replace(prob, x0=torch.tensor(x0s[:n], dtype=dtype,
                                                         device=dev))

    cfg = at.solvers.ProxDDPConfig(**{**SOLVE_OPTIONS, **opts})
    return nonlinear_run(label, make, cfg, batch, k1_only, cpu_n, profile=profile,
                         min_frac=min_frac)


def cartpole_phases():
    counts, out = {}, {}
    runs = {
        "cartpole": dict(batch=CART_BATCH, profile=True, min_frac=CART_MIN_FRAC),
        "cartpole_midpoint": dict(batch=CART_VARIANT_BATCH, integrator="midpoint",
                                  nsteps=CART_MIDPOINT_NSTEPS, profile=True,
                                  rollout_max_iters=CART_MIDPOINT_NEWTON,
                                  min_frac=CART_MIDPOINT_MIN_FRAC,
                                  max_iters=CART_MIDPOINT_ITERS),
        "cartpole_exact": dict(batch=CART_VARIANT_BATCH, hessian_approx="exact",
                               max_iters=CART_EXACT_ITERS),
        "cartpole_fp32": dict(batch=CART_BATCH, dtype=torch.float32, cpu_n=0,
                              max_iters=CART_FP32_ITERS),
    }
    for label, kw in runs.items():
        counts[label], out[label] = cartpole_run(label, **kw)
    # fp64's converged fraction within fp32's budget, from its own run
    k = CART_FP32_ITERS
    f64 = out["cartpole"]
    within = (f64["conv"] & (f64["num_iters"] <= k)).float().mean().item()
    print(f"[cartpole] converged within {k} iterations: fp64 {within:.6f}, fp32 "
          f"{out['cartpole_fp32']['frac_converged']:.6f} (gates nothing); fp64 within "
          f"300 {f64['frac_converged']:.6f}; midpoint (N = {CART_MIDPOINT_NSTEPS}) "
          f"{out['cartpole_midpoint']['frac_converged']:.6f}")
    f64["frac_converged_within_fp32_budget"] = within
    for run in out.values():
        del run["conv"], run["num_iters"]
    return counts, out


# ---------------------------------------------------------------- phase 9


def inverse_lqr_phase(card):
    """Inverse LQR through gar.diff.solve: the published fit on the card and
    on the CPU, and ms a step at 16 and 4096 demonstrations."""
    from aligator_tpu_torch.examples import inverse_lqr as il

    N = 40
    x0s = np.random.default_rng(SEED + 9).standard_normal((max(INV_DEMOS), 4))

    def setup(dev, n):
        template = il.make_problem_template(N=N, device=dev)
        x = torch.tensor(x0s[:n], device=dev)
        return template, x, il.expert(template, x)

    def first_grad(dev):
        template, x, target = setup(dev, INV_DEMOS[0])
        q = x.new_zeros(4, requires_grad=True)
        r = x.new_zeros(2, requires_grad=True)
        il.loss(template, x, target, q, r).backward()
        return torch.cat([q.grad, r.grad]).cpu()

    n = INV_DEMOS[0]
    with plain_versions_raise():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, r, losses = il.fit(il.make_problem_template(N=N, device="cuda"),
                              torch.tensor(x0s[:n], device="cuda"), INV_STEPS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = launch_counts()
        g_card = first_grad("cuda")
    # the expert's solve, the forward and adjoint solve of every step and
    # the final loss: 2 K2 launches a stage each
    want = {"fused_riccati": 0, "spd_solve": 2 * N * (1 + 2 * INV_STEPS + 1),
            "fused_stage_sweep": 0, "fused_stage_forward": 0, "fd_rows": 0, "free_fd": 0}
    losses = losses.cpu()
    print(f"[inverse-lqr] {n} demonstrations, {INV_STEPS} Adam steps on the card in "
          f"{fit_s:.2f} s: loss {losses[0].item():.4e} -> {losses[-1].item():.4e}; "
          f"launches {launches}")
    check(launches == want, f"inverse LQR launches {launches} != {want}")
    check(bool(torch.isfinite(losses).all()), "inverse LQR: non-finite loss")
    check(losses[-1].item() < 1e-3 * losses[0].item(), "inverse LQR: the loss did not fall")

    t0 = time.perf_counter()
    qc, rc, losses_c = il.fit(il.make_problem_template(N=N, device="cpu"),
                              torch.tensor(x0s[:n]), INV_STEPS)
    cpu_s = time.perf_counter() - t0
    loss_err = abs(losses[-1].item() - losses_c[-1].item()) / abs(losses_c[-1].item())
    g_cpu = first_grad("cpu")
    grad_err = ((g_card - g_cpu).abs().max() / g_cpu.abs().max()).item()
    print(f"[inverse-lqr] cpu check ({cpu_s:.1f} s): final loss rel err {loss_err:.3e} "
          f"(tol {INV_LOSS_TOL:g}), first gradient rel err {grad_err:.3e} "
          f"(tol {INV_GRAD_TOL:g})")
    check(loss_err <= INV_LOSS_TOL, "inverse LQR: card and CPU final losses differ")
    check(grad_err <= INV_GRAD_TOL, "inverse LQR: card and CPU gradients differ")

    ms, breakdown = {}, None
    for demos in INV_DEMOS:
        template, x, target = setup("cuda", demos)
        q = x.new_zeros(4, requires_grad=True)
        r = x.new_zeros(2, requires_grad=True)
        opt = torch.optim.Adam([q, r], lr=0.1)

        def step():
            opt.zero_grad()
            il.loss(template, x, target, q, r).backward()
            opt.step()

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(INV_TIMED_STEPS):
            step()
        torch.cuda.synchronize()
        ms[demos] = (time.perf_counter() - t0) / INV_TIMED_STEPS * 1e3
        print(f"[inverse-lqr] {card}: {demos} demonstrations, {ms[demos]:.2f} ms an "
              f"Adam step (forward and adjoint solve, N = {N})")
        if demos == n:
            breakdown = profile_solve(step, f"inverse-lqr profile (one step, {n} demonstrations)")
    return launches, dict(fit_s=fit_s, loss0=losses[0].item(), loss_final=losses[-1].item(),
                          loss_rel_err=loss_err, grad_rel_err=grad_err, cpu_s=cpu_s,
                          ms_per_step={str(k): v for k, v in ms.items()},
                          breakdown=breakdown)


# ---------------------------------------------------------------- phase 10


def sensitivity_phase(card):
    """θ sensitivities of the double-integrator family at SENS_BATCH random
    θ, without and with an active control box."""
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples import theta_family as tf

    N = 20
    cases = {"free": (None, tf.SOLVE_OPTIONS, 5e-5),
             "box": (0.12, dict(tol=1e-8, mu_init=1e-2, max_iters=300), 1e-3)}
    thetas = 0.4 * np.random.default_rng(SEED + 10).standard_normal((SENS_BATCH, 2))
    counted, out = [], {}
    for case, (u_bound, opts, fd_tol) in cases.items():
        cfg = at.solvers.ProxDDPConfig(**opts)
        pf = tf.make_double_integrator_family(N, device="cuda", u_bound=u_bound)
        th = torch.tensor(thetas, device="cuda")
        with plain_versions_raise():
            reset_counts()
            res = at.solvers.solve(pf(th), cfg)
            torch.cuda.synchronize()
            solve_counts = launch_counts()
            reset_counts()
            t0 = time.perf_counter()
            res = at.solvers.theta_sensitivities(pf, th, cfg, res)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            th_counts = launch_counts()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                at.solvers.theta_sensitivities(pf, th, cfg, res)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        counted += [solve_counts, th_counts]
        breakdown = profile_solve(lambda: at.solvers.theta_sensitivities(pf, th, cfg, res),
                                  f"sensitivity {case} profile (one harvest)")
        steps = int(res.newton_steps.max())
        want_solve = {"fused_riccati": steps, "spd_solve": 0, "fused_stage_sweep": 0,
                      "fused_stage_forward": 0, "fd_rows": 0, "free_fd": 0}
        want_th = dict(want_solve, fused_riccati=0, spd_solve=2 * N)
        check(solve_counts == want_solve, f"{case}: solve launches {solve_counts}")
        check(th_counts == want_th, f"{case}: θ launches {th_counts} != {want_th}")
        frac = res.conv.float().mean().item()
        finite = bool(torch.isfinite(res.th_grad).all() & torch.isfinite(res.th_hess).all())
        check(finite, f"{case}: non-finite sensitivities")

        t0 = time.perf_counter()
        n = SENS_CPU_SCENARIOS
        pc = tf.make_double_integrator_family(N, device="cpu", u_bound=u_bound)
        rc = at.solvers.solve_with_sensitivities(pc, torch.tensor(thetas[:n]), cfg)
        cpu_s = time.perf_counter() - t0
        errs = {k: (getattr(res, k)[:n].cpu() - getattr(rc, k)).abs().max().item()
                / max(1.0, getattr(rc, k).abs().max().item()) for k in ("th_grad", "th_hess")}
        same = bool((rc.num_iters == res.num_iters[:n].cpu()).all())

        # central differences of converged values on the first converged
        # scenarios
        idx = res.conv.nonzero()[:SENS_FD_SCENARIOS, 0]
        eps = 1e-5
        fd_err = 0.0
        for j in range(2):
            e = torch.zeros(2, dtype=torch.float64, device="cuda")
            e[j] = eps
            both = at.solvers.solve(pf(torch.cat([th[idx] + e, th[idx] - e])), cfg)
            check(bool(both.conv.all()), f"{case}: a finite-difference solve did not converge")
            k = idx.shape[0]
            fd = (both.traj_cost[:k] - both.traj_cost[k:]) / (2 * eps)
            fd_err = max(fd_err, ((res.th_grad[idx, j] - fd).abs()
                                  / fd.abs().clamp(min=1.0)).max().item())
        print(f"[sensitivity] {case} ({card}): batch {SENS_BATCH}, frac_converged "
              f"{frac:.6f}, iterations max {int(res.num_iters.max())}; θ harvest "
              f"{first_ms:.2f} ms first, {statistics.median(times):.2f} ms median of 3; "
              f"launches solve {solve_counts}, θ {th_counts}; vs CPU ({n} scenarios, "
              f"{cpu_s:.1f} s): "
              f"num_iters equal {same}, th_grad {errs['th_grad']:.3e}, th_hess "
              f"{errs['th_hess']:.3e} (tol {SENS_TOL:g}); th_grad vs central differences "
              f"on {idx.shape[0]} scenarios {fd_err:.3e} (tol {fd_tol:g})")
        check(same, f"{case}: card and CPU iteration counts differ")
        check(max(errs.values()) <= SENS_TOL, f"{case}: card and CPU sensitivities differ")
        check(idx.shape[0] == SENS_FD_SCENARIOS and fd_err <= fd_tol,
              f"{case}: th_grad vs finite differences {fd_err}")
        out[case] = dict(frac_converged=frac, harvest_ms=statistics.median(times),
                         harvest_first_ms=first_ms, th_launches=th_counts, cpu_errs=errs,
                         fd_rel_err=fd_err, breakdown=breakdown)
    return counted, out


# ---------------------------------------------------------------- main


# ---------------------------------------------------------------- phase 11


def free_x0s(case, batch):
    """Initial states of a free-dynamics path (``tools/torch_free_fixture.py``'s
    ``x0s``): the UR5 at its neutral configuration + 0.1·N(0, 1) on q, the
    FFSR at the nominal arm posture + 0.05·N(0, 1) on the 14 arm joints, the
    acrobot at 0 + 0.1·N(0, 1); velocities of the arms zero."""
    from aligator_tpu_torch.modelling.multibody.robots import FFSR_Q_ARM1, FFSR_Q_ARM2

    rng = np.random.default_rng(SEED + {"ur5": 9, "ffsr": 10, "acrobot": 11}[case])
    if case == "ur5":
        x = np.zeros((batch, 12))
        x[:, :6] = 0.1 * rng.standard_normal((batch, 6))
    elif case == "ffsr":
        x = np.zeros((batch, 41))
        x[:, 6] = 1.0  # base quaternion w
        x[:, 7:21] = np.concatenate([FFSR_Q_ARM1, FFSR_Q_ARM2]) + 0.05 * rng.standard_normal(
            (batch, 14))
    else:
        x = 0.1 * rng.standard_normal((batch, 4))
    return x


def free_paths():
    """``{case: (create, published options, want)}`` of the free-dynamics
    paths: the UR5 and FFSR reaches on the per-stage loop (K2 twice a stage
    and K4 once a Newton step), the acrobot on K1 once a Newton step."""
    from aligator_tpu_torch.examples import acrobot, dual_ffsr_reach, ur5_reach

    def lq_loop(steps, trials, n, iters):
        return {"fused_riccati": 0, "spd_solve": 2 * n * steps, "fused_stage_sweep": 0,
                "fused_stage_forward": steps, "fd_rows": 0,
                "free_fd": free_fd_launches(trials, n, iters)}

    return {
        "ur5": (ur5_reach.create_ur5_problem, ur5_reach.SOLVE_OPTIONS, lq_loop),
        "ffsr": (dual_ffsr_reach.create_ffsr_problem, dual_ffsr_reach.SOLVE_OPTIONS, lq_loop),
        "acrobot": (acrobot.create_acrobot_problem, acrobot.SOLVE_OPTIONS,
                    lambda *a: k1_only(*a, free_fd=True)),
    }


def free_problem(case, create, dev, n, scale=1.0):
    """The path's problem on ``dev`` with its first ``n`` initial states,
    multiplied by ``scale``."""
    x0s = free_x0s(case, FREE_BATCHES[case])[:n] * scale
    prob = create(nsteps=FREE_NSTEPS[case], device=dev)
    return dataclasses.replace(prob, x0=torch.tensor(x0s, device=dev))


CPU_REF_FIELDS = ("history", "history_xs", "history_us", "xs", "us", "num_iters", "conv")


def free_cpu_refs(conn):
    """Worker process, CPU only: each free path's first FREE_CPU_SCENARIOS
    scenarios, each contact path's first CONTACT_CPU_SCENARIOS, the UR5
    table reach's first TABLE_CPU_SCENARIOS and the ingested Panda reach's
    first PANDA_CPU_SCENARIOS (its MJCF file written in the worker's own
    temporary directory) solved for CART_CPU_ITERS
    iterations with the published options from x0 and from
    x0·(1 ± FREE_SPREAD_EPS); sends ``("ok",
    {case: [fields of each solve as numpy arrays]})`` or ``("error",
    traceback)``."""
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples import panda_reach, ur5_table

    try:
        torch.set_num_threads(2)
        out = {}
        jobs = [(case, opts, lambda s, case=case, create=create: free_problem(
                    case, create, "cpu", FREE_CPU_SCENARIOS, s), None)
                for case, (create, opts, _) in free_paths().items()]
        jobs += [(case, p["opts"], lambda s, p=p: p["make"]("cpu", CONTACT_CPU_SCENARIOS, s),
                  p["init"]) for case, p in contact_paths().items()]
        jobs += [("ur5_table", ur5_table.SOLVE_OPTIONS,
                  lambda s: table_problem("cpu", TABLE_CPU_SCENARIOS, s), None)]
        panda_dir = tempfile.mkdtemp()
        panda_path = write_panda_file(panda_dir)
        jobs += [("panda_mjcf", panda_reach.SOLVE_OPTIONS, lambda s: panda_problem(
            panda_path, "cpu", PANDA_CPU_SCENARIOS, s), None)]
        for case, opts, make, init in jobs:
            cfg = at.solvers.ProxDDPConfig(**{**opts, "max_iters": CART_CPU_ITERS},
                                           record_history=True, record_history_trajs=True)
            out[case] = []
            for scale in (1.0, 1.0 + FREE_SPREAD_EPS, 1.0 - FREE_SPREAD_EPS):
                prob = make(scale)
                t0 = time.perf_counter()
                r = at.solvers.solve(prob, cfg, **(init(prob) if init else {}))
                out[case].append(dict({k: getattr(r, k).numpy() for k in CPU_REF_FIELDS},
                                      secs=time.perf_counter() - t0))
        shutil.rmtree(panda_dir, ignore_errors=True)
        conn.send(("ok", out))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class FreeCpuRefs:
    """:func:`free_cpu_refs` in a spawned process, started at once; ``get()``
    waits for its result, ``stop()`` ends it."""

    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=free_cpu_refs, args=(child,))
        self.proc.start()
        child.close()
        self.result = None

    def get(self):
        if self.result is None:
            t0 = time.perf_counter()
            status, payload = self.conn.recv()
            print(f"[free] CPU references received after waiting {time.perf_counter() - t0:.1f} s")
            check(status == "ok", f"the free paths' CPU references failed:\n{payload}")
            self.result = {case: [SimpleNamespace(**{
                k: (torch.from_numpy(v) if k != "secs" else v) for k, v in run.items()})
                for run in runs] for case, runs in payload.items()}
        return self.result

    def stop(self):
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()


def free_phase(cpu_refs):
    """The UR5 reach, the dual-arm FFSR reach and the acrobot
    (:func:`free_paths`), each at the published size and options, float64:
    solves/s, frac_converged, the iterations, launch counts, the first 16
    scenarios' converged count held to the JAX package's less one, and
    those 16 against the CPU (``cpu_refs``, a :class:`FreeCpuRefs`) for
    CART_CPU_ITERS iterations; one profiled FFSR solve."""
    import aligator_tpu_torch as at

    ref = np.load(FREE_REF)
    counts, out = {}, {}
    for case, (create, opts, want) in free_paths().items():
        batch, n_ref = FREE_BATCHES[case], FREE_CPU_SCENARIOS
        check(np.array_equal(free_x0s(case, batch)[:n_ref], ref[f"{case}_full_x0s"]),
              f"{case}: the initial states are not the JAX reference's")

        def make(dev, n, create=create, case=case):
            return free_problem(case, create, dev, n)

        budget = FREE_MAX_ITERS.get(case, opts["max_iters"])
        counts[case], out[case] = nonlinear_run(
            case, make, at.solvers.ProxDDPConfig(**{**opts, "max_iters": budget}), batch,
            want, n_ref, profile=case == "ffsr", cpu_refs=cpu_refs.get()[case],
            profile_iters=FREE_PROFILE_ITERS)
        jax_n = int((ref[f"{case}_full_conv"]
                     & (ref[f"{case}_full_num_iters"] <= budget)).sum())
        card_n = int(out[case]["conv"][:n_ref].sum())
        print(f"[{case}] converged on the first {n_ref} within {budget} iterations: card "
              f"{card_n}, JAX {jax_n} (floor {jax_n - 1}); JAX's iterations "
              f"{ref[f'{case}_full_num_iters'].tolist()}, the card's "
              f"{out[case]['num_iters'][:n_ref].tolist()}")
        check(card_n >= jax_n - 1, f"{case}: {card_n} of {n_ref} converged, JAX {jax_n}")
        out[case].update(first_converged=card_n, jax_first_converged=jax_n)
        del out[case]["conv"], out[case]["num_iters"]
    return counts, out


# ---------------------------------------------------------------- phase 12


def ur10_targets(batch):
    """The throw's targets ``(batch, 3)`` (``tools/torch_contact_fixture.py``'s
    ``ur10_targets``): TARGET_POS + U(−0.1, 0.1) m per axis; scenario 0
    keeps TARGET_POS."""
    from aligator_tpu_torch.examples.ur10_ballistic import TARGET_POS

    rng = np.random.default_rng(SEED + 15)
    t = np.asarray(TARGET_POS) + rng.uniform(-0.1, 0.1, (batch, 3))
    t[0] = TARGET_POS
    return t


def solo_x0s(batch, x0):
    """The jump's initial states (the fixture tool's ``solo_x0s``): the
    standing state ``x0`` with joint velocities 0.1·N(0, 1), the base at
    rest."""
    rng = np.random.default_rng(SEED + 16)
    out = np.tile(np.asarray(x0), (batch, 1))
    out[:, -8:] = 0.1 * rng.standard_normal((batch, 8))
    return out


def contact_paths():
    """``{case: dict(make, init, opts, want, batch)}`` of the contact paths.
    ``make(device, n, scale=1)`` builds the first ``n`` scenarios (initial
    states multiplied by ``scale``). The UR10 throw: K2 twice a stage a
    Newton step (the per-stage loop), six times a derivative evaluation (the
    loop constraint's KKT, 2 solves for its dynamics residual and 2 for the
    values and 2 for the folded tangents of ``acc_derivatives``) and twice a
    line-search trial (the dynamics residual; and twice for the warm-up
    before the trial's CUDA graph is captured), K4 once a Newton step. The
    Solo jump: K5 once and K2 twice a derivative evaluation (the contact-KKT
    derivative solves) and K2 twice a stage and K4 once a Newton step."""
    from aligator_tpu_torch.examples import solo_jump, ur10_ballistic

    targets = ur10_targets(UR10_BATCH)

    def ur10_make(dev, n, scale=1.0):
        prob = ur10_ballistic.create_ur10_ballistic_problem(
            UR10_NSTEPS, UR10_DT, target_pos=targets[:n], device=dev)[0]
        return dataclasses.replace(prob, x0=prob.x0 * scale)

    def ur10_init(prob):
        return dict(zip(("xs_init", "us_init"), ur10_ballistic.warm_start(prob)))

    def solo_make(dev, n, scale=1.0):
        prob = solo_jump.create_solo_jump_problem(*SOLO_PHASES, device=dev)[0]
        x0 = solo_x0s(SOLO_BATCH, prob.x0[0].cpu().numpy())[:n] * scale
        return dataclasses.replace(prob, x0=torch.tensor(x0, device=dev))

    def none(**kw):
        return {k: 0 for k in KERNEL_NAMES} | kw

    return {
        "ur10": dict(make=ur10_make, init=ur10_init, opts=ur10_ballistic.SOLVE_OPTIONS,
                     batch=UR10_BATCH, want=lambda steps, trials, n, iters: none(
                         spd_solve=2 * n * steps + 6 * (iters + 1) + 2 * (trials + 1),
                         fused_stage_forward=steps)),
        "solo": dict(make=solo_make, init=None, opts=solo_jump.SOLVE_OPTIONS,
                     batch=SOLO_BATCH, want=lambda steps, trials, n, iters: none(
                         spd_solve=2 * n * steps + 2 * (iters + 1),
                         fused_stage_forward=steps, fd_rows=iters + 1)),
    }


def contact_phase(cpu_refs):
    """The UR10 payload throw and the Solo jump (:func:`contact_paths`) at
    the published size and options, float64: solves/s, frac_converged, the
    iterations, launch counts, a profiled iteration, the first scenarios'
    converged count (4 throws, 64 jumps) held to the JAX package's less one
    and the first 4 against the CPU (``cpu_refs``) for CART_CPU_ITERS
    iterations; the throw's
    payload landing error (held to UR10_LANDING_TOL on the converged first
    4) and torque-box violation, the jump's peak base height."""
    import aligator_tpu_torch as at
    from aligator_tpu_torch.modelling.multibody.robots import ur10_effort_limits

    ref = np.load(CONTACT_REF)
    check(np.array_equal(ur10_targets(UR10_BATCH)[:4], ref["ur10_full_targets"]),
          "ur10: the targets are not the JAX reference's")
    counts, out = {}, {}
    for case, p in contact_paths().items():
        t_case = time.perf_counter()
        n_ref = CONTACT_CPU_SCENARIOS
        # the floor's scenarios: the first 4 throws, the first 64 jumps
        n_jax = len(ref[f"{case}_full_conv"])
        if case == "solo":
            x0 = p["make"]("cpu", n_jax).x0.numpy()
            check(np.array_equal(x0, ref["solo_full_x0s"]),
                  "solo: the initial states are not the JAX reference's")
        budget = CONTACT_MAX_ITERS.get(case, p["opts"]["max_iters"])
        counts[case], out[case] = nonlinear_run(
            case, p["make"], at.solvers.ProxDDPConfig(**{**p["opts"], "max_iters": budget}),
            p["batch"], p["want"],
            n_ref, profile=True, cpu_refs=cpu_refs.get()[case],
            profile_iters=CONTACT_PROFILE_ITERS, init=p["init"], witness=False, keep=True)
        res = out[case].pop("result")
        jax_n = int((ref[f"{case}_full_conv"]
                     & (ref[f"{case}_full_num_iters"] <= budget)).sum())
        card_n = int(out[case]["conv"][:n_jax].sum())
        print(f"[{case}] converged on the first {n_jax} within {budget} iterations: card "
              f"{card_n}, JAX {jax_n} "
              f"(floor {jax_n - 1}); JAX's iterations "
              f"{ref[f'{case}_full_num_iters'].tolist()}, the card's "
              f"{out[case]['num_iters'][:n_jax].tolist()}")
        check(card_n >= jax_n - 1, f"{case}: {card_n} of {n_jax} converged, JAX {jax_n}")
        conv = out[case]["conv"]
        if case == "ur10":
            targets = torch.tensor(ur10_targets(UR10_BATCH), device="cuda")
            land = (res.xs[:, -1, 6:9] - targets).abs().amax(-1).cpu()
            eff = ur10_effort_limits(device="cuda")
            viol = float((res.us.abs() - eff).clamp(min=0).max())
            first = land[:n_ref][conv[:n_ref]]
            worst_first = float(first.max()) if first.numel() else 0.0
            worst_conv = float(land[conv].max()) if bool(conv.any()) else float("nan")
            print(f"[ur10] payload landing error |p_mug(N) - target|: the largest "
                  f"{float(land.max()):.3e} over the batch, {worst_conv:.3e} over the "
                  f"converged, {worst_first:.3e} over the converged first {n_ref} (tol "
                  f"{UR10_LANDING_TOL:g}; JAX's {ref['ur10_full_landing_err'].tolist()}); "
                  f"the largest torque-box violation {viol:.3e} N m")
            check(worst_first <= UR10_LANDING_TOL, f"ur10: landing error {worst_first}")
            out[case].update(landing_err_max=float(land.max()), landing_err_conv=worst_conv,
                             torque_violation=viol)
        else:
            peak = res.xs[..., 2].amax(1)
            print(f"[solo] base peak height: median {float(peak.median()):.4f} m over the "
                  f"batch (start {float(res.xs[0, 0, 2]):.4f} m; JAX's first {n_jax} "
                  f"{ref['solo_full_peak'].tolist()}, the card's "
                  f"{peak[:n_jax].tolist()})")
            out[case].update(peak_median=float(peak.median()))
        out[case].update(first_converged=card_n, jax_first_converged=jax_n)
        del out[case]["conv"], out[case]["num_iters"], res
        print(f"[{case}] the path's checks and measurements took "
              f"{time.perf_counter() - t_case:.1f} s")
    return counts, out


# ---------------------------------------------------------------- phase 13


def table_x0s(batch):
    """The UR5 table reach's initial states (``tools/torch_collision_fixture.py``'s
    ``table_x0s``): the elbow-up start + 0.1·N(0, 1) on q, at rest."""
    rng = np.random.default_rng(SEED + 18)
    x = np.zeros((batch, 12))
    x[:, :6] = np.asarray(TABLE_Q0) + 0.1 * rng.standard_normal((batch, 6))
    return x


def table_problem(dev, n, scale=1.0):
    """The published table reach on ``dev`` with the first ``n`` initial
    states of the card batch, multiplied by ``scale``."""
    from aligator_tpu_torch.examples import ur5_table

    prob = ur5_table.create_ur5_table_problem(nsteps=TABLE_NSTEPS, device=dev)
    x0 = table_x0s(TABLE_BATCH)[:n] * scale
    return dataclasses.replace(prob, x0=torch.tensor(x0, device=dev))


def table_launches(steps, trials, n, iters):
    """The table reach's launches: K2 twice a stage and K4 once a Newton
    step (the per-stage loop); the free-dynamics kernel once for all stages
    of each line-search trial (linear rollout: the dynamics residual), of
    the warm-up before the trial's CUDA graph is captured and of each
    derivative evaluation (each iteration and the final refresh)."""
    return {k: 0 for k in KERNEL_NAMES} | dict(
        spd_solve=2 * n * steps, fused_stage_forward=steps,
        free_fd=(trials + 1) + (iters + 1))


def table_phase(cpu_refs):
    """The UR5 table reach at the published size and options, float64, B =
    TABLE_BATCH: solves/s, frac_converged, the iterations, launch counts, a
    breakdown of a solve cut to TABLE_PROFILE_ITERS iterations,
    the first 16 scenarios' converged count held to the JAX package's less
    one and those 16 against the CPU (``cpu_refs``) for CART_CPU_ITERS
    iterations; the table and box keep-outs' residuals on the converged
    trajectories held to the solver's tolerance (and over all, printed),
    the end effector's lowest height, and the final end-effector error."""
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples import ur5_table
    from aligator_tpu_torch.modelling.multibody import geometry as geo
    from aligator_tpu_torch.modelling.multibody import model as rbd
    from aligator_tpu_torch.modelling.multibody.robots import make_ur5

    ref = np.load(TABLE_REF)
    n_jax = len(ref["table_full_conv"])
    check(np.array_equal(table_x0s(TABLE_BATCH)[:n_jax], ref["table_full_x0s"]),
          "ur5 table: the initial states are not the JAX reference's")
    cfg = at.solvers.ProxDDPConfig(**ur5_table.SOLVE_OPTIONS)
    counts, out = nonlinear_run(
        "ur5_table", lambda dev, n: table_problem(dev, n), cfg, TABLE_BATCH, table_launches,
        TABLE_CPU_SCENARIOS, profile=True, profile_iters=TABLE_PROFILE_ITERS,
        cpu_refs=cpu_refs.get()["ur5_table"], keep=True)
    res = out.pop("result")
    jax_n = int(ref["table_full_conv"].sum())
    card_n = int(out["conv"][:n_jax].sum())
    print(f"[ur5_table] converged on the first {n_jax}: card {card_n}, JAX {jax_n} "
          f"(floor {jax_n - 1}); JAX's iterations {ref['table_full_num_iters'].tolist()}, "
          f"the card's {out['num_iters'][:n_jax].tolist()}")
    check(card_n >= jax_n - 1, f"ur5 table: {card_n} of {n_jax} converged, JAX {jax_n}")
    model = make_ur5(device="cuda")
    conv = out["conv"]
    # the problem's own keep-outs on the stages' states, r <= 0 where kept:
    # a converged solve keeps each to the tolerance; an unconverged one may
    # not (the JAX package's solve of scenario 6 dips to 0.134 m in its 100
    # iterations)
    ee = model.frame_id("ee")
    space = model.phase_space()
    xs, us = res.xs[:, :TABLE_NSTEPS], res.us
    keep_outs = {
        "table": geo.FrameHalfspaceResidual(model=model, frame_id=ee,
                                            **ur5_table.table_leaves(device="cuda")),
        "box": geo.FrameBoxResidual(model=model, frame_id=ee,
                                    **ur5_table.box_leaves(device="cuda"))}
    viol = {k: f.value(space, xs, us)[..., 0].amax(-1).cpu() for k, f in keep_outs.items()}
    viol_conv = {k: float(v[conv].max()) if bool(conv.any()) else float("nan")
                 for k, v in viol.items()}
    heights = ur5_table.ee_heights(model, res.xs).amin(-1).cpu()
    lowest_all = float(heights.min())
    jax_dips = int(((ref["table_full_min_height"] < ur5_table.TABLE_HEIGHT)
                    & ~ref["table_full_conv"]).sum())
    _, p_f = rbd.frame_placement(model, res.xs[:, -1, :model.nq], ee)
    err = (p_f - torch.tensor(ur5_table.P_TARGET, dtype=p_f.dtype, device=p_f.device)
           ).norm(dim=-1).cpu()
    err_conv = float(err[conv].max()) if bool(conv.any()) else float("nan")
    print(f"[ur5_table] the keep-outs' largest residual over the converged "
          f"trajectories: table {viol_conv['table']:.3e}, box {viol_conv['box']:.3e} "
          f"(tol {cfg.tol:g}); over all: table {float(viol['table'].max()):.3e}, box "
          f"{float(viol['box'].max()):.3e}")
    print(f"[ur5_table] the end effector's lowest height: {lowest_all:.5f} m over all, "
          f"{int((heights < ur5_table.TABLE_HEIGHT).sum())} of {len(heights)} below the "
          f"table, {int((heights[conv] < ur5_table.TABLE_HEIGHT).sum())} of them converged "
          f"(median of the minima {float(heights.median()):.5f} m; the table at "
          f"{ur5_table.TABLE_HEIGHT} m; JAX's first {n_jax} "
          f"{ref['table_full_min_height'].round(5).tolist()}, {jax_dips} unconverged "
          f"below it); the final end-effector error: median {float(err.median()):.3e} m, "
          f"largest {float(err.max()):.3e} m, largest over the converged {err_conv:.3e} m")
    check(bool(conv.any()) and max(viol_conv.values()) <= cfg.tol,
          f"ur5 table: a converged trajectory violates a keep-out: {viol_conv}")
    out.update(first_converged=card_n, jax_first_converged=jax_n,
               keep_out_residual_conv=viol_conv,
               keep_out_residual_all={k: float(v.max()) for k, v in viol.items()},
               lowest_height_all=lowest_all,
               final_ee_err_median=float(err.median()), final_ee_err_max=float(err.max()),
               final_ee_err_conv_max=err_conv)
    del out["conv"], out["num_iters"], res
    return counts, out


# ---------------------------------------------------------------- phase 14


MPC_PATHS = {"se2": (1, 4096), "humanoid": (1, 128)}
MPC_CYCLES = 20
MPC_CPU_SCENARIOS = 16
MPC_CPU_CYCLES = 4  # the CPU's cycles (~2 s each at N = 50) held to the card's first
MPC_HUMANOID_SEED = 5


def mpc_problem(path, batch, dev):
    """The MPC paths of bench_mpc.py's protocol, float32: the SE(2) car at N
    = 50 (one scenario the nominal state, a batch the fleet of
    ``mpc_se2.se2_initial_states``) and humanoid dims at N = 100 (x0
    perturbed by 0.05 N(0, 1), numpy)."""
    from aligator_tpu_torch.examples import medium_dims, mpc_se2

    if path == "se2":
        return mpc_se2.create_mpc_problem(batch, 50, torch.float32, dev, seed=SEED)
    prob = medium_dims.make_humanoid_dims_problem(100, torch.float32, dev)
    if batch > 1:
        rng = np.random.default_rng(MPC_HUMANOID_SEED)
        x0 = prob.x0.cpu().numpy() + 0.05 * rng.standard_normal((batch, prob.x0.shape[1]))
        prob = dataclasses.replace(prob, x0=torch.tensor(x0, dtype=torch.float32, device=dev))
    return prob


def mpc_chain(prob, cfg, cold, x_start, n):
    """``n`` chained cycles from ``x_start`` and the cold solve: the
    per-cycle results (each cycle writes its state into ``prob.x0``)."""
    from aligator_tpu_torch.examples import mpc_se2

    x, xs, us, out = x_start, cold.xs, cold.us, []
    for _ in range(n):
        x, r = mpc_se2.mpc_cycle(prob, cfg, x, xs, us)
        xs, us = r.xs, r.us
        out.append((x, r))
    return out


def mpc_host_syncs(run):
    """The host synchronizations of one call of ``run``: CUDA's sync debug
    mode warns at each."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def mpc_phase(card):
    """Receding-horizon MPC (examples/mpc_se2.py, bench_mpc.py's protocol):
    a cold solve, then 20 chained warm cycles (apply the first control,
    shift the warm start, re-solve at 2 iterations) at each batch, with the
    plain versions patched to raise and the launches checked against the
    route (K1 a Newton step on the SE(2) car, K3 and K4 at humanoid dims);
    ms a cycle of one scenario by the delta method (20 against 5 chained
    cycles, each timed once), scenario-cycles/s of a batch (the counted
    20 cycles), the share of cycles primal feasible at 1e-4; at B = 1 the
    host synchronizations and kernels of one cycle and its device-busy
    share (profiled); the first 16 scenarios' first 4 cycles
    held to the same cycles on the CPU (iteration counts and flags equal,
    trajectories within 1e-3, as the SE(2) path is held)."""
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples import mpc_se2

    cold_cfg = at.solvers.ProxDDPConfig(**mpc_se2.COLD)
    warm = at.solvers.ProxDDPConfig(**mpc_se2.WARM)
    out, counted = {}, []
    for path, batches in MPC_PATHS.items():
        for B in batches:
            label = f"mpc {path} B={B}"
            prob = mpc_problem(path, B, "cuda")
            cold = at.solvers.solve(prob, cold_cfg)
            x_start = prob.x0.clone()
            mpc_chain(prob, warm, cold, x_start, 1)  # the warm trial graph's capture
            with plain_versions_raise():
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                recs = mpc_chain(prob, warm, cold, x_start, MPC_CYCLES)
                float(recs[-1][1].us.sum())
                t_hi = time.perf_counter() - t0
                launches = launch_counts()
                steps = sum(int(r.newton_steps.max()) for _, r in recs)
                want = dict.fromkeys(KERNEL_NAMES, 0)
                if path == "se2":
                    want["fused_riccati"] = steps
                else:
                    want["fused_stage_sweep"] = want["fused_stage_forward"] = steps
                print(f"[{label}] {MPC_CYCLES} cycles: launches {launches}, expected {want}")
                check(launches == want, f"{label}: launches {launches} != {want}")
                counted.append(launches)

                def chain(n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    r = mpc_chain(prob, warm, cold, x_start, n)[-1][1]
                    float(r.us.sum())
                    return time.perf_counter() - t0

                t_lo = chain(5) if B == 1 else None
                syncs = prof = None
                if B == 1:  # one scenario's cycle: its syncs, kernels, busy share
                    syncs = mpc_host_syncs(lambda: mpc_se2.mpc_cycle(
                        prob, warm, x_start, cold.xs, cold.us))
                    prof = profile_solve(lambda: mpc_se2.mpc_cycle(
                        prob, warm, x_start, cold.xs, cold.us), f"{label} cycle")
            prims = torch.stack([r.prim_infeas for _, r in recs], 1)
            iters = torch.stack([r.num_iters for _, r in recs], 1)
            finite = all(bool(torch.isfinite(r.xs).all() & torch.isfinite(r.us).all())
                         for _, r in recs)
            check(finite, f"{label}: non-finite cycles")
            feas = (prims <= warm.tol).float().mean().item()
            res = dict(frac_cycles_prim_ok=feas, iters_mean=iters.float().mean().item(),
                       launches=launches)
            prof_line = ""
            if prof is not None:
                res.update(host_syncs_per_cycle=syncs, kernels_per_cycle=prof["kernels"],
                           busy_share=prof["busy_ms"] / prof["wall_ms"], cycle_profile=prof)
                prof_line = (f"; host syncs a cycle {syncs}, device kernels a cycle "
                             f"{prof['kernels']}, busy share {100 * res['busy_share']:.1f}%")
            if B == 1:
                ms = 1e3 * (t_hi - t_lo) / (MPC_CYCLES - 5)
                res["ms_per_cycle"] = ms
                rate = f"{ms:.3f} ms a cycle (delta of 20 and 5 chained cycles)"
            else:
                res["scenario_cycles_per_s"] = B * MPC_CYCLES / t_hi
                rate = f"{res['scenario_cycles_per_s']:.1f} scenario-cycles/s"
            print(f"[{label}] {card}: {rate}; primal-feasible share {feas:.4f} at "
                  f"{warm.tol:g}; mean iterations a cycle {res['iters_mean']:.2f}{prof_line}")
            # the first scenarios' cycles on the CPU
            n = min(B, MPC_CPU_SCENARIOS)
            cprob = dataclasses.replace(mpc_problem(path, B, "cpu"),
                                        x0=x_start[:n].cpu().clone())
            crecs = mpc_chain(cprob, warm, at.solvers.solve(cprob, cold_cfg),
                              cprob.x0.clone(), MPC_CPU_CYCLES)
            same = all(torch.equal(cr.num_iters, r.num_iters[:n].cpu())
                       and torch.equal(cr.conv, r.conv[:n].cpu())
                       for (_, cr), (_, r) in zip(crecs, recs))
            gap = max(max((cr.xs - r.xs[:n].cpu()).abs().max().item(),
                          (cr.us - r.us[:n].cpu()).abs().max().item())
                      for (_, cr), (_, r) in zip(crecs, recs))
            print(f"[{label}] cpu check ({n} scenarios, {MPC_CPU_CYCLES} cycles): num_iters "
                  f"and conv equal {same}, max|d(xs, us)| {gap:.3e} (tol "
                  f"{MEDIUM_CPU_TRAJ_TOL:g})")
            check(same, f"{label}: card and CPU cycles differ in iterations")
            check(gap <= MEDIUM_CPU_TRAJ_TOL, f"{label}: card and CPU cycles differ")
            res.update(cpu_same=same, cpu_gap=gap)
            out[f"{path}_B{B}"] = res
    return counted, out


# ---------------------------------------------------------------- phase 15


CENTROIDAL_BATCHES = {"wip": 1024, "centroidal": 256, "kinodynamics": 256,
                      "continuous": 256}
CENTROIDAL_REF = "tests/data/torch_centroidal_ref.npz"
CENTROIDAL_CPU_SCENARIOS = 1
CENTROIDAL_CPU_ITERS = 4


def centroidal_module(path):
    from aligator_tpu_torch.examples import (centroidal_locomotion, continuous_centroidal,
                                             solo_kinodynamics, wheeled_inverted_pendulum)

    return {"wip": wheeled_inverted_pendulum, "centroidal": centroidal_locomotion,
            "kinodynamics": solo_kinodynamics, "continuous": continuous_centroidal}[path]


def centroidal_problem(path, x0s, dev):
    """``(problem, init)`` of a path at its published size, float64, from
    numpy initial states."""
    mod = centroidal_module(path)
    x0 = torch.tensor(x0s, dtype=torch.float64, device=dev)
    if path == "wip":
        prob = mod.create_wip_problem(device=dev)
    elif path == "centroidal":
        prob = mod.create_centroidal_problem(device=dev)
    elif path == "kinodynamics":
        prob = mod.create_kinodynamics_problem(device=dev)
    else:
        prob = dataclasses.replace(mod.create_problem(device=dev)[0], x0=x0)
        return prob, dict(xs_init=mod.warm_start(prob))
    return dataclasses.replace(prob, x0=x0), {}


def centroidal_route(path, N, res):
    """The launches a solve's route implies: K1 a Newton step for the
    pendulum ((4, 1), E = -I); the per-stage loop's K2 twice a stage a step
    for the centroidal gait ((9, 12): nu > 8 sends it past K1, nx < 12 past
    K3 and K4); K3 and K4 a step for the kinodynamics (25, 20) and the
    continuous gait (21, 12)."""
    steps = int(res.newton_steps.max())
    want = dict.fromkeys(KERNEL_NAMES, 0)
    if path == "wip":
        want["fused_riccati"] = steps
    elif path == "centroidal":
        want["spd_solve"] = 2 * N * steps
    else:
        want["fused_stage_sweep"] = want["fused_stage_forward"] = steps
    return want


def short_gaps(a, b):
    """History rows by iteration and the iterate (xs, us, lams) of two solves
    cut to the same iterations, and whether their counts and flags agree."""
    k = min(a.history.shape[1], b.history.shape[1])
    by_iter = [col_rel(a.history[:, i:i + 1].cpu(), b.history[:, i:i + 1].cpu())
               for i in range(k)]
    traj = max(col_rel(getattr(a, f).cpu(), getattr(b, f).cpu()) for f in ("xs", "us", "lams"))
    same = bool(torch.equal(a.num_iters.cpu(), b.num_iters.cpu())
                and torch.equal(a.conv.cpu(), b.conv.cpu()))
    return by_iter, traj, same


def centroidal_phase(card):
    """The wheeled inverted pendulum (B = 1024), the centroidal gait, the
    Solo kinodynamics and the continuous gait (B = 256) at their published
    sizes and budgets, float64, initial states from SEED (numpy,
    ``initial_states`` of each example): with the plain versions patched to
    raise, launches checked against the route (:func:`centroidal_route`),
    solves/s, frac_converged, the first 16 scenarios' converged count held
    to the JAX package's (tests/data/torch_centroidal_ref.npz) less one,
    the least of its counts from x0 and from x0·(1 ± 1e-15) (the gait
    flips scenarios on one ulp),
    each converged scenario's physical checks (``solution_checks``); the
    first 2 scenarios over 4 iterations on the card against the CPU, to 1e-9
    or 100 times the spread of CPU solves from x0·(1 ± 1e-15)."""
    import aligator_tpu_torch as at

    ref = np.load(CENTROIDAL_REF)
    out, counted = {}, []
    for path, B in CENTROIDAL_BATCHES.items():
        mod = centroidal_module(path)
        label = f"centroidal {path} B={B}"
        x0s = mod.initial_states(B, SEED)
        floor_x0 = ref[f"{path}_full_x0"]
        check(np.array_equal(x0s[:len(floor_x0)], floor_x0),
              f"{label}: initial states differ from the fixture's")
        prob, init = centroidal_problem(path, x0s, "cuda")
        cfg = at.solvers.ProxDDPConfig(**mod.SOLVE_OPTIONS)
        with plain_versions_raise():
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = at.solvers.solve(prob, cfg, **init)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launches = launch_counts()
            want = centroidal_route(path, prob.nsteps, res)
            print(f"[{label}] first solve {first_s:.2f} s, launches {launches}, expected {want}")
            check(launches == want, f"{label}: launches {launches} != {want}")
            counted.append(launches)
            secs = first_s
            # a second, timed solve where the first (which also captures the
            # graphs) is short; the longer paths report their first solve
            if first_s < 3.0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r2 = at.solvers.solve(prob, cfg, **init)
                float(r2.us.sum())
                secs = time.perf_counter() - t0
        finite = torch.isfinite(res.xs).flatten(1).all(1) & torch.isfinite(res.us).flatten(1).all(1)
        check(bool(finite.all()), f"{label}: non-finite solutions")
        conv = res.conv & finite
        frac = conv.float().mean().item()
        n16 = len(floor_x0)
        # JAX's count from x0, and the least of it and its counts from
        # x0·(1 ± 1e-15): the floor is that least count less one
        jax_conv = int(ref[f"{path}_full_conv"].sum())
        jax_least = min(jax_conv, *(int(ref[f"{path}_full_conv_{k}"].sum())
                                    for k in ("up", "down")))
        ours = int(conv[:n16].sum())
        checks = mod.solution_checks(res.xs, res.us)
        phys = {k: (v | ~conv).float().mean().item() for k, v in checks.items()}
        hist = torch.bincount(res.num_iters.long()).tolist()
        print(f"[{label}] {card}: {B / secs:.2f} solves/s ({secs:.2f} s a batch), "
              f"frac_converged {frac:.4f}, first {n16} converged {ours} (JAX {jax_conv}, "
              f"{jax_least} at least over one ulp of x0, floor {jax_least - 1}); physical "
              f"checks on converged scenarios {phys}; num_iters histogram {hist}")
        check(ours >= jax_least - 1, f"{label}: {ours} of the first {n16} converged, JAX "
                                     f"{jax_conv} (least {jax_least})")
        check(all(v == 1.0 for v in phys.values()), f"{label}: physical checks {phys}")
        # card against CPU over the first iterations, held to the CPU spread
        n, k = CENTROIDAL_CPU_SCENARIOS, CENTROIDAL_CPU_ITERS
        kcfg = dataclasses.replace(cfg, max_iters=k, record_history=True)

        def short(dev, scale=1.0):
            p, i = centroidal_problem(path, x0s[:n] * scale, dev)
            return at.solvers.solve(p, kcfg, **i)

        t0 = time.perf_counter()
        cpu = short("cpu")
        spread = [short_gaps(short("cpu", s), cpu)
                  for s in (1.0 + FREE_SPREAD_EPS, 1.0 - FREE_SPREAD_EPS)]
        cpu_s = time.perf_counter() - t0
        with plain_versions_raise():
            card_k = short("cuda")
        by_iter, traj, same = short_gaps(card_k, cpu)
        lim_iter = [max(FREE_CPU_TOL, FREE_SPREAD_FACTOR * max(g[0][i] for g in spread))
                    for i in range(len(by_iter))]
        lim_traj = max(FREE_CPU_TOL, FREE_SPREAD_FACTOR * max(g[1] for g in spread))
        print(f"[{label}] cpu check ({n} scenarios, {k} iterations, {cpu_s:.1f} s): "
              f"num_iters and conv equal {same}; history rows rel err by iteration "
              f"{[f'{e:.1e}' for e in by_iter]} (limits {[f'{e:.1e}' for e in lim_iter]}), "
              f"iterate {traj:.2e} (limit {lim_traj:.1e})")
        check(same, f"{label}: card and CPU iteration counts differ")
        check(all(e <= t for e, t in zip(by_iter, lim_iter)) and traj <= lim_traj,
              f"{label}: card and CPU solves differ")
        out[path] = dict(batch=B, solves_per_sec=B / secs, batch_s=secs, first_solve_s=first_s,
                         frac_converged=frac, first16_converged=ours, jax_first16=jax_conv,
                         jax_first16_least=jax_least,
                         physical=phys, num_iters_hist=hist, launches=launches,
                         cpu_by_iter=by_iter, cpu_traj=traj, cpu_limits=lim_iter + [lim_traj])
        del prob, res
    return counted, out


# ---------------------------------------------------------------- phase 16


def write_panda_file(directory):
    """The armature Panda's MJCF text (``panda_reach.write_panda_mjcf``) in
    ``directory``; returns its path."""
    from aligator_tpu_torch.examples import panda_reach

    path = f"{directory}/panda.xml"
    panda_reach.write_panda_mjcf(path)
    return path


def panda_problem(path, dev, n, scale=1.0):
    """The published reach on the Panda read from ``path``
    (``create_panda_problem(real_model=True)`` with ``PANDA_MJCF_PATH``
    pointed at it) with the first ``n`` of the PANDA_BATCH starts,
    multiplied by ``scale``."""
    from aligator_tpu_torch.examples import panda_reach
    from aligator_tpu_torch.modelling.multibody import robots

    robots.PANDA_MJCF_PATH = path
    prob = panda_reach.create_panda_problem(nsteps=PANDA_NSTEPS, real_model=True, device=dev)
    x0 = panda_reach.initial_states(PANDA_BATCH, SEED)[:n] * scale
    return dataclasses.replace(prob, x0=torch.tensor(x0, device=dev))


def panda_launches(steps, trials, n, iters):
    """The reach's launches: K2 twice a stage and K4 once a Newton step (the
    per-stage loop; ndx 14, general E), the free-dynamics kernel
    (:func:`free_fd_launches`)."""
    return {k: 0 for k in KERNEL_NAMES} | dict(
        spd_solve=2 * n * steps, fused_stage_forward=steps,
        free_fd=free_fd_launches(trials, n, iters))


def post_clearance(model, xs, frame):
    """Each trajectory's least distance ``(B,)`` from ``frame`` to the
    post's axis, less the post's radius (the margin the collision
    constraint keeps non-negative)."""
    from aligator_tpu_torch.examples import panda_reach
    from aligator_tpu_torch.modelling.multibody import model as rbd

    a, b = (torch.tensor(p, dtype=xs.dtype, device=xs.device) for p in panda_reach.POST)
    _, p = rbd.frame_placement(model, xs[..., :model.nq], model.frame_id(frame))
    ab = b - a
    t = (((p - a) @ ab) / (ab @ ab)).clamp(0.0, 1.0)
    d = (p - (a + t[..., None] * ab)).norm(dim=-1)
    return (d - panda_reach.POST_RADIUS).amin(-1)


def panda_mjcf_phase(cpu_refs):
    """The Panda reach on a Panda read from MJCF at the published size,
    float64, B = PANDA_BATCH: the text written (the JAX package's, from the
    fixture), the model read back held to the one written, then solves/s,
    frac_converged, the iterations, launch counts, a breakdown of one
    iteration, the first 16 starts' converged count held to the JAX
    package's less one and the first 4 against the CPU (``cpu_refs``) for
    CART_CPU_ITERS iterations; the flange's and the elbow's least clearance
    to the post and the final flange error."""
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples import panda_reach
    from aligator_tpu_torch.modelling.multibody import free_fd, robots
    from aligator_tpu_torch.modelling.multibody import model as rbd
    from aligator_tpu_torch.modelling.multibody.mjcf_export import model_to_mjcf

    ref = np.load(PANDA_REF)
    written = panda_reach.armature_panda(device="cuda")
    check(model_to_mjcf(written, name="panda") == str(ref["mjcf_text"]),
          "panda: the port's MJCF text is not the JAX package's")
    n_jax = len(ref["full_conv"])
    check(np.array_equal(panda_reach.initial_states(PANDA_BATCH, SEED)[:n_jax],
                         ref["full_x0s"]), "panda: the starts are not the JAX reference's")
    tmp = tempfile.mkdtemp()
    try:
        path = write_panda_file(tmp)
        model, info = robots.make_panda_real(path, device="cuda")
        errs = {k: rel_err(getattr(model, k), getattr(written, k))
                for k in ("jplac_p", "axes", "mass", "com", "inertia", "gravity")}
        errs["jplac_R"] = rel_err(rbd.quat_to_matrix(model.jplac_q),
                                  rbd.quat_to_matrix(written.jplac_q))
        for name in ("attachment", "elbow"):
            i, j = model.frame_id(name), written.frame_id(name)
            errs[f"frame {name}"] = max(rel_err(model.fplac_p[i], written.fplac_p[j]),
                                        rel_err(rbd.quat_to_matrix(model.fplac_q[i]),
                                                rbd.quat_to_matrix(written.fplac_q[j])))
        same_arm = model.armature is not None and torch.equal(model.armature, written.armature)
        print(f"[panda_mjcf] the model read back from {len(str(ref['mjcf_text']))} bytes of "
              f"MJCF: {model.njoints} joints, frames {model.frame_names}; largest table "
              f"error against the model written {max(errs.values()):.2e} (tol 1e-12; "
              f"{ {k: f'{e:.1e}' for k, e in errs.items()} }); armature equal {same_arm} "
              f"({model.armature.tolist() if model.armature is not None else None})")
        check(max(errs.values()) <= 1e-12 and same_arm
              and (model.joint_types, model.parents) == (written.joint_types, written.parents),
              f"panda: the model read back differs from the one written: {errs}")
        prob = panda_problem(path, "cuda", 1)
        solved = prob.stages.dynamics.ode.model
        table = free_fd._model_table(solved, prob.x0)
        check(solved.armature is not None and "attachment" in solved.frame_names
              and torch.equal(table[-solved.nv:], solved.armature),
              "panda: the problem does not solve the ingested model with its armature")
        budget = int(ref["full_budget"])
        cfg = at.solvers.ProxDDPConfig(**{**panda_reach.SOLVE_OPTIONS, "max_iters": budget})
        counts, out = nonlinear_run(
            "panda_mjcf", lambda dev, n: panda_problem(path, dev, n), cfg, PANDA_BATCH,
            panda_launches, PANDA_CPU_SCENARIOS, profile=True,
            profile_iters=PANDA_PROFILE_ITERS, cpu_refs=cpu_refs.get()["panda_mjcf"],
            keep=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = out.pop("result")
    jax_n = int(ref["full_conv"].sum())
    card_n = int(out["conv"][:n_jax].sum())
    print(f"[panda_mjcf] converged on the first {n_jax} within {budget} iterations: card "
          f"{card_n}, JAX {jax_n} (floor {jax_n - 1}); JAX's iterations "
          f"{ref['full_num_iters'].tolist()}, the card's {out['num_iters'][:n_jax].tolist()}")
    check(card_n >= jax_n - 1, f"panda: {card_n} of {n_jax} converged, JAX {jax_n}")
    conv = out["conv"]
    clear = {f: post_clearance(solved, res.xs, f).cpu() for f in ("ee", "elbow")}
    _, p_f = rbd.frame_placement(solved, res.xs[:, -1, :solved.nq], solved.frame_id("ee"))
    err = (p_f - torch.tensor(panda_reach.P_TARGET, dtype=p_f.dtype, device=p_f.device)
           ).norm(dim=-1).cpu()

    def over_conv(t, fn):
        return float(fn(t[conv])) if bool(conv.any()) else float("nan")

    print(f"[panda_mjcf] least clearance to the post (the constraint keeps it >= 0): flange "
          f"{float(clear['ee'].min()):.3e} m, elbow {float(clear['elbow'].min()):.3e} m over "
          f"the batch ({over_conv(clear['ee'], torch.min):.3e}, "
          f"{over_conv(clear['elbow'], torch.min):.3e} over the converged); the final flange "
          f"error: median {float(err.median()):.3e} m, largest {float(err.max()):.3e} m, "
          f"largest over the converged {over_conv(err, torch.max):.3e} m")
    out.update(first_converged=card_n, jax_first_converged=jax_n, budget=budget,
               clearance_flange_min=float(clear["ee"].min()),
               clearance_elbow_min=float(clear["elbow"].min()),
               final_flange_err_median=float(err.median()),
               final_flange_err_max=float(err.max()), model_table_err=max(errs.values()))
    del out["conv"], out["num_iters"], res
    return counts, out


# ---------------------------------------------------------------- phase 17

MESH_RANKS = 4
MESH_BATCH = 4096  # a rank's scenarios (the world of one solves one such chunk)
MESH_PIT = (511, 36, 12)  # bench_scaling.py's medium dims: N, nx, nu; 4 legs
MESH_MU = 1e-3
MESH_KKT_TOL = 1e-3
# a rank's controls against one process solving the same chunk; against one
# process solving the whole batch they part as the batch's size changes the
# fp32 rounding (8.25e-4 at each rank's chunk on an H100, with every
# iteration count equal), so there they are held to MESH_BATCH_TOL, which
# scenarios swapped between ranks (differences of order 1) would fail
MESH_TRAJ_TOL = 1e-6
MESH_BATCH_TOL = 1e-2
MESH_TIMEOUT_S = 300


def mesh_se2():
    """bench_scaling.py's batched SE(2) problem and options (N = 50, fp32,
    4 × 4 budget, linear rollout) and a ``solve_batch`` for
    ``parallel.batched_solve``: the controls and iterations of a batch of
    initial states."""
    import aligator_tpu_torch as at
    from aligator_tpu_torch.examples.se2_car import create_se2_problem

    cfg = at.solvers.ProxDDPConfig(tol=1e-3, mu_init=1e-3, max_iters=4, max_al_iters=4,
                                   rollout="linear", ls_max_steps=6)
    problem = create_se2_problem(nsteps=NSTEPS, dtype=torch.float32, device="cuda")

    def solve_batch(x0s):
        res = at.solvers.solve(dataclasses.replace(problem, x0=x0s), cfg)
        return res.us, res.num_iters, res.newton_steps

    return solve_batch


def mesh_x0s(batch):
    """bench_scaling.py's initial states (numpy in place of jax.random):
    x = 0.7 + 0.2 N(0, 1), y = -0.1, heading 0.15355."""
    x = 0.7 + 0.2 * np.random.default_rng(SEED + 60).standard_normal(batch)
    th = np.full(batch, 0.15355)
    return np.stack([x, np.full(batch, -0.1), np.cos(th), np.sin(th)], -1).astype(np.float32)


def mesh_pit_problem():
    from aligator_tpu_torch.gar import lqr_problem

    N, nx, nu = MESH_PIT
    return lqr_problem.random_convex_problem(np.random.default_rng(SEED + 61), 1, N, nx, nu,
                                             0, dtype=torch.float32, device="cuda")


def _mesh_timed(fn):
    """``fn()`` once to warm up (its trial graphs captured), then counted:
    launches and collectives from 0, the plain versions raising; returns
    ``(out, ms, launches, collectives, host copies)``."""
    from aligator_tpu_torch.parallel import mesh

    fn()
    torch.cuda.synchronize()
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
    with plain_versions_raise():
        reset_counts()
        mesh.COLLECTIVES.clear()
        mesh.HOST_COPIES.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = launch_counts()
    return out, ms, launches, dict(mesh.COLLECTIVES), dict(mesh.HOST_COPIES)


def mesh_rank(rank, world, init_file, out_dir):
    """A rank of the gloo world that shares the card (spawned by
    :func:`mesh_phase`): its chunk of the batched SE(2) solve and its leg of
    the sharded LQ solve, each counted, saved for the main process. It
    builds nothing: a missing library fails the rank."""
    from aligator_tpu_torch import _build
    from aligator_tpu_torch.gar import parallel as gar_parallel
    from aligator_tpu_torch.parallel import mesh
    from aligator_tpu_torch.solvers.proxddp import TrialGraphWarning

    def refuse(variants):
        missing = [v for v in variants if not _build._library_path(_build.variant(v)).exists()]
        raise RuntimeError(f"rank {rank} would build {missing}: the build phase builds")

    _build.build = refuse
    torch.set_num_threads(2)  # four ranks on the host's eight cores
    warnings.simplefilter("error", TrialGraphWarning)
    torch.cuda.set_device(0)
    torch.distributed.init_process_group("gloo", init_method=f"file://{init_file}",
                                         rank=rank, world_size=world)
    try:
        bm = mesh.make_mesh(device="cuda:0")
        solve_batch = mesh_se2()
        x0s = torch.tensor(mesh_x0s(world * MESH_BATCH))
        out, ms, launches, coll, copies = _mesh_timed(
            lambda: mesh.batched_solve(solve_batch, x0s, mesh=bm))
        steps = int(out[2][rank * MESH_BATCH:(rank + 1) * MESH_BATCH].max())
        res = dict(batch=dict(us=out[0].cpu(), num_iters=out[1].cpu(), ms=ms,
                              launches=launches, collectives=coll, host_copies=copies,
                              steps=steps))
        tm = mesh.make_mesh(("t",), device="cuda:0")
        prob = mesh_pit_problem()
        legs, ms, launches, coll, copies = _mesh_timed(
            lambda: gar_parallel.solve_sharded(prob, MESH_MU, MESH_MU, tm,
                                               assume_explicit=True))
        res["pit"] = dict(legs=[t.cpu() for t in legs], ms=ms, launches=launches,
                          collectives=coll, host_copies=copies)
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def mesh_phase(card):
    """The mesh helpers and the sharded parallel-in-time solve over
    ``torch.distributed``: (i) a world of one on NCCL, the backend four
    cards would use: ``batched_solve`` of bench_scaling.py's SE(2) problem
    at MESH_BATCH scenarios; (ii) MESH_RANKS gloo processes sharing the card
    (NCCL takes one rank a GPU): ``batched_solve`` at MESH_RANKS ×
    MESH_BATCH, each rank's launches, iterations and controls against one
    process solving its chunk and one solving the whole batch (whose fp32
    rounding differs with the batch's size), and ``solve_sharded`` at
    bench_scaling.py's medium dims (4 legs, fp32, B = 1) against the serial
    solve on the card (KKT in fp64), one all-gather a rank. Ranks sharing
    one card measure the code path, not scaling across cards."""
    import torch.multiprocessing as tmp

    from aligator_tpu_torch.gar import lqr_problem, riccati
    from aligator_tpu_torch.parallel import mesh

    out, counted = {}, []
    solve_batch = mesh_se2()
    with tempfile.TemporaryDirectory() as d:
        # (i) the world of one on NCCL
        torch.distributed.init_process_group("nccl", init_method=f"file://{d}/nccl",
                                             rank=0, world_size=1)
        try:
            bm = mesh.make_mesh(device="cuda:0")
            check(torch.distributed.get_backend(bm.group("batch")) == "nccl", "not NCCL")
            x0s = torch.tensor(mesh_x0s(MESH_BATCH))
            one, ms1, launches1, coll1, copies1 = _mesh_timed(
                lambda: mesh.batched_solve(solve_batch, x0s, mesh=bm))
        finally:
            torch.distributed.destroy_process_group()
        counted.append(launches1)
        want = collections.Counter(("all_gather", 1, (1,) + tuple(t.shape)) for t in one)
        check(coll1 == want and not copies1,
              f"NCCL world of one: collectives {coll1}, copies {copies1}")
        check(launches1["fused_riccati"] >= 1 and sum(launches1.values())
              == launches1["fused_riccati"], f"NCCL world of one: launches {launches1}")
        print(f"[mesh] NCCL world of one, SE(2) B={MESH_BATCH}: {ms1:.1f} ms a batched "
              f"solve, launches {launches1}, collectives {coll1} ({card})")

        # (ii) the gloo world sharing the card, while this process waits
        ctx = tmp.start_processes(mesh_rank, args=(MESH_RANKS, f"{d}/gloo", d),
                                  nprocs=MESH_RANKS, join=False, start_method="spawn")
        try:
            deadline = time.monotonic() + MESH_TIMEOUT_S
            while not ctx.join(timeout=1):
                check(time.monotonic() < deadline, f"the gloo world ran past {MESH_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        ranks = [torch.load(f"{d}/rank{r}.pt") for r in range(MESH_RANKS)]

    # the one-process references on the card: the whole batch, each rank's
    # chunk alone, the serial LQ
    B = MESH_RANKS * MESH_BATCH
    x0s = torch.tensor(mesh_x0s(B), device="cuda")
    whole, ms_whole, launches_whole, _, _ = _mesh_timed(lambda: solve_batch(x0s))
    counted.append(launches_whole)
    us_ref, iters_ref, steps_ref = (t.cpu() for t in whole)
    chunk_gaps, batch_gaps = [], []
    for r, res in enumerate(ranks):
        b = res["batch"]
        chunk = slice(r * MESH_BATCH, (r + 1) * MESH_BATCH)
        alone = solve_batch(x0s[chunk])
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want["fused_riccati"] = int(alone[2].max())
        check(b["launches"] == want and b["steps"] == want["fused_riccati"],
              f"rank {r}: launches {b['launches']}, Newton steps {b['steps']}, want {want}")
        check(torch.equal(b["num_iters"], iters_ref), f"rank {r}: iterations differ")
        check(bool(torch.isfinite(b["us"]).all()), f"rank {r}: non-finite controls")
        chunk_gaps.append((b["us"][chunk] - alone[0].cpu()).abs().max().item())
        batch_gaps.append((b["us"] - us_ref).abs().max().item())
        check(chunk_gaps[-1] <= MESH_TRAJ_TOL and batch_gaps[-1] <= MESH_BATCH_TOL,
              f"rank {r}: controls {chunk_gaps[-1]:.3e} from one process solving its chunk, "
              f"{batch_gaps[-1]:.3e} from one process solving all {B}")
        want = collections.Counter(("all_gather", MESH_RANKS, (MESH_RANKS, MESH_BATCH)
                                    + tuple(t.shape[1:])) for t in whole)
        check(b["collectives"] == want, f"rank {r}: collectives {b['collectives']}")
    ms_ranks = [res["batch"]["ms"] for res in ranks]
    gaps = max(batch_gaps)
    print(f"[mesh] gloo world of {MESH_RANKS} on one card, SE(2) B={B}: {max(ms_ranks):.1f} "
          f"ms a batched solve (ranks {[round(m, 1) for m in ms_ranks]}), launches a rank "
          f"{ranks[0]['batch']['launches']}; each rank's controls within "
          f"{max(chunk_gaps):.2e} of one process solving its chunk (tol {MESH_TRAJ_TOL:g}), "
          f"within {[f'{g:.2e}' for g in batch_gaps]} of one process solving the {B} "
          f"(tol {MESH_BATCH_TOL:g}; {ms_whole:.1f} ms, launches {launches_whole}), "
          f"iterations equal; ranks sharing one card measure the code path, not scaling "
          f"({card})")

    N, nx, nu = MESH_PIT
    prob = mesh_pit_problem()
    serial, ms_serial, launches_serial, _, _ = _mesh_timed(
        lambda: riccati.solve(prob, MESH_MU, MESH_MU, True))
    counted.append(launches_serial)
    legs = [torch.cat([res["pit"]["legs"][k] for res in ranks], 1) for k in range(4)]
    p64 = prob.map(lambda t: t.cpu().double())
    kkt = {name: max(e.max().item() for e in lqr_problem.kkt_error(
        p64, *(t.cpu().double() for t in sol), MESH_MU, MESH_MU))
        for name, sol in (("sharded", legs), ("serial", serial))}
    L = (N + 1) // MESH_RANKS
    payload = (MESH_RANKS, 1, 4 * nx * nx + 2 * nx)
    for r, res in enumerate(ranks):
        pit = res["pit"]
        check(pit["collectives"] == {("all_gather", MESH_RANKS, payload): 1},
              f"rank {r}: the sharded solve's collectives {pit['collectives']}")
        check(pit["host_copies"] == {("to_host", payload[1:]): 1, ("to_device", payload): 1},
              f"rank {r}: host copies {pit['host_copies']}")
        want = dict.fromkeys(KERNEL_NAMES, 0)  # the leg's θ sweep: K2 twice a stage
        want.update(spd_solve=2 * (L - 1), fused_stage_forward=1)
        check(pit["launches"] == want, f"rank {r}: sharded launches {pit['launches']}")
    check(kkt["sharded"] <= MESH_KKT_TOL, f"sharded KKT {kkt['sharded']}")
    ms_pit = [res["pit"]["ms"] for res in ranks]
    print(f"[mesh] solve_sharded N={N} ({nx}, {nu}) fp32 B=1, {MESH_RANKS} legs on one card: "
          f"{max(ms_pit):.1f} ms a solve (ranks {[round(m, 1) for m in ms_pit]}), launches a "
          f"rank {ranks[0]['pit']['launches']}, one all-gather of {payload} a rank; serial "
          f"on the card {ms_serial:.2f} ms (launches {launches_serial}); KKT in fp64 sharded "
          f"{kkt['sharded']:.3e}, serial {kkt['serial']:.3e} (bound {MESH_KKT_TOL:g}) ({card})")
    out = dict(nccl_world_of_one=dict(batch=MESH_BATCH, ms=ms1, launches=launches1),
               gloo_world=dict(ranks=MESH_RANKS, batch=B, ms=max(ms_ranks), rank_ms=ms_ranks,
                               one_process_ms=ms_whole, chunk_gaps=chunk_gaps,
                               batch_gaps=batch_gaps),
               sharded=dict(N=N, nx=nx, nu=nu, legs=MESH_RANKS, ms=max(ms_pit),
                            rank_ms=ms_pit, serial_ms=ms_serial, kkt=kkt))
    return counted, out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    # fails outside the repository
    from aligator_tpu_torch.solvers.proxddp import TrialGraphWarning

    # a nonlinear trial that falls back to eager execution fails the run
    warnings.simplefilter("error", TrialGraphWarning)

    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        phase_s[name] = time.perf_counter() - t0
        print(f"[time] {name} {phase_s[name]:.1f} s (script {time.perf_counter() - t_start:.1f} s)")
        return out

    smi = timed("device", device_phase)
    late = timed("build", build_phase)
    cpu_refs = FreeCpuRefs()
    try:
        k1, k1_times = timed("K1", kernel_phase)
        k2, k2_extra = timed("K2", k2_phase)
        k3, k3_extra = timed("K3", k3_phase)
        k4, k4_shapes = timed("K4", k4_phase)
        k5, k5_extra = timed("K5", k5_phase)
        k6, k6_extra = timed("free_fd", free_fd_phase)
        se2_counts, result = timed("se2", slice_phase)
        medium_counts, medium = timed("medium", medium_phases)
        talos_counts, talos = timed("talos", talos_phases)
        pit_counts, pit = timed("parallel-in-time", lambda: parallel_in_time_phases(
            medium["humanoid"]["solves_per_sec"], smi))
        cart_counts, cart = timed("cartpole", cartpole_phases)
        inv_counts, inv = timed("inverse-lqr", lambda: inverse_lqr_phase(smi))
        sens_counts, sens = timed("sensitivity", lambda: sensitivity_phase(smi))
        # late, so that the background builds (one to two minutes of nvcc
        # each beside the CPU reference worker) have ended
        timed("K1 slow shapes", lambda: k1_slow_phase(late))
        free_counts, free = timed("free-dynamics", lambda: free_phase(cpu_refs))
        contact_counts, contacts = timed("contact", lambda: contact_phase(cpu_refs))
        table_counts, table = timed("ur5-table", lambda: table_phase(cpu_refs))
        mpc_counts, mpc = timed("mpc", lambda: mpc_phase(smi))
        cent_counts, cent = timed("centroidal", lambda: centroidal_phase(smi))
        panda_counts, panda = timed("panda-mjcf", lambda: panda_mjcf_phase(cpu_refs))
        mesh_counts, mesh_out = timed("mesh", lambda: mesh_phase(smi))
    finally:
        cpu_refs.stop()
        late.thread.join()
    # each kernel's launches: the sum over the paths' counted runs
    runs = [se2_counts, *medium_counts.values(), *talos_counts.values(), *pit_counts,
            *cart_counts.values(), inv_counts, *sens_counts, *free_counts.values(),
            *contact_counts.values(), table_counts, *mpc_counts, *cent_counts, panda_counts,
            *mesh_counts]
    for k in (k1, k2, k3, k4, k5, k6):
        k["launches"] = sum(c[k["name"]] for c in runs)
    print(json.dumps({"slice": result, "fused_riccati": k1_times,
                      "medium": medium, "medium_launches": medium_counts,
                      "talos": talos, "talos_launches": talos_counts,
                      "parallel_in_time": pit, "cartpole": cart,
                      "cartpole_launches": cart_counts, "inverse_lqr": inv,
                      "sensitivity": sens, "free_dynamics": free,
                      "free_dynamics_launches": free_counts, "contact": contacts,
                      "contact_launches": contact_counts, "ur5_table": table,
                      "ur5_table_launches": table_counts, "mpc": mpc,
                      "centroidal": cent, "panda_mjcf": panda,
                      "panda_mjcf_launches": panda_counts, "mesh": mesh_out,
                      "mesh_launches": mesh_counts,
                      "spd_solve": k2_extra, "fused_stage_sweep": k3_extra,
                      "fused_stage_forward": k4_shapes,
                      "fd_rows": k5_extra, "free_fd": k6_extra, "phase_s": phase_s,
                      "script_s": time.perf_counter() - t_start,
                      "card": smi}))
    print(smi)
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
