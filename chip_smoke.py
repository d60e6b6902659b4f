"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. device and toolchain: nvidia-smi name and power limit, torch, CUDA,
     nvcc versions; exits at once without a CUDA device;
  2. nvcc build of hqp_tpu_torch/csrc into build/hqp_tpu_torch/;
  3. kernel K1 (batched pivoted Gauss-Jordan) against its plain twin, at
     the main path's shape and at edge shapes (s = 124, P = 1);
  4. kernel K2 (batched block-Thomas) against its plain twin, at the main
     path's shape and at edge shapes (N = n = 1; n = 8; a system large
     enough to stream through the kernel's chunk ring; n = 3, the block of
     phase 19's SFunctionOpt-1000);
  5. at the main path's shapes: each kernel's time per launch (CUDA events
     around 50 back-to-back launches, median of 5 such runs), its mean
     device time per launch from a torch.profiler trace of 50 launches,
     its single-launch event time (median of 20, the measure of earlier
     runs), its plain twin's time, its library yardstick's time (one torch
     call the port never makes) and its bound from bytes and FLOPs;
  6. SqpPowell(PrgDID(kmax=60)) on the card: optimal at 98.4;
  7. SqpPowell(PrgDID(kmax=1000)) on the card, init/simulate/solve cold
     then warm: optimal at the reference objective, with both kernels'
     launch counts, host syncs per IP iteration and solve times;
  8. K1's routes against the twin: the large (cluster) kernel at s = 152,
     the first large size at b = 10, at s = 245 (f64 and f32, with and
     without a forced row swap, and a batch of 3 clusters) and at s = 512
     (f64 at P = 2 and f32), Minv equal to the last bit; the register
     kernel at the crane's s = 124, b = 12; each case checks the route it
     took and that route's launch counter and prints the cluster size;
     the wrapper's copy of the cluster kernel's shared-memory layout
     against the kernel's own;
  9. the measures of phase 5 at this slice's shapes: the register kernel at
     P = 100, s = 124, b = 12 (the crane's interior at 1000 stages), the
     large kernel at P = 1, s = 245, b = 10 (CranePar's interior) and at
     P = 2, s = 512, K2 at N = 101, n = 6; the cluster kernel's device
     time at each cluster size (4, 8, 16) at s = 245 and at the crane's
     P = 5, s = 124, b = 12 (for the record: that size takes the register
     kernel);
 10. one f64 factor+solve link of PartitionedKKT(L=10) on bench.py's
     nx6-1000 stage QP (the crane's block sizes at 1000 stages), gated on
     its KKT residual, with ms per link;
 11. SqpPowell(PrgCrane(K=50)), init/simulate/solve: optimal at the
     reference objective, with the launches of K1 by route and of K2 and
     host syncs per IP iteration;
 12. BatchReactor, Bio, TP383omu, HS99omu and CranePar (init/solve), each
     optimal at its reference objective; CranePar's interior (s = 245)
     must go through the large K1 kernel, 20 launches a solve;
 13. the KKT oracles on DID-1000's KKT system (bench.py's build_kkt: the
     first QP at Q = 1e-2 I, z = w = 1): one f64 factor+solve link each
     of PartitionedKKT(L=10), RiccatiKKT and FullStageKKT, gated at KKT
     residual < 1e-6, the oracles' dx within 1e-8 (relative) of the
     partitioned one, with ms per link;
 14. DenseKKT on the first KKT system of PrgLQBlend(n=2000) (the first
     QP, z = w = 1, Mehrotra's cold-start right-hand side), gated at KKT
     residual < 1e-10, with ms per factor+solve;
 15. the exchangeable modules: TP383, Maratos and HS99 by seven pairings
     (Powell with BFGS, DScale, Gerschgorin, AugBFGS, Gangster, with the
     Franke QP solver, and Schittkowski), and DID-60 and DID-1000 by
     Powell with Franke and by Schittkowski (K1 and K2 launches > 0),
     each held to the JAX package's CPU f64 verdict, SQP and IP counts
     and objective (REF_ALT; the objective of DID-1000 with Franke, which
     fails in both packages, within FAILED_F_RTOL); the two chaotic TP383
     failures as REF_CHAOTIC says;
 16. the five generated families in solve_generated's configuration but
     on the dense path, SqpPowell(..., kkt_backend=DenseKKT()), on the card
     (LQBlend at n = 2000, the others at n = 1000): optimal with
     norm_inf < 1e-6 at the JAX package's objective (REF_FAMILIES), but
     Catena, whose dense saddle matrix is singular, degenerate at its
     first QP; wall ms and host syncs per IP iteration per solve;
 17. the scenario batch (BASELINE config 5): PrgDID(kmax=60) and the
     port's 256 draws (seed 0, scale 1e-3, checked against the checksum
     the CPU tests record), presolved at tau = 0.02 and solved by
     make_scenario_solve with Mehrotra(PartitionedKKT(L=20), eps=1e-9),
     cold then warm: every scenario's verdict and IP count equal to the
     JAX package's unbatched solves of the same draws (REF_SCEN), the
     largest original-row violation within 1e-9 of the reference's, 8
     scenarios (the fastest and the slowest among them) equal to the
     port's own unbatched solves on the card, one K1 launch on all 768
     interiors per batched factorization and K2 on all 256 masters; the
     batch's solve ms, QP solves/s, IP iterations/s and host syncs per
     batched IP iteration; then K1 and K2 on the batch's own inputs
     against their twins and timed as in phase 5, with their library
     yardsticks (torch.linalg.inv on [768, 98, 98]; a dense
     torch.linalg.solve of the 256 assembled [8, 8] masters);
 18. the host-sparse slice, every QP on the card and every KKT system
     factored on the host: (a) the g++ build of the host library and its
     seconds; (b) the five families through solve_generated
     (SparseCallbackKKT) in the order of the reference's record, each at
     the JAX package's verdict, objective and SQP and IP counts
     (REF_FAMILIES), Catena at REF_CATENA's verdict and counts with its
     objective over the first SQP iterations; (c) the seven files of
     tests/sif through solve_sif (SparseHostKKT), each at REF_SIF's
     verdict, counts and objective and at its published optimum; (d) TP383
     through SparseHostKKT and FullSparseBKPKKT (with the BKP's pinned
     pivots) and (e) SeparablePairs with SparseBFGS, each at REF_HOST; (f)
     every QP tensor and iterate of (b)-(e) on the card; (g) a warm LQBlend
     n = 2000 solve: wall ms, host factor and host solve ms, bytes each way
     and host syncs per IP iteration, beside phase 16's DenseKKT solve;
 19. the user-model slice (USER_CASES), every QP on the card and every
     hosted model evaluated on the host: the cc builds of the demo
     S-functions and the test FMU; (a) the rest of the odc suite at the
     reference's sizes (DID_SFunction kmax = 60, DIC, DIC_SFunction and
     DIC_FMU at K = 20, beside the native DID-60), (b) the hosted path at
     K = 1000 (DID_SFunction with qp_eps = 1e-7 and SFunctionOpt, that is
     DynamicOpt over the hosted sfun_dic with u_order = 1 and slack
     controls; K1 and K2 must launch), (c) DynamicOpt in the layouts of
     tests/test_dynamic_opt2.py, DynamicEst with its confidence intervals,
     DTOpt over the hosted sfun_did and DTEst: each at the JAX package's
     verdict and SQP/IP counts with f within 1e-8 (REF_HOSTED,
     REF_CONFIDENCE), each hosted program at its native twin's f; per
     solve the wall time, the host-callback time, the bytes each way per
     SQP iteration, the host syncs per IP iteration and the launches;
     then K1 and K2 on the first inputs the cases gave them at each shape
     and dtype, against their plain twins;
 20. the rest of the Omuses integrators and Mehrotra's non-default knobs,
     every QP on the card: (a) SqpPowell(PrgCrane(K=50, integrator=
     Dopri5())), init/simulate/solve, cold then warm; (b) PrgBio under
     SDIRK, BDF, BDF(krylov=True), GRK4, GRK4Adaptive, IMPAdaptive,
     BDFAdaptive and BDFVarOrder; (c) PrgDIC(K=20) under RKsuite(method=2),
     RKF78 and OdeTs (INTEG_CASES); (d) DID-1000 with qp_eps = 1e-7 by
     Mehrotra with init_method 1, 2, 3, mod_terlaky, gondzio_correctors=2
     and cheap_predictor over PartitionedKKT (KNOB_CASES): each at the JAX
     package's verdict and SQP/IP counts with f within 1e-8 (REF_INTEG,
     REF_KNOBS); per solve the wall time, K1's launches by route and K2's,
     the host syncs per IP iteration and, for the adaptive integrators,
     the loop iterations and host reads per make_qp; K1 and K2 launched
     in every case; then K1 and K2 on the first inputs the cases gave them
     at each shape and dtype, against their plain twins.  The Crane and
     the Bio cases (INTEG_PARALLEL, host-bound) run in INTEG_WORKERS
     spawned processes on the same card while the main one runs (c) and
     (d), so their walls are taken beside one another; each worker holds
     the kernels against their twins on its own case's first inputs;
 21. the shell slice, every program made by hqp_tpu_torch.shell.Shell on
     the card: (a) the README's quick start (DID-60) and DID-1000 through
     ``prg_name DID; prg_kmax 1000; qp_eps 1e-7; ...; hqp_solve``
     (SHELL_SCRIPTS), (b) five hqp_solve_hot steps of that DID-1000 after
     ``set_pinned`` of the new initial states HOT_X0, each x0 honoured
     exactly, the hot wall times beside the cold one, (c) the Crane through
     the shell with its .plt file written and read back, and a checkpoint
     of it after CKPT_ITERS SQP iterations resumed in a fresh shell's
     solver that shares no storage with the saver, (d) DID-1000 with
     ``sqp_qp_solver Client``, the worker solving on the card (its K1 and
     K2 launches, the bytes each way and the transport ms per QP), (e)
     IntDemoT through the shell's mip_solve and the seeded MIQP by
     BranchBound on the card, (f) prg_test and prg_qp_dump/qp_load on the
     solved DID-1000: each at the JAX package's verdict, SQP/IP counts and
     f within 1e-8 (REF_SHELL, REF_HOT, REF_CLIENT, REF_MIP: status,
     integers and node count exact), per solve the wall time, host syncs
     per IP iteration and K1/K2 launches (both launched in every solve of
     (a)-(c)); (g) K1 and K2 on the first inputs (a) and (b) gave them,
     against their plain twins;
 22. the MEX and Simulink-coder hosts and the sharded KKT backend: (a) the
     demo S-function csrc/hxi_simulink/sfun_did_demo.c built both ways (the
     cg_sfun build and the MEX build, which exports mexFunction alone) and
     the MEX host library, under build/, driven alike to the last bit; (b)
     DID_MEX at K = 60 and 1000 (MEX_CASES: DID through the MEX build, its
     parameter as MATLAB-style text), every QP on the card, each at the
     JAX package's verdict and SQP/IP counts with f within 1e-8 (REF_MEX),
     DID_MEX-1000 at DID-1000's f within 1e-6, K1 and K2 launched and held
     against their twins on the case's first inputs; (c) DID-1000 with
     qp_mat_solver SpSCdist (ShardedPartitionedKKT over a one-rank nccl
     group made without a launcher) at the JAX package's SpSCdist verdict,
     SQP/IP counts and f within 1e-8 (REF_SHARD), K1 on its [50, 98, 98]
     interiors and K2 on its master held against their twins, both timed
     there as in phase 5; (d) per solve the wall time, the host-callback
     time, host syncs per IP iteration, launches and collectives;
 23. PartitionedKKT's reference keywords and SpSCdist's other layout on
     DID-1000 with qp_eps = 1e-7, each at the JAX package's verdict, SQP/IP
     counts and f within 1e-8 (REF_KKT_KNOBS, REF_SHARD_REP): (a) gj="xla"
     (the library inverse by the caller's word: K1 launched 0 times, K2 as
     often as in phase 7 at the same IP count), (b) refine_relative=False,
     refine_rounds=2, reg_corr_rounds=1 (KKT_KNOB_CASES; K1 once per
     factorization), (c) SpSCdist with full_shard=False at world size 1
     (K1 once per factorization on the rank's [50, 98, 98] interiors; its
     collectives per solve beside phase 22 (c)'s); K1 and K2 held against
     their twins on the first inputs the cases gave them; (d)
     thomas_solve_scaled (one K2 launch) against its plain twin within
     3e-16 relative at SCALED_SHAPES (DID-1000's master N = 101, n = 2 and
     the crane's n = 6), timed as in phase 5;
 24. K1's batched route (csrc/gj_interior_batch.cu): (a) the wrapper's
     copies of both register kernels' shared-memory layouts against the
     kernels'; (b) hold_batch_route at BATCH_CASES (s = 5, 48, 97, 98;
     one to 1,000 interiors; f64 and f32; interiors that pivot at every
     step, a tie and a NaN column), the checks of
     tests/test_torch_kernels.py's card test: Minv equal to the tile
     kernel's and the twin's to the last bit, W and Schur to the tile
     kernel's (and within KERNEL_RTOL of the twin's), one launch in
     LAUNCHES and LAUNCHES_BATCH; then the same at every s the route
     takes to the batched kernel (1 to 98, three interiors); (c) at
     BATCH_SHAPES and BATCH_SWEEP, the route the rule takes, both
     register routes' time a launch (CUDA events around back-to-back
     launches, median of 5) and bound, their outputs equal to the last
     bit, and each kernel's resident interiors an SM, registers and
     spilled bytes (the CUDA runtime's occupancy query and function
     attributes; phase 2 prints ptxas's).
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from hqp_tpu_torch.prof_did1000 import SFUNCTION_OPT

#: DID-1000 objective of the JAX reference package on a CPU host in f64:
#: SqpPowell(PrgDID(kmax=1000), max_iters=50, qp_eps=1e-7) after
#: init/simulate/solve -> "optimal" in 1 SQP and 27 IP iterations
REF_F_DID1000 = 88.91363105840026
#: bench.py's acceptance window for the DID-1000 objective
BENCH_F_DID1000, BENCH_TOL = 88.9064, 1e-2
#: DID-1000's IP iterations (the reference's count) and the port's K1 and
#: K2 launches in one solve: one K1 launch per factorization, about 40 K2
#: launches per IP iteration
DID1000_COUNTS = (27, 28, 1074)
#: the card's published peaks (NVIDIA H100 SXM data sheet): memory rate
#: in bytes/s and the dense FP64 tensor-core rate in FLOP/s (FP32 outside
#: the tensor cores runs at the same 67 TFLOP/s)
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.float64: 67e12, torch.float32: 67e12}
#: the QP tolerance of every recorded reference DID-1000 run: with the
#: default 1e-9 the f64 interior point stalls at mu ~ 3.6e-9 on
#: SIGMA_CAP-capped rows and the SQP raises "subiters", in the reference
#: package and in the port alike (ROADMAP Q3 R7; PERF.md gives the
#: reference's command and output, and phase 4 of
#: ``python -m hqp_tpu_torch.prof_did1000`` shows the port's on the card)
QP_EPS_DID1000 = 1e-7
#: the odc suite's objectives, SQP and IP iterations in the JAX reference
#: package on a CPU host in f64: SqpPowell(prg, max_iters=100), init(),
#: solve() with each program's default arguments (Crane: K=50; the
#: port's Crane drive adds simulate(), which keeps the same optimum)
REF_OMU = {
    "Crane": (11.675123552118006, 6, 98),
    "BatchReactor": (-0.5734788463825502, 9, 44),
    "Bio": (-6.880796996428104, 15, 131),
    "TP383omu": (728593.645954019, 8, 77),
    "HS99omu": (-831079891.5623015, 6, 31),
    "CranePar": (0.017026127127584032, 6, 13),
}
#: objective tolerance of the suite's drives (relative)
OMU_RTOL = 1e-6
#: CranePar's large-route K1 launches in one solve (one a factorization)
CRANEPAR_LARGE = 20
#: the large K1 kernel's W and Schur against the twin's (relative): sums in
#: another order; its Minv must equal the twin's to the last bit
LARGE_WS_TOL = {torch.float64: 1e-14, torch.float32: 1e-6}
#: the device of phases 13-18 (a CPU run of those phases alone rehearses
#: them up to phase 17's kernel timings; main() needs the card)
DEVICE = "cuda"
#: the exchangeable modules in the JAX reference package on a CPU host in
#: f64 (verdict, f, SQP and IP iterations): the NLP suite by init(),
#: solve() with max_iters=120, DID by init(), simulate(), solve() with
#: max_iters=50, qp_eps=1e-7 (reference_values() in tests/test_torch_sqp.py)
REF_ALT = {
    ("TP383", "BFGS"): ("optimal", 728593.6459679933, 50, 536),
    ("TP383", "AugBFGS"): ("optimal", 728593.6459679933, 50, 536),
    ("TP383", "Gangster"): ("optimal", 728593.6459591711, 45, 443),
    ("TP383", "Franke"): ("optimal", 728593.6459821286, 48, 263),
    ("TP383", "Schittkowski"): ("optimal", 728593.6459679933, 50, 536),
    ("Maratos", "BFGS"): ("optimal", -0.9999999969273417, 45, 45),
    ("Maratos", "DScale"): ("optimal", -0.9999928114822518, 43, 43),
    ("Maratos", "Gerschgorin"): ("optimal", -0.9999928114822518, 43, 43),
    ("Maratos", "AugBFGS"): ("optimal", -0.9999999969273417, 45, 45),
    ("Maratos", "Gangster"): ("optimal", -0.9999945594225979, 43, 44),
    ("Maratos", "Franke"): ("optimal", -0.9999999969273417, 45, 45),
    ("Maratos", "Schittkowski"): ("optimal", -0.9999999162580193, 10, 11),
    ("HS99", "BFGS"): ("optimal", -831079891.5102032, 8, 18),
    ("HS99", "DScale"): ("optimal", -831079891.5101134, 13, 28),
    ("HS99", "Gerschgorin"): ("optimal", -831079891.5101076, 4, 8),
    ("HS99", "AugBFGS"): ("optimal", -831079891.5102032, 8, 18),
    ("HS99", "Gangster"): ("optimal", -831079891.510132, 10, 22),
    ("HS99", "Franke"): ("optimal", -831079891.5102032, 8, 36),
    ("HS99", "Schittkowski"): ("optimal", -831079891.5101099, 8, 18),
    ("DID-60", "Franke"): ("optimal", 98.39997009427306, 1, 50),
    ("DID-60", "Schittkowski"): ("optimal", 98.40000411194269, 1, 21),
    ("DID-1000", "Franke"): ("subiters", 37.376436327761525, 1, 50),
    ("DID-1000", "Schittkowski"): ("optimal", 88.91363105840026, 1, 27),
}
#: the objective tolerance (relative) of a DID pairing that fails in both
#: packages, DID-1000 with Franke (SqpError("subiters") at 1 SQP / 50 IP):
#: Franke's step length collapses to 0.01-0.05 from its 5th step on, and
#: over that stall the two packages' iterates part by up to 2.6e-7
#: relative in x (a step-by-step comparison on a CPU host; ROADMAP Q3 R13),
#: where their end points lie 7.4e-8 (CPU) and 7.5e-8 (card) apart
FAILED_F_RTOL = 1e-6
#: TP383's two failing pairings, chaotic in the reference itself (ROADMAP
#: Q3 R11): (verdict, f, SQP, IP) of the reference's full run, printed
#: beside the port's with the first SQP iteration whose IP count differs,
#: and what is held: for DScale the IP counts of the first SQP iterations
#: (the stretch before iteration 34's step throws x to an infeasibility of
#: 1e12), for Gerschgorin the verdict and the SQP count
REF_CHAOTIC = {
    "DScale": (("infeasible", 13841.692724320856, 113, 865),
               [3, 3, 3, 3, 3, 3, 5, 4, 3, 19, 5, 4, 3, 3, 3, 3, 3, 3, 3,
                3, 5, 3, 6, 7, 7, 6, 5, 5, 3, 21]),
    "Gerschgorin": (("infeasible", 5.060834829680604e-12, 49, 369),
                    ("infeasible", 49)),
}
#: the JAX package's solve_generated (host sparse LDL') on a CPU host, the
#: families in sorted order in one process (host_sparse_reference_values()
#: in tests/test_torch_sqp.py): (n, verdict, f, SQP, IP)
REF_FAMILIES = {
    "lqblend": (2000, "optimal", -199.99707215036685, 2, 5),
    "broydn3d": (1000, "optimal", 1.6917715654089756e-14, 7, 7),
    "bdqrtic": (1000, "optimal", 3983.8179505765397, 9, 10),
    "srosenbr": (1000, "optimal", 1.4319427271097043e-16, 43, 95),
}
#: the same for Catena at n = 1000, which the reference does not solve:
#: (verdict, SQP, IP, f after the QP of each of the first six SQP
#: iterations).  f is held over those alone: from the sixth on it parts
#: exponentially, between the packages and between runs of the reference
#: itself (ROADMAP Q3 R14)
REF_CATENA = ("iters", 200, 200,
              [-127.45117381283265, -128.11393358704416, -178.49838527166335,
               -178.50080909611583, -178.98208915521062, -166.2620994959886])
#: where two runs of the reference's Catena ended (f, norm_inf): the record
#: of reference_values() and that of host_sparse_reference_values()
REF_CATENA_ENDS = ((-23952.442580435672, 1211.0119187742637),
                   (-139.31661153160823, 3.5119834463247625e-06))
#: the JAX package's solve_sif on each file of tests/sif on a CPU host:
#: (verdict, objective, SQP, IP)
REF_SIF = {
    "HS21": ("optimal", -99.95999999999994, 1, 8),
    "HS27": ("optimal", 0.04000000000001431, 32, 33),
    "HS35": ("optimal", 0.1111111111169125, 2, 7),
    "HS6": ("optimal", 2.342559463410134e-15, 2, 2),
    "HS7": ("optimal", -1.732050807570195, 10, 10),
    "HS76": ("optimal", -4.6818181818181825, 2, 8),
    "TAME": ("optimal", 0.0, 1, 2),
}
#: the published optima of those files (tests/test_sif.py:130-142)
SIF_OPTIMA = {"HS21": -99.96, "HS27": 0.04, "HS35": 1.0 / 9.0, "HS6": 0.0,
              "HS7": -1.7320508075, "HS76": -4.681818181, "TAME": 0.0}
#: the JAX package on a CPU host (verdict, f, SQP, IP): TP383 through
#: SqpPowell(max_iters=60, Mehrotra(eps=1e-9, max_iters=50)) with the host
#: sparse LDL' (RedSpBKP_host) and with the sparse BKP (SpBKP), the flows
#: of tests/test_sparse_host.py:40 and tests/test_bkp.py:147; and
#: tests/test_sparse_bfgs.py:83's SeparablePairs with SparseBFGS
REF_HOST = {
    ("TP383", "RedSpBKP_host"): ("optimal", 728593.6459679932, 50, 536),
    ("TP383", "SpBKP"): ("optimal", 728593.6459679933, 50, 536),
    ("SeparablePairs", "SparseBFGS"): ("optimal", 3.5545436955784777e-12,
                                       7, 7),
}


def _decay_record():
    """DynamicEst's measurements (tests/test_formulations.py:75-95): two
    experiments of dx = -1.3 x from x0 = 1 and 2 on 21 points, with seeded
    noise of 1e-3 so that the fit's confidence is not rounding noise."""
    ts = np.linspace(0.0, 1.0, 21)
    x0s = np.array([[1.0], [2.0]])
    ys = np.stack([x0 * np.exp(-1.3 * ts)[:, None] for x0 in x0s])
    ys = ys + 1e-3 * np.random.default_rng(0).standard_normal(ys.shape)
    return dict(ys_meas=ys, K=20, p_init=[0.5], p_min=[0.0], p_max=[10.0],
                x0_init=x0s)


def _decay_dt_record(dt=0.05, K=20):
    """DTEst's measurements: two experiments of the discrete decay
    x+ = (1 - dt p) x at p = 1.3 from x0 = 1 and 2 on 21 points, with
    seeded noise of 1e-3."""
    x0s = np.array([[1.0], [2.0]])
    ks = np.arange(K + 1)
    ys = np.stack([x0 * ((1.0 - dt * 1.3) ** ks)[:, None] for x0 in x0s])
    ys = ys + 1e-3 * np.random.default_rng(1).standard_normal(ys.shape)
    return dict(ys_meas=ys, K=K, dt=dt, p_init=[0.5], p_min=[0.0],
                p_max=[10.0], x0_init=x0s)


#: the double integrator's terminal target in DynamicOpt's knobs
_DIC_TARGET = dict(x0=[1.0, 0.0], yf_ref=[-1.0, 0.0])
#: the user-model slice's solves (phase 19), each SqpPowell(prg, **solver),
#: init(), [simulate()], solve(): name -> (part, prg_name, model, program
#: keywords, solver keywords, simulate).  The model is None for the hosted
#: suite's programs and their native twins DID and DIC, ("DIC",) or ("Decay",) for a model in torch ops, and
#: (S-function, parameter) for a hosted demo S-function.  (a) the rest of
#: the odc suite at the reference's sizes, with the settings of
#: tests/test_hxi.py:135-175; (b) the hosted path at K = 1000; (c) the
#: formulations at the sizes of their JAX tests (tests/test_dynamic_opt2.py,
#: tests/test_formulations.py; dic_target is test_dynamic_opt_dic's problem
#: at K = 20), DTOpt over sfun_did and DTEst over a discrete decay
USER_CASES = {
    "DID": ("a", "DID", None, dict(kmax=60), {}, False),
    "DID_SFunction": ("a", "DID_SFunction", None, dict(kmax=60), {}, False),
    "DIC": ("a", "DIC", None, dict(K=20), {}, False),
    "DIC_SFunction": ("a", "DIC_SFunction", None, dict(K=20), {}, False),
    "DIC_FMU": ("a", "DIC_FMU", None, dict(K=20), {}, False),
    "DID_SFunction-20": ("a", "DID_SFunction", None,
                         dict(kmax=20, with_cns=False), {}, False),
    "DID_SFunction-1000": ("b", "DID_SFunction", None, dict(kmax=1000),
                           dict(max_iters=50, qp_eps=1e-7), True),
    "SFunctionOpt-1000": ("b", "SFunctionOpt", ("sfun_dic", 1.0),
                          dict(SFUNCTION_OPT, K=1000),
                          dict(max_iters=60), False),
    "min_time": ("c", "DynamicOpt", ("DIC",),
                 dict(K=24, x0=[0.0, 0.0], u_min=[-1.0], u_max=[1.0],
                      u_init=[0.5], yf_min=[0.0, 1.0], yf_max=[0.0, 1.0],
                      t_scale=True, t_weight1=1.0), dict(max_iters=80),
                 False),
    "soft_l1": ("c", "DynamicOpt", ("DIC",),
                dict(_DIC_TARGET, K=30, u_weight2=[0.01],
                     yf_weight2=[100.0, 100.0], y_soft_max=[np.inf, 0.02],
                     s_lin=50.0, s_quad=50.0), dict(max_iters=80), False),
    "u_order1": ("c", "DynamicOpt", ("DIC",),
                 dict(_DIC_TARGET, K=20, u_order=1, du_weight2=[1e-4],
                      yf_weight2=[100.0, 100.0]), dict(max_iters=60), False),
    "du_penalty": ("c", "DynamicOpt", ("DIC",),
                   dict(_DIC_TARGET, K=20, u_weight2=[0.01],
                        du_weight2=[0.1], yf_weight2=[100.0, 100.0]),
                   dict(max_iters=60), False),
    "decimation": ("c", "DynamicOpt", ("DIC",),
                   dict(_DIC_TARGET, K=10, decimation=3, u_weight2=[0.01],
                        yf_weight2=[10.0, 10.0]), dict(max_iters=40), False),
    "dic_target": ("c", "DynamicOpt", ("DIC",),
                   dict(_DIC_TARGET, K=20, u_weight2=[0.01],
                        yf_weight2=[100.0, 100.0]), dict(max_iters=60),
                   False),
    "DynamicEst": ("c", "DynamicEst", ("Decay",), _decay_record(),
                   dict(max_iters=60), False),
    "DTOpt": ("c", "DTOpt", ("sfun_did", 0.05),
              dict(_DIC_TARGET, K=20, dt=0.05, u_min=[-20.0], u_max=[20.0],
                   u_weight2=[0.05], yf_weight2=[100.0, 100.0]),
              dict(max_iters=60), False),
    "DTEst": ("c", "DTEst", ("DecayDT",), _decay_dt_record(),
              dict(max_iters=60), False),
}
#: the JAX package's results of USER_CASES on a CPU host in f64 (verdict,
#: f, SQP, IP; hosted_reference_values() in tests/test_torch_sqp.py)
REF_HOSTED = {
    "DID": ("optimal", 98.40000001279562, 1, 24),
    "DID_SFunction": ("optimal", 98.40000001515537, 1, 24),
    "DIC": ("optimal", 104.00000002084506, 1, 12),
    "DIC_SFunction": ("optimal", 104.00000002082722, 1, 12),
    "DIC_FMU": ("optimal", 104.00000002084506, 1, 12),
    "DID_SFunction-20": ("optimal", 104.00000001999743, 1, 12),
    "DID_SFunction-1000": ("optimal", 88.91363107458275, 1, 27),
    "SFunctionOpt-1000": ("optimal", 89.37537709180582, 11, 112),
    "min_time": ("optimal", 1.9999999998851326, 7, 62),
    "soft_l1": ("optimal", 7.948548856296956, 1, 10),
    "u_order1": ("optimal", 2.490989706627088e-15, 1, 1),
    "du_penalty": ("optimal", 0.798642911622061, 4, 9),
    "decimation": ("optimal", 1.1671732522796354, 1, 1),
    "dic_target": ("optimal", 0.7984124995264895, 1, 1),
    "DynamicEst": ("optimal", 2.867511706843285e-05, 4, 13),
    "DTOpt": ("optimal", 3.961421455386295, 1, 4),
    "DTEst": ("optimal", 3.6362376327903574e-05, 4, 12),
}
#: f's tolerance (relative) of phase 19's cases, and of the estimations'
#: estimates and half-widths
USER_F_RTOL = 1e-8
#: the absolute floor of that check, for an optimum at 0 (u_order1's f is
#: 2.5e-15, rounding noise of a zero optimum)
USER_F_ATOL = 1e-12
#: the JAX package's confidence() of the estimation cases of REF_HOSTED:
#: the estimates (v[0, :nx]) and the ~95% half-widths
REF_CONFIDENCE = {
    "DynamicEst": ([1.3001510863281918, 1.0, 2.0],
                   [0.0010611626830890407, 0.0006790129953399419,
                    0.000859699354091322]),
    "DTEst": ([1.3001813895396517, 1.0, 2.0],
              [0.001143308936786884, 0.0007727978798387823,
               0.0009756023513570176]),
}
#: parity of each hosted program with its native twin (the reference's
#: tests/test_hxi.py:142-175 tolerances): twin case, relative tolerance;
#: DID_SFunction-1000's twin is DID-1000 (REF_F_DID1000, within 1e-6)
HOSTED_TWINS = {"DID_SFunction": ("DID", 1e-6),
                "DIC_SFunction": ("DIC", 1e-5), "DIC_FMU": ("DIC", 1e-5)}


def user_program(name, device):
    """The port's program of USER_CASES[name] on ``device``."""
    import hqp_tpu_torch.models.hxi_suite  # noqa: F401  (registers them)
    import hqp_tpu_torch.omu.dt_opt  # noqa: F401
    from hqp_tpu_torch.hxi.sfunction import SFunction, demo_sfunction_path
    from hqp_tpu_torch.omu.hosted import HostedModel
    from hqp_tpu_torch.omu.integrators import RK4
    from hqp_tpu_torch.omu.model import Model
    from hqp_tpu_torch.utils.registry import modules

    class DIC(Model):
        """Double integrator: states (v, s), input a, outputs = states."""
        nx, nu, ny, npar = 2, 1, 2, 0

        def ode(self, t, x, u, p):
            return torch.stack([u[0], x[0]])

    class Decay(Model):
        """dx = -p x; y = x.  One estimated rate parameter."""
        nx, nu, ny, npar = 1, 0, 1, 1
        p0 = (0.5,)

        def ode(self, t, x, u, p):
            return -p[0] * x

    class DecayDT(Model):
        """x+ = (1 - 0.05 p) x; y = x.  One estimated rate parameter."""
        nx, nu, ny, npar = 1, 0, 1, 1
        p0 = (0.5,)
        discrete = True

        def dt_update(self, t, x, u, p):
            return (1.0 - 0.05 * p[0]) * x

    _, prg_name, model, kw, _, _ = USER_CASES[name]
    if model is None:
        return modules.create("prg_name", prg_name, **kw, device=device)
    if model[0] == "DIC":
        m = DIC()
    elif model[0] == "Decay":
        m = Decay()
        kw = dict(kw, integrator=RK4(steps=4))
    elif model[0] == "DecayDT":
        m = DecayDT()
    else:
        m = HostedModel(SFunction(demo_sfunction_path(model[0]),
                                  params=[[model[1]]]))
    return modules.create("prg_name", prg_name, m, **kw, device=device)


#: phase 20's cases, the rest of the integrator family on the Omuses
#: programs: (program, integrator, its keywords, simulate).  Each runs
#: SqpPowell(prg, max_iters=100): Crane at K = 50, Bio at its own size (K =
#: 51), DIC at K = 20.  Bio's adaptive integrators run at looser
#: tolerances than the default 1e-8, BDF at 2 steps and its Krylov case at
#: 4 Newton iterations, the same in both packages: the reference solves
#: each in 4-10 s on a CPU at the defaults, but the port's eager loops cost
#: a launch-bound iteration each (at 1e-8 Bio's stages need 27-460 loop
#: iterations a make_qp, and a Krylov corrector's J v products run in
#: forward mode; PERF.md §6)
INTEG_CASES = {
    "Crane-Dopri5": ("Crane", "Dopri5", {}, True),
    "Bio-SDIRK": ("Bio", "SDIRK", {}, False),
    "Bio-BDF": ("Bio", "BDF", {"steps": 2}, False),
    "Bio-BDFKrylov": ("Bio", "BDF", {"steps": 2, "krylov": True,
                                     "newton_iters": 4}, False),
    "Bio-GRK4": ("Bio", "GRK4", {}, False),
    "Bio-GRK4Adaptive": ("Bio", "GRK4Adaptive",
                         {"rtol": 1e-6, "atol": 1e-6}, False),
    "Bio-IMPAdaptive": ("Bio", "IMPAdaptive", {"rtol": 1e-3, "atol": 1e-3},
                        False),
    "Bio-BDFAdaptive": ("Bio", "BDFAdaptive", {"rtol": 1e-3, "atol": 1e-3},
                        False),
    "Bio-BDFVarOrder": ("Bio", "BDFVarOrder", {"rtol": 1e-2, "atol": 1e-2},
                        False),
    "DIC-RKsuite2": ("DIC", "RKsuite", {"method": 2}, False),
    "DIC-RKF78": ("DIC", "RKF78", {}, False),
    "DIC-OdeTs": ("DIC", "OdeTs", {}, False),
}
#: the JAX package's (verdict, f, SQP, IP) of each case of INTEG_CASES on a
#: CPU host in f64 (integrator_reference_values() in
#: tests/test_torch_sqp.py)
REF_INTEG = {
    "Crane-Dopri5": ("optimal", 11.67512094788542, 6, 61),
    "Bio-SDIRK": ("optimal", -6.880510079903444, 17, 142),
    "Bio-BDF": ("optimal", -6.862230540885921, 17, 130),
    "Bio-BDFKrylov": ("optimal", -6.862230540884154, 17, 130),
    "Bio-GRK4": ("optimal", -6.880653552734419, 22, 208),
    "Bio-GRK4Adaptive": ("optimal", -6.880652370340921, 15, 135),
    "Bio-IMPAdaptive": ("optimal", -6.88065534280171, 18, 145),
    "Bio-BDFAdaptive": ("optimal", -6.879986261825768, 15, 129),
    "Bio-BDFVarOrder": ("optimal", -6.859292142912892, 18, 144),
    "DIC-RKsuite2": ("optimal", 104.00000002084519, 1, 12),
    "DIC-RKF78": ("optimal", 104.00000002084514, 1, 12),
    "DIC-OdeTs": ("optimal", 104.00000002084506, 1, 12),
}
#: the keywords of Mehrotra(eps=1e-7, max_iters=50) in phase 20 (d)
KNOB_CASES = {
    "init_method=1": {"init_method": 1},
    "init_method=2": {"init_method": 2},
    "init_method=3": {"init_method": 3},
    "mod_terlaky": {"mod_terlaky": True},
    "gondzio_correctors=2": {"gondzio_correctors": 2},
    "cheap_predictor": {"cheap_predictor": True},
}
#: the JAX package's (verdict, f, SQP, IP) of SqpPowell(PrgDID(kmax=1000),
#: max_iters=50, qp_solver=Mehrotra(eps=1e-7, max_iters=50, **knob)),
#: init/simulate/solve, on a CPU host in f64 (mehrotra_reference_values()
#: in tests/test_torch_sqp.py)
REF_KNOBS = {
    "init_method=1": ("optimal", 88.91363118637818, 1, 13),
    "init_method=2": ("optimal", 88.91363697413341, 1, 15),
    "init_method=3": ("optimal", 88.91366430223138, 1, 15),
    "mod_terlaky": ("optimal", 88.91361640706438, 1, 30),
    "gondzio_correctors=2": ("optimal", 88.91366823314047, 1, 21),
    "cheap_predictor": ("optimal", 88.9136691532432, 1, 28),
}
#: f of phase 20's cases against the reference (relative)
INTEG_F_RTOL = 1e-8


def integ_program(name, device):
    """The port's program of INTEG_CASES[name] on ``device``."""
    from hqp_tpu_torch.models.crane import PrgCrane
    from hqp_tpu_torch.models.hxi_suite import PrgDIC
    from hqp_tpu_torch.models.omu_suite import PrgBio
    from hqp_tpu_torch.utils.registry import modules
    prg, integ, kw, _ = INTEG_CASES[name]
    it = modules.create("prg_integrator", integ, **kw)
    if prg == "Crane":
        return PrgCrane(K=50, integrator=it, device=device)
    if prg == "Bio":
        return PrgBio(integrator=it, device=device)
    return PrgDIC(K=20, integrator=it, device=device)


def integ_solver(name, device):
    """SqpPowell(prg, max_iters=100) of INTEG_CASES[name] on ``device``."""
    from hqp_tpu_torch.sqp.powell import SqpPowell
    return SqpPowell(integ_program(name, device), max_iters=100)


def knob_solver(name, device):
    """Phase 20 (d)'s solver of DID-1000 with the knob KNOB_CASES[name]."""
    from hqp_tpu_torch.models.did import PrgDID
    from hqp_tpu_torch.qp.mehrotra import Mehrotra
    from hqp_tpu_torch.sqp.powell import SqpPowell
    return SqpPowell(PrgDID(kmax=1000, device=device), max_iters=50,
                     qp_solver=Mehrotra(eps=QP_EPS_DID1000, max_iters=50,
                                        **KNOB_CASES[name]))


#: phase 21's shell scripts: the README's quick start (DID-60), DID-1000
#: at the QP tolerance of every recorded DID-1000 run, and the Crane
SHELL_SCRIPTS = {
    "quickstart": "prg_name DID; prg_kmax 60; qp_mat_solver SpSC; "
                  "prg_setup; hqp_solve",
    "DID-1000": f"prg_name DID; prg_kmax 1000; qp_eps {QP_EPS_DID1000}; "
                "qp_mat_solver SpSC; prg_setup; prg_simulate; hqp_solve",
    "Crane": "prg_name Crane; prg_setup; prg_simulate; hqp_solve",
    # the Client is chosen before qp_eps creates the solver
    "DID-1000 Client": "prg_name DID; prg_kmax 1000; sqp_qp_solver Client; "
                       f"qp_eps {QP_EPS_DID1000}; qp_mat_solver SpSC; "
                       "prg_setup; prg_simulate; hqp_solve",
}
#: the measured initial states of phase 21 (b)'s hqp_solve_hot steps
HOT_X0 = tuple((1.0 + 0.01 * j, 0.0) for j in range(1, 6))
#: SQP iterations (qp_update, qp_solve, step) before phase 21 (c)'s
#: checkpoint of the Crane is saved
CKPT_ITERS = 3
#: phase 21 (e)'s seeded convex MIQP
MIQP = dict(seed=0, n=30, n_int=12, me=4)


def miqp_arrays(seed, n, n_int, me):
    """The MIQP of MIQP as host arrays (Q, c, A, b, C, d, int_mask) of
    min 1/2 x'Qx + c'x, Ax + b = 0, Cx + d >= 0: Q = M'M + I, the first
    n_int variables integer in [0, 4], the rest in [-10, 10], and me
    equality rows through a point with integer first entries."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    Q = M.T @ M + np.eye(n)
    c = 10.0 * rng.standard_normal(n)
    A = rng.standard_normal((me, n))
    xf = np.concatenate([rng.integers(0, 5, n_int),
                         rng.uniform(-1.0, 1.0, n - n_int)])
    lo = np.concatenate([np.zeros(n_int), np.full(n - n_int, -10.0)])
    hi = np.concatenate([np.full(n_int, 4.0), np.full(n - n_int, 10.0)])
    return (Q, c, A, -A @ xf, np.vstack([np.eye(n), -np.eye(n)]),
            np.concatenate([-lo, hi]), np.arange(n) < n_int)


#: the JAX package's (verdict, f, SQP, IP) of each script of SHELL_SCRIPTS in
#: a fresh Shell and of the Crane stopped after CKPT_ITERS SQP iterations,
#: saved, loaded into a fresh shell's solver and solved ("Crane resumed"),
#: on a CPU host in f64 (shell_reference_values() in tests/test_torch_sqp.py)
REF_SHELL = {
    "quickstart": ("optimal", 98.40000001279562, 1, 24),
    "DID-1000": ("optimal", 88.91363105840026, 1, 27),
    "Crane": ("optimal", 11.6751235521463, 6, 61),
    "Crane resumed": ("optimal", 11.675123370117783, 5, 63),
}
#: the same of the DID-1000 script with ``sqp_qp_solver Client`` (the
#: reference's worker solves on its CPU)
REF_CLIENT = ("optimal", 88.91363105840026, 1, 27)
#: (verdict, f, SQP, IP) of each hqp_solve_hot step of DID-1000 after
#: set_pinned(HOT_X0[j]), counted over the step; steps 2 and 4 take more
#: IP iterations than the cold solve in the reference too: their hot start
#: fails its decay test and the IP restarts cold (ROADMAP Q3 R18)
REF_HOT = (
    ("optimal", 90.26103021621438, 1, 7),
    ("optimal", 91.63516592301794, 1, 28),
    ("optimal", 93.03680319271962, 1, 6),
    ("optimal", 94.46591202730134, 1, 35),
    ("optimal", 95.92262823934789, 1, 11),
)
#: BranchBound's (status, f, integer values) of IntDemoT through the shell
#: (mip_f, mip_x) and (status, f, nodes, integer values) of MIQP
REF_MIP = {
    "IntDemoT": ("optimal", 0.9799999999999999, (2.0, 1.0)),
    "MIQP": ("optimal", -27.913560303012957, 25,
             (4.0, 1.0, 0.0, 2.0, 0.0, 0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 0.0)),
}
#: f of phase 21's solves against the reference (relative)
SHELL_F_RTOL = 1e-8


#: phase 22's solves, each SqpPowell(prg, **solver), init(), [simulate()],
#: solve(): name -> (program keywords, solver keywords, simulate).  DID_MEX
#: is DID through the MEX-built demo S-function (csrc/hxi_simulink/
#: sfun_did_demo.c), at the reference's size (tests/test_mex_sfun.py:
#: 119-134) and at K = 1000 with DID-1000's settings
MEX_CASES = {
    "DID_MEX": (dict(kmax=60), {}, False),
    "DID_MEX-1000": (dict(kmax=1000), dict(max_iters=50,
                                           qp_eps=QP_EPS_DID1000), True),
}
#: the JAX package's (verdict, f, SQP, IP) of MEX_CASES on a CPU host in
#: f64 (mex_reference_values() in tests/test_torch_sqp.py)
REF_MEX = {
    "DID_MEX": ("optimal", 98.40000001515537, 1, 24),
    "DID_MEX-1000": ("optimal", 88.91363107458275, 1, 27),
}
#: the JAX package's DID-1000 by qp_mat_solver SpSCdist
#: (ShardedPartitionedKKT on a one-device mesh: L = 20, P = 50, its master
#: by cyclic reduction) with DID-1000's settings, on a CPU host in f64
#: (mex_reference_values())
REF_SHARD = ("optimal", 88.91363105840014, 1, 27)
#: K1's shape on the sharded DID-1000 at one rank: P = 50 interiors of
#: s = 98 with b = 4 couplings
SHARD_K1 = (50, 98, 98)


#: phase 23 (a)-(b): DID-1000 with DID-1000's settings through
#: PartitionedKKT with the reference's backend keywords: name -> keywords
KKT_KNOB_CASES = {
    "gj=xla": {"gj": "xla"},
    "refine_relative=False": {"refine_relative": False, "refine_rounds": 2,
                              "reg_corr_rounds": 1},
}
#: the JAX package's (verdict, f, SQP, IP) of KKT_KNOB_CASES, and of
#: DID-1000 by ShardedPartitionedKKT(full_shard=False) on a one-device mesh
#: (its master by cyclic reduction), on a CPU host in f64
#: (kkt_knob_reference_values() in tests/test_torch_sqp.py)
REF_KKT_KNOBS = {
    "gj=xla": ("optimal", 88.91363105840026, 1, 27),
    "refine_relative=False": ("optimal", 88.91362606998236, 1, 30),
}
REF_SHARD_REP = ("optimal", 88.91363105840014, 1, 27)
#: phase 23 (d): thomas_solve_scaled's systems (N, n), DID-1000's master
#: and the crane's, held to its plain twin within SCALED_RTOL (relative)
SCALED_SHAPES = ((101, 2), (101, 6))
SCALED_RTOL = 3e-16


def register_int_demo():
    """Register the port's IntDemoT (tests/test_mip.py's two-integer
    program) under prg_name, once."""
    from hqp_tpu_torch.docp.nlp import Nlp
    from hqp_tpu_torch.utils.registry import modules
    if modules.has("prg_name", "IntDemoT"):
        return

    @modules.register("prg_name", "IntDemoT")
    class IntDemoT(Nlp):
        name = "IntDemoT"
        n = 2
        m = 0
        x_int = [True, True]

        def setup_vars(self):
            return dict(x_min=[0.0, 0.0], x_max=[5.0, 5.0],
                        x_init=[1.0, 1.0])

        def f0(self, x):
            return ((x[0] - 2.3) ** 2 + (x[1] - 1.7) ** 2
                    + 0.2 * x[0] * x[1])


#: BASELINE config 5 (bench.py:326-377): scenarios, draw scale, seed,
#: presolve tau, partition length, IP tolerance
SCEN = dict(n=256, scale=1e-3, seed=0, tau=0.02, L=20, eps=1e-9)
#: checksum of the port's draws (noise = batched_qp(PrgDID(kmax=60),
#: setup(), 256, scale=1e-3, seed=0) - setup(), drawn on the CPU): its sum,
#: its absolute sum, and three entries, as tests/test_torch_kernels.py
#: records them (SCEN_CHECKSUM)
SCEN_CHECKSUM = (-0.29271950609446296, 37.495359228680115,
                 {(0, 0, 0): -0.002310411800234169,
                  (100, 30, 1): 0.00040663832132356315,
                  (255, 60, 2): 0.0012800506857305201})
#: the JAX package's unbatched solves of the same 256 draws after the
#: same presolve, on a CPU host in f64: Mehrotra(PartitionedKKT(L=20,
#: master="cr", gj="xla"), eps=1e-9) -> (IP iterations of each draw,
#: verdict tally, largest original-row violation); reference_values() in
#: tests/test_torch_sqp.py prints it
REF_SCEN = ([
    23, 22, 23, 22, 24, 23, 23, 22, 23, 23, 21, 23, 23, 20, 22, 21,
    20, 23, 24, 23, 23, 21, 19, 23, 23, 23, 21, 20, 21, 23, 20, 22,
    22, 23, 20, 23, 21, 23, 22, 22, 22, 23, 22, 24, 22, 22, 23, 22,
    19, 20, 23, 23, 22, 23, 19, 23, 21, 22, 22, 24, 24, 22, 23, 24,
    23, 22, 23, 23, 19, 22, 24, 22, 23, 22, 22, 20, 21, 23, 22, 23,
    22, 22, 24, 24, 21, 24, 20, 22, 22, 20, 22, 22, 22, 21, 20, 22,
    23, 22, 23, 22, 23, 23, 22, 24, 22, 23, 20, 23, 23, 21, 21, 22,
    22, 22, 22, 22, 23, 20, 24, 21, 21, 21, 24, 22, 22, 22, 23, 21,
    25, 23, 22, 23, 22, 23, 22, 22, 21, 23, 19, 23, 21, 23, 23, 23,
    22, 20, 22, 22, 24, 23, 19, 23, 22, 22, 22, 23, 21, 22, 23, 22,
    21, 23, 22, 22, 23, 23, 21, 22, 21, 24, 21, 22, 23, 21, 22, 20,
    22, 21, 22, 23, 22, 21, 24, 22, 23, 20, 21, 19, 22, 22, 20, 23,
    22, 22, 22, 22, 22, 23, 23, 21, 23, 22, 23, 23, 22, 22, 22, 22,
    21, 23, 23, 21, 20, 24, 23, 22, 22, 22, 22, 22, 21, 22, 22, 22,
    23, 22, 21, 23, 20, 23, 20, 22, 22, 23, 22, 22, 23, 22, 22, 23,
    23, 22, 21, 22, 23, 22, 23, 20, 23, 19, 22, 22, 22, 22, 22, 23,
], {"optimal": 256}, 0.0008395557138829498)
#: scenarios of phase 17 compared with the port's unbatched solves on the
#: card besides the fastest and the slowest
SCEN_SELF = (0, 1, 2, 3, 64, 255)


#: a kernel's largest error relative to its plain twin's largest entry, by
#: dtype
KERNEL_RTOL = {torch.float64: 1e-10, torch.float32: 1e-3}


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def median_ms(fn, reps=20, runs=1):
    """Median over ``reps`` CUDA-event timings of ``runs`` back-to-back
    calls of fn(), divided by ``runs``, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(runs):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / runs)
    return statistics.median(times)


def device_ms(fn, kernel, reps=50):
    """Mean device time of the kernel whose name contains ``kernel`` over
    ``reps`` back-to-back calls of fn(), from a torch.profiler trace; None
    if the trace holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and kernel in e.name]
    return statistics.mean(us) / 1e3 if us else None


def bound(nbytes, flops, dtype):
    """(ms, side): the least time of the card for this work."""
    tb, tf = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S[dtype]
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def gj_inputs(P, s, b, dtype, seed, swap=False):
    rng = np.random.default_rng(seed)
    # a diagonal shift that keeps the largest tiles well conditioned
    shift = 4.0 if s < 100 else 3.0 * np.sqrt(s)
    M = rng.standard_normal((P, s, s)) + shift * np.eye(s)
    if swap:
        M[:, 0, 0] = 0.0       # forces a row interchange at step 0
    B = rng.standard_normal((P, s, b))
    return (torch.as_tensor(M, dtype=dtype, device="cuda"),
            torch.as_tensor(B, dtype=dtype, device="cuda"))


def gj_bound(P, s, b, dtype):
    """K1's bound: bytes, each input read once and each output written
    once; FLOPs, GJ inverse 2 s^3, W 2 s^2 b, Schur 2 s b^2."""
    el = torch.finfo(dtype).bits // 8
    return bound(P * (2 * s * s + 2 * s * b + b * b) * el,
                 P * (2 * s ** 3 + 2 * s * s * b + 2 * s * b * b), dtype)


def thomas_bound(D, U, r):
    """K2's bound: bytes as for K1; FLOPs per block (of every system of a
    batch) 2n^3 (U'G) + 4n^3 (inverse) + 2n^3 (CU) + 6n^2 (vectors) + n."""
    n = D.shape[-1]
    el = torch.finfo(D.dtype).bits // 8
    return bound((D.numel() + U.numel() + 2 * r.numel()) * el,
                 D.numel() // (n * n) * (8 * n ** 3 + 6 * n * n + n),
                 D.dtype)


def tridiag_dense(D, U):
    """The assembled dense [N n, N n] system of one block-tridiagonal."""
    N, n = D.shape[0], D.shape[-1]
    T = torch.zeros((N * n, N * n), dtype=D.dtype, device=D.device)
    for i in range(N):
        T[i * n:(i + 1) * n, i * n:(i + 1) * n] = D[i]
    for i in range(N - 1):
        T[i * n:(i + 1) * n, (i + 1) * n:(i + 2) * n] = U[i]
        T[(i + 1) * n:(i + 2) * n, i * n:(i + 1) * n] = U[i].T
    return T


def measure(run, plain, library, kernel, bnd):
    """A kernel's times at one shape: 50 back-to-back launches (median of
    5), profiler device time, a single launch (median of 20), its plain
    twin, its library yardstick (50 back-to-back calls) and its bound."""
    return dict(ms=median_ms(run, reps=5, runs=50),
                device_ms=device_ms(run, kernel), single_ms=median_ms(run),
                plain_ms=median_ms(plain, reps=5),
                library_ms=median_ms(library, reps=5, runs=50), bound=bnd)


def time_gj(M, B, kernel):
    """``measure`` for K1 on one batch; the yardstick is torch.linalg.inv
    on the same batch (Minv only)."""
    from hqp_tpu_torch.ops import gj_cuda
    return measure(lambda: gj_cuda.interior_factor(M, B),
                   lambda: gj_cuda.interior_factor_plain(M, B),
                   lambda: torch.linalg.inv(M), kernel,
                   gj_bound(M.shape[0], M.shape[-1], B.shape[-1], M.dtype))


def time_thomas(D, U, r):
    """``measure`` for K2 on one system; the yardstick is the dense
    torch.linalg.solve of the assembled system."""
    from hqp_tpu_torch.ops import thomas_cuda
    N, n = D.shape[0], D.shape[-1]
    T, rv = tridiag_dense(D, U), r.reshape(-1, 1)

    def run():
        return thomas_cuda.thomas_solve(D, U, r)

    check(rel_err(torch.linalg.solve(T, rv).reshape(N, n), run()) < 1e-10,
          "K2's library yardstick solves another system")
    return measure(run, lambda: thomas_cuda.thomas_solve_plain(D, U, r),
                   lambda: torch.linalg.solve(T, rv), "thomas_kernel",
                   thomas_bound(D, U, r))


def show(phase, name, t, what):
    dev = "not measured" if t["device_ms"] is None else \
        f"{t['device_ms']:.4f} ms"
    print(f"[{phase}] {name}: kernel {t['ms']:.4f} ms per launch (50 "
          f"back-to-back, median of 5), device {dev} per launch (profiler, "
          f"50 launches), single launch {t['single_ms']:.4f} ms (median of "
          f"20); plain {t['plain_ms']:.4f} ms; library "
          f"{t['library_ms']:.4f} ms; bound {t['bound'][0]:.3e} ms "
          f"({t['bound'][1]}); {what}")


def gj_launches():
    """K1's launch counters by route ("tile" counts both register routes;
    gj_cuda.LAUNCHES_BATCH the batched one of them)."""
    from hqp_tpu_torch.ops import gj_cuda
    return {"tile": gj_cuda.LAUNCHES, "large": gj_cuda.LAUNCHES_LARGE,
            "inv": gj_cuda.LAUNCHES_INV}


def reset_counts():
    """Every kernel launch counter and the host-sync counter to 0."""
    from hqp_tpu_torch.ops import gj_cuda, thomas_cuda
    from hqp_tpu_torch.utils import sync
    gj_cuda.LAUNCHES = gj_cuda.LAUNCHES_LARGE = gj_cuda.LAUNCHES_INV = 0
    gj_cuda.LAUNCHES_BATCH = 0
    thomas_cuda.LAUNCHES = 0
    sync.COUNT = 0


def thomas_inputs(B, N, n, dtype, seed):
    """Equilibrated SPD block-tridiagonal systems (unit diagonal blocks
    after Jacobi scaling, as the master solve hands them over)."""
    from hqp_tpu_torch.ops import blocktri
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((B, N - 1, n, n)) * 0.3 / n
    X = rng.standard_normal((B, N, n, n)) * 0.1
    D = np.eye(n) * 3.0 + 0.5 * (X + np.swapaxes(X, -1, -2))
    Ds, Us, _ = blocktri.equilibrate(torch.as_tensor(D), torch.as_tensor(U))
    r = rng.standard_normal((B, N, n))
    return tuple(torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()
                 for a in (Ds, Us, r))


def time_links(be, qp, ones, mask, rhs, reps):
    """``reps`` synchronized f64 factor+solve links of backend ``be`` at
    z = w = ``ones`` after one warm-up: (median ms, KKT residual of the
    last link, its solution)."""
    from hqp_tpu_torch.qp import kkt as K_
    ms = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = be.solve(be.factor(qp, ones, ones, mask), qp, ones, ones, mask,
                       *rhs)
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
    *_, res = K_.kkt_residual(qp, ones, ones, mask, *rhs, *sol)
    return statistics.median(ms), float(res), sol


def nx6_link(reps=5):
    """bench.py's cfg_nx6_1000 stage QP (built as there, in numpy from
    default_rng(0)) and PartitionedKKT(L=10) factor+solve links on it in
    f64: (median ms per link after one warm-up, KKT residual of the last
    link)."""
    from hqp_tpu_torch.qp.kkt_partitioned import PartitionedKKT
    from hqp_tpu_torch.qp.program import StageQP
    from hqp_tpu_torch.utils import masked as mk
    rng = np.random.default_rng(0)
    K, nx, nu = 1000, 6, 1
    nv = nx + nu
    M = rng.standard_normal((K + 1, nv, nv)) * 0.1
    Q = M @ M.transpose(0, 2, 1) + 0.5 * np.eye(nv)
    A = np.tile(np.concatenate([np.eye(nx), np.ones((nx, nu)) * 0.01],
                               axis=1), (K, 1, 1)) \
        + 0.01 * rng.standard_normal((K, nx, nv))
    b = 0.01 * rng.standard_normal((K, nx))
    lb = np.full((K + 1, nv), -2.0)
    ub = np.full((K + 1, nv), 2.0)
    lb[-1, nx:] = ub[-1, nx:] = 0.0
    var_mask = np.ones((K + 1, nv), bool)
    var_mask[-1, nx:] = False

    def t(a):
        return torch.as_tensor(a, device="cuda")

    qp = StageQP(Q=t(Q), c=t(np.zeros((K + 1, nv))), A=t(A), b=t(b),
                 lb=t(lb), ub=t(ub), C=t(np.zeros((K + 1, 1, nv))),
                 d_lo=t(np.full((K + 1, 1), -np.inf)),
                 d_up=t(np.full((K + 1, 1), np.inf)), var_mask=t(var_mask),
                 con_mask=t(np.zeros((K + 1, 1), bool)))
    mask = qp.ineq_mask()
    ones = mk.fill(mask, 1.0)
    rhs = (t(np.ones((K + 1, nv))), qp.eq_offsets(), mk.fill(mask, 0.0),
           mk.fill(mask, 0.0))
    return time_links(PartitionedKKT(L=10), qp, ones, mask, rhs, reps)[:2]


def omu_programs():
    """Constructors of the Omuses programs on the card."""
    from hqp_tpu_torch.models import omu_suite as S
    from hqp_tpu_torch.models.crane import PrgCrane
    return {"Crane": lambda: PrgCrane(K=50, device="cuda"),
            "BatchReactor": lambda: S.PrgBatchReactor(device="cuda"),
            "Bio": lambda: S.PrgBio(device="cuda"),
            "TP383omu": lambda: S.PrgTP383omu(device="cuda"),
            "HS99omu": lambda: S.PrgHS99omu(device="cuda"),
            "CranePar": lambda: S.PrgCranePar(device="cuda")}


def omu_drive(phase, name, make, simulate):
    """One SqpPowell(prg, max_iters=100) solve on the card with every
    counter set to 0 just before it: optimal at the reference objective.
    Returns the launches it counted."""
    from hqp_tpu_torch.ops import thomas_cuda
    from hqp_tpu_torch.sqp.powell import SqpPowell
    from hqp_tpu_torch.utils import sync
    f_ref, sqp_ref, ip_ref = REF_OMU[name]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = SqpPowell(make(), max_iters=100)
    s.init()
    if simulate:
        s.simulate()
    res = s.solve()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {"gj": gj_launches(), "thomas": thomas_cuda.LAUNCHES}
    f, ip = float(s.f), s.qp_iters_total
    print(f"[{phase}] {name}: {res}, f = {f!r} (reference {f_ref!r}, rel "
          f"{abs(f - f_ref) / abs(f_ref):.1e}), {secs:.3f} s, SQP {s.iter} "
          f"IP {ip} (reference {sqp_ref} / {ip_ref} without simulate), "
          f"host syncs {sync.COUNT} ({sync.COUNT / max(ip, 1):.2f} per IP "
          f"iteration), launches K1 {counts['gj']} K2 {counts['thomas']}")
    check(s.x.is_cuda and s.qp.Q.is_cuda, f"{name}: not on the card")
    check(res == "optimal", f"{name}: {res}")
    check(abs(f - f_ref) <= OMU_RTOL * abs(f_ref),
          f"{name}: objective {f} vs reference {f_ref}")
    return counts


def oracle_links(reps=3):
    """bench.py's DID-1000 KKT system (the port's PrgDID) and one f64
    factor+solve link of each backend on it, timed as the median of
    ``reps`` synchronized links after one warm-up: {name: (ms, residual,
    dx)}."""
    from hqp_tpu_torch.prof_did1000 import kkt_point
    from hqp_tpu_torch.qp import kkt as K_
    from hqp_tpu_torch.qp.kkt_partitioned import PartitionedKKT
    qp, mask, ones, rhs = kkt_point(1000, DEVICE)
    out = {}
    for name, be in (("PartitionedKKT(L=10)", PartitionedKKT(L=10)),
                     ("RiccatiKKT", K_.RiccatiKKT()),
                     ("FullStageKKT", K_.FullStageKKT())):
        ms, res, sol = time_links(be, qp, ones, mask, rhs, reps)
        out[name] = (ms, res, sol[0])
    return out


def dense_link(reps=5):
    """The first KKT system of PrgLQBlend(n=2000) (its first QP after the
    Gerschgorin hela's start, z = w = 1, Mehrotra's cold-start rhs) and
    DenseKKT factor+solve links on it: (median ms after one warm-up,
    residual of the last, n, rows of the saddle matrix)."""
    from hqp_tpu_torch.models.nlp_gen import PrgLQBlend
    from hqp_tpu_torch.qp import kkt as K_
    from hqp_tpu_torch.sqp.hessian import Gerschgorin
    from hqp_tpu_torch.sqp.powell import SqpPowell
    from hqp_tpu_torch.utils import masked as mk
    s = SqpPowell(PrgLQBlend(n=2000, device=DEVICE), hela=Gerschgorin())
    s.init()
    s.qp_update()
    qp = s.qp
    mask = qp.ineq_mask()
    ones = mk.fill(mask, 1.0)
    rhs = (qp.c, -qp.eq_offsets(), mk.scale(-1.0, qp.ineq_offsets()),
           mk.fill(mask, 0.0))
    ms, res, _ = time_links(K_.DenseKKT(), qp, ones, mask, rhs, reps)
    return ms, res, qp.n, qp.n + qp.me


def alt_solver(pair, prg, **kw):
    """SQP solver of one pairing of phase 15 on ``prg``."""
    from hqp_tpu_torch.qp.franke import Franke
    from hqp_tpu_torch.sqp import hessian
    from hqp_tpu_torch.sqp.powell import SqpPowell
    from hqp_tpu_torch.sqp.schittkowski import SqpSchittkowski
    if pair == "Schittkowski":
        return SqpSchittkowski(prg, **kw)
    if pair == "Franke":
        return SqpPowell(prg, qp_solver=Franke(), **kw)
    if pair != "BFGS":
        kw["hela"] = getattr(hessian, pair)()
    return SqpPowell(prg, **kw)


def alt_drive(name, pair, make, simulate=False, ips=None, **kw):
    """One solve of phase 15 on the card with every counter set to 0 just
    before it: (verdict, f, SQP, IP, seconds, launches); appends each SQP
    iteration's IP count to the list ``ips`` if one is given."""
    from hqp_tpu_torch.ops import thomas_cuda
    from hqp_tpu_torch.sqp.solver import SqpError
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = alt_solver(pair, make(), **kw)
    if ips is not None:
        qp_solve = s.qp_solve

        def counted():
            qp_solve()
            ips.append(s.qp_iters_last)

        s.qp_solve = counted
    s.init()
    if simulate:
        s.simulate()
    try:
        res = s.solve()
    except SqpError as e:
        res = e.reason
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(s.x.device.type == s.qp.Q.device.type == DEVICE,
          f"{name}/{pair}: not on the card")
    return (res, float(s.f), s.iter, s.qp_iters_total, secs,
            {"gj": gj_launches(), "thomas": thomas_cuda.LAUNCHES})


def nlp_programs():
    """Constructors of the NLP suite and DID on the card."""
    from hqp_tpu_torch.models.did import PrgDID
    from hqp_tpu_torch.models import nlp_suite as N
    return {"TP383": lambda: N.PrgTP383(device=DEVICE),
            "Maratos": lambda: N.PrgMaratos(device=DEVICE),
            "HS99": lambda: N.PrgHS99(device=DEVICE),
            "DID-60": lambda: PrgDID(kmax=60, device=DEVICE),
            "DID-1000": lambda: PrgDID(kmax=1000, device=DEVICE)}


def phases_13_to_16(smi):
    """The phases of the general-NLP slice (see the module docstring);
    returns phase 16's dense solves by family (wall ms, IP iterations,
    host syncs an IP iteration)."""
    # -- 13. the KKT oracles on DID-1000 --------------------------------------
    links = oracle_links()
    dx_part = links["PartitionedKKT(L=10)"][2]
    for name, (ms, res, dx) in links.items():
        rel = rel_err(dx, dx_part)
        print(f"[13] DID-1000 {name} f64 link: {ms:.3f} ms per link (median "
              f"of 3, synchronized), KKT residual {res:.2e}, dx vs the "
              f"partitioned rel {rel:.2e}; on {smi}")
        check(res < 1e-6, f"DID-1000 {name} KKT residual {res}")
        check(rel <= 1e-8, f"DID-1000 {name} dx differs from the partitioned"
              f" one by {rel}")

    # -- 14. DenseKKT at the general path's size ------------------------------
    ms, res, n, rows = dense_link()
    print(f"[14] LQBlend n={n} DenseKKT f64 factor+solve ({rows} saddle rows):"
          f" {ms:.3f} ms (median of 5, synchronized), KKT residual "
          f"{res:.2e}; on {smi}")
    check(res < 1e-10, f"LQBlend DenseKKT residual {res}")

    # -- 15. the exchangeable modules ------------------------------------------
    make = nlp_programs()
    for name in ("TP383", "Maratos", "HS99"):
        for pair in ("BFGS", "DScale", "Gerschgorin", "AugBFGS", "Gangster",
                     "Franke", "Schittkowski"):
            ips = []
            res, f, it, ip, secs, _ = alt_drive(name, pair, make[name],
                                                ips=ips, max_iters=120)
            if (name, pair) in REF_ALT:
                ref = REF_ALT[name, pair]
                print(f"[15] {name} {pair}: {res}, f = {f!r}, SQP {it} IP "
                      f"{ip}, {secs:.3f} s (reference {ref[0]}, {ref[1]!r}, "
                      f"{ref[2]} / {ref[3]})")
                check((res, it, ip) == (ref[0], ref[2], ref[3]),
                      f"{name}/{pair}: {res} {it}/{ip} vs reference {ref}")
                check(abs(f - ref[1]) <= 1e-9 * abs(ref[1]),
                      f"{name}/{pair}: f = {f} vs reference {ref[1]}")
                continue
            full, held = REF_CHAOTIC[pair]
            print(f"[15] {name} {pair}: {res}, f = {f!r}, SQP {it} IP {ip}, "
                  f"{secs:.3f} s (reference {full[0]}, {full[1]!r}, {full[2]}"
                  f" / {full[3]}; chaotic, ROADMAP Q3 R11); IP counts by SQP "
                  f"iteration {ips}")
            if isinstance(held, list):
                n = len(held)
                check(ips[:n] == held, f"{name}/{pair}: IP counts of the "
                      f"first {n} SQP iterations {ips[:n]} vs {held}")
            else:
                check((res, it) == held,
                      f"{name}/{pair}: {res} at {it} vs {held}")
    for name in ("DID-60", "DID-1000"):
        for pair in ("Franke", "Schittkowski"):
            res, f, it, ip, secs, c = alt_drive(
                name, pair, make[name], simulate=True, max_iters=50,
                qp_eps=QP_EPS_DID1000)
            ref = REF_ALT[name, pair]
            print(f"[15] {name} {pair}: {res}, f = {f!r}, SQP {it} IP {ip}, "
                  f"{secs:.3f} s, launches K1 {c['gj']} K2 {c['thomas']} "
                  f"(reference {ref[0]}, {ref[1]!r}, {ref[2]} / {ref[3]})")
            check((res, it, ip) == (ref[0], ref[2], ref[3]),
                  f"{name}/{pair}: {res} {it}/{ip} vs reference {ref}")
            rtol = 1e-9 if res == "optimal" else FAILED_F_RTOL
            check(abs(f - ref[1]) <= rtol * abs(ref[1]),
                  f"{name}/{pair}: f = {f} vs reference {ref[1]} (rel "
                  f"tolerance {rtol:g})")
            check(c["gj"]["tile"] > 0 and c["thomas"] > 0,
                  f"{name}/{pair} skipped a kernel: {c}")

    # -- 16. the generated families on the dense path -----------------------------
    from hqp_tpu_torch.models.nlp_gen import FAMILIES, FAMILY_HELA
    from hqp_tpu_torch.qp.kkt import DenseKKT
    from hqp_tpu_torch.qp.mehrotra import Mehrotra
    from hqp_tpu_torch.sqp.powell import SqpPowell
    from hqp_tpu_torch.sqp.solver import SqpError
    from hqp_tpu_torch.utils import sync
    from hqp_tpu_torch.utils.registry import modules
    dense = {}
    for name in ("lqblend", "broydn3d", "bdqrtic", "catena", "srosenbr"):
        n = 2000 if name == "lqblend" else 1000
        torch.cuda.synchronize()
        sync.COUNT = 0
        t0 = time.perf_counter()
        s = SqpPowell(FAMILIES[name](n=n, device=DEVICE), max_iters=200,
                      eps=1e-6, qp_solver=Mehrotra(eps=1e-9, max_iters=60),
                      kkt_backend=DenseKKT(),
                      hela=modules.create("sqp_hela", FAMILY_HELA[name]))
        s.init()
        try:
            res = s.solve()
        except SqpError as e:
            res = e.reason
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if name == "catena":
            print(f"[16] catena n={n} DenseKKT: {res}, {ms:.1f} ms wall (n + 1"
                  f" link equalities on n heights: the dense saddle matrix is "
                  f"singular); on {smi}")
            check(res == "degenerate", f"catena: {res}")
            continue
        rn, rres, rf, rit, rip = REF_FAMILIES[name]
        f = float(s.f)
        print(f"[16] {name} n={n} DenseKKT: {res}, f = {f!r} (reference "
              f"{rf!r}), norm_inf {s.norm_inf}, SQP/IP {s.iter} / "
              f"{s.qp_iters_total} (the host-sparse reference {rit} / {rip}), "
              f"{ms:.1f} ms wall, {sync.COUNT / max(s.qp_iters_total, 1):.2f}"
              f" host syncs an IP iteration; on {smi}")
        check(res == "optimal" and s.norm_inf < 1e-6, f"{name}: {res}")
        check(abs(f - rf) <= max(1e-6 * abs(rf), 1e-8),
              f"{name}: f = {f} vs reference {rf}")
        dense[name] = dict(ms=ms, ip=s.qp_iters_total,
                           syncs=sync.COUNT / max(s.qp_iters_total, 1))
    return dense


def time_thomas_batch(D, U, r):
    """``measure`` for K2 on a batch of systems; the yardstick is one
    batched dense torch.linalg.solve of the assembled systems."""
    from hqp_tpu_torch.ops import thomas_cuda
    T = torch.stack([tridiag_dense(Di, Ui) for Di, Ui in zip(D, U)])
    rv = r.reshape(r.shape[0], -1, 1)

    def run():
        return thomas_cuda.thomas_solve(D, U, r)

    check(rel_err(torch.linalg.solve(T, rv).reshape(r.shape), run())
          < 1e-10, "K2's library yardstick solves other systems")
    return measure(run, lambda: thomas_cuda.thomas_solve_plain(D, U, r),
                   lambda: torch.linalg.solve(T, rv), "thomas_kernel",
                   thomas_bound(D, U, r))


def phase_17(smi):
    """The scenario batch (see the module docstring).  Returns the rows
    the kernels JSON adds for the batch's shapes: {"gj": ..., "thomas":
    ...}."""
    from hqp_tpu_torch.models.did import PrgDID
    from hqp_tpu_torch.ops import gj_cuda, thomas_cuda
    from hqp_tpu_torch.parallel import scenarios as sc
    from hqp_tpu_torch.qp.kkt_partitioned import PartitionedKKT
    from hqp_tpu_torch.qp.mehrotra import RESULT_STRINGS, Mehrotra
    from hqp_tpu_torch.qp.presolve import merge_parallel_rows
    from hqp_tpu_torch.utils import sync
    n = SCEN["n"]
    prg = PrgDID(kmax=60, device=DEVICE)
    v0 = prg.setup()
    vb = sc.batched_qp(prg, v0, n, scale=SCEN["scale"], seed=SCEN["seed"])
    noise = (vb - v0).cpu()
    total, absum, entries = SCEN_CHECKSUM
    got = (float(noise.sum()), float(noise.abs().sum()),
           {k: float(noise[k]) for k in entries})
    print(f"[17] draws: {n} x {tuple(v0.shape)}, noise sum {got[0]!r}, "
          f"abs sum {got[1]!r}, entries {got[2]} (recorded: "
          f"{SCEN_CHECKSUM})")
    check(abs(got[0] - total) <= 1e-12 * absum
          and abs(got[1] - absum) <= 1e-12 * absum and got[2] == entries,
          "the draws are not those the CPU tests record, and counts are "
          f"held only on the same data: {got} vs {SCEN_CHECKSUM}")
    Qb = (1e-2 * torch.eye(prg.nv, dtype=torch.float64, device=DEVICE)
          ).expand(n, prg.K + 1, prg.nv, prg.nv)
    be = PartitionedKKT(L=SCEN["L"])
    slv = Mehrotra(backend=be, eps=SCEN["eps"])
    solve = sc.make_scenario_solve(prg, slv, presolve_tau=SCEN["tau"])

    # count the batched factorizations and the kernels' batch shapes, and
    # keep the kernels' first inputs of the cold run for their comparison
    factor = be.factor
    seen = {"factor": 0, "gj": set(), "thomas": set()}

    def counted(*a):
        seen["factor"] += 1
        fac = factor(*a)
        seen["gj"].add(tuple(fac.Minv.shape))
        seen["thomas"].add(tuple(fac.master[3].shape))
        return fac

    be.factor = counted
    inputs = {}
    gj_fn, th_fn = gj_cuda.interior_factor, thomas_cuda.thomas_solve

    def gj_spy(M, B):
        inputs.setdefault("gj", (M.clone(), B.clone()))
        return gj_fn(M, B)

    def th_spy(D, U, r):
        inputs.setdefault("thomas", (D.clone(), U.clone(), r.clone()))
        return th_fn(D, U, r)

    def run(tag):
        reset_counts()
        seen["factor"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, viol = solve(vb, Qb)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        its, res = st.iter.tolist(), st.result.tolist()
        c = {"gj": gj_launches(), "batch": gj_cuda.LAUNCHES_BATCH,
             "thomas": thomas_cuda.LAUNCHES, "syncs": sync.COUNT,
             "factor": seen["factor"]}
        steps = max(its)
        print(f"[17] {tag} batch solve: {secs * 1e3:.1f} ms, "
              f"{n / secs:.1f} QP solves/s, {sum(its) / secs:.1f} IP "
              f"iterations/s ({sum(its)} in all, {steps} batched IP "
              f"iterations), {res.count(0)}/{n} optimal, largest "
              f"original-row violation {float(viol.max())!r}, "
              f"{c['factor']} batched factorizations, launches K1 "
              f"{c['gj']} (batched route {c['batch']}) K2 {c['thomas']}, "
              f"host syncs {c['syncs']} "
              f"({c['syncs'] / max(steps, 1):.2f} per batched IP "
              f"iteration); on {smi}")
        check(st.x.device.type == viol.device.type == DEVICE,
              "the batch is not on the card")
        return st, viol, c

    gj_cuda.interior_factor, thomas_cuda.thomas_solve = gj_spy, th_spy
    try:
        run("cold")
    finally:
        gj_cuda.interior_factor, thomas_cuda.thomas_solve = gj_fn, th_fn
    st, viol, c = run("warm")
    its, res = st.iter.tolist(), st.result.tolist()
    tally = {}
    for r in res:
        tally[RESULT_STRINGS[r]] = tally.get(RESULT_STRINGS[r], 0) + 1
    vmax = float(viol.max())
    ref_its, ref_tally, ref_viol = REF_SCEN
    diff = [(i, its[i], ref_its[i]) for i in range(n) if its[i] != ref_its[i]]
    print(f"[17] against the JAX package's unbatched solves of the same "
          f"draws: verdicts {tally} (reference {ref_tally}), IP counts "
          f"differ in {len(diff)} scenarios {diff[:10]} (index, port, "
          f"reference), largest violation {vmax!r} (reference "
          f"{ref_viol!r}, {abs(vmax - ref_viol):.1e} apart)")
    check(tally == ref_tally and not diff,
          f"scenario verdicts {tally} or IP counts {diff} differ from "
          "REF_SCEN")
    check(abs(vmax - ref_viol) <= 1e-9,
          f"largest original-row violation {vmax} vs {ref_viol}")
    way = gj_cuda.route(98, 4, torch.float64, DEVICE)
    check(c["gj"] == {"tile": c["factor"], "large": 0, "inv": 0}
          and c["batch"] == (c["factor"] if way == "batch" else 0),
          f"K1 launches {c['gj']}, batched {c['batch']}, vs {c['factor']} "
          f"batched factorizations by the {way} route")
    check(seen["gj"] == {(n * 3, 98, 98)}
          and seen["thomas"] == {(n, 4, 2, 2)} and c["thomas"] > 0,
          f"kernel shapes {seen} (K2 launches {c['thomas']})")

    # -- the batch against the port's own unbatched solves on the card
    pick = sorted({its.index(min(its)), its.index(max(its)), *SCEN_SELF})
    for i in pick:
        _, qp = prg.make_qp(vb[i], Qb[i])
        qps = merge_parallel_rows(qp, SCEN["tau"])
        one = slv.solve(qps, slv.init_state(qps))
        dx = float((one.x - st.x[i]).abs().max())
        print(f"[17] scenario {i}: batched {RESULT_STRINGS[res[i]]} at "
              f"{its[i]}, unbatched {RESULT_STRINGS[int(one.result)]} at "
              f"{int(one.iter)}, x max-abs apart {dx:.1e}")
        check((int(one.result), int(one.iter)) == (res[i], its[i])
              and dx <= 1e-10, f"scenario {i}: batched and unbatched differ")

    # -- the kernels on the batch's own inputs, against their twins
    M, B = inputs["gj"]
    out, ref = gj_cuda.interior_factor(M, B), \
        gj_cuda.interior_factor_plain(M, B)
    e_gj = [rel_err(o, r) for o, r in zip(out, ref)]
    D, U, r = inputs["thomas"]
    x, xr = thomas_cuda.thomas_solve(D, U, r), \
        thomas_cuda.thomas_solve_plain(D, U, r)
    e_th = rel_err(x, xr)
    print(f"[17] K1 on the batch's first interiors {tuple(M.shape)}, b="
          f"{B.shape[-1]}: rel err Minv {e_gj[0]:.2e} W {e_gj[1]:.2e} "
          f"Schur {e_gj[2]:.2e}; K2 on its first masters {tuple(D.shape)}:"
          f" rel err {e_th:.2e}")
    check(max(e_gj) <= 1e-10 and e_th <= 1e-10,
          "a kernel disagrees with its twin on the batch's inputs")
    rows = {}
    for key, t, err, what in (
            ("gj", time_gj(M, B, "gj_interior_kernel"),
             float((out[0] - ref[0]).abs().max()),
             f"K1 {way} route, P={M.shape[0]}, s={M.shape[-1]}, "
             f"b={B.shape[-1]} (the scenario batch's interiors)"),
            ("thomas", time_thomas_batch(D, U, r),
             float((x - xr).abs().max()),
             f"K2, B={D.shape[0]}, N={D.shape[1]}, n={D.shape[-1]} (the "
             "scenario batch's masters)")):
        show(17, key, t, f"f64, {what}, on {smi}")
        rows[key] = {"shape": list((M if key == "gj" else D).shape),
                     "launches": c["gj"]["tile"] if key == "gj"
                     else c["thomas"],
                     "max_abs_err": err, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                     "bound_by": t["bound"][1],
                     "library_ms": t["library_ms"],
                     "device_ms": t["device_ms"],
                     "single_ms": t["single_ms"]}
    print("[17] library yardsticks: K1 torch.linalg.inv on the same "
          "[768, 98, 98] (Minv only); K2 one batched torch.linalg.solve of "
          "the 256 assembled [8, 8] masters")
    return rows


def separable_pairs(device):
    """tests/test_sparse_bfgs.py's partially separable NLP in the port:
    f = sum_i (x_i^2 - x_{i+h})^2 + (x_i - 1)^2 over n = 8, h = n/2, whose
    Hessian is 2x2-block diagonal after a reordering that RCM finds."""
    from hqp_tpu_torch.docp.nlp import Nlp

    class SeparablePairs(Nlp):
        name = "SeparablePairs"
        n = 8
        m = 0

        def setup_vars(self):
            return dict(x_init=np.full(self.n, 0.5))

        def f0(self, x):
            h = self.n // 2
            a, b = x[:h], x[h:]
            return ((a ** 2 - b) ** 2 + (a - 1.0) ** 2).sum()

    return SeparablePairs(device=device)


class QPDevices:
    """Records the device of every tensor of each QP (DenseQP or StageQP)
    that Mehrotra.solve is handed and of the iterate it returns, while
    active (a context manager)."""

    def __enter__(self):
        from hqp_tpu_torch.qp.mehrotra import Mehrotra
        self.devices = set()
        self._solve = Mehrotra.solve
        rec = self.devices

        def solve(slv, qp, state, hot=False):
            out = self._solve(slv, qp, state, hot)
            rec.update(t.device.type for t in (*vars(qp).values(), out.x)
                       if torch.is_tensor(t))
            return out

        Mehrotra.solve = solve
        return self

    def __exit__(self, *exc):
        from hqp_tpu_torch.qp.mehrotra import Mehrotra
        Mehrotra.solve = self._solve


class KernelSpy:
    """While active (a context manager), keeps each kernel's first inputs
    at every shape and dtype it is given, with the case (``case``) that
    gave them; :meth:`hold` then holds each kernel against its plain twin
    on them."""

    case = None

    def __enter__(self):
        from hqp_tpu_torch.ops import gj_cuda, thomas_cuda
        self.inputs = {}
        self._fns = gj_fn, th_fn = (gj_cuda.interior_factor,
                                    thomas_cuda.thomas_solve)

        def gj_spy(M, B):
            key = ("K1", tuple(M.shape), B.shape[-1], M.dtype)
            self.inputs.setdefault(key, (self.case, M.clone(), B.clone()))
            return gj_fn(M, B)

        def th_spy(D, U, r):
            key = ("K2", tuple(D.shape), r.shape[-1], D.dtype)
            self.inputs.setdefault(key, (self.case, D.clone(), U.clone(),
                                         r.clone()))
            return th_fn(D, U, r)

        gj_cuda.interior_factor, thomas_cuda.thomas_solve = gj_spy, th_spy
        return self

    def __exit__(self, *exc):
        from hqp_tpu_torch.ops import gj_cuda, thomas_cuda
        gj_cuda.interior_factor, thomas_cuda.thomas_solve = self._fns

    def hold(self, phase):
        """Each kept input through the kernel (the route its size takes)
        and through the plain twin: rel err within KERNEL_RTOL."""
        from hqp_tpu_torch.ops import gj_cuda, thomas_cuda
        for (k, shape, b, dt), (case, *a) in self.inputs.items():
            on_card = a[0].device.type == "cuda"
            if k == "K1":
                way = gj_cuda.route(shape[-1], b, dt, a[0].device) \
                    if on_card else "plain"
                out, ref = gj_cuda.interior_factor(*a), \
                    gj_cuda.interior_factor_plain(*a)
                e = max(rel_err(o, r) for o, r in zip(out, ref))
            else:
                way = (f"plan {thomas_cuda.plan(shape[-3], shape[-1], dt)}"
                       if on_card else "plain")
                e = rel_err(thomas_cuda.thomas_solve(*a),
                            thomas_cuda.thomas_solve_plain(*a))
            print(f"[{phase}] {k} on {case}'s first inputs {list(shape)}, "
                  f"{'b' if k == 'K1' else 'rhs'}={b}, {str(dt)[6:]}, "
                  f"{way}: rel err {e:.2e}")
            check(e <= KERNEL_RTOL[dt],
                  f"{k} disagrees with its twin on {case}'s inputs ({e})")
        check({"K1", "K2"} <= {k[0] for k in self.inputs},
              f"phase {phase} gave the kernels no inputs: "
              f"{list(self.inputs)}")


def phase_18(smi, dense):
    """The host-sparse slice on the card (see the module docstring);
    ``dense`` holds phase 16's DenseKKT solves by family."""
    import os

    from hqp_tpu_torch import native
    from hqp_tpu_torch.models import nlp_gen
    from hqp_tpu_torch.models import nlp_suite
    from hqp_tpu_torch.models.sif import solve_sif
    from hqp_tpu_torch.ops import _build_host
    from hqp_tpu_torch.prof_did1000 import LayerTimers
    from hqp_tpu_torch.qp.kkt_sparse_host import (FullSparseBKPKKT,
                                                  SparseCallbackKKT,
                                                  SparseHostKKT)
    from hqp_tpu_torch.qp.mehrotra import Mehrotra
    from hqp_tpu_torch.sqp.hessian import SparseBFGS
    from hqp_tpu_torch.sqp.powell import SqpPowell
    from hqp_tpu_torch.sqp.solver import SqpError
    from hqp_tpu_torch.utils import sync

    # -- (a) build -------------------------------------------------------------
    t0 = time.perf_counter()
    native.library()
    print(f"[18] host library built in {time.perf_counter() - t0:.1f} s "
          f"(g++ {_build_host.INFO['seconds']:.1f} s, built="
          f"{_build_host.INFO['built']}) -> {_build_host.INFO['path']}")

    with QPDevices() as qd:
        # -- (b) the families through solve_generated, in the order of the
        # reference's record: the shared backend keeps its symbolic records
        # per problem shape across calls, as the reference's does
        for name in sorted([*REF_FAMILIES, "catena"]):
            if name == "catena":
                catena_drive(smi)
                continue
            n, rres, rf, rit, rip = REF_FAMILIES[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = nlp_gen.solve_generated(name, n=n, device=DEVICE)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            f = info["obj"]
            print(f"[18] {name} n={n} RedSpBKP: {info['result']}, f = {f!r} "
                  f"(reference {rf!r}), norm_inf {info['norm_inf']}, SQP/IP "
                  f"{info['sqp_iters']} / {info['qp_iters_total']} (reference"
                  f" {rit} / {rip}), {ms:.1f} ms wall; on {smi}")
            check(info["result"] == rres and info["norm_inf"] < 1e-6,
                  f"{name}: {info}")
            check((info["sqp_iters"], info["qp_iters_total"]) == (rit, rip),
                  f"{name}: SQP/IP {info['sqp_iters']} / "
                  f"{info['qp_iters_total']} vs reference {rit} / {rip}")
            check(abs(f - rf) <= max(1e-6 * abs(rf), 1e-8),
                  f"{name}: f = {f} vs reference {rf}")

        # -- (c) the SIF files through solve_sif ---------------------------------
        here = os.path.dirname(os.path.abspath(__file__))
        for name, (rres, rf, rit, rip) in REF_SIF.items():
            t0 = time.perf_counter()
            out = solve_sif(os.path.join(here, "tests", "sif", name + ".SIF"),
                            device=DEVICE)
            ms = (time.perf_counter() - t0) * 1e3
            fstar = SIF_OPTIMA[name]
            print(f"[18] SIF {name}: {out['result']}, obj = {out['obj']!r} "
                  f"(reference {rf!r}, published {fstar!r}), SQP/IP "
                  f"{out['sqp_iters']} / {out['qp_iters_total']} (reference "
                  f"{rit} / {rip}), {ms:.1f} ms wall")
            check((out["result"], out["sqp_iters"], out["qp_iters_total"])
                  == (rres, rit, rip), f"SIF {name}: {out}")
            check(abs(out["obj"] - rf) <= max(1e-8 * abs(rf), 1e-12),
                  f"SIF {name}: obj {out['obj']} vs reference {rf}")
            check(abs(out["obj"] - fstar) <= max(1e-4 * abs(fstar), 2e-5)
                  and out["ok"], f"SIF {name}: obj {out['obj']} vs the "
                  f"published optimum {fstar}")

        # -- (d) TP383 by RedSpBKP_host and SpBKP; (e) SparseBFGS ----------------
        for (prog, pair), ref in REF_HOST.items():
            if pair == "SparseBFGS":
                s = SqpPowell(separable_pairs(DEVICE), max_iters=60,
                              hela=SparseBFGS())
                be = None
            else:
                be = (SparseHostKKT if pair == "RedSpBKP_host"
                      else FullSparseBKPKKT)()
                s = SqpPowell(nlp_suite.PrgTP383(device=DEVICE), max_iters=60,
                              qp_solver=Mehrotra(eps=1e-9, max_iters=50),
                              kkt_backend=be)
            t0 = time.perf_counter()
            s.init()
            try:
                res = s.solve()
            except SqpError as e:
                res = e.reason
            ms = (time.perf_counter() - t0) * 1e3
            f = float(s.f)
            extra = ""
            if pair == "SpBKP":
                extra = (f", pinned pivots {sum(be.pinned)} over "
                         f"{len(be.pinned)} factorizations (most in one: "
                         f"{max(be.pinned)})")
            elif pair == "SparseBFGS":
                extra = f", blocks {s.hela._blocks}"
            print(f"[18] {prog} {pair}: {res}, f = {f!r} (reference "
                  f"{ref[1]!r}), SQP/IP {s.iter} / {s.qp_iters_total} "
                  f"(reference {ref[2]} / {ref[3]}), {ms:.1f} ms wall{extra}")
            check((res, s.iter, s.qp_iters_total) == (ref[0], ref[2], ref[3]),
                  f"{prog}/{pair}: {res} {s.iter}/{s.qp_iters_total} vs "
                  f"reference {ref}")
            check(abs(f - ref[1]) <= max(1e-9 * abs(ref[1]), 1e-15),
                  f"{prog}/{pair}: f = {f} vs reference {ref[1]}")

    # -- (f) every QP tensor of (b)-(e) on the card ----------------------------
    print(f"[18] devices of the QP tensors and iterates of (b)-(e): "
          f"{sorted(qd.devices)}")
    check(qd.devices == {DEVICE}, f"a QP left the card: {qd.devices}")

    # -- (g) where lqblend's time goes, beside the dense path's ---------------
    n = REF_FAMILIES["lqblend"][0]
    be = nlp_gen.generated_solver("lqblend", n=n, device=DEVICE)._kkt_backend
    moved = dict(be.moved)
    lt = LayerTimers(torch.device(DEVICE))
    lt.wrap(SparseCallbackKKT, "_host_factor", "factor")
    lt.wrap(SparseCallbackKKT, "_host_solve", "solve")
    try:
        torch.cuda.synchronize()
        sync.COUNT = 0
        t0 = time.perf_counter()
        info = nlp_gen.solve_generated("lqblend", n=n, device=DEVICE)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        lt.restore()
    ip = info["qp_iters_total"]
    d2h = (be.moved["d2h"] - moved["d2h"]) / ip
    h2d = (be.moved["h2d"] - moved["h2d"]) / ip
    dn = dense["lqblend"]
    print(f"[18] lqblend n={n} warm solve_generated (RedSpBKP): "
          f"{info['result']}, {ms:.1f} ms wall, IP {ip}; an IP iteration: "
          f"host factor {lt.excl['factor'] * 1e3 / ip:.2f} ms "
          f"({lt.calls['factor']} factorizations in all), host solves "
          f"{lt.excl['solve'] * 1e3 / ip:.2f} ms ({lt.calls['solve']} "
          f"solves in all), {d2h:.0f} bytes to the host and {h2d:.0f} to "
          f"the card, {sync.COUNT / ip:.2f} host syncs; the same solve by "
          f"DenseKKT (phase 16): {dn['ms']:.1f} ms wall, IP {dn['ip']}, "
          f"{dn['syncs']:.2f} host syncs an IP iteration; on {smi}")
    check(info["result"] == "optimal", f"lqblend: {info}")


def catena_drive(smi):
    """Phase 18's catena: solve_generated's solver (generated_solver, init,
    solve) held to REF_CATENA: the verdict, the SQP and IP counts, and f
    over the first SQP iterations (ROADMAP Q3 R14: f parts exponentially
    after them, between the packages and within the reference itself)."""
    from hqp_tpu_torch.models import nlp_gen
    from hqp_tpu_torch.sqp.solver import SqpError
    res, it, ip, head = REF_CATENA
    n = 1000
    s = nlp_gen.generated_solver("catena", n=n, device=DEVICE)
    fs = []
    qp_solve = s.qp_solve

    def traced():
        qp_solve()
        fs.append(float(s.f))

    s.qp_solve = traced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.init()
    try:
        got = s.solve()
    except SqpError as e:
        got = e.reason
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    be = s._kkt_backend
    floored = be._live[be._token]["ldl"].n_floored
    rel = [abs(a - b) / abs(b) for a, b in zip(fs, head)]
    print(f"[18] catena n={n} RedSpBKP: {got} at SQP {s.iter} / IP "
          f"{s.qp_iters_total} (reference {res} at {it} / {ip}), f = "
          f"{float(s.f)!r}, norm_inf {s.norm_inf} (chaotic: reference runs "
          f"end at {REF_CATENA_ENDS}); f over the first {len(head)} SQP "
          f"iterations {fs[:len(head)]}, largest rel difference "
          f"{max(rel):.2e}; LDL' pivots floored in the last factorization "
          f"{floored}; {ms:.1f} ms wall; on {smi}")
    check((got, s.iter, s.qp_iters_total) == (res, it, ip),
          f"catena: {got} {s.iter}/{s.qp_iters_total} vs {REF_CATENA[:3]}")
    check(len(fs) >= len(head) and max(rel) <= 1e-6,
          f"catena: f over the first SQP iterations {fs[:len(head)]} vs "
          f"{head}")


def user_drive(name, smi):
    """One case of USER_CASES on the card, every counter set to 0 just
    before it: SqpPowell(prg, **solver), init(), [simulate()], solve(),
    held to REF_HOSTED's verdict, SQP and IP counts and f within
    USER_F_RTOL or USER_F_ATOL (the estimations' estimates and half-widths
    within USER_F_RTOL).  Prints
    the wall time, the host-callback time (HostedModel's batches, one read
    and one write each), the bytes each way per SQP iteration, the host
    syncs per IP iteration and the launches; returns (f, launches)."""
    from hqp_tpu_torch.omu import hosted
    from hqp_tpu_torch.ops import thomas_cuda
    from hqp_tpu_torch.prof_did1000 import LayerTimers
    from hqp_tpu_torch.sqp.powell import SqpPowell
    from hqp_tpu_torch.sqp.solver import SqpError
    from hqp_tpu_torch.utils import sync
    part, _, _, _, skw, sim = USER_CASES[name]
    rres, rf, rit, rip = REF_HOSTED[name]
    prg = user_program(name, DEVICE)
    models = [m for m in (getattr(prg, "hosted", None),
                          getattr(prg, "model", None))
              if isinstance(m, hosted.HostedModel)]
    lt = LayerTimers(torch.device(DEVICE))
    lt.wrap(hosted._HostFn, "run", "hosted")
    reset_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = SqpPowell(prg, **skw)
        s.init()
        if sim:
            s.simulate()
        try:
            res = s.solve()
        except SqpError as e:
            res = e.reason
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        lt.restore()
    launches = {"gj": gj_launches(), "thomas": thomas_cuda.LAUNCHES}
    f, it, ip = float(s.f), s.iter, s.qp_iters_total
    d2h = sum(m.moved["d2h"] for m in models) / max(it, 1)
    h2d = sum(m.moved["h2d"] for m in models) / max(it, 1)
    print(f"[19{part}] {name}: {res}, f = {f!r} (reference {rf!r}, rel "
          f"{abs(f - rf) / abs(rf):.1e}), SQP/IP {it} / {ip} (reference "
          f"{rit} / {rip}), {secs:.3f} s wall, host callbacks "
          f"{lt.excl['hosted'] * 1e3:.1f} ms in {lt.calls['hosted']} "
          f"batches, {d2h:.0f} bytes to the host and {h2d:.0f} to the card "
          f"per SQP iteration, host syncs {sync.COUNT / max(ip, 1):.2f} per "
          f"IP iteration, launches K1 {launches['gj']} K2 "
          f"{launches['thomas']}; on {smi}")
    check((res, it, ip) == (rres, rit, rip),
          f"{name}: {res} at {it} / {ip} vs reference {REF_HOSTED[name]}")
    check(abs(f - rf) <= max(USER_F_RTOL * abs(rf), USER_F_ATOL),
          f"{name}: f = {f} vs reference {rf}")
    if name in REF_CONFIDENCE:
        theta, half = (torch.tensor(a, dtype=torch.float64, device=DEVICE)
                       for a in REF_CONFIDENCE[name])
        _, got = prg.confidence(s.x)
        est = s.x[0, :prg.nx]
        e = max(rel_err(est, theta), rel_err(got, half))
        print(f"[19{part}] {name} confidence: estimates "
              f"{est.tolist()}, half-widths {got.tolist()}, largest rel "
              f"difference to the reference {e:.1e}")
        check(e <= USER_F_RTOL, f"{name}: confidence {est.tolist()}, "
              f"{got.tolist()} vs reference {REF_CONFIDENCE[name]}")
    return f, launches


def phase_19(smi):
    """The user-model slice on the card (see the module docstring)."""
    from hqp_tpu_torch.hxi import fmu, sfunction

    # -- the builds --------------------------------------------------------------
    t0 = time.perf_counter()
    paths = [sfunction.demo_sfunction_path(n) for n in ("sfun_did",
                                                        "sfun_dic")]
    paths.append(fmu.build_test_fmu())
    built = ", ".join(f"{k} built={v['built']}"
                      for k, v in sfunction.INFO.items())
    print(f"[19] S-functions and test FMU built in "
          f"{time.perf_counter() - t0:.1f} s ({built}) -> {', '.join(paths)}")

    fs = {}
    with KernelSpy() as spy, QPDevices() as qd:
        for name, case in USER_CASES.items():
            spy.case = name
            fs[name], launches = user_drive(name, smi)
            if case[0] == "b":
                check(launches["gj"]["tile"] + launches["gj"]["large"]
                      > 0 and launches["thomas"] > 0,
                      f"{name} skipped a kernel: {launches}")
    print(f"[19] devices of the QP tensors and iterates: "
          f"{sorted(qd.devices)}")
    check(qd.devices == {DEVICE}, f"a QP left the card: {qd.devices}")
    spy.hold(19)
    for name, (twin, rtol) in HOSTED_TWINS.items():
        check(abs(fs[name] - fs[twin]) <= rtol * abs(fs[twin]),
              f"{name}: f = {fs[name]} vs its native twin {twin}'s "
              f"{fs[twin]}")
    f = fs["DID_SFunction-1000"]
    check(abs(f - REF_F_DID1000) <= 1e-6 * REF_F_DID1000,
          f"DID_SFunction-1000: f = {f} vs DID-1000's {REF_F_DID1000}")
    print(f"[19] hosted programs against their native twins: "
          + ", ".join(f"{n} {fs[n]!r} / {t} {fs[t]!r}"
                      for n, (t, _) in HOSTED_TWINS.items())
          + f", DID_SFunction-1000 {f!r} / DID-1000 {REF_F_DID1000!r}")


def integ_drive(part, name, make, ref, smi):
    """One solve of phase 20 on the card, every counter set to 0 just
    before it: ``make()`` gives the solver, init(), simulate() for the
    Crane and DID, solve(); held to ``ref`` = (verdict, f, SQP, IP) with f
    within INTEG_F_RTOL (a failure of both packages within
    FAILED_F_RTOL).  Prints the wall time, the launches, the host syncs
    per IP iteration and the adaptive loop's iterations and host reads
    per make_qp; returns the launches."""
    from hqp_tpu_torch.docp.program import Docp
    from hqp_tpu_torch.omu import integrators
    from hqp_tpu_torch.ops import thomas_cuda
    from hqp_tpu_torch.sqp.solver import SqpError
    from hqp_tpu_torch.utils import sync
    rres, rf, rit, rip = ref
    per = {"calls": 0, "iters": 0, "reads": 0}
    make_qp = Docp.make_qp

    def counted(prg, *a, **kw):
        i, r = integrators.LOOP_ITERS, integrators.LOOP_READS
        out = make_qp(prg, *a, **kw)
        per["calls"] += 1
        per["iters"] += integrators.LOOP_ITERS - i
        per["reads"] += integrators.LOOP_READS - r
        return out

    Docp.make_qp = counted
    reset_counts()
    integrators.LOOP_ITERS = integrators.LOOP_READS = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = make()
        s.init()
        if name.startswith(("Crane", "DID")):
            s.simulate()
        try:
            res = s.solve()
        except SqpError as e:
            res = e.reason
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        Docp.make_qp = make_qp
    launches = {"gj": gj_launches(), "thomas": thomas_cuda.LAUNCHES}
    f, it, ip = float(s.f), s.iter, s.qp_iters_total
    n = max(per["calls"], 1)
    loop = (f", adaptive loop {per['iters'] / n:.1f} iterations and "
            f"{per['reads'] / n:.1f} host reads per make_qp ("
            f"{integrators.LOOP_ITERS} iterations in all)"
            if integrators.LOOP_ITERS else "")
    print(f"[20{part}] {name}: {res}, f = {f!r} (reference {rf!r}, rel "
          f"{abs(f - rf) / abs(rf):.1e}), SQP/IP {it} / {ip} (reference "
          f"{rit} / {rip}), {secs:.3f} s wall, host syncs "
          f"{sync.COUNT / max(ip, 1):.2f} per IP iteration, launches K1 "
          f"{launches['gj']} K2 {launches['thomas']}{loop}; on {smi}")
    check(s.x.device.type == s.qp.Q.device.type == DEVICE,
          f"{name}: not on the card")
    check((res, it, ip) == (rres, rit, rip),
          f"{name}: {res} at {it} / {ip} vs reference {ref}")
    rtol = INTEG_F_RTOL if rres == "optimal" else FAILED_F_RTOL
    check(abs(f - rf) <= rtol * abs(rf), f"{name}: f = {f} vs {rf}")
    check(launches["gj"]["tile"] + launches["gj"]["large"] > 0
          and launches["thomas"] > 0, f"{name} skipped a kernel: {launches}")
    return launches


#: phase 20's solves that run in worker processes beside the main one
#: (the host-bound Bio and Crane cases), longest first as measured on the
#: card, and the number of workers
INTEG_PARALLEL = ("Bio-BDFVarOrder", "Bio-BDFKrylov", "Bio-IMPAdaptive",
                  "Bio-BDFAdaptive", "Bio-GRK4Adaptive", "Bio-SDIRK",
                  "Crane-Dopri5", "Bio-BDF", "Bio-GRK4")
INTEG_WORKERS = 4


def integ_case(name, smi):
    """The solves of INTEG_CASES[name] (the Crane cold, then warm in the
    same process) on the card."""
    prg = INTEG_CASES[name][0]
    part = {"Crane": "a", "Bio": "b", "DIC": "c"}[prg]
    for run in (("cold", "warm") if prg == "Crane" else ("",)):
        integ_drive(part, f"{name} {run}".strip(),
                    lambda: integ_solver(name, DEVICE), REF_INTEG[name], smi)


def integ_worker(name, smi):
    """One case of INTEG_PARALLEL in a worker process: its solves, then the
    kernels held against their twins on the case's own first inputs;
    returns (what it printed, the QP devices, the failure or None)."""
    import contextlib
    import io
    out = io.StringIO()
    devices, failed = set(), None
    try:
        with contextlib.redirect_stdout(out):
            with KernelSpy() as spy, QPDevices() as qd:
                spy.case = name
                integ_case(name, smi)
            devices = qd.devices
            spy.hold(20)
    except SystemExit as e:
        failed = str(e)
    return out.getvalue(), devices, failed


def phase_20(smi):
    """The rest of the integrators and Mehrotra's knobs on the card (see
    the module docstring): INTEG_PARALLEL's cases in INTEG_WORKERS spawned
    processes, the others here meanwhile."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(INTEG_WORKERS) as pool:
        jobs = [pool.apply_async(integ_worker, (name, smi))
                for name in INTEG_PARALLEL]
        with KernelSpy() as spy, QPDevices() as qd:
            for name in INTEG_CASES:
                if name not in INTEG_PARALLEL:
                    spy.case = name
                    integ_case(name, smi)
            for name in KNOB_CASES:
                spy.case = f"DID-1000 {name}"
                integ_drive("d", f"DID-1000 {name}",
                            lambda: knob_solver(name, DEVICE),
                            REF_KNOBS[name], smi)
        spy.hold(20)
        devices = set(qd.devices)
        for name, job in zip(INTEG_PARALLEL, jobs):
            text, dev, failed = job.get()
            print(text, end="")
            check(failed is None, f"{name} in its worker: {failed}")
            devices |= dev
    print(f"[20] devices of the QP tensors and iterates: {sorted(devices)}")
    check(devices == {DEVICE}, f"a QP left the card: {devices}")


def shell_drive(part, name, sh, step, ref, smi, whole=False):
    """One action of phase 21 on the card, every counter set to 0 just
    before it: ``step()`` runs it in the shell ``sh`` and returns the
    verdict; held to ``ref`` = (verdict, f, SQP, IP) with f within
    SHELL_F_RTOL, SQP and IP counted over the action (over the solver's
    whole run with ``whole``).  Prints the wall time, the host syncs per
    IP iteration and the launches; returns (wall ms, launches)."""
    from hqp_tpu_torch.ops import thomas_cuda
    from hqp_tpu_torch.utils import sync
    s = sh.solver
    it0, ip0 = (s.iter, s.qp_iters_total) if s is not None and not whole \
        else (0, 0)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {"gj": gj_launches(), "thomas": thomas_cuda.LAUNCHES}
    f = float(sh("prg_f"))
    it, ip = sh.solver.iter - it0, sh.solver.qp_iters_total - ip0
    rres, rf, rit, rip = ref
    print(f"[21{part}] {name}: {res}, f = {f!r} (reference {rf!r}, rel "
          f"{abs(f - rf) / abs(rf):.1e}), SQP/IP {it} / {ip} (reference "
          f"{rit} / {rip}), {ms:.1f} ms wall, host syncs "
          f"{sync.COUNT / max(ip, 1):.2f} per IP iteration, launches K1 "
          f"{launches['gj']} K2 {launches['thomas']}; on {smi}")
    check(sh.solver.x.device.type == sh.solver.qp.Q.device.type == DEVICE,
          f"{name}: not on the card")
    check((res, it, ip) == (rres, rit, rip),
          f"{name}: {res} at {it} / {ip} vs reference {ref}")
    check(abs(f - rf) <= SHELL_F_RTOL * abs(rf), f"{name}: f = {f} vs {rf}")
    return ms, launches


def phase_21(smi):
    """The shell slice on the card (see the module docstring)."""
    import os
    import tempfile

    from hqp_tpu_torch.mip.branch_bound import BranchBound
    from hqp_tpu_torch.qp.program import DenseQP
    from hqp_tpu_torch.shell import Shell
    from hqp_tpu_torch.utils import checkpoint, diagnostics, masked
    register_int_demo()
    tmp = tempfile.TemporaryDirectory()

    def ran(launches, name):
        check(launches["gj"]["tile"] + launches["gj"]["large"] > 0
              and launches["thomas"] > 0,
              f"{name} skipped a kernel: {launches}")

    with KernelSpy() as spy:
        # (a) the README's quick start, then DID-1000 through the shell
        for name in ("quickstart", "DID-1000"):
            spy.case = name
            sh = Shell(rcfile=False, device=DEVICE)
            ms, launches = shell_drive(
                "a", name, sh, lambda: sh.run(SHELL_SCRIPTS[name])[-1],
                REF_SHELL[name], smi)
            ran(launches, name)
        cold_ms = ms
        check((REF_SHELL[name][3], launches["gj"]["tile"],
               launches["thomas"]) == DID1000_COUNTS,
              f"DID-1000 through the shell: launches {launches} vs "
              f"{DID1000_COUNTS}")
        # (b) MPC hot re-solves of DID-1000 in the same shell
        hot = []
        for j, x0 in enumerate(HOT_X0):
            spy.case = f"DID-1000 hot {x0[0]}"
            sh.prg.set_pinned(x0, stage=0)
            ms, launches = shell_drive("b", spy.case, sh,
                                       lambda: sh("hqp_solve_hot"),
                                       REF_HOT[j], smi)
            ran(launches, spy.case)
            got = sh.solver.x[0, :2].tolist()
            check(got == list(x0), f"{spy.case}: x0 = {got}, not {x0}")
            hot.append(ms)
    print(f"[21b] hqp_solve_hot ms: {[round(m, 1) for m in hot]}, mean "
          f"{statistics.mean(hot):.1f} ms, against the cold solve's "
          f"{cold_ms:.1f} ms; IP iterations {[r[3] for r in REF_HOT]} "
          f"against the cold {REF_SHELL['DID-1000'][3]}; on {smi}")
    check(sum(r[3] for r in REF_HOT) < len(REF_HOT) * REF_SHELL[
        "DID-1000"][3], "the hot re-solves took more IP iterations in all "
          "than as many cold solves")
    # (f) prg_test and prg_qp_dump / qp_load on the solved DID-1000
    out = sh("prg_test")
    print(f"[21f] DID-1000 prg_test: {out}")
    check(out.startswith("ok"), f"prg_test: {out}")
    path = os.path.join(tmp.name, "did1000.npz")
    sh(f"prg_qp_dump {path}")
    qp = diagnostics.qp_load(path, DEVICE)
    same = all(torch.equal(a, b) for a, b in zip(
        masked.leaves(qp), masked.leaves(sh.solver.qp)))
    print(f"[21f] DID-1000 QP dumped and loaded onto {qp.device}: every "
          f"field equal {same}")
    check(same and qp.device.type == DEVICE, "qp_load changed the QP")

    # (c) the Crane through the shell, its plt file, and a checkpoint
    sh = Shell(rcfile=False, device=DEVICE)
    ms, launches = shell_drive("c", "Crane", sh,
                               lambda: sh.run(SHELL_SCRIPTS["Crane"])[-1],
                               REF_SHELL["Crane"], smi)
    ran(launches, "Crane")
    plt = os.path.join(tmp.name, "crane.plt")
    sh(f"omu_write_plt {plt}")
    n = int(sh(f"omu_read_plt {plt}"))
    print(f"[21c] Crane omu_write_plt / omu_read_plt: {n} points, columns "
          f"{sh.plt_names}")
    check(n == sh.prg.K + 1, f"the Crane's plt file holds {n} points")
    sh = Shell(rcfile=False, device=DEVICE)
    sh.run("prg_name Crane; prg_setup; prg_simulate")
    for _ in range(CKPT_ITERS):
        sh.run("sqp_qp_update; sqp_qp_solve; sqp_step")
    path = os.path.join(tmp.name, "crane.npz")
    checkpoint.save_solver(path, sh.solver)
    saver = sh.solver
    sh = Shell(rcfile=False, device=DEVICE)
    sh.run("prg_name Crane; prg_setup")
    checkpoint.load_solver(path, sh.solver)
    shared = {t.untyped_storage().data_ptr() for t in masked.leaves(
        (saver.x, saver.y, saver.z, saver.qp, saver.ip_state))} & {
        t.untyped_storage().data_ptr() for t in masked.leaves(
            (sh.solver.x, sh.solver.y, sh.solver.z, sh.solver.qp,
             sh.solver.ip_state))}
    check(not shared, "the restored solver shares storage with the saver")
    ms, launches = shell_drive("c", f"Crane resumed after {CKPT_ITERS} SQP "
                               "iterations (SQP/IP over the whole run)", sh,
                               lambda: sh("hqp_solve"),
                               REF_SHELL["Crane resumed"], smi, whole=True)
    ran(launches, "Crane resumed")
    tmp.cleanup()

    # (d) DID-1000 with its QPs solved in the Client's worker process
    sh = Shell(rcfile=False, device=DEVICE)
    try:
        ms, launches = shell_drive(
            "d", "DID-1000 by sqp_qp_solver Client", sh,
            lambda: sh.run(SHELL_SCRIPTS["DID-1000 Client"])[-1],
            REF_CLIENT, smi)
        c = sh.solver.qp_solver
        n, first, ran_k = c.solves, dict(c.seconds), dict(c.launches)
        check(ran_k["K1"] > 0 and ran_k["K2"] > 0,
              f"the Client's worker skipped a kernel: {ran_k}")
        check((ran_k["K1"], ran_k["K2"]) == DID1000_COUNTS[1:],
              f"the Client's worker: launches {ran_k} vs {DID1000_COUNTS}")
        # one more QP to the warm worker: its transport without the start
        qp = sh.solver.qp
        c.solve(qp, c.init_state(qp))
        warm = {k: c.seconds[k] - first[k] for k in first}
        print(f"[21d] Client: worker on {DEVICE}, its launches in the "
              f"shell's solve K1 {ran_k['K1']} K2 {ran_k['K2']}; bytes sent "
              f"{c.moved['sent'] / (n + 1):.0f} and received "
              f"{c.moved['received'] / (n + 1):.0f} per QP; the shell's {n} "
              f"QP(s): round trip {first['round_trip'] * 1e3:.1f} ms, of it "
              f"the worker's solve {first['solve'] * 1e3:.1f} ms (the rest "
              f"is the worker's start and the transport); one more QP to "
              f"the warm worker: round trip {warm['round_trip'] * 1e3:.1f} "
              f"ms, solve {warm['solve'] * 1e3:.1f} ms, transport "
              f"{(warm['round_trip'] - warm['solve']) * 1e3:.1f} ms; on "
              f"{smi}")
        check(REF_CLIENT == REF_SHELL["DID-1000"],
              "REF_CLIENT differs from the shell's DID-1000")
    finally:
        sh.solver.qp_solver.close()

    # (e) the mixed-integer layer: IntDemoT through the shell, the MIQP
    sh = Shell(rcfile=False, device=DEVICE)
    sh.run("prg_name IntDemoT; mip_solver BranchBound; prg_setup")
    check(sh("hqp_solve") == "optimal", "IntDemoT's relaxation")
    status, f = sh("mip_solve"), float(sh("mip_f"))
    x = tuple(sh._mip_x.tolist())
    rs, rf, rx = REF_MIP["IntDemoT"]
    print(f"[21e] IntDemoT mip_solve: {status}, mip_f = {f!r} (reference "
          f"{rf!r}), mip_x {x} on {sh._mip_x.device}")
    check((status, x) == (rs, rx) and abs(f - rf) <= SHELL_F_RTOL * abs(rf),
          f"IntDemoT: {status}, {f}, {x} vs {REF_MIP['IntDemoT']}")
    Q, cq, A, b, C, d, im = (torch.as_tensor(a, device=DEVICE) for a in
                             miqp_arrays(**MIQP))
    bb = BranchBound()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, f, status = bb.solve(DenseQP.build(Q, cq, A=A, b=b, C=C, d=d),
                            im.cpu().numpy())
    ms = (time.perf_counter() - t0) * 1e3
    rs, rf, rnodes, rx = REF_MIP["MIQP"]
    ints = tuple(v + 0.0 for v in x[:MIQP["n_int"]].tolist())
    print(f"[21e] MIQP n={MIQP['n']} ({MIQP['n_int']} integer, "
          f"{MIQP['me']} equality rows) by BranchBound: {status}, f = {f!r} "
          f"(reference {rf!r}), {bb.nodes} nodes (reference {rnodes}), "
          f"integers {ints}, {ms:.1f} ms, {ms / bb.nodes:.1f} ms per node; "
          f"x on {x.device}; on {smi}")
    check((status, bb.nodes, ints) == (rs, rnodes, rx),
          f"MIQP: {status}, {bb.nodes} nodes, {ints} vs {REF_MIP['MIQP']}")
    check(abs(f - rf) <= SHELL_F_RTOL * abs(rf), f"MIQP: f = {f} vs {rf}")
    check(x.device.type == DEVICE, "the MIQP's solution left the card")

    # (g) the kernels on (a)'s and (b)'s first inputs against their twins
    spy.hold(21)




def drive22(part, name, prg, skw, sim, ref, smi, phase=22, **kw):
    """One solve of phase 22 on the card, every counter set to 0 just
    before it: SqpPowell(prg, **skw, **kw), init(), [simulate()], solve(),
    held to ``ref`` = (verdict, f, SQP, IP) with f within USER_F_RTOL.
    Prints the wall time, the host-callback time of a hosted model, the
    host syncs per IP iteration and the launches; returns (f, launches)."""
    from hqp_tpu_torch.omu import hosted
    from hqp_tpu_torch.ops import thomas_cuda
    from hqp_tpu_torch.parallel import sharded_kkt
    from hqp_tpu_torch.prof_did1000 import LayerTimers
    from hqp_tpu_torch.sqp.powell import SqpPowell
    from hqp_tpu_torch.sqp.solver import SqpError
    from hqp_tpu_torch.utils import sync
    lt = LayerTimers(torch.device(DEVICE))
    lt.wrap(hosted._HostFn, "run", "hosted")
    reset_counts()
    sharded_kkt.COLLECTIVES = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = SqpPowell(prg, **skw, **kw)
        s.init()
        if sim:
            s.simulate()
        try:
            res = s.solve()
        except SqpError as e:
            res = e.reason
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        lt.restore()
    launches = {"gj": gj_launches(), "thomas": thomas_cuda.LAUNCHES,
                "collectives": sharded_kkt.COLLECTIVES}
    f, it, ip = float(s.f), s.iter, s.qp_iters_total
    rres, rf, rit, rip = ref
    print(f"[{phase}{part}] {name}: {res}, f = {f!r} (reference {rf!r}, rel "
          f"{abs(f - rf) / abs(rf):.1e}), SQP/IP {it} / {ip} (reference "
          f"{rit} / {rip}), {secs * 1e3:.1f} ms wall, host callbacks "
          f"{lt.excl['hosted'] * 1e3:.1f} ms in {lt.calls['hosted']} "
          f"batches, host syncs {sync.COUNT / max(ip, 1):.2f} per IP "
          f"iteration, launches K1 {launches['gj']} K2 "
          f"{launches['thomas']}, collectives {launches['collectives']}; "
          f"on {smi}")
    check((res, it, ip) == (rres, rit, rip),
          f"{name}: {res} at {it} / {ip} vs reference {ref}")
    check(abs(f - rf) <= USER_F_RTOL * abs(rf),
          f"{name}: f = {f} vs reference {rf}")
    return f, launches


def phase_22(smi):
    """The MEX and Simulink-coder hosts and the sharded KKT backend on the
    card (see the module docstring); returns the kernels JSON's entries of
    K1 ("gj") and K2 ("thomas", where the master runs it) at the sharded
    solve's shapes."""
    import ctypes
    import os

    import torch.distributed as dist

    import hqp_tpu_torch.models.hxi_suite  # noqa: F401  (DID_MEX)
    from hqp_tpu_torch.hxi import mex, sfunction, simulink
    from hqp_tpu_torch.models.did import PrgDID
    from hqp_tpu_torch.ops import gj_cuda, thomas_cuda
    from hqp_tpu_torch.parallel import distributed, sharded_kkt
    from hqp_tpu_torch.utils.registry import modules

    # (a) the demo S-function both ways and the MEX host library
    t0 = time.perf_counter()
    src = os.path.join(simulink.SIMULINK_DIR, "sfun_did_demo.c")
    paths = [simulink.build_sfunction(src), mex.build_mex_sfunction(src)]
    mex._host_lib()
    built = ", ".join(f"{k} built={v['built']} {v['seconds']:.2f} s"
                      for k, v in sfunction.INFO.items()
                      if k.startswith(("sfun_did_demo", "libhximex")))
    print(f"[22a] sfun_did_demo.c built both ways and the MEX host in "
          f"{time.perf_counter() - t0:.2f} s ({built}) -> "
          f"{', '.join(paths)}")
    check(hasattr(ctypes.CDLL(paths[1]), "mexFunction") and not hasattr(
        ctypes.CDLL(paths[1]), "hxi_mdlOutputs"),
        "the MEX build exports more than mexFunction")
    cg = simulink.SimulinkSFunction(paths[0], params=[0.001])
    mx = mex.MexSFunction(paths[1], args="[0.001]")
    for k in range(4):
        for sf in (cg, mx):
            sf.set_inputs([0.5 - 0.25 * k])
            sf.update(t=0.001 * k)
        check(np.array_equal(cg.xd, mx.xd) and np.array_equal(
            cg.outputs(), mx.outputs()), "the two builds drive apart")

    # (b) DID_MEX on the card
    fs = {}
    with KernelSpy() as spy, QPDevices() as qd:
        for name, (pkw, skw, sim) in MEX_CASES.items():
            spy.case = name
            prg = modules.create("prg_name", "DID_MEX", **pkw, device=DEVICE)
            fs[name], launches = drive22("b", name, prg, skw, sim,
                                         REF_MEX[name], smi)
        check(launches["gj"]["tile"] > 0 and launches["thomas"] > 0,
              f"DID_MEX-1000 skipped a kernel: {launches}")
    print(f"[22b] devices of the QP tensors and iterates: "
          f"{sorted(qd.devices)}")
    check(qd.devices == {DEVICE}, f"a QP left the card: {qd.devices}")
    spy.hold(22)
    f = fs["DID_MEX-1000"]
    check(abs(f - REF_F_DID1000) <= 1e-6 * REF_F_DID1000,
          f"DID_MEX-1000: f = {f} vs DID-1000's {REF_F_DID1000}")
    print(f"[22b] DID_MEX-1000 {f!r} / DID-1000 {REF_F_DID1000!r}; "
          f"DID_MEX {fs['DID_MEX']!r} / DID_SFunction "
          f"{REF_HOSTED['DID_SFunction'][1]!r}")

    # (c) DID-1000 by qp_mat_solver SpSCdist at world size 1 on nccl
    check(distributed.init_distributed(world_size=1, device=DEVICE),
          "no process group")
    try:
        print(f"[22c] {distributed.process_summary()}")
        mesh = distributed.global_mesh(("sp",))
        be = modules.create("qp_mat_solver", "SpSCdist", mesh)
        check(type(be) is sharded_kkt.ShardedPartitionedKKT, "SpSCdist")
        with KernelSpy() as spy, QPDevices() as qd:
            spy.case = "SpSCdist DID-1000"
            prg = PrgDID(kmax=1000, device=DEVICE)
            f, launches = drive22("c", spy.case, prg,
                                  dict(max_iters=50, qp_eps=QP_EPS_DID1000),
                                  True,
                                  REF_SHARD, smi, kkt_backend=be)
        check(qd.devices == {DEVICE}, f"a QP left the card: {qd.devices}")
        COUNTS["22c"] = launches["collectives"]
        key = ("K1", SHARD_K1, 4, torch.float64)
        check(key in spy.inputs and launches["gj"]["tile"] > 0,
              f"K1 at {SHARD_K1}: {launches}, {list(spy.inputs)}")
        master = be._master_k()
        check((launches["thomas"] > 0) == (master == "thomas"),
              f"the master ({master}) and K2's launches {launches}")
        print(f"[22c] SpSCdist DID-1000's master: {master}; f {f!r} / "
              f"DID-1000's {REF_F_DID1000!r}")
        spy.hold(22)
        # K1 and K2 timed on the case's own first inputs
        _, M, B = spy.inputs[key]
        out, ref = gj_cuda.interior_factor(M, B), \
            gj_cuda.interior_factor_plain(M, B)
        rows = {}
        t = time_gj(M, B, "gj_interior_kernel")
        show(22, "gj", t, f"f64, K1 "
             f"{gj_cuda.route(M.shape[-1], B.shape[-1], M.dtype, M.device)}"
             f" route, P={M.shape[0]}, "
             f"s={M.shape[-1]}, b={B.shape[-1]} (SpSCdist DID-1000's "
             f"interiors at one rank), on {smi}")
        rows["gj"] = (M.shape, launches["gj"]["tile"],
                      (out[0] - ref[0]).abs().max(), t)
        kth = [k for k in spy.inputs if k[0] == "K2"]
        if kth:
            _, D, U, r = spy.inputs[kth[0]]
            x, xr = thomas_cuda.thomas_solve(D, U, r), \
                thomas_cuda.thomas_solve_plain(D, U, r)
            t = time_thomas(D, U, r)
            show(22, "thomas", t, f"f64, K2, N={D.shape[0]}, n="
                 f"{D.shape[-1]} (SpSCdist DID-1000's master), on {smi}")
            rows["thomas"] = (D.shape, launches["thomas"],
                              (x - xr).abs().max(), t)
    finally:
        dist.destroy_process_group()
    return {k: {"shape": list(shape), "launches": n,
                "max_abs_err": float(err), "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"], "single_ms": t["single_ms"]}
            for k, (shape, n, err, t) in rows.items()}

#: counts one phase reads from another: the collectives of phase 22 (c)
COUNTS = {}


class FactorCount:
    """Counts the factorizations of PartitionedKKT and of its sharded
    subclass while active (a context manager): ``n``."""

    def __enter__(self):
        from hqp_tpu_torch.parallel.sharded_kkt import ShardedPartitionedKKT
        from hqp_tpu_torch.qp.kkt_partitioned import PartitionedKKT
        self.n = 0
        self._fns = [(c, c.__dict__["factor"])
                     for c in (PartitionedKKT, ShardedPartitionedKKT)]
        for cls, fn in self._fns:
            def factor(be, *a, _fn=fn):
                self.n += 1
                return _fn(be, *a)
            cls.factor = factor
        return self

    def __exit__(self, *exc):
        for cls, fn in self._fns:
            cls.factor = fn


def time_thomas_scaled(D, U, d, r):
    """``measure`` for thomas_solve_scaled (K2) on one system; the
    yardstick is the dense torch.linalg.solve of the original system
    diag(1/d) T diag(1/d); the bound counts K2's work plus reading d and
    its two products."""
    from hqp_tpu_torch.ops import thomas_cuda
    N, n = D.shape[-3], D.shape[-1]
    T = tridiag_dense(D.reshape(N, n, n), U.reshape(N - 1, n, n))
    di = 1.0 / d.reshape(-1)
    A, rv = di[:, None] * T * di[None, :], r.reshape(-1, 1)

    def run():
        return thomas_cuda.thomas_solve_scaled(D, U, d, r)

    check(rel_err(torch.linalg.solve(A, rv).reshape(r.shape), run())
          < 1e-10, "thomas_solve_scaled's yardstick solves another system")
    el = torch.finfo(D.dtype).bits // 8
    return measure(run, lambda: thomas_cuda.thomas_solve_scaled_plain(
        D, U, d, r), lambda: torch.linalg.solve(A, rv), "thomas_kernel",
        bound((D.numel() + U.numel() + 3 * r.numel()) * el,
              D.numel() // (n * n) * (8 * n ** 3 + 6 * n * n + n)
              + 2 * r.numel(), D.dtype))


def phase_23(smi):
    """PartitionedKKT's reference keywords, SpSCdist's full_shard=False and
    thomas_solve_scaled on the card (see the module docstring); returns the
    kernels JSON's entries of thomas_solve_scaled, one per SCALED_SHAPES."""
    import torch.distributed as dist

    from hqp_tpu_torch.models.did import PrgDID
    from hqp_tpu_torch.ops import blocktri, thomas_cuda
    from hqp_tpu_torch.parallel import distributed, sharded_kkt
    from hqp_tpu_torch.qp.kkt_partitioned import PartitionedKKT
    from hqp_tpu_torch.utils.registry import modules
    skw = dict(max_iters=50, qp_eps=QP_EPS_DID1000)
    nk1, nk2 = DID1000_COUNTS[1:]
    with KernelSpy() as spy, QPDevices() as qd:
        # (a) the library inverse by the caller's word; (b) the refinement
        # and regularization keywords with K1's routes
        for part, (name, kw) in zip("ab", KKT_KNOB_CASES.items()):
            spy.case = name
            with FactorCount() as fc:
                _, launches = drive22(part, name, PrgDID(
                    kmax=1000, device=DEVICE), skw, True,
                    REF_KKT_KNOBS[name], smi, phase=23,
                    kkt_backend=PartitionedKKT(**kw))
            gj = launches["gj"]
            print(f"[23{part}] {name}: {fc.n} factorizations, K1 "
                  f"{gj}, K2 {launches['thomas']} (DID-1000 in phase 7: "
                  f"K1 {nk1}, K2 {nk2} at {DID1000_COUNTS[0]} IP)")
            if kw.get("gj") == "xla":
                check(gj == {"tile": 0, "large": 0, "inv": 0},
                      f"{name}: K1 launched: {gj}")
                if REF_KKT_KNOBS[name][3] == DID1000_COUNTS[0]:
                    check(launches["thomas"] == nk2,
                          f"{name}: K2 {launches['thomas']} launches, "
                          f"phase 7's {nk2}")
            else:
                check(gj == {"tile": fc.n, "large": 0, "inv": 0},
                      f"{name}: K1 {gj} for {fc.n} factorizations")
            check(launches["thomas"] > 0, f"{name}: K2 not launched")
        check(qd.devices == {DEVICE}, f"a QP left the card: {qd.devices}")

        # (c) SpSCdist's replicated layout at world size 1 on nccl
        check(distributed.init_distributed(world_size=1, device=DEVICE),
              "no process group")
        try:
            mesh = distributed.global_mesh(("sp",))
            be = modules.create("qp_mat_solver", "SpSCdist", mesh,
                                full_shard=False)
            check(type(be) is sharded_kkt.ShardedPartitionedKKT
                  and not be.full_shard, "SpSCdist full_shard=False")
            spy.case = "SpSCdist full_shard=False"
            with FactorCount() as fc:
                _, launches = drive22("c", spy.case, PrgDID(
                    kmax=1000, device=DEVICE), skw, True, REF_SHARD_REP,
                    smi, phase=23, kkt_backend=be)
        finally:
            dist.destroy_process_group()
        key = ("K1", SHARD_K1, 4, torch.float64)
        check(key in spy.inputs and launches["gj"]["tile"] == fc.n,
              f"K1 at {SHARD_K1}: {launches} for {fc.n} factorizations, "
              f"{list(spy.inputs)}")
        print(f"[23c] collectives per solve: {launches['collectives']} "
              f"(full_shard=True in phase 22 (c): "
              f"{COUNTS.get('22c', 'not run')}); {fc.n} factorizations, "
              f"K1 {launches['gj']['tile']} on {list(SHARD_K1)}, K2 "
              f"{launches['thomas']}")
        check(qd.devices == {DEVICE}, f"a QP left the card: {qd.devices}")
    spy.hold(23)

    # (d) thomas_solve_scaled against its plain twin
    rows = []
    for N, n in SCALED_SHAPES:
        D, U, r = thomas_inputs(1, N, n, torch.float64, seed=N + n)
        rng = np.random.default_rng(n)
        d = torch.as_tensor(rng.uniform(0.1, 10.0, (1, N, n)),
                            device=DEVICE)
        # no solve of either package calls it: its path is this one call,
        # counted from 0 as a main path's launches are
        reset_counts()
        x = thomas_cuda.thomas_solve_scaled(D, U, d, r)
        launches = thomas_cuda.LAUNCHES
        check(launches == 1, f"thomas_solve_scaled launched K2 {launches} "
              "times, not once")
        xr = thomas_cuda.thomas_solve_scaled_plain(D, U, d, r)
        e = rel_err(x, xr)
        # the scaled solve is d * (K2 on the scaled rhs), and the original
        # system's factors give the same answer (blocktri.solve_scaled)
        L, W = blocktri.factor(D[0], U[0])
        e_bt = rel_err(blocktri.solve_scaled(L, W, d[0], r[0]), x[0])
        t = time_thomas_scaled(D, U, d, r)
        show(23, "thomas_solve_scaled", t, f"f64, K2, N={N}, n={n}: rel "
             f"err {e:.2e} against its twin, {e_bt:.2e} against "
             f"blocktri.solve_scaled; on {smi}")
        check(e <= SCALED_RTOL, f"thomas_solve_scaled at N={N}, n={n}: "
              f"rel err {e} against its twin")
        check(e_bt < 1e-10, f"thomas_solve_scaled at N={N}, n={n}: "
              f"{e_bt} from blocktri.solve_scaled")
        rows.append({"shape": [N, n, n], "launches": launches,
                     "max_abs_err": float((x - xr).abs().max()),
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                     "library_ms": t["library_ms"],
                     "device_ms": t["device_ms"],
                     "single_ms": t["single_ms"]})
    return rows


#: the interior shapes phase 24 times both register routes of K1 at (P,
#: s, b = 4, f64): the scenario batch's (B = 16,384 and 4,096), the
#: 256-scenario batch's, DID-1000's, SpSCdist DID-1000's at one rank and
#: one interior; then batches of one to four waves at s = 98
BATCH_SHAPES = [(49152, 98), (12288, 98), (768, 98), (100, 48), (50, 98),
                (1, 98)]
BATCH_SWEEP = [132, 264, 396, 528]
#: the card cases of the batched route (tests/test_torch_kernels.py
#: holds the same through hold_batch_route): sizes (97 and 98: one and two
#: rows past the register tile) and batches
BATCH_CASES = [(s, nb) for s in (5, 48, 97, 98) for nb in (1, 264, 1000)]


def same(a, b):
    """Equal to the last bit, NaN where the other is NaN."""
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def batch_inputs(P, s, b, dtype, seed, device="cuda"):
    """Interiors that pivot at every step (each a well-conditioned matrix
    with its rows shuffled), with a tie for the first pivot in matrix 0
    (two rows of equal |value|: the lower one must win) and, where P > 1,
    a NaN in column 1 of the last matrix (NaN never wins)."""
    g = torch.Generator(device=device).manual_seed(seed)
    shift = 4.0 if s < 100 else 3.0 * s ** 0.5
    M = torch.randn(P, s, s, generator=g, dtype=dtype, device=device) + \
        shift * torch.eye(s, dtype=dtype, device=device)
    order = torch.rand(P, s, generator=g, device=device).argsort(dim=1)
    M = M.gather(1, order[:, :, None].expand(-1, -1, s)).contiguous()
    if s >= 3:
        top = float(M[0, :, 0].abs().max()) + 1.0
        M[0, 1, 0], M[0, s - 1, 0] = -top, top
    if P > 1 and s >= 3:
        M[-1, s // 2, 1] = float("nan")
    B = torch.randn(P, s, b, generator=g, dtype=dtype, device=device)
    return M, B


def hold_batch_route(s, nb, dtype=torch.float64, b=4, seed=0):
    """The batched route of K1 at one size and batch, on the card: its
    Minv equal to the tile route's and the plain twin's to the last bit
    (NaN where they are NaN), its W and Schur equal to the tile route's
    (the two share their write-out) and within KERNEL_RTOL of the twin's
    on the finite matrices, and one launch counted in LAUNCHES and in
    LAUNCHES_BATCH."""
    from hqp_tpu_torch.ops import gj_cuda
    M, B = batch_inputs(nb, s, b, dtype, seed)
    n0, nb0 = gj_cuda.LAUNCHES, gj_cuda.LAUNCHES_BATCH
    out = gj_cuda.batch_factor(M, B)
    check((gj_cuda.LAUNCHES - n0, gj_cuda.LAUNCHES_BATCH - nb0) == (1, 1),
          f"batched K1 at s={s}, nb={nb}: launches counted "
          f"{gj_cuda.LAUNCHES - n0}, batched {gj_cuda.LAUNCHES_BATCH - nb0}")
    tile = gj_cuda.tile_factor(M, B)
    ref = gj_cuda.interior_factor_plain(M, B)
    torch.cuda.synchronize()
    check(same(out[0], tile[0]) and same(out[0], ref[0]),
          f"batched K1 at s={s}, nb={nb}: Minv not the tile kernel's and "
          f"the twin's to the last bit")
    fin = torch.isfinite(M).flatten(1).all(dim=1)
    e = [rel_err(o[fin], r[fin]) for o, r in zip(out[1:], ref[1:])]
    check(max(e) <= KERNEL_RTOL[dtype],
          f"batched K1 at s={s}, nb={nb}: W, Schur rel err {e}")
    check(all(same(o, t) for o, t in zip(out[1:], tile[1:])),
          f"batched K1 at s={s}, nb={nb}: W or Schur not the tile "
          "kernel's to the last bit")


def phase_24(smi):
    """K1's batched route (see the module docstring).  Returns the kernels
    JSON's entries: one per BATCH_SHAPES and BATCH_SWEEP shape."""
    from hqp_tpu_torch.ops import _build, gj_cuda
    f64, f32 = torch.float64, torch.float32
    lib = _build.library()
    # (a) the wrapper's copies of both register kernels' layouts
    bad = [(s, b, dt, way) for dt, sfx in ((f64, "f64"), (f32, "f32"))
           for b in (4, 10, 12) for s in range(1, 257)
           for way, fn, py, top in (
               ("tile", getattr(lib, f"hqp_gj_interior_smem_{sfx}"),
                gj_cuda.tile_smem, 256),
               ("batch", getattr(lib, f"hqp_gj_batch_smem_{sfx}"),
                gj_cuda.batch_smem, gj_cuda.BATCH_MAX))
           if s <= top and fn(s, b) != py(s, b, dt)]
    check(not bad, f"gj_cuda's shared-memory layouts disagree with the "
          f"kernels': {bad[:5]}")
    print("[24] gj_cuda.tile_smem and batch_smem equal the kernels' "
          "layouts (s <= 256 and s <= 98, b = 4, 10, 12, f64 and f32)")
    # (b) the card cases, as tests/test_torch_kernels.py holds them
    for s, nb in BATCH_CASES:
        for dt in (f64, f32):
            hold_batch_route(s, nb, dt, seed=s + nb)
            print(f"[24] batched K1 s={s} nb={nb} {str(dt)[6:]}: Minv equal "
                  f"to the tile kernel's and the twin's, W and Schur to the "
                  f"tile kernel's, to the last bit")
    # ... and at every size the route takes to the batched kernel
    for s in range(1, gj_cuda.BATCH_MAX + 1):
        for dt in (f64, f32):
            check(gj_cuda.route(s, 4, dt, "cuda") == "batch",
                  f"K1 at s={s}, {dt}: not the batched route")
            hold_batch_route(s, 3, dt, seed=1000 + s)
    print(f"[24] batched K1 at every s from 1 to {gj_cuda.BATCH_MAX}, three "
          f"interiors, f64 and f32: the route's, and Minv, W and Schur "
          f"equal to the tile kernel's and Minv to the twin's, to the last "
          f"bit")
    # (c) both routes timed at the callers' shapes and the sweep
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    print(f"[24] {sms} SMs, opt-in shared memory "
          f"{props.shared_memory_per_block_optin} B a block; the rule "
          f"takes the batched route at s <= {gj_cuda.BATCH_MAX}")
    rows = []
    for P, s in BATCH_SHAPES + [(nb, 98) for nb in BATCH_SWEEP]:
        b = 4
        M, B = batch_inputs(P, s, b, f64, seed=P + s)
        way = gj_cuda.route(s, b, f64, M.device)
        tile, bat = gj_cuda.tile_factor(M, B), gj_cuda.batch_factor(M, B)
        torch.cuda.synchronize()
        check(all(same(o, t) for o, t in zip(bat, tile)),
              f"batched K1 at [{P}, {s}, {s}]: Minv, W or Schur not the "
              "tile kernel's to the last bit")
        del tile, bat
        runs = 3 if P > 10000 else 50
        ms = {k: median_ms(fn, reps=5, runs=runs) for k, fn in (
            ("tile", lambda: gj_cuda.tile_factor(M, B)),
            ("batch", lambda: gj_cuda.batch_factor(M, B)))}
        attrs = {k: gj_cuda.kernel_attrs(k, s, b, f64)
                 for k in ("tile", "batch")}
        bnd = gj_bound(P, s, b, f64)
        print(f"[24] K1 [{P}, {s}, {s}] b={b} f64: rule -> {way}; ms a "
              f"launch ({runs} back-to-back, median of 5): tile "
              f"{ms['tile']:.4f}, batched {ms['batch']:.4f} "
              f"({ms['tile'] / ms['batch']:.2f}x); bound {bnd[0]:.3e} ms "
              f"({bnd[1]}): tile {100 * bnd[0] / ms['tile']:.2f}%, batched "
              f"{100 * bnd[0] / ms['batch']:.2f}%; resident interiors an SM,"
              f" registers, spilled bytes, threads: tile {attrs['tile']}, "
              f"batched {attrs['batch']}; Minv, W, Schur equal; on {smi}")
        rows.append({"shape": [P, s, s], "b": b, "route": way,
                     "tile_ms": ms["tile"], "batch_ms": ms["batch"],
                     "bound_ms": bnd[0], "bound_by": bnd[1],
                     "tile_attrs": attrs["tile"],
                     "batch_attrs": attrs["batch"]})
        del M, B
        torch.cuda.empty_cache()
    return rows


def main():
    # -- 1. device and toolchain -----------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: torch.cuda.is_available() is False")
    t_main = time.perf_counter()

    def clock(done):
        print(f"[t] phases 1-{done} done at "
              f"{time.perf_counter() - t_main:.1f} s")
    from hqp_tpu_torch.models.did import PrgDID
    from hqp_tpu_torch.ops import _build, gj_cuda, thomas_cuda
    from hqp_tpu_torch.sqp.powell import SqpPowell
    from hqp_tpu_torch.utils import sync

    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(smi)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print("[1] " + run([_build.nvcc_path(), "--version"]).splitlines()[-1])

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.INFO['seconds']:.1f} s, built="
          f"{_build.INFO['built']}) -> {_build.INFO['path']}")
    for ln in _build.INFO["log"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("[2]   " + ln.strip())

    # -- 3. K1 against its plain twin -------------------------------------
    tol = KERNEL_RTOL
    errs = {"gj": 0.0, "thomas": 0.0}
    cases = [(100, 48, 4, torch.float64, False),
             (100, 48, 4, torch.float32, False),
             (4, 73, 4, torch.float64, False),
             (11, 17, 4, torch.float64, True),
             (11, 17, 4, torch.float32, True),
             (2, 124, 4, torch.float64, True),
             (1, 48, 4, torch.float64, True)]
    def gj_case(phase, P, s, b, dt, swap, seed):
        """K1 (whichever route the size takes) against the twin, with the
        launches of each route counted by this one call; returns the
        route and the largest absolute error of Minv."""
        M, B = gj_inputs(P, s, b, dt, seed=seed, swap=swap)
        before, batch0 = gj_launches(), gj_cuda.LAUNCHES_BATCH
        out = gj_cuda.interior_factor(M, B)
        after = gj_launches()
        ref = gj_cuda.interior_factor_plain(M, B)
        torch.cuda.synchronize()
        e = [rel_err(o, r) for o, r in zip(out, ref)]
        eye = torch.eye(s, dtype=dt, device="cuda")
        resid = float((out[0] @ M - eye).abs().max())
        way = gj_cuda.route(s, b, dt, M.device)
        emax = float((out[0] - ref[0]).abs().max())
        cl = ""
        if way == "large":
            C = gj_cuda.cluster_size(s, b, dt, gj_cuda.smem_limit(M.device))
            cl = f", cluster of {C}"
            check(emax == 0.0 and max(e[1:]) <= LARGE_WS_TOL[dt],
                  f"large K1 at s={s}: Minv max-abs error {emax}, rel W/Schur"
                  f" {e[1:]}")
        print(f"[{phase}] K1 P={P} s={s} b={b} {str(dt)[6:]} swap={swap}: "
              f"route {way}{cl}; Minv max-abs err {emax:.2e}; rel err Minv "
              f"{e[0]:.2e} W {e[1]:.2e} Schur {e[2]:.2e}; |Minv M - I| "
              f"{resid:.2e}")
        check(max(e) <= tol[dt], f"K1 disagrees with its twin ({e})")
        check(resid <= 100 * tol[dt], f"K1 inverse residual {resid}")
        counted = {k: after[k] - before[k] for k in after}
        # ("tile" counts both register routes)
        reg = "tile" if way == "batch" else way
        check(counted == {k: int(k == reg) for k in counted}
              and gj_cuda.LAUNCHES_BATCH - batch0 == int(way == "batch"),
              f"K1 at s={s}: route {way} but launches {counted}, batched "
              f"{gj_cuda.LAUNCHES_BATCH - batch0}")
        return way, emax

    for i, (P, s, b, dt, swap) in enumerate(cases):
        way, err = gj_case(3, P, s, b, dt, swap, seed=i)
        want = "batch" if s <= gj_cuda.BATCH_MAX else "tile"
        check(way == want, f"K1 at s={s}: route {way}, not {want}")
        if (P, s, dt) == (100, 48, torch.float64):
            errs["gj"] = err

    # -- 4. K2 against its plain twin -------------------------------------
    for i, (Bn, N, n, dt) in enumerate([
            (1, 101, 2, torch.float64), (1, 101, 2, torch.float32),
            (3, 101, 6, torch.float64), (3, 101, 6, torch.float32),
            (1, 1, 1, torch.float64), (1, 1, 1, torch.float32),
            (1, 101, 8, torch.float64), (1, 101, 8, torch.float32),
            (2, 600, 6, torch.float64), (2, 600, 6, torch.float32),
            (1, 1001, 3, torch.float64), (1, 1001, 3, torch.float32)]):
        D, U, r = thomas_inputs(Bn, N, n, dt, seed=10 + i)
        x = thomas_cuda.thomas_solve(D, U, r)
        xr = thomas_cuda.thomas_solve_plain(D, U, r)
        torch.cuda.synchronize()
        e = rel_err(x, xr)
        chunked = thomas_cuda.plan(N, n, dt) == 2
        print(f"[4] K2 B={Bn} N={N} n={n} {str(dt)[6:]}: rel err {e:.2e}, "
              f"{'chunk ring' if chunked else 'staged whole'}")
        if (N, n, dt) == (600, 6, torch.float64):
            check(chunked, "N=600, n=6, f64 does not take the chunk ring")
        check(e <= tol[dt], f"K2 disagrees with its twin ({e})")
        if (Bn, n, dt) == (1, 2, torch.float64):
            errs["thomas"] = float((x - xr).abs().max())

    # -- 5. times at the main path's shapes --------------------------------
    f64 = torch.float64
    P, sz, bz = 100, 48, 4
    M, B = gj_inputs(P, sz, bz, f64, seed=0)
    times = {"gj": time_gj(M, B, "gj_interior_kernel"),
             "thomas": time_thomas(*(a[0] for a in thomas_inputs(
                 1, 101, 2, f64, seed=10)))}
    for k, t in times.items():
        show(5, k, t, f"f64, main-path shape, on {smi}")
    print("[5] library yardsticks: K1 torch.linalg.inv on [100, 48, 48] "
          "(Minv only, 92% of K1's FLOPs); K2 torch.linalg.solve on the "
          "assembled dense [202, 202] system")

    # -- 6. DID-60 ----------------------------------------------------------
    s = SqpPowell(PrgDID(kmax=60, device="cuda"), max_iters=50)
    s.init()
    res = s.solve()
    f60 = float(s.f)
    print(f"[6] DID-60: {res}, f = {f60!r}, SQP {s.iter}, IP "
          f"{s.qp_iters_total}")
    check(res == "optimal" and abs(f60 - 98.4) <= 1e-4, "DID-60")

    # -- 7. DID-1000, the main path ------------------------------------------
    def did1000(tag):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = SqpPowell(PrgDID(kmax=1000, device="cuda"), max_iters=50,
                      qp_eps=QP_EPS_DID1000)
        s.init()
        s.simulate()
        res = s.solve()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {"gj": gj_cuda.LAUNCHES, "thomas": thomas_cuda.LAUNCHES}
        f = float(s.f)
        check(s.qp.Q.is_cuda and s.qp.A.is_cuda and s.x.is_cuda,
              "QP tensors are not on the card")
        ip = s.qp_iters_total
        print(f"[7] DID-1000 {tag}: {res}, f = {f!r}, {secs:.3f} s, SQP "
              f"{s.iter}, IP {ip} ({ip / secs:.1f} IP it/s), host syncs "
              f"{sync.COUNT} ({sync.COUNT / max(ip, 1):.2f} per IP "
              f"iteration), launches K1 {launches['gj']} K2 "
              f"{launches['thomas']}, QP on {s.qp.Q.device}")
        check(res == "optimal", f"DID-1000 {tag}: {res}")
        check(abs(f - BENCH_F_DID1000) <= BENCH_TOL,
              f"DID-1000 objective {f} outside bench window")
        check(abs(f - REF_F_DID1000) <= 1e-4 * abs(REF_F_DID1000),
              f"DID-1000 objective {f} vs reference {REF_F_DID1000}")
        check(launches["gj"] > 0 and launches["thomas"] > 0,
              f"main path skipped a kernel: {launches}")
        check((ip, launches["gj"], launches["thomas"]) == DID1000_COUNTS,
              f"DID-1000 IP iterations and launches {ip}, {launches} vs "
              f"{DID1000_COUNTS}")
        return launches

    launches = did1000("cold")
    did1000("warm")

    # -- 8. K1's routes against the twin -------------------------------------
    lib = _build.library()
    bad = [(s, b, dt, C) for dt, fn in ((f64, lib.hqp_gj_large_smem_f64),
                                        (torch.float32,
                                         lib.hqp_gj_large_smem_f32))
           for b in (10, 12) for s in range(1, 513) for C in (4, 8, 16)
           if fn(s, b, C) != gj_cuda.large_smem(s, b, dt, C)]
    check(not bad, f"gj_cuda.large_smem disagrees with the kernel: {bad[:5]}")
    for i, (P, s, b, dt, swap, want) in enumerate([
            (1, 152, 10, torch.float64, True, "large"),
            (1, 245, 10, torch.float64, False, "large"),
            (1, 245, 10, torch.float64, True, "large"),
            (1, 245, 10, torch.float32, False, "large"),
            (1, 245, 10, torch.float32, True, "large"),
            (3, 245, 10, torch.float64, True, "large"),
            (2, 512, 10, torch.float64, True, "large"),
            (1, 512, 10, torch.float32, True, "large"),
            (3, 124, 12, torch.float64, True, "tile")]):
        way, err = gj_case(8, P, s, b, dt, swap, seed=20 + i)
        check(way == want, f"K1 at s={s}, b={b}: route {way}, not {want}")
        if (s, dt, swap) == (245, torch.float64, False):
            errs["gj_large"] = err
    check(gj_cuda.route(513, 10, f64, "cuda") == "inv",
          "K1 above s = 512 does not take torch.linalg.inv")
    for b in (10, 12):
        ways = [gj_cuda.route(s, b, f64, "cuda") for s in range(1, 513)]
        nbat, top = ways.count("batch"), ways.count("batch") + ways.count(
            "tile")
        check(nbat == gj_cuda.BATCH_MAX and ways == ["batch"] * nbat
              + ["tile"] * (top - nbat) + ["large"] * (512 - top),
              f"K1's routes at b={b} are not one size rule")
        print(f"[8] K1 routes at b={b}, f64: batched register kernel for "
              f"s <= {nbat}, register kernel for {nbat} < s <= {top}, large "
              f"kernel for {top} < s <= 512, torch.linalg.inv above")

    # -- 9. times at this slice's shapes -------------------------------------
    optin = gj_cuda.smem_limit("cuda")
    cluster = gj_cuda.cluster_size(245, 10, f64, optin)
    M, B = gj_inputs(1, 245, 10, f64, seed=31)
    times["gj_large"] = time_gj(M, B, "gj_cluster_kernel")
    for C in (4, 8, 16):
        dev = device_ms(lambda: gj_cuda.large_factor(M, B, C),
                        "gj_cluster_kernel")
        print(f"[9] K1 cluster kernel P=1, s=245, b=10, f64, cluster of {C}"
              f"{' (the rule)' if C == cluster else ''}: device {dev:.4f} ms"
              f" per launch (profiler, 50 launches), {dev * 1e6 / 245:.0f} "
              f"ns per elimination step; on {smi}")
    M5, B5 = gj_inputs(2, 512, 10, f64, seed=33)
    large512 = time_gj(M5, B5, "gj_cluster_kernel")
    Mc, Bc = gj_inputs(5, 124, 12, f64, seed=34)
    Cc = gj_cuda.cluster_size(124, 12, f64, optin)
    dev = device_ms(lambda: gj_cuda.large_factor(Mc, Bc, Cc),
                    "gj_cluster_kernel")
    reg = device_ms(lambda: gj_cuda.interior_factor(Mc, Bc),
                    "gj_interior_kernel")
    print(f"[9] K1 cluster kernel at the crane's P=5, s=124, b=12, f64, "
          f"cluster of {Cc}, called directly (the route rule gives this size"
          f" the register kernel): device {dev:.4f} ms per launch; register "
          f"kernel {reg:.4f} ms; on {smi}")
    M, B = gj_inputs(100, 124, 12, f64, seed=30)
    D, U, r = (a[0] for a in thomas_inputs(1, 101, 6, f64, seed=32))
    for name, t, what in (
            ("gj", time_gj(M, B, "gj_interior_kernel"), "K1 register "
             "kernel, P=100, s=124, b=12 (nx6-1000 and Crane interiors)"),
            ("gj_large", times["gj_large"], f"K1 large (cluster) kernel, "
             f"cluster of {cluster}, P=1, s=245, b=10 (CranePar's interior)"),
            ("gj_large", large512, "K1 large (cluster) kernel, cluster of "
             f"{gj_cuda.cluster_size(512, 10, f64, optin)}, P=2, s=512, "
             "b=10"),
            ("thomas", time_thomas(D, U, r), "K2, N=101, n=6 (the nx6-1000 "
             "master)")):
        show(9, name, t, f"f64, {what}, on {smi}")

    # -- 10. the nx6-1000 KKT link ---------------------------------------------
    link_ms, res = nx6_link()
    print(f"[10] nx6-1000 PartitionedKKT(L=10) f64 link: {link_ms:.3f} ms "
          f"per link (median of 5, synchronized), KKT residual {res:.2e}")
    check(res < 1e-6, f"nx6-1000 KKT residual {res}")

    # -- 11. Crane K=50 --------------------------------------------------------
    omu = omu_programs()
    counts = omu_drive(11, "Crane", omu["Crane"], simulate=True)
    check(counts["gj"]["tile"] > 0 and counts["thomas"] > 0,
          f"the Crane solve skipped a kernel: {counts}")

    # -- 12. the odc suite -----------------------------------------------------
    for name in ("BatchReactor", "Bio", "TP383omu", "HS99omu", "CranePar"):
        c = omu_drive(12, name, omu[name], simulate=False)
        if name == "CranePar":
            check(c["gj"]["large"] == CRANEPAR_LARGE,
                  f"CranePar's interior: {c['gj']['large']} large K1 "
                  f"launches, not {CRANEPAR_LARGE}: {c}")
            launches["gj_large"] = c["gj"]["large"]
    clock(12)

    dense = phases_13_to_16(smi)
    clock(16)

    # -- 17. the scenario batch --------------------------------------------------
    batch = phase_17(smi)
    clock(17)

    # -- 18. the host-sparse slice ------------------------------------------------
    phase_18(smi, dense)
    clock(18)

    # -- 19. the user-model slice -------------------------------------------------
    phase_19(smi)
    clock(19)

    # -- 20. the rest of the integrators and Mehrotra's knobs ----------------------
    phase_20(smi)
    clock(20)

    # -- 21. the command shell and the actions it drives ---------------------------
    phase_21(smi)
    clock(21)

    # -- 22. the MEX and Simulink-coder hosts, sharding ---------------------------
    sharded = phase_22(smi)
    clock(22)

    # -- 23. PartitionedKKT's keywords, full_shard=False, the scaled K2 ---------
    scaled = phase_23(smi)
    clock(23)

    # -- 24. K1's batched route ------------------------------------------------
    batch24 = phase_24(smi)
    clock(24)

    def row(key, name, replaces):
        t = times[key]
        return {"name": name, "route": "cuda",
                "source": f"hqp_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": errs[key], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"], "single_ms": t["single_ms"]}

    # "scenarios": the same kernel at the scenario batch's shapes, with its
    # launches in one warm batched solve
    # "sharded": at SpSCdist DID-1000's shapes, with its launches there
    kernels = [dict(row("gj", "gj_interior", "hqp_tpu/ops/gj_pallas.py:138"),
                    scenarios=batch["gj"], sharded=sharded["gj"],
                    batch=batch24),
               dict(row("gj_large", "gj_interior_large",
                        "hqp_tpu/ops/gj_pallas.py:138"), cluster=cluster),
               dict(row("thomas", "thomas",
                        "hqp_tpu/ops/thomas_pallas.py:128"),
                    scenarios=batch["thomas"], scaled=scaled,
                    **({"sharded": sharded["thomas"]} if "thomas" in sharded
                       else {}))]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
